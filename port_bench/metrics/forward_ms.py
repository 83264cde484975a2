"""forward_ms (ms): device time a step of the events launched in
``train.forward``'s self time, the model (its objective, ``train.loss``,
excluded), each event given to the innermost program span open at its launch
on the host (harness/spans.py)."""

from port_bench.harness.spans import self_ms


def read(run):
    return self_ms(run, "train.forward")
