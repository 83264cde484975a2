"""loss_ms (ms): device time a step of the events launched inside
``train.loss``, the objective that follows the model's output (uPIT's PIT
MSE, DPRNN's SI-SNR PIT), each event given to the innermost program span open
at its launch on the host (harness/spans.py)."""

from port_bench.harness.spans import self_ms


def read(run):
    return self_ms(run, "train.loss")
