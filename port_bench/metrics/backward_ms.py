"""backward_ms (ms): device time a step of the events launched while the
step's main thread was inside ``train.backward``, from autograd's thread
among others, each event given to the innermost program span open at its
launch on the host (harness/spans.py)."""

from port_bench.harness.spans import self_ms


def read(run):
    return self_ms(run, "train.backward")
