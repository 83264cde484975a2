"""inter_path_ms (ms): device time a step of the events launched in
``sepformer.inter``'s self time: SepFormer's inter-chunk paths in the
forward (each block's transpose into rows across the chunks, its stack of
transformer layers with K5's forward, the final LayerNorm, the global norm,
the residual and the transpose back), each event given to the innermost
program span open at its launch on the host (harness/spans.py). The
backward's events stay with ``train.backward``. So on SepFormer
``forward_ms`` (``train.forward``'s self time) is the forward without its
paths (the encoder, the head, the gate and the decoder): the whole forward
is ``forward_ms`` + ``intra_path_ms`` + ``inter_path_ms``."""

from port_bench.harness.spans import self_ms


def read(run):
    return self_ms(run, "sepformer.inter")
