"""k5_bwd_roofline (%): the chunk attention's recompute backward (K5:
``attn_bwd_rows``, ``attn_bwd_passes`` in bf16, ``attn_bwd_kernel`` in
float32) against its roofline, over every launch in the traced window, as
``k5_fwd_roofline`` reads the forward. Its bound: each input read once (q,
k, v and the output's gradient in the product dtype, the float32 key mask)
and dq, dk, dv written once at the memory's rate, or its operations,
whichever is longer: five products of 2 N T^2 dh (QK^T recomputed, dV, the
weights' gradient, dQ, dK) at the dtype's peak, or one exp per (query,
key) on the SFU."""

from port_bench.harness.core import metric_reader

PRODUCTS = 5


def match(name: str) -> bool:
    return "attn_bwd_" in name


def bytes_and_flops(N: int, T: int, dh: int, e: int) -> tuple:
    return 7 * N * T * dh * e + 4 * N * T, PRODUCTS * 2 * N * T * T * dh


def read(run):
    return metric_reader("k5_fwd_roofline").share(run, match, bytes_and_flops)
