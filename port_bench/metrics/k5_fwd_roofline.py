"""k5_fwd_roofline (%): the chunk attention's forward (K5: ``attn_fwd_rows``,
``attn_fwd_passes`` in bf16, ``attn_fwd_kernel`` in float32;
csrc/attention_mma.cuh, csrc/attention.cu) against its roofline, over every
launch in the traced window: the sum of each launch's bound over the sum of
the launches' device times.

A launch's (N, T, dh) comes from the configuration (the reference's
``attention_launches`` for each step's batch); the number is given only
where the trace holds as many of the kernels as those shapes. Its bound is
the work the call needs: each input read once (q, k, v in the product
dtype, the float32 key mask) and the output written once at the memory's
rate, or its operations, whichever is longer: QK^T and AV (2 N T^2 dh
multiply-adds each) at the dtype's peak, or one exp per (query, key) on the
SFU. ``share`` is the reading both K5 readers make."""

from port_bench.harness.peaks import FLOPS, HBM_BYTES_PER_S

# exp on the SFU: 16 results per SM and clock, 132 SMs, the 1.98 GHz boost
# clock (H100 SXM)
SFU_PER_S = 132 * 16 * 1.98e9
PRODUCTS = 2


def match(name: str) -> bool:
    return "attn_fwd_" in name


def bytes_and_flops(N: int, T: int, dh: int, e: int) -> tuple:
    return 4 * N * T * dh * e + 4 * N * T, PRODUCTS * 2 * N * T * T * dh


def bound_s(nbytes: float, flops: float, exps: float, dtype: str) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / FLOPS[dtype], exps / SFU_PER_S)


def share(run, match, bytes_and_flops):
    """The percentage of K5's roofline over the window's launches that
    ``match`` accepts, each bound from ``bytes_and_flops(N, T, dh, e)``;
    None without a trace or where the count of launches is not the
    configuration's."""
    t, trace = run.records.get("train"), run.trace_data
    launches = getattr(run.reference, "attention_launches", None)
    if not t or trace is None or launches is None:
        return None
    dtype = run.config["precision"]
    e = 2 if dtype == "bfloat16" else 4
    shapes = [s for lens in t["lengths"] for s in launches(run.config["model"], t["T"], lens)]
    ks = trace.kernels(match)
    if not ks or len(ks) != len(shapes):
        return None
    bound = sum(bound_s(*bytes_and_flops(N, T, dh, e), N * T * T, dtype) for N, T, dh in shapes)
    return 100.0 * bound / sum(end - start for _, start, end, _ in ks)


def read(run):
    return share(run, match, bytes_and_flops)
