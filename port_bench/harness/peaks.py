"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit), frozen here as the benchmark's yardstick."""

HBM_BYTES_PER_S = 3.35e12
# dense tensor-core bf16, and float32 on the CUDA cores (outside the tensor cores)
FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    """The least time a call can take: its bytes at the memory's rate or its
    operations at the dtype's peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FLOPS[dtype])
