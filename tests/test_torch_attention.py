"""The port's fused chunk attention (K5, speech_separation_tpu_torch/ops/
attention_kernel.py) against the JAX package's chunk_attention, run in
interpret mode on the CPU as tests/test_attention_pallas.py runs it, on the
same shapes: ragged key masks with one fully-masked row, N=12 and N=13.

On the CPU the port's wrappers run their plain versions, and the backward is
the port's VJP rule (chunk_attention_bwd), not autograd through the plain
forward. Tolerances: float32 forward 1e-5 and gradients 2e-4 (the same f32
arithmetic, products summed in another order); bfloat16 2e-2 and 5e-2 (one
bf16 rounding of the weights and of each output, at other places).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_separation_tpu.ops.attention_pallas import chunk_attention as jax_attention
from speech_separation_tpu_torch.ops.attention_kernel import (
    chunk_attention, chunk_attention_bwd, chunk_attention_fwd)

TOL = {"float32": (1e-5, 2e-4), "bfloat16": (2e-2, 5e-2)}


def _data(N, T=20, dh=8, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((N, T, dh)).astype(np.float32) for _ in range(3))
    lens = rng.integers(1, T + 1, size=N)
    lens[1] = 0                      # a fully-masked row (a pad chunk)
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    cot = rng.standard_normal((N, T, dh)).astype(np.float32)
    return q, k, v, mask, cot


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,seed", [(12, 0), (13, 2)])
def test_forward_and_vjp_match_jax(dtype, N, seed):
    q, k, v, mask, cot = _data(N, seed=seed)
    jd = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(x, jd) for x in (q, k, v))
    jm, jcot = jnp.asarray(mask), jnp.asarray(cot, jd)
    want, vjp = jax.vjp(lambda a, b, c: jax_attention(a, b, c, jm), jq, jk, jv)
    want_grads = vjp(jcot)

    tq, tk, tv = (_torch(x, dtype).requires_grad_(True) for x in (q, k, v))
    got = chunk_attention(tq, tk, tv, torch.from_numpy(mask))
    got.backward(_torch(cot, dtype))
    f_tol, g_tol = TOL[dtype]
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got.detach()), _np(want), rtol=f_tol, atol=f_tol)
    for name, t, w in zip("qkv", (tq, tk, tv), want_grads):
        assert t.grad.dtype == t.dtype
        np.testing.assert_allclose(_np(t.grad), _np(w), rtol=g_tol, atol=g_tol,
                                   err_msg=f"d{name}")


def test_fully_masked_row_gives_the_mean_of_v():
    q, k, v, mask, _ = _data(12, seed=5)
    o = chunk_attention_fwd(*(torch.from_numpy(x) for x in (q, k, v, mask)))
    np.testing.assert_allclose(o[1].numpy(), np.broadcast_to(v[1].mean(0), v[1].shape),
                               rtol=1e-5, atol=1e-6)
    assert np.isfinite(o.numpy()).all()


def test_cpu_wrappers_use_the_plain_versions_and_count_no_launch():
    q, k, v, mask, cot = (torch.from_numpy(x) for x in _data(4, seed=6))
    before = (chunk_attention_fwd.launches, chunk_attention_bwd.launches)
    chunk_attention_fwd(q, k, v, mask)
    chunk_attention_bwd(q, k, v, mask, cot)
    assert (chunk_attention_fwd.launches, chunk_attention_bwd.launches) == before
    with pytest.raises(ValueError, match="dtype"):
        chunk_attention_fwd(q, k.bfloat16(), v, mask)
    with pytest.raises(ValueError, match="key_mask"):
        chunk_attention_fwd(q, k, v, mask[:, :-1])
