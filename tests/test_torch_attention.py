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

from fractions import Fraction

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_separation_tpu.ops.attention_pallas import chunk_attention as jax_attention
from speech_separation_tpu_torch.ops.attention_kernel import (
    DH_SUPPORTED, MAX_T_BWD, REG_CAP, SMEM_MAX, attention_plan, chunk_attention,
    chunk_attention_bwd, chunk_attention_fwd)

torch.set_num_threads(1)  # six xdist workers share the cores: one thread each, for life

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


# --------------------------------------------------------- the launch plan

PLAN_T = (1, 15, 16, 17, 83, 100, 104, 129, REG_CAP, REG_CAP + 1, 1230)


@pytest.mark.parametrize("dh", DH_SUPPORTED)
@pytest.mark.parametrize("T", PLAN_T)
def test_attention_plan_takes_every_tile_edge(T, dh):
    """bf16 rows stay in registers up to the cap and go to passes beyond it;
    every CTA fits the card's shared memory and covers all N rows."""
    for N in (1, 13, 10624):
        for backward in (False, True):
            plan = attention_plan(N, T, dh, torch.bfloat16, backward=backward)
            if T > REG_CAP:
                assert plan["path"] == "passes"
            else:                  # a backward at T <= 112 (96 at dh >= 32) stores its weights
                stores = backward and T <= (112 if dh <= 16 else 96)
                assert plan["path"] == ("stored" if stores else "registers")
            assert plan["cap"] == REG_CAP
            assert 1 <= plan["rows"] <= N and plan["warps"] >= 1
            assert 0 < plan["smem"] <= SMEM_MAX
            if plan["path"] != "passes":
                assert plan["ctas"] * plan["rows"] >= N > (plan["ctas"] - 1) * plan["rows"]
            else:
                assert plan["ctas"] >= N


def test_attention_plan_at_sepformers_shapes():
    """The intra-chunk (T=100) and inter-chunk (T=83) training shapes keep
    whole rows in registers (the backward its weights in shared memory); one
    60 s request's inter-chunk pass (T=1230) goes over key tiles; float32
    stays on the CUDA cores."""
    for N, T in ((10624, 100), (12800, 83)):
        assert attention_plan(N, T, 16)["path"] == "registers"
        assert attention_plan(N, T, 16, backward=True)["path"] == "stored"
    assert attention_plan(400, 1230, 16)["path"] == "passes"
    assert attention_plan(400, 1230, 16, backward=True)["ctas"] == 400
    assert attention_plan(10624, 100, 16, torch.float32)["path"] == "cuda_cores"


def test_attention_plan_names_the_cap():
    """The backward keeps float32 statistics of every query in shared
    memory, so it refuses T above MAX_T_BWD, naming it; the forward does not."""
    for dtype in (torch.bfloat16, torch.float32):
        assert attention_plan(2, MAX_T_BWD, 64, dtype, backward=True)["smem"] <= SMEM_MAX
        with pytest.raises(ValueError, match=str(MAX_T_BWD)):
            attention_plan(2, MAX_T_BWD + 1, 16, dtype, backward=True)
        assert attention_plan(2, MAX_T_BWD + 1, 16, dtype)["smem"] <= SMEM_MAX
    with pytest.raises(ValueError, match="dh"):
        attention_plan(2, 100, 12)


# ------------------------------------------ the bf16 kernels' softmax division

def _rn32(x: Fraction) -> Fraction:
    """x rounded to the nearest float32 (ties to even, subnormals kept)."""
    if x == 0:
        return Fraction(0)
    sign, x = (-1 if x < 0 else 1), abs(x)
    exp = x.numerator.bit_length() - x.denominator.bit_length()
    if Fraction(2) ** exp > x:
        exp -= 1
    ulp = Fraction(2) ** (max(exp, -126) - 23)
    q, rem = divmod(x, ulp)
    if 2 * rem > ulp or (2 * rem == ulp and q % 2):
        q += 1
    return sign * q * ulp


def test_reciprocal_division_rounds_as_ieee_division():
    """csrc/attention_mma.cuh divides a softmax weight e by its row's sum s
    as q = RN(e r), then RN(q + RN(e - q s) r) with r = RN(1 / s) (div_rcp,
    each step one float32 rounding, the inner two fused multiply-adds), and
    leaves e in (0, 2^-80) to __fdiv_rn. Over the range it takes (s in
    [1, 2^13], the sum of at most 8192 exps whose largest is 1; e in
    [2^-80, 1]) that is RN(e / s), IEEE division's result, in exact
    arithmetic on 4000 float32 pairs drawn from a seed and the range's ends."""
    rng = np.random.default_rng(7)
    n = 4000
    e_bits = ((47 + rng.integers(0, 80, n)) << 23) | rng.integers(0, 1 << 23, n)
    s_bits = ((127 + rng.integers(0, 13, n)) << 23) | rng.integers(0, 1 << 23, n)
    es = np.minimum(e_bits.astype(np.uint32).view(np.float32), np.float32(1)).tolist()
    ss = s_bits.astype(np.uint32).view(np.float32).tolist()
    ends = [1.0, 2.0 ** -80, float(np.float32(1) - np.float32(2) ** -24)]
    pairs = list(zip(es, ss)) + [(e, s) for e in ends
                                 for s in (1.0, 8192.0, 2.0 - 2.0 ** -23, 3.0)]
    for e, s in pairs:
        e, s = Fraction(e), Fraction(s)
        r = _rn32(1 / s)
        q = _rn32(e * r)
        got = _rn32(_rn32(e - q * s) * r + q)
        assert got == _rn32(e / s), (float(e), float(s))
