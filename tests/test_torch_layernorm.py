"""The channelwise LayerNorm: ``models/layers.cln`` and K6 (ops/layernorm_kernel.py).

On the CPU: ``cln`` is bit for bit the formula it always ran (also with
``over_model``), the plain forward and backward equal autograd through that
formula, and the wrappers and ``cln`` refuse what the kernel does not take.
On the card (marked ``cuda``; they skip without one, and import no JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_layernorm.py

K6 against the formula in float64 at SepFormer's (132,000, 256) bf16 rows, at
widths 64, 257 and 1024 and in float32 storage, with all-zero rows (pad
tokens: rstd = 1/sqrt(eps)). Tolerances: y within one bf16 ulp of the float64
value, the ulp taken at no less than 2^-10 (the float32 arithmetic's own
error, a few 1e-7 at |xhat| near 4, exceeds a bf16 ulp of smaller values),
float32 y within 1e-6 of max(1, |y|); dx by relative L2 within 4e-3 in bf16
(one rounding, about 1.6e-3 RMS) and 1e-5 in float32; dg, db (float32 sums
over the rows) within 1e-5; mu and rstd within 1e-6.
"""

import pytest
import torch

from speech_separation_tpu_torch.models.layers import cln
from speech_separation_tpu_torch.ops.layernorm_kernel import (MAX_H, channel_norm,
                                                              channel_norm_bwd,
                                                              channel_norm_bwd_plain,
                                                              channel_norm_fwd,
                                                              channel_norm_fwd_plain)

torch.set_num_threads(1)  # six xdist workers share the cores: one thread each, for life


def _cln_before(x, p, eps=1e-6):
    """``cln``'s body as it stood before K6 (unsplit)."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    return (((xf - mu) * torch.rsqrt(var + eps)) * p["g"] + p["b"]).to(x.dtype)


def _inputs(R, H, dtype, device="cpu", seed=0):
    """x (R, H) with every 97th row all zero, dy, and g, b near 1 and 0."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = (2.0 * torch.randn((R, H), generator=gen, device=device) + 0.5).to(dtype)
    x[::97] = 0
    dy = torch.randn((R, H), generator=gen, device=device).to(dtype)
    g = 0.9 + 0.2 * torch.rand(H, generator=gen, device=device)
    b = 0.1 * torch.rand(H, generator=gen, device=device) - 0.05
    return x, dy, g, b


def _rel_l2(got, ref) -> float:
    ref = ref.double()
    return float((got.double() - ref).norm() / ref.norm().clamp_min(1e-300))


# ------------------------------------------------------------------ the CPU

@pytest.mark.parametrize("over_model", [False, True])
@pytest.mark.parametrize("H", [8, 257])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cln_on_cpu_is_bit_for_bit_the_formula(dtype, H, over_model):
    x, dy, g, b = _inputs(40, H, dtype)
    x = x.reshape(4, 10, H)
    leaves = [t.clone().requires_grad_(True) for t in (x, g, b)]
    ref = [t.clone().requires_grad_(True) for t in (x, g, b)]
    y = cln(leaves[0], {"g": leaves[1], "b": leaves[2]}, over_model=over_model)
    y_ref = _cln_before(ref[0], {"g": ref[1], "b": ref[2]})
    y.backward(dy.reshape(x.shape))
    y_ref.backward(dy.reshape(x.shape))
    assert y.dtype == dtype and torch.equal(y, y_ref)
    for a, r in zip(leaves, ref):
        assert torch.equal(a.grad, r.grad)


@pytest.mark.parametrize("H", [1, 64, 257])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_pair_equals_autograd_through_the_formula(dtype, H):
    x, dy, g, b = _inputs(150, H, dtype, seed=H)
    y, mu, rstd = channel_norm_fwd_plain(x, g, b)
    assert torch.equal(y, _cln_before(x, {"g": g, "b": b}))
    assert mu.shape == rstd.shape == (150,) and mu.dtype == rstd.dtype == torch.float32
    assert torch.all(rstd[::97] == torch.rsqrt(torch.tensor(1e-6)))
    leaves = [t.clone().requires_grad_(True) for t in (x, g, b)]
    _cln_before(leaves[0], {"g": leaves[1], "b": leaves[2]}).backward(dy)
    dx, dg, db = channel_norm_bwd_plain(x, g, mu, rstd, dy)
    assert dx.dtype == dtype and dg.dtype == db.dtype == torch.float32
    # the same sums in another association: float32 rounding, and in bf16 a
    # value of dx that rounds the other way now and then
    assert _rel_l2(dx, leaves[0].grad) <= (1e-6 if dtype == torch.float32 else 1e-3)
    assert _rel_l2(dg, leaves[1].grad) <= 1e-6
    assert _rel_l2(db, leaves[2].grad) <= 1e-6


def test_channel_norm_on_cpu_runs_the_plain_pair_and_launches_nothing():
    x, dy, g, b = _inputs(30, 24, torch.bfloat16)
    x = x.reshape(3, 10, 24)
    before = (channel_norm_fwd.launches, channel_norm_bwd.launches)
    leaves = [t.clone().requires_grad_(True) for t in (x, g, b)]
    y = channel_norm(*leaves)
    y.backward(dy.reshape(x.shape))
    y_ref, mu, rstd = channel_norm_fwd_plain(x, g, b)
    grads = channel_norm_bwd_plain(x, g, mu, rstd, dy.reshape(x.shape))
    assert torch.equal(y, y_ref)
    for leaf, ref in zip(leaves, grads):
        assert torch.equal(leaf.grad, ref)
    assert (channel_norm_fwd.launches, channel_norm_bwd.launches) == before


@pytest.mark.parametrize("dtype,H,takes", [(torch.float32, 256, True), (torch.bfloat16, 257, True),
                                           (torch.bfloat16, 1, True),
                                           (torch.bfloat16, MAX_H, True),
                                           (torch.bfloat16, MAX_H + 1, False),
                                           (torch.float16, 256, False),
                                           (torch.float64, 256, False)])
def test_cln_takes_the_dtypes_and_widths_the_kernel_takes(dtype, H, takes):
    """``cln`` unsplit on the CPU runs K6's plain forward, which refuses
    what the kernel would: the same rows pass or raise on either device."""
    x = torch.zeros((2, H), dtype=dtype)
    p = {"g": torch.ones(H), "b": torch.zeros(H)}
    if takes:
        assert torch.equal(cln(x, p), x)
    else:
        with pytest.raises(ValueError, match="float32 or bfloat16|widths 1 to"):
            cln(x, p)


def _bad(case):
    """(call, message) for one input the wrappers refuse."""
    x, dy, g, b = _inputs(6, 16, torch.bfloat16)
    _, mu, rstd = channel_norm_fwd_plain(x, g, b)
    wide = torch.zeros((2, MAX_H + 1), dtype=torch.bfloat16)
    meta = torch.empty((6, 16), dtype=torch.bfloat16, device="meta")
    return {
        "float16 x": (lambda: channel_norm_fwd(x.half(), g, b), "float32 or bfloat16"),
        "float64 x": (lambda: channel_norm_fwd(x.double(), g, b), "float32 or bfloat16"),
        "too wide": (lambda: channel_norm_fwd(wide, torch.ones(MAX_H + 1),
                                              torch.zeros(MAX_H + 1)), "widths 1 to"),
        "no width": (lambda: channel_norm_fwd(x[:, :0], g[:0], b[:0]), "widths 1 to"),
        "bf16 g": (lambda: channel_norm_fwd(x, g.bfloat16(), b), "g must be"),
        "short b": (lambda: channel_norm_fwd(x, g, b[:8]), "b must be"),
        "dy of another dtype": (lambda: channel_norm_bwd(x, g, mu, rstd, dy.float()),
                                "dy must be"),
        "mu of another shape": (lambda: channel_norm_bwd(x, g, mu[:3], rstd, dy), "mu must be"),
        "rstd in bf16": (lambda: channel_norm_bwd(x, g, mu, rstd.bfloat16(), dy),
                         "rstd must be"),
        "meta forward": (lambda: channel_norm_fwd(meta, g.to("meta"), b.to("meta")),
                         "cuda or cpu"),
        "meta backward": (lambda: channel_norm_bwd(meta, g.to("meta"), mu.to("meta"),
                                                   rstd.to("meta"), meta), "cuda or cpu"),
    }[case]


@pytest.mark.parametrize("case", ["float16 x", "float64 x", "too wide", "no width", "bf16 g",
                                  "short b", "dy of another dtype", "mu of another shape",
                                  "rstd in bf16", "meta forward", "meta backward"])
def test_wrappers_refuse_what_the_kernel_does_not_take(case):
    call, message = _bad(case)
    with pytest.raises(ValueError, match=message):
        call()


# ----------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _float64_formula(x, g, b, dy, eps=1e-6):
    xd, gd, bd, dyd = (t.double() for t in (x, g, b, dy))
    mu = xd.mean(-1, keepdim=True)
    var = ((xd - mu) ** 2).mean(-1, keepdim=True)
    rstd = 1.0 / torch.sqrt(var + eps)
    xhat = (xd - mu) * rstd
    dyg = dyd * gd
    dx = rstd * (dyg - dyg.mean(-1, keepdim=True) - xhat * (dyg * xhat).mean(-1, keepdim=True))
    return (xhat * gd + bd, mu.squeeze(-1), rstd.squeeze(-1), dx, (dyd * xhat).sum(0),
            dyd.sum(0))


def _bf16_ulp(v):
    """One bf16 ulp at |v|, taken at no less than 2^-10."""
    _, e = torch.frexp(v.abs().clamp_min(2.0 ** -10))
    return torch.ldexp(torch.ones_like(v), e - 8)


@pytest.mark.cuda
@pytest.mark.parametrize("R,H,dtype", [(132000, 256, torch.bfloat16), (4096, 64, torch.bfloat16),
                                       (4096, 257, torch.bfloat16),
                                       (4096, 1024, torch.bfloat16),
                                       (4096, 256, torch.float32), (4096, 257, torch.float32)])
def test_k6_matches_float64_on_the_card(cuda, R, H, dtype):
    x, dy, g, b = _inputs(R, H, dtype, device=cuda, seed=R + H)
    before = (channel_norm_fwd.launches, channel_norm_bwd.launches)
    y, mu, rstd = channel_norm_fwd(x, g, b)
    dx, dg, db = channel_norm_bwd(x, g, mu, rstd, dy)
    again = (*channel_norm_fwd(x, g, b), *channel_norm_bwd(x, g, mu, rstd, dy))
    torch.cuda.synchronize()
    assert (channel_norm_fwd.launches, channel_norm_bwd.launches) == (before[0] + 2,
                                                                      before[1] + 2)
    for a, r in zip((y, mu, rstd, dx, dg, db), again):
        assert torch.equal(a, r), "a second launch gives other bits"
    y64, mu64, rstd64, dx64, dg64, db64 = _float64_formula(x, g, b, dy)
    err = (y.double() - y64).abs()
    if dtype == torch.bfloat16:
        assert torch.all(err <= _bf16_ulp(y64)), float((err / _bf16_ulp(y64)).max())
    else:
        assert torch.all(err <= 1e-6 * y64.abs().clamp_min(1.0)), float(err.max())
    assert float(((mu.double() - mu64).abs() / mu64.abs().clamp_min(1.0)).max()) <= 1e-6
    assert float(((rstd.double() - rstd64).abs() / rstd64).max()) <= 1e-6
    assert torch.equal(y[::97], b.to(dtype).expand_as(y[::97]))       # zero rows: y = b
    assert _rel_l2(dx, dx64) <= (4e-3 if dtype == torch.bfloat16 else 1e-5)
    assert _rel_l2(dg, dg64) <= 1e-5 and _rel_l2(db, db64) <= 1e-5


@pytest.mark.cuda
def test_cln_on_the_card_runs_k6_unless_split(cuda):
    x, dy, g, b = _inputs(2000, 256, torch.bfloat16, device=cuda)
    x, dy = x.reshape(8, 250, 256), dy.reshape(8, 250, 256)
    p = {"g": g.clone().requires_grad_(True), "b": b.clone().requires_grad_(True)}
    ref_p = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    before = (channel_norm_fwd.launches, channel_norm_bwd.launches)
    xl = x.clone().requires_grad_(True)
    y = cln(xl, p)
    y.backward(dy)
    torch.cuda.synchronize()
    assert (channel_norm_fwd.launches, channel_norm_bwd.launches) == (before[0] + 1,
                                                                      before[1] + 1)
    xr = x.clone().requires_grad_(True)
    y_ref = _cln_before(xr, ref_p)
    y_ref.backward(dy)
    # two float32 results rounded to bf16 differ by one ulp at most
    scale = torch.maximum(y.double().abs(), y_ref.double().abs())
    assert torch.all((y.double() - y_ref.double()).abs() <= _bf16_ulp(scale))
    assert _rel_l2(xl.grad, xr.grad) <= 4e-3
    assert _rel_l2(p["g"].grad, ref_p["g"].grad) <= 1e-5
    assert _rel_l2(p["b"].grad, ref_p["b"].grad) <= 1e-5
    # split over the model group: the plain body; a dtype the kernel does not
    # take: refused, as on the CPU
    cln(x, p, over_model=True)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cln(x.half(), p)
    torch.cuda.synchronize()
    assert channel_norm_fwd.launches == before[0] + 1
