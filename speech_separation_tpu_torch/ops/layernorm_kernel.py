"""Channelwise LayerNorm (K6): the wrappers of csrc/layernorm.cu.

Replaces no TPU kernel: the JAX package's channelwise norm
(speech_separation_tpu/models/tcn.py ``_cln``) is plain jnp that XLA fuses.
On the card the port's ``cln`` (models/layers.py) in plain PyTorch is about
ten float32 passes forward and two dozen backward over every value;
SepFormer runs 68 a step.
Over the last axis of x (..., H), per row:

- ``mu = mean(x)`` and ``var = mean((x - mu)^2)`` in float32 (two passes, not
  ``E[x^2] - mu^2``), ``rstd = rsqrt(var + eps)``;
- ``y = ((x - mu) * rstd) * g + b`` in float32, stored in x's dtype;
- the backward recomputes ``xhat = (x - mu) * rstd`` from x and the saved
  per-row ``mu`` and ``rstd`` and, with ``dyg = dy * g``, gives
  ``dx = rstd * (dyg - mean(dyg) - xhat * mean(dyg * xhat))`` in x's dtype
  and ``dg = sum(dy * xhat)``, ``db = sum(dy)`` over the rows in float32.

``channel_norm_fwd`` and ``channel_norm_bwd`` launch the kernels for CUDA
tensors (or raise) and run their plain versions (``*_plain``, the same
formulas in PyTorch) only for CPU tensors; ``<wrapper>.launches`` counts the
calls that launched (a backward is two launches: the rows, then the sum of
the parameter gradients' partial rows). ``channel_norm`` is the
differentiable call, a ``torch.autograd.Function``: it saves x as it is
(bf16 in the bf16 models) and the two float32 statistics a row.

The kernels take x of float32 or bfloat16 with 1 <= H <= ``MAX_H``,
contiguous, with g and b float32 of shape (H,); the plain versions take
the same. Two launches on the same inputs give the same bits:
the parameter gradients' sums have one owner and a fixed order.
"""

from __future__ import annotations

import torch

from ._build import check_launch, cuda_device, library

MAX_H = 1024
DTYPES = (torch.float32, torch.bfloat16)


def _check(x, g=None, b=None, stats=(), dy=None) -> int:
    if x.dim() < 1 or x.dtype not in DTYPES:
        raise ValueError(f"channel_norm takes float32 or bfloat16 x (..., H), got "
                         f"{x.dtype} {tuple(x.shape)}")
    H = x.shape[-1]
    if not 1 <= H <= MAX_H:
        raise ValueError(f"channel_norm takes widths 1 to {MAX_H}, got H={H}")
    for name, t in (("g", g), ("b", b)):
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != (H,)):
            raise ValueError(f"{name} must be ({H},) float32, got {tuple(t.shape)} {t.dtype}")
    for name, t in zip(("mu", "rstd"), stats):
        if t.dtype != torch.float32 or t.shape != x.shape[:-1]:
            raise ValueError(f"{name} must be {tuple(x.shape[:-1])} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if dy is not None and (dy.shape != x.shape or dy.dtype != x.dtype):
        raise ValueError(f"dy must be {tuple(x.shape)} {x.dtype} like x, got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    return H


def channel_norm_fwd_plain(x, g, b, eps=1e-6):
    """The forward in plain PyTorch: (y in x's dtype, mu, rstd float32 of
    x.shape[:-1]); y is bit for bit models/layers.py ``cln``'s on the CPU."""
    _check(x, g, b)
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (((xf - mu) * rstd) * g + b).to(x.dtype)
    return y, mu.squeeze(-1), rstd.squeeze(-1)


def channel_norm_bwd_plain(x, g, mu, rstd, dy):
    """The backward in plain PyTorch: (dx in x's dtype, dg, db float32)."""
    H = _check(x, g, stats=(mu, rstd), dy=dy)
    xhat = (x.float() - mu[..., None]) * rstd[..., None]
    dyf = dy.float()
    dyg = dyf * g
    dx = rstd[..., None] * (dyg - torch.mean(dyg, dim=-1, keepdim=True)
                            - xhat * torch.mean(dyg * xhat, dim=-1, keepdim=True))
    dg = torch.sum((dyf * xhat).reshape(-1, H), dim=0)
    db = torch.sum(dyf.reshape(-1, H), dim=0)
    return dx.to(x.dtype), dg, db


def channel_norm_fwd(x, g, b, eps=1e-6):
    """K6's forward: (y in x's dtype, mu, rstd float32 of x.shape[:-1])."""
    if x.device.type == "cpu":
        return channel_norm_fwd_plain(x, g, b, eps)
    H = _check(x, g, b)
    cuda_device("channel_norm_fwd", x=x, g=g, b=b)
    R = x.numel() // H
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    mu, rstd = (torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
                for _ in range(2))
    lib = library("layernorm")
    with torch.cuda.device(x.device):
        err = lib.sep_ln_fwd(x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
                             mu.data_ptr(), rstd.data_ptr(), int(x.dtype == torch.bfloat16),
                             R, H, eps, torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(err, "layernorm", "channel_norm_fwd")
    channel_norm_fwd.launches += 1
    return y, mu, rstd


def channel_norm_bwd(x, g, mu, rstd, dy):
    """K6's backward: (dx in x's dtype, dg, db float32)."""
    if x.device.type == "cpu":
        return channel_norm_bwd_plain(x, g, mu, rstd, dy)
    H = _check(x, g, stats=(mu, rstd), dy=dy)
    cuda_device("channel_norm_bwd", x=x, g=g, mu=mu, rstd=rstd, dy=dy)
    R = x.numel() // H
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dg, db = (torch.empty(H, dtype=torch.float32, device=x.device) for _ in range(2))
    # each CTA's partial dg and db, summed in order by the second launch
    lib = library("layernorm")
    part = torch.empty((lib.sep_ln_part_rows(R), 2 * H), dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        err = lib.sep_ln_bwd(x.data_ptr(), dy.data_ptr(), g.data_ptr(), mu.data_ptr(),
                                rstd.data_ptr(), dx.data_ptr(), dg.data_ptr(), db.data_ptr(),
                                part.data_ptr(), int(x.dtype == torch.bfloat16), R, H,
                                torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(err, "layernorm", "channel_norm_bwd")
    channel_norm_bwd.launches += 1
    return dx, dg, db


channel_norm_fwd.launches = 0
channel_norm_bwd.launches = 0


class _ChannelNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, b, eps):
        y, mu, rstd = channel_norm_fwd(x, g, b, eps)
        ctx.save_for_backward(x, g, mu, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, g, mu, rstd = ctx.saved_tensors
        dx, dg, db = channel_norm_bwd(x, g, mu, rstd, dy.contiguous())
        return dx, dg, db, None


def channel_norm(x, g, b, eps=1e-6):
    """Differentiable channelwise LayerNorm over x's last axis: x (..., H)
    float32 or bfloat16, g and b (H,) float32; y in x's dtype."""
    return _ChannelNorm.apply(x, g, b, eps)
