"""Layers the port's archs share: linear layers and their products, PReLU,
the channelwise and global layer norms, and the model-config coercion.

Parameters keep the JAX package's pytree layout: a linear layer is a
``ParameterDict`` with ``w`` (in, out) and ``b`` (out,), a norm one with
``g`` and ``b``, so a module's parameter names read as the JAX pytree's
paths (``in_proj.w``, ``blocks.3.ln1.g``; utils/weights.
pytree_state_dict_from_jax carries weights across).

The norms keep their statistics and the normalization in float32 whatever
x's storage dtype, and store the result back in x's dtype. ``over_model``:
x is this rank's block of a channel axis split over the model group, and
the statistics are summed over the group. Unsplit, ``cln`` is K6
(ops/layernorm_kernel.py).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..ops.layernorm_kernel import channel_norm, channel_norm_fwd_plain
from ..ops.mxu import rounded_dot
from ..parallel.ranks import reduce_from_model, sum_over_model


def coerce_kwargs(cls, kwargs: dict) -> dict:
    """Coerce the reference's all-string key=value config values onto the
    dataclass field types; unknown keys are dropped."""
    fields = {f.name: str(f.type) for f in dataclasses.fields(cls)}
    clean = {}
    for k, v in kwargs.items():
        if k not in fields:
            continue
        t = fields[k]
        if "bool" in t:
            clean[k] = str(v).lower() in ("1", "true", "yes")
        elif "int" in t:
            clean[k] = int(v)
        else:
            clean[k] = str(v)
    return clean


def linear_init(n_in: int, n_out: int, generator: torch.Generator | None = None
                ) -> nn.ParameterDict:
    """{'w': (n_in, n_out), 'b': (n_out,)}, drawn by ``linear_draw_``."""
    p = nn.ParameterDict({"w": nn.Parameter(torch.empty(n_in, n_out)),
                          "b": nn.Parameter(torch.empty(n_out))})
    linear_draw_(p, generator)
    return p


@torch.no_grad()
def linear_draw_(p, generator: torch.Generator | None = None) -> None:
    """Redraw a linear layer in place: w then b, U(-1/sqrt(n_in), 1/sqrt(n_in))."""
    kb = 1.0 / math.sqrt(p["w"].shape[0])
    p["w"].uniform_(-kb, kb, generator=generator)
    p["b"].uniform_(-kb, kb, generator=generator)


def dot(x: torch.Tensor, lin, dtype: torch.dtype, out_dtype: torch.dtype | None = None
        ) -> torch.Tensor:
    """x @ w + b with the product's inputs in ``dtype`` and a float32 sum;
    ``out_dtype`` sets the storage dtype of the result, rounded once after
    the bias."""
    return rounded_dot(x, lin["w"], dtype, out_dtype or torch.float32, lin["b"])


def row_dot(x: torch.Tensor, lin, dtype: torch.dtype, out_dtype: torch.dtype) -> torch.Tensor:
    """``dot`` of this rank's block of x's last axis by its block of w's
    rows (a row-parallel product): the float32 partial products summed over
    the model group, then the replicated bias, once."""
    return (reduce_from_model(rounded_dot(x, lin["w"], dtype)) + lin["b"]).to(out_dtype)


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, x * alpha.to(x.dtype))


def cln_init(dim: int) -> nn.ParameterDict:
    return nn.ParameterDict({"g": nn.Parameter(torch.ones(dim)),
                             "b": nn.Parameter(torch.zeros(dim))})


def cln(x: torch.Tensor, p, eps: float = 1e-6, over_model: bool = False) -> torch.Tensor:
    """Per-frame (channelwise) layer norm over x's last axis. Unsplit, the
    norm is K6 (ops/layernorm_kernel.py): one kernel each way on the card,
    its plain forward under autograd on the CPU; both raise on rows the
    kernel does not take."""
    if not over_model:
        if x.is_cuda:
            return channel_norm(x.contiguous(), p["g"], p["b"], eps)
        return channel_norm_fwd_plain(x, p["g"], p["b"], eps)[0]
    xf = x.float()
    cnt = sum_over_model(xf.new_full((), x.shape[-1]))
    mu = sum_over_model(torch.sum(xf, dim=-1, keepdim=True)) / cnt
    var = sum_over_model(torch.sum(torch.square(xf - mu), dim=-1, keepdim=True)) / cnt
    return (((xf - mu) * torch.rsqrt(var + eps)) * p["g"] + p["b"]).to(x.dtype)


def gln(x: torch.Tensor, p, mask: torch.Tensor, eps: float = 1e-6,
        over_model: bool = False) -> torch.Tensor:
    """Masked global layer norm over all non-batch axes: one (mu, var) per
    utterance over its true positions and all channels. x (B, ..., C); mask
    broadcasts against x with 1.0 at true positions. Over the model group
    the sums and the count are summed."""
    total = sum_over_model if over_model else (lambda t: t)
    xf = x.float()
    axes = tuple(range(1, x.dim()))
    cnt = torch.clamp_min(total(torch.sum(mask, dim=axes, keepdim=True)
                                * x.shape[-1] / mask.shape[-1]), 1.0)
    mu = total(torch.sum(xf * mask, dim=axes, keepdim=True)) / cnt
    var = total(torch.sum(torch.square((xf - mu) * mask), dim=axes, keepdim=True)) / cnt
    return (((xf - mu) * torch.rsqrt(var + eps)) * p["g"] + p["b"]).to(x.dtype)


def norm(x: torch.Tensor, p, tmask: torch.Tensor, kind: str,
         over_model: bool = False) -> torch.Tensor:
    """Conv-TasNet's norm by kind: ``"cln"`` per frame, else masked gLN."""
    if kind == "cln":
        return cln(x, p, over_model=over_model)
    return gln(x, p, tmask, over_model=over_model)
