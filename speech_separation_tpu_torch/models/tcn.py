"""Layer helpers of the TCN family that SepFormer uses.

The counterpart of the parts of speech_separation_tpu/models/tcn.py that
models/sepformer.py imports: the linear and channelwise-LN parameter
initialisers, ``_cln`` and ``_prelu``. The TCN architecture itself (its
config, dilated blocks, loss and streaming) is not ported yet; it is queued
in ROADMAP.md.

Parameters keep the JAX package's pytree layout: a linear layer is a
``ParameterDict`` with ``w`` (in, out) and ``b`` (out,), a norm one with
``g`` and ``b``, so a module's parameter names read as the JAX pytree's paths
(``bottleneck.w``, ``in_ln.g``).
"""

from __future__ import annotations

import math

import torch
from torch import nn


def _linear_init(n_in: int, n_out: int, generator: torch.Generator | None = None
                 ) -> nn.ParameterDict:
    """{'w': (n_in, n_out), 'b': (n_out,)}, drawn by ``_linear_draw_``."""
    p = nn.ParameterDict({"w": nn.Parameter(torch.empty(n_in, n_out)),
                          "b": nn.Parameter(torch.empty(n_out))})
    _linear_draw_(p, generator)
    return p


@torch.no_grad()
def _linear_draw_(p, generator: torch.Generator | None = None) -> None:
    """Redraw a linear layer in place: w then b, U(-1/sqrt(n_in), 1/sqrt(n_in))."""
    kb = 1.0 / math.sqrt(p["w"].shape[0])
    p["w"].uniform_(-kb, kb, generator=generator)
    p["b"].uniform_(-kb, kb, generator=generator)


def _cln_init(dim: int) -> nn.ParameterDict:
    return nn.ParameterDict({"g": nn.Parameter(torch.ones(dim)),
                             "b": nn.Parameter(torch.zeros(dim))})


def _prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, x * alpha.to(x.dtype))


def _cln(x: torch.Tensor, p, eps: float = 1e-6) -> torch.Tensor:
    """Per-frame (channelwise) layer norm; statistics and normalization in
    float32 whatever x's storage dtype, the result stored back in x's
    dtype."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    return (((xf - mu) * torch.rsqrt(var + eps)) * p["g"] + p["b"]).to(x.dtype)
