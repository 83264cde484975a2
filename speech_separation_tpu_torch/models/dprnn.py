"""Dual-path chunking and its helpers, as SepFormer uses them.

The counterpart of the parts of speech_separation_tpu/models/dprnn.py that
models/sepformer.py imports: ``_dot``, ``_gln_nd``, ``num_chunks``,
``_segment``, ``_merge`` and ``_chunk_lengths``. The DPRNN architecture
itself (its dual-path BLSTM blocks, config and loss) is not ported yet; it is
queued in ROADMAP.md.

Segmentation cuts a latent sequence (B, T', H) into 50%-overlap chunks
(B, C, K, H), hop P = K/2, with P zeros in front and at least P behind, so
every real frame lies in exactly two chunks and the averaged merge inverts
the segmentation exactly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.mxu import head_dot


def _dot(x: torch.Tensor, lin, dtype: torch.dtype, out_dtype: torch.dtype | None = None
         ) -> torch.Tensor:
    """x @ w + b with the product's inputs in ``dtype`` and a float32 sum;
    ``out_dtype`` sets the storage dtype of the result."""
    y = head_dot(x, lin["w"], dtype) + lin["b"]
    return y if out_dtype is None else y.to(out_dtype)


def _gln_nd(x: torch.Tensor, p, mask: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Masked global layer norm over all non-batch axes: one (mu, var) per
    utterance over its true positions and all channels. x (B, ..., C); mask
    broadcasts against x with 1.0 at true positions. Statistics in float32,
    the result stored back in x's dtype."""
    xf = x.float()
    axes = tuple(range(1, x.dim()))
    cnt = torch.clamp_min(torch.sum(mask, dim=axes, keepdim=True)
                          * x.shape[-1] / mask.shape[-1], 1.0)
    mu = torch.sum(xf * mask, dim=axes, keepdim=True) / cnt
    var = torch.sum(torch.square((xf - mu) * mask), dim=axes, keepdim=True) / cnt
    return (((xf - mu) * torch.rsqrt(var + eps)) * p["g"] + p["b"]).to(x.dtype)


def num_chunks(cfg, n_t: int) -> int:
    """Chunks covering a T'-frame latent sequence after the segmentation
    pad (front hop + back pad to a hop multiple)."""
    P = cfg.hop
    t_pad = P + n_t + (-(P + n_t) % P) + P
    return t_pad // P - 1


def _segment(x: torch.Tensor, P: int) -> torch.Tensor:
    """(B, T, H) -> (B, C, 2P, H) overlapping chunks, hop P."""
    B, T, H = x.shape
    back = (-(P + T) % P) + P
    xp = F.pad(x, (0, 0, P, back))
    rows = xp.reshape(B, -1, P, H)                     # (B, t_pad/P, P, H)
    return torch.cat([rows[:, :-1], rows[:, 1:]], dim=2)


def _merge(ch: torch.Tensor, P: int, T: int) -> torch.Tensor:
    """Inverse of _segment: averaged overlap-add of (B, C, 2P, H) chunks
    back to (B, T, H)."""
    B, C, _K, H = ch.shape
    first, second = ch[:, :, :P], ch[:, :, P:]
    rows = F.pad(first, (0, 0, 0, 0, 0, 1)) + F.pad(second, (0, 0, 0, 0, 1, 0))
    out = rows.reshape(B, (C + 1) * P, H) * 0.5
    return out[:, P: P + T]


def _chunk_lengths(cfg, vt: torch.Tensor, C: int) -> torch.Tensor:
    """Per-(row, chunk) count of valid frames: chunk c spans latent frames
    [c*P - P, c*P + P), clipped to [0, K]."""
    P = cfg.hop
    starts = torch.arange(C, device=vt.device) * P - P
    return torch.clamp(vt[:, None] - starts[None, :], 0, cfg.chunk)
