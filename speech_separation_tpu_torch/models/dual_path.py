"""The dual-path scaffold that DPRNN and SepFormer share.

  segment:   latent frames (B, T', H) -> 50%-overlap chunks (B, C, K, H),
             hop P = K/2, with P zeros in front and at least P behind, so
             every real frame lies in exactly two chunks and the averaged
             merge inverts the segmentation exactly
  separator: the arch's own ``dual_path`` over the chunks
  head:      PReLU + linear H -> S*N on the chunks, merge, the arch's
             ``gate`` if any, ReLU (or sigmoid) masks
  around it: models/waveform.py's encoder, decoder and overlap-add.

The model holds the waveform bases (``enc``, ``dec``), ``in_ln``,
``bottleneck``, ``head_prelu`` and ``head``; its config ``chunk``, ``hop``,
``num_spk``, ``n_filters``, ``mask_act`` and ``torch_dtype``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import dot, gln, prelu
from .waveform import decode, encode


def num_chunks(cfg, n_t: int) -> int:
    """Chunks covering a T'-frame latent sequence after the segmentation
    pad (front hop + back pad to a hop multiple)."""
    P = cfg.hop
    t_pad = P + n_t + (-(P + n_t) % P) + P
    return t_pad // P - 1


def segment(x: torch.Tensor, P: int) -> torch.Tensor:
    """(B, T, H) -> (B, C, 2P, H) overlapping chunks, hop P."""
    B, T, H = x.shape
    back = (-(P + T) % P) + P
    xp = F.pad(x, (0, 0, P, back))
    rows = xp.reshape(B, -1, P, H)                     # (B, t_pad/P, P, H)
    return torch.cat([rows[:, :-1], rows[:, 1:]], dim=2)


def merge(ch: torch.Tensor, P: int, T: int) -> torch.Tensor:
    """Inverse of segment: averaged overlap-add of (B, C, 2P, H) chunks
    back to (B, T, H)."""
    B, C, _K, H = ch.shape
    first, second = ch[:, :, :P], ch[:, :, P:]
    rows = F.pad(first, (0, 0, 0, 0, 0, 1)) + F.pad(second, (0, 0, 0, 0, 1, 0))
    out = rows.reshape(B, (C + 1) * P, H) * 0.5
    return out[:, P: P + T]


def chunk_lengths(cfg, vt: torch.Tensor, C: int) -> torch.Tensor:
    """Per-(row, chunk) count of valid frames: chunk c spans latent frames
    [c*P - P, c*P + P), clipped to [0, K]."""
    P = cfg.hop
    starts = torch.arange(C, device=vt.device) * P - P
    return torch.clamp(vt[:, None] - starts[None, :], 0, cfg.chunk)


def chunk_masks(cfg, vt: torch.Tensor, C: int):
    """(clens (B, C) from ``chunk_lengths``, the chunk mask (B, C, K, 1)
    float32, 1.0 at each chunk's valid frames, and n_chunks (B,) the chunks
    that hold a row's frames) of the rows' latent frame counts vt."""
    clens = chunk_lengths(cfg, vt, C)
    cmask = (torch.arange(cfg.chunk, device=vt.device)[None, None, :]
             < clens[:, :, None]).float()[..., None]
    n_chunks = torch.clamp_min(
        torch.div(vt + cfg.hop - 1, cfg.hop, rounding_mode="floor") + 1, 1)
    return clens, cmask, n_chunks


def separate_core(model, wav: torch.Tensor, sample_lengths: torch.Tensor,
                  dual_path, gate=None) -> torch.Tensor:
    """(B, L) padded waveforms -> (B, S, L) estimated sources: frame ->
    encoder -> masked gLN and bottleneck -> segment -> ``dual_path`` ->
    PReLU and head -> merge -> ``gate`` (if given: ``gate(model, x)`` of
    the merged (B, T', S*N) float32 head output, SepFormer's output gate)
    -> masks -> decoder -> overlap-add. ``dual_path(model, h, vt, C)``
    takes the (B, C, K, H) chunks and returns them after the blocks, with
    the chunk mask (B, C, K, 1) float32. Rows are not trimmed to their
    lengths."""
    cfg = model.cfg
    md = cfg.torch_dtype
    w, tmask, vt = encode(model, wav, sample_lengths)
    B, n_t, _ = w.shape
    h = dot(gln(w.to(md), model.in_ln, tmask), model.bottleneck, md, md) * tmask.to(md)
    C = num_chunks(cfg, n_t)
    h, cmask = dual_path(model, segment(h, cfg.hop), vt, C)

    out = dot(prelu(h, model.head_prelu), model.head, md) * cmask
    out = merge(out, cfg.hop, n_t)
    if gate is not None:
        out = gate(model, out)
    out = out.reshape(B, n_t, cfg.num_spk, cfg.n_filters)
    act = torch.relu if cfg.mask_act == "relu" else torch.sigmoid
    return decode(model, w, act(out) * tmask[:, :, None, :], wav.shape[1])
