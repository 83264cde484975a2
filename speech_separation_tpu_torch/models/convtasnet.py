"""Learned-encoder framing and the SI-SNR objective that SepFormer uses.

The counterpart of the parts of speech_separation_tpu/models/convtasnet.py
that models/sepformer.py imports: ``latent_frames``, ``valid_latent_frames``
and ``pairwise_neg_si_snr``. The Conv-TasNet architecture itself (its
config, TCN masking stack, loss and streaming) is not ported yet; it is
queued in ROADMAP.md.
"""

from __future__ import annotations

import torch


def latent_frames(cfg, total_samples: int) -> int:
    """Encoder frames for a padded signal of ``total_samples``."""
    return (total_samples - cfg.filter_len) // cfg.stride + 1


def valid_latent_frames(cfg, sample_lengths: torch.Tensor, n_t: int) -> torch.Tensor:
    """Per-row count of encoder frames touching real samples: frame k
    (starting at k*stride) carries signal iff k*stride < n."""
    c = torch.div(sample_lengths + cfg.stride - 1, cfg.stride, rounding_mode="floor")
    return torch.clamp(c, 1, n_t).to(torch.int32)


def pairwise_neg_si_snr(est: torch.Tensor, ref: torch.Tensor, smask: torch.Tensor,
                        eps: float = 1e-8) -> torch.Tensor:
    """NEG[b, i, j] = -SI-SNR(est_i, ref_j) over each row's true samples.

    est, ref: (B, S, L); smask (B, L) 1.0 at valid samples. Both signals are
    zero-meaned over the valid samples; SI-SNR = 10 log10(||s_t||^2 /
    ||e_n||^2) with s_t the projection of est onto ref. All-zero pad rows
    come out as the finite 0 through the eps guards. The pairwise products
    run in full float32 (the reference's Precision.HIGHEST): callers on the
    card keep TF32 off."""
    sm = smask[:, None, :]
    cnt = torch.clamp_min(torch.sum(smask, dim=-1), 1.0)[:, None, None]
    est = (est - torch.sum(est * sm, dim=-1, keepdim=True) / cnt) * sm
    ref = (ref - torch.sum(ref * sm, dim=-1, keepdim=True) / cnt) * sm
    dot = torch.einsum("bil,bjl->bij", est, ref)
    ref_pow = torch.sum(torch.square(ref), dim=-1)         # (B, S)
    est_pow = torch.sum(torch.square(est), dim=-1)         # (B, S)
    s_target = torch.square(dot) / (ref_pow[:, None, :] + eps)
    e_noise = torch.clamp_min(est_pow[:, :, None] - s_target, 0.0)
    return -10.0 * torch.log10((s_target + eps) / (e_noise + eps))
