"""The time-domain front and back end that Conv-TasNet, DPRNN and SepFormer
share: the learned encoder and decoder bases, their frame counts, and uPIT
over negative SI-SNR on waveforms.

  encoder: overlapping frames (filter_len, stride) -> ReLU linear basis
           (filter_len -> n_filters), zeroed past each row's frames
  decoder: masked latents -> linear basis (n_filters -> filter_len) ->
           overlap-add
  loss:    min over speaker permutations of negative SI-SNR over each
           row's true samples.

The model holds ``enc`` (filter_len, n_filters) and ``dec`` (n_filters,
filter_len) and a config with ``filter_len``, ``stride`` and
``torch_dtype``; the bases are torch.matmul, as the JAX package leaves them
to XLA outside any kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dsp.stft import _overlap_add, frame_signal
from ..ops.mxu import rounded_dot
from ..ops.pit import permutation_min_loss
from ..parallel.ranks import global_sum
from ..utils.spans import span


def latent_frames(cfg, total_samples: int) -> int:
    """Encoder frames for a padded signal of ``total_samples``."""
    return (total_samples - cfg.filter_len) // cfg.stride + 1


def valid_latent_frames(cfg, sample_lengths: torch.Tensor, n_t: int) -> torch.Tensor:
    """Per-row count of encoder frames touching real samples: frame k
    (starting at k*stride) carries signal iff k*stride < n."""
    c = torch.div(sample_lengths + cfg.stride - 1, cfg.stride, rounding_mode="floor")
    return torch.clamp(c, 1, n_t).to(torch.int32)


def encode(model, wav: torch.Tensor, sample_lengths: torch.Tensor):
    """(B, L) padded waveforms -> (w (B, T', N) ReLU encoder latents zeroed
    past each row's frames, tmask (B, T', 1) float32, vt (B,) frame counts)."""
    cfg = model.cfg
    n_t = latent_frames(cfg, wav.shape[1])
    frames = frame_signal(wav, cfg.filter_len, cfg.stride, n_t)
    w = torch.relu(rounded_dot(frames, model.enc, cfg.torch_dtype))
    vt = valid_latent_frames(cfg, sample_lengths, n_t)
    tmask = (torch.arange(n_t, device=wav.device)[None, :]
             < vt[:, None]).float()[:, :, None]
    return w * tmask, tmask, vt


def decode(model, w: torch.Tensor, masks: torch.Tensor, L: int) -> torch.Tensor:
    """Latents w (B, T', N) and masks (B, T', S, N) -> (B, S, L) waveforms:
    the masked latents through the decoder basis, overlap-added, zero-padded
    or cut to L."""
    cfg = model.cfg
    B, n_t, N = w.shape
    S = masks.shape[2]
    masked = (w[:, :, None, :] * masks).permute(0, 2, 1, 3)            # (B, S, T', N)
    dec_frames = rounded_dot(masked.reshape(B * S, n_t, N), model.dec, cfg.torch_dtype)
    y = _overlap_add(dec_frames, cfg.stride)
    if y.shape[-1] < L:
        y = F.pad(y, (0, L - y.shape[-1]))
    return y[:, :L].reshape(B, S, L)


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


def pit_si_snr_loss(est: torch.Tensor, batch: dict, num_spk: int):
    """uPIT over negative SI-SNR of (B, S, L) estimates against a waveform
    batch (``source_wavs``, ``sample_lengths``, ``row_mask``): returns
    (total / norm, aux) with norm the number of real rows, so an epoch's
    mean reads as the mean per-utterance -SI-SNR in dB."""
    with span("train.loss"):
        n, row_mask = batch["sample_lengths"], batch["row_mask"]
        L = est.shape[-1]
        smask = (torch.arange(L, device=est.device)[None, :] < n[:, None]).float()
        pair = pairwise_neg_si_snr(est * smask[:, None, :], batch["source_wavs"], smask)
        min_losses, best_perm = permutation_min_loss(pair, num_spk)
        total = torch.sum(min_losses * row_mask) / num_spk
        # over data-parallel ranks: this rank's total over the global norm
        norm = global_sum(torch.sum(row_mask), "norm")
        return total / norm, {"norm": norm, "total": total, "best_perm": best_perm}
