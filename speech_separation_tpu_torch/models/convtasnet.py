"""Conv-TasNet: time-domain separation with a learned encoder and decoder.

The counterpart of speech_separation_tpu/models/convtasnet.py (Luo and
Mesgarani, TASLP 2019), trained with uPIT over negative SI-SNR on waveforms:

  encoder:   overlapping frames (filter_len, stride) -> ReLU linear basis
             (filter_len -> n_filters)
  separator: norm -> 1x1 bottleneck -> R repeats of X dilated residual blocks
             (models/tcn.py's blocks) -> PReLU -> 1x1 head -> ReLU (or
             sigmoid) masks, num_spk of them over the latent space
  decoder:   masked latents -> linear basis (n_filters -> filter_len) ->
             overlap-add
  loss:      min over speaker permutations of negative SI-SNR over each
             row's true samples.

``norm="gln"`` normalizes with masked global statistics (one mean and
variance per utterance over its true frames and all channels), ``"cln"`` per
frame; ``causal=True`` forces cLN and pads the depthwise convs on the left
only, the streaming variant (``streaming_forward``, eval/streaming.py). Frames
past a row's true samples are zeroed throughout, so an utterance's separated
samples do not depend on the padding of its batch. DOMAIN is 'time': the
model consumes waveform batches (train/wav_data.audio_to_wave_batch), trains
only with ``--on-device-features`` and serves through ``separate``. The 1x1
products and the bases are torch.matmul, the depthwise convs
torch.nn.functional.conv1d, as the JAX package leaves them to XLA outside any
kernel; ``remat=True`` recomputes the separation in the backward.

Tensor parallelism (``tp == "convtasnet"``,
parallel/mesh.shard_params_convtasnet): the blocks run Megatron style
(models/tcn.run_blocks with ``split``), their gLN or cLN statistics summed
over the model group (``in_ln``, on a replicated tensor, is not), and the
mask head is column-parallel, its logits gathered whole before the reshape
to (S, N).

Also kept here, for models/dprnn.py and sepformer.py: ``latent_frames``,
``valid_latent_frames``, the encoder and decoder (``encode``, ``decode``),
the masked gLN ``_gln``, ``pairwise_neg_si_snr`` and ``pit_si_snr_loss``.
Parameters are named as the JAX pytree's paths (``enc``, ``bottleneck.w``,
``blocks.0.dw``, ...) in its (in, out) layout
(utils/weights.pytree_state_dict_from_jax carries weights across).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

# init_stream_state: the blocks' conv context, as TCN's (eval/streaming.py)
from .tcn import (Block, _cln, _cln_init, _dot, _linear_draw_, _linear_init, _prelu,  # noqa: F401
                  init_stream_state, run_blocks)
from .upit import _coerce_kwargs
from ..dsp.stft import _overlap_add, frame_signal
from ..ops.mxu import column_dot, rounded_dot
from ..ops.pit import permutation_min_loss
from ..parallel.ranks import gather_from_model, global_sum, sum_over_model
from ..utils.spans import span

NAME = "ConvTasNet"
DOMAIN = "time"


@dataclasses.dataclass(frozen=True)
class Config:
    num_spk: int = 2
    n_filters: int = 256     # encoder basis size (the paper's N)
    filter_len: int = 32     # encoder window in samples (L): 4 ms at 8 kHz
    stride: int = 16         # encoder hop
    channels: int = 128      # bottleneck / residual width (B)
    hidden: int = 512        # block inner width (H)
    kernel: int = 3          # depthwise kernel (P)
    blocks: int = 8          # dilated blocks per repeat (X), dilation 2^x
    repeats: int = 3         # repeats (R)
    norm: str = "gln"        # "gln" (masked global statistics) | "cln"
    mask_act: str = "relu"   # "relu" | "sigmoid"
    compute_dtype: str = "float32"  # "bfloat16": bf16 products and activations
    remat: bool = False      # recompute the separation in the backward
    causal: bool = False     # left-only conv padding and cLN: the streaming variant

    @classmethod
    def from_kwargs(cls, **kwargs):
        return cls(**_coerce_kwargs(cls, kwargs))

    def __post_init__(self):
        if self.causal and self.norm == "gln":
            # gLN reads future frames' statistics: a causal model uses cLN
            object.__setattr__(self, "norm", "cln")
        if self.mask_act not in ("relu", "sigmoid"):
            raise ValueError(f"mask_act must be relu|sigmoid, got {self.mask_act!r}")
        if self.norm not in ("gln", "cln"):
            raise ValueError(f"norm must be gln|cln, got {self.norm!r}")
        if self.stride <= 0 or self.filter_len < self.stride:
            raise ValueError("need 0 < stride <= filter_len")

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32

    def dilations(self) -> list:
        return [2 ** (i % self.blocks) for i in range(self.repeats * self.blocks)]

    @property
    def receptive_field(self) -> int:
        """Latent frames of (left, in causal mode) context per output."""
        return 1 + (self.kernel - 1) * sum(self.dilations())


# ----------------------------------------------- framing, norms and the loss

def latent_frames(cfg, total_samples: int) -> int:
    """Encoder frames for a padded signal of ``total_samples``."""
    return (total_samples - cfg.filter_len) // cfg.stride + 1


def valid_latent_frames(cfg, sample_lengths: torch.Tensor, n_t: int) -> torch.Tensor:
    """Per-row count of encoder frames touching real samples: frame k
    (starting at k*stride) carries signal iff k*stride < n."""
    c = torch.div(sample_lengths + cfg.stride - 1, cfg.stride, rounding_mode="floor")
    return torch.clamp(c, 1, n_t).to(torch.int32)


def _gln(x: torch.Tensor, p, mask: torch.Tensor, eps: float = 1e-6,
         over_model: bool = False) -> torch.Tensor:
    """Masked global layer norm over all non-batch axes: one (mu, var) per
    utterance over its true positions and all channels. x (B, ..., C); mask
    broadcasts against x with 1.0 at true positions. Statistics in float32,
    the result stored back in x's dtype. ``over_model``: x is this rank's
    block of a channel axis split over the model group, and the sums and
    the count are summed over the group."""
    total = sum_over_model if over_model else (lambda t: t)
    xf = x.float()
    axes = tuple(range(1, x.dim()))
    cnt = torch.clamp_min(total(torch.sum(mask, dim=axes, keepdim=True)
                                * x.shape[-1] / mask.shape[-1]), 1.0)
    mu = total(torch.sum(xf * mask, dim=axes, keepdim=True)) / cnt
    var = total(torch.sum(torch.square((xf - mu) * mask), dim=axes, keepdim=True)) / cnt
    return (((xf - mu) * torch.rsqrt(var + eps)) * p["g"] + p["b"]).to(x.dtype)


def _norm(x: torch.Tensor, p, tmask: torch.Tensor, kind: str,
          over_model: bool = False) -> torch.Tensor:
    if kind == "cln":
        return _cln(x, p, over_model=over_model)
    return _gln(x, p, tmask, over_model=over_model)


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


# -------------------------------------------------------------------- model

class ConvTasNet(nn.Module):
    # "convtasnet": Megatron blocks over the model group (parallel/mesh.place)
    tp: str | None = None

    def __init__(self, cfg: Config, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.enc = nn.Parameter(torch.empty(cfg.filter_len, cfg.n_filters))
        self.dec = nn.Parameter(torch.empty(cfg.n_filters, cfg.filter_len))
        self.in_ln = _cln_init(cfg.n_filters)
        self.bottleneck = _linear_init(cfg.n_filters, cfg.channels)
        self.head = _linear_init(cfg.channels, cfg.n_filters * cfg.num_spk)
        self.head_prelu = nn.Parameter(torch.full((cfg.channels,), 0.25))
        self.blocks = nn.ModuleList(Block(cfg.channels, cfg.hidden, cfg.kernel)
                                    for _ in range(cfg.repeats * cfg.blocks))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Draw every parameter in place from the JAX package's
        distributions: the encoder U(+-1/sqrt(filter_len)), the decoder
        U(+-1/sqrt(n_filters)), linear layers U(+-1/sqrt(n_in)), the
        depthwise kernels U(+-1/sqrt(K)), norms at identity, PReLU 0.25. The
        parameters and ``generator`` must be on one device."""
        cfg = self.cfg
        kb, kd = 1.0 / math.sqrt(cfg.filter_len), 1.0 / math.sqrt(cfg.n_filters)
        self.enc.uniform_(-kb, kb, generator=generator)
        self.dec.uniform_(-kd, kd, generator=generator)
        _linear_draw_(self.bottleneck, generator)
        _linear_draw_(self.head, generator)
        self.head_prelu.fill_(0.25)
        self.in_ln["g"].fill_(1.0)
        self.in_ln["b"].zero_()
        for blk in self.blocks:
            blk.reset_parameters(generator)

    def _masks(self, skips: torch.Tensor) -> torch.Tensor:
        """Summed skips (B, T', channels) -> masks (B, T', S, N), the head's
        logits in float32."""
        cfg = self.cfg
        if self.tp is None:
            out = _dot(_prelu(skips, self.head_prelu), self.head, cfg.torch_dtype)
        else:
            out = column_dot(_prelu(skips, self.head_prelu), self.head["w"], cfg.torch_dtype)
            out = gather_from_model(out + self.head["b"], dim=-1)
        out = out.reshape(*out.shape[:2], cfg.num_spk, cfg.n_filters)
        return torch.relu(out) if cfg.mask_act == "relu" else torch.sigmoid(out)

    def mask_logits(self, w: torch.Tensor, tmask: torch.Tensor) -> torch.Tensor:
        """Encoder latents w (B, T', N), already frame-masked, -> masks (B,
        T', S, N), zero past each row's frames."""
        cfg = self.cfg
        ad = cfg.torch_dtype
        tm = tmask.to(ad)

        split = self.tp is not None

        def block_norm(x, p):
            return _norm(x, p, tmask, cfg.norm, over_model=split)

        h = _dot(_norm(w.to(ad), self.in_ln, tmask, cfg.norm), self.bottleneck, ad, ad) * tm
        skips, _ = run_blocks(self.blocks, cfg, h, block_norm, tm, split=split)
        return self._masks(skips) * tmask[:, :, None, :]

    def forward(self, wav: torch.Tensor, sample_lengths: torch.Tensor) -> torch.Tensor:
        """(B, L) padded waveforms -> (B, S, L) estimated sources, rows not
        trimmed to their lengths (zero past stride*(T'-1)+filter_len)."""
        w, tmask, _ = encode(self, wav, sample_lengths)
        return decode(self, w, self.mask_logits(w, tmask), wav.shape[1])

    def streaming_forward(self, w: torch.Tensor, conv_state: list):
        """One chunk of the causal separator with each block's conv context:
        w (B, C, n_filters) encoder latents, all real. Returns (masks (B, C,
        S, N), new conv state); on the concatenated stream it equals the
        offline ``mask_logits``."""
        cfg = self.cfg
        if not cfg.causal:
            raise ValueError("streaming_forward needs a causal config")
        ad = cfg.torch_dtype
        h = _dot(_cln(w.to(ad), self.in_ln), self.bottleneck, ad, ad)
        skips, new_state = run_blocks(self.blocks, cfg, h, _cln, None, conv_state)
        return self._masks(skips), new_state


@torch.inference_mode()
def separate(model: ConvTasNet, wav: torch.Tensor, sample_lengths: torch.Tensor
             ) -> torch.Tensor:
    """Serving entry (DOMAIN='time'): (B, L) padded waveforms and their
    (B,) sample counts -> (B, S, L) estimated sources."""
    return model(wav, sample_lengths)


def loss_fn(model: ConvTasNet, batch: dict, generator: torch.Generator | None, train: bool):
    """uPIT over negative SI-SNR for a waveform batch (``mix_wav`` (B, L),
    ``source_wavs`` (B, S, L), ``sample_lengths``, ``row_mask``): returns
    (total / norm, aux) with norm the number of real rows. The model has no
    randomness and no mode, so ``generator`` and ``train`` are unused."""
    mix, n = batch["mix_wav"], batch["sample_lengths"]
    if model.cfg.remat and torch.is_grad_enabled():
        est = checkpoint(model, mix, n, use_reentrant=False)
    else:
        est = model(mix, n)
    return pit_si_snr_loss(est, batch, model.cfg.num_spk)


Model = ConvTasNet
