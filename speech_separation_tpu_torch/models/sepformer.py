"""SepFormer: dual-path attention separation in a learned encoder basis.

The counterpart of speech_separation_tpu/models/sepformer.py (Subakan et
al., ICASSP 2021, scaled to ``blocks`` dual-path blocks of one transformer
layer per path):

  encoder:   overlapping frames (filter_len, stride) -> ReLU linear basis
  segment:   latent frames (T', H) -> 50%-overlap chunks (C, K, H)
  separator: ``blocks`` x [intra layer over the K frames of a chunk, batched
             over B*C; inter layer over the C chunks, batched over B*K],
             each layer x + MHA(LN(x) + PE) then x + FFN(LN(x)), keys masked
             to the true frames/chunks, pad positions re-zeroed after each
             layer
  head:      PReLU + linear -> merge -> ReLU (or sigmoid) masks
  decoder:   masked latents -> linear basis -> overlap-add
  loss:      uPIT over negative SI-SNR on the waveforms.

``fused_attention=1`` sends every attention through the hand-written kernel
K5 (ops/attention_kernel.chunk_attention: forward and recompute backward on
the card, their plain versions on the CPU); ``fused_attention=0`` is the
einsum path, plain torch products as the JAX package leaves them to XLA.

Dtypes mirror the JAX package step by step: with ``compute_dtype=bfloat16``
the products take bf16 inputs with float32 sums (ops/mxu.rounded_dot), the
trunk's activations are stored in bf16, and the norm statistics, the
biases, the head's logits, the masks and the decoder stay float32. The
sinusoidal PE is computed in numpy. DOMAIN is 'time': the model consumes
waveform batches (train/wav_data.audio_to_wave_batch) and serves through
``separate``.

Parameters are named as the JAX pytree's paths (``enc``, ``in_ln.g``,
``blocks.0.intra.qkv.w``, ...) in its (in, out) layout
(utils/weights.pytree_state_dict_from_jax carries weights across).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .convtasnet import pit_si_snr_loss
from .dprnn import _chunk_lengths, _separate_core
from .tcn import _cln, _cln_init, _dot, _linear_draw_, _linear_init
from .upit import _coerce_kwargs
from ..ops.attention_kernel import chunk_attention

NAME = "SepFormer"
DOMAIN = "time"


@dataclasses.dataclass(frozen=True)
class Config:
    num_spk: int = 2
    n_filters: int = 64      # encoder basis size
    filter_len: int = 16     # encoder window in samples (2 ms at 8 kHz)
    stride: int = 8          # encoder hop
    channels: int = 64       # dual-path model width (d_model)
    heads: int = 4           # attention heads (channels % heads == 0)
    d_ff: int = 256          # FFN inner width
    chunk: int = 100         # intra-chunk length K; hop is chunk // 2
    blocks: int = 4          # dual-path blocks (intra + inter layer each)
    mask_act: str = "relu"   # "relu" | "sigmoid"
    compute_dtype: str = "float32"  # "bfloat16": bf16 products and activations
    remat: bool = False      # recompute the separator's forward in the backward
    fused_attention: bool = False   # attention through the K5 kernel

    @classmethod
    def from_kwargs(cls, **kwargs):
        return cls(**_coerce_kwargs(cls, kwargs))

    def __post_init__(self):
        if self.mask_act not in ("relu", "sigmoid"):
            raise ValueError(f"mask_act must be relu|sigmoid, got {self.mask_act!r}")
        if self.stride <= 0 or self.filter_len < self.stride:
            raise ValueError("need 0 < stride <= filter_len")
        if self.chunk < 2 or self.chunk % 2:
            raise ValueError(f"chunk must be even and >= 2, got {self.chunk}")
        if self.channels % self.heads:
            raise ValueError(f"channels ({self.channels}) must divide by "
                             f"heads ({self.heads})")

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32

    @property
    def hop(self) -> int:
        return self.chunk // 2


def _layer_init(cfg: Config, generator) -> nn.ModuleDict:
    """One pre-LN transformer layer: MHA (qkv + out) + FFN."""
    H = cfg.channels
    return nn.ModuleDict({
        "ln1": _cln_init(H),
        "qkv": _linear_init(H, 3 * H, generator),
        "out": _linear_init(H, H, generator),
        "ln2": _cln_init(H),
        "ff1": _linear_init(H, cfg.d_ff, generator),
        "ff2": _linear_init(cfg.d_ff, H, generator),
    })


class SepFormer(nn.Module):
    def __init__(self, cfg: Config, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        kb = 1.0 / math.sqrt(cfg.filter_len)
        kd = 1.0 / math.sqrt(cfg.n_filters)
        self.enc = nn.Parameter(torch.empty(cfg.filter_len, cfg.n_filters)
                                .uniform_(-kb, kb, generator=generator))
        self.dec = nn.Parameter(torch.empty(cfg.n_filters, cfg.filter_len)
                                .uniform_(-kd, kd, generator=generator))
        self.in_ln = _cln_init(cfg.n_filters)
        self.bottleneck = _linear_init(cfg.n_filters, cfg.channels, generator)
        self.head = _linear_init(cfg.channels, cfg.n_filters * cfg.num_spk, generator)
        self.head_prelu = nn.Parameter(torch.full((cfg.channels,), 0.25))
        self.blocks = nn.ModuleList(
            nn.ModuleDict({"intra": _layer_init(cfg, generator),
                           "inter": _layer_init(cfg, generator)})
            for _ in range(cfg.blocks))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Redraw every parameter in place, in the order __init__ draws them,
        from the JAX package's distributions: the encoder
        U(+-1/sqrt(filter_len)), the decoder U(+-1/sqrt(n_filters)), linear
        layers U(+-1/sqrt(n_in)), norms at identity, PReLU 0.25. The
        parameters and ``generator`` must be on one device."""
        cfg = self.cfg
        kb = 1.0 / math.sqrt(cfg.filter_len)
        kd = 1.0 / math.sqrt(cfg.n_filters)
        self.enc.uniform_(-kb, kb, generator=generator)
        self.dec.uniform_(-kd, kd, generator=generator)
        self.head_prelu.fill_(0.25)
        lins = [self.bottleneck, self.head]
        norms = [self.in_ln]
        for blk in self.blocks:
            for layer in (blk["intra"], blk["inter"]):
                lins += [layer[n] for n in ("qkv", "out", "ff1", "ff2")]
                norms += [layer["ln1"], layer["ln2"]]
        for p in lins:
            _linear_draw_(p, generator)
        for p in norms:
            p["g"].fill_(1.0)
            p["b"].zero_()

    def forward(self, wav: torch.Tensor, sample_lengths: torch.Tensor) -> torch.Tensor:
        """(B, L) padded waveforms -> (B, S, L) estimated sources (rows not
        trimmed to their lengths)."""
        return _separate_core(self, wav, sample_lengths, _dual_path)


def _sinusoid_pe(T: int, H: int) -> np.ndarray:
    """Standard sinusoidal positional encoding, (T, H) float32."""
    pos = np.arange(T)[:, None]
    div = np.exp(np.arange(0, H, 2) * (-np.log(10000.0) / H))
    pe = np.zeros((T, H), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div[: pe[:, 1::2].shape[1]])
    return pe


@functools.lru_cache(maxsize=32)
def _pe_tensor(T: int, H: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """One resident copy of the PE per shape, device and dtype (read-only)."""
    return torch.from_numpy(_sinusoid_pe(T, H)).to(device, dtype)


def _attention(layer, x: torch.Tensor, key_mask: torch.Tensor, cfg: Config) -> torch.Tensor:
    """Pre-LN MHA + FFN over axis 1. x (R, T, H); key_mask (R, T) 1.0 at
    true KEY positions (pad-row queries give junk the caller re-zeroes)."""
    R, T, H = x.shape
    ad = x.dtype
    nh, dh = cfg.heads, H // cfg.heads
    md = cfg.torch_dtype
    y = _cln(x, layer["ln1"]) + _pe_tensor(T, H, x.device, ad)
    qkv = _dot(y, layer["qkv"], md, ad).reshape(R, T, 3, nh, dh)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]       # (R, T, nh, dh)
    if cfg.fused_attention:
        def fold(t):
            return t.permute(0, 2, 1, 3).reshape(R * nh, T, dh).contiguous()
        km = key_mask[:, None, :].expand(R, nh, T).reshape(R * nh, T).contiguous()
        o = chunk_attention(fold(q), fold(k), fold(v), km)
        o = o.reshape(R, nh, T, dh).permute(0, 2, 1, 3).reshape(R, T, H).to(ad)
    else:
        # the products' sums and the softmax in float32
        logits = torch.einsum("rqhd,rkhd->rhqk", q.float(), k.float()) / math.sqrt(dh)
        logits = logits + (1.0 - key_mask)[:, None, None, :] * (-1e9)
        w = torch.softmax(logits, dim=-1).to(ad)
        o = torch.einsum("rhqk,rkhd->rqhd", w.float(), v.float()).reshape(R, T, H).to(ad)
    x = x + _dot(o, layer["out"], md, ad)
    y = _dot(_cln(x, layer["ln2"]), layer["ff1"], md, ad)
    return x + _dot(torch.relu(y), layer["ff2"], md, ad)


def _dual_path(model: SepFormer, h: torch.Tensor, vt: torch.Tensor, C: int):
    """(B, C, K, H) chunked latents -> same shape after the blocks; also
    returns the chunk mask (B, C, K, 1) float32."""
    cfg = model.cfg
    B = h.shape[0]
    K, H = cfg.chunk, cfg.channels
    dev = h.device
    clens = _chunk_lengths(cfg, vt, C)                                  # (B, C)
    cmask = (torch.arange(K, device=dev)[None, None, :]
             < clens[:, :, None]).float()[..., None]                    # (B, C, K, 1)
    n_chunks = torch.clamp_min(
        torch.div(vt + cfg.hop - 1, cfg.hop, rounding_mode="floor") + 1, 1)   # (B,)
    kmask_intra = cmask[..., 0].reshape(B * C, K)
    kmask_inter = ((torch.arange(C, device=dev)[None, :] < n_chunks[:, None]).float()
                   [:, None, :].expand(B, K, C).reshape(B * K, C))
    ad = cfg.torch_dtype
    h = h.to(ad)
    cm = cmask.to(ad)
    for blk in model.blocks:
        x = h.reshape(B * C, K, H)
        y = _attention(blk["intra"], x, kmask_intra, cfg)
        h = y.reshape(B, C, K, H) * cm
        x = h.transpose(1, 2).reshape(B * K, C, H)
        y = _attention(blk["inter"], x, kmask_inter, cfg)
        h = y.reshape(B, K, C, H).transpose(1, 2) * cm
    return h, cmask


@torch.inference_mode()
def separate(model: SepFormer, wav: torch.Tensor, sample_lengths: torch.Tensor
             ) -> torch.Tensor:
    """Serving entry (DOMAIN='time'): (B, L) padded waveforms and their
    (B,) sample counts -> (B, S, L) estimated sources."""
    return _separate_core(model, wav, sample_lengths, _dual_path)


def loss_fn(model: SepFormer, batch: dict, generator: torch.Generator | None, train: bool):
    """uPIT over negative SI-SNR for a waveform batch (``mix_wav`` (B, L),
    ``source_wavs`` (B, S, L), ``sample_lengths``, ``row_mask``): returns
    (total / norm, aux) with norm the number of real rows. The model has no
    randomness and no mode, so ``generator`` and ``train`` are unused."""
    mix, n = batch["mix_wav"], batch["sample_lengths"]
    if model.cfg.remat and torch.is_grad_enabled():
        est = checkpoint(_separate_core, model, mix, n, _dual_path, use_reentrant=False)
    else:
        est = _separate_core(model, mix, n, _dual_path)
    return pit_si_snr_loss(est, batch, model.cfg.num_spk)

Model = SepFormer
