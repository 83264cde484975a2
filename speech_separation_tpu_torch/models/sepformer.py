"""SepFormer: dual-path attention separation in a learned encoder basis.

Subakan, Ravanelli, Cornell, Bronzi and Zhong, "Attention is All You Need
in Speech Separation" (ICASSP 2021). Two structures, chosen by ``Config``:

- the compact one (the defaults: ``published=0``, ``layers=1``), the
  counterpart of speech_separation_tpu/models/sepformer.py, which the CPU
  tests hold it to: ``blocks`` dual-path blocks of one transformer layer
  a path, the sinusoidal PE added to each layer's attention input, no
  norm around the paths and no gate;
- the published one (``published=1``, ``layers=8``, with the paper's
  widths: 2 blocks, d_model 256, 8 heads, d_ff 1024, chunk 250), after
  SpeechBrain's WSJ0-2mix recipe: each path a stack of
  ``layers`` pre-LN layers with the PE added once to the stack's input
  and a final LayerNorm (eps 1e-6), then a masked global layer norm (eps
  1e-8) on the path's output and a residual around the path; after the
  overlap-add a gate tanh(x W_t + b_t) * sigmoid(x W_s + b_s) and a 1x1
  without bias before the masks.

The pieces:

  encoder:   overlapping frames (filter_len, stride) -> ReLU linear basis
  segment:   latent frames (T', H) -> 50%-overlap chunks (C, K, H)
  separator: ``blocks`` x [intra path over the K frames of a chunk, batched
             over B*C; inter path over the C chunks, batched over B*K];
             a layer is x + MHA(LN(x)) then x + FFN(LN(x)) (ReLU), keys
             masked to the true frames/chunks; pad positions re-zeroed
             after each path (compact: after its one layer)
  head:      PReLU + linear -> merge -> [gate] -> ReLU (or sigmoid) masks
  decoder:   masked latents -> linear basis -> overlap-add
  loss:      uPIT over negative SI-SNR on the waveforms.

``fused_attention=1`` sends every attention through the hand-written kernel
K5 (ops/attention_kernel.chunk_attention: forward and recompute backward on
the card, their plain versions on the CPU); ``fused_attention=0`` is the
einsum path, plain torch products as the JAX package leaves them to XLA.

Dtypes mirror the JAX package step by step: with ``compute_dtype=bfloat16``
the products take bf16 inputs with float32 sums (ops/mxu.rounded_dot; the
transformer layers' four, whose roundings no recurrence carries, through
ops/mxu.any_order_dot, summed on the tensor cores on the card), the
trunk's activations are stored in bf16, and the norm statistics, the
biases, the head's logits, the gate, the masks and the decoder stay
float32. The sinusoidal PE is computed in numpy. DOMAIN is 'time': the
model consumes waveform batches (train/wav_data.audio_to_wave_batch) and
serves through ``separate``.

Spans (utils/spans.py, recorded only under a profiler): ``sepformer.intra``
and ``sepformer.inter`` around each path of each block in the forward
(the reshape into the path's rows, the stack, the norms, the residual and
the re-zeroing), ``blocks`` of each a pass.

Parameters are named as the JAX pytree's paths (``enc``, ``in_ln.g``,
``blocks.0.intra.qkv.w``, ...) in its (in, out) layout
(utils/weights.pytree_state_dict_from_jax carries weights across). The
published structure's paths hold ``layers.<l>.*`` (each layer's leaves
as the compact path's), ``ln`` (the stack's final LayerNorm) and ``gln``
(the norm around the path); the gate is ``gate_tanh``, ``gate_sigmoid``
and ``gate_end`` (the 1x1, no bias).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .dual_path import chunk_masks, separate_core
from .layers import cln, cln_init, coerce_kwargs, dot, gln, linear_draw_, linear_init
from .waveform import pit_si_snr_loss
from ..ops.attention_kernel import chunk_attention
from ..ops.mxu import any_order_dot, rounded_dot
from ..utils.spans import span

NAME = "SepFormer"
DOMAIN = "time"
# the kernel sources (ops/_build.TABLE) it launches: the chunk attention
# (K5, with fused_attention=1) and the channelwise LayerNorm (K6)
KERNELS = ("attention", "layernorm")


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
    # the published structure (module docstring); the defaults are the
    # JAX package's compact model
    published: bool = False  # PE once a stack, final LN, gLN and residual a path, the gate
    layers: int = 1          # transformer layers a path (more than 1: published only)

    @classmethod
    def from_kwargs(cls, **kwargs):
        return cls(**coerce_kwargs(cls, kwargs))

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
        if self.layers < 1 or (self.layers > 1 and not self.published):
            raise ValueError(f"layers must be 1, or >= 1 with published=1; got {self.layers}")

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
        "ln1": cln_init(H),
        "qkv": linear_init(H, 3 * H, generator),
        "out": linear_init(H, H, generator),
        "ln2": cln_init(H),
        "ff1": linear_init(H, cfg.d_ff, generator),
        "ff2": linear_init(cfg.d_ff, H, generator),
    })


def _path_init(cfg: Config, generator) -> nn.ModuleDict:
    """One path of a block: compact, its one layer's leaves
    (``blocks.0.intra.qkv.w``, as in the JAX package); published, ``layers``
    layers, the stack's final LN and the path's gLN."""
    if not cfg.published:
        return _layer_init(cfg, generator)
    return nn.ModuleDict({"layers": nn.ModuleList(_layer_init(cfg, generator)
                                                  for _ in range(cfg.layers)),
                          "ln": cln_init(cfg.channels), "gln": cln_init(cfg.channels)})


def _path_layers(cfg: Config, path) -> list:
    return list(path["layers"]) if cfg.published else [path]


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
        self.in_ln = cln_init(cfg.n_filters)
        self.bottleneck = linear_init(cfg.n_filters, cfg.channels, generator)
        self.head = linear_init(cfg.channels, cfg.n_filters * cfg.num_spk, generator)
        self.head_prelu = nn.Parameter(torch.full((cfg.channels,), 0.25))
        self.blocks = nn.ModuleList(
            nn.ModuleDict({"intra": _path_init(cfg, generator),
                           "inter": _path_init(cfg, generator)})
            for _ in range(cfg.blocks))
        if cfg.published:
            N = cfg.n_filters
            self.gate_tanh = linear_init(N, N, generator)
            self.gate_sigmoid = linear_init(N, N, generator)
            self.gate_end = nn.Parameter(torch.empty(N, N).uniform_(-kd, kd, generator=generator))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Redraw every parameter in place, in the order __init__ draws them,
        from the JAX package's distributions: the encoder
        U(+-1/sqrt(filter_len)), the decoder U(+-1/sqrt(n_filters)), linear
        layers U(+-1/sqrt(n_in)) (the gate's 1x1 too), norms at identity,
        PReLU 0.25. The parameters and ``generator`` must be on one device."""
        cfg = self.cfg
        kb = 1.0 / math.sqrt(cfg.filter_len)
        kd = 1.0 / math.sqrt(cfg.n_filters)
        self.enc.uniform_(-kb, kb, generator=generator)
        self.dec.uniform_(-kd, kd, generator=generator)
        self.head_prelu.fill_(0.25)
        lins = [self.bottleneck, self.head]
        norms = [self.in_ln]
        for blk in self.blocks:
            for path in (blk["intra"], blk["inter"]):
                for layer in _path_layers(cfg, path):
                    lins += [layer[n] for n in ("qkv", "out", "ff1", "ff2")]
                    norms += [layer["ln1"], layer["ln2"]]
                if cfg.published:
                    norms += [path["ln"], path["gln"]]
        if cfg.published:
            lins += [self.gate_tanh, self.gate_sigmoid]
        for p in lins:
            linear_draw_(p, generator)
        if cfg.published:
            self.gate_end.uniform_(-kd, kd, generator=generator)
        for p in norms:
            p["g"].fill_(1.0)
            p["b"].zero_()

    def forward(self, wav: torch.Tensor, sample_lengths: torch.Tensor) -> torch.Tensor:
        """(B, L) padded waveforms -> (B, S, L) estimated sources (rows not
        trimmed to their lengths)."""
        return _separate(self, wav, sample_lengths)


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


def _fold_mask(key_mask: torch.Tensor, cfg: Config) -> torch.Tensor:
    """The key mask as a path's attentions take it: (R, T) for the einsum
    path, repeated over the heads to K5's rows (R * heads, T) for the
    fused one."""
    if not cfg.fused_attention:
        return key_mask
    R, T = key_mask.shape
    return key_mask[:, None, :].expand(R, cfg.heads, T).reshape(R * cfg.heads, T).contiguous()


def _attention(layer, x: torch.Tensor, key_mask: torch.Tensor, cfg: Config,
               pe: bool = True) -> torch.Tensor:
    """Pre-LN MHA + FFN over axis 1. x (R, T, H); key_mask 1.0 at true KEY
    positions, as ``_fold_mask`` gives it (pad-row queries give junk the
    caller re-zeroes). ``pe``: the sinusoidal PE is added to the attention's
    input (the compact structure)."""
    R, T, H = x.shape
    ad = x.dtype
    nh, dh = cfg.heads, H // cfg.heads
    md = cfg.torch_dtype

    def lin(t, name):
        return any_order_dot(t, layer[name]["w"], md, ad, layer[name]["b"])
    y = cln(x, layer["ln1"])
    if pe:
        y = y + _pe_tensor(T, H, x.device, ad)
    qkv = lin(y, "qkv").reshape(R, T, 3, nh, dh)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]       # (R, T, nh, dh)
    if cfg.fused_attention:
        def fold(t):
            return t.permute(0, 2, 1, 3).reshape(R * nh, T, dh).contiguous()
        o = chunk_attention(fold(q), fold(k), fold(v), key_mask)
        o = o.reshape(R, nh, T, dh).permute(0, 2, 1, 3).reshape(R, T, H).to(ad)
    else:
        # the products' sums and the softmax in float32
        logits = torch.einsum("rqhd,rkhd->rhqk", q.float(), k.float()) / math.sqrt(dh)
        logits = logits + (1.0 - key_mask)[:, None, None, :] * (-1e9)
        w = torch.softmax(logits, dim=-1).to(ad)
        o = torch.einsum("rhqk,rkhd->rqhd", w.float(), v.float()).reshape(R, T, H).to(ad)
    x = x + lin(o, "out")
    y = lin(cln(x, layer["ln2"]), "ff1")
    return x + lin(torch.relu(y), "ff2")


def _path(path, x: torch.Tensor, key_mask: torch.Tensor, cfg: Config) -> torch.Tensor:
    """One path's transformer stack over axis 1 of x (R, T, H): its layers,
    the PE added inside each; published, the PE added once to the stack's
    input instead, and the stack ending in its LayerNorm."""
    km = _fold_mask(key_mask, cfg)
    if cfg.published:
        x = x + _pe_tensor(x.shape[1], x.shape[2], x.device, x.dtype)
    for layer in _path_layers(cfg, path):
        x = _attention(layer, x, km, cfg, pe=not cfg.published)
    return cln(x, path["ln"]) if cfg.published else x


def _around(path, h: torch.Tensor, y: torch.Tensor, cmask: torch.Tensor, cfg: Config
            ) -> torch.Tensor:
    """A path's output y (B, C, K, H) into the block's stream h:
    published, h + gLN(y) (masked statistics, eps 1e-8), else y; pad
    positions re-zeroed."""
    out = h + gln(y, path["gln"], cmask, eps=1e-8) if cfg.published else y
    return out * cmask.to(out.dtype)


def _dual_path(model: SepFormer, h: torch.Tensor, vt: torch.Tensor, C: int):
    """(B, C, K, H) chunked latents -> same shape after the blocks; also
    returns the chunk mask (B, C, K, 1) float32."""
    cfg = model.cfg
    B = h.shape[0]
    K, H = cfg.chunk, cfg.channels
    dev = h.device
    _, cmask, n_chunks = chunk_masks(cfg, vt, C)
    kmask_intra = cmask[..., 0].reshape(B * C, K)
    kmask_inter = ((torch.arange(C, device=dev)[None, :] < n_chunks[:, None]).float()
                   [:, None, :].expand(B, K, C).reshape(B * K, C))
    h = h.to(cfg.torch_dtype)
    for blk in model.blocks:
        with span("sepformer.intra"):
            y = _path(blk["intra"], h.reshape(B * C, K, H), kmask_intra, cfg)
            h = _around(blk["intra"], h, y.reshape(B, C, K, H), cmask, cfg)
        with span("sepformer.inter"):
            y = _path(blk["inter"], h.transpose(1, 2).reshape(B * K, C, H), kmask_inter, cfg)
            h = _around(blk["inter"], h, y.reshape(B, K, C, H).transpose(1, 2), cmask, cfg)
    return h, cmask


def _out_gate(model: SepFormer, x: torch.Tensor) -> torch.Tensor:
    """The merged head output (B, T', S*N) float32 through the published
    gate, each speaker's N channels alike: tanh(x W_t + b_t) *
    sigmoid(x W_s + b_s), then the 1x1 without bias; float32."""
    cfg = model.cfg
    md = cfg.torch_dtype
    x = x.reshape(*x.shape[:-1], cfg.num_spk, cfg.n_filters)
    g = torch.tanh(dot(x, model.gate_tanh, md)) * torch.sigmoid(dot(x, model.gate_sigmoid, md))
    return rounded_dot(g, model.gate_end, md).flatten(-2)


def _separate(model: SepFormer, wav: torch.Tensor, sample_lengths: torch.Tensor
              ) -> torch.Tensor:
    gate = _out_gate if model.cfg.published else None
    return separate_core(model, wav, sample_lengths, _dual_path, gate)


@torch.inference_mode()
def separate(model: SepFormer, wav: torch.Tensor, sample_lengths: torch.Tensor
             ) -> torch.Tensor:
    """Serving entry (DOMAIN='time'): (B, L) padded waveforms and their
    (B,) sample counts -> (B, S, L) estimated sources."""
    return _separate(model, wav, sample_lengths)


def loss_fn(model: SepFormer, batch: dict, generator: torch.Generator | None, train: bool):
    """uPIT over negative SI-SNR for a waveform batch (``mix_wav`` (B, L),
    ``source_wavs`` (B, S, L), ``sample_lengths``, ``row_mask``): returns
    (total / norm, aux) with norm the number of real rows. The model has no
    randomness and no mode, so ``generator`` and ``train`` are unused."""
    mix, n = batch["mix_wav"], batch["sample_lengths"]
    if model.cfg.remat and torch.is_grad_enabled():
        est = checkpoint(_separate, model, mix, n, use_reentrant=False)
    else:
        est = _separate(model, mix, n)
    return pit_si_snr_loss(est, batch, model.cfg.num_spk)

Model = SepFormer
