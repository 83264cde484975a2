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

The encoder, decoder and loss are models/waveform.py's, shared with DPRNN
and SepFormer; the norms and products models/layers.py's. Parameters are
named as the JAX pytree's paths (``enc``, ``bottleneck.w``,
``blocks.0.dw``, ...) in its (in, out) layout
(utils/weights.pytree_state_dict_from_jax carries weights across).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import tcn
from .layers import cln, cln_init, coerce_kwargs, dot, linear_draw_, linear_init, norm, prelu
from .tcn import Block, run_blocks
from .waveform import decode, encode, pit_si_snr_loss
from ..ops.mxu import column_dot
from ..parallel.ranks import gather_from_model

NAME = "ConvTasNet"
DOMAIN = "time"
# no hand-written kernel with its default global norm; norm="cln" and the
# causal streaming model launch the channelwise LayerNorm (K6) at first use
KERNELS = ()
# the blocks' conv context, as TCN's (eval/streaming.py reads it off the arch)
init_stream_state = tcn.init_stream_state


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
        return cls(**coerce_kwargs(cls, kwargs))

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


# -------------------------------------------------------------------- model

class ConvTasNet(nn.Module):
    # "convtasnet": Megatron blocks over the model group (parallel/mesh.place)
    tp: str | None = None

    def __init__(self, cfg: Config, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.enc = nn.Parameter(torch.empty(cfg.filter_len, cfg.n_filters))
        self.dec = nn.Parameter(torch.empty(cfg.n_filters, cfg.filter_len))
        self.in_ln = cln_init(cfg.n_filters)
        self.bottleneck = linear_init(cfg.n_filters, cfg.channels)
        self.head = linear_init(cfg.channels, cfg.n_filters * cfg.num_spk)
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
        linear_draw_(self.bottleneck, generator)
        linear_draw_(self.head, generator)
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
            out = dot(prelu(skips, self.head_prelu), self.head, cfg.torch_dtype)
        else:
            out = column_dot(prelu(skips, self.head_prelu), self.head["w"], cfg.torch_dtype)
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
            return norm(x, p, tmask, cfg.norm, over_model=split)

        h = dot(norm(w.to(ad), self.in_ln, tmask, cfg.norm), self.bottleneck, ad, ad) * tm
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
        h = dot(cln(w.to(ad), self.in_ln), self.bottleneck, ad, ad)
        skips, new_state = run_blocks(self.blocks, cfg, h, cln, None, conv_state)
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
