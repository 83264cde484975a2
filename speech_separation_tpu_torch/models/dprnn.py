"""DPRNN: dual-path recurrent separation in a learned encoder basis.

The counterpart of speech_separation_tpu/models/dprnn.py (Luo, Chen and
Yoshioka, ICASSP 2020), a time-domain arch trained with uPIT over negative
SI-SNR on waveforms:

  encoder:   overlapping frames (filter_len, stride) -> ReLU linear basis
  segment:   latent frames (B, T', H) -> 50%-overlap chunks (B, C, K, H),
             hop P = K/2, with P zeros in front and at least P behind, so
             every real frame lies in exactly two chunks and the averaged
             merge inverts the segmentation exactly
  separator: ``blocks`` x [intra-chunk BLSTM over the K frames of every
             chunk (B*C rows) -> linear 2h->H -> masked gLN -> residual;
             inter-chunk BLSTM over the C chunks at every position (B*K
             rows) -> linear -> masked gLN -> residual]
  head:      PReLU + linear H -> S*N on the chunks, merge, ReLU (or
             sigmoid) masks
  decoder:   masked latents -> linear basis -> overlap-add
  loss:      min over speaker permutations of negative SI-SNR.

Both BLSTMs of a block are the port's ``BLSTM`` (models/blstm.py) with zero
initial state and true lengths: each chunk's count of real frames for the
intra-chunk one (0 for a chunk that lies wholly in a row's padding), each
row's count of chunks for the inter-chunk one. So their recurrences run
through the hand-written LSTM kernels on CUDA (the training forward and
backward under grad, the inference forward otherwise), and a row's output
does not depend on the padding of the batch it rides in. ``remat`` recomputes
one dual-path block at a time in the backward (torch.utils.checkpoint), as
the JAX package checkpoints each block.

The segmentation, head and merge around the blocks are models/
dual_path.py's, shared with SepFormer; the encoder, decoder and loss
models/waveform.py's.

Parameters are named as the JAX pytree's paths (``enc``, ``in_ln.g``,
``blocks.0.intra_proj.w``, ...) in its (in, out) layout, except the BLSTMs,
which carry torch.nn.LSTM's names (``blocks.0.intra_rnn.weight_ih_l0``)
(utils/weights.dprnn_state_dict_from_jax carries weights across).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .blstm import BLSTM
from .dual_path import chunk_masks, separate_core
from .layers import cln_init, coerce_kwargs, dot, gln, linear_draw_, linear_init
from .waveform import pit_si_snr_loss

NAME = "DPRNN"
DOMAIN = "time"
# the kernel sources (ops/_build.TABLE) it launches: the LSTM recurrences
# (K1, K3; K4); it works on waveforms, without the STFT
KERNELS = ("lstm_fwd", "lstm_bwd")


@dataclasses.dataclass(frozen=True)
class Config:
    num_spk: int = 2
    n_filters: int = 64      # encoder basis size (the paper's N)
    filter_len: int = 16     # encoder window in samples (2 ms at 8 kHz)
    stride: int = 8          # encoder hop
    channels: int = 64       # dual-path feature width
    rnn_hidden: int = 128    # BLSTM hidden units per direction
    chunk: int = 100         # intra-chunk length K; hop is chunk // 2
    blocks: int = 6          # dual-path blocks
    mask_act: str = "relu"   # "relu" | "sigmoid"
    compute_dtype: str = "float32"  # "bfloat16": bf16 products and activations
    remat: bool = False      # recompute each dual-path block in the backward

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

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32

    @property
    def hop(self) -> int:
        """Segmentation hop P = K/2 (50% chunk overlap)."""
        return self.chunk // 2


def _block(cfg: Config) -> nn.ModuleDict:
    """One dual-path block: per path a 1-layer BLSTM, its projection back to
    the channels and its gLN."""
    return nn.ModuleDict({
        "intra_rnn": BLSTM(cfg.channels, cfg.rnn_hidden, 1),
        "intra_proj": linear_init(2 * cfg.rnn_hidden, cfg.channels),
        "intra_ln": cln_init(cfg.channels),
        "inter_rnn": BLSTM(cfg.channels, cfg.rnn_hidden, 1),
        "inter_proj": linear_init(2 * cfg.rnn_hidden, cfg.channels),
        "inter_ln": cln_init(cfg.channels),
    })


class DPRNN(nn.Module):
    def __init__(self, cfg: Config, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.enc = nn.Parameter(torch.empty(cfg.filter_len, cfg.n_filters))
        self.dec = nn.Parameter(torch.empty(cfg.n_filters, cfg.filter_len))
        self.in_ln = cln_init(cfg.n_filters)
        self.bottleneck = linear_init(cfg.n_filters, cfg.channels)
        self.head = linear_init(cfg.channels, cfg.n_filters * cfg.num_spk)
        self.head_prelu = nn.Parameter(torch.full((cfg.channels,), 0.25))
        self.blocks = nn.ModuleList(_block(cfg) for _ in range(cfg.blocks))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Draw every parameter in place from the JAX package's
        distributions: the encoder U(+-1/sqrt(filter_len)), the decoder
        U(+-1/sqrt(n_filters)), linear layers U(+-1/sqrt(n_in)), the BLSTMs
        as torch.nn.LSTM, norms at identity, PReLU 0.25. The parameters and
        ``generator`` must be on one device."""
        cfg = self.cfg
        kb, kd = 1.0 / math.sqrt(cfg.filter_len), 1.0 / math.sqrt(cfg.n_filters)
        self.enc.uniform_(-kb, kb, generator=generator)
        self.dec.uniform_(-kd, kd, generator=generator)
        self.head_prelu.fill_(0.25)
        linear_draw_(self.bottleneck, generator)
        linear_draw_(self.head, generator)
        norms = [self.in_ln]
        for blk in self.blocks:
            for path in ("intra", "inter"):
                blk[f"{path}_rnn"].reset_parameters(generator)
                linear_draw_(blk[f"{path}_proj"], generator)
                norms.append(blk[f"{path}_ln"])
        for p in norms:
            p["g"].fill_(1.0)
            p["b"].zero_()

    def forward(self, wav: torch.Tensor, sample_lengths: torch.Tensor) -> torch.Tensor:
        """(B, L) padded waveforms -> (B, S, L) estimated sources (rows not
        trimmed to their lengths)."""
        return separate_core(self, wav, sample_lengths, _dual_path)


# ------------------------------------------------------- dual-path pieces

def _one_block(blk, h, cmask, klens, ilens, zeros_intra, zeros_inter):
    """One dual-path block on (B, C, K, H) chunked latents in the compute
    dtype; cmask (B, C, K, 1) float32."""
    B, C, K, H = h.shape
    dt = h.dtype
    cm = cmask.to(dt)
    y, _ = blk["intra_rnn"](h.reshape(B * C, K, H), klens, zeros_intra, zeros_intra,
                            compute_dtype=dt)
    y = dot(y, blk["intra_proj"], dt, dt).reshape(B, C, K, H)
    h = (h + gln(y, blk["intra_ln"], cmask)) * cm
    y, _ = blk["inter_rnn"](h.transpose(1, 2).reshape(B * K, C, H), ilens, zeros_inter,
                            zeros_inter, compute_dtype=dt)
    y = dot(y, blk["inter_proj"], dt, dt).reshape(B, K, C, H).transpose(1, 2)
    return (h + gln(y, blk["inter_ln"], cmask)) * cm


def _dual_path(model: DPRNN, h: torch.Tensor, vt: torch.Tensor, C: int):
    """(B, C, K, H) chunked latents -> same shape after the blocks; also
    returns the chunk mask (B, C, K, 1) float32."""
    cfg = model.cfg
    B = h.shape[0]
    K, hid = cfg.chunk, cfg.rnn_hidden
    dev = h.device
    clens, cmask, n_chunks = chunk_masks(cfg, vt, C)
    klens = clens.reshape(B * C).to(torch.int32)
    ilens = n_chunks[:, None].expand(B, K).reshape(B * K).to(torch.int32)
    zeros_intra = torch.zeros((1, 2, B * C, hid), device=dev)
    zeros_inter = torch.zeros((1, 2, B * K, hid), device=dev)
    h = h.to(cfg.torch_dtype)
    remat = cfg.remat and torch.is_grad_enabled()
    for blk in model.blocks:
        args = (blk, h, cmask, klens, ilens, zeros_intra, zeros_inter)
        h = checkpoint(_one_block, *args, use_reentrant=False) if remat else _one_block(*args)
    return h, cmask


@torch.inference_mode()
def separate(model: DPRNN, wav: torch.Tensor, sample_lengths: torch.Tensor) -> torch.Tensor:
    """Serving entry (DOMAIN='time'): (B, L) padded waveforms and their
    (B,) sample counts -> (B, S, L) estimated sources."""
    return separate_core(model, wav, sample_lengths, _dual_path)


def loss_fn(model: DPRNN, batch: dict, generator: torch.Generator | None, train: bool):
    """uPIT over negative SI-SNR for a waveform batch (``mix_wav`` (B, L),
    ``source_wavs`` (B, S, L), ``sample_lengths``, ``row_mask``). The model
    has no randomness and no mode, so ``generator`` and ``train`` are
    unused; ``remat`` acts per block inside the dual path."""
    est = separate_core(model, batch["mix_wav"], batch["sample_lengths"], _dual_path)
    return pit_si_snr_loss(est, batch, model.cfg.num_spk)


Model = DPRNN
