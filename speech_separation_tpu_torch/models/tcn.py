"""TCN: dilated temporal-convolution mask estimation on STFT magnitudes.

The counterpart of speech_separation_tpu/models/tcn.py: the Conv-TasNet
masking stack (Luo and Mesgarani, 2019) on the uPIT contract, so it trains,
infers and serves through uPIT's batches, loss and (B, T, S*F) sigmoid-mask
head:

  model: cLN -> 1x1 input projection (F -> channels) -> R repeats of X
         residual blocks (1x1 -> PReLU -> cLN -> depthwise dilated conv,
         dilation 2^x -> PReLU -> cLN -> 1x1 residual + 1x1 skip) -> PReLU
         over the summed skips -> 1x1 head (-> S*F) -> sigmoid.
  loss:  uPIT's (models/spectral.contract_loss, one implementation for both).
  infer: the same forward; it has no mode and draws nothing.

Frames past each row's length are zeroed after the input projection, before
every depthwise conv and after every block, so a row's masks do not depend
on the padding of its batch. The norms are per frame (cLN): no running
statistics. With ``compute_dtype=bfloat16`` the 1x1 products take bf16
inputs with float32 sums (ops/mxu.rounded_dot) and the trunk's activations are
stored in bf16; the norm statistics and the head's logits are float32.

``causal=True`` pads every depthwise conv on the left only, so frame t
depends on frames <= t: the streaming variant. ``streaming_forward`` runs
one chunk of it with each block's conv context carried as state
(eval/streaming.py); ``remat=True`` recomputes the forward in the backward.

The 1x1 products are torch.matmul and the depthwise convs
torch.nn.functional.conv1d (groups = hidden), as the JAX package leaves them
to XLA outside any kernel; the norms, products and PReLU are models/
layers.py's.

Also here, for models/convtasnet.py, whose separator is this stack: the
residual ``Block``, ``run_blocks`` and the streaming conv state. Parameter
names read as the JAX pytree's paths (``in_proj.w``, ``blocks.3.dw``;
utils/weights.pytree_state_dict_from_jax carries weights across).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import cln, cln_init, coerce_kwargs, dot, linear_draw_, linear_init, prelu, row_dot
from .spectral import contract_loss
from ..ops.mxu import column_dot

NAME = "TCN"
DOMAIN = "spectrum"
# the kernel sources (ops/_build.TABLE) it launches: the STFT (K2) for
# on-device features and serving, the channelwise LayerNorm (K6)
KERNELS = ("stft", "layernorm")


@dataclasses.dataclass(frozen=True)
class Config:
    feat_dim: int = 257
    num_spk: int = 2
    channels: int = 256      # residual path width (Conv-TasNet B)
    hidden: int = 512        # block inner width (Conv-TasNet H)
    kernel: int = 3          # depthwise kernel size (P)
    blocks: int = 8          # dilated blocks per repeat (X): dilation 2^x
    repeats: int = 4         # repeats (R)
    compute_dtype: str = "float32"  # "bfloat16": bf16 products and activations
    remat: bool = False      # recompute the forward in the backward
    causal: bool = False     # left-only conv padding: the streaming variant

    @classmethod
    def from_kwargs(cls, **kwargs):
        return cls(**coerce_kwargs(cls, kwargs))

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32

    def dilations(self) -> list:
        return [2 ** (i % self.blocks) for i in range(self.repeats * self.blocks)]

    @property
    def receptive_field(self) -> int:
        """Frames of (left, in causal mode) context one output depends on."""
        return 1 + (self.kernel - 1) * sum(self.dilations())


# ------------------------------------------------------------ depthwise conv

def _conv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, dilation: int,
          pad: tuple[int, int]) -> torch.Tensor:
    """Depthwise conv over time in x's dtype: x (B, T, H), kernel (K, H) as
    a cross-correlation, ``pad`` zeros (left, right) around the frames, then
    the bias."""
    xt = F.pad(x.transpose(1, 2), pad)
    w = kernel.to(x.dtype).t().unsqueeze(1)                       # (H, 1, K)
    y = F.conv1d(xt, w, dilation=dilation, groups=x.shape[-1])
    return y.transpose(1, 2) + bias.to(x.dtype)


def _depthwise(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, dilation: int,
               causal: bool = False) -> torch.Tensor:
    """Depthwise dilated conv over time, x (B, T, H), kernel (K, H): centred
    ((K-1)//2*d zeros each side) or causal ((K-1)*d on the left)."""
    K = kernel.shape[0]
    pad = ((K - 1) * dilation, 0) if causal else ((K - 1) // 2 * dilation,) * 2
    return _conv(x, kernel, bias, dilation, pad)


# -------------------------------------------------------------------- model

class Block(nn.Module):
    """One residual block of the masking stack (TCN's and Conv-TasNet's)."""

    def __init__(self, channels: int, hidden: int, kernel: int):
        super().__init__()
        self.expand = linear_init(channels, hidden)
        self.prelu1 = nn.Parameter(torch.full((hidden,), 0.25))
        self.ln1 = cln_init(hidden)
        self.dw = nn.Parameter(torch.empty(kernel, hidden))
        self.dw_b = nn.Parameter(torch.empty(hidden))
        self.prelu2 = nn.Parameter(torch.full((hidden,), 0.25))
        self.ln2 = cln_init(hidden)
        self.res = linear_init(hidden, channels)
        self.skip = linear_init(hidden, channels)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """The JAX package's distributions: linear layers U(+-1/sqrt(n_in)),
        the depthwise kernel and its bias U(+-1/sqrt(K)), norms at identity,
        PReLU 0.25."""
        kd = 1.0 / math.sqrt(self.dw.shape[0])
        linear_draw_(self.expand, generator)
        self.dw.uniform_(-kd, kd, generator=generator)
        self.dw_b.uniform_(-kd, kd, generator=generator)
        linear_draw_(self.res, generator)
        linear_draw_(self.skip, generator)
        for p in (self.prelu1, self.prelu2):
            p.fill_(0.25)
        for ln in (self.ln1, self.ln2):
            ln["g"].fill_(1.0)
            ln["b"].zero_()


def run_blocks(blocks, cfg, h: torch.Tensor, norm, tm: torch.Tensor | None,
               conv_state: list | None = None, split: bool = False):
    """The residual stack shared by TCN and Conv-TasNet, offline and
    streaming: h (B, T, channels) in the activation dtype; ``norm(x, p)``
    the block's norm; ``tm`` (B, T, 1) the frame mask in the activation
    dtype, or None (streaming: every frame is real). Offline, each
    depthwise conv pads as ``cfg.causal`` says; with ``conv_state`` (one
    context a block) each runs over its carried context instead. Returns the
    summed skips and, with ``conv_state``, the new contexts.

    ``split``: the blocks hold this rank's block of H (Megatron style,
    parallel/mesh.shard_params_convtasnet): ``expand`` column-parallel on
    the replicated h, the PReLUs, norms (``norm`` sums their statistics
    over the model group) and depthwise conv on the rank's H block, ``res``
    and ``skip`` row-parallel, so h and the skips stay replicated."""
    md = ad = cfg.torch_dtype
    skips, new_state = None, []
    for i, (blk, d) in enumerate(zip(blocks, cfg.dilations())):
        if split:
            y = (column_dot(h, blk.expand["w"], md) + blk.expand["b"]).to(ad)
        else:
            y = dot(h, blk.expand, md, ad)
        y = norm(prelu(y, blk.prelu1), blk.ln1)
        if tm is not None:
            # masked before the conv: pad frames would otherwise carry bias
            # and norm constants into real frames' windows
            y = y * tm
        if conv_state is None:
            y = _depthwise(y, blk.dw, blk.dw_b, d, cfg.causal)
        else:
            y, ctx = stream_conv(y, blk, d, conv_state[i])
            new_state.append(ctx)
        y = norm(prelu(y, blk.prelu2), blk.ln2)
        out = row_dot if split else dot
        h = h + out(y, blk.res, md, ad)
        s = out(y, blk.skip, md, ad)
        if tm is not None:
            h, s = h * tm, s * tm
        skips = s if skips is None else skips + s
    return skips, new_state


def stream_conv(y: torch.Tensor, blk: Block, dilation: int, ctx: torch.Tensor):
    """One chunk of a causal depthwise conv: a VALID conv over concat(the
    carried context, y). Returns (y, the new context: the last (K-1)*d
    frames)."""
    full = torch.cat([ctx.to(y.dtype), y], dim=1)
    return (_conv(full, blk.dw, blk.dw_b, dilation, (0, 0)),
            full[:, full.shape[1] - ctx.shape[1]:])


def init_stream_state(cfg, batch: int = 1, device=None) -> list:
    """Zeroed depthwise-conv context, (B, (K-1)*d, hidden) float32 a block:
    zeros are the offline causal conv's left padding, so a stream started
    from them matches the offline forward."""
    return [torch.zeros((batch, (cfg.kernel - 1) * d, cfg.hidden), device=device)
            for d in cfg.dilations()]


class TCN(nn.Module):
    def __init__(self, cfg: Config, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.in_ln = cln_init(cfg.feat_dim)
        self.in_proj = linear_init(cfg.feat_dim, cfg.channels)
        self.head = linear_init(cfg.channels, cfg.feat_dim * cfg.num_spk)
        self.head_prelu = nn.Parameter(torch.full((cfg.channels,), 0.25))
        self.blocks = nn.ModuleList(Block(cfg.channels, cfg.hidden, cfg.kernel)
                                    for _ in range(cfg.repeats * cfg.blocks))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Draw every parameter in place from the JAX package's
        distributions (the input projection, the head, then each block). The
        parameters and ``generator`` must be on one device."""
        linear_draw_(self.in_proj, generator)
        linear_draw_(self.head, generator)
        self.head_prelu.fill_(0.25)
        self.in_ln["g"].fill_(1.0)
        self.in_ln["b"].zero_()
        for blk in self.blocks:
            blk.reset_parameters(generator)

    def _head(self, skips: torch.Tensor) -> torch.Tensor:
        # the head's logits back in float32
        return torch.sigmoid(dot(prelu(skips, self.head_prelu), self.head,
                                  self.cfg.torch_dtype))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, row_mask: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        """x (B, T, feat_dim) -> masks (B, T, feat_dim*num_spk), zero past
        each row's length; source s is [s*F, (s+1)*F). ``row_mask`` and
        ``train`` keep uPIT's signature: the forward has neither batch
        statistics nor a mode."""
        cfg = self.cfg
        ad = cfg.torch_dtype
        T = x.shape[1]
        tmask = (torch.arange(T, device=x.device)[None, :]
                 < lengths[:, None]).float()[:, :, None]
        tm = tmask.to(ad)
        h = dot(cln(x, self.in_ln), self.in_proj, ad, ad) * tm
        skips, _ = run_blocks(self.blocks, cfg, h, cln, tm)
        return self._head(skips) * tmask

    def streaming_forward(self, x: torch.Tensor, conv_state: list):
        """One chunk of the causal forward with each block's conv context:
        x (B, C, feat_dim) magnitude frames, all real. Returns (masks (B, C,
        feat_dim*num_spk), new conv state). On the concatenated stream it
        equals the offline causal forward: every op but the depthwise conv
        is per frame, and the conv sees its whole left context."""
        if not self.cfg.causal:
            raise ValueError("streaming_forward needs a causal config")
        ad = self.cfg.torch_dtype
        h = dot(cln(x, self.in_ln), self.in_proj, ad, ad)
        skips, new_state = run_blocks(self.blocks, self.cfg, h, cln, None, conv_state)
        return self._head(skips), new_state


def loss_fn(model: TCN, batch: dict, generator: torch.Generator | None, train: bool):
    """uPIT's objective (models/spectral.contract_loss) on a feature batch; the
    forward draws nothing, so ``generator`` is unused."""
    return contract_loss(model, batch, train=train)


@torch.inference_mode()
def infer_masks(model: TCN, batch: dict, generator: torch.Generator | None = None
                ) -> torch.Tensor:
    """Masks (B, T, feat_dim*num_spk) for a batch dict with ``mix`` (B, T,
    F), ``lengths`` (B,) and ``row_mask`` (B,)."""
    return model(batch["mix"], batch["lengths"], batch["row_mask"])


Model = TCN
