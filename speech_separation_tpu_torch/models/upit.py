"""uPIT architecture: BLSTM mask estimation with utterance-level
permutation-invariant training.

The counterpart of speech_separation_tpu/models/upit.py:

  model:  bidirectional LSTM (num_layers x hidden per direction) over the
          mixture magnitude spectra -> BatchNorm1d(2*hidden) on the padded
          output (padding frames included in the statistics) -> Linear(
          2*hidden -> feat_dim*num_spk) -> sigmoid, giving num_spk masks
          stacked along the frequency axis.
  loss:   min over speaker permutations of the summed elementwise MSE
          between mask * mixture and the permuted source magnitudes;
          scalar = (sum_b min_perm * row_mask / num_spk) /
          (sum lengths * row_mask * feat_dim) (models/spectral.contract_loss).
  infer:  the same forward in eval mode; source s is the feat_dim-sized
          slice [s*feat_dim : (s+1)*feat_dim] of the output.

The initial LSTM state is drawn from N(0, 1) per batch (a reference quirk);
``zero_init_hidden=True`` gives the deterministic variant. ``remat=True``
recomputes the whole forward in the backward (torch.utils.checkpoint), as the
JAX package wraps it in ``jax.checkpoint``: the state is drawn before it, and
BN's running statistics move once a step all the same.

Parameter names follow the reference ``.mdl`` state dict: ``blstm.*``
(torch.nn.LSTM names), ``bn.*`` (BatchNorm1d) and ``lin.*`` (Linear).

Tensor parallelism (parallel/mesh.shard_params; ``tp`` "head" or
"lstm_gates"): the head is column-parallel. Each rank of the model group
holds a block of ``lin``'s output rows, multiplies the replicated BN output
(``copy_to_model``) by it, adds its bias block, and the logits are gathered
whole before the sigmoid and the loss. BN stays replicated over the model
group, its statistics summed over the data group.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from .blstm import BLSTM, random_hidden
from .layers import coerce_kwargs
from .spectral import contract_loss
from ..ops.batchnorm import BatchNorm
from ..ops.mxu import column_dot, rounded_dot
from ..parallel.ranks import copy_to_model, gather_from_model

NAME = "uPIT"
DOMAIN = "spectrum"
# the kernel sources (ops/_build.TABLE) its training and serving launch: the
# LSTM recurrences (K1, K3; K4), and the STFT (K2) for on-device features
# and serving
KERNELS = ("lstm_fwd", "lstm_bwd", "stft")


@dataclasses.dataclass(frozen=True)
class Config:
    feat_dim: int = 257
    num_spk: int = 2
    hidden: int = 600
    num_layers: int = 2
    zero_init_hidden: bool = False
    # product input dtype: "bfloat16" rounds the inputs of the products to
    # bf16 (f32 accumulation; gate/cell math stays f32); "float32" is the
    # bit-faithful default
    compute_dtype: str = "float32"
    # recompute the forward in the backward: activation memory for compute
    remat: bool = False

    @classmethod
    def from_kwargs(cls, **kwargs):
        """Accept the reference's key=value model-config strings."""
        return cls(**coerce_kwargs(cls, kwargs))

    @property
    def input_dim(self) -> int:
        return self.feat_dim

    @property
    def out_dim(self) -> int:
        return self.feat_dim * self.num_spk

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32


class UPIT(nn.Module):
    """BLSTM -> padded BN -> linear -> sigmoid, from ``cfg.input_dim`` to
    ``cfg.out_dim`` features a frame (models/rsh.py's model too)."""

    # "head" or "lstm_gates": split over the model group (parallel/mesh.place)
    tp: str | None = None

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.blstm = BLSTM(cfg.input_dim, cfg.hidden, cfg.num_layers)
        self.bn = BatchNorm(2 * cfg.hidden)
        self.lin = nn.Linear(2 * cfg.hidden, cfg.out_dim)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """The JAX package's init: BLSTM as torch.nn.LSTM, the head
        U(-1/sqrt(2H), 1/sqrt(2H)), BN at identity."""
        self.blstm.reset_parameters(generator)
        kb = 1.0 / math.sqrt(2 * self.cfg.hidden)
        with torch.no_grad():
            self.lin.weight.uniform_(-kb, kb, generator=generator)
            self.lin.bias.uniform_(-kb, kb, generator=generator)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                row_mask: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                train: bool = False, return_state: bool = False):
        """x: (B, T, input_dim); returns masks (B, T, out_dim), and with
        ``return_state`` also the BLSTM's final (h_n, c_n)."""
        dt = self.cfg.torch_dtype
        y, state = self.blstm(x, lengths, h0, c0, compute_dtype=dt)
        y = self.bn(y, row_mask, train)
        if self.tp is None:
            y = torch.sigmoid(rounded_dot(y, self.lin.weight.t(), dt) + self.lin.bias)
        else:
            logits = column_dot(y, self.lin.weight.t(), dt) + self.lin.bias
            y = torch.sigmoid(gather_from_model(logits, dim=-1))
        return (y, state) if return_state else y


def initial_state(cfg: Config, batch: int, generator: torch.Generator,
                  device: torch.device):
    """(h0, c0) for one batch: zeros, or the reference's N(0, 1) draw."""
    if cfg.zero_init_hidden:
        shape = (cfg.num_layers, 2, batch, cfg.hidden)
        zeros = torch.zeros(shape, dtype=torch.float32, device=device)
        return zeros, zeros
    return random_hidden(generator, cfg.num_layers, batch, cfg.hidden)


def loss_fn(model: UPIT, batch: dict, generator: torch.Generator, train: bool):
    """``contract_loss`` with the batch's initial state: zeros, or the
    reference's N(0, 1) draw from ``generator``."""
    h0, c0 = initial_state(model.cfg, batch["mix"].shape[0], generator,
                           batch["mix"].device)
    return contract_loss(model, batch, h0, c0, train=train)


@torch.inference_mode()
def infer_masks(model: UPIT, batch: dict, generator: torch.Generator,
                state=None) -> torch.Tensor:
    """Eval-mode masks (B, T, feat_dim*num_spk) for a batch dict with
    ``mix`` (B, T, F), ``lengths`` (B,) and ``row_mask`` (B,); the initial
    (h0, c0) drawn from ``generator``, or ``state`` when given (a replica's
    rows of a whole batch's draw)."""
    mix = batch["mix"]
    h0, c0 = state or initial_state(model.cfg, mix.shape[0], generator, mix.device)
    return model(mix, batch["lengths"], batch["row_mask"], h0, c0, train=False)


Model = UPIT
