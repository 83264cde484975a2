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
          (sum lengths * row_mask * feat_dim) (``contract_loss``).
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
from ..ops.batchnorm import BatchNorm, remat_checkpoint
from ..ops.mxu import column_dot, rounded_dot
from ..ops.pit import pairwise_mse, permutation_min_loss
from ..parallel.ranks import copy_to_model, gather_from_model, global_sum
from ..utils.spans import span

NAME = "uPIT"
DOMAIN = "spectrum"


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
        return cls(**_coerce_kwargs(cls, kwargs))

    @property
    def input_dim(self) -> int:
        return self.feat_dim

    @property
    def out_dim(self) -> int:
        return self.feat_dim * self.num_spk

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32


def _coerce_kwargs(cls, kwargs: dict) -> dict:
    """Coerce the reference's all-string key=value config values onto the
    dataclass field types; unknown keys are dropped."""
    fields = {f.name: str(f.type) for f in dataclasses.fields(cls)}
    clean = {}
    for k, v in kwargs.items():
        if k not in fields:
            continue
        t = fields[k]
        if "bool" in t:
            clean[k] = str(v).lower() in ("1", "true", "yes")
        elif "int" in t:
            clean[k] = int(v)
        else:
            clean[k] = str(v)
    return clean


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


def contract_loss(model: nn.Module, batch: dict, *state: torch.Tensor, train: bool):
    """The uPIT-contract objective, one implementation for every arch whose
    forward ``model(mix, lengths, row_mask, *state, train=train)`` gives
    (B, T, feat_dim*num_spk) sigmoid masks (uPIT with its initial (h0, c0),
    TCN with none), as speech_separation_tpu/models/upit.py::contract_loss:
    for a batch dict with ``mix`` (B, T, F), ``sources`` (B, S, T, F),
    ``lengths`` (B,) and ``row_mask`` (B,), returns (total / norm, aux) with
    aux ``norm`` (for the norm-weighted epoch average), ``total``,
    ``best_perm`` and ``masked`` (B, T, S, F). With ``cfg.remat`` and grad
    enabled the forward is recomputed in the backward."""
    cfg = model.cfg
    mix, sources = batch["mix"], batch["sources"]
    lengths, row_mask = batch["lengths"], batch["row_mask"]
    B, T, F = mix.shape
    args = (mix, lengths, row_mask, *state)
    if cfg.remat and torch.is_grad_enabled():
        masks = remat_checkpoint(model, *args, train=train)
    else:
        masks = model(*args, train=train)
    with span("train.loss"):
        masked = masks.reshape(B, T, cfg.num_spk, F) * mix[:, :, None, :]
        min_losses, best_perm = permutation_min_loss(pairwise_mse(masked, sources),
                                                     cfg.num_spk)
        total = torch.sum(min_losses * row_mask) / cfg.num_spk
        # over data-parallel ranks: this rank's total over the global norm
        norm = global_sum(torch.sum(lengths.to(torch.float32) * row_mask) * cfg.feat_dim,
                          "norm")
        return total / norm, {"norm": norm, "total": total, "best_perm": best_perm,
                              "masked": masked}


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
