"""RSH architecture: recurrent selective hearing, the reference's iterative
one-speaker-at-a-time extraction with a residual attention channel.

The counterpart of speech_separation_tpu/models/rsh.py:

  input:  combo = concat(mix magnitude, attention) along frequency, the
          attention one within each row's length and zero past it;
  model:  BLSTM(2 * feat_dim -> hidden x 2, num_layers) -> padded BN ->
          linear(2 * hidden -> feat_dim) -> sigmoid: ONE mask per pass;
  loss:   S passes over a batch of one speaker count S (the trainer groups
          batches by count, or splits a mixed batch into sub-batches). Each
          pass estimates a mask, takes its MSE against every source, sets the
          sources the row has already claimed to +inf, claims the first
          argmin, and subtracts the mask from the attention channel. The loss
          path always relus the residual (combo - [0, mask]), in CV too; only
          BN follows the train flag. ``infer_masks`` never relus;
  state:  the LSTM state carries from one pass into the next: the BLSTM's
          final (h, c) of pass p are pass p+1's initial state, and in
          training the gradient flows back through them (through the
          training kernels' dh0/dc0 on CUDA). BN's running statistics
          update once per pass in train mode.

The initial state of the first pass is the reference's N(0, 1) draw per
batch, or zeros with ``zero_init_hidden``. Parameter names are those of the
reference ``.mdl`` (``blstm.*``, ``bn.*``, ``lin.*``), the uPIT layout with a
2F input. ``remat=True`` recomputes each pass in the backward, as the JAX
package checkpoints each pass; the (h, c) carried from pass to pass crosses
the boundary, and BN's running statistics move once a pass all the same.
"""

from __future__ import annotations

import dataclasses

import torch

from .layers import coerce_kwargs
from .upit import UPIT, initial_state
from ..ops.batchnorm import remat_checkpoint
from ..parallel.ranks import global_sum
from ..utils.spans import span

NAME = "RSH"
DOMAIN = "spectrum"
# the kernel sources (ops/_build.TABLE) it launches: uPIT's
KERNELS = ("lstm_fwd", "lstm_bwd", "stft")


@dataclasses.dataclass(frozen=True)
class Config:
    feat_dim: int = 257
    hidden: int = 600
    num_layers: int = 2
    zero_init_hidden: bool = False
    # the speaker count is the batch's, not the model's; this default is the
    # count a caller gets when it names none
    num_spk: int = 2
    compute_dtype: str = "float32"   # as upit.Config
    remat: bool = False              # recompute each pass in the backward

    @classmethod
    def from_kwargs(cls, **kwargs):
        return cls(**coerce_kwargs(cls, kwargs))

    @property
    def input_dim(self) -> int:
        return 2 * self.feat_dim

    @property
    def out_dim(self) -> int:
        return self.feat_dim

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32


class RSH(UPIT):
    """BLSTM -> padded BN -> linear -> sigmoid, one mask a pass; uPIT's
    module with a 2F input and an F output."""


def _make_combo(mix: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """concat(mix, ones within each row's length) along frequency."""
    B, T, F = mix.shape
    atten = (torch.arange(T, device=mix.device)[None, :] < lengths[:, None]).to(mix.dtype)
    return torch.cat([mix, atten[:, :, None].expand(B, T, F)], dim=-1)


def loss_fn(model: RSH, batch: dict, generator: torch.Generator, train: bool):
    """S greedy-assignment passes over a batch of one speaker count, S =
    ``sources.shape[1]``: returns (total / norm, aux) with aux ``norm`` (S *
    real frames * feat_dim), ``total`` (the sum over passes of each real
    row's claimed MSE, / S), ``assignments`` (B, S) and ``masks`` (B, S, T,
    F)."""
    cfg = model.cfg
    mix, sources = batch["mix"], batch["sources"]
    lengths, row_mask = batch["lengths"], batch["row_mask"]
    B, T, F = mix.shape
    S = sources.shape[1]
    combo = _make_combo(mix, lengths)
    state = initial_state(cfg, B, generator, mix.device)
    masks = []
    remat = cfg.remat and torch.is_grad_enabled()
    for _ in range(S):
        args = (combo, lengths, row_mask, *state)
        if remat:
            mask, state = remat_checkpoint(model, *args, train=train, return_state=True)
        else:
            mask, state = model(*args, train=train, return_state=True)
        masks.append(mask)
        # the loss path relus the residual, CV included
        combo = torch.relu(combo - torch.cat([torch.zeros_like(mask), mask], dim=-1))
    # the passes' inputs do not depend on the claims, so the objective
    # follows all of them
    with span("train.loss"):
        used = torch.zeros((B, S), dtype=torch.bool, device=mix.device)
        total = 0.0
        assignments = []
        for mask in masks:
            err = torch.sum(torch.square((mask * mix)[:, None] - sources), dim=(2, 3))
            err = torch.where(used, torch.full_like(err, float("inf")), err)
            # the first of tied values, as jnp.argmin (pad rows tie at 0)
            idx = torch.argmin(err, dim=1)
            min_losses = torch.gather(err, 1, idx[:, None])[:, 0]
            used = used | torch.nn.functional.one_hot(idx, S).bool()
            total = total + torch.sum(min_losses * row_mask) / S
            assignments.append(idx)
        # over data-parallel ranks: this rank's total over the global norm
        norm = global_sum(S * torch.sum(lengths.to(torch.float32) * row_mask) * cfg.feat_dim,
                          "norm")
        return total / norm, {"norm": norm, "total": total,
                              "assignments": torch.stack(assignments, dim=1),
                              "masks": torch.stack(masks, dim=1)}


@torch.inference_mode()
def infer_masks(model: RSH, batch: dict, generator: torch.Generator,
                num_spk: int, state=None) -> torch.Tensor:
    """Eval-mode masks (B, num_spk, T, F) in pass order (saved as s1..sN)
    for a batch dict with ``mix`` (B, T, F), ``lengths`` and ``row_mask``.
    The residual is subtracted without a relu. The initial (h0, c0) is
    drawn from ``generator``, or ``state`` when given."""
    mix = batch["mix"]
    combo = _make_combo(mix, batch["lengths"])
    state = state or initial_state(model.cfg, mix.shape[0], generator, mix.device)
    masks = []
    for _ in range(num_spk):
        mask, state = model(combo, batch["lengths"], batch["row_mask"], *state,
                            return_state=True)
        masks.append(mask)
        combo = combo - torch.cat([torch.zeros_like(mask), mask], dim=-1)
    return torch.stack(masks, dim=1)


Model = RSH
