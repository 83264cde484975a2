"""The uPIT contract that uPIT and TCN share: sigmoid masks over magnitude
spectra, trained by the permutation-min MSE of the masked mixture against
the source magnitudes.

  loss: min over speaker permutations of the summed elementwise MSE
        between mask * mixture and the permuted source magnitudes;
        scalar = (sum_b min_perm * row_mask / num_spk) /
        (sum lengths * row_mask * feat_dim).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.batchnorm import remat_checkpoint
from ..ops.pit import pairwise_mse, permutation_min_loss
from ..parallel.ranks import global_sum
from ..utils.spans import span


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
