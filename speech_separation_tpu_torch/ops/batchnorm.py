"""Batch normalization with the reference's padded-statistics semantics.

The counterpart of speech_separation_tpu/ops/batchnorm.py. The reference
applies ``nn.BatchNorm1d(1200)`` to the *padded* BLSTM output, so padding
frames (exact zeros) count in the batch statistics; that is reproduced here.
``row_mask`` excludes shape-padding dummy rows from the statistics. Over
data-parallel ranks (parallel/ranks.py) the statistics are the global
batch's: each sum and the count are summed over the ranks, differentiably,
also when a remat forward is recomputed in the backward.

torch semantics: normalization uses the biased variance, the running
variance update the unbiased one (n/(n-1)); running = (1 - momentum) *
running + momentum * stat with momentum 0.1; eval mode normalizes with the
running statistics.

``remat_checkpoint`` recomputes a forward in the backward
(torch.utils.checkpoint) without moving the running statistics a second
time: the JAX package's ``jax.checkpoint`` takes the new BN state from the
first forward only.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel.ranks import global_sum


def batchnorm_apply(params: dict, state: dict, x: torch.Tensor,
                    row_mask: torch.Tensor, train: bool,
                    momentum: float = 0.1, eps: float = 1e-5):
    """Normalize x (B, T, C) over (batch, time) per channel.

    params: {"gamma", "beta"}; state: {"mean", "var"}; row_mask: (B,) float,
    1.0 for real rows (all their T positions count, padding included), 0.0
    for dummy rows. Returns (y, new_state)."""
    B, T, C = x.shape
    if train:
        rm = row_mask[:, None, None]
        # over data-parallel ranks the sums and the count are the whole
        # batch's (parallel/ranks.global_sum; each rank's own otherwise)
        n = global_sum(torch.sum(row_mask) * T, "bn")
        mean = global_sum(torch.sum(x * rm, dim=(0, 1)), "bn") / n
        var = global_sum(torch.sum(torch.square(x - mean) * rm, dim=(0, 1)), "bn") / n
        new_state = {
            "mean": (1.0 - momentum) * state["mean"] + momentum * mean,
            "var": (1.0 - momentum) * state["var"] + momentum * var * n / (n - 1.0),
        }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    y = (x - mean) / torch.sqrt(var + eps)
    return y * params["gamma"] + params["beta"], new_state


class BatchNorm(nn.Module):
    """Holds the parameters under the names of ``nn.BatchNorm1d`` (weight,
    bias, running_mean, running_var, num_batches_tracked), so a reference
    state dict loads as it is."""

    def __init__(self, num_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.register_buffer("running_mean", torch.zeros(num_channels))
        self.register_buffer("running_var", torch.ones(num_channels))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))
        # set while a checkpointed forward is recomputed: the batch
        # statistics normalize as before, the running ones stay as they are
        self.frozen = False

    def forward(self, x: torch.Tensor, row_mask: torch.Tensor, train: bool = False):
        y, new_state = batchnorm_apply(
            {"gamma": self.weight, "beta": self.bias},
            {"mean": self.running_mean, "var": self.running_var},
            x, row_mask, train)
        if train and not self.frozen:
            with torch.no_grad():
                self.running_mean.copy_(new_state["mean"])
                self.running_var.copy_(new_state["var"])
                self.num_batches_tracked += 1
        return y


@contextlib.contextmanager
def frozen_running_stats(module: nn.Module):
    """Within the block, the BatchNorms of ``module`` leave their running
    statistics as they are."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.frozen = True
    try:
        yield
    finally:
        for m in bns:
            m.frozen = False


def remat_checkpoint(module: nn.Module, *args, **kwargs):
    """``module(*args, **kwargs)`` under torch.utils.checkpoint
    (non-reentrant): its activations are recomputed in the backward, where
    its BatchNorms keep the running statistics that the forward left. The
    module must draw nothing at random: the initial states are drawn
    before."""
    return checkpoint(module, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          frozen_running_stats(module)),
                      **kwargs)
