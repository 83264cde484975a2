"""Permutation-invariant training (PIT) loss ops.

The counterpart of speech_separation_tpu/ops/pit.py: the elementwise MSE
between the masked mixture and each of the num_spk! permutations of the
source magnitudes, summed per utterance, minimum over permutations. The
per-permutation error is the sum of pairwise errors
    E[b, i, j] = sum_{t,f} (masked_i[b,t,f] - source_j[b,t,f])^2
taken along each permutation, so the (B, S, S) matrix is computed once.
Padding is harmless: the mixture and the sources are zero-padded, so the
pairwise errors vanish there.
"""

from __future__ import annotations

import itertools
from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=8)
def make_permutations(num_spk: int) -> np.ndarray:
    """(S!, S) int64 array of all permutations, in itertools order."""
    return np.asarray(list(itertools.permutations(range(num_spk))), dtype=np.int64)


def pairwise_mse(masked: torch.Tensor, sources: torch.Tensor) -> torch.Tensor:
    """E[b, i, j] = sum_{t,f} (masked[b,:,i,:] - sources[b,j])^2.

    masked: (B, T, S, F) per-source masked mixture estimates;
    sources: (B, S, T, F). Returns (B, S_est, S_src)."""
    diff = masked.permute(0, 2, 1, 3)[:, :, None] - sources[:, None]
    return torch.sum(torch.square(diff), dim=(3, 4))


def permutation_min_loss(pair_err: torch.Tensor, num_spk: int):
    """Returns (min_losses (B,), best_perm (B,) int64) with
    min_losses[b] = min_p sum_i pair_err[b, i, perms[p, i]]; the first
    minimum wins a tie."""
    perms = torch.as_tensor(make_permutations(num_spk), device=pair_err.device)  # (P, S)
    idx = perms.t()[None].expand(pair_err.shape[0], -1, -1)                     # (B, S, P)
    per_perm = torch.gather(pair_err, 2, idx).sum(dim=1)                        # (B, P)
    min_losses, best = torch.min(per_perm, dim=1)
    return min_losses, best
