"""Plain reference of uPIT (Kolbaek et al. 2017; the mmaciej2/speech-separation
recipe's archs/uPIT.py): a bidirectional LSTM over the mixture's STFT
magnitudes, BatchNorm over the padded (B, T) positions, a linear head and
sigmoid masks, one per speaker; trained by utterance-level PIT over the
masked mixtures' squared error.

Leaves carry the names of the reference recipe's state dict (``blstm.*`` as
torch.nn.LSTM's, ``bn.*``, ``lin.*``), the format that the port's ``.mdl``
files keep. Also here: uPIT's product operations a frame, and the
recurrences a step launches (the per-layer readers count from them).
"""

from __future__ import annotations

import itertools

import torch

from .common import blstm_layer, blstm_specs, dot, draw


def init_params(model: dict, generator: torch.Generator, device) -> dict:
    """Every leaf from the seed's generator on ``device``, in one draw: the
    BLSTM as torch.nn.LSTM draws it (one bias per direction), the head
    U(+-1/sqrt(2H)), and BatchNorm's scale, shift and running statistics
    spread around identity so that the eval path normalises for real."""
    F, S, H, L = model["feat_dim"], model["num_spk"], model["hidden"], model["num_layers"]
    kb = (2 * H) ** -0.5
    specs = blstm_specs("blstm.", F, H, L) + [
        ("bn.weight", (2 * H,), 0.8, 1.2), ("bn.bias", (2 * H,), -0.1, 0.1),
        ("bn.running_mean", (2 * H,), -0.05, 0.05), ("bn.running_var", (2 * H,), 0.02, 0.08),
        ("lin.weight", (F * S, 2 * H), -kb, kb), ("lin.bias", (F * S,), -kb, kb)]
    p = draw(specs, generator, device)
    p["bn.num_batches_tracked"] = torch.zeros((), dtype=torch.long, device=device)
    return p


def masks(p: dict, model: dict, mix: torch.Tensor, lengths: torch.Tensor, q,
          train: bool) -> torch.Tensor:
    """(B, T, S*F) sigmoid masks: BLSTM (zero initial state) -> BatchNorm
    (train: the batch's statistics over every padded position; eval: the
    running ones) -> linear -> sigmoid."""
    y = mix
    for layer in range(model["num_layers"]):
        y = blstm_layer(y, lengths, p, "blstm.", layer, q)
    if train:
        mean = y.mean(dim=(0, 1))
        var = ((y - mean) ** 2).mean(dim=(0, 1))
    else:
        mean, var = p["bn.running_mean"], p["bn.running_var"]
    y = (y - mean) / torch.sqrt(var + 1e-5) * p["bn.weight"] + p["bn.bias"]
    return torch.sigmoid(dot(y, p["lin.weight"].t(), q) + p["lin.bias"])


def loss(p: dict, model: dict, batch: dict, q, per_perm_out: list | None = None) -> list:
    """PIT loss of a feature batch (``mix`` (B, T, F), ``sources`` (B, S, T,
    F), ``lengths``): per row the least, over speaker orders, summed squared
    error of mask * mix against the sources, summed over rows, over S, over
    the batch's true frames times F. One part: BatchNorm's statistics span
    the whole batch. ``per_perm_out`` collects each row's error under each
    speaker order."""
    mix, src, lengths = batch["mix"], batch["sources"], batch["lengths"]
    B, T, F = mix.shape
    S = model["num_spk"]
    est = outputs(p, model, batch, q).permute(0, 2, 1, 3)          # (B, S, T, F)
    err = ((est[:, :, None] - src[:, None]) ** 2).sum(dim=(3, 4))   # (B, S_est, S_src)
    per_perm = torch.stack([sum(err[:, i, perm[i]] for i in range(S))
                            for perm in itertools.permutations(range(S))], dim=1)
    if per_perm_out is not None:
        per_perm_out.append(per_perm.detach())
    total = per_perm.min(dim=1).values.sum() / S
    return [total / (lengths.float().sum() * F)]


def outputs(p: dict, model: dict, batch: dict, q) -> torch.Tensor:
    """The training forward's masked estimates, (B, T, S, F): mask * mix."""
    mix = batch["mix"]
    B, T, F = mix.shape
    m = masks(p, model, mix, batch["lengths"], q, True)
    return m.reshape(B, T, model["num_spk"], F) * mix[:, :, None]


def forward_flops_per_frame(model: dict) -> float:
    """Product operations of one frame's forward: per layer the input
    projection and the recurrence of both directions, then the head."""
    F, S, H, L = model["feat_dim"], model["num_spk"], model["hidden"], model["num_layers"]
    total = 0.0
    for layer in range(L):
        d_in = F if layer == 0 else 2 * H
        total += 2 * (2 * d_in * 4 * H) + 2 * (2 * H * 4 * H)
    return total + 2 * (2 * H) * (F * S)


def train_flops(model: dict, batch_lengths) -> float:
    """Forward and backward (three forwards) over the rows' true frames."""
    return 3.0 * forward_flops_per_frame(model) * float(sum(batch_lengths))


def lstm_launches(model: dict, T: int, lengths) -> list:
    """The recurrences one pass over a batch runs, in order: (T, rows, H,
    per-row lengths), one per layer (both directions in one call)."""
    return [(T, len(lengths), model["hidden"], list(lengths))] * model["num_layers"]
