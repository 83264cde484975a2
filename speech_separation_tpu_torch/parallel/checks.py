"""One optimizer step over data-parallel ranks against the same step in one
process: what the tests and chip_smoke.py hold data parallelism with.

``steps_over_ranks(jobs, mesh)`` runs each job's step on ``mesh``'s ranks
(parallel/ranks.py), each rank its rows of the job's batch, or in this
process when the mesh has one entry. The ranks' target lives here, in the
package, because spawned children import it. Training itself needs none of
this module (train/loop.py).
"""

from __future__ import annotations

import functools

import torch

from ..eval.infer import resolve_device
from ..models.registry import get_arch
from ..train.loop import (AUDIO_KEYS, FEATURE_KEYS, Optimizer, TrainLoopConfig,
                          accumulate_step, to_device, update_step, upcast_features)
from ..train.wav_data import STFT, audio_to_feature_batch, audio_to_wave_batch
from ..utils.weights import fold_lstm_biases
from . import ranks
from .mesh import Mesh


def steps_over_ranks(jobs: list[dict], mesh: Mesh | None = None, device=None) -> list[dict]:
    """One optimizer step for each job, over ``mesh``'s ranks (each its
    rows of the batch) or, without a mesh of more than one entry, in this
    process on ``device``. A job is {"arch", "model_kwargs", "weights" (a
    state dict of a model whose LSTM biases are folded), "batch" (a collated
    numpy batch, or a list of a mixed batch's sub-batches), "seed" (the
    initial states' generator), "faults" (parallel/ranks.FAULTS, default
    none), "time_pad_multiple", "raise_on_rank" (that rank raises before its
    step: the failing-rank control)}. Returns, for each job, {"loss",
    "norm", "grads" (every gradient as reduced over the ranks, before the
    clip), "params" (after the Adam update), "buffers" (BN's running
    statistics)}, on the CPU."""
    if mesh is not None and mesh.size > 1:
        return ranks.launch(mesh, _steps_here, (jobs,))
    return _steps_here(jobs, device if mesh is None else mesh.devices[0])


class _Recording(Optimizer):
    """The training optimizer, keeping a copy of the gradients as they
    reach the clip (after the sum over the ranks)."""

    def clip(self) -> torch.Tensor:
        self.reduced = [None if p.grad is None else p.grad.detach().clone()
                        for p in self.params]
        return super().clip()


def _steps_here(jobs: list[dict], device=None) -> list[dict]:
    r = ranks.current()
    dev = r.device if r is not None else resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    return [_one_step(dev, r, **job) for job in jobs]


def _one_step(dev, r, arch, model_kwargs, weights, batch, seed=0, faults=(),
              time_pad_multiple=128, raise_on_rank=None) -> dict:
    if r is not None and r.rank == raise_on_rank:
        raise RuntimeError(f"rank {r.rank} raises before its step, as the job asks")
    arch = get_arch(arch)
    model = arch.Model(arch.Config.from_kwargs(**model_kwargs))
    fold_lstm_biases(model)
    model.load_state_dict(weights)
    model.to(dev)
    optimizer = _Recording(model.parameters(), TrainLoopConfig())
    generator = torch.Generator(device=dev).manual_seed(seed)
    subs = batch if isinstance(batch, list) else [batch]
    keys = AUDIO_KEYS if "audio" in subs[0] else FEATURE_KEYS
    if keys == AUDIO_KEYS:
        to_arch = audio_to_wave_batch if arch.DOMAIN == "time" else audio_to_feature_batch
        prepare = functools.partial(to_arch, cfg=STFT)
    else:
        prepare = upcast_features
    with ranks.with_faults(faults):
        subs = [prepare(to_device(ranks.rows_of(sb, r, time_pad_multiple), dev, keys=keys))
                for sb in subs]
        if isinstance(batch, list):
            loss, norm = accumulate_step(arch, model, optimizer, subs, generator)
        else:
            loss, norm = update_step(arch, model, optimizer, subs[0], generator)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    return {"loss": float(loss), "norm": float(norm),
            "grads": {n: g.cpu() for n, g in zip(names, optimizer.reduced) if g is not None},
            "params": {n: p.detach().cpu() for n, p in model.named_parameters()},
            "buffers": {n: b.cpu() for n, b in model.named_buffers()}}
