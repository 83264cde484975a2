"""One optimizer step over parallel ranks against the same step in one
process: what the tests and chip_smoke.py hold data and tensor parallelism
with.

``steps_over_ranks(jobs, mesh)`` runs each job's step on ``mesh``'s ranks
(parallel/ranks.py), each rank its data index's rows of the job's batch
and, over a model axis, its model index's shards of the job's placement,
or in this process when the mesh has one entry. The ranks' target lives
here, in the package, because spawned children import it. Training itself
needs none of this module (train/loop.py); tensor parallelism is reached
only here, as the JAX package reaches its model axis only from its tests.
"""

from __future__ import annotations

import functools
import os
import tempfile
import time

import torch

from ..models.registry import get_arch
from ..train.loop import (AUDIO_KEYS, FEATURE_KEYS, Optimizer, TrainLoopConfig,
                          accumulate_step, to_device, update_step, upcast_features)
from ..train.wav_data import STFT, audio_to_feature_batch, audio_to_wave_batch
from ..utils.device import disable_tf32, resolve_device
from ..utils.weights import fold_lstm_biases
from . import ranks
from .mesh import Mesh, place, shard_params, shard_params_convtasnet

# a waveform batch as the JAX package's tests make it: float waveforms, no STFT
WAVE_KEYS = ("mix_wav", "source_wavs", "sample_lengths", "row_mask")


def steps_over_ranks(jobs: list[dict], mesh: Mesh | None = None, device=None) -> list[dict]:
    """One optimizer step for each job, over ``mesh``'s ranks or, without
    a mesh of more than one entry, in this process on ``device``. A job is
    {"arch", "model_kwargs", "weights" (a state dict of a model whose LSTM
    biases are folded), "batch" (a collated numpy batch: features, shipped
    audio or WAVE_KEYS waveforms; or a list of a mixed batch's
    sub-batches), "seed" (the initial states' generator), "faults"
    (parallel/ranks.FAULTS, default none), "time_pad_multiple",
    "raise_on_rank" (that rank raises before its step: the failing-rank
    control), "tp" (the placement over the mesh's model axis: None, "head"
    or "lstm_gates" (parallel/mesh.shard_params), "convtasnet"
    (shard_params_convtasnet); nothing is split without a model axis),
    "time_steps" (after the step, that many more on the same batch, each
    timed)}. Returns, for each job, {"loss", "norm" (the loss's), "grads"
    (every gradient as reduced over the data group, before the clip),
    "clip_norm" (the clip's global norm), "clip_norms" (as each rank saw
    it, in rank order), "params" (after the Adam update), "buffers" (BN's
    running statistics), "step_ms" (the timed steps, on rank 0's host clock
    up to the loss's read-back), "wall_s" (the job's, rank 0's)}, every
    split tensor assembled whole from its model group's blocks, on the
    CPU. Products and convolutions run in full float32 (no TF32)."""
    if mesh is not None and mesh.size > 1:
        # the jobs reach the ranks through one file: as spawn arguments
        # they would be pickled once a rank, and their weights and batches
        # (hundreds of MB at full width) would hold up every rank's start
        with tempfile.TemporaryDirectory(prefix="sep_jobs_") as tmp:
            path = os.path.join(tmp, "jobs.pt")
            torch.save(jobs, path)
            return ranks.launch(mesh, _steps_from_file, (path, mesh))
    return _steps_here(jobs, device if mesh is None else mesh.devices[0])


class _Recording(Optimizer):
    """The training optimizer, keeping a copy of the gradients as they
    reach the clip (after the sum over the data group) and the clip's
    norm."""

    def clip(self) -> torch.Tensor:
        self.reduced = [None if p.grad is None else p.grad.detach().clone()
                        for p in self.params]
        self.clip_norm = super().clip()
        return self.clip_norm


def _steps_from_file(path: str, mesh: Mesh) -> list[dict]:
    return _steps_here(torch.load(path, weights_only=False), mesh=mesh)


def _steps_here(jobs: list[dict], device=None, mesh: Mesh | None = None) -> list[dict]:
    r = ranks.current()
    dev = r.device if r is not None else resolve_device(device)
    # full float32 products and convolutions, in every process alike
    disable_tf32(cudnn=True)
    return [_one_step(dev, r, mesh, **job) for job in jobs]


def _placement(tp: str | None, weights: dict, mesh: Mesh | None):
    if tp is None or mesh is None or mesh.shape["model"] == 1:
        return None
    if tp == "convtasnet":
        return shard_params_convtasnet(weights, mesh)
    if tp not in ("head", "lstm_gates"):
        raise ValueError(f"unknown placement {tp!r}: None, head, lstm_gates or convtasnet")
    return shard_params(weights, mesh, lstm_gates=tp == "lstm_gates")


def _per_rank(x: torch.Tensor) -> list[float]:
    """A scalar as each rank holds it, in rank order."""
    r = ranks.current()
    if r is None:
        return [float(x)]
    import torch.distributed as dist
    buf = torch.zeros(r.world, dtype=torch.float32, device=r.device)
    buf[r.rank] = x.float()
    dist.all_reduce(buf)
    return buf.tolist()


def _batch_prep(sub: dict, arch):
    """(the keys the batch sends to the device, the arch's batch from them)."""
    if "audio" in sub:
        to_arch = audio_to_wave_batch if arch.DOMAIN == "time" else audio_to_feature_batch
        return AUDIO_KEYS, functools.partial(to_arch, cfg=STFT)
    if "mix_wav" in sub:
        return WAVE_KEYS, lambda b: b
    return FEATURE_KEYS, upcast_features


def _one_step(dev, r, mesh, arch, model_kwargs, weights, batch, seed=0, faults=(),
              time_pad_multiple=128, raise_on_rank=None, tp=None, time_steps=0) -> dict:
    t0 = time.perf_counter()
    if r is not None and r.rank == raise_on_rank:
        raise RuntimeError(f"rank {r.rank} raises before its step, as the job asks")
    arch = get_arch(arch)
    model = arch.Model(arch.Config.from_kwargs(**model_kwargs))
    fold_lstm_biases(model)
    model.load_state_dict(weights)
    model.to(dev)
    placement = _placement(tp, weights, mesh)
    if placement is not None:
        place(model, placement, r.model_index)
    optimizer = _Recording(model.parameters(), TrainLoopConfig())
    generator = torch.Generator(device=dev).manual_seed(seed)
    subs = batch if isinstance(batch, list) else [batch]
    keys, prepare = _batch_prep(subs[0], arch)
    with ranks.with_faults(faults):
        subs = [prepare(to_device(ranks.rows_of(sb, r, time_pad_multiple), dev, keys=keys))
                for sb in subs]
        if isinstance(batch, list):
            loss, norm = accumulate_step(arch, model, optimizer, subs, generator)
        else:
            loss, norm = update_step(arch, model, optimizer, subs[0], generator)
    dims = placement.dims if placement is not None else {}

    def whole(name, t):
        return ranks.gather_tensor(t, dims[name]) if dims.get(name) is not None else t

    def kept(t):          # a copy: the timed steps below move the model on
        return t.detach().to("cpu", copy=True)

    names = [n for n, p in model.named_parameters() if p.requires_grad]
    out = {"loss": float(loss), "norm": float(norm),
           "grads": {n: kept(whole(n, g)) for n, g in zip(names, optimizer.reduced)
                     if g is not None},
           "clip_norm": float(optimizer.clip_norm),
           "clip_norms": _per_rank(optimizer.clip_norm),
           "params": {n: kept(whole(n, p)) for n, p in model.named_parameters()},
           "buffers": {n: kept(b) for n, b in model.named_buffers()}, "step_ms": []}
    with ranks.with_faults(faults):
        for _ in range(time_steps):
            t = time.perf_counter()
            loss, _ = update_step(arch, model, optimizer, subs[0], generator)
            float(loss)                               # waits for the device
            out["step_ms"].append(1e3 * (time.perf_counter() - t))
    out["wall_s"] = time.perf_counter() - t0
    return out
