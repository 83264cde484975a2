"""The ranks of a data-parallel training run: one process per mesh entry.

``launch(mesh, target, args)`` starts one spawned process a mesh entry,
joins them into one ``torch.distributed`` process group and runs
``target(*args)`` in each; it returns rank 0's result. A step over the
ranks computes what one device computes on the whole batch:

- each rank collates the whole of every batch and keeps its rows (the rows
  padded to a multiple of the ranks, then split in order: ``rows_of``), so
  its time axis is the global batch's;
- BatchNorm sums its statistics' sums and count over the ranks
  (``global_sum``, differentiable, so BN's gradient is the single-device
  one; every rank updates the running statistics from the global values);
- a loss's norm (a count) is summed over the ranks, and each rank
  backpropagates its local total over the global norm;
- the gradients are summed over the ranks once, after the backward, in one
  flat buffer (``reduce_gradients``), before the clip and Adam. Every
  collective is issued in one program order on every rank (the backward of
  an all-reduce, and a forward recomputed under remat, run in the same
  order), so they cannot cross.

Backend, by a rule on the device list: ``nccl`` when every rank has a card
of its own; ``gloo`` when ranks share a card (NCCL refuses two ranks on one
device) or run on the CPU. The group rendezvouses through a file in a
fresh temporary directory (no port) and has a timeout, so a rank stuck in
a collective raises. A rank that fails ends the run: the others are killed
and ``launch`` raises ``RankFailed``; a rank whose parent dies exits too.

Three fault controls (``with_faults``), off outside tests and
chip_smoke.py, each reproducing a way data parallelism goes wrong:
``bn_per_rank`` (BN statistics over the rank's rows), ``time_per_rank``
(each rank's rows padded to their own longest) and ``mean_grads``
(gradients averaged over ranks that each divide by their own norm, the
DistributedDataParallel default).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import multiprocessing
import os
import shutil
import tempfile
import threading
import time

import numpy as np
import torch

from .mesh import Mesh, shard_batch

# seconds a collective may wait for the other ranks before it raises
TIMEOUT_S = 600.0
FAULTS = ("bn_per_rank", "time_per_rank", "mean_grads")


class RankFailed(RuntimeError):
    """A rank of a data-parallel run exited with an error."""


@dataclasses.dataclass(frozen=True)
class Ranks:
    """This process's place in a data-parallel run."""
    rank: int
    world: int
    device: torch.device


_current: Ranks | None = None
_faults: frozenset = frozenset()


def current() -> Ranks | None:
    """This process's ranks, or None outside a data-parallel run."""
    return _current


@contextlib.contextmanager
def with_faults(faults=()):
    """Within the block, the named fault controls (module docstring) act."""
    global _faults
    bad = set(faults) - set(FAULTS)
    if bad:
        raise ValueError(f"unknown fault controls {sorted(bad)}; known: {FAULTS}")
    saved, _faults = _faults, frozenset(faults)
    try:
        yield
    finally:
        _faults = saved


@contextlib.contextmanager
def alone():
    """Within the block this process computes on its own, with no
    collective (what one rank alone runs, as rank 0's plots)."""
    global _current
    saved, _current = _current, None
    try:
        yield
    finally:
        _current = saved


def backend_for(devices) -> tuple[str, str]:
    """(backend, why) for ranks on ``devices``."""
    devices = list(devices)
    if all(d.type == "cuda" for d in devices):
        if len(set(devices)) == len(devices):
            return "nccl", "one card a rank"
        return "gloo", "ranks share a card, which NCCL refuses"
    return "gloo", "ranks on the CPU"


def _spread() -> bool:
    return _current is not None and _current.world > 1


def global_sum(t: torch.Tensor, kind: str) -> torch.Tensor:
    """``t`` summed over the ranks, differentiably (the gradient of each
    rank's input is the sum of the gradients of every rank's output); ``t``
    itself outside a data-parallel run. ``kind`` "bn" (BatchNorm's sums and
    count) or "norm" (a loss's norm) names the fault control that keeps it
    local. The sum is taken in float32."""
    if not _spread() or _local(kind):
        return t
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(t.float()).to(t.dtype)


def _local(kind: str) -> bool:
    return {"bn": "bn_per_rank", "norm": "mean_grads"}[kind] in _faults


def loss_over_ranks(loss: torch.Tensor) -> torch.Tensor:
    """The batch's loss from each rank's share (local total / global norm):
    their sum; their mean under ``mean_grads``, where each share is a mean
    of its own."""
    if not _spread():
        return loss
    import torch.distributed as dist
    out = loss.detach().float().clone()
    dist.all_reduce(out)
    return out / _current.world if "mean_grads" in _faults else out


def reduce_gradients(params) -> None:
    """Sum the gradients of ``params`` over the ranks, in place, in one
    flat float32 buffer (averaged under ``mean_grads``)."""
    if not _spread():
        return
    import torch.distributed as dist
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat)
    if "mean_grads" in _faults:
        flat /= _current.world
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def rows_of(batch: dict, r: Ranks | None, time_pad_multiple: int = 1) -> dict:
    """Rank ``r``'s rows of a collated batch (numpy arrays, ``row_mask``
    and ``names``), as ``mesh.shard_batch`` splits them, with ``n_real`` the
    batch's real rows over all ranks; the batch itself for None (outside a
    data-parallel run). Every rank collates the whole batch, so its T and
    source count are the whole batch's. Under ``time_per_rank`` a feature
    batch's time axis is cut to the rank's own longest row, rounded up to
    ``time_pad_multiple``. (The caller passes ``current()``: a loader
    thread's collation must not see ``alone``.)"""
    if r is None or r.world == 1:
        return batch
    n_real = int(np.sum(batch["row_mask"]))
    out = shard_batch(batch, r.world)[r.rank]
    out["n_real"] = n_real
    if "names" in batch:
        per = len(out["row_mask"])
        out["names"] = list(batch["names"])[r.rank * per:(r.rank + 1) * per]
    if "time_per_rank" in _faults and "mix" in out:
        t = max(1, int(np.max(out["lengths"])))
        T = -(-t // time_pad_multiple) * time_pad_multiple
        out["mix"] = out["mix"][:, :T]
        out["sources"] = out["sources"][:, :, :T]
    return out


def _watch_parent(parent_pid: int) -> None:
    """Exit when the process that launched the ranks is gone (a watchdog's
    kill, a crash): nobody would collect this rank."""
    def watch():
        while os.getppid() == parent_pid:
            time.sleep(1.0)
        os._exit(1)
    threading.Thread(target=watch, daemon=True).start()


def _rank_main(ranks: Ranks, backend: str, init_file: str, timeout_s: float, threads: int,
               parent_pid: int, target, args, result_path: str) -> None:
    """A spawned rank: join the group, run ``target(*args)``, rank 0 saves
    the result."""
    global _current
    import torch.distributed as dist
    _watch_parent(parent_pid)
    torch.set_num_threads(threads)
    if ranks.device.type == "cuda":
        torch.cuda.set_device(ranks.device)
    dist.init_process_group(backend, init_method="file://" + init_file, rank=ranks.rank,
                            world_size=ranks.world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _current = ranks
    out = target(*args)
    counters = _kernel_counters()
    counts = torch.tensor([f.launches for f in counters], dtype=torch.int64,
                          device=ranks.device)
    dist.all_reduce(counts)
    if ranks.rank == 0:
        torch.save({"result": out, "launches": {f.__name__: int(n) for f, n in
                                                zip(counters, counts.tolist())}},
                   result_path)
    dist.destroy_process_group()


def _kernel_counters() -> list:
    """The hand-written kernels' wrappers, each counting its launches."""
    from ..ops.attention_kernel import chunk_attention_bwd, chunk_attention_fwd
    from ..ops.lstm_kernel import lstm_seq_bwd, lstm_seq_fwd, lstm_seq_infer
    from ..ops.stft_kernel import stft
    return [stft, lstm_seq_infer, lstm_seq_fwd, lstm_seq_bwd, chunk_attention_fwd,
            chunk_attention_bwd]


def launch(mesh: Mesh, target, args=(), timeout_s: float = TIMEOUT_S, log=print):
    """Run ``target(*args)`` in one spawned process per mesh entry, joined
    in one process group; returns rank 0's result. ``target`` must be a
    module-level function (the children import it). Raises ``RankFailed``
    as soon as a rank exits with an error, after killing the others.
    ``launch.kernel_launches`` then holds each kernel's launches summed over
    the ranks ({wrapper name: count})."""
    world = mesh.size
    backend, why = backend_for(mesh.devices)
    log(f"data-parallel: {world} ranks on {[str(d) for d in mesh.devices]}, "
        f"backend {backend} ({why})")
    tmp = tempfile.mkdtemp(prefix="sep_ranks_")
    result_path = os.path.join(tmp, "result.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        Ranks(r, world, mesh.devices[r]), backend, os.path.join(tmp, "rendezvous"), timeout_s,
        torch.get_num_threads(), os.getpid(), target, args, result_path))
        for r in range(world)]
    started = []
    try:
        for p in procs:
            p.start()
            started.append(p)
        while True:
            codes = [p.exitcode for p in procs]
            failed = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                r, c = failed[0]
                raise RankFailed(f"rank {r} of {world} exited with code {c}; "
                                 "the other ranks were stopped")
            if all(c == 0 for c in codes):
                saved = torch.load(result_path, weights_only=False)
                launch.kernel_launches = saved["launches"]
                return saved["result"]
            time.sleep(0.05)
    finally:
        for p in started:
            if p.is_alive():
                p.kill()
        for p in started:
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)


launch.kernel_launches = {}
