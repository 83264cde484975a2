"""The ranks of a training run over a mesh: one process per mesh entry.

``launch(mesh, target, args)`` starts one spawned process a mesh entry,
joins them into one ``torch.distributed`` process group and runs
``target(*args)`` in each; it returns rank 0's result. Rank ``r`` sits at
(data index ``r // m``, model index ``r % m``) of a mesh with a model axis
of ``m`` (parallel/mesh.py). Over a mesh with a model axis every rank makes
one process group per data index (its model group: the ranks that hold the
same rows) and one per model index (its data group: the ranks that hold the
same shards), all in one order. A step over the ranks computes what one
device computes on the whole batch:

- each rank collates the whole of every batch and keeps its data index's
  rows (the rows padded to a multiple of the data axis, then split in
  order: ``rows_of``), so its time axis is the global batch's;
- BatchNorm sums its statistics' sums and count over the data group
  (``global_sum``, differentiable, so BN's gradient is the single-device
  one; every rank updates the running statistics from the global values);
- a loss's norm (a count) is summed over the data group, and each rank
  backpropagates its local total over the global norm;
- the gradients are summed over the data group once, after the backward,
  in one flat buffer (``reduce_gradients``), before the clip and Adam. A
  model group holds the same rows m times, so a sum over the whole world
  would count them m times.

Tensor parallelism (the model axis) writes out the collectives the JAX
package leaves to GSPMD, each a ``torch.autograd.Function`` over the model
group:

- ``copy_to_model``: forward the identity, backward an all-reduce. It sits
  on a replicated input that enters a column-parallel product, whose
  gradient each rank holds only in part;
- ``gather_from_model``: forward an all-gather along the split axis,
  backward the rank's own block of the gradient, unsummed: every rank of
  the group computes the same loss from the gathered tensor, so each holds
  the whole gradient already (torch.distributed.nn's all_gather sums the
  blocks, m times too much here);
- ``reduce_from_model``: forward an all-reduce, backward the identity, on
  the output of a row-parallel product;
- ``sum_over_model``: forward and backward an all-reduce, for a norm's
  statistics over a split axis, into which every block feeds gradient.

Every collective is an all-reduce (of float32; a gather's of a zero-filled
whole-size buffer into which each rank writes its block, summed as int32
words, which is exact), the one collective that ``gloo`` runs on CUDA
tensors as well as NCCL does,
and every one is issued in one program order on every rank of its group (the
backward's, and a forward recomputed under remat, run in the same order),
so they cannot cross.

Backend, by a rule on the device list: ``nccl`` when every rank has a card
of its own; ``gloo`` when ranks share a card (NCCL refuses two ranks on one
device) or run on the CPU. The group rendezvouses through a file in a
fresh temporary directory (no port) and has a timeout, so a rank stuck in
a collective raises. A rank that fails ends the run: the others are killed
and ``launch`` raises ``RankFailed``; a rank whose parent dies exits too.

Fault controls (``with_faults``), off outside tests and chip_smoke.py, each
reproducing a way the parallel step goes wrong: ``bn_per_rank`` (BN
statistics over the rank's rows), ``time_per_rank`` (each rank's rows padded
to their own longest), ``mean_grads`` (gradients averaged over ranks that
each divide by their own norm, the DistributedDataParallel default);
``gather_sums`` (a gather's backward sums the blocks, as torch's own
all_gather does), ``no_input_reduce`` (a replicated input's gradient is not
summed over the model group), ``shard_norm_stats`` (a norm's statistics
over the rank's block of a split axis only) and ``world_sums`` (gradients
and the loss's norm summed over every rank, not the data group).
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

from ..ops._build import launch_counters
from .mesh import Mesh, shard_batch

# seconds a collective may wait for the other ranks before it raises
TIMEOUT_S = 600.0
FAULTS = ("bn_per_rank", "time_per_rank", "mean_grads", "gather_sums", "no_input_reduce",
          "shard_norm_stats", "world_sums")


class RankFailed(RuntimeError):
    """A rank of a parallel run exited with an error."""


@dataclasses.dataclass(frozen=True)
class Ranks:
    """This process's place in a parallel run: rank ``rank`` of ``world``
    on ``device``, over a mesh whose model axis is ``model``."""
    rank: int
    world: int
    device: torch.device
    model: int = 1

    @property
    def data(self) -> int:
        """The data axis: how many parts each batch's rows are split in."""
        return self.world // self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model


_current: Ranks | None = None
_faults: frozenset = frozenset()
# this rank's process groups over a mesh with a model axis: {"data", "model"}
_groups: dict = {}


def current() -> Ranks | None:
    """This process's ranks, or None outside a parallel run."""
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


def _data_group(kind: str):
    """The group a data-axis sum runs over (None: the whole world), or
    False when there is nothing to sum: outside a run, or over a data axis
    of 1. ``kind`` ("bn", "norm", "grads") names the sum, which
    ``world_sums`` sends over every rank ("norm", "grads")."""
    if _current is None or _current.world == 1:
        return False
    if kind != "bn" and "world_sums" in _faults:
        return None
    if _current.data == 1:
        return False
    return _groups.get("data")


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """A new float32 tensor: ``t`` summed over ``group``."""
    import torch.distributed as dist
    out = t.detach().float().clone()
    dist.all_reduce(out, group=group)
    return out


class _SumOver(torch.autograd.Function):
    """Forward and backward an all-reduce over ``group`` (in float32)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_reduce(t, group).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group).to(g.dtype), None


def global_sum(t: torch.Tensor, kind: str) -> torch.Tensor:
    """``t`` summed over the data group, differentiably (the gradient of
    each rank's input is the sum of the gradients of every rank's output);
    ``t`` itself outside a data-parallel run. ``kind`` "bn" (BatchNorm's
    sums and count) or "norm" (a loss's norm) names the fault control that
    keeps it local. The sum is taken in float32."""
    group = _data_group(kind)
    if group is False or _local(kind):
        return t
    return _SumOver.apply(t, group)


def _local(kind: str) -> bool:
    return {"bn": "bn_per_rank", "norm": "mean_grads"}[kind] in _faults


def loss_over_ranks(loss: torch.Tensor) -> torch.Tensor:
    """The batch's loss from each rank's share (local total / global norm):
    their sum over the data group; their mean under ``mean_grads``, where
    each share is a mean of its own."""
    group = _data_group("norm")
    if group is False:
        return loss
    out = _all_reduce(loss, group)
    return out / _current.data if "mean_grads" in _faults else out


def reduce_gradients(params) -> None:
    """Sum the gradients of ``params`` over the data group, in place, in one
    flat float32 buffer (averaged under ``mean_grads``)."""
    group = _data_group("grads")
    if group is False:
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = _all_reduce(torch.cat([g.reshape(-1) for g in grads]), group)
    if "mean_grads" in _faults:
        flat /= _current.data
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


# ------------------------------------------------- the model group's collectives

def _spread_over_model() -> bool:
    return _current is not None and _current.model > 1


def _gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The model group's blocks of ``x`` along ``dim``, in model order:
    each rank writes its block into a zero-filled buffer of the whole size,
    and the buffers are all-reduced as int32 words (at most one rank's word
    is not zero, so the sum is that word: exact for any dtype, in the
    tensor's own bytes), or as float32 where the bytes do not make whole
    words."""
    import torch.distributed as dist
    m, k = _current.model, _current.model_index
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * m
    buf = x.new_zeros(shape)
    buf.narrow(dim, k * n, n).copy_(x.detach())
    if buf.numel() * buf.element_size() % 4 == 0:
        dist.all_reduce(buf.view(-1).view(torch.int32), group=_groups["model"])
        return buf
    return _all_reduce(buf, _groups["model"]).to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.reduce = "no_input_reduce" not in _faults
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, _groups["model"]).to(g.dtype) if ctx.reduce else g


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.n, ctx.sums = dim, x.shape[dim], "gather_sums" in _faults
        return _gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.sums:
            g = _all_reduce(g, _groups["model"]).to(g.dtype)
        k = _current.model_index
        return g.narrow(ctx.dim, k * ctx.n, ctx.n).contiguous(), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x, _groups["model"]).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x``, a tensor every rank of the model group holds whole, entering
    a column-parallel product: the identity forward, its gradient summed
    over the group backward."""
    return _CopyToModel.apply(x) if _spread_over_model() else x


def gather_from_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The model group's blocks of ``x`` joined along ``dim``; backward,
    the rank's own block of the gradient."""
    if not _spread_over_model():
        return x
    return _GatherFromModel.apply(x, dim % x.dim())


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum over the model group of each rank's partial ``x`` (a
    row-parallel product's output); backward, the identity."""
    return _ReduceFromModel.apply(x) if _spread_over_model() else x


def sum_over_model(x: torch.Tensor) -> torch.Tensor:
    """A norm's statistic summed over the blocks of a split axis: forward
    and backward an all-reduce over the model group (each block alone
    under ``shard_norm_stats``)."""
    if not _spread_over_model() or "shard_norm_stats" in _faults:
        return x
    return _SumOver.apply(x, _groups["model"])


@torch.no_grad()
def gather_tensor(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The model group's blocks of ``x`` joined along ``dim``, outside
    autograd (assembling split parameters and their gradients)."""
    return _gather(x, dim) if _spread_over_model() else x


@torch.no_grad()
def model_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the model group, outside autograd (the clip's
    squared norm of the split parameters)."""
    return _all_reduce(x, _groups["model"]).to(x.dtype) if _spread_over_model() else x


def rows_of(batch: dict, r: Ranks | None, time_pad_multiple: int = 1) -> dict:
    """Rank ``r``'s rows of a collated batch (numpy arrays, ``row_mask``
    and ``names``): its data index's, as ``mesh.shard_batch`` splits them
    (every rank of a model group gets the same rows), with ``n_real`` the
    batch's real rows over all ranks; the batch itself for None (outside a
    parallel run) or a data axis of 1. Every rank collates the whole batch,
    so its T and source count are the whole batch's. Under
    ``time_per_rank`` a feature batch's time axis is cut to the rank's own
    longest row, rounded up to ``time_pad_multiple``. (The caller passes
    ``current()``: a loader thread's collation must not see ``alone``.)"""
    if r is None or r.data == 1:
        return batch
    n_real = int(np.sum(batch["row_mask"]))
    i = r.data_index
    out = shard_batch(batch, r.data)[i]
    out["n_real"] = n_real
    if "names" in batch:
        per = len(out["row_mask"])
        out["names"] = list(batch["names"])[i * per:(i + 1) * per]
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


def _make_groups(mesh: Mesh, rank: int) -> dict:
    """Every model group, then every data group, made by every rank in this
    one order (``dist.new_group`` is collective); this rank's two."""
    import torch.distributed as dist
    mine = {}
    for axis, groups in (("model", mesh.model_groups()), ("data", mesh.data_groups())):
        for members in groups:
            group = dist.new_group(members)
            if rank in members:
                mine[axis] = group
    return mine


def _rank_main(ranks: Ranks, mesh: Mesh, backend: str, init_file: str, timeout_s: float,
               threads: int, parent_pid: int, target, args, result_path: str) -> None:
    """A spawned rank: join the group (and, over a model axis, make the
    model and data groups), run ``target(*args)``, rank 0 saves the
    result."""
    global _current, _groups
    import torch.distributed as dist
    _watch_parent(parent_pid)
    torch.set_num_threads(threads)
    if ranks.device.type == "cuda":
        torch.cuda.set_device(ranks.device)
    dist.init_process_group(backend, init_method="file://" + init_file, rank=ranks.rank,
                            world_size=ranks.world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _groups = _make_groups(mesh, ranks.rank) if ranks.model > 1 else {}
    _current = ranks
    out = target(*args)
    counters = launch_counters()
    counts = torch.tensor([f.launches for f in counters], dtype=torch.int64,
                          device=ranks.device)
    dist.all_reduce(counts)
    if ranks.rank == 0:
        torch.save({"result": out, "launches": {f.__name__: int(n) for f, n in
                                                zip(counters, counts.tolist())}},
                   result_path)
    dist.destroy_process_group()


def launch(mesh: Mesh, target, args=(), timeout_s: float = TIMEOUT_S, log=print):
    """Run ``target(*args)`` in one spawned process per mesh entry, joined
    in one process group; returns rank 0's result. ``target`` must be a
    module-level function (the children import it). Raises ``RankFailed``
    as soon as a rank exits with an error, after killing the others.
    ``launch.kernel_launches`` then holds each kernel's launches summed over
    the ranks ({wrapper name: count})."""
    world = mesh.size
    backend, why = backend_for(mesh.devices)
    axes = "" if mesh.shape["model"] == 1 else \
        f" (data {mesh.shape['data']} x model {mesh.shape['model']})"
    log(f"data-parallel: {world} ranks{axes} on {[str(d) for d in mesh.devices]}, "
        f"backend {backend} ({why})")
    tmp = tempfile.mkdtemp(prefix="sep_ranks_")
    result_path = os.path.join(tmp, "result.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        Ranks(r, world, mesh.devices[r], mesh.shape["model"]), mesh, backend,
        os.path.join(tmp, "rendezvous"), timeout_s,
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
