"""The device mesh of data-parallel separation, scoring and training.

The counterpart of speech_separation_tpu/parallel/mesh.py's data axis. A
mesh is a list of devices, one entry a replica (inference, scoring) or a
rank (training); ``shape`` is ``{"data": n, "model": 1}``. The parameters
are replicated and the batch's rows split over the entries:

- inference and scoring: one model copy per device (``replicate_module``),
  the rows of each batch split in order and merged back in order, with no
  collectives (eval-mode BN uses the running statistics, and every BSS-eval
  quantity is per utterance); ``run_replicas`` runs the entries, one thread
  per distinct device and in turn on a device that repeats;
- training: one process per entry (parallel/ranks.py), each with its rows
  of every batch (``shard_batch``); the ranks sum BN's statistics, the
  loss's norm and the gradients, so a step computes what one device does
  on the whole batch, up to the order of sums.

Rows that do not divide the mesh are padded with dummy rows (zeros,
``row_mask`` 0), which every loss, norm and BN statistic weighs by 0. The
device list may repeat a device (two ranks or replicas on ``cuda:0``): the
tests and chip_smoke.py build such meshes; no CLI flag does. Tensor
parallelism (``model > 1``, the JAX package's ``shard_params``) is not
ported (ROADMAP.md A.5.6).
"""

from __future__ import annotations

import contextlib
import copy
import threading

import numpy as np
import torch


class Mesh:
    """Devices on the data axis; ``shape`` {"data": n, "model": 1}."""

    def __init__(self, devices):
        self.devices = [_indexed(torch.device(d)) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.shape = {"data": len(self.devices), "model": 1}

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def _indexed(d: torch.device) -> torch.device:
    """``cuda`` as ``cuda:0``, so equal devices compare equal."""
    return torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d


def _visible_devices() -> list:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(data: int | None = None, model: int = 1, devices=None) -> Mesh:
    """A mesh of ``data`` entries of ``devices`` (default: every visible
    card, all on the data axis)."""
    if model != 1:
        raise NotImplementedError(
            f"model={model}: tensor parallelism is not ported (ROADMAP.md A.5.6); "
            "the port's mesh has a data axis only")
    devices = list(devices) if devices is not None else _visible_devices()
    if data is None:
        data = len(devices)
    if not 0 < data <= len(devices):
        raise ValueError(f"a data axis of {data} over {len(devices)} device(s)")
    return Mesh(devices[:data])


def data_parallel_mesh(log=print, device=None) -> Mesh | None:
    """The mesh of ``--data-parallel``: every visible card. None, with the
    JAX package's note, when fewer than two are visible or ``device`` is not
    a card: the single-device path is then simpler and gives the same
    output."""
    on_cards = device is None or torch.device(device).type == "cuda"
    if not on_cards or torch.cuda.device_count() < 2:
        log("note: --data-parallel with one visible device; running single-device")
        return None
    return make_mesh()


def _rows(v) -> int | None:
    shape = getattr(v, "shape", None)
    return int(shape[0]) if shape else None


def _pad(v, n: int):
    if isinstance(v, torch.Tensor):
        return torch.cat([v, v.new_zeros((n,) + tuple(v.shape[1:]))])
    return np.pad(v, [(0, n)] + [(0, 0)] * (v.ndim - 1))


_pad_warned = False


def pad_rows(arrays: dict, n_data: int) -> dict:
    """``arrays`` with dummy rows (zeros, ``row_mask`` 0) appended to every
    array of the batch's row count, up to a multiple of ``n_data``, with the
    JAX package's note the first time. Arrays of another leading size, and
    values that are not arrays, stay as they are."""
    global _pad_warned
    B = _rows(arrays["row_mask"])
    if B % n_data == 0:
        return arrays
    Bp = -(-B // n_data) * n_data
    if not _pad_warned:
        _pad_warned = True
        print(f"note: batch rows {B} padded to {Bp} to shard over {n_data} data-parallel "
              f"devices (pick batch sizes divisible by {n_data} to avoid the pad waste)")
    return {k: _pad(v, Bp - B) if _rows(v) == B else v for k, v in arrays.items()}


def shard_batch(arrays: dict, mesh: Mesh | int) -> list[dict]:
    """The batch split over ``mesh`` (or that many entries), one dict per
    entry, in order: rows padded as ``pad_rows`` does, then the leading axis
    of each array of the batch's row count cut into equal slices; other
    arrays and values are replicated. Values keep their type (numpy stays
    numpy, a tensor stays on its device)."""
    n = mesh if isinstance(mesh, int) else mesh.size
    arrays = pad_rows(arrays, n)
    per = _rows(arrays["row_mask"]) // n
    return [{k: v[i * per:(i + 1) * per] if _rows(v) == per * n else v
             for k, v in arrays.items()} for i in range(n)]


def replicate_module(model: torch.nn.Module, mesh: Mesh) -> list[torch.nn.Module]:
    """One copy of ``model`` per mesh entry, on the entry's device; entries
    on one device share its copy (inference reads the weights only)."""
    copies = {}
    for d in mesh.devices:
        if d not in copies:
            copies[d] = model if next(model.parameters()).device == d else \
                copy.deepcopy(model).to(d)
    return [copies[d] for d in mesh.devices]


def run_replicas(mesh: Mesh, fn) -> list:
    """``[fn(i) for i in range(mesh.size)]``, each call under its entry's
    device. Entries on distinct devices run at once, one thread a device;
    entries on one device run in turn, never on two streams at once: the
    LSTM kernels spin on a grid barrier that needs all their CTAs resident,
    and two such kernels sharing a card's SMs could wait on each other."""
    by_device: dict[torch.device, list[int]] = {}
    for i, d in enumerate(mesh.devices):
        by_device.setdefault(d, []).append(i)
    out: list = [None] * mesh.size
    errors: list = []

    def run(d, idxs):
        try:
            with (torch.cuda.device(d) if d.type == "cuda" else contextlib.nullcontext()):
                for i in idxs:
                    out[i] = fn(i)
        except BaseException as e:  # surfaces on the caller's thread
            errors.append(e)

    if len(by_device) == 1:
        run(*next(iter(by_device.items())))
    else:
        threads = [threading.Thread(target=run, args=item) for item in by_device.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    return out
