"""The device mesh: data-parallel separation, scoring and training, and
tensor-parallel training.

The counterpart of speech_separation_tpu/parallel/mesh.py. A mesh is a grid
of devices with two axes, ``shape`` ``{"data": d, "model": m}``, held as
one list in the grid's row-major order (JAX's ``devices.reshape(data,
model)``): entry ``r`` sits at (data index ``r // m``, model index ``r %
m``). One entry is a replica (inference, scoring) or a rank (training).

- ``data``: the batch's rows split over the data axis (``shard_batch``).
  Inference and scoring: one model copy per device (``replicate_module``),
  the rows of each batch split in order and merged back in order, with no
  collectives (eval-mode BN uses the running statistics, and every BSS-eval
  quantity is per utterance); ``run_replicas`` runs the entries, one thread
  per distinct device and in turn on a device that repeats. Training: one
  process per entry (parallel/ranks.py), each with its rows of every batch;
  the ranks of a data group sum BN's statistics, the loss's norm and the
  gradients, so a step computes what one device does on the whole batch,
  up to the order of sums.
- ``model``: tensor parallelism, for training only, as in the JAX package
  (its CLI reaches neither; ``parallel/checks.steps_over_ranks`` does). The
  ranks of a model group hold the same rows; ``shard_params`` and
  ``shard_params_convtasnet`` say which parameters are split over the group
  and on which axis (``Placement``), and the models run their split
  products with the collectives of parallel/ranks.py. ``replicate_module``
  and ``run_replicas`` refuse a model axis.

Rows that do not divide the data axis are padded with dummy rows (zeros,
``row_mask`` 0), which every loss, norm and BN statistic weighs by 0. The
device list may repeat a device (two or four ranks or replicas on
``cuda:0``): the tests and chip_smoke.py build such meshes; no CLI flag
does.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading

import numpy as np
import torch

from ..utils.weights import shard_state_dict


class Mesh:
    """A (data, model) grid of devices, held in row-major order."""

    def __init__(self, devices, model: int = 1):
        self.devices = [_indexed(torch.device(d)) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if model < 1 or len(self.devices) % model:
            raise ValueError(f"a model axis of {model} over {len(self.devices)} device(s)")
        self.shape = {"data": len(self.devices) // model, "model": model}

    @property
    def size(self) -> int:
        return len(self.devices)

    def model_groups(self) -> list[list[int]]:
        """The entries of each data index (they hold the same rows)."""
        m = self.shape["model"]
        return [list(range(i * m, (i + 1) * m)) for i in range(self.shape["data"])]

    def data_groups(self) -> list[list[int]]:
        """The entries of each model index (they hold the same shards)."""
        m = self.shape["model"]
        return [list(range(k, self.size, m)) for k in range(m)]

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, shape={self.shape})"


def _indexed(d: torch.device) -> torch.device:
    """``cuda`` as ``cuda:0``, so equal devices compare equal."""
    return torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d


def _visible_devices() -> list:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(data: int | None = None, model: int = 1, devices=None) -> Mesh:
    """A (``data``, ``model``) mesh of the first data x model entries of
    ``devices`` (default: every visible card; ``data`` defaults to as many
    as fill the list)."""
    devices = list(devices) if devices is not None else _visible_devices()
    if model < 1:
        raise ValueError(f"a model axis of {model}")
    if data is None:
        data = len(devices) // model
    if not 0 < data * model <= len(devices):
        raise ValueError(f"a {data} x {model} mesh over {len(devices)} device(s)")
    return Mesh(devices[:data * model], model=model)


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
    """The batch split over ``mesh``'s data axis (or that many parts), one
    dict per data index, in order: rows padded as ``pad_rows`` does, then
    the leading axis of each array of the batch's row count cut into equal
    slices; other arrays and values are replicated. Values keep their type
    (numpy stays numpy, a tensor stays on its device)."""
    n = mesh if isinstance(mesh, int) else mesh.shape["data"]
    arrays = pad_rows(arrays, n)
    per = _rows(arrays["row_mask"]) // n
    return [{k: v[i * per:(i + 1) * per] if _rows(v) == per * n else v
             for k, v in arrays.items()} for i in range(n)]


def _data_only(mesh: Mesh) -> None:
    if mesh.shape["model"] > 1:
        raise ValueError(f"a mesh with a model axis ({mesh.shape}) serves and scores nothing: "
                         "tensor parallelism is for training only, as in the JAX package")


def replicate_module(model: torch.nn.Module, mesh: Mesh) -> list[torch.nn.Module]:
    """One copy of ``model`` per mesh entry, on the entry's device; entries
    on one device share its copy (inference reads the weights only)."""
    _data_only(mesh)
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
    _data_only(mesh)
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


# ------------------------------------------------------ tensor parallelism

@dataclasses.dataclass(frozen=True)
class Placement:
    """Where each parameter of a model lives over a mesh's model axis:
    ``dims[name]`` is None (replicated) or the axis it is split on, in
    contiguous equal blocks, block k on model index k. ``kind`` names the
    placement the models run ("head", "lstm_gates", "convtasnet"; None when
    the model axis is 1)."""
    kind: str | None
    model: int
    dims: dict
    state: dict

    def shards(self, k: int) -> dict:
        """Model index k's state dict: its block of every split tensor, the
        replicated ones whole."""
        return shard_state_dict(self.state, self.dims, self.model, k)


def _state_dict(model_or_state_dict) -> dict:
    if isinstance(model_or_state_dict, torch.nn.Module):
        return model_or_state_dict.state_dict()
    return dict(model_or_state_dict)


def _placement(model_or_state_dict, mesh: Mesh, kind: str, dim_of) -> Placement:
    sd = _state_dict(model_or_state_dict)
    m = mesh.shape["model"]
    if m == 1:
        return Placement(None, 1, {n: None for n in sd}, sd)
    dims = {n: dim_of(n.split("."), v) for n, v in sd.items()}
    for n, d in dims.items():
        if d is not None and sd[n].shape[d] % m:
            raise ValueError(f"{n} {tuple(sd[n].shape)} does not split {m} ways on axis {d}")
    return Placement(kind, m, dims, sd)


def shard_params(model_or_state_dict, mesh: Mesh, lstm_gates: bool = False) -> Placement:
    """Tensor-parallel placement of a uPIT (or RSH) over the model axis.

    Default (head-only): the mask head's ``lin.weight`` (out, in) and
    ``lin.bias`` split their output dimension, a column-parallel product
    whose one collective is outside the recurrence; the rest is replicated.
    ``lstm_gates=True`` also splits each BLSTM direction's ``weight_ih``,
    ``weight_hh`` and biases on the 4H axis, in contiguous (i, f, g, o)
    blocks (the JAX package's (in, 4H) columns, transposed): each rank
    computes its gate columns of the input projection, and the projection
    and ``weight_hh`` are gathered before the recurrence, which every rank
    of a model group runs whole. With a model axis of 1 everything is
    replicated."""
    def dim_of(path, v):
        if "lin" in path or (lstm_gates and "blstm" in path and v.dim() in (1, 2)):
            return 0
        return None
    return _placement(model_or_state_dict, mesh, "lstm_gates" if lstm_gates else "head", dim_of)


def shard_params_convtasnet(model_or_state_dict, mesh: Mesh) -> Placement:
    """Megatron-style placement of a Conv-TasNet over the model axis. In
    each block the hidden axis H is split: ``expand`` (channels -> H) is
    column-parallel, the depthwise conv, the PReLUs and the norms act on the
    rank's H block (the norms' statistics summed over the model group), and
    ``res`` and ``skip`` (H -> channels) are row-parallel, their biases
    replicated and added once after the sum. The mask head is
    column-parallel; ``enc``, ``dec``, ``in_ln``, ``bottleneck`` and
    ``head_prelu`` are replicated. Parameters keep the JAX pytree's (in,
    out) layout, so each split axis is the JAX package's."""
    def dim_of(path, v):
        if "blocks" in path:
            if any(n in path for n in ("expand", "dw", "dw_b", "prelu1", "prelu2",
                                       "ln1", "ln2")):
                return v.dim() - 1
            if any(n in path for n in ("res", "skip")):
                return 0 if v.dim() == 2 else None
        elif "head" in path:
            return v.dim() - 1
        return None
    return _placement(model_or_state_dict, mesh, "convtasnet", dim_of)


def place(model: torch.nn.Module, placement: Placement, k: int) -> None:
    """Give ``model`` model index k's shards (each split parameter becomes
    its block, marked with ``model_split``, its axis) and switch its
    forward to the placement's split products (the ``tp`` attribute of each
    module that has one). A placement of kind None loads the state as it
    is."""
    shards = placement.shards(k)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if placement.dims.get(name) is not None:
                p.data = shards[name].to(p.device, p.dtype).contiguous()
                p.model_split = placement.dims[name]
    model.load_state_dict(shards)
    for m in model.modules():
        if hasattr(type(m), "tp"):
            m.tp = placement.kind

