"""Checkpoints under the reference's names, loadable by the serving path.

The counterpart of speech_separation_tpu/train/checkpoint.py. The reference
writes the bare state dict as ``intermediate_models/init.mdl``,
``intermediate_models/NNN.mdl`` every 5 epochs and ``final.mdl``; so does
the port, so every ``.mdl`` loads as it is with eval/infer.load_model (and
with the reference's own loader). What resuming also needs goes beside it,
in ``<name>.state`` (a ``torch.save`` dict): the optimizer's state (Adam
moments, step counts, the update count of the lr schedule), the state of
the generator that draws the initial LSTM states, the epoch and the meta
(arch, model kwargs). With both, a resumed run continues bit for bit;
``reference_resume`` reads the weights only, as the reference does, so it
also resumes from a reference's bare ``.mdl``.

``read_septpu01`` reads the JAX package's own checkpoint format (its
train/checkpoint.py): the magic ``SEPTPU01``, a little-endian u32 header
length, a JSON header ``{"epoch", "meta"}``, then flax's msgpack payload
``{"params", "state"[, "opt_state"][, "rng"]}``, decoded by
utils/msgpack_lite.py into nested dicts of numpy arrays (a pytree's
tuples and lists are dicts keyed "0".."N-1" there).
"""

from __future__ import annotations

import json
import os
import struct

import torch

SEPTPU_MAGIC = b"SEPTPU01"


def state_path(mdl_path: str) -> str:
    """The training state's file beside a ``.mdl``."""
    return os.path.splitext(mdl_path)[0] + ".state"


def _save_atomic(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)  # a crash never leaves a torn file


def unwrap(model: torch.nn.Module) -> torch.nn.Module:
    """The module a DistributedDataParallel (or DataParallel) wraps, else
    ``model``."""
    wrappers = (torch.nn.parallel.DistributedDataParallel, torch.nn.DataParallel)
    return model.module if isinstance(model, wrappers) else model


def save_checkpoint(mdl_path: str, model: torch.nn.Module, *, optimizer=None,
                    generator: torch.Generator | None = None, epoch: int = 0,
                    meta: dict | None = None) -> None:
    """Write the model's state dict to ``mdl_path`` and the training state
    to ``state_path(mdl_path)``. A wrapped model (DistributedDataParallel's
    ``module``) is saved unwrapped: no ``module.`` prefix reaches a
    ``.mdl``."""
    os.makedirs(os.path.dirname(os.path.abspath(mdl_path)), exist_ok=True)
    model = unwrap(model)
    _save_atomic({k: v.detach().cpu() for k, v in model.state_dict().items()}, mdl_path)
    _save_atomic({"epoch": int(epoch), "meta": meta or {},
                  "optimizer": optimizer.state_dict() if optimizer is not None else None,
                  "generator": generator.get_state() if generator is not None else None},
                 state_path(mdl_path))


def load_checkpoint(mdl_path: str, *, reference_resume: bool = False) -> dict:
    """{'model': state dict, 'epoch', 'meta', 'optimizer', 'generator'};
    with ``reference_resume`` the ``.state`` file is not read, and epoch,
    optimizer and generator are None."""
    model = torch.load(mdl_path, map_location="cpu", weights_only=True)
    if reference_resume:
        return {"model": model, "epoch": None, "meta": {}, "optimizer": None,
                "generator": None}
    path = state_path(mdl_path)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"{path} is missing: {mdl_path} holds the weights only (as the "
            "reference writes it); resume from it with reference_resume "
            "(--reference-resume)")
    extra = torch.load(path, map_location="cpu", weights_only=True)
    return {"model": model, **extra}


def save_state_dict(mdl_path: str, state_dict: dict, *, epoch: int = 0,
                    meta: dict | None = None) -> None:
    """Write a converted state dict as a port checkpoint: the ``.mdl`` and
    a ``.state`` beside it with the epoch and meta and no optimizer or
    generator state."""
    os.makedirs(os.path.dirname(os.path.abspath(mdl_path)), exist_ok=True)
    _save_atomic(state_dict, mdl_path)
    _save_atomic({"epoch": int(epoch), "meta": meta or {}, "optimizer": None,
                  "generator": None}, state_path(mdl_path))


def is_septpu01(path: str) -> bool:
    """Whether ``path`` starts with the JAX package's checkpoint magic."""
    with open(path, "rb") as f:
        return f.read(len(SEPTPU_MAGIC)) == SEPTPU_MAGIC


def read_septpu01(path: str) -> dict:
    """The JAX package's checkpoint as {'params', 'state', 'opt_state',
    'rng', 'epoch', 'meta'}, numpy leaves (opt_state and rng None when the
    file has none), read without JAX, flax or msgpack."""
    from ..utils.msgpack_lite import unchunk, unpackb
    with open(path, "rb") as f:
        if f.read(len(SEPTPU_MAGIC)) != SEPTPU_MAGIC:
            raise ValueError(f"{path}: not a speech_separation_tpu checkpoint")
        (hlen,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hlen).decode())
        try:
            payload = unchunk(unpackb(f.read()))
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from e
    for key in ("opt_state", "rng"):
        payload.setdefault(key, None)
    payload["epoch"] = header["epoch"]
    payload["meta"] = header["meta"]
    return payload


def intermediate_model_path(exp_dir: str, epoch: int | str) -> str:
    """Reference naming: intermediate_models/NNN.mdl, init.mdl."""
    name = epoch if isinstance(epoch, str) else f"{epoch:03d}"
    return os.path.join(exp_dir, "intermediate_models", f"{name}.mdl")


def final_model_path(exp_dir: str) -> str:
    return os.path.join(exp_dir, "final.mdl")
