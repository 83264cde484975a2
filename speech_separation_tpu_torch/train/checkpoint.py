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
"""

from __future__ import annotations

import os

import torch


def state_path(mdl_path: str) -> str:
    """The training state's file beside a ``.mdl``."""
    return os.path.splitext(mdl_path)[0] + ".state"


def _save_atomic(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)  # a crash never leaves a torn file


def save_checkpoint(mdl_path: str, model: torch.nn.Module, *, optimizer=None,
                    generator: torch.Generator | None = None, epoch: int = 0,
                    meta: dict | None = None) -> None:
    """Write the model's state dict to ``mdl_path`` and the training state
    to ``state_path(mdl_path)``."""
    os.makedirs(os.path.dirname(os.path.abspath(mdl_path)), exist_ok=True)
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


def intermediate_model_path(exp_dir: str, epoch: int | str) -> str:
    """Reference naming: intermediate_models/NNN.mdl, init.mdl."""
    name = epoch if isinstance(epoch, str) else f"{epoch:03d}"
    return os.path.join(exp_dir, "intermediate_models", f"{name}.mdl")


def final_model_path(exp_dir: str) -> str:
    return os.path.join(exp_dir, "final.mdl")
