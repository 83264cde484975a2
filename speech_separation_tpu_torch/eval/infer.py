"""Model loading for the port: torch state-dict ``.mdl`` files.

The counterpart of speech_separation_tpu/eval/infer.py::load_model. The port
reads a ``.mdl`` state dict (``torch.save(model.state_dict())``): one that
its own trainer wrote, with the arch and model kwargs in the ``.state`` meta
beside it (train/checkpoint.py), or a reference SepDNN state dict (the JAX
package writes one with ``sepsep export-model``), whose arch and sizes are
inferred from the weight shapes. ``model_kwargs`` (for example
``compute_dtype`` or ``zero_init_hidden``) apply on top. The JAX package's
own msgpack checkpoints are not read yet (ROADMAP.md).
"""

from __future__ import annotations

import os

import torch

from ..models.registry import get_arch
from ..train.checkpoint import state_path
from ..utils.weights import infer_model_info

_SEPTPU_MAGIC = b"SEPTPU01"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Without a visible card it raises; it never falls back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; the port runs on the GPU "
                           "(pass device='cpu' for the plain PyTorch versions)")
    return dev


def load_state_dict(model_path: str) -> dict:
    with open(model_path, "rb") as f:
        magic = f.read(len(_SEPTPU_MAGIC))
    if magic == _SEPTPU_MAGIC:
        raise ValueError(
            f"{model_path} is a speech_separation_tpu (JAX) checkpoint; the "
            "PyTorch port reads reference .mdl state dicts: convert it with "
            "`python -m speech_separation_tpu.cli.main export-model "
            f"{model_path} <out.mdl>`")
    return torch.load(model_path, map_location="cpu", weights_only=True)


def _checkpoint_meta(model_path: str) -> dict:
    """The meta (arch, model kwargs) that the port's trainer writes beside a
    ``.mdl`` in ``<name>.state``; {} when there is none (a reference
    ``.mdl``)."""
    path = state_path(model_path)
    if not os.path.isfile(path):
        return {}
    return torch.load(path, map_location="cpu", weights_only=True).get("meta") or {}


def load_model(model_path: str, arch_name: str = "",
               model_kwargs: dict | None = None, device=None):
    """Load (arch, cfg, model) from a ``.mdl``, the model in eval mode on
    ``device`` (CUDA by default). The arch and its kwargs come from the
    port's ``.state`` meta when it is there, else from the shapes of a
    reference uPIT/RSH state dict; ``arch_name`` and ``model_kwargs``
    override both."""
    dev = resolve_device(device)
    sd = load_state_dict(model_path)
    meta = _checkpoint_meta(model_path)
    if meta.get("arch"):
        name, kwargs = meta["arch"], dict(meta.get("model_kwargs") or {})
    else:
        info = infer_model_info(sd)
        name = info["arch"]
        kwargs = {k: str(info[k]) for k in ("feat_dim", "num_spk", "hidden", "num_layers")
                  if info.get(k) is not None}
    arch = get_arch(arch_name or name)
    kwargs.update(model_kwargs or {})
    cfg = arch.Config.from_kwargs(**kwargs)
    model = arch.Model(cfg)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    # older torch writes no num_batches_tracked; eval never reads it
    missing = [k for k in missing if k != "bn.num_batches_tracked"]
    if missing or unexpected:
        raise ValueError(f"{model_path}: state dict does not fit {arch.NAME} "
                         f"{cfg}: missing {missing}, unexpected {unexpected}")
    return arch, cfg, model.to(dev).eval()
