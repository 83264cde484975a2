"""Checkpoints across the reference, the JAX package and the port.

The counterpart of speech_separation_tpu/utils/import_torch.py, without JAX:
the JAX package's ``SEPTPU01`` files are read by train/checkpoint.
read_septpu01 and turned into the port's state dicts by utils/weights.py's
converters.

- ``state_dict_from_septpu01``: a decoded ``SEPTPU01`` payload as the
  port's state dict of its arch (``meta['arch']``, uPIT when it names none,
  as the JAX loader reads it): ``state_dict_from_jax`` for uPIT and RSH,
  ``dprnn_state_dict_from_jax`` for DPRNN, ``pytree_state_dict_from_jax``
  for TCN, SepFormer and Conv-TasNet.
- ``import_reference_model`` (``import-model <in> <out.mdl>``): a reference
  ``.mdl`` (the reference's own ``torch.save(model.state_dict())``) or a
  ``SEPTPU01`` file, written as a port checkpoint: the ``.mdl`` and its
  ``.state`` with ``meta`` {arch, model_kwargs, imported_from}. A reference
  ``.mdl``'s sizes come from its weight shapes, and its two LSTM biases are
  stored summed in ``bias_ih`` with ``bias_hh`` zero, the JAX package's
  layout (the forward is unchanged: torch adds them).
- ``export_reference_model`` (``export-model <in> <out.mdl>``): a port
  checkpoint or a ``SEPTPU01`` file, written as the reference's ``.mdl``:
  uPIT and RSH only (the reference has no other arch), the full bias in
  ``bias_ih`` and ``bias_hh`` zero, ``bn.num_batches_tracked`` synthesised.
- ``checkpoint_info``: the lines of the ``info`` subcommand.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..train.checkpoint import (is_septpu01, load_checkpoint, read_septpu01, save_state_dict,
                                state_path)
from .weights import (dprnn_state_dict_from_jax, infer_model_info,
                      pytree_state_dict_from_jax, state_dict_from_jax)


def _arch_name(meta: dict) -> str:
    from ..models.registry import get_arch
    return get_arch(meta.get("arch") or "uPIT").NAME


def state_dict_from_septpu01(payload: dict) -> dict[str, torch.Tensor]:
    """The port's state dict of a ``read_septpu01`` payload's model."""
    arch = _arch_name(payload["meta"])
    if arch in ("uPIT", "RSH"):
        return state_dict_from_jax(payload["params"], payload["state"])
    if arch == "DPRNN":
        return dprnn_state_dict_from_jax(payload["params"])
    return pytree_state_dict_from_jax(payload["params"])


def _sizes(info: dict) -> dict:
    """model_kwargs of inferred reference sizes, as strings."""
    return {k: str(info[k]) for k in ("feat_dim", "hidden", "num_layers", "num_spk")
            if info.get(k) is not None}


def params_from_reference(sd: dict):
    """A reference SepDNN state dict as the JAX package's (params, state)
    layout, numpy float32 (the summed bias as ``b``): the port's copy of
    import_torch.params_from_state_dict. Returns (params, state, info)."""
    sd = {k: np.asarray(v.numpy() if hasattr(v, "numpy") else v) for k, v in sd.items()}
    info = infer_model_info(sd)
    f32_t = lambda a: np.ascontiguousarray(a.T).astype(np.float32)
    layers = []
    for li in range(info["num_layers"]):
        layers.append({direction: {
            "w_ih": f32_t(sd[f"blstm.weight_ih_l{li}{sfx}"]),
            "w_hh": f32_t(sd[f"blstm.weight_hh_l{li}{sfx}"]),
            "b": (sd[f"blstm.bias_ih_l{li}{sfx}"]
                  + sd[f"blstm.bias_hh_l{li}{sfx}"]).astype(np.float32)}
            for direction, sfx in (("fwd", ""), ("bwd", "_reverse"))})
    params = {"blstm": layers,
              "bn": {"gamma": sd["bn.weight"].astype(np.float32),
                     "beta": sd["bn.bias"].astype(np.float32)},
              "lin": {"w": f32_t(sd["lin.weight"]), "b": sd["lin.bias"].astype(np.float32)}}
    state = {"bn": {"mean": sd["bn.running_mean"].astype(np.float32),
                    "var": sd["bn.running_var"].astype(np.float32)}}
    return params, state, info


def _describe(info: dict) -> str:
    return (f"{info['arch']} model ({info['num_layers']}x{info['hidden']} BLSTM, "
            f"feat_dim {info['feat_dim']})")


def import_reference_model(in_path: str, out_path: str, log=print) -> dict:
    """A reference ``.mdl`` or a ``SEPTPU01`` file -> a port checkpoint
    (``out_path`` and its ``.state``). Returns the meta written."""
    if is_septpu01(in_path):
        payload = read_septpu01(in_path)
        sd = state_dict_from_septpu01(payload)
        meta = {"arch": _arch_name(payload["meta"]),
                "model_kwargs": dict(payload["meta"].get("model_kwargs") or {}),
                "imported_from": in_path}
        what = f"{meta['arch']} model (the JAX package's checkpoint, epoch {payload['epoch']})"
        epoch = payload["epoch"]
    else:
        params, state, info = params_from_reference(
            torch.load(in_path, map_location="cpu", weights_only=True))
        sd = state_dict_from_jax(params, state)
        meta = {"arch": info["arch"], "model_kwargs": _sizes(info), "imported_from": in_path}
        what, epoch = _describe(info), 0
    save_state_dict(out_path, sd, epoch=epoch, meta=meta)
    log(f"imported {what} -> {out_path}")
    return meta


def _port_checkpoint(path: str) -> dict:
    """train/checkpoint.load_checkpoint of a port checkpoint; a bare
    ``.mdl`` (no ``.state``) reads with meta {} and no training state."""
    return load_checkpoint(path, reference_resume=not os.path.isfile(state_path(path)))


def export_reference_model(in_path: str, out_path: str, log=print) -> dict:
    """A port checkpoint or a ``SEPTPU01`` file -> the reference's ``.mdl``
    (uPIT and RSH; any other arch raises). Returns the inferred sizes."""
    if is_septpu01(in_path):
        payload = read_septpu01(in_path)
        arch = _arch_name(payload["meta"])
    else:
        payload = None
        ckpt = _port_checkpoint(in_path)
        arch = _arch_name(ckpt["meta"] or {"arch": infer_model_info(ckpt["model"])["arch"]})
    if arch not in ("uPIT", "RSH"):
        raise ValueError(
            f"{in_path} holds a {arch!r} model; only the reference archs "
            "(uPIT, RSH) can be exported to the reference .mdl format")
    sd = (state_dict_from_septpu01(payload) if payload is not None
          else state_dict_from_jax(*params_from_reference(ckpt["model"])[:2]))
    info = infer_model_info(sd)
    torch.save(sd, out_path)
    log(f"exported {_describe(info)} -> {out_path} (reference torch state-dict)")
    if info["hidden"] != 600 or info["num_layers"] != 2:
        # the reference SepDNN builds a fixed 2x600 BLSTM
        log(f"note: the stock reference recipe builds a fixed 2x600 BLSTM; "
            f"this {info['num_layers']}x{info['hidden']} export loads via "
            "plain torch.load/state-dict APIs but NOT via the unmodified "
            "reference eval scripts")
    return info


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def checkpoint_info(path: str) -> list[str]:
    """The ``info`` lines of a ``SEPTPU01`` file (those of the JAX CLI's
    ``info``: the parameters counted over the decoded params tree) or of a
    port checkpoint (the ``.mdl``'s tensors and the ``.state`` beside it;
    a bare reference ``.mdl``'s arch and sizes from its shapes)."""
    if is_septpu01(path):
        ckpt = read_septpu01(path)
        meta = ckpt.get("meta") or {}
        leaves = [np.asarray(x) for x in _leaves(ckpt["params"])]
        epoch = ckpt["epoch"]
        has_opt, has_rng = ckpt["opt_state"] is not None, ckpt["rng"] is not None
    else:
        ckpt = _port_checkpoint(path)
        meta = ckpt["meta"]
        if not meta:
            info = infer_model_info(ckpt["model"])
            meta = {"arch": info["arch"], "model_kwargs": _sizes(info)}
        leaves = list(ckpt["model"].values())
        epoch = ckpt["epoch"]
        has_opt, has_rng = ckpt["optimizer"] is not None, ckpt["generator"] is not None
    lines = [f"arch: {meta.get('arch', '?')}"]
    lines += [f"  {k} = {v}" for k, v in sorted((meta.get("model_kwargs") or {}).items())]
    if meta.get("imported_from"):
        lines.append(f"imported from: {meta['imported_from']}")
    if epoch is not None:
        lines.append(f"epoch: {epoch}")
    if leaves:
        lines.append(f"parameters: {sum(int(np.prod(x.shape)) for x in leaves):,} "
                     f"({len(leaves)} arrays)")
    lines.append("optimizer state: " + ("present" if has_opt else "absent"))
    lines.append("rng state: " + ("present" if has_rng else "absent"))
    return lines
