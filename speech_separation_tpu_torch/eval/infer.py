"""Model loading and mask inference for the port.

The counterpart of speech_separation_tpu/eval/infer.py. ``load_model``: the port
reads a ``.mdl`` state dict (``torch.save(model.state_dict())``): one that
its own trainer wrote, with the arch and model kwargs in the ``.state`` meta
beside it (train/checkpoint.py), or a reference SepDNN state dict, whose
arch and sizes are inferred from the weight shapes; and the JAX package's
own ``SEPTPU01`` checkpoints, read without JAX (train/checkpoint.
read_septpu01, utils/import_reference.py), the arch and model kwargs from
their header's meta. A uPIT or RSH model's sizes come from its weight
shapes, the meta's kwargs on top; ``model_kwargs`` (for example
``compute_dtype`` or ``zero_init_hidden``) apply on top of both.

``generate_masks`` streams a test set's features (``feats_test.scp``)
through the eval-mode forward in padded batches and writes one mask npz per
utterance: keys ``s1``..``sN``, (freq, time) float32, trimmed to the
utterance's length, the format the reference's eval writes. For RSH the
batches hold one speaker count each (from ``utt2num_spk``), and an
utterance of S speakers gets the masks of S passes, ``s1``..``sS`` in pass
order. The recurrence runs through the hand-written inference kernel on
CUDA.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models.registry import get_arch
from ..train.checkpoint import is_septpu01, load_checkpoint, read_septpu01, state_path
from ..utils.device import resolve_device
from ..utils.weights import infer_model_info


def read_checkpoint(model_path: str) -> tuple[dict, dict]:
    """(state dict, meta) of a model file: a ``SEPTPU01`` checkpoint's
    weights converted to the port's layout with its header's meta, or a
    ``.mdl`` with the meta (arch, model kwargs) that the port's trainer
    writes beside it in ``<name>.state`` ({} when there is none, as for a
    reference ``.mdl``)."""
    if is_septpu01(model_path):
        from ..utils.import_reference import state_dict_from_septpu01
        payload = read_septpu01(model_path)
        return state_dict_from_septpu01(payload), {"arch": "uPIT", **payload["meta"]}
    ckpt = load_checkpoint(model_path,
                           reference_resume=not os.path.isfile(state_path(model_path)))
    return ckpt["model"], ckpt["meta"] or {}


def load_model(model_path: str, arch_name: str = "",
               model_kwargs: dict | None = None, device=None):
    """Load (arch, cfg, model) from a ``.mdl`` or a ``SEPTPU01`` checkpoint,
    the model in eval mode on ``device`` (CUDA by default). The arch and its
    kwargs come from the meta (the port's ``.state``, a ``SEPTPU01``
    header) when there is one, a uPIT/RSH model's sizes from its weight
    shapes; ``arch_name`` and ``model_kwargs`` override both."""
    dev = resolve_device(device)
    sd, meta = read_checkpoint(model_path)
    name, kwargs = meta.get("arch"), {}
    if name in (None, "uPIT", "RSH") and "blstm.weight_ih_l0" in sd:
        info = infer_model_info(sd)
        name = name or info["arch"]
        kwargs = {k: str(info[k]) for k in ("feat_dim", "num_spk", "hidden", "num_layers")
                  if info.get(k) is not None}
    if name is None:
        infer_model_info(sd)             # raises: not a reference state dict
    kwargs.update(meta.get("model_kwargs") or {})
    arch = get_arch(arch_name or name)
    kwargs.update(model_kwargs or {})
    cfg = arch.Config.from_kwargs(**kwargs)
    model = arch.Model(cfg)
    try:
        missing, unexpected = model.load_state_dict(sd, strict=False)
    except RuntimeError as e:            # weight shapes that do not fit cfg
        raise ValueError(f"{model_path}: state dict does not fit {arch.NAME} {cfg}: "
                         f"{e}") from e
    # older torch writes no num_batches_tracked; eval never reads it
    missing = [k for k in missing if k != "bn.num_batches_tracked"]
    if missing or unexpected:
        raise ValueError(f"{model_path}: state dict does not fit {arch.NAME} "
                         f"{cfg}: missing {missing}, unexpected {unexpected}")
    return arch, cfg, model.to(dev).eval()


def generate_masks(model_path: str, data_dir: str, out_dir: str,
                   arch_name: str = "", model_kwargs: dict | None = None,
                   batch_size: int = 100, seed: int = 0, log=print,
                   device=None) -> None:
    """Write ``out_dir/<utt>.npz`` masks for every utterance of
    ``data_dir/feats_test.scp``, on ``device`` (CUDA by default; it raises
    when no card is visible). Every batch is padded to ``batch_size`` rows;
    eval-mode BN uses its running statistics, so a row's masks do not depend
    on the other rows. Frames are padded to a multiple of 128, as in
    training. The initial LSTM state is the reference's N(0, 1)
    draw, from a generator seeded with ``seed``, unless the model config
    says ``zero_init_hidden``."""
    from ..datadir.scp import read_utt2num_spk
    from ..train.data import BatchPlan, FeatureDataset, make_device_batch, plan_batches
    arch, cfg, model = load_model(model_path, arch_name, model_kwargs, device)
    if arch.DOMAIN == "time":
        raise ValueError(
            f"{arch.NAME} is a time-domain architecture: it has no spectral "
            "masks to write. Evaluate through the fused waveform path "
            "(run-eval --on-device-features) or `separate`.")
    dev = next(model.parameters()).device
    os.makedirs(out_dir, exist_ok=True)

    dataset = FeatureDataset(data_dir, "test")
    rsh = arch.NAME == "RSH"
    plan = BatchPlan(batch_size=min(batch_size, len(dataset)), group_by_num_spk=rsh)
    num_spks = None
    if rsh:
        utt2num = read_utt2num_spk(os.path.join(data_dir, "utt2num_spk"))
        num_spks = np.asarray([utt2num[dataset.utt_id(i)] for i in range(len(dataset))])
    generator = torch.Generator(device=dev).manual_seed(seed)
    F = cfg.feat_dim
    for idxs in plan_batches(dataset, plan, 0, num_spks=num_spks, shuffle=False):
        batch_np = make_device_batch([dataset.load(i) for i in idxs], plan)
        batch = {k: torch.from_numpy(batch_np[k]).to(dev)
                 for k in ("mix", "lengths", "row_mask")}
        if rsh:
            S = int(num_spks[idxs[0]])
            masks = arch.infer_masks(model, batch, generator, S)          # (B, S, T, F)
        else:
            S = cfg.num_spk
            masks = arch.infer_masks(model, batch, generator)             # (B, T, F*S)
            masks = masks.reshape(*masks.shape[:2], S, F).transpose(1, 2)
        masks = masks.cpu().numpy()
        for row in range(len(idxs)):
            T_i = int(batch_np["lengths"][row])
            np.savez_compressed(
                os.path.join(out_dir, batch_np["names"][row]),
                **{f"s{s + 1}": masks[row, s, :T_i].T.astype(np.float32) for s in range(S)})
    log(f"wrote masks for {len(dataset)} utterances -> {out_dir}")
