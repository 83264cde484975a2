"""Weights across the two packages: shape inference on reference state
dicts, and the JAX parameter pytrees (uPIT/RSH; SepFormer, TCN and
Conv-TasNet, whose port names its parameters by the pytree's paths; DPRNN)
as state dicts of the port.

The layout rule is the one of speech_separation_tpu/utils/import_torch.py
(a copy, not an import):
- ``blstm.weight_ih_l{i}[_reverse]`` (4H, in) <-> ``w_ih`` (in, 4H), transposed;
- ``blstm.weight_hh_l{i}[_reverse]`` (4H, H)  <-> ``w_hh`` (H, 4H), transposed;
- the JAX package stores the two torch LSTM biases summed as ``b``: the sum
  goes to ``bias_ih`` and ``bias_hh`` is zero (torch adds them, so every
  forward is unchanged);
- ``lin.weight`` (out, 2H) <-> ``lin.w`` transposed, ``lin.bias`` <-> ``lin.b``;
- ``bn.weight/bias`` <-> gamma/beta, ``bn.running_mean/var`` <-> state['bn'].

Training keeps that layout (``fold_lstm_biases``): the JAX package trains
one summed bias per direction, while torch's LSTM layout has two trainable
ones. Adam on both would move their sum by twice the step, and the global
norm of the clip would count that gradient twice, so the trajectory would
leave the JAX package's from the first step. So the trainer folds
``bias_hh`` into ``bias_ih`` and keeps ``bias_hh`` at zero and out of the
optimizer.
"""

from __future__ import annotations

import numpy as np
import torch


def infer_model_info(sd: dict) -> dict:
    """Infer {arch, feat_dim, num_spk, hidden, num_layers} from the shapes
    of a reference SepDNN state dict (values: numpy arrays or tensors)."""
    if "blstm.weight_ih_l0" not in sd or "lin.weight" not in sd:
        raise ValueError("not a reference SepDNN state dict "
                         "(expected blstm.*/lin.*/bn.* keys)")
    w0 = sd["blstm.weight_ih_l0"]
    if w0.shape[0] % 4:
        raise ValueError(f"weight_ih_l0 first dim {w0.shape[0]} is not 4*H "
                         "(unexpected gate layout)")
    hidden = w0.shape[0] // 4
    input_dim = w0.shape[1]
    num_layers = len([k for k in sd
                      if k.startswith("blstm.weight_ih_l")
                      and not k.endswith("_reverse")])
    if "blstm.weight_ih_l0_reverse" not in sd:
        raise ValueError("state dict is not bidirectional")
    lin_out = sd["lin.weight"].shape[0]
    if input_dim == 2 * lin_out:
        # RSH: input = concat(mix, attention) of dim 2F, one mask of dim F
        return {"arch": "RSH", "feat_dim": lin_out, "num_spk": None,
                "hidden": hidden, "num_layers": num_layers}
    if lin_out % input_dim == 0:
        return {"arch": "uPIT", "feat_dim": input_dim,
                "num_spk": lin_out // input_dim,
                "hidden": hidden, "num_layers": num_layers}
    raise ValueError(f"cannot infer arch from shapes: input_dim={input_dim}, "
                     f"lin_out={lin_out}")


def _listed(node):
    """A pytree list, or its msgpack-checkpoint form (a dict keyed "0".."N-1")."""
    return [node[k] for k in sorted(node, key=int)] if isinstance(node, dict) else node


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _f32_t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).T))


def _blstm_state_dict(layers, prefix: str) -> dict[str, torch.Tensor]:
    """A JAX BLSTM's layers ({'fwd', 'bwd'} of w_ih, w_hh, b each) under
    torch.nn.LSTM's names, the summed bias in bias_ih and bias_hh zero."""
    sd = {}
    for li, directions in enumerate(_listed(layers)):
        for direction, sfx in (("fwd", ""), ("bwd", "_reverse")):
            d = directions[direction]
            sd[f"{prefix}weight_ih_l{li}{sfx}"] = _f32_t(d["w_ih"])
            sd[f"{prefix}weight_hh_l{li}{sfx}"] = _f32_t(d["w_hh"])
            sd[f"{prefix}bias_ih_l{li}{sfx}"] = _f32(d["b"])
            sd[f"{prefix}bias_hh_l{li}{sfx}"] = torch.zeros_like(_f32(d["b"]))
    return sd


def state_dict_from_jax(params_np, state_np) -> dict[str, torch.Tensor]:
    """The JAX package's uPIT or RSH (params, state) pytree, as numpy arrays,
    turned into the port's state dict of float32 tensors (RSH's is uPIT's
    layout with a 2F input and an F head)."""
    sd = _blstm_state_dict(params_np["blstm"], "blstm.")
    sd["bn.weight"] = _f32(params_np["bn"]["gamma"])
    sd["bn.bias"] = _f32(params_np["bn"]["beta"])
    sd["bn.running_mean"] = _f32(state_np["bn"]["mean"])
    sd["bn.running_var"] = _f32(state_np["bn"]["var"])
    sd["bn.num_batches_tracked"] = torch.tensor(1, dtype=torch.long)
    sd["lin.weight"] = _f32_t(params_np["lin"]["w"])
    sd["lin.bias"] = _f32(params_np["lin"]["b"])
    return sd


def pytree_state_dict_from_jax(params_np) -> dict[str, torch.Tensor]:
    """A JAX params pytree, as numpy arrays, turned into the port's state
    dict of float32 tensors, every leaf under its path (``in_ln.g``,
    ``blocks.3.dw``): the layout of the port's SepFormer, TCN and Conv-TasNet,
    which name their parameters by the pytree's paths in the same (in, out)
    layout. ``blocks`` is a list (or, in a msgpack checkpoint, a dict keyed
    "0".."N-1")."""
    sd = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            keys = sorted(node, key=int) if prefix.endswith("blocks") else node
            for k in keys:
                walk(f"{prefix}.{k}" if prefix else str(k), node[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}.{i}", v)
        else:
            sd[prefix] = _f32(node)

    walk("", params_np)
    return sd



def dprnn_state_dict_from_jax(params_np) -> dict[str, torch.Tensor]:
    """The JAX package's DPRNN params pytree, as numpy arrays, turned into
    the port's state dict of float32 tensors: every leaf by its pytree path
    (``pytree_state_dict_from_jax``), except each block's ``intra_rnn`` and
    ``inter_rnn``, which go under torch.nn.LSTM's names."""
    blocks = _listed(params_np["blocks"])
    sd = pytree_state_dict_from_jax(
        {k: v for k, v in params_np.items() if k != "blocks"}
        | {"blocks": [{k: v for k, v in b.items() if not k.endswith("_rnn")} for b in blocks]})
    for i, b in enumerate(blocks):
        for path in ("intra_rnn", "inter_rnn"):
            sd.update(_blstm_state_dict(b[path], f"blocks.{i}.{path}."))
    return sd


def fold_lstm_biases(module: torch.nn.Module) -> None:
    """Fold every ``bias_hh_*`` of the LSTMs in ``module`` into its
    ``bias_ih_*``, zero it and freeze it (requires_grad False): one trainable
    bias per direction, as the JAX package has. Forwards are unchanged; a
    module without an LSTM is left as it is."""
    with torch.no_grad():
        for m in module.modules():
            for name, p in list(m.named_parameters(recurse=False)):
                if name.startswith("bias_hh_"):
                    getattr(m, "bias_ih_" + name[len("bias_hh_"):]).add_(p)
                    p.zero_()
                    p.requires_grad_(False)


def shard_state_dict(sd: dict, dims: dict, m: int, k: int) -> dict:
    """Model index k's part of a state dict over a model axis of ``m``:
    each tensor whose ``dims`` entry is an axis cut into ``m`` contiguous
    equal blocks and block k kept (as the JAX package's NamedSharding lays
    a split axis over its mesh), the others whole (parallel/mesh.Placement)."""
    return {n: v if dims.get(n) is None else v.chunk(m, dims[n])[k].clone()
            for n, v in sd.items()}
