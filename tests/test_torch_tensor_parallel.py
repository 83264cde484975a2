"""Tensor parallelism of the port (parallel/mesh.py's model axis,
shard_params with and without lstm_gates, shard_params_convtasnet, the
collectives of parallel/ranks.py) on the CPU, as tests/test_multichip.py and
tests/test_multichip_convtasnet.py hold the JAX package's.

- Placement, no spawn: for uPIT in both placements and for Conv-TasNet, the
  port's shard for model index k equals, bit for bit, the JAX array's shard
  on mesh device (0, k) of a data=2 x model=2 mesh.
- The step: one spawn of four gloo CPU ranks (data 2 x model 2) runs every
  job, each held against the port's single-process step on the same
  (row-padded) batch and, for the JAX tests' jobs, against the JAX package's
  data=2 x model=2 step.
- Four fault controls, each a way tensor parallelism goes wrong.

Tolerances:
- against the port's single-process step, tests/test_torch_parallel_train.py's
  STEP_LOSS (1e-6 relative), STEP_GRAD (each gradient within 1e-5 of its
  largest magnitude) and STEP_PARAM (1e-6 absolute, the updated parameters
  and BN's statistics); the clip's norm within STEP_GRAD relative (a sum of
  the gradients' squares: each within STEP_GRAD, so is it);
- except the updated parameters whose gradient lies within 100 times
  Adam's eps (1e-8) of zero: held at the JAX tests' 1e-5 (JAX_PARAM). Adam's
  first update is lr g / (|g| + eps), so there a gradient difference dg
  moves the update by up to lr dg / eps: in uPIT's dp x tp step one
  blstm.weight_ih_l1 gradient of 7.4e-9 read 1.0e-10 apart (1.4e-8 of the
  tensor's largest gradient), and its weight 3.2e-6 apart;
- against the JAX package's step, its tests' own bounds: uPIT loss rtol
  1e-5, the loss's norm 1e-6, parameters atol 1e-5, BN 1e-6; Conv-TasNet
  2e-4 (loss, parameters);
- a fault control must miss the gradient bound by 100x.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_separation_tpu.models import convtasnet as jct
from speech_separation_tpu.models import upit as jupit
from speech_separation_tpu.parallel.mesh import make_mesh as jax_mesh
from speech_separation_tpu.parallel.mesh import replicate_tree as jax_replicate
from speech_separation_tpu.parallel.mesh import shard_batch as jax_shard
from speech_separation_tpu.parallel.mesh import shard_params as jax_shard_params
from speech_separation_tpu.parallel.mesh import (shard_params_convtasnet
                                                 as jax_shard_params_convtasnet)
from speech_separation_tpu.train.loop import (TrainLoopConfig as JaxLoopConfig,
                                              make_optimizer, make_update_step)
from speech_separation_tpu_torch.models import convtasnet as tct
from speech_separation_tpu_torch.models import rsh as trsh
from speech_separation_tpu_torch.models import upit as tupit
from speech_separation_tpu_torch.parallel.checks import steps_over_ranks
from speech_separation_tpu_torch.parallel.mesh import (make_mesh, pad_rows, replicate_module,
                                                       run_replicas, shard_params,
                                                       shard_params_convtasnet)
from speech_separation_tpu_torch.train.loop import TrainLoopConfig, train
from speech_separation_tpu_torch.utils.weights import (fold_lstm_biases,
                                                       pytree_state_dict_from_jax,
                                                       state_dict_from_jax)

from test_torch_parallel_train import (CT_KW, STEP_GRAD, STEP_LOSS, STEP_PARAM, _audio,
                                       _errs, _features)
from torch_session import built_once

torch.set_num_threads(1)  # six xdist workers share the cores: one thread each, for life

ADAM_EPS = 1e-8
JAX_LOSS, JAX_NORM, JAX_PARAM, JAX_BN = 1e-5, 1e-6, 1e-5, 1e-6
JAX_CT = 2e-4
CPU4 = ["cpu"] * 4
# tests/test_multichip.py's dp x tp model and tests/test_multichip_convtasnet.py's CFG
UPIT_CFG = jupit.Config(feat_dim=16, hidden=8, num_layers=2, num_spk=2, zero_init_hidden=True)
UPIT_KW = {"feat_dim": "16", "hidden": "8", "num_layers": "2", "zero_init_hidden": "1"}
CT_CFG = jct.Config(n_filters=16, filter_len=16, stride=8, channels=8, hidden=12, kernel=3,
                    blocks=2, repeats=2, num_spk=2)
CT_CFG_KW = {k: str(getattr(CT_CFG, k)) for k in ("n_filters", "filter_len", "stride",
                                                  "channels", "hidden", "kernel", "blocks",
                                                  "repeats", "num_spk")}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _upit_batch():
    """tests/test_multichip.py's dp x tp batch (seed 3, B=8, T=32, F=16)."""
    rng = np.random.default_rng(3)
    B, T, F, S = 8, 32, 16, 2
    lengths = rng.integers(16, T + 1, size=B).astype(np.int32)
    mix = np.abs(rng.standard_normal((B, T, F))).astype(np.float32)
    sources = np.abs(rng.standard_normal((B, S, T, F))).astype(np.float32)
    for b in range(B):
        mix[b, lengths[b]:] = 0.0
        sources[b, :, lengths[b]:] = 0.0
    return {"mix": mix, "sources": sources, "lengths": lengths,
            "row_mask": np.ones((B,), np.float32)}


def _wave_batch(B=8, L=512, seed=0):
    """tests/test_multichip_convtasnet.py's waveform batch."""
    rng = np.random.default_rng(seed)
    srcs = (0.1 * rng.standard_normal((B, CT_CFG.num_spk, L))).astype(np.float32)
    return {"mix_wav": srcs.sum(axis=1), "source_wavs": srcs,
            "sample_lengths": np.full(B, L, np.int32), "row_mask": np.ones(B, np.float32)}


def _upit_jax_weights():
    params, state = jupit.init(jax.random.PRNGKey(0), UPIT_CFG)
    return params, state, state_dict_from_jax(_np(params), _np(state))


def _ct_jax_weights():
    params, _ = jct.init(jax.random.PRNGKey(0), CT_CFG)
    return params, pytree_state_dict_from_jax(_np(params))


def _param_errs(got, want):
    """The updated parameters' largest |difference| where the gradient
    stands clear of Adam's eps (|g| >= 100 eps), and where it does not."""
    clear = near = 0.0
    for n, p in want["params"].items():
        d = (got["params"][n] - p).abs()
        g = want["grads"].get(n)
        away = torch.ones_like(d, dtype=torch.bool) if g is None else g.abs() >= 100 * ADAM_EPS
        clear = max(clear, float(d[away].max()) if away.any() else 0.0)
        near = max(near, float(d[~away].max()) if (~away).any() else 0.0)
    return clear, near


def _weights(model):
    model.reset_parameters(torch.Generator().manual_seed(0))
    fold_lstm_biases(model)
    return model.state_dict()


# -------------------------------------------------------------- placement

def _jax_shard_tree(tree, mesh, k):
    """Each leaf's shard on mesh device (0, k), as numpy."""
    dev = mesh.devices[0, k]
    return jax.tree_util.tree_map(
        lambda a: np.asarray(next(s.data for s in a.addressable_shards if s.device == dev)),
        tree)


@pytest.mark.parametrize("lstm_gates", [False, True], ids=["head", "lstm_gates"])
def test_upit_shards_equal_the_jax_shards(lstm_gates):
    params, state, sd = _upit_jax_weights()
    jmesh = jax_mesh(data=2, model=2, devices=jax.devices()[:4])
    sharded = jax_shard_params(params, jmesh, lstm_gates=lstm_gates)
    placement = shard_params(sd, make_mesh(data=2, model=2, devices=CPU4), lstm_gates=lstm_gates)
    assert placement.kind == ("lstm_gates" if lstm_gates else "head")
    split = {n for n, d in placement.dims.items() if d is not None}
    assert split == ({n for n in sd if n.startswith(("lin.", "blstm."))} if lstm_gates
                     else {"lin.weight", "lin.bias"})
    for k in (0, 1):
        want = state_dict_from_jax(_jax_shard_tree(sharded, jmesh, k), _np(state))
        got = placement.shards(k)
        assert sorted(got) == sorted(want)
        for n in want:
            assert got[n].shape == want[n].shape and torch.equal(got[n], want[n]), (k, n)


def test_convtasnet_shards_equal_the_jax_shards():
    params, sd = _ct_jax_weights()
    jmesh = jax_mesh(data=2, model=2, devices=jax.devices()[:4])
    sharded = jax_shard_params_convtasnet(params, jmesh)
    placement = shard_params_convtasnet(sd, make_mesh(data=2, model=2, devices=CPU4))
    for k in (0, 1):
        want = pytree_state_dict_from_jax(_jax_shard_tree(sharded, jmesh, k))
        got = placement.shards(k)
        assert sorted(got) == sorted(want)
        for n in want:
            assert got[n].shape == want[n].shape and torch.equal(got[n], want[n]), (k, n)


def test_tp_placement_specs():
    """tests/test_multichip_convtasnet.py's specs (and test_multichip.py's
    head), in the port's names: the split axis, or None for replicated."""
    _, sd = _ct_jax_weights()
    dims = shard_params_convtasnet(sd, make_mesh(data=2, model=2, devices=CPU4)).dims
    assert dims["blocks.0.expand.w"] == 1 and dims["blocks.0.expand.b"] == 0
    assert dims["blocks.0.dw"] == 1 and dims["blocks.0.dw_b"] == 0
    assert dims["blocks.0.prelu1"] == 0 and dims["blocks.0.ln2.g"] == 0
    # row-parallel: the input dim split, the bias replicated (added after the sum)
    assert dims["blocks.0.res.w"] == 0 and dims["blocks.0.res.b"] is None
    assert dims["blocks.0.skip.w"] == 0 and dims["blocks.0.skip.b"] is None
    assert dims["head.w"] == 1 and dims["head.b"] == 0
    for name in ("head_prelu", "enc", "dec", "in_ln.g", "bottleneck.w", "bottleneck.b"):
        assert dims[name] is None, name
    # uPIT's head: JAX's (in, out) P(None, "model") is the port's (out, in) rows
    up = shard_params(_upit_jax_weights()[2], make_mesh(data=2, model=2, devices=CPU4))
    assert up.dims["lin.weight"] == 0 and up.dims["bn.weight"] is None
    # a model axis of 1: everything replicated
    one = shard_params_convtasnet(sd, make_mesh(devices=CPU4))
    assert one.kind is None and set(one.dims.values()) == {None}


def test_a_model_axis_serves_nothing_and_trains_only_through_the_checks(tmp_path):
    """Inference meshes and train() refuse a model axis: the JAX package
    trains only under it, and only from its tests."""
    mesh = make_mesh(data=2, model=2, devices=CPU4)
    with pytest.raises(ValueError, match="tensor parallelism is for training only"):
        replicate_module(torch.nn.Linear(2, 2), mesh)
    with pytest.raises(ValueError, match="tensor parallelism is for training only"):
        run_replicas(mesh, lambda i: i)
    with pytest.raises(ValueError, match="data axis only"):
        train(str(tmp_path), str(tmp_path / "exp"), TrainLoopConfig(), device="cpu", mesh=mesh)


# ------------------------------------------------------------------ steps

def _jobs():
    _, _, upit_sd = _upit_jax_weights()
    fold = tupit.UPIT(tupit.Config.from_kwargs(**UPIT_KW))
    fold.load_state_dict(upit_sd)
    fold_lstm_biases(fold)
    upit = {"arch": "uPIT", "model_kwargs": UPIT_KW, "weights": fold.state_dict(),
            "batch": _upit_batch(), "seed": 1, "time_pad_multiple": 4}
    random_kw = {"feat_dim": "16", "hidden": "8", "num_layers": "1"}
    ct = {"arch": "ConvTasNet", "model_kwargs": CT_CFG_KW, "weights": _ct_jax_weights()[1],
          "batch": _wave_batch(), "seed": 1}
    ct_dp = {"arch": "ConvTasNet", "model_kwargs": CT_KW, "batch": _audio(6), "seed": 1,
             "weights": _weights(tct.ConvTasNet(tct.Config.from_kwargs(**CT_KW)))}
    jobs = {
        "upit_head": dict(upit, tp="head"),
        "upit_lstm_gates": dict(upit, tp="lstm_gates"),
        # the reference's N(0, 1) initial states, ragged rows padded 5 -> 6
        "upit_random_init": dict(upit, model_kwargs=random_kw, tp="lstm_gates",
                                 weights=_weights(tupit.UPIT(tupit.Config.from_kwargs(
                                     **random_kw))), batch=_features(5, seed=1)),
        "rsh_head": dict(upit, arch="RSH", model_kwargs=random_kw, tp="head",
                         weights=_weights(trsh.RSH(trsh.Config.from_kwargs(**random_kw))),
                         batch=_features(5, seed=3)),
        "convtasnet": dict(ct, tp="convtasnet"),
        "convtasnet_dp_cfg": dict(ct_dp, tp="convtasnet"),
        "convtasnet_cln": dict(ct_dp, model_kwargs={**CT_KW, "norm": "cln"}, tp="convtasnet",
                               weights=_weights(tct.ConvTasNet(tct.Config.from_kwargs(
                                   **CT_KW, norm="cln")))),
    }
    for fault in ("gather_sums", "no_input_reduce", "world_sums"):
        jobs[fault] = dict(jobs["upit_lstm_gates"], faults=(fault,))
    jobs["shard_norm_stats"] = dict(jobs["convtasnet_dp_cfg"], faults=("shard_norm_stats",))
    return jobs


SOUND = ["upit_head", "upit_lstm_gates", "upit_random_init", "rsh_head", "convtasnet",
         "convtasnet_dp_cfg", "convtasnet_cln"]
FAULTS = {"gather_sums": "upit_lstm_gates", "no_input_reduce": "upit_lstm_gates",
          "world_sums": "upit_lstm_gates", "shard_norm_stats": "convtasnet_dp_cfg"}


def _run_steps(root):
    jobs = _jobs()
    names = list(jobs)
    over = steps_over_ranks([jobs[n] for n in names],
                            mesh=make_mesh(data=2, model=2, devices=CPU4))
    single = steps_over_ranks([dict(jobs[n], batch=pad_rows(jobs[n]["batch"], 2), tp=None)
                               for n in SOUND], device="cpu")
    torch.save((dict(zip(names, over)), dict(zip(SOUND, single))), root / "steps.pt")


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """Every job over data 2 x model 2 ranks (one spawn) and the sound ones
    in this process, once per session: (jobs, over the ranks, one process)."""
    root = built_once(tmp_path_factory, "torch_tensor_parallel_steps", _run_steps)
    over, single = torch.load(root / "steps.pt", weights_only=False)
    return _jobs(), over, single


@pytest.mark.parametrize("name", SOUND)
def test_dp_tp_step_equals_one_process(steps, name):
    """Loss, the loss's norm, the clip's norm, every gradient as reduced (the
    split ones assembled from their model group's blocks), the updated
    parameters and BN's running statistics."""
    _, over, single = steps
    got, want = over[name], single[name]
    loss, grad, _, buf = _errs(got, want)
    assert loss <= STEP_LOSS, loss
    assert grad <= STEP_GRAD, grad
    clear, near = _param_errs(got, want)
    assert clear <= STEP_PARAM, clear
    assert near <= JAX_PARAM, near
    assert buf <= STEP_PARAM, buf
    assert got["norm"] == pytest.approx(want["norm"], rel=1e-7)
    assert got["clip_norm"] == pytest.approx(want["clip_norm"], rel=STEP_GRAD)
    assert sorted(got["params"]) == sorted(want["params"])
    for n, p in want["params"].items():
        assert got["params"][n].shape == p.shape, n


def test_every_rank_clips_by_the_same_norm(steps):
    """The clip's norm is the logical parameters': split squares summed over
    the model group, replicated ones once; all four ranks see one value."""
    _, over, _ = steps
    for name in SOUND:
        norms = over[name]["clip_norms"]
        assert len(norms) == 4 and len(set(norms)) == 1, (name, norms)
        assert norms[0] == pytest.approx(over[name]["clip_norm"], rel=1e-7)


@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_controls_fail_the_comparison(steps, fault):
    """Each way tensor parallelism goes wrong moves the gradients far past
    the bound the sound step meets."""
    _, over, single = steps
    _, grad, _, _ = _errs(over[fault], single[FAULTS[fault]])
    assert grad > 100 * STEP_GRAD, grad


def _jax_upit_step(lstm_gates):
    cfg = UPIT_CFG
    optimizer = make_optimizer(JaxLoopConfig())
    step = make_update_step(jupit, cfg, optimizer)
    params, state = jupit.init(jax.random.PRNGKey(0), cfg)
    mesh = jax_mesh(data=2, model=2, devices=jax.devices()[:4])
    p = jax_shard_params(params, mesh, lstm_gates=lstm_gates)
    s, o = jax_replicate(state, mesh), jax_replicate(optimizer.init(params), mesh)
    with mesh:
        p2, s2, _, loss, norm = step(p, s, o, jax_shard(_upit_batch(), mesh),
                                     jax.random.PRNGKey(1))
    return float(loss), float(norm), state_dict_from_jax(_np(p2), _np(s2))


@pytest.mark.parametrize("lstm_gates", [False, True], ids=["head", "lstm_gates"])
def test_upit_dp_tp_step_matches_the_jax_mesh_step(steps, lstm_gates):
    """tests/test_multichip.py's dp x tp step on a data=2 x model=2 mesh of
    the JAX package's devices against the port's four ranks."""
    _, over, _ = steps
    got = over["upit_lstm_gates" if lstm_gates else "upit_head"]
    loss, norm, ref = _jax_upit_step(lstm_gates)
    np.testing.assert_allclose(got["loss"], loss, rtol=JAX_LOSS)
    np.testing.assert_allclose(got["norm"], norm, rtol=JAX_NORM)
    for name, want in ref.items():
        if name == "bn.num_batches_tracked":
            continue
        is_bn = name.startswith("bn.running")
        have = (got["buffers"] if is_bn else got["params"])[name]
        np.testing.assert_allclose(have.numpy(), want.numpy(),
                                   atol=JAX_BN if is_bn else JAX_PARAM, err_msg=name)


def test_convtasnet_dp_tp_step_matches_the_jax_mesh_step(steps):
    """tests/test_multichip_convtasnet.py's dp x tp step (Megatron blocks) on
    a data=2 x model=2 mesh against the port's four ranks."""
    _, over, _ = steps
    optimizer = make_optimizer(JaxLoopConfig())
    params, state = jct.init(jax.random.PRNGKey(0), CT_CFG)
    mesh = jax_mesh(data=2, model=2, devices=jax.devices()[:4])
    p = jax_shard_params_convtasnet(params, mesh)
    s, o = jax_replicate(state, mesh), jax_replicate(optimizer.init(params), mesh)
    step = make_update_step(jct, CT_CFG, optimizer)
    with mesh:
        p2, _, _, loss, norm = step(p, s, o, jax_shard(_wave_batch(), mesh),
                                    jax.random.PRNGKey(1))
    got = over["convtasnet"]
    np.testing.assert_allclose(got["loss"], float(loss), rtol=JAX_CT)
    np.testing.assert_allclose(got["norm"], float(norm), rtol=JAX_NORM)
    ref = pytree_state_dict_from_jax(_np(p2))
    assert sorted(ref) == sorted(got["params"])
    for name, want in ref.items():
        np.testing.assert_allclose(got["params"][name].numpy(), want.numpy(), atol=JAX_CT,
                                   err_msg=name)
    assert jnp.isfinite(loss)

