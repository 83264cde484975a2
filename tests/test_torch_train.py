"""The port's uPIT training (speech_separation_tpu_torch: ops/pit.py, the
loss in models/upit.py, train/) against the JAX package on the CPU, with
the same weights (utils/weights.state_dict_from_jax) and the same numpy
inputs; then the ``train`` CLI end to end on a tiny corpus.

Tolerances: the PIT ops and the loss are the same f32 sums in another order
(rtol 1e-6 and 1e-5). Gradients of the whole loss: atol 1e-5 of the largest
reference gradient (f32 sums over T steps and B rows, other order). The
5-step trajectory uses tests/test_train_trajectory_parity.py's limits: step
0 at rtol 1e-6 (one forward), later steps at 2e-3 (float32 noise amplified
through the clip's rescale). The optimizer against optax: rtol 1e-6
(elementwise f32 arithmetic in another order).
"""

import itertools
import os
import threading

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_separation_tpu.models import upit as jupit
from speech_separation_tpu.ops import pit as jpit
from speech_separation_tpu.train import data as jdata
from speech_separation_tpu.train.loop import (TrainLoopConfig as JaxLoopConfig,
                                              make_optimizer, make_update_step)
from speech_separation_tpu_torch.models import upit as tupit
from speech_separation_tpu_torch.models.registry import get_arch
from speech_separation_tpu_torch.ops import pit as tpit
from speech_separation_tpu_torch.train import data as tdata
from speech_separation_tpu_torch.train.loop import (Optimizer, TrainLoopConfig,
                                                    update_step)
from speech_separation_tpu_torch.utils.weights import (fold_lstm_biases,
                                                       state_dict_from_jax)

torch.set_num_threads(1)  # six xdist workers share the cores: one thread each, for life


# ---------------------------------------------------------------------- PIT

@pytest.mark.parametrize("S", [2, 3])
def test_pit_ops_match_jax(S):
    rng = np.random.default_rng(S)
    B, T, F = 5, 7, 6
    masked = rng.random((B, T, S, F)).astype(np.float32)
    sources = rng.random((B, S, T, F)).astype(np.float32)
    # row 0: two permutations tie exactly, the first one in itertools order wins
    masked[0] = 0.0
    sources[0] = 1.0
    np.testing.assert_array_equal(tpit.make_permutations(S),
                                  jpit.make_permutations(S))
    assert [tuple(p) for p in tpit.make_permutations(S)] == list(
        itertools.permutations(range(S)))
    pair = tpit.pairwise_mse(torch.from_numpy(masked), torch.from_numpy(sources))
    jpair = jpit.pairwise_mse(jnp.asarray(masked), jnp.asarray(sources))
    np.testing.assert_allclose(pair.numpy(), np.asarray(jpair), rtol=1e-6)
    mins, best = tpit.permutation_min_loss(pair, S)
    jmins, jbest = jpit.permutation_min_loss(jpair, S)
    np.testing.assert_allclose(mins.numpy(), np.asarray(jmins), rtol=1e-6)
    np.testing.assert_array_equal(best.numpy(), np.asarray(jbest))
    assert int(best[0]) == 0


# --------------------------------------------------------------------- loss

F, S, H, L = 9, 2, 6, 2


def _jax_model(seed=0, hidden=H):
    cfg = jupit.Config(feat_dim=F, num_spk=S, hidden=hidden, num_layers=L,
                       zero_init_hidden=True)
    params, state = jupit.init(jax.random.PRNGKey(seed), cfg)
    return cfg, params, state


def _port_model(params, state, hidden=H):
    cfg = tupit.Config(feat_dim=F, num_spk=S, hidden=hidden, num_layers=L,
                       zero_init_hidden=True)
    model = tupit.UPIT(cfg)
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params),
                             jax.tree_util.tree_map(np.asarray, state))
    model.load_state_dict(sd)
    fold_lstm_biases(model.blstm)
    return model


def _batch(seed=0, B=4, T=14, lengths=(14, 11, 5, 0)):
    """The last row is a dummy (row_mask 0, length 0), as make_device_batch
    pads a short batch."""
    rng = np.random.default_rng(seed)
    mix = np.abs(rng.standard_normal((B, T, F))).astype(np.float32)
    sources = np.abs(rng.standard_normal((B, S, T, F))).astype(np.float32)
    for b, n in enumerate(lengths):
        mix[b, n:] = 0.0
        sources[b, :, n:] = 0.0
    lengths = np.asarray(lengths, np.int32)
    row_mask = (lengths > 0).astype(np.float32)
    return {"mix": mix, "sources": sources, "lengths": lengths, "row_mask": row_mask}


def _grads_by_jax_name(model):
    """The port's gradients in the JAX package's pytree layout."""
    g = {n: p.grad for n, p in model.named_parameters()}
    blstm = []
    for li in range(L):
        layer = {}
        for direction, sfx in (("fwd", ""), ("bwd", "_reverse")):
            layer[direction] = {"w_ih": g[f"blstm.weight_ih_l{li}{sfx}"].t(),
                                "w_hh": g[f"blstm.weight_hh_l{li}{sfx}"].t(),
                                "b": g[f"blstm.bias_ih_l{li}{sfx}"]}
        blstm.append(layer)
    return {"blstm": blstm, "bn": {"gamma": g["bn.weight"], "beta": g["bn.bias"]},
            "lin": {"w": g["lin.weight"].t(), "b": g["lin.bias"]}}


def test_loss_and_every_gradient_match_jax():
    cfg, params, state = _jax_model()
    batch = _batch()
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jupit.loss_fn(cfg, p, state, jax.tree_util.tree_map(jnp.asarray, batch),
                                jax.random.PRNGKey(0), True), has_aux=True)(params)
    model = _port_model(params, state)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    arch = get_arch("upit")
    loss, aux = arch.loss_fn(model, tb, torch.Generator().manual_seed(0), True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in ("norm", "total"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(aux["best_perm"].numpy(), np.asarray(jaux["best_perm"]))
    np.testing.assert_allclose(aux["masked"].detach().numpy(), np.asarray(jaux["masked"]),
                               atol=1e-5)
    # BN ran in train mode: its running statistics moved as the JAX state did
    np.testing.assert_allclose(model.bn.running_mean.numpy(),
                               np.asarray(jaux["new_state"]["bn"]["mean"]), atol=1e-6)
    np.testing.assert_allclose(model.bn.running_var.numpy(),
                               np.asarray(jaux["new_state"]["bn"]["var"]), atol=1e-6)
    got = jax.tree_util.tree_leaves_with_path(_grads_by_jax_name(model))
    ref = dict(jax.tree_util.tree_leaves_with_path(jgrads))
    scale = max(float(np.abs(np.asarray(r)).max()) for r in ref.values())
    assert len(got) == len(ref) == 6 * L + 4
    for path, g in got:
        np.testing.assert_allclose(g.numpy(), np.asarray(ref[path]), atol=1e-5 * scale,
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------- optimizer

def test_optimizer_matches_optax_clip_adam_and_staircase():
    """Optimizer (clip by global norm with optax's rule, Adam, per-epoch
    staircase lr) against optax's chain over 7 updates whose gradients cross
    the clip threshold both ways."""
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,), (2, 2)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]
             for scale in (0.01, 1.0, 0.02, 3.0, 0.001, 0.5, 0.05)]
    cfg = TrainLoopConfig(lr_decay=0.5, grad_clip=0.25)
    params = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    opt = Optimizer(params, cfg, steps_per_epoch=3)
    jopt = make_optimizer(JaxLoopConfig(lr_decay=0.5, grad_clip=0.25), steps_per_epoch=3)
    jparams = [jnp.asarray(a) for a in init]
    jstate = jopt.init(jparams)
    schedule = optax.exponential_decay(1e-3, transition_steps=3, decay_rate=0.5,
                                       staircase=True)
    for k, gs in enumerate(grads):
        np.testing.assert_allclose(opt.lr(), float(schedule(k)), rtol=1e-6)
        for p, g in zip(params, gs):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
        updates, jstate = jopt.update([jnp.asarray(g) for g in gs], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, jp in zip(params, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-6,
                                       atol=1e-9)


def test_clip_is_optax_rule_not_clip_grad_norm():
    """Above the limit the gradient is scaled by max/norm exactly (torch's
    clip_grad_norm_ would use max/(norm + 1e-6)); below it, untouched."""
    for scale in (10.0, 0.01):
        g = torch.full((4,), scale)
        p = torch.nn.Parameter(torch.zeros(4))
        p.grad = g.clone()
        opt = Optimizer([p], TrainLoopConfig(grad_clip=0.25))
        norm = opt.clip()
        ref, _ = optax.clip_by_global_norm(0.25).update([jnp.asarray(g.numpy())], None)
        np.testing.assert_allclose(float(norm), float(torch.linalg.vector_norm(g)),
                                   rtol=1e-6)
        np.testing.assert_array_equal(p.grad.numpy(), np.asarray(ref[0]))


# --------------------------------------------------------------- trajectory

def test_five_step_trajectory_matches_jax_update_step():
    cfg, params, state = _jax_model()
    batch = _batch(seed=1)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    optimizer = make_optimizer(JaxLoopConfig())
    opt_state = optimizer.init(params)
    step = make_update_step(jupit, cfg, optimizer)

    model = _port_model(params, state)
    arch = get_arch("uPIT")
    opt = Optimizer(model.parameters(), TrainLoopConfig())
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(0)
    jl, tl = [], []
    for _ in range(5):
        params, state, opt_state, loss, _ = step(params, state, opt_state, jbatch,
                                                 jax.random.PRNGKey(1))
        jl.append(float(loss))
        loss, _ = update_step(arch, model, opt, tb, gen)
        tl.append(float(loss))
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-6)
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    assert tl[-1] < tl[0]
    # the weights after five updates: Adam moves each by about lr per step,
    # and the trajectories agree to a small part of one step (5e-5 of 1e-3)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              jax.tree_util.tree_map(np.asarray, state))
    for name, p in model.state_dict().items():
        if name == "bn.num_batches_tracked":
            continue
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), atol=5e-5, err_msg=name)


# --------------------------------------------------------------------- data

def _feature_dir(root, n=7, seed=0):
    rng = np.random.default_rng(seed)
    lines, frames = [], []
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        T = int(rng.integers(3, 30))
        utt = f"u{i:02d}"
        path = os.path.join(root, utt + ".npz")
        np.savez(path, mix=rng.random((5, T)).astype(np.float32),
                 s1=rng.random((5, T)).astype(np.float32),
                 s2=rng.random((5, T)).astype(np.float32))
        lines.append(f"{utt} {path}\n")
        frames.append(f"{utt} {T}\n")
    with open(os.path.join(root, "feats_train.scp"), "w") as f:
        f.writelines(lines)
    with open(os.path.join(root, "utt2num_frames"), "w") as f:
        f.writelines(frames)
    return root


@pytest.mark.parametrize("bucket", [False, True])
def test_batches_match_jax(tmp_path, bucket):
    d = _feature_dir(str(tmp_path / "feats"))
    jds = jdata.FeatureDataset(d, "train")
    tds = tdata.FeatureDataset(d)
    np.testing.assert_array_equal(tds.num_frames, jds.num_frames)
    jplan = jdata.BatchPlan(batch_size=3, time_pad_multiple=8, bucket_by_length=bucket,
                            seed=4)
    tplan = tdata.BatchPlan(batch_size=3, time_pad_multiple=8, bucket_by_length=bucket,
                            seed=4)
    for epoch in range(3):
        jb = jdata.plan_batches(jds, jplan, epoch, lengths=jds.num_frames)
        tb = tdata.plan_batches(tds, tplan, epoch, lengths=tds.num_frames)
        assert tb == jb
    for idxs in tb:
        ref = jdata.make_device_batch([jds.load(i) for i in idxs], jplan)
        got = tdata.make_device_batch([tds.load(i) for i in idxs], tplan)
        assert got["names"] == ref["names"]
        for k in ("mix", "sources", "lengths", "row_mask"):
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    streamed = list(tdata.iter_batches(tds, tplan, 2, transfer_fn=lambda b: b["names"]))
    assert streamed == [[tds.entries[i][0] for i in idxs] for idxs in tb]


def test_loader_errors_reach_the_consumer(tmp_path):
    d = _feature_dir(str(tmp_path / "feats"), n=4)
    os.remove(os.path.join(d, "u02.npz"))
    ds = tdata.FeatureDataset(d)
    with pytest.raises(FileNotFoundError):
        list(tdata.iter_batches(ds, tdata.BatchPlan(batch_size=2), 0,
                                transfer_fn=lambda b: b))


def test_first_batch_collates_before_the_model_is_built(tmp_path, monkeypatch):
    """train() starts its loader before it builds the model, so epoch 1's
    first batch collates (and, on a card, copies) while the model is built,
    moved and checkpointed: the model's constructor, held until a collation
    begins, finds one begun. The losses are those of the unhooked run."""
    from speech_separation_tpu_torch.train import loop
    d = _feature_dir(str(tmp_path / "feats"), n=4)
    cfg = TrainLoopConfig(batch_size=2, num_epochs=2, time_pad_multiple=8)
    kwargs = {"feat_dim": 5, "hidden": 8, "num_layers": 1}
    plain = loop.train(d, str(tmp_path / "plain"), cfg, model_kwargs=kwargs, device="cpu",
                       log=lambda m: None)

    collating = threading.Event()
    make_batch = tdata.make_device_batch

    def hooked_collate(samples, plan):
        collating.set()
        return make_batch(samples, plan)

    arch = get_arch("uPIT")
    model = arch.Model
    found = []

    def hooked_model(model_cfg):
        found.append(collating.wait(timeout=10.0))
        return model(model_cfg)

    monkeypatch.setattr(tdata, "make_device_batch", hooked_collate)
    monkeypatch.setattr(arch, "Model", hooked_model)
    res = loop.train(d, str(tmp_path / "hooked"), cfg, model_kwargs=kwargs, device="cpu",
                     log=lambda m: None)
    assert found == [True]
    assert res["epoch_losses"] == plain["epoch_losses"]
