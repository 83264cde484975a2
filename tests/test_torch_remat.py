"""``remat`` on the port's uPIT and RSH (speech_separation_tpu_torch/models):
a step with the forward recomputed in the backward (torch.utils.checkpoint)
against the same step without, and against the JAX package's remat step
(``jax.checkpoint``), on the CPU with the same weights
(utils/weights.state_dict_from_jax) and the same numpy inputs.

What remat must not change: the loss, every gradient and BN's running
statistics, which the recomputed forward would otherwise update a second
time (ops/batchnorm.remat_checkpoint keeps them out of the recompute).

Tolerances: remat against no remat rtol 1e-6 (the same arithmetic,
recomputed; BN's running statistics and its count exactly). Against the JAX
package, the port's step tolerances of tests/test_torch_train.py and
tests/test_torch_rsh.py: losses rtol 1e-5 (the same f32 sums in another
order), gradients atol 1e-5 of the largest reference gradient, BN's running
statistics atol 1e-6 (uPIT, one update) and 2e-5 (RSH, one update a pass).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_separation_tpu.models import rsh as jrsh
from speech_separation_tpu.models import upit as jupit
from speech_separation_tpu_torch.models import rsh as trsh
from speech_separation_tpu_torch.models import upit as tupit
from speech_separation_tpu_torch.utils.weights import fold_lstm_biases, state_dict_from_jax

torch.set_num_threads(1)  # six xdist workers share the cores: one thread each, for life

F, H, L = 9, 6, 2


ARCHS = {"uPIT": (jupit, tupit, {"num_spk": 2}), "RSH": (jrsh, trsh, {})}


def _pair(name, remat, seed=0):
    """The JAX (cfg, params, state) with non-trivial BN statistics, and the
    port's model with the same weights."""
    jmod, tmod, extra = ARCHS[name]
    kw = dict(feat_dim=F, hidden=H, num_layers=L, zero_init_hidden=True, remat=remat, **extra)
    cfg = jmod.Config(**kw)
    params, state = jmod.init(jax.random.PRNGKey(seed), cfg)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    rng = np.random.default_rng(seed)
    state["bn"]["mean"] = (0.1 * rng.standard_normal(2 * H)).astype(np.float32)
    state["bn"]["var"] = (0.5 + rng.random(2 * H)).astype(np.float32)
    model = tmod.Model(tmod.Config(**kw))
    model.load_state_dict(state_dict_from_jax(params, state))
    fold_lstm_biases(model.blstm)
    return cfg, params, state, model


def _batch(S, seed=0, B=4, T=12, lengths=(12, 9, 3, 0)):
    """A ragged batch; the last row a dummy (row_mask 0, length 0)."""
    rng = np.random.default_rng(seed)
    mix = np.abs(rng.standard_normal((B, T, F))).astype(np.float32)
    sources = np.abs(rng.standard_normal((B, S, T, F))).astype(np.float32)
    for b, n in enumerate(lengths):
        mix[b, n:] = 0.0
        sources[b, :, n:] = 0.0
    lengths = np.asarray(lengths, np.int32)
    return {"mix": mix, "sources": sources, "lengths": lengths,
            "row_mask": (lengths > 0).astype(np.float32)}


def _port_step(model, tmod, batch):
    loss, aux = tmod.loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()},
                             torch.Generator().manual_seed(0), True)
    loss.backward()
    bn = {k: getattr(model.bn, k).clone()
          for k in ("running_mean", "running_var", "num_batches_tracked")}
    return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()
                         if p.grad is not None}, bn


def _grads_by_jax_name(grads):
    blstm = [{direction: {"w_ih": grads[f"blstm.weight_ih_l{li}{sfx}"].t(),
                          "w_hh": grads[f"blstm.weight_hh_l{li}{sfx}"].t(),
                          "b": grads[f"blstm.bias_ih_l{li}{sfx}"]}
              for direction, sfx in (("fwd", ""), ("bwd", "_reverse"))} for li in range(L)]
    return {"blstm": blstm, "bn": {"gamma": grads["bn.weight"], "beta": grads["bn.bias"]},
            "lin": {"w": grads["lin.weight"].t(), "b": grads["lin.bias"]}}


CASES = [("uPIT", 2), ("RSH", 2), ("RSH", 3)]


@pytest.mark.parametrize("name,S", CASES)
def test_remat_step_equals_plain_step(name, S):
    batch = _batch(S, seed=S)
    tmod = ARCHS[name][1]
    plain = _port_step(_pair(name, False)[3], tmod, batch)
    remat = _port_step(_pair(name, True)[3], tmod, batch)
    np.testing.assert_allclose(remat[0], plain[0], rtol=1e-6)
    assert set(remat[1]) == set(plain[1]) and len(plain[1]) == 6 * L + 4
    for n, g in plain[1].items():
        np.testing.assert_allclose(remat[1][n].numpy(), g.numpy(), rtol=1e-6, atol=1e-12,
                                   err_msg=n)
    # one BN update a forward (uPIT) or a pass (RSH), not a second one in the
    # recompute
    for k, v in plain[2].items():
        np.testing.assert_array_equal(remat[2][k].numpy(), v.numpy(), err_msg=k)
    assert int(remat[2]["num_batches_tracked"]) == 1 + (S if name == "RSH" else 1)


@pytest.mark.parametrize("name,S", CASES)
def test_remat_step_matches_jax_remat_step(name, S):
    jmod, tmod, _ = ARCHS[name]
    cfg, params, state, model = _pair(name, True)
    assert cfg.remat and model.cfg.remat
    batch = _batch(S, seed=S + 10)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jmod.loss_fn(cfg, p, jax.tree_util.tree_map(jnp.asarray, state), jb,
                               jax.random.PRNGKey(0), True), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    loss, grads, bn = _port_step(model, tmod, batch)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    bn_tol = 1e-6 if name == "uPIT" else 2e-5
    np.testing.assert_allclose(bn["running_mean"].numpy(),
                               np.asarray(jaux["new_state"]["bn"]["mean"]), atol=bn_tol)
    np.testing.assert_allclose(bn["running_var"].numpy(),
                               np.asarray(jaux["new_state"]["bn"]["var"]), atol=bn_tol)
    got = jax.tree_util.tree_leaves_with_path(_grads_by_jax_name(grads))
    ref = dict(jax.tree_util.tree_leaves_with_path(jgrads))
    scale = max(float(np.abs(np.asarray(r)).max()) for r in ref.values())
    assert len(got) == len(ref) == 6 * L + 4
    for path, g in got:
        np.testing.assert_allclose(g.numpy(), np.asarray(ref[path]), atol=1e-5 * scale,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", ["uPIT", "RSH"])
def test_remat_from_model_config_strings(name):
    tmod = ARCHS[name][1]
    assert tmod.Config.from_kwargs(remat="1").remat is True
    assert tmod.Config.from_kwargs(remat="0").remat is False
    assert tmod.Config.from_kwargs().remat is False


@pytest.mark.parametrize("name", ["uPIT", "RSH"])
def test_remat_without_grad_is_the_plain_cv_loss(name):
    """CV runs without grad: remat changes nothing there, and BN's running
    statistics stay as they are (eval mode)."""
    tmod = ARCHS[name][1]
    batch = {k: torch.from_numpy(v) for k, v in _batch(2, seed=7).items()}
    out = []
    for remat in (False, True):
        model = _pair(name, remat)[3]
        before = model.bn.running_mean.clone()
        with torch.no_grad():
            loss, _ = tmod.loss_fn(model, batch, torch.Generator().manual_seed(0), False)
        np.testing.assert_array_equal(model.bn.running_mean.numpy(), before.numpy())
        out.append(loss.item())
    assert out[0] == out[1]
