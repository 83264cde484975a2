"""The port's BLSTM and uPIT (speech_separation_tpu_torch/models) against
the JAX package on the CPU, with the same weights (carried by
utils/weights.state_dict_from_jax) and the same numpy inputs and states.

Tolerances: f32 atol 2e-5 on BLSTM outputs (the same f32 math, other
summation order). bf16: the gate inputs and h_{t-1} are rounded to bf16, so
an f32 sum on the other side of a rounding boundary moves a value by one
bf16 step (~4e-3 relative); atol 2e-2 on BLSTM outputs and 1e-2 on masks.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_separation_tpu.models import upit as jupit
from speech_separation_tpu.models.blstm import blstm_forward
from speech_separation_tpu_torch.models import upit as tupit
from speech_separation_tpu_torch.models.blstm import BLSTM, random_hidden
from speech_separation_tpu_torch.models.registry import get_arch
from speech_separation_tpu_torch.utils.weights import (infer_model_info,
                                                       state_dict_from_jax)

torch.set_num_threads(1)  # six xdist workers share the cores: one thread each, for life

F, H, L = 20, 16, 2


def _jax_model(num_layers=L, hidden=H, feat_dim=F, seed=0, zero=True):
    cfg = jupit.Config(feat_dim=feat_dim, num_spk=2, hidden=hidden,
                       num_layers=num_layers, zero_init_hidden=zero)
    params, state = jupit.init(jax.random.PRNGKey(seed), cfg)
    params_np = jax.tree_util.tree_map(np.asarray, params)
    state_np = jax.tree_util.tree_map(np.asarray, state)
    # non-trivial BN statistics, so eval mode is really tested
    rng = np.random.default_rng(seed)
    state_np["bn"]["mean"] = (0.1 * rng.standard_normal(2 * hidden)).astype(np.float32)
    state_np["bn"]["var"] = (0.5 + rng.random(2 * hidden)).astype(np.float32)
    return cfg, params_np, state_np


def _batch(B=3, T=12, seed=1):
    rng = np.random.default_rng(seed)
    lengths = np.asarray([T, 7, 1][:B], np.int32)
    x = np.abs(rng.standard_normal((B, T, F))).astype(np.float32)
    x *= (np.arange(T)[None, :, None] < lengths[:, None, None])
    return x, lengths


def _port_blstm(params_np, state_np, num_layers=L):
    sd = state_dict_from_jax(params_np, state_np)
    m = BLSTM(F, H, num_layers)
    m.load_state_dict({k[len("blstm."):]: v for k, v in sd.items()
                       if k.startswith("blstm.")})
    return m


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_blstm_matches_jax(dtype, tol):
    _, params_np, state_np = _jax_model()
    x, lengths = _batch()
    B = x.shape[0]
    rng = np.random.default_rng(5)
    h0 = rng.standard_normal((L, 2, B, H)).astype(np.float32)
    c0 = rng.standard_normal((L, 2, B, H)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    # bf16: the TPU serving kernel (interpret mode); f32: the lax.scan path
    ref, (h_ref, c_ref) = blstm_forward(
        jax.tree_util.tree_map(jnp.asarray, params_np["blstm"]), jnp.asarray(x),
        jnp.asarray(lengths), jnp.asarray(h0), jnp.asarray(c0), compute_dtype=jdt,
        use_pallas=dtype == "bfloat16", save_activations=False)
    m = _port_blstm(params_np, state_np)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    with torch.inference_mode():
        out, (h_n, c_n) = m(torch.from_numpy(x), torch.from_numpy(lengths),
                            torch.from_numpy(h0), torch.from_numpy(c0), tdt)
    assert out.shape == (B, x.shape[1], 2 * H)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=tol)
    np.testing.assert_allclose(h_n.numpy(), np.asarray(h_ref), atol=tol)
    np.testing.assert_allclose(c_n.numpy(), np.asarray(c_ref), atol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 1e-2)])
def test_upit_infer_masks_matches_jax(dtype, tol):
    cfg, params_np, state_np = _jax_model()
    cfg = jupit.Config(**{**cfg.__dict__, "compute_dtype": dtype})
    x, lengths = _batch()
    row_mask = np.ones((x.shape[0],), np.float32)
    batch = {"mix": jnp.asarray(x), "lengths": jnp.asarray(lengths),
             "row_mask": jnp.asarray(row_mask)}
    ref = jupit.infer_masks(cfg, jax.tree_util.tree_map(jnp.asarray, params_np),
                            jax.tree_util.tree_map(jnp.asarray, state_np), batch,
                            jax.random.PRNGKey(0))

    sd = state_dict_from_jax(params_np, state_np)
    info = infer_model_info(sd)
    assert info == {"arch": "uPIT", "feat_dim": F, "num_spk": 2, "hidden": H,
                    "num_layers": L}
    tcfg = tupit.Config.from_kwargs(feat_dim=str(F), hidden=str(H), num_layers=str(L),
                                    zero_init_hidden="1", compute_dtype=dtype)
    model = tupit.UPIT(tcfg)
    model.load_state_dict(sd)
    got = tupit.infer_masks(model.eval(),
                            {"mix": torch.from_numpy(x),
                             "lengths": torch.from_numpy(lengths),
                             "row_mask": torch.from_numpy(row_mask)},
                            torch.Generator().manual_seed(0))
    assert got.shape == (x.shape[0], x.shape[1], 2 * F)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol)


def test_state_dict_keys_match_reference_mdl():
    """The port's parameter names are those of the reference .mdl that the
    JAX package exports."""
    from speech_separation_tpu.utils.import_torch import state_dict_from_params
    _, params_np, state_np = _jax_model(num_layers=1)
    ref = state_dict_from_params(params_np, state_np)
    model = tupit.UPIT(tupit.Config(feat_dim=F, hidden=H, num_layers=1))
    assert set(model.state_dict()) == set(ref)
    sd = state_dict_from_jax(params_np, state_np)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("train", [False, True])
def test_batchnorm_matches_jax(train):
    """Padded statistics over real rows (a dummy row excluded), the
    running-statistics update in train mode, running statistics in eval."""
    from speech_separation_tpu.ops.batchnorm import batchnorm_apply as jbn
    from speech_separation_tpu_torch.ops.batchnorm import BatchNorm
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 5, 6)).astype(np.float32)
    row_mask = np.asarray([1.0, 1.0, 0.0], np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(6)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(6)).astype(np.float32)
    mean = (0.1 * rng.standard_normal(6)).astype(np.float32)
    var = (0.5 + rng.random(6)).astype(np.float32)
    y_ref, st_ref = jbn({"gamma": jnp.asarray(gamma), "beta": jnp.asarray(beta)},
                        {"mean": jnp.asarray(mean), "var": jnp.asarray(var)},
                        jnp.asarray(x), jnp.asarray(row_mask), train)
    bn = BatchNorm(6)
    bn.load_state_dict({"weight": torch.from_numpy(gamma), "bias": torch.from_numpy(beta),
                        "running_mean": torch.from_numpy(mean),
                        "running_var": torch.from_numpy(var),
                        "num_batches_tracked": torch.tensor(0)})
    y = bn(torch.from_numpy(x), torch.from_numpy(row_mask), train=train)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), atol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(st_ref["mean"]), atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(st_ref["var"]), atol=1e-6)
    assert int(bn.num_batches_tracked) == int(train)


def test_random_hidden_is_seeded_normal():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    h1, c1 = random_hidden(g1, 2, 4, 8)
    h2, c2 = random_hidden(g2, 2, 4, 8)
    assert h1.shape == (2, 2, 4, 8) and c1.shape == (2, 2, 4, 8)
    assert torch.equal(h1, h2) and torch.equal(c1, c2)
    assert not torch.equal(h1, c1)


def test_registry_knows_upit_only():
    """uPIT resolves by any case; so do the other five archs, all ported
    (TCN and Conv-TasNet since their slice); a name of no arch raises."""
    from speech_separation_tpu_torch.models import convtasnet, dprnn, rsh, tcn
    assert get_arch("upit") is tupit
    assert get_arch("rsh") is rsh and get_arch("DPRNN") is dprnn
    assert get_arch("TCN") is tcn and get_arch("convtasnet") is convtasnet
    with pytest.raises(NotImplementedError, match="unknown architecture"):
        get_arch("NoSuchArch")


def test_config_from_kwargs_coerces_strings():
    cfg = tupit.Config.from_kwargs(hidden="32", zero_init_hidden="true",
                                   compute_dtype="bfloat16", remat="1")
    assert cfg.hidden == 32 and cfg.zero_init_hidden
    assert cfg.torch_dtype == torch.bfloat16
