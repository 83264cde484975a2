"""The port's LSTM training recurrence (speech_separation_tpu_torch/ops/
lstm_kernel.py: the training forward, the backward and the differentiable
``lstm_seq``) and the BLSTM training forward against the JAX package's
Pallas kernels in interpret mode, on the CPU, with the same numpy inputs.

Tolerances: with f32 saves atol 2e-5 (the same f32 math, other summation
order); with bf16 saves 2e-2 (a value on the other side of a bf16 rounding
boundary moves by one bf16 step, ~4e-3 relative, and the step carries it
on), as tests/test_lstm_pallas.py holds the Pallas kernels to their scan
reference. Gradients are compared divided by max(1, max |reference|).
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_separation_tpu.models.blstm import blstm_forward
from speech_separation_tpu.models import upit as jupit
from speech_separation_tpu.ops import lstm_pallas
from speech_separation_tpu_torch.models import blstm as tblstm
from speech_separation_tpu_torch.models import upit as tupit
from speech_separation_tpu_torch.ops.lstm_kernel import (lstm_seq, lstm_seq_bwd_plain,
                                                         lstm_seq_fwd_plain,
                                                         lstm_seq_infer_plain)
from speech_separation_tpu_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(1)  # six xdist workers share the cores: one thread each, for life

SFX = (False, True)
# (weight dtype, save dtype, tolerance): f32 saves are exact up to summation
# order; bf16 saves round every saved value (see the module docstring)
CASES = [("float32", "float32", 2e-5), ("float32", "bfloat16", 2e-2),
         ("bfloat16", "bfloat16", 2e-2)]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(T=11, B=5, H=8, seed=0):
    rng = np.random.default_rng(seed)
    G = 4 * H
    xw = (0.5 * rng.standard_normal((T, 2, B, G))).astype(np.float32)
    w = (0.3 * rng.standard_normal((2, H, G))).astype(np.float32)
    h0 = rng.standard_normal((2, B, H)).astype(np.float32)
    c0 = rng.standard_normal((2, B, H)).astype(np.float32)
    lengths = np.asarray([T, 1, 6, T - 2, 3][:B], np.int32)
    return xw, w, h0, c0, lengths


def _jax(a, dt=None):
    a = jnp.asarray(a)
    return a.astype(dt) if dt is not None else a


def _torch(a, dt=None):
    t = torch.from_numpy(np.array(a, np.float32))
    return t.to(dt) if dt is not None else t


def _close(got, ref, tol, name):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got / scale, ref / scale, atol=tol, err_msg=name)


@pytest.mark.parametrize("wdt,sdt,tol", CASES)
def test_training_forward_matches_pallas(wdt, sdt, tol):
    xw, w, h0, c0, lengths = _inputs()
    ref = lstm_pallas.lstm_seq_fwd(_jax(xw, JDT[wdt]), _jax(w, JDT[wdt]), _jax(h0),
                                   _jax(c0), _jax(lengths), interpret=True,
                                   save_dtype=JDT[sdt], suffix_dirs=SFX)
    got = lstm_seq_fwd_plain(_torch(xw, TDT[wdt]), _torch(w, TDT[wdt]), _torch(h0),
                             _torch(c0), torch.from_numpy(lengths), TDT[sdt], SFX)
    for name, g, r in zip(("ys", "cs", "gates", "h_last", "c_last"), got, ref):
        assert g.dtype == (TDT[sdt] if name in ("ys", "cs", "gates") else torch.float32)
        _close(g, r.astype(jnp.float32), tol, name)


@pytest.mark.parametrize("wdt,sdt,tol", CASES)
def test_backward_matches_pallas(wdt, sdt, tol):
    """Both backwards on the same saved inputs (the JAX forward's) and the
    same cotangents."""
    xw, w, h0, c0, lengths = _inputs(seed=1)
    ys, cs, gates, _, _ = lstm_pallas.lstm_seq_fwd(
        _jax(xw, JDT[wdt]), _jax(w, JDT[wdt]), _jax(h0), _jax(c0), _jax(lengths),
        interpret=True, save_dtype=JDT[sdt], suffix_dirs=SFX)
    rng = np.random.default_rng(2)
    dys = rng.standard_normal(ys.shape).astype(np.float32)
    dh_last = rng.standard_normal(h0.shape).astype(np.float32)
    dc_last = rng.standard_normal(c0.shape).astype(np.float32)
    ref = lstm_pallas.lstm_seq_bwd(_jax(w, JDT[wdt]), _jax(c0), _jax(lengths), cs, gates,
                                   _jax(dys, JDT[sdt]), _jax(dh_last), _jax(dc_last),
                                   interpret=True, save_dtype=JDT[sdt], suffix_dirs=SFX)
    f32 = lambda a: _torch(np.asarray(a.astype(jnp.float32)), TDT[sdt])
    got = lstm_seq_bwd_plain(_torch(w, TDT[wdt]), _torch(c0), torch.from_numpy(lengths),
                             f32(cs), f32(gates), _torch(dys, TDT[sdt]), _torch(dh_last),
                             _torch(dc_last), TDT[sdt], SFX)
    assert got[0].dtype == TDT[sdt]
    for name, g, r in zip(("dxw", "dh0", "dc0"), got, ref):
        _close(g, r.astype(jnp.float32), tol, name)


def _loss_jax(save_dtype, lengths, xw, w, h0, c0):
    ys, h_last, c_last = lstm_pallas.lstm_seq(xw, w, h0, c0, lengths, save_dtype, SFX)
    return (jnp.sum(ys.astype(jnp.float32) ** 2) + jnp.sum(jnp.sin(h_last))
            + jnp.sum(c_last ** 2) * 0.1)


@pytest.mark.parametrize("wdt,sdt,tol", CASES)
def test_lstm_seq_gradients_match_jax_vjp(wdt, sdt, tol):
    """lstm_seq's gradients on the CPU (plain forward and backward) against
    jax.vjp of the Pallas lstm_seq in interpret mode, as
    tests/test_lstm_pallas.py scales them; dxw is exactly zero at masked
    steps."""
    xw, w, h0, c0, lengths = _inputs(seed=3)
    jl = jnp.asarray(lengths)
    args = (_jax(xw, JDT[wdt]), _jax(w, JDT[wdt]), _jax(h0), _jax(c0))
    ref_loss, ref = jax.value_and_grad(partial(_loss_jax, JDT[sdt], jl),
                                       argnums=(0, 1, 2, 3))(*args)
    ts = [_torch(xw, TDT[wdt]), _torch(w, TDT[wdt]), _torch(h0), _torch(c0)]
    for t in ts:
        t.requires_grad_(True)
    ys, h_last, c_last = lstm_seq(*ts, torch.from_numpy(lengths), TDT[sdt], SFX)
    loss = (torch.sum(ys.float() ** 2) + torch.sum(torch.sin(h_last))
            + torch.sum(c_last ** 2) * 0.1)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss),
                               rtol=1e-5 if sdt == "float32" else 2e-3)
    for name, t, r in zip(("dxw", "dw_hh", "dh0", "dc0"), ts, ref):
        assert t.grad.dtype == t.dtype, name
        _close(t.grad, r.astype(jnp.float32), tol, name)
    dxw = ts[0].grad.float().numpy()
    T = xw.shape[0]
    for b, L in enumerate(lengths):
        assert np.all(dxw[L:, 0, b] == 0.0), f"forward direction, row {b}"
        assert np.all(dxw[:T - L, 1, b] == 0.0), f"suffix direction, row {b}"


def test_unused_outputs_count_as_zero_cotangents():
    """Only ys feeds the loss: h_last's and c_last's cotangents are zeros,
    as the plain forward's autograd sees them."""
    xw, w, h0, c0, lengths = _inputs(seed=4)
    lens = torch.from_numpy(lengths)
    got = [_torch(a).requires_grad_(True) for a in (xw, w, h0, c0)]
    ys, _, _ = lstm_seq(*got, lens, torch.float32, SFX)
    (ys ** 2).sum().backward()
    ref = [_torch(a).requires_grad_(True) for a in (xw, w, h0, c0)]
    ys_r, _, _, _, _ = lstm_seq_fwd_plain(*ref, lens, torch.float32, SFX)
    (ys_r ** 2).sum().backward()
    for name, g, r in zip(("dxw", "dw_hh", "dh0", "dc0"), got, ref):
        _close(g.grad, r.grad.numpy(), 2e-5, name)


def test_inference_plain_is_the_training_forward():
    xw, w, h0, c0, lengths = _inputs(seed=5)
    args = [_torch(a) for a in (xw, w, h0, c0)] + [torch.from_numpy(lengths)]
    ys, h, c = lstm_seq_infer_plain(*args, SFX)
    ys_t, _, _, h_t, c_t = lstm_seq_fwd_plain(*args, torch.float32, SFX)
    for a, b in ((ys, ys_t), (h, h_t), (c, c_t)):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ BLSTM

F, H, L = 12, 8, 2


def _blstm_pair(seed=0):
    cfg = jupit.Config(feat_dim=F, num_spk=2, hidden=H, num_layers=L)
    params, state = jupit.init(jax.random.PRNGKey(seed), cfg)
    params_np = jax.tree_util.tree_map(np.asarray, params)
    state_np = jax.tree_util.tree_map(np.asarray, state)
    sd = state_dict_from_jax(params_np, state_np)
    m = tblstm.BLSTM(F, H, L)
    m.load_state_dict({k[len("blstm."):]: v for k, v in sd.items() if k.startswith("blstm.")})
    return params_np["blstm"], m


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_blstm_training_forward_and_gradients_match_jax(dtype, tol):
    """The port's BLSTM with grad (lstm_seq) against blstm_forward with
    use_pallas=True and save_activations=True (the Pallas training kernels,
    interpret mode): outputs, final states and every weight's gradient."""
    jparams, m = _blstm_pair()
    rng = np.random.default_rng(6)
    B, T = 4, 10
    lengths = np.asarray([T, 7, 1, 4], np.int32)
    x = np.abs(rng.standard_normal((B, T, F))).astype(np.float32)
    x *= np.arange(T)[None, :, None] < lengths[:, None, None]
    h0 = rng.standard_normal((L, 2, B, H)).astype(np.float32)
    c0 = rng.standard_normal((L, 2, B, H)).astype(np.float32)
    cot = rng.standard_normal((B, T, 2 * H)).astype(np.float32)

    def jloss(p):
        out, (h_n, c_n) = blstm_forward(p, jnp.asarray(x), jnp.asarray(lengths),
                                        jnp.asarray(h0), jnp.asarray(c0),
                                        compute_dtype=JDT[dtype], use_pallas=True,
                                        save_activations=True)
        return jnp.sum(out.astype(jnp.float32) * cot) + jnp.sum(h_n * c_n), (out, h_n, c_n)

    (_, (ref, h_ref, c_ref)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, jparams))
    out, (h_n, c_n) = m(torch.from_numpy(x), torch.from_numpy(lengths),
                        torch.from_numpy(h0), torch.from_numpy(c0), TDT[dtype])
    # the training path's layer output is in the compute dtype, as on the TPU
    assert out.dtype == TDT[dtype] and ref.dtype == JDT[dtype]
    (torch.sum(out.float() * torch.from_numpy(cot)) + torch.sum(h_n * c_n)).backward()
    _close(out, ref.astype(jnp.float32), tol, "out")
    _close(h_n, h_ref, tol, "h_n")
    _close(c_n, c_ref, tol, "c_n")
    for li in range(L):
        for direction, sfx in (("fwd", ""), ("bwd", "_reverse")):
            g = jgrads[li][direction]
            got = {n: getattr(m, f"{n}_l{li}{sfx}").grad for n in
                   ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
            _close(got["weight_ih"].t(), g["w_ih"], tol, f"w_ih l{li}{sfx}")
            _close(got["weight_hh"].t(), g["w_hh"], tol, f"w_hh l{li}{sfx}")
            # the two torch biases both receive the gradient of JAX's one b
            _close(got["bias_ih"], g["b"], tol, f"b l{li}{sfx}")
            assert torch.equal(got["bias_ih"], got["bias_hh"])


def test_training_forward_does_not_use_the_inference_kernel(monkeypatch):
    """With grad on, the BLSTM must not go through lstm_seq_infer (whose
    kernel records no graph): with it made to raise, a uPIT training
    forward and backward still run, and every BLSTM parameter gets a
    nonzero gradient."""
    def refuse(*a, **k):
        raise AssertionError("lstm_seq_infer called")
    monkeypatch.setattr(tblstm, "lstm_seq_infer", refuse)
    cfg = tupit.Config(feat_dim=F, num_spk=2, hidden=H, num_layers=L)
    model = tupit.UPIT(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    B, T = 3, 9
    lengths = torch.tensor([T, 5, 2], dtype=torch.int32)
    mix = torch.from_numpy(np.abs(rng.standard_normal((B, T, F))).astype(np.float32))
    batch = {"mix": mix * (torch.arange(T)[None, :, None] < lengths[:, None, None]),
             "sources": torch.from_numpy(np.abs(rng.standard_normal((B, 2, T, F)))
                                         .astype(np.float32)),
             "lengths": lengths, "row_mask": torch.ones(B)}
    loss, _ = tupit.loss_fn(model, batch, torch.Generator().manual_seed(1), True)
    loss.backward()
    for name, p in model.blstm.named_parameters():
        assert p.grad is not None and float(p.grad.abs().max()) > 0, name
    # without grad the inference kernel is the one that runs
    with torch.no_grad(), pytest.raises(AssertionError, match="lstm_seq_infer called"):
        tupit.loss_fn(model, batch, torch.Generator().manual_seed(1), False)
