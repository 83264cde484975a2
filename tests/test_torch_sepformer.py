"""The port's SepFormer (speech_separation_tpu_torch/models/sepformer.py)
against the JAX package's on the CPU, at tests/test_sepformer.py's TINY
widths, with the same weights (utils/weights.pytree_state_dict_from_jax)
and the same numpy waveforms.

The JAX side runs its einsum path (fused_attention=False):
tests/test_sepformer_fused_attention.py ties the JAX fused path to it within
1e-5, and the fused path in interpret mode is too slow for Tier-1. The port
runs both of its paths, the einsum one and the fused one (K5's plain
versions under its VJP rule on the CPU). Tolerances, float32: separated
waveforms and the loss rtol 1e-5 (the same f32 arithmetic summed in another
order); every gradient atol 1e-5 + 1e-4 * max |g|, the limit the JAX package
sets between its own two paths.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_separation_tpu.models import sepformer as jsf
from speech_separation_tpu_torch.models import sepformer as tsf
from speech_separation_tpu_torch.models.registry import get_arch
from speech_separation_tpu_torch.utils.weights import pytree_state_dict_from_jax

torch.set_num_threads(1)  # six xdist workers share the cores: one thread each, for life

TINY = dict(n_filters=16, filter_len=16, stride=8, channels=16, heads=2,
            d_ff=24, chunk=8, blocks=2)
LENGTHS = (400, 333, 200)


def _wav_batch(B=3, S=2, L=400, lengths=LENGTHS, seed=0):
    rng = np.random.default_rng(seed)
    srcs = rng.standard_normal((B, S, L)).astype(np.float32) * 0.1
    for b, n in enumerate(lengths):
        srcs[b, :, n:] = 0.0
    return {"mix_wav": srcs.sum(axis=1), "source_wavs": srcs,
            "sample_lengths": np.asarray(lengths, np.int32),
            "row_mask": np.ones((B,), np.float32)}


@functools.lru_cache(maxsize=1)
def _jax_reference():
    """JAX SepFormer at TINY (einsum path): params, separated waveforms,
    loss and gradients, all as numpy."""
    cfg = jsf.Config(num_spk=2, **TINY)
    params, state = jax.jit(jsf.init, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    jb = {k: jnp.asarray(v) for k, v in _wav_batch().items()}
    sep = jax.jit(lambda p: jsf.separate(cfg, p, state, jb["mix_wav"],
                                         jb["sample_lengths"]))(params)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jsf.loss_fn(cfg, p, state, jb, jax.random.PRNGKey(1), True)[0]))(params)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return to_np(params), np.asarray(sep), float(loss), to_np(grads)


def _port_model(fused: bool, dtype: str = "float32", **extra):
    params, _, _, _ = _jax_reference()
    cfg = tsf.Config(num_spk=2, fused_attention=fused, compute_dtype=dtype, **TINY, **extra)
    model = tsf.SepFormer(cfg)
    model.load_state_dict(pytree_state_dict_from_jax(params), strict=True)
    return model


def _port_batch():
    return {k: torch.from_numpy(v) for k, v in _wav_batch().items()}


@pytest.mark.parametrize("fused", [False, True])
def test_separate_loss_and_gradients_match_jax(fused):
    _, want_sep, want_loss, want_grads = _jax_reference()
    model = _port_model(fused)
    b = _port_batch()
    sep = tsf.separate(model, b["mix_wav"], b["sample_lengths"])
    np.testing.assert_allclose(sep.numpy(), want_sep, rtol=1e-5, atol=1e-6)

    loss, aux = tsf.loss_fn(model, b, None, True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    assert float(aux["norm"]) == 3.0
    want = pytree_state_dict_from_jax(want_grads)
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    for name, p in got.items():
        g = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, atol=1e-5 + 1e-4 * np.abs(g).max(),
                                   err_msg=name)


def test_parameter_names_and_layout_mirror_the_jax_pytree():
    params, _, _, _ = _jax_reference()
    sd = pytree_state_dict_from_jax(params)
    model = tsf.SepFormer(tsf.Config(num_spk=2, **TINY))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: tuple(v.shape) for k, v in sd.items()}
    assert tuple(sd["blocks.1.inter.qkv.w"].shape) == (16, 48)      # (in, out)


def test_config_registry_and_init():
    cfg = tsf.Config.from_kwargs(channels="32", heads="4", chunk="50", fused_attention="1",
                                 compute_dtype="bfloat16", bogus="dropped")
    assert cfg.channels == 32 and cfg.hop == 25 and cfg.fused_attention is True
    assert cfg.torch_dtype == torch.bfloat16
    assert tsf.Config.from_kwargs(fused_attention="0").fused_attention is False
    jfields = {f: getattr(jsf.Config(), f) for f in jsf.Config.__dataclass_fields__}
    tfields = {f: getattr(tsf.Config(), f) for f in tsf.Config.__dataclass_fields__}
    # the port's keys of the published structure, at the defaults that give
    # the JAX package's compact model
    assert tfields == {**jfields, "published": False, "layers": 1}
    for bad in (dict(channels=30, heads=4), dict(chunk=7), dict(mask_act="tanh"),
                dict(stride=32)):
        with pytest.raises(ValueError):
            tsf.Config(**bad)
    arch = get_arch("sepformer")
    assert arch is tsf and arch.DOMAIN == "time" and get_arch("uPIT").DOMAIN == "spectrum"
    cfg = tsf.Config(num_spk=2, **TINY)
    a, b = arch.Model(cfg), arch.Model(cfg)
    a.reset_parameters(torch.Generator().manual_seed(3))
    b.reset_parameters(torch.Generator().manual_seed(3))
    for (n, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), n
    assert a.blocks[0]["intra"]["qkv"]["w"].abs().max().item() <= 1 / np.sqrt(16)
    assert torch.equal(a.in_ln["g"], torch.ones(16)) and a.head_prelu[0].item() == 0.25


def test_bf16_fused_path_matches_the_einsum_path():
    """The two attention paths of the port in bf16 (K5's plain versions on
    the CPU): loss within 1e-3 relative and gradients within 5e-2 of the
    largest, a few bf16 roundings apart."""
    b = _port_batch()
    out = {}
    for fused in (False, True):
        model = _port_model(fused, "bfloat16")
        loss, _ = tsf.loss_fn(model, b, None, True)
        loss.backward()
        out[fused] = (loss.item(), {n: p.grad for n, p in model.named_parameters()})
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-3)
    for n, g in out[False][1].items():
        tol = 5e-2 * float(g.abs().max()) + 1e-6
        np.testing.assert_allclose(out[True][1][n].numpy(), g.numpy(), atol=tol, err_msg=n)


def test_remat_gives_the_same_loss_and_gradients():
    b = _port_batch()
    res = []
    for remat in (False, True):
        model = _port_model(True, remat=remat)
        loss, _ = tsf.loss_fn(model, b, None, True)
        loss.backward()
        res.append((loss.item(), [p.grad.clone() for p in model.parameters()]))
    assert res[0][0] == res[1][0]
    for a, g in zip(res[0][1], res[1][1]):
        torch.testing.assert_close(a, g, rtol=0, atol=1e-7)


def test_padding_invariance():
    """An utterance's separated samples do not depend on the batch and time
    padding it shares a batch with."""
    model = _port_model(True)
    rng = np.random.default_rng(1)
    sig = torch.from_numpy(rng.standard_normal(300).astype(np.float32) * 0.1)
    one = tsf.separate(model, torch.nn.functional.pad(sig, (0, 84))[None],
                       torch.tensor([300], dtype=torch.int32))
    big = torch.zeros((3, 768))
    big[1, :300] = sig
    three = tsf.separate(model, big, torch.tensor([17, 300, 1], dtype=torch.int32))
    assert one.shape == (1, 2, 384) and three.shape == (3, 2, 768)
    np.testing.assert_allclose(three[1, :, :300].numpy(), one[0, :, :300].numpy(),
                               atol=2e-5, rtol=1e-4)
