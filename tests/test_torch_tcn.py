"""The port's TCN (speech_separation_tpu_torch/models/tcn.py) against the JAX
package on the CPU, with the same weights
(utils/weights.pytree_state_dict_from_jax) and the same seeded numpy inputs:
the forward in f32 and bf16, centred and causal; the loss and every gradient;
``streaming_forward`` over several chunks; ``_depthwise`` against a literal
cross-correlation; the JAX package's properties held on the port (padding
invariance, a mode-free forward, causality, remat); the serving pipeline;
and ``train TCN`` then ``separate`` through the port's CLI.

Tolerances: f32 masks atol 2e-5, losses rtol 1e-5, gradients atol 1e-5 of
the largest reference gradient (the same f32 math, sums in another order).
bf16: the 1x1 products take bf16 inputs and the trunk stores bf16, so a
value on the other side of a bf16 rounding boundary moves by one bf16 step
(~4e-3 relative) and the blocks carry it on: masks atol 2e-2, losses rtol
2e-2, gradients atol 2e-2 of the largest reference gradient. Streamed chunks
against the JAX package's at the f32 limit, 2e-5. Causality and the
mode-free forward exactly (the causal conv reads no frame to its right, and
the forward has no mode); padding invariance atol 1e-6 (exact in the JAX
package; torch's CPU mean in ``cln`` (models/layers.py) sums a frame's channels in a grouping
that depends on the batch's frame count, ~2e-7), frames past a row's length
exact zeros; the stream against the offline causal forward atol 2e-6 (a
VALID conv over the carried context and a padded conv over the whole
sequence are the same three products a frame, summed by another conv call);
remat rtol 1e-6 (the same arithmetic, recomputed); served waveforms atol
2e-4, as tests/test_torch_pipeline.py holds uPIT's.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_separation_tpu.datadir import DatasetRegistry, prepare_data_dir
from speech_separation_tpu.dsp import STFTConfig
from speech_separation_tpu.dsp.extract import extract_features
from speech_separation_tpu.eval.pipeline import SeparationPipeline as JaxPipeline
from speech_separation_tpu.models import tcn as jtcn
from speech_separation_tpu.train.checkpoint import save_checkpoint as jax_save
from speech_separation_tpu.utils.synthetic import make_synthetic_corpus, write_id_list
from speech_separation_tpu_torch.cli.main import main
from speech_separation_tpu_torch.eval.pipeline import SeparationPipeline
from speech_separation_tpu_torch.models import tcn as ttcn
from speech_separation_tpu_torch.models.registry import get_arch
from speech_separation_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from speech_separation_tpu_torch.utils.audio import load_wav
from speech_separation_tpu_torch.utils.weights import pytree_state_dict_from_jax

torch.set_num_threads(1)  # six xdist workers share the cores: one thread each, for life

TINY = dict(feat_dim=33, num_spk=2, channels=16, hidden=24, blocks=3, repeats=2)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _pair(seed=0, **over):
    kw = {**TINY, **over}
    cfg = jtcn.Config(**kw)
    params, state = jtcn.init(jax.random.PRNGKey(seed), cfg)
    model = ttcn.TCN(ttcn.Config(**kw))
    model.load_state_dict(pytree_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params)),
                          strict=True)
    return cfg, params, state, model


def _batch(seed=0, B=4, T=40, lengths=(40, 30, 17, 0), F=33):
    """A ragged batch; the last row a dummy (row_mask 0, length 0)."""
    rng = np.random.default_rng(seed)
    mix = np.abs(rng.standard_normal((B, T, F))).astype(np.float32)
    sources = np.abs(rng.standard_normal((B, 2, T, F))).astype(np.float32)
    for b, n in enumerate(lengths):
        mix[b, n:] = 0.0
        sources[b, :, n:] = 0.0
    lengths = np.asarray(lengths, np.int32)
    return {"mix": mix, "sources": sources, "lengths": lengths,
            "row_mask": (lengths > 0).astype(np.float32)}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_state_dict_names_match_the_jax_pytree():
    _, params, _, model = _pair()
    sd = pytree_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    assert set(sd) == set(model.state_dict())
    assert len(sd) == len(jax.tree_util.tree_leaves(params))
    assert "blocks.5.dw" in sd and sd["blocks.5.dw"].shape == (3, 24)


def test_registry_and_config():
    assert get_arch("tcn") is ttcn and ttcn.DOMAIN == "spectrum"
    cfg = ttcn.Config.from_kwargs(channels="24", repeats="2", remat="true", causal="1",
                                  compute_dtype="bfloat16", bogus="ignored")
    assert (cfg.channels, cfg.repeats, cfg.remat, cfg.causal) == (24, 2, True, True)
    assert cfg.torch_dtype == torch.bfloat16
    jcfg = jtcn.Config.from_kwargs(channels="24", repeats="2")
    assert cfg.dilations() == jcfg.dilations() and cfg.receptive_field == jcfg.receptive_field
    assert ttcn.Config().receptive_field == jtcn.Config().receptive_field == 2041


def test_default_width_has_the_jax_parameter_count():
    """The JAX defaults: 257 -> 256 channels, hidden 512, 8 x 4 blocks."""
    n = sum(p.numel() for p in ttcn.TCN(ttcn.Config()).parameters())
    params, _ = jax.eval_shape(lambda k: jtcn.init(k, jtcn.Config()), jax.random.PRNGKey(0))
    assert n == sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(params))
    assert n == 12_978_436


@pytest.mark.parametrize("causal", [False, True], ids=["centred", "causal"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(dtype, causal):
    cfg, params, state, model = _pair(compute_dtype=dtype, causal=causal)
    b = _batch()
    ref, _ = jtcn.forward(cfg, params, state, jnp.asarray(b["mix"]), jnp.asarray(b["lengths"]),
                          jnp.asarray(b["row_mask"]), None, train=False)
    got = ttcn.infer_masks(model, _t(b))
    assert got.shape == (4, 40, 66) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL[dtype])


@pytest.mark.parametrize("dtype,causal", [("float32", False), ("float32", True),
                                          ("bfloat16", False)])
def test_loss_and_every_gradient_match_jax(dtype, causal):
    cfg, params, state, model = _pair(compute_dtype=dtype, causal=causal)
    b = _batch(seed=1)
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jtcn.loss_fn(cfg, p, state, jax.tree_util.tree_map(jnp.asarray, b), None,
                               True), has_aux=True)(params)
    loss, aux = ttcn.loss_fn(model, _t(b), None, True)
    loss.backward()
    rtol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=rtol)
    for k in ("norm", "total"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=rtol, err_msg=k)
    np.testing.assert_array_equal(aux["best_perm"].numpy(), np.asarray(jaux["best_perm"]))
    ref = pytree_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    scale = max(float(r.abs().max()) for r in ref.values())
    got = dict(model.named_parameters())
    assert set(got) == set(ref)
    atol = (1e-5 if dtype == "float32" else 2e-2) * scale
    for name, p in got.items():
        # the last block's residual feeds nothing: no gradient in torch, zeros in JAX
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), atol=atol, err_msg=name)
    assert got["blocks.5.res.w"].grad is None
    assert float(np.abs(ref["blocks.5.res.w"].numpy()).max()) == 0.0


@pytest.mark.parametrize("causal", [False, True], ids=["centred", "causal"])
def test_depthwise_matches_numpy_cross_correlation(causal):
    rng = np.random.default_rng(0)
    B, T, H, K, d = 2, 12, 3, 3, 2
    x = rng.standard_normal((B, T, H)).astype(np.float32)
    k = rng.standard_normal((K, H)).astype(np.float32)
    b = rng.standard_normal((H,)).astype(np.float32)
    y = ttcn._depthwise(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b), d,
                        causal).numpy()
    left, right = ((K - 1) * d, 0) if causal else ((K - 1) // 2 * d,) * 2
    xp = np.pad(x, ((0, 0), (left, right), (0, 0)))
    ref = np.zeros_like(x)
    for t in range(T):
        for j in range(K):
            ref[:, t, :] += xp[:, t + j * d, :] * k[j]
    np.testing.assert_allclose(y, ref + b, atol=1e-5)


def test_padding_invariance_and_mode_free():
    """A row's masks are the same however much time padding its batch
    carries; frames past each row's length are exact zeros; the train-mode
    forward equals the eval one. The JAX package holds the padding
    invariance bit for bit; torch's CPU mean over the channels (in ``cln`` (models/layers.py))
    groups a row's sums by the batch's frame count, which moves a mask by
    ~2e-7, so the port holds 1e-6."""
    model = ttcn.TCN(ttcn.Config(**TINY), torch.Generator().manual_seed(0))
    b = _t(_batch(lengths=(40, 30, 17, 5)))
    masks = ttcn.infer_masks(model, b)
    mix2 = torch.zeros((4, 64, 33))
    mix2[:, :40] = b["mix"]
    m2 = ttcn.infer_masks(model, dict(b, mix=mix2))
    np.testing.assert_allclose(m2[:, :40].numpy(), masks.numpy(), rtol=0, atol=1e-6)
    for r, n in enumerate((40, 30, 17, 5)):
        assert torch.all(masks[r, n:] == 0.0)
    with torch.no_grad():
        assert torch.equal(model(b["mix"], b["lengths"], b["row_mask"], train=True), masks)


def test_causal_forward_ignores_the_future():
    model = ttcn.TCN(ttcn.Config(**TINY, causal=True), torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.abs(np.random.default_rng(0).standard_normal((1, 30, 33)))
                         .astype(np.float32))
    lengths, rm = torch.tensor([30]), torch.ones(1)
    m1 = ttcn.infer_masks(model, {"mix": x, "lengths": lengths, "row_mask": rm})
    x2 = x.clone()
    x2[0, 20:] = 7.7
    m2 = ttcn.infer_masks(model, {"mix": x2, "lengths": lengths, "row_mask": rm})
    assert torch.equal(m1[0, :20], m2[0, :20])
    assert not torch.equal(m1[0, 20:], m2[0, 20:])


def _stream(model, x, chunk, state):
    outs = []
    with torch.no_grad():
        for t0 in range(0, x.shape[1], chunk):
            m, state = model.streaming_forward(x[:, t0: t0 + chunk], state)
            outs.append(m)
    return torch.cat(outs, dim=1), state


def test_streaming_forward_matches_jax_and_the_offline_forward():
    """Five chunks of 8 frames, two rows, the conv context carried from
    chunk to chunk."""
    cfg, params, _, model = _pair(causal=True)
    x = np.abs(np.random.default_rng(4).standard_normal((2, 40, 33))).astype(np.float32)
    jstate = jtcn.init_stream_state(cfg, batch=2)
    ref = []
    for t0 in range(0, 40, 8):
        m, jstate = jtcn.streaming_forward(cfg, params, jnp.asarray(x[:, t0: t0 + 8]), jstate)
        ref.append(np.asarray(m))
    got, state = _stream(model, torch.from_numpy(x), 8, ttcn.init_stream_state(model.cfg, 2))
    np.testing.assert_allclose(got.numpy(), np.concatenate(ref, axis=1), atol=2e-5)
    assert [tuple(s.shape) for s in state] == [tuple(s.shape) for s in jstate]
    for s, js in zip(state, jstate):
        np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=2e-5)
    off = ttcn.infer_masks(model, {"mix": torch.from_numpy(x), "lengths": torch.tensor([40, 40]),
                                   "row_mask": torch.ones(2)})
    np.testing.assert_allclose(got.numpy(), off.numpy(), atol=2e-6)
    with pytest.raises(ValueError, match="causal"):
        ttcn.TCN(ttcn.Config(**TINY)).streaming_forward(torch.from_numpy(x), state)


def test_remat_matches_no_remat():
    b = _t(_batch(seed=2))
    out = {}
    for remat in (False, True):
        model = ttcn.TCN(ttcn.Config(**TINY, remat=remat), torch.Generator().manual_seed(4))
        loss, _ = ttcn.loss_fn(model, b, None, True)
        loss.backward()
        out[remat] = (loss.item(), {n: p.grad for n, p in model.named_parameters()})
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-6)
    for name, g in out[False][1].items():
        if g is None:
            assert out[True][1][name] is None
            continue
        np.testing.assert_allclose(out[True][1][name].numpy(), g.numpy(), rtol=1e-6,
                                   atol=1e-12, err_msg=name)


KW = {"channels": "16", "hidden": "24", "blocks": "3", "repeats": "2"}


def test_pipeline_matches_jax(tmp_path):
    """The spectral serving path with a TCN: three ragged signals."""
    cfg = jtcn.Config(feat_dim=257, num_spk=2, channels=16, hidden=24, blocks=3, repeats=2)
    params, state = jtcn.init(jax.random.PRNGKey(5), cfg)
    ckpt = str(tmp_path / "model.ckpt")
    jax_save(ckpt, params=params, state=state, epoch=0,
             meta={"arch": "TCN", "model_kwargs": KW})
    model = ttcn.TCN(ttcn.Config.from_kwargs(**KW))
    model.load_state_dict(pytree_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    mdl = str(tmp_path / "model.mdl")
    save_checkpoint(mdl, model, meta={"arch": "TCN", "model_kwargs": KW})
    rng = np.random.default_rng(3)
    sigs = [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in (3000, 1200, 400)]
    ref = JaxPipeline(ckpt, batch_size=4, length_quantum=4096).separate(sigs)
    pipe = SeparationPipeline(mdl, batch_size=4, length_quantum=4096, device="cpu")
    assert pipe.arch is ttcn
    got = pipe.separate(sigs)
    for r, g in zip(ref, got):
        for a, c in zip(r, g):
            assert a.shape == c.shape
            np.testing.assert_allclose(c, a, atol=2e-4)
    with pytest.raises(ValueError, match="RSH"):
        pipe.separate(sigs, num_spk=3)


def test_train_tcn_cli_then_eval_masks_and_separate(tmp_path):
    ids = make_synthetic_corpus(str(tmp_path / "corpus"), 4, min_sec=0.3, max_sec=0.6,
                                seed=0, prefix="tr")
    write_id_list(str(tmp_path / "id_lists"), "toy", ids)
    data_dir = prepare_data_dir("toy", DatasetRegistry({"toy": str(tmp_path / "corpus")}),
                                data_root=str(tmp_path / "data"),
                                id_lists_dir=str(tmp_path / "id_lists"))
    extract_features(data_dir, "train", str(tmp_path / "feats"), STFTConfig(),
                     log=lambda *a: 0)
    conf = tmp_path / "model.conf"
    conf.write_text("".join(f"{k}={v}\n" for k, v in KW.items()))
    exp = str(tmp_path / "exp")
    main(["train", "TCN", data_dir, exp, "--cv-data-dir", data_dir, "--model-config", str(conf),
          "--num-epochs", "5", "--batch-size", "4", "--time-pad-multiple", "32",
          "--device", "cpu"])
    with open(os.path.join(exp, "train_stats", "train_loss.txt")) as f:
        losses = [float(ln.split()[1]) for ln in f]
    assert len(losses) == 5 and all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert load_checkpoint(os.path.join(exp, "final.mdl"))["meta"]["arch"] == "TCN"
    wav = os.path.join(tmp_path, "corpus", "mix", "tr0001.wav")
    out_dir = str(tmp_path / "separated")
    main(["separate", os.path.join(exp, "final.mdl"), out_dir, wav, "--device", "cpu"])
    n = len(load_wav(wav)[0])
    for s in (1, 2):
        y, sr = load_wav(os.path.join(out_dir, f"tr0001_s{s}.wav"))
        assert sr == 8000 and abs(len(y) - n) < 128 and np.all(np.isfinite(y))
