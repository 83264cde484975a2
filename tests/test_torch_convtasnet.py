"""The port's Conv-TasNet (speech_separation_tpu_torch/models/convtasnet.py)
against the JAX package on the CPU, with the same weights
(utils/weights.pytree_state_dict_from_jax) and the same seeded numpy inputs:
``separate`` with gLN and cLN, ReLU and sigmoid masks, in f32 and bf16; the
loss and every gradient; ``streaming_forward`` over several chunks; the JAX
package's properties held on the port (padding invariance, the causal
receptive field, a finite loss on pad rows, remat); the serving pipeline;
and ``train ConvTasNet --on-device-features`` then ``separate`` through the
port's CLI, with the refusals of ``train`` without waveforms and of
``eval-masks``.

Tolerances: f32 separated waveforms atol 2e-5 of max(1, max |reference|),
losses rtol 1e-5, gradients atol 1e-5 of the largest reference gradient (the
same f32 math, sums in another order). bf16 waveforms 2e-2 of max(1, max
|reference|) (a value on the other side of a bf16 rounding boundary moves by
one bf16 step, ~4e-3 relative, and the blocks carry it on), as
tests/test_torch_dprnn.py holds DPRNN's. Streamed masks against the JAX
package's at the f32 limit, 2e-5, and against the offline causal forward
atol 2e-6 (the same products, the conv summed by another call). Padding
invariance atol 2e-5, rtol 1e-4, and the causal receptive field atol 1e-6:
the JAX package's own limits (tests/test_convtasnet.py). Remat rtol 1e-6
(the same arithmetic, recomputed); served waveforms atol 2e-4, as
tests/test_torch_dprnn.py holds DPRNN's.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_separation_tpu.datadir import DatasetRegistry, prepare_data_dir
from speech_separation_tpu.eval.pipeline import SeparationPipeline as JaxPipeline
from speech_separation_tpu.models import convtasnet as jct
from speech_separation_tpu.train.checkpoint import save_checkpoint as jax_save
from speech_separation_tpu.utils.synthetic import make_synthetic_corpus, write_id_list
from speech_separation_tpu_torch.cli.main import main
from speech_separation_tpu_torch.eval.infer import generate_masks
from speech_separation_tpu_torch.eval.pipeline import SeparationPipeline
from speech_separation_tpu_torch.models import convtasnet as tct
from speech_separation_tpu_torch.models.waveform import latent_frames
from speech_separation_tpu_torch.models.registry import get_arch
from speech_separation_tpu_torch.train.checkpoint import save_checkpoint
from speech_separation_tpu_torch.train.loop import TrainLoopConfig, train
from speech_separation_tpu_torch.utils.audio import load_wav
from speech_separation_tpu_torch.utils.weights import pytree_state_dict_from_jax

torch.set_num_threads(1)  # six xdist workers share the cores: one thread each, for life

TINY = dict(n_filters=32, filter_len=16, stride=8, channels=16, hidden=24, kernel=3,
            blocks=3, repeats=2)
TINY_KW = {k: str(v) for k, v in TINY.items()}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _pair(seed=0, **over):
    kw = {**TINY, **over}
    cfg = jct.Config(num_spk=2, **kw)
    params, state = jct.init(jax.random.PRNGKey(seed), cfg)
    model = tct.ConvTasNet(tct.Config(num_spk=2, **kw))
    model.load_state_dict(pytree_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params)),
                          strict=True)
    return cfg, params, state, model


def _wav_batch(B=4, S=2, L=400, lengths=(400, 333, 17, 0), seed=0):
    """Row 3 is a dummy (row_mask 0, no samples)."""
    rng = np.random.default_rng(seed)
    srcs = (0.1 * rng.standard_normal((B, S, L))).astype(np.float32)
    for b, n in enumerate(lengths):
        srcs[b, :, n:] = 0.0
    lengths = np.asarray(lengths, np.int32)
    return {"mix_wav": srcs.sum(axis=1), "source_wavs": srcs, "sample_lengths": lengths,
            "row_mask": (lengths > 0).astype(np.float32)}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_state_dict_names_and_the_default_width():
    _, params, _, model = _pair()
    sd = pytree_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    assert set(sd) == set(model.state_dict()) and len(sd) == len(jax.tree_util.tree_leaves(params))
    n = sum(p.numel() for p in tct.ConvTasNet(tct.Config()).parameters())
    full, _ = jax.eval_shape(lambda k: jct.init(k, jct.Config()), jax.random.PRNGKey(0))
    assert n == sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(full))


def test_config_checks_and_registry():
    assert get_arch("ConvTasNet") is tct and tct.DOMAIN == "time"
    assert tct.Config(causal=True).norm == "cln"
    for bad in ({"mask_act": "tanh"}, {"norm": "bn"}, {"filter_len": 8, "stride": 16},
                {"stride": 0}):
        with pytest.raises(ValueError):
            tct.Config(**bad)
    cfg = tct.Config.from_kwargs(remat="1", causal="true", n_filters="64", bogus="x")
    assert cfg.remat and cfg.causal and cfg.n_filters == 64 and cfg.norm == "cln"
    assert cfg.receptive_field == jct.Config.from_kwargs(causal="1").receptive_field


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm,act,causal", [("gln", "relu", False), ("cln", "sigmoid", False),
                                             ("cln", "relu", True)],
                         ids=["gln-relu", "cln-sigmoid", "causal"])
def test_separate_matches_jax(norm, act, causal, dtype):
    cfg, params, state, model = _pair(norm=norm, mask_act=act, causal=causal,
                                      compute_dtype=dtype)
    b = _wav_batch()
    ref = np.asarray(jct.separate(cfg, params, state, jnp.asarray(b["mix_wav"]),
                                  jnp.asarray(b["sample_lengths"])))
    got = tct.separate(model, torch.from_numpy(b["mix_wav"]),
                       torch.from_numpy(b["sample_lengths"]))
    assert got.shape == (4, 2, 400) and got.dtype == torch.float32
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got.numpy() / scale, ref / scale, atol=TOL[dtype])


@pytest.mark.parametrize("norm,act", [("gln", "relu"), ("cln", "sigmoid")])
def test_loss_and_every_gradient_match_jax(norm, act):
    cfg, params, state, model = _pair(norm=norm, mask_act=act)
    b = _wav_batch(seed=1)
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jct.loss_fn(cfg, p, state, jax.tree_util.tree_map(jnp.asarray, b), None,
                              True), has_aux=True)(params)
    loss, aux = tct.loss_fn(model, _t(b), None, True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in ("norm", "total"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(aux["best_perm"].numpy(), np.asarray(jaux["best_perm"]))
    ref = pytree_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    scale = max(float(r.abs().max()) for r in ref.values())
    got = dict(model.named_parameters())
    assert set(got) == set(ref)
    for name, p in got.items():
        # the last block's residual feeds nothing: no gradient in torch, zeros in JAX
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), atol=1e-5 * scale,
                                   err_msg=name)


def test_streaming_forward_matches_jax_and_the_offline_masks():
    """Five chunks of 8 latent frames, two rows, the conv context carried
    from chunk to chunk."""
    cfg, params, _, model = _pair(causal=True)
    w = np.maximum(np.random.default_rng(4).standard_normal((2, 40, 32)), 0).astype(np.float32)
    jstate = jct.init_stream_state(cfg, batch=2)
    state = tct.init_stream_state(model.cfg, 2)
    ref, got = [], []
    with torch.no_grad():
        for t0 in range(0, 40, 8):
            m, jstate = jct.streaming_forward(cfg, params, jnp.asarray(w[:, t0: t0 + 8]), jstate)
            ref.append(np.asarray(m))
            m, state = model.streaming_forward(torch.from_numpy(w[:, t0: t0 + 8]), state)
            got.append(m.numpy())
        off = model.mask_logits(torch.from_numpy(w), torch.ones((2, 40, 1)))
    got = np.concatenate(got, axis=1)
    assert got.shape == (2, 40, 2, 32)
    np.testing.assert_allclose(got, np.concatenate(ref, axis=1), atol=2e-5)
    for s, js in zip(state, jstate):
        np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=2e-5)
    np.testing.assert_allclose(got, off.numpy(), atol=2e-6)


def test_separate_padding_invariance():
    """An utterance's samples do not depend on the batch and padding it
    rides in (masked gLN statistics)."""
    model = tct.ConvTasNet(tct.Config(**TINY), torch.Generator().manual_seed(0))
    sig = (0.1 * np.random.default_rng(1).standard_normal(300)).astype(np.float32)
    one = tct.separate(model, torch.from_numpy(np.pad(sig, (0, 84))[None]),
                       torch.tensor([300], dtype=torch.int32))
    assert one.shape == (1, 2, 384)
    big = np.zeros((3, 768), np.float32)
    big[1, :300] = sig
    three = tct.separate(model, torch.from_numpy(big),
                         torch.tensor([1, 300, 1], dtype=torch.int32))
    np.testing.assert_allclose(three[1, :, :300].numpy(), one[0, :, :300].numpy(),
                               atol=2e-5, rtol=1e-4)


def test_cln_variant_and_causal_receptive_field():
    """Perturbing the last encoder frame's samples leaves the output before
    that frame's start as it was."""
    cfg = tct.Config(causal=True, **TINY)
    model = tct.ConvTasNet(cfg, torch.Generator().manual_seed(0))
    wav = torch.from_numpy((0.1 * np.random.default_rng(2).standard_normal((1, 256)))
                           .astype(np.float32))
    n = torch.tensor([256], dtype=torch.int32)
    base = tct.separate(model, wav, n)
    pert = wav.clone()
    pert[0, -cfg.stride:] += 1.0
    out = tct.separate(model, pert, n)
    safe = (latent_frames(cfg, 256) - 3) * cfg.stride
    np.testing.assert_allclose(out[:, :, :safe].numpy(), base[:, :, :safe].numpy(), atol=1e-6)
    assert not torch.equal(out, base)


def test_pad_rows_keep_loss_and_gradients_finite():
    model = tct.ConvTasNet(tct.Config(**TINY), torch.Generator().manual_seed(0))
    b = _wav_batch(B=3, lengths=(400, 333, 0))
    loss, _ = tct.loss_fn(model, _t(b), None, True)
    loss.backward()
    assert np.isfinite(loss.item())
    assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)


def test_remat_matches_no_remat():
    b = _t(_wav_batch(seed=2))
    out = {}
    for remat in (False, True):
        model = tct.ConvTasNet(tct.Config(remat=remat, **TINY), torch.Generator().manual_seed(4))
        loss, _ = tct.loss_fn(model, b, None, True)
        loss.backward()
        out[remat] = (loss.item(), {n: p.grad for n, p in model.named_parameters()})
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-6)
    for name, g in out[False][1].items():
        if g is None:
            assert out[True][1][name] is None
            continue
        np.testing.assert_allclose(out[True][1][name].numpy(), g.numpy(), rtol=1e-6,
                                   atol=1e-12, err_msg=name)


def test_pipeline_matches_jax(tmp_path):
    """The time-domain serving path: three ragged signals in one batch."""
    cfg = jct.Config(num_spk=2, **TINY)
    params, state = jct.init(jax.random.PRNGKey(5), cfg)
    ckpt = str(tmp_path / "model.ckpt")
    jax_save(ckpt, params=params, state=state, epoch=0,
             meta={"arch": "ConvTasNet", "model_kwargs": TINY_KW})
    model = tct.ConvTasNet(tct.Config.from_kwargs(**TINY_KW))
    model.load_state_dict(pytree_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    mdl = str(tmp_path / "model.mdl")
    save_checkpoint(mdl, model, meta={"arch": "ConvTasNet", "model_kwargs": TINY_KW})
    rng = np.random.default_rng(3)
    sigs = [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in (3000, 1200, 40)]
    ref = JaxPipeline(ckpt, batch_size=4, length_quantum=4096).separate(sigs)
    pipe = SeparationPipeline(mdl, batch_size=4, length_quantum=4096, device="cpu")
    assert pipe.arch is tct and pipe.domain == "time"
    got = pipe.separate(sigs)
    for r, g, s in zip(ref, got, sigs):
        for a, c in zip(r, g):
            assert a.shape == c.shape == s.shape
            np.testing.assert_allclose(c, a, atol=2e-4)


def test_train_cli_then_separate_and_the_refusals(tmp_path):
    ids = make_synthetic_corpus(str(tmp_path / "corpus"), 4, min_sec=0.3, max_sec=0.6,
                                seed=0, prefix="tr")
    write_id_list(str(tmp_path / "id_lists"), "toy", ids)
    data_dir = prepare_data_dir("toy", DatasetRegistry({"toy": str(tmp_path / "corpus")}),
                                data_root=str(tmp_path / "data"),
                                id_lists_dir=str(tmp_path / "id_lists"))
    conf = tmp_path / "model.conf"
    conf.write_text("".join(f"{k}={v}\n" for k, v in TINY.items()))
    exp = str(tmp_path / "exp")
    main(["train", "ConvTasNet", data_dir, exp, "--on-device-features", "--cv-data-dir",
          data_dir, "--model-config", str(conf), "--num-epochs", "5", "--batch-size", "4",
          "--device", "cpu"])
    with open(os.path.join(exp, "train_stats", "train_loss.txt")) as f:
        losses = [float(ln.split()[1]) for ln in f]
    assert len(losses) == 5 and all(np.isfinite(losses))
    with open(os.path.join(exp, "train_stats", "cv_loss.txt")) as f:
        assert [ln.split()[0] for ln in f] == ["005"]
    wav = os.path.join(tmp_path, "corpus", "mix", "tr0001.wav")
    out_dir = str(tmp_path / "separated")
    main(["separate", os.path.join(exp, "final.mdl"), out_dir, wav, "--device", "cpu"])
    x, _ = load_wav(wav)
    for s in (1, 2):
        y, sr = load_wav(os.path.join(out_dir, f"tr0001_s{s}.wav"))
        assert sr == 8000 and len(y) == len(x) and np.all(np.isfinite(y))

    # a time-domain arch trains on waveforms only, and has no masks to write
    with pytest.raises(ValueError, match="time-domain"):
        train(data_dir, str(tmp_path / "exp2"), TrainLoopConfig(arch="ConvTasNet"),
              device="cpu")
    with pytest.raises(ValueError, match="time-domain"):
        generate_masks(os.path.join(exp, "final.mdl"), data_dir, str(tmp_path / "masks"),
                       device="cpu")
