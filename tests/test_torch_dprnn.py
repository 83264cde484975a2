"""The port's DPRNN (speech_separation_tpu_torch/models/dprnn.py) against
the JAX package on the CPU, with the same weights
(utils/weights.dprnn_state_dict_from_jax) and the same numpy inputs: the
separation and the loss with every gradient on a ragged batch whose short
rows leave whole chunks in padding (length-0 rows of the intra-chunk
BLSTM), bf16 separation, the serving pipeline, padding invariance, remat
against no remat, and `train DPRNN --on-device-features` then `separate`
through the CLI.

Tolerances: f32 outputs atol 2e-5 and losses rtol 1e-5 (the same f32 math,
sums in another order); gradients atol 1e-5 of the largest reference
gradient; bf16 outputs 2e-2 of max(1, max |reference|) (a value on the
other side of a bf16 rounding boundary moves by one bf16 step, ~4e-3
relative, and the step carries it on); served waveforms atol 2e-4, as
tests/test_torch_pipeline.py holds uPIT's. Padding invariance atol 2e-5,
rtol 1e-4, the JAX package's own limit (tests/test_dprnn.py); remat rtol
1e-6 against no remat (the same arithmetic recomputed).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_separation_tpu.datadir import DatasetRegistry, prepare_data_dir
from speech_separation_tpu.eval.pipeline import SeparationPipeline as JaxPipeline
from speech_separation_tpu.models import dprnn as jdp
from speech_separation_tpu.train.checkpoint import save_checkpoint as jax_save
from speech_separation_tpu.utils.synthetic import make_synthetic_corpus, write_id_list
from speech_separation_tpu_torch.cli.main import main
from speech_separation_tpu_torch.eval.pipeline import SeparationPipeline
from speech_separation_tpu_torch.models import dprnn as tdp
from speech_separation_tpu_torch.models import dual_path, waveform
from speech_separation_tpu_torch.models.registry import get_arch
from speech_separation_tpu_torch.train.checkpoint import save_checkpoint
from speech_separation_tpu_torch.utils.audio import load_wav
from speech_separation_tpu_torch.utils.weights import dprnn_state_dict_from_jax, fold_lstm_biases

torch.set_num_threads(1)  # six xdist workers share the cores: one thread each, for life

TINY = dict(n_filters=16, filter_len=16, stride=8, channels=12, rnn_hidden=10, chunk=8,
            blocks=2)
TINY_KW = {k: str(v) for k, v in TINY.items()}


def _pair(dtype="float32", seed=0, **over):
    cfg = jdp.Config(num_spk=2, compute_dtype=dtype, **{**TINY, **over})
    params, state = jdp.init(jax.random.PRNGKey(seed), cfg)
    model = tdp.DPRNN(tdp.Config(num_spk=2, compute_dtype=dtype, **{**TINY, **over}))
    model.load_state_dict(dprnn_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    fold_lstm_biases(model)
    return cfg, params, state, model


def _wav_batch(B=4, S=2, L=400, lengths=(400, 333, 17, 0), seed=0):
    """Row 2 fills 3 of 49 latent frames, so most of its chunks lie wholly in
    padding; row 3 is a dummy (row_mask 0, no samples)."""
    rng = np.random.default_rng(seed)
    srcs = (0.1 * rng.standard_normal((B, S, L))).astype(np.float32)
    for b, n in enumerate(lengths):
        srcs[b, :, n:] = 0.0
    lengths = np.asarray(lengths, np.int32)
    return {"mix_wav": srcs.sum(axis=1), "source_wavs": srcs, "sample_lengths": lengths,
            "row_mask": (lengths > 0).astype(np.float32)}


def test_state_dict_names_match_the_jax_pytree():
    _, params, _, model = _pair()
    sd = dprnn_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    assert set(sd) == set(model.state_dict())
    n_leaves = len(jax.tree_util.tree_leaves(params))
    # each 1-layer BLSTM: 6 JAX leaves (w_ih, w_hh, b per direction) -> 8
    assert len(sd) == n_leaves + 2 * 2 * TINY["blocks"]


def test_config_checks_and_registry():
    assert get_arch("dprnn") is tdp and tdp.DOMAIN == "time"
    for bad in ({"mask_act": "tanh"}, {"chunk": 7}, {"filter_len": 8, "stride": 16}):
        with pytest.raises(ValueError):
            tdp.Config(**bad)
    assert tdp.Config.from_kwargs(remat="1", rnn_hidden="32").rnn_hidden == 32


def test_chunk_lengths_have_all_padding_chunks():
    batch = _wav_batch()
    cfg = tdp.Config(**TINY)
    n_t = waveform.latent_frames(cfg, 400)
    vt = waveform.valid_latent_frames(cfg, torch.from_numpy(batch["sample_lengths"]), n_t)
    C = dual_path.num_chunks(cfg, n_t)
    clens = dual_path.chunk_lengths(cfg, vt, C)
    np.testing.assert_array_equal(
        clens.numpy(), np.asarray(jdp._chunk_lengths(jdp.Config(**TINY), jnp.asarray(vt.numpy()),
                                                      C)))
    assert int((clens[2] == 0).sum()) >= 10 and int((clens[3] == 0).sum()) >= 10


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_separate_matches_jax(dtype, tol):
    cfg, params, state, model = _pair(dtype)
    b = _wav_batch()
    ref = np.asarray(jax.jit(jdp.separate, static_argnums=0)(
        cfg, params, state, jnp.asarray(b["mix_wav"]), jnp.asarray(b["sample_lengths"])))
    got = tdp.separate(model, torch.from_numpy(b["mix_wav"]),
                       torch.from_numpy(b["sample_lengths"]))
    assert got.shape == (4, 2, 400) and got.dtype == torch.float32
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got.numpy() / scale, ref / scale, atol=tol)


def test_loss_and_every_gradient_match_jax():
    cfg, params, state, model = _pair()
    b = _wav_batch(seed=1)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jdp.loss_fn(cfg, p, state, jax.tree_util.tree_map(jnp.asarray, b),
                              jax.random.PRNGKey(0), True), has_aux=True))(params)
    loss, aux = tdp.loss_fn(model, {k: torch.from_numpy(v) for k, v in b.items()}, None, True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in ("norm", "total"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(aux["best_perm"].numpy(), np.asarray(jaux["best_perm"]))
    ref = dprnn_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    got = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    assert set(got) == {n for n in ref if ".bias_hh_" not in n}
    scale = max(float(r.abs().max()) for r in ref.values())
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), atol=1e-5 * scale,
                                   err_msg=name)


def test_padding_invariance():
    """A row's separated samples do not depend on the batch and the padding
    it rides in (masked gLN, true lengths in both BLSTM paths)."""
    model = tdp.DPRNN(tdp.Config(**TINY), torch.Generator().manual_seed(0))
    sig = (0.1 * np.random.default_rng(1).standard_normal(300)).astype(np.float32)
    one = tdp.separate(model, torch.from_numpy(np.pad(sig, (0, 84))[None]),
                       torch.tensor([300], dtype=torch.int32))
    big = np.zeros((3, 768), np.float32)
    big[1, :300] = sig
    three = tdp.separate(model, torch.from_numpy(big), torch.tensor([17, 300, 1],
                                                                     dtype=torch.int32))
    np.testing.assert_allclose(three[1, :, :300].numpy(), one[0, :, :300].numpy(),
                               atol=2e-5, rtol=1e-4)


def test_remat_matches_no_remat():
    b = {k: torch.from_numpy(v) for k, v in _wav_batch(seed=2).items()}
    out = {}
    for remat in (False, True):
        model = tdp.DPRNN(tdp.Config(remat=remat, **TINY), torch.Generator().manual_seed(4))
        loss, _ = tdp.loss_fn(model, b, None, True)
        loss.backward()
        out[remat] = (loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()})
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-6)
    for name, g in out[False][1].items():
        np.testing.assert_allclose(out[True][1][name].numpy(), g.numpy(), rtol=1e-6,
                                   atol=1e-9, err_msg=name)


def test_pipeline_matches_jax(tmp_path):
    """The time-domain serving path: three ragged signals in one batch."""
    cfg = jdp.Config(num_spk=2, **TINY)
    params, state = jdp.init(jax.random.PRNGKey(5), cfg)
    ckpt = str(tmp_path / "model.ckpt")
    jax_save(ckpt, params=params, state=state, epoch=0,
             meta={"arch": "DPRNN", "model_kwargs": TINY_KW})
    model = tdp.DPRNN(tdp.Config.from_kwargs(**TINY_KW))
    model.load_state_dict(dprnn_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    mdl = str(tmp_path / "model.mdl")
    save_checkpoint(mdl, model, meta={"arch": "DPRNN", "model_kwargs": TINY_KW})
    rng = np.random.default_rng(3)
    sigs = [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in (3000, 1200, 40)]
    ref = JaxPipeline(ckpt, batch_size=4, length_quantum=4096).separate(sigs)
    pipe = SeparationPipeline(mdl, batch_size=4, length_quantum=4096, device="cpu")
    assert pipe.arch is tdp
    got = pipe.separate(sigs)
    for r, g, s in zip(ref, got, sigs):
        for a, c in zip(r, g):
            assert a.shape == c.shape == s.shape
            np.testing.assert_allclose(c, a, atol=2e-4)
    with pytest.raises(ValueError, match="RSH"):
        pipe.separate(sigs, num_spk=3)


def test_train_dprnn_cli_then_separate(tmp_path):
    ids = make_synthetic_corpus(str(tmp_path / "corpus"), 4, min_sec=0.3, max_sec=0.6,
                                seed=0, prefix="tr")
    write_id_list(str(tmp_path / "id_lists"), "toy", ids)
    data_dir = prepare_data_dir("toy", DatasetRegistry({"toy": str(tmp_path / "corpus")}),
                                data_root=str(tmp_path / "data"),
                                id_lists_dir=str(tmp_path / "id_lists"))
    # one block and 64-frame chunks: the waveforms pad to 16384 samples
    conf = tmp_path / "model.conf"
    conf.write_text("".join(f"{k}={v}\n" for k, v in {**TINY, "chunk": 64, "blocks": 1}.items()))
    exp = str(tmp_path / "exp")
    main(["train", "DPRNN", data_dir, exp, "--on-device-features", "--cv-data-dir", data_dir,
          "--model-config", str(conf), "--num-epochs", "5", "--batch-size", "4",
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
