"""SepFormer training in the port against the JAX package on the CPU: the
waveform input (train/wav_data.py) against the JAX package's, a three-step
float32 trajectory against its make_update_step, the batch order of the
loader that spans epochs, and the ``train SepFormer --on-device-features``
CLI end to end, whose ``final.mdl`` the port's ``separate`` serves.

Tolerances: the shipped batches are the same integers and the conversion to
waveforms the same float32 arithmetic (exact); the magnitudes 1e-5 of the
largest (an f32 DFT summed in another order); the trajectory's first loss
rtol 1e-5 (one forward, sums in another order), later losses 2e-3 and the
weights after three Adam updates atol 5e-5 (a small part of one lr=1e-3
step), the limits of tests/test_torch_train.py's uPIT trajectory.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_separation_tpu.datadir import DatasetRegistry, prepare_data_dir
from speech_separation_tpu.models import sepformer as jsf
from speech_separation_tpu.train import wav_data as jwav
from speech_separation_tpu.train.loop import (TrainLoopConfig as JaxLoopConfig,
                                              make_optimizer, make_update_step)
from speech_separation_tpu.utils.synthetic import make_synthetic_corpus, write_id_list
from speech_separation_tpu_torch.cli.main import main
from speech_separation_tpu_torch.dsp.stft import STFTConfig
from speech_separation_tpu_torch.models import sepformer as tsf
from speech_separation_tpu_torch.train import data as tdata
from speech_separation_tpu_torch.train import loop
from speech_separation_tpu_torch.train import wav_data as twav
from speech_separation_tpu_torch.utils.audio import load_wav
from speech_separation_tpu_torch.utils.weights import pytree_state_dict_from_jax

torch.set_num_threads(1)  # six xdist workers share the cores: one thread each, for life

TINY = dict(n_filters=16, filter_len=16, stride=8, channels=16, heads=2,
            d_ff=24, chunk=8, blocks=2)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_sepformer")
    ids = make_synthetic_corpus(str(root / "corpus"), 5, min_sec=0.3, max_sec=0.6,
                                seed=0, prefix="tr")
    write_id_list(str(root / "id_lists"), "toy", ids)
    data_dir = prepare_data_dir("toy", DatasetRegistry({"toy": str(root / "corpus")}),
                                data_root=str(root / "data"),
                                id_lists_dir=str(root / "id_lists"))
    return root, data_dir


@pytest.mark.parametrize("kind", ["wave", "feature"])
def test_waveform_batches_match_jax(corpus, kind):
    _, data_dir = corpus
    jds = jwav.WavDataset(data_dir)
    tds = twav.WavDataset(data_dir)
    assert os.path.isfile(os.path.join(data_dir, "utt2num_samples"))
    for a in ("num_samples", "num_frames", "num_spks"):
        np.testing.assert_array_equal(getattr(tds, a), getattr(jds, a), err_msg=a)
    idxs = [3, 0, 4]
    ref = jwav.collate_wav_batch(jds, idxs, 4)
    got = twav.collate_wav_batch(tds, idxs, 4)
    assert got["names"] == ref["names"]
    for k in ("audio", "sample_lengths", "lengths", "row_mask"):
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["audio"].dtype == np.int16 and got["audio"].shape[-1] == 16384 + 512
    cfg = STFTConfig()
    tb = {k: torch.from_numpy(got[k]) for k in ("audio", "sample_lengths", "lengths", "row_mask")}
    jb = {k: jnp.asarray(ref[k]) for k in ("audio", "sample_lengths", "lengths", "row_mask")}
    if kind == "wave":
        out, want = twav.audio_to_wave_batch(tb, cfg), jwav.audio_to_wave_batch(jb, cfg)
        keys, tol = ("mix_wav", "source_wavs", "sample_lengths", "row_mask"), 0
    else:
        out, want = twav.audio_to_feature_batch(tb, cfg), jwav.audio_to_feature_batch(jb, cfg)
        keys, tol = ("mix", "sources", "lengths", "row_mask"), 1e-5
    for k in keys:
        w = np.asarray(want[k])
        np.testing.assert_allclose(out[k].numpy(), w, rtol=0, atol=tol * np.abs(w).max(),
                                   err_msg=k)


def test_three_step_trajectory_matches_jax_update_step(corpus):
    """The port's update_step (fused attention, K5's VJP rule) against the
    JAX package's make_update_step (einsum path) on one shipped batch."""
    _, data_dir = corpus
    ds = twav.WavDataset(data_dir)
    # padded to a multiple of 1024 samples, not the loader's 16384, to keep
    # the two programs small
    shipped = twav.collate_wav_batch(ds, [0, 1, 2, 3], 4, sample_pad_multiple=1024)
    jcfg = jsf.Config(num_spk=2, **TINY)
    params, state = jax.jit(jsf.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    model = tsf.SepFormer(tsf.Config(num_spk=2, fused_attention=True, **TINY))
    model.load_state_dict(pytree_state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                                params)))
    optimizer = make_optimizer(JaxLoopConfig())
    opt_state = optimizer.init(params)
    step = make_update_step(jsf, jcfg, optimizer, jwav.STFTConfig())
    jbatch = {k: jnp.asarray(shipped[k]) for k in ("audio", "sample_lengths", "lengths",
                                                   "row_mask")}
    opt = loop.Optimizer(model.parameters(), loop.TrainLoopConfig())
    tbatch = twav.audio_to_wave_batch(
        {k: torch.from_numpy(v) for k, v in shipped.items() if k != "names"}, STFTConfig())
    jl, tl = [], []
    for _ in range(3):
        params, state, opt_state, loss, _ = step(params, state, opt_state, jbatch,
                                                 jax.random.PRNGKey(1))
        jl.append(float(loss))
        loss, _ = loop.update_step(tsf, model, opt, tbatch, None)
        tl.append(loss.item())
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-5)
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    ref = pytree_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), atol=5e-5, err_msg=name)


def _npz_dir(root, n=7, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(root)
    with open(os.path.join(root, "feats_train.scp"), "w") as f:
        for i in range(n):
            T = int(rng.integers(3, 12))
            path = os.path.join(root, f"u{i:02d}.npz")
            np.savez(path, mix=rng.random((5, T)).astype(np.float32),
                     s1=rng.random((5, T)).astype(np.float32),
                     s2=rng.random((5, T)).astype(np.float32))
            f.write(f"u{i:02d} {path}\n")
    return root


@pytest.mark.parametrize("arch", ["uPIT", "SepFormer"])
def test_trainer_consumes_each_epochs_planned_batches_in_order(corpus, tmp_path,
                                                               monkeypatch, arch):
    """One loader spans the epochs; what the trainer steps on is, in order,
    the batches of three per-epoch plan_batches calls. The step itself is
    replaced by one that only records its batch."""
    _, data_dir = corpus
    if arch == "uPIT":
        data_dir = _npz_dir(str(tmp_path / "feats"))
        ds, kwargs = tdata.FeatureDataset(data_dir), {"feat_dim": "5", "hidden": "4", "num_layers": "1"}
        want_keys = {"mix", "sources", "lengths", "row_mask"}
    else:
        ds, kwargs = twav.WavDataset(data_dir), dict(TINY)
        want_keys = {"mix_wav", "source_wavs", "sample_lengths", "row_mask"}
    consumed = []
    real_wait = loop._wait_for_copy

    def recording_wait(batch):
        consumed.append(list(batch["names"]))
        return real_wait(batch)

    def recording_step(arch, model, optimizer, batch, generator):
        assert want_keys <= set(batch), sorted(batch)
        return torch.zeros(()), batch["row_mask"].sum()

    monkeypatch.setattr(loop, "_wait_for_copy", recording_wait)
    monkeypatch.setattr(loop, "update_step", recording_step)
    cfg = loop.TrainLoopConfig(arch=arch, batch_size=2, num_epochs=3, seed=5,
                               time_pad_multiple=4, on_device_features=arch == "SepFormer")
    loop.train(data_dir, str(tmp_path / "exp"), cfg, model_kwargs=kwargs, device="cpu",
               log=lambda *a: None)
    plan = tdata.BatchPlan(batch_size=2, time_pad_multiple=4, seed=5)
    want = [[ds.entries[i][0] for i in idxs] for e in range(3)
            for idxs in tdata.plan_batches(ds, plan, e, lengths=ds.num_frames)]
    assert consumed == want and len(want) == 3 * -(-len(ds) // 2)


def test_time_domain_arch_needs_waveform_input(corpus, tmp_path):
    _, data_dir = corpus
    with pytest.raises(ValueError, match="--on-device-features"):
        loop.train(data_dir, str(tmp_path / "exp"), loop.TrainLoopConfig(arch="SepFormer"),
                   device="cpu")


def test_train_sepformer_cli_then_separate(corpus):
    root, data_dir = corpus
    # one block and 32-frame chunks: the waveforms pad to 16384 samples, and
    # TINY's 8-frame chunks make 513 of them, a costly inter-chunk attention
    conf = root / "model_cli.conf"
    conf.write_text("".join(f"{k}={v}\n" for k, v in {**TINY, "chunk": 32, "blocks": 1}.items())
                    + "fused_attention=1\n")
    exp = str(root / "exp_cli")
    main(["train", "SepFormer", data_dir, exp, "--on-device-features", "--cv-data-dir",
          data_dir, "--model-config", str(conf), "--num-epochs", "5", "--batch-size", "4",
          "--device", "cpu", "--seed", "2"])
    with open(os.path.join(exp, "train_stats", "train_loss.txt")) as f:
        losses = [float(ln.split()[1]) for ln in f]
    assert len(losses) == 5 and all(np.isfinite(losses))
    with open(os.path.join(exp, "train_stats", "cv_loss.txt")) as f:
        assert [ln.split()[0] for ln in f] == ["005"]
    for name in ("intermediate_models/init.mdl", "intermediate_models/005.mdl", "final.mdl"):
        assert os.path.isfile(os.path.join(exp, name)), name

    # the arch and config come from final.state's meta
    wav = os.path.join(root, "corpus", "mix", "tr0001.wav")
    out_dir = str(root / "separated")
    main(["separate", os.path.join(exp, "final.mdl"), out_dir, wav, "--device", "cpu"])
    x, _ = load_wav(wav)
    for s in (1, 2):
        y, sr = load_wav(os.path.join(out_dir, f"tr0001_s{s}.wav"))
        assert sr == 8000 and len(y) == len(x) and np.all(np.isfinite(y))
