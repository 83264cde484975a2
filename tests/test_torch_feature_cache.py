"""The port's packed feature cache (speech_separation_tpu_torch/train/
feature_cache.py) against the JAX package's (speech_separation_tpu/train/
feature_cache.py), on one npz corpus (6 utterances of 0.3-0.5 s, 257 bins)
that the port's extractor writes once per session:

- both packers write the same ``.bin`` bytes and equal index arrays, at
  float32 and float16 (the ``.idx.npz`` zip itself need not match);
- each package reads the other's cache: records and batches equal;
- the cache's batches over an epoch bit-equal to the npz path's, the
  port's and the JAX package's, and ``train`` from the cache writes the
  npz path's loss lines;
- an f16 cache ships f16 batches, and one port uPIT step on the CPU
  upcasts them: its loss within 1e-5 relative of the JAX step's on the
  same f16 batch and weights (one forward, f32 sums in another order), and
  within 2e-3 of the f32 batch's (the JAX test's quantization envelope);
- a stale, truncated or moved cache is refused with a warning and the npz
  files are read; the train kind only; ``pack-features`` and ``extract
  --pack-cache`` through the CLI.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from speech_separation_tpu.models import upit as jupit
from speech_separation_tpu.train import data as jdata
from speech_separation_tpu.train import feature_cache as jcache
from speech_separation_tpu.train.loop import TrainLoopConfig as JaxLoopConfig
from speech_separation_tpu.train.loop import make_optimizer, make_update_step
from speech_separation_tpu_torch.cli.main import main
from speech_separation_tpu_torch.datadir.prepare import prepare_data_dir
from speech_separation_tpu_torch.datadir.registry import DatasetRegistry
from speech_separation_tpu_torch.dsp.extract import extract_features
from speech_separation_tpu_torch.models import upit as tupit
from speech_separation_tpu_torch.models.registry import get_arch
from speech_separation_tpu_torch.train import data as tdata
from speech_separation_tpu_torch.train import feature_cache as tcache
from speech_separation_tpu_torch.train.loop import (Optimizer, TrainLoopConfig, train,
                                                    update_step, upcast_features)
from speech_separation_tpu_torch.utils.synthetic import make_synthetic_corpus, write_id_list
from speech_separation_tpu_torch.utils.weights import fold_lstm_biases, state_dict_from_jax

from torch_session import built_once

torch.set_num_threads(1)  # six xdist workers share the cores: one thread each, for life

KEYS = ("mix", "sources", "lengths", "row_mask")


def quiet(*_):
    pass


def _build(root):
    ids = make_synthetic_corpus(str(root / "corpus"), 6, min_sec=0.3, max_sec=0.5, seed=3,
                                prefix="c")
    write_id_list(str(root / "id_lists"), "fc", ids)
    d = prepare_data_dir("fc", DatasetRegistry({"fc": str(root / "corpus")}),
                         data_root=str(root / "data"), id_lists_dir=str(root / "id_lists"))
    extract_features(d, "train", str(root / "feats"), log=quiet, device="cpu")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The session's npz corpus: its data dir (never packed: the tests pack
    copies of it)."""
    return str(built_once(tmp_path_factory, "torch_feature_cache", _build) / "data" / "fc")


def _copy(corpus, dst, counts=True):
    """A data dir over the corpus's npz files, for a pointer of its own."""
    os.makedirs(dst)
    for name in ("feats_train.scp",) + (("utt2num_frames", "utt2num_spk") if counts else ()):
        shutil.copy(os.path.join(corpus, name), dst)
    return dst


def _equal_batches(got, want):
    assert got["names"] == want["names"]
    for k in KEYS:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_both_packers_write_the_same_cache(corpus, tmp_path, dtype):
    paths = {}
    for name, pack in (("jax", jcache.pack_features), ("port", tcache.pack_features)):
        d = _copy(corpus, str(tmp_path / name))
        paths[name] = pack(d, "train", cache_path=str(tmp_path / f"{name}.bin"), dtype=dtype,
                           log=quiet)
        with open(tcache.pointer_path(d, "train")) as f:
            assert f.read() == paths[name] + "\n"
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    with np.load(paths["jax"] + ".idx.npz") as a, np.load(paths["port"] + ".idx.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert str(b["dtype"]) == dtype


@pytest.mark.parametrize("packer", ["jax", "port"])
def test_each_package_reads_the_others_cache(corpus, tmp_path, packer):
    d = _copy(corpus, str(tmp_path / "d"))
    pack = jcache.pack_features if packer == "jax" else tcache.pack_features
    pack(d, "train", cache_path=str(tmp_path / "c.bin"), log=quiet)
    jc, tc = jcache.FeatureCache(d), tcache.FeatureCache(d)
    npz = tdata.FeatureDataset(_copy(corpus, str(tmp_path / "npz"), counts=False), log=quiet)
    assert jc.ids == tc.ids == [u for u, _ in npz.entries]
    for i in range(len(tc)):
        np.testing.assert_array_equal(jc.record(i), tc.record(i))
        want = npz.load(i)
        got = tc.load(i)
        np.testing.assert_array_equal(got["mix"], want["mix"])
        np.testing.assert_array_equal(got["sources"], want["sources"])
    idxs = [4, 0, 2]
    _equal_batches(tc.collate(idxs, 16, 4), jc.collate(idxs, 16, 4))
    tc.close()


@pytest.mark.parametrize("bucket", [False, True], ids=["shuffled", "bucketed"])
def test_cached_batches_bit_equal_the_npz_path(corpus, tmp_path, bucket):
    """Two epochs of the port's loader from the cache against its numpy
    path and against the JAX package's loader from the same cache."""
    d = _copy(corpus, str(tmp_path / "d"))
    tcache.pack_features(d, "train", cache_path=str(tmp_path / "c.bin"), log=quiet)
    cached = tdata.FeatureDataset(d, log=quiet)
    npz = tdata.FeatureDataset(_copy(corpus, str(tmp_path / "npz"), counts=False), log=quiet)
    assert (cached.collation, npz.collation) == ("cache", "numpy")
    plan = tdata.BatchPlan(batch_size=4, time_pad_multiple=16, bucket_by_length=bucket, seed=2)
    jds = jdata.FeatureDataset(d, "train")
    assert jds.cache is not None
    jplan = jdata.BatchPlan(batch_size=4, time_pad_multiple=16, bucket_by_length=bucket, seed=2)
    for epoch in (0, 1):
        got = list(tdata.iter_batches(cached, plan, epoch))
        # the npz path's batches of the same plan (bucketing reads the
        # cache's frame counts; the npz dir has none)
        want = [tdata.make_device_batch([npz.load(i) for i in idxs], plan)
                for idxs in tdata.plan_batches(cached, plan, epoch, lengths=cached.num_frames)]
        jgot = list(jdata.iter_batches(jds, jplan, epoch))
        assert len(got) == len(want) == len(jgot) == 2
        for g, w, j in zip(got, want, jgot):
            _equal_batches(g, w)
            _equal_batches(g, j)


def test_train_from_the_cache_writes_the_npz_paths_losses(corpus, tmp_path):
    d = _copy(corpus, str(tmp_path / "d"))
    tcache.pack_features(d, "train", cache_path=str(tmp_path / "c.bin"), log=quiet)
    npz = _copy(corpus, str(tmp_path / "npz"), counts=False)
    cfg = TrainLoopConfig(batch_size=4, num_epochs=2, time_pad_multiple=16, seed=1,
                          make_plots=False)
    kw = {"hidden": "8", "num_layers": "1"}
    runs = {name: train(data, str(tmp_path / f"exp_{name}"), cfg, model_kwargs=kw,
                        device="cpu", log=quiet) for name, data in (("cache", d), ("npz", npz))}
    assert runs["cache"]["collation"] == "cache" and runs["npz"]["collation"] == "numpy"
    assert runs["cache"]["epoch_losses"] == runs["npz"]["epoch_losses"]
    assert runs["cache"]["h2d_bytes"] == runs["npz"]["h2d_bytes"]


def test_f16_cache_ships_f16_and_the_step_upcasts(corpus, tmp_path):
    d32 = _copy(corpus, str(tmp_path / "d32"))
    d16 = _copy(corpus, str(tmp_path / "d16"))
    tcache.pack_features(d32, "train", cache_path=str(tmp_path / "c32.bin"), log=quiet)
    tcache.pack_features(d16, "train", cache_path=str(tmp_path / "c16.bin"), dtype="float16",
                         log=quiet)
    plan = tdata.BatchPlan(batch_size=6, time_pad_multiple=16)
    (b32,) = tdata.iter_batches(tdata.FeatureDataset(d32, log=quiet), plan, 0)
    (b16,) = tdata.iter_batches(tdata.FeatureDataset(d16, log=quiet), plan, 0)
    assert b32["mix"].dtype == np.float32
    assert b16["mix"].dtype == b16["sources"].dtype == np.float16
    scale = np.abs(b32["mix"]).max()
    assert np.abs(b16["mix"].astype(np.float32) - b32["mix"]).max() <= 1e-3 * scale

    cfg = jupit.Config(hidden=8, num_layers=1, zero_init_hidden=True)
    params, state = jupit.init(jax.random.PRNGKey(0), cfg)
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params),
                             jax.tree_util.tree_map(np.asarray, state))
    jopt = make_optimizer(JaxLoopConfig())
    jstep = make_update_step(jupit, cfg, jopt)

    def port_loss(b):
        model = tupit.UPIT(tupit.Config(hidden=8, num_layers=1, zero_init_hidden=True))
        model.load_state_dict(sd)
        fold_lstm_biases(model.blstm)
        batch = upcast_features({k: torch.from_numpy(b[k]) for k in KEYS})
        assert batch["mix"].dtype == torch.float32
        loss, _ = update_step(get_arch("uPIT"), model, Optimizer(model.parameters(),
                                                                 TrainLoopConfig()),
                              batch, torch.Generator().manual_seed(0))
        return float(loss)

    p, s = jupit.init(jax.random.PRNGKey(0), cfg)        # the step donates its buffers
    *_, jloss, _ = jstep(p, s, jopt.init(p), {k: b16[k] for k in KEYS}, jax.random.PRNGKey(1))
    l16, l32 = port_loss(b16), port_loss(b32)
    np.testing.assert_allclose(l16, float(jloss), rtol=1e-5)
    assert abs(l16 - l32) <= 2e-3 * abs(l32)


@pytest.mark.parametrize("fault", ["stale", "truncated", "moved"])
def test_an_unusable_cache_is_refused_with_a_warning(corpus, tmp_path, fault):
    d = _copy(corpus, str(tmp_path / "d"))
    bin_path = tcache.pack_features(d, "train", cache_path=str(tmp_path / "c.bin"), log=quiet)
    if fault == "stale":         # the utterance list changed since packing
        with open(os.path.join(d, "feats_train.scp")) as f:
            lines = f.readlines()
        with open(os.path.join(d, "feats_train.scp"), "w") as f:
            f.writelines(lines[:-1])
        match = "stale"
    elif fault == "truncated":
        with open(bin_path, "r+b") as f:
            f.truncate(os.path.getsize(bin_path) - 4)
        match = "truncated"
    else:
        os.rename(bin_path, bin_path + ".elsewhere")
        match = "unusable"
    with pytest.warns(UserWarning, match=match):
        assert tcache.open_cache(d, "train") is None
    with pytest.warns(UserWarning, match=match):
        ds = tdata.FeatureDataset(d, log=quiet)
    assert ds.cache is None and ds.collation == "native"


@pytest.mark.parametrize("kind,dtype", [("test", "float32"), ("train", "float64")])
def test_train_kind_and_two_dtypes_only(corpus, kind, dtype):
    with pytest.raises(ValueError, match="kind='train' only" if kind == "test" else "dtype"):
        tcache.pack_features(corpus, kind, dtype=dtype, log=quiet)
    assert not os.path.exists(tcache.pointer_path(corpus, kind))


def test_cli_pack_features_and_extract_pack_cache(corpus, tmp_path):
    d = _copy(corpus, str(tmp_path / "d"))
    main(["pack-features", d, "train", "--dtype", "float16", "--cache-path",
          str(tmp_path / "p.bin")])
    assert tcache.FeatureCache(d).dtype == np.float16
    # extract --pack-cache re-extracts a dir's features and packs them
    wav_dir = str(tmp_path / "w")
    os.makedirs(wav_dir)
    shutil.copy(os.path.join(corpus, "wav.scp"), wav_dir)
    main(["extract", wav_dir, "train", str(tmp_path / "feats"), "--pack-cache",
          "--cache-dtype", "float16", "--device", "cpu"])
    cache = tcache.FeatureCache(wav_dir)
    assert cache.dtype == np.float16 and len(cache) == 6
    assert cache.bin_path == str(tmp_path / "feats" / "feats_train.cache.bin")
    assert tdata.FeatureDataset(wav_dir, log=quiet).collation == "cache"
