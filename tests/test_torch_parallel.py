"""Data-parallel separation and scoring of the port on the CPU
(parallel/mesh.py, SeparationPipeline(mesh=...), the server over it, the
device scorer and the oracle over a mesh, the CLI's --data-parallel), with
two-entry meshes of the CPU against the single-device runs, as the JAX
package's tests/test_multichip_serve.py and test_multichip_score.py hold
its 8-device mesh; and the mesh helpers against the JAX package's.

Tolerances: separated tracks within 1e-5 (the JAX test's bound; the
replicas run the same per-row arithmetic on fewer rows); BSS-eval rows
within 1e-9 dB (float64 on each part, the same per-utterance sums).
"""

import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax

from speech_separation_tpu.datadir import DatasetRegistry, prepare_data_dir
from speech_separation_tpu.parallel.mesh import make_mesh as jax_mesh
from speech_separation_tpu.parallel.mesh import shard_batch as jax_shard
from speech_separation_tpu.utils.synthetic import make_synthetic_corpus_var, write_id_list
from speech_separation_tpu_torch.cli.main import main
from speech_separation_tpu_torch.eval.bss_eval_device import bss_eval_sources_batch
from speech_separation_tpu_torch.eval.oracle import evaluate_oracle
from speech_separation_tpu_torch.eval.pipeline import SeparationPipeline
from speech_separation_tpu_torch.eval.serve import SeparationServer, request
from speech_separation_tpu_torch.models import upit
from speech_separation_tpu_torch.parallel import mesh as pmesh
from speech_separation_tpu_torch.parallel.mesh import (data_parallel_mesh, make_mesh,
                                                       pad_rows, replicate_module,
                                                       run_replicas, shard_batch)
from speech_separation_tpu_torch.parallel.ranks import Ranks, rows_of
from speech_separation_tpu_torch.train.checkpoint import save_checkpoint
from speech_separation_tpu_torch.train.data import BatchPlan, FeatureDataset, collate
from speech_separation_tpu_torch.train.feature_cache import pack_features
from speech_separation_tpu_torch.train.wav_data import WavDataset, collate_wav_batch
from speech_separation_tpu_torch.utils.audio import load_wav, write_wav_int16

from test_torch_feature_cache import _build as _build_fc
from test_torch_feature_cache import _copy as _copy_fc
from torch_session import built_once

torch.set_num_threads(1)  # six xdist workers share the cores: one thread each, for life

SR = 8000
TRACK_TOL = 1e-5
SCORE_DB = 1e-9
CPU2 = make_mesh(devices=["cpu", "cpu"])


# ------------------------------------------------------------------- mesh

def _batch(B=5):
    rng = np.random.default_rng(0)
    return {"mix": rng.standard_normal((B, 6, 3)).astype(np.float32),
            "lengths": rng.integers(1, 7, size=B).astype(np.int32),
            "row_mask": np.ones((B,), np.float32)}


def test_rows_pad_to_the_mesh_with_the_jax_note(monkeypatch, capsys):
    monkeypatch.setattr(pmesh, "_pad_warned", False)
    parts = shard_batch(_batch(5), CPU2)
    assert "note: batch rows 5 padded to 6 to shard over 2 data-parallel devices" \
        in capsys.readouterr().out
    assert [p["mix"].shape[0] for p in parts] == [3, 3]
    np.testing.assert_array_equal(parts[1]["row_mask"], [1, 1, 0])
    assert not parts[1]["mix"][2].any() and parts[1]["lengths"][2] == 0
    # the JAX package's padding of the same batch, over its 8 devices
    want = {k: np.asarray(v) for k, v in jax_shard(_batch(5), jax_mesh()).items()}
    got = pad_rows(_batch(5), 8)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_arrays_that_are_not_the_batch_are_replicated():
    table = np.arange(7.0)
    parts = shard_batch({**_batch(4), "table": table, "names": ["a"] * 4}, CPU2)
    for p in parts:
        assert p["table"] is table and p["names"] == ["a"] * 4
        assert p["mix"].shape[0] == 2
    # tensors stay tensors, rows in order
    t = shard_batch({"row_mask": torch.ones(3), "x": torch.arange(3.0)}, CPU2)
    assert [p["x"].tolist() for p in t] == [[0.0, 1.0], [2.0, 0.0]]


def test_one_visible_device_gives_no_mesh_with_the_note():
    said = []
    assert data_parallel_mesh(said.append) is None
    assert data_parallel_mesh(said.append, device="cpu") is None
    assert said == ["note: --data-parallel with one visible device; running "
                    "single-device"] * 2


def test_tensor_parallel_meshes_are_refused():
    """Once a refusal of model > 1; now the (data, model) mesh as the JAX
    package's make_mesh lays it out: row-major (devices.reshape(data,
    model)), data defaulting to what fills the list, and each rank's model
    and data groups. Only an axis that does not fit is refused."""
    mesh = make_mesh(data=2, model=2, devices=["cpu"] * 4)
    assert mesh.shape == {"data": 2, "model": 2} and mesh.size == 4
    coords = [(r.data_index, r.model_index) for r in
              (Ranks(k, mesh.size, mesh.devices[k], mesh.shape["model"]) for k in range(4))]
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert mesh.model_groups() == [[0, 1], [2, 3]]       # same rows
    assert mesh.data_groups() == [[0, 2], [1, 3]]        # same shards
    jm = jax_mesh(data=2, model=2, devices=jax.devices()[:4])
    assert [[d.id for d in row] for row in jm.devices] == [[0, 1], [2, 3]]
    assert make_mesh(model=2, devices=["cpu"] * 5).shape == {"data": 2, "model": 2}
    assert make_mesh(model=4, devices=["cpu"] * 4).shape == {"data": 1, "model": 4}
    with pytest.raises(ValueError):
        make_mesh(data=3, model=2, devices=["cpu"] * 4)
    assert make_mesh(devices=["cpu"] * 3).shape == {"data": 3, "model": 1}
    assert make_mesh(data=2, devices=["cpu"] * 3).size == 2


def test_replicas_on_one_device_share_a_copy_and_run_in_turn():
    m = torch.nn.Linear(2, 2)
    assert replicate_module(m, CPU2) == [m, m]
    seen = []
    assert run_replicas(CPU2, lambda i: seen.append(threading.get_ident()) or i * 10) == [0, 10]
    assert seen == [threading.get_ident()] * 2          # in turn, on the caller's thread
    with pytest.raises(ValueError, match="boom"):
        run_replicas(CPU2, lambda i: (_ for _ in ()).throw(ValueError("boom")))


@pytest.fixture(scope="module")
def fc_corpus(tmp_path_factory):
    """tests/test_torch_feature_cache.py's npz corpus (6 utterances)."""
    return str(built_once(tmp_path_factory, "torch_feature_cache", _build_fc) / "data" / "fc")


@pytest.mark.parametrize("collation", ["numpy", "native", "cache", "wav"])
def test_each_rank_collates_its_rows_of_the_whole_batch(fc_corpus, tmp_path, collation):
    """A rank's share of a batch of 3 utterances in 5 rows (padded to 6,
    3 a rank), through each collation: its rows of the whole batch, at the
    whole batch's T and source count, with its names and the whole batch's
    real-row count."""
    d = _copy_fc(fc_corpus, str(tmp_path / "d"), counts=collation != "numpy")
    idxs = [4, 0, 2]
    if collation == "wav":
        shutil.copy(os.path.join(fc_corpus, "wav.scp"), d)
        whole = collate_wav_batch(WavDataset(d), idxs, 5)
    else:
        if collation == "cache":
            pack_features(d, "train", cache_path=str(tmp_path / "c.bin"), log=lambda *_: None)
        ds = FeatureDataset(d, log=lambda *_: None)
        assert ds.collation == collation
        whole = collate(ds, idxs, BatchPlan(batch_size=5, time_pad_multiple=8))
    parts = [rows_of(whole, Ranks(r, 2, torch.device("cpu"))) for r in (0, 1)]
    names = whole["names"] + [""] * 3
    for r, got in enumerate(parts):
        assert got["n_real"] == 3 and got["names"] == names[3 * r:3 * r + 3][:len(got["names"])]
        for k, v in whole.items():
            if k != "names":
                want = np.concatenate([v, np.zeros((1,) + v.shape[1:], v.dtype)])[3 * r:3 * r + 3]
                assert got[k].dtype == v.dtype and got[k].shape == want.shape, k
                np.testing.assert_array_equal(got[k], want, err_msg=k)


# --------------------------------------------------------------- pipeline

KW = {"hidden": "16", "num_layers": "1"}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_serve")
    model = upit.UPIT(upit.Config(hidden=16, num_layers=1))
    model.reset_parameters(torch.Generator().manual_seed(0))
    path = str(root / "model.mdl")
    save_checkpoint(path, model, meta={"arch": "uPIT", "model_kwargs": KW})
    rng = np.random.default_rng(11)
    sigs = [rng.standard_normal(n).astype(np.float32) * 0.05
            for n in (7000, 5000, 3210, 9000, 4000)]
    wavs = []
    for k, x in enumerate(sigs):
        wavs.append(str(root / f"in{k}.wav"))
        write_wav_int16(wavs[-1], SR, x)
    return {"root": root, "model": path, "sigs": sigs, "wavs": wavs}


def _pipe(m, mesh=None, batch_size=8, **kw):
    return SeparationPipeline(m["model"], model_kwargs={**KW, **kw}, batch_size=batch_size,
                              length_quantum=4096, device="cpu", mesh=mesh)


def _same(a, b):
    assert len(a) == len(b)
    for ts, td in zip(a, b):
        assert len(ts) == len(td) == 2
        for x, y in zip(ts, td):
            assert x.shape == y.shape
            np.testing.assert_allclose(x, y, atol=TRACK_TOL, rtol=TRACK_TOL)


@pytest.mark.parametrize("init", ["zero", "random"])
def test_two_replicas_separate_as_one_device(served, init):
    """Zero initial states (the JAX test's case), and the reference's N(0, 1)
    draw: drawn for the whole padded batch and split, so each row's tracks
    are those of the single-device pipeline serving padded batches."""
    kw = {"zero_init_hidden": "1"} if init == "zero" else {}
    dp = _pipe(served, CPU2, **kw)
    assert dp.mesh is CPU2 and len(dp.replicas) == 2
    single = _pipe(served, **kw)
    n = len(served["sigs"])
    want = [None] * n
    for i, t in single.separate_stream(served["sigs"].__getitem__,
                                       [len(s) for s in served["sigs"]], pad_batches=True):
        want[i] = t
    _same(dp.separate(served["sigs"]), want)


def test_batch_size_rounds_up_and_one_entry_degenerates(served, capsys):
    dp = _pipe(served, CPU2, batch_size=15)
    assert dp.batch_size == 16
    assert "note: pipeline batch_size 15 -> 16 (must divide over 2 data-parallel devices)" \
        in capsys.readouterr().out
    assert _pipe(served, make_mesh(devices=["cpu"]), batch_size=5).mesh is None


def test_server_over_the_data_parallel_pipeline(served, tmp_path):
    dp = _pipe(served, CPU2, zero_init_hidden="1")
    sock = str(tmp_path / "dp.sock")
    server = SeparationServer(dp, sock, coalesce=8)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    deadline = time.monotonic() + 30
    while not os.path.exists(sock):
        assert time.monotonic() < deadline, "server never bound its socket"
        time.sleep(0.02)
    try:
        r = request(sock, {"wavs": served["wavs"][:2], "out_dir": str(tmp_path / "out")})
        assert r["ok"], r
        single = _pipe(served, zero_init_hidden="1")
        ref = single.separate([load_wav(w)[0] for w in served["wavs"][:2]])
        for k, wav in enumerate(served["wavs"][:2]):
            for s, path in enumerate(r["outputs"][wav]):
                ref_path = str(tmp_path / f"ref_{k}_{s}.wav")
                write_wav_int16(ref_path, SR, ref[k][s])
                got, want = (wavfile.read(p)[1].astype(np.int32) for p in (path, ref_path))
                # identical up to the int16 rounding of ~1e-6 differences
                assert got.shape == want.shape and np.max(np.abs(got - want)) <= 1
    finally:
        server.shutdown()
        t.join(10)


@pytest.mark.parametrize("argv", [
    ["separate", "m", "o", "a.wav"], ["serve", "m", "s.sock"],
    ["score", "d", "e", "--device-scoring"], ["oracle", "d", "--device-scoring"],
    ["run-eval", "--model-dir", "x", "--test-sets", "y", "--on-device-features"],
], ids=lambda a: a[0])
def test_every_command_takes_the_one_device_path_with_the_note(argv, capsys):
    """Each of the five commands' --data-parallel gives no mesh on one
    device (here the CPU), with the JAX package's note: the run is the
    single-device one."""
    from speech_separation_tpu_torch.cli.main import _data_mesh, build_parser
    args = build_parser().parse_args(argv + ["--data-parallel", "--device", "cpu"])
    assert _data_mesh(args) is None
    assert capsys.readouterr().out == ("note: --data-parallel with one visible device; "
                                       "running single-device\n")
    assert _data_mesh(build_parser().parse_args(argv + ["--device", "cpu"])) is None
    assert capsys.readouterr().out == ""


def test_separate_data_parallel_on_one_device(served, tmp_path, capsys):
    """--data-parallel with one device: the JAX package's note, and wavs
    bit-identical to the run without it."""
    for tag, extra in (("plain", []), ("dp", ["--data-parallel"])):
        main(["separate", served["model"], str(tmp_path / tag), *served["wavs"][:3],
              "--device", "cpu", *extra])
    assert "note: --data-parallel with one visible device; running single-device" \
        in capsys.readouterr().out
    names = sorted(os.listdir(tmp_path / "plain"))
    assert names == sorted(os.listdir(tmp_path / "dp")) and len(names) == 6
    for n in names:
        assert (tmp_path / "plain" / n).read_bytes() == (tmp_path / "dp" / n).read_bytes()


# ---------------------------------------------------------------- scoring

def _cases(B=5, n=2, L=4000, seed=3):
    """tests/test_multichip_score.py's AR(0.9) cases."""
    rng = np.random.default_rng(seed)
    refs = np.zeros((B, n, L), np.float32)
    ests = np.zeros((B, n, L), np.float32)
    for b in range(B):
        e = rng.standard_normal((n, L)).astype(np.float32)
        s = np.copy(e)
        for t in range(1, L):
            s[:, t] += 0.9 * s[:, t - 1]
        refs[b] = s * 0.05
        mix = 0.6 * s[0] + 0.4 * s[1]
        ests[b, 0] = 0.8 * s[0] + 0.2 * mix
        ests[b, 1] = 0.8 * s[1] + 0.2 * mix
    return refs, ests


@pytest.mark.parametrize("max_batch", [None, 1])
def test_device_scoring_over_a_mesh_equals_one_device(max_batch):
    refs, ests = _cases(B=5)
    one = bss_eval_sources_batch(refs, ests, max_batch=max_batch, device="cpu")
    stats = {}
    two = bss_eval_sources_batch(refs, ests, max_batch=max_batch, mesh=CPU2, stats=stats)
    np.testing.assert_array_equal(one[3], two[3])
    for a, b in zip(one[:3], two[:3]):
        assert a.shape == b.shape == (5, 2) and np.all(np.isfinite(a))
        np.testing.assert_allclose(b, a, rtol=0, atol=SCORE_DB)
    assert stats["fallbacks"] == 0 and stats["reasons"] == []


@pytest.fixture(scope="module")
def oracle_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_oracle")
    corpus = str(root / "corpus")
    ids = make_synthetic_corpus_var(corpus, 5, seed=4, prefix="dp", counts=(2, 3))
    write_id_list(str(root / "id_lists"), "toy", ids)
    return prepare_data_dir("toy", DatasetRegistry({"toy": corpus}),
                            data_root=str(root / "data"), id_lists_dir=str(root / "id_lists"))


def test_score_over_a_mesh_equals_one_device(oracle_dir, tmp_path):
    """evaluate_sources --device-scoring with a two-entry mesh: every row of
    every metric within SCORE_DB of the one-device run's."""
    from speech_separation_tpu_torch.datadir.scp import read_scp, source_wavs_for_mix
    from speech_separation_tpu_torch.eval.score import evaluate_sources
    rng = np.random.default_rng(5)
    exp = str(tmp_path / "exp")
    with open(os.path.join(oracle_dir, "utt2num_spk"), "w") as f:
        for utt, mix in read_scp(os.path.join(oracle_dir, "wav.scp")):
            srcs = [load_wav(w)[0] for w in source_wavs_for_mix(mix)[1:]]
            f.write(f"{utt} {len(srcs)}\n")
            for k, x in enumerate(srcs):
                est = 0.9 * x + 0.1 * srcs[k - 1] + 0.01 * rng.standard_normal(len(x))
                os.makedirs(os.path.join(exp, "wav", f"s{k + 1}"), exist_ok=True)
                write_wav_int16(os.path.join(exp, "wav", f"s{k + 1}", utt + ".wav"), SR,
                                est.astype(np.float32))
    rows = {}
    for tag, mesh in (("one", None), ("two", CPU2)):
        evaluate_sources(oracle_dir, exp, device_scoring=True, device="cpu", mesh=mesh,
                         log=lambda *_: None)
        for m in ("SDR", "SIR", "SAR", "SI-SDR"):
            with open(os.path.join(exp, "results", f"source_{m}s.txt")) as f:
                rows[tag, m] = [np.array(ln.split()[1:], float) for ln in f]
    for m in ("SDR", "SIR", "SAR", "SI-SDR"):
        assert len(rows["two", m]) == 5
        for got, want in zip(rows["two", m], rows["one", m], strict=True):
            np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_DB, err_msg=m)


def _source_rows(data_dir):
    with open(os.path.join(data_dir, "oracle_soft_mask_eval", "source_SDRs.txt")) as f:
        return {ln.split()[0]: np.array(ln.split()[1:], float) for ln in f}


def test_oracle_scoring_over_a_mesh_equals_one_device(oracle_dir):
    """Slabs of 2 and 3 sources, each split over the two entries."""
    evaluate_oracle(oracle_dir, device_scoring=True, device="cpu", log=lambda *_: None)
    one = _source_rows(oracle_dir)
    evaluate_oracle(oracle_dir, device_scoring=True, device="cpu", mesh=CPU2,
                    log=lambda *_: None)
    two = _source_rows(oracle_dir)
    assert sorted(one) == sorted(two) and len(one) == 5
    for utt, want in one.items():
        np.testing.assert_allclose(two[utt], want, rtol=0, atol=SCORE_DB, err_msg=utt)
