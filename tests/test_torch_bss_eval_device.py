"""The port's batched float64 scorer (speech_separation_tpu_torch/eval/
bss_eval_device.py) on the CPU against the JAX package's host f64 scorer
(speech_separation_tpu/eval/bss_eval.py), and the port's
``evaluate_sources(device_scoring=True)`` against the host path.

It is held to the host scorer, not to the JAX device scorer
(eval/bss_eval_jax.py), which is 5.6 dB off in SIR on the e2e corpus below
(tests/test_e2e.py::test_evaluate_sources_device_matches_host).

Tolerances:
- every SDR/SIR/SAR within 1e-8 dB of the host's on seeded AR(0.95)
  material (n = 1, 2, 3 sources; flen 512 and 64; with and without the
  permutation, which must be the host's): both are float64 with the same
  decomposition, the sums in another order (the readings are ~1e-13 dB);
- int16 PCM against the same samples as float k/32768: bit-identical (a
  power-of-two scale is exact in float64); a zero-padded batch against each
  utterance alone at its exact length within 1e-8 dB (the scorer cuts each
  sub-batch to its longest signal, so the transforms match; the batched
  products and LU sum in another order, ~4e-13 dB);
- an all-zero reference source and two identical sources go through the
  trust gate's host fallback and equal the host exactly (at flen 64: the
  host's least-squares fallback on a singular 1024 x 1024 Gram costs
  seconds alone and minutes beside other test workers, and the gate does
  not depend on flen);
- scoring on the CPU after a change of torch's thread count finishes
  (PyTorch's batched CPU LU can hang there);
- on the e2e corpus (make_synthetic_corpus(seed=1), 4 utterances, the
  noisy remixes of tests/test_e2e.py): every SDR/SIR/SAR row within 1e-6
  dB of the host path, SI-SDR and SI-SDRi within 1e-9, the same row order.
"""

import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from speech_separation_tpu.datadir import DatasetRegistry, prepare_data_dir
from speech_separation_tpu.eval.bss_eval import bss_eval_sources as jax_host
from speech_separation_tpu.eval.score import evaluate_sources as jax_evaluate
from speech_separation_tpu.utils.synthetic import make_synthetic_corpus, write_id_list
from speech_separation_tpu_torch.datadir.scp import read_scp
from speech_separation_tpu_torch.eval import bss_eval_device as bd
from speech_separation_tpu_torch.eval.score import evaluate_sources
from speech_separation_tpu_torch.utils.audio import load_wav, write_wav_int16

torch.set_num_threads(1)  # six xdist workers share the cores: one thread each, for life

METRIC_DB = 1e-8
E2E_DB = 1e-6
SI_DB = 1e-9
LENGTHS = (3000, 2600, 2231)


def ar_mixture(n: int, seed: int, lengths=LENGTHS):
    """(refs, ests) zero-padded (B, n, max L) and the exact lengths: AR(0.95)
    sources, estimates a random remix of them (reversed, so the permutation
    search has work) plus noise."""
    rng = np.random.default_rng(seed)
    B, L = len(lengths), max(lengths)
    refs, ests = np.zeros((B, n, L)), np.zeros((B, n, L))
    for b, Lb in enumerate(lengths):
        w = rng.standard_normal((n, Lb))
        s = np.zeros((n, Lb))
        for t in range(Lb):
            s[:, t] = 0.95 * (s[:, t - 1] if t else 0) + w[:, t]
        mix = np.eye(n) + 0.3 * rng.standard_normal((n, n))
        refs[b, :, :Lb] = s
        ests[b, :, :Lb] = (mix @ s + 0.05 * rng.standard_normal((n, Lb)))[::-1]
    return refs, ests, lengths


@pytest.mark.parametrize("perm", [True, False], ids=["perm", "identity"])
@pytest.mark.parametrize("flen", [512, 64])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_matches_the_host_scorer(n, flen, perm):
    refs, ests, lengths = ar_mixture(n, seed=10 * n + flen % 7)
    stats = {}
    got = bd.bss_eval_sources_batch(refs, ests, perm, flen=flen, max_batch=2, device="cpu",
                                    stats=stats)
    assert stats["fallbacks"] == 0, stats
    assert stats["gate_db_max"] < bd.GATE_DB
    for b, Lb in enumerate(lengths):
        want = jax_host(refs[b, :, :Lb], ests[b, :, :Lb], perm, flen)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_allclose(g[b], w, rtol=0, atol=METRIC_DB)
        np.testing.assert_array_equal(got[3][b], want[3])


def test_padding_and_int16_transport():
    refs, ests, lengths = ar_mixture(2, seed=5)
    scale = 0.5 / max(np.abs(refs).max(), np.abs(ests).max())
    pcm_refs = np.rint(refs * scale * 32768).astype(np.int16)
    pcm_ests = np.rint(ests * scale * 32768).astype(np.int16)
    padded = np.zeros((3, 2, 5000), np.int16), np.zeros((3, 2, 5000), np.int16)
    padded[0][:, :, :3000], padded[1][:, :, :3000] = pcm_refs, pcm_ests
    as_int16 = bd.bss_eval_sources_batch(*padded, device="cpu")
    as_float = bd.bss_eval_sources_batch(pcm_refs / 32768.0, pcm_ests / 32768.0, device="cpu")
    for b, Lb in enumerate(lengths):
        alone = bd.bss_eval_sources_batch(pcm_refs[b:b + 1, :, :Lb] / 32768.0,
                                          pcm_ests[b:b + 1, :, :Lb] / 32768.0, device="cpu")
        for x, y, z in zip(as_int16, as_float, alone):
            np.testing.assert_array_equal(x[b], y[b])
            np.testing.assert_allclose(y[b], z[0], rtol=0, atol=METRIC_DB)


@pytest.mark.parametrize("case", ["zero_reference", "identical_sources"])
def test_degenerate_grams_fall_back_to_the_host(case):
    rng = np.random.default_rng(7)
    s = rng.standard_normal((2, 1500))
    refs = np.stack([s[0], np.zeros(1500) if case == "zero_reference" else s[0]])
    ests = s + 0.1 * rng.standard_normal((2, 1500))
    # the host cannot choose a permutation with a silent source (every
    # mean SIR is -inf), so that case scores the identity pairing
    perm = case != "zero_reference"
    stats = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = bd.bss_eval_sources_batch(refs[None], ests[None], perm, flen=64, device="cpu",
                                        stats=stats)
        want = jax_host(refs, ests, perm, 64)
    assert stats["fallbacks"] == 1 and stats["reasons"][0][0] == 0, stats
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w)


def test_cpu_scoring_after_a_thread_count_change():
    """PyTorch's batched CPU LU (MKL) can hang once torch.set_num_threads has
    changed the intra-op thread count, as the port's other test modules do
    (one thread, then restored); the scorer factors one matrix at a time on
    the CPU. In a process of its own, so that a hang fails by its timeout."""
    code = ("import numpy as np, torch\n"
            "from speech_separation_tpu_torch.eval.bss_eval_device import "
            "bss_eval_sources_batch\n"
            "n = torch.get_num_threads()\n"
            "torch.set_num_threads(1)\n"
            "torch.ones(64, 64) @ torch.ones(64, 64)\n"
            "torch.set_num_threads(max(n, 2))\n"
            "rng = np.random.default_rng(0)\n"
            "s = rng.standard_normal((4, 2, 3000))\n"
            "sdr = bss_eval_sources_batch(s, s + 0.1 * rng.standard_normal(s.shape), "
            "device='cpu')[0]\n"
            "assert np.all(np.isfinite(sdr)), sdr\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=repo)


def test_batch_size_follows_the_working_set():
    small = bd.bytes_per_utterance(2, 40000)
    assert small == 8 * (6 * 4 + 8) * 65536 + 24 * 1024 ** 2
    assert bd.bytes_per_utterance(3, 40000) > small
    assert bd.default_max_batch(2, 40000) == (1 << 30) // small
    assert bd.default_max_batch(1, 100) == 64


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """tests/test_e2e.py's corpus and its noisy-remix estimates."""
    root = tmp_path_factory.mktemp("bss_device")
    corpus = str(root / "corpus" / "tt")
    ids = make_synthetic_corpus(corpus, 4, seed=1, prefix="tt")
    write_id_list(str(root / "id_lists"), "toy_tt", ids)
    tt = prepare_data_dir("toy_tt", DatasetRegistry({"toy_tt": corpus}),
                          data_root=str(root / "data"), id_lists_dir=str(root / "id_lists"))
    entries = read_scp(os.path.join(tt, "wav.scp"))
    with open(os.path.join(tt, "utt2num_spk"), "w") as f:
        f.writelines(f"{utt} 2\n" for utt, _ in entries)
    rng = np.random.default_rng(3)
    exp = str(root / "exp")
    for utt, mix_path in entries:
        srcs = [load_wav(mix_path.replace("/mix/", f"/s{s}/"))[0] for s in (1, 2)]
        L = min(len(s) for s in srcs)
        for s in (0, 1):
            est = (0.9 * srcs[s][:L] + 0.1 * srcs[1 - s][:L]
                   + 0.01 * rng.standard_normal(L).astype(np.float32))
            path = os.path.join(exp, "wav", f"s{s + 1}", utt + ".wav")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            write_wav_int16(path, 8000, est)
    return tt, exp


def _rows(exp, name):
    with open(os.path.join(exp, "results", f"source_{name}s.txt")) as f:
        return [(ln.split()[0], np.array(ln.split()[1:], float)) for ln in f]


def test_evaluate_sources_on_the_device_path_matches_the_host(e2e):
    tt, exp = e2e
    jax_evaluate(tt, exp)                            # the JAX package's host f64 path
    host = {m: _rows(exp, m) for m in ("SDR", "SIR", "SAR", "SI-SDR", "SI-SDRi")}
    lines = []
    means = evaluate_sources(tt, exp, device_scoring=True, device="cpu", log=lines.append)
    assert any(ln.startswith("device scoring anatomy:") for ln in lines), lines
    for m, tol in (("SDR", E2E_DB), ("SIR", E2E_DB), ("SAR", E2E_DB),
                   ("SI-SDR", SI_DB), ("SI-SDRi", SI_DB)):
        got = _rows(exp, m)
        assert [u for u, _ in got] == [u for u, _ in host[m]]
        for (_, g), (_, w) in zip(got, host[m]):
            np.testing.assert_allclose(g, w, rtol=0, atol=tol)
        assert abs(means[m] - np.mean(np.concatenate([w for _, w in host[m]]))) < tol
    import json
    with open(os.path.join(exp, "results", "summary.json")) as f:
        summary = json.load(f)
    assert summary["scorer"] == "device-f64" and summary["host_fallbacks"] == 0
    assert summary["n_utts"] == 4


def test_cli_score_device_scoring(e2e, capsys):
    from speech_separation_tpu_torch.cli.main import main
    tt, exp = e2e
    main(["score", tt, exp, "--nj", "2"])
    host = _rows(exp, "SDR")
    main(["score", tt, exp, "--device-scoring", "--device", "cpu"])
    for (u, g), (v, w) in zip(_rows(exp, "SDR"), host):
        assert u == v
        np.testing.assert_allclose(g, w, rtol=0, atol=E2E_DB)
    device_rows = _rows(exp, "SDR")
    # --data-parallel with one device (the CPU): the JAX package's note, and
    # the rows of the run without it
    capsys.readouterr()
    main(["score", tt, exp, "--device-scoring", "--data-parallel", "--device", "cpu"])
    assert "note: --data-parallel with one visible device" in capsys.readouterr().out
    for (u, g), (v, w) in zip(_rows(exp, "SDR"), device_rows, strict=True):
        assert u == v and np.array_equal(g, w)
