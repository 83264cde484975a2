"""The port's oracle-mask evaluation (speech_separation_tpu_torch/eval/
oracle.py and the ``oracle`` subcommand) against the JAX package's
evaluate_oracle on the CPU: soft and hard masks on a corpus of 1-3
speakers (make_synthetic_corpus_var), with and without a ``segments``
file; ``--nj 2`` through the CLI against the single run; the port's
``--device-scoring`` rows against its host rows.

Tolerances:
- every SDR/SIR/SAR row within 1e-3 dB of the JAX package's (soft and hard
  masks): the STFTs differ by float32 rounding (the JAX package's Pallas
  kernel in interpret mode against the port's plain product, ~1e-6 of
  max |X|), which moves a soft mask's estimate by as much and the dB values
  by far less than 1e-3. A hard mask can flip where two sources' magnitudes
  tie within that rounding; the synthetic voices are spectrally disjoint,
  so no bin of this corpus comes near a tie, and the hard rows hold the
  same bound (readings: soft 2.6e-6 to 3.8e-6 dB, hard 2.1e-6 to 3.6e-6);
- except a one-speaker row whose SDR and SAR lie above 100 dB: there the
  soft mask is exactly 1 and the hard mask all ones, so the "error" is the
  float32 STFT round trip's own rounding, and its dB value is that rounding
  (two float32 STFTs read 130.577 and 130.596 dB on one segment). Such rows
  are held to lie above that noise floor, 100 dB, on both sides; the
  one-speaker rows' SIR is +inf in both (no interference);
- ``--nj 2`` merged against the single run: identical rows;
- the port's device-scoring rows against its host rows: within 1e-6 dB.
"""

import os

import numpy as np
import pytest
import torch

from speech_separation_tpu.datadir import DatasetRegistry, prepare_data_dir
from speech_separation_tpu.eval.oracle import evaluate_oracle as jax_oracle
from speech_separation_tpu.eval.oracle import merge_oracle_shards as jax_merge
from speech_separation_tpu.utils.synthetic import make_synthetic_corpus_var, write_id_list
from speech_separation_tpu_torch.cli.main import main
from speech_separation_tpu_torch.eval.oracle import evaluate_oracle, merge_oracle_shards

torch.set_num_threads(1)  # six xdist workers share the cores: one thread each, for life

JAX_DB = 1e-3
DEVICE_DB = 1e-6


def quiet(*_):
    pass


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_oracle")
    corpus = str(root / "corpus")
    ids = make_synthetic_corpus_var(corpus, 6, seed=4, prefix="or", counts=(1, 2, 3))
    write_id_list(str(root / "id_lists"), "toy", ids)
    return prepare_data_dir("toy", DatasetRegistry({"toy": corpus}),
                            data_root=str(root / "data"), id_lists_dir=str(root / "id_lists"))


def _rows(data_dir, kind, metric="SDR"):
    path = os.path.join(data_dir, f"oracle_{kind}_mask_eval", f"source_{metric}s.txt")
    with open(path) as f:
        return {ln.split()[0]: np.array(ln.split()[1:], float) for ln in f}


def _all_rows(data_dir, kind):
    return {m: _rows(data_dir, kind, m) for m in ("SDR", "SIR", "SAR")}


NOISE_FLOOR_DB = 100.0


def _close(got, want, tol, floor=False):
    """Every row within tol dB; with ``floor``, a one-source row (a single
    value) above NOISE_FLOOR_DB on both sides instead."""
    for m in want:
        assert sorted(got[m]) == sorted(want[m]), m
        for seg, w in want[m].items():
            if floor and len(w) == 1 and w[0] > NOISE_FLOOR_DB:
                assert got[m][seg][0] > NOISE_FLOOR_DB, (m, seg, got[m][seg], w)
                continue
            np.testing.assert_allclose(got[m][seg], w, rtol=0, atol=tol, err_msg=f"{m} {seg}")


@pytest.mark.parametrize("segments", [False, True], ids=["whole", "segments"])
@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard"])
def test_oracle_matches_the_jax_package(data_dir, hard, segments):
    kind = "hard" if hard else "soft"
    seg_path = os.path.join(data_dir, "segments")
    if segments:
        with open(os.path.join(data_dir, "wav.scp")) as f:
            recos = [ln.split()[0] for ln in f][:3]
        with open(seg_path, "w") as f:
            for r in recos:
                f.write(f"{r}-a {r} 0.00 0.31\n{r}-b {r} 0.31 0.55\n")
    try:
        jax_oracle(data_dir, hard_mask=hard, log=quiet)
        want_means = jax_merge(data_dir, hard, 1)
        want = _all_rows(data_dir, kind)
        evaluate_oracle(data_dir, hard_mask=hard, device="cpu", log=quiet)
        means = merge_oracle_shards(data_dir, hard, 1)
        got = _all_rows(data_dir, kind)
        _close(got, want, JAX_DB, floor=True)
        assert len(want["SDR"]) == 6
        assert np.isposinf(means["SIR"]) and np.isposinf(want_means["SIR"])
        if segments:
            assert sorted(want["SDR"]) == sorted(f"{r}-{p}" for r in recos for p in "ab")
        # one-speaker utterances: no interference, SIR +inf in both
        assert any(np.all(np.isposinf(v)) for v in got["SIR"].values())

        evaluate_oracle(data_dir, hard_mask=hard, device_scoring=True, device="cpu", slab=4,
                        log=quiet)
        merge_oracle_shards(data_dir, hard, 1)
        _close(_all_rows(data_dir, kind), got, DEVICE_DB)
    finally:
        if segments:
            os.remove(seg_path)


def test_cli_oracle_in_shards(data_dir, capsys):
    main(["oracle", data_dir, "--device", "cpu"])
    single = _all_rows(data_dir, "soft")
    stats = open(os.path.join(data_dir, "oracle_soft_mask_eval", "SDR_stats.txt")).read()
    main(["oracle", data_dir, "--nj", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "oracle mean SDR:" in out
    _close(_all_rows(data_dir, "soft"), single, 0.0)
    assert stats.splitlines()[0].startswith("Mean:\t")
    for i in (1, 2):
        assert os.path.isfile(os.path.join(data_dir, "oracle_soft_mask_eval",
                                           f"source_SDRs.txt.{i}"))
    # --data-parallel with one device (the CPU): the JAX package's note, and
    # the rows of the run without it
    main(["oracle", data_dir, "--data-parallel", "--device", "cpu"])
    assert "note: --data-parallel with one visible device" not in capsys.readouterr().out
    _close(_all_rows(data_dir, "soft"), single, 0.0)
    main(["oracle", data_dir, "--device-scoring", "--device", "cpu"])
    device_rows = _all_rows(data_dir, "soft")
    main(["oracle", data_dir, "--device-scoring", "--data-parallel", "--device", "cpu"])
    assert "note: --data-parallel with one visible device" in capsys.readouterr().out
    _close(_all_rows(data_dir, "soft"), device_rows, 0.0)
