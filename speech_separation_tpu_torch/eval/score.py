"""Scoring: BSS-eval of the estimated against the oracle sources, in the
reference's result files.

The counterpart of the host path of speech_separation_tpu/eval/score.py
(the device scorer is not ported yet, ROADMAP.md). For each utterance of
wav.scp, the oracle sources are found by the /mix/ -> /s<i>/ substitution,
everything is cut to the first estimate's length, BSS-eval runs with the
permutation search (eval/bss_eval.py, float64 on the host), and

  results/session_{SDR,SIR,SAR,SI-SDR,SI-SDRi}s.txt   per utterance, mean over sources
  results/source_{...}s.txt                           per utterance, per source
  results/{...}_stats.txt                             Mean/Std/Max/Min over all sources
  results/summary.json                                n_utts, means, scorer

are written. ``num_workers > 1`` scores utterances in a pool of spawned
processes; this module imports numpy and scipy only, so they never touch
the card.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from ..datadir.scp import read_scp, read_utt2num_spk
from ..utils.audio import load_wav
from .bss_eval import bss_eval_sources, si_sdr, si_sdr_improvement

METRICS = ("SDR", "SIR", "SAR", "SI-SDR", "SI-SDRi")


def _load_case(utt, mix_path, num_src, est_dir):
    """(oracle (n, L), est (n, L), mix (L,)), cut to the first estimate's
    length L."""
    oracle = est = None
    for s in range(num_src):
        o, _ = load_wav(mix_path.replace("/mix/", f"/s{s + 1}/"))
        e, _ = load_wav(os.path.join(est_dir, f"s{s + 1}", utt + ".wav"))
        if s == 0:
            oracle = np.zeros((num_src, len(e)))
            est = np.zeros((num_src, len(e)))
        oracle[s] = o[:est.shape[1]]
        est[s] = e[:est.shape[1]]
    mix, _ = load_wav(mix_path)
    return oracle, est, mix[:est.shape[1]]


def _score_one(args):
    utt, mix_path, num_src, est_dir = args
    oracle, est, mix = _load_case(utt, mix_path, num_src, est_dir)
    sdr, sir, sar, perm = bss_eval_sources(oracle, est)
    sisdr = np.array([si_sdr(est[k], oracle[perm[k]]) for k in range(num_src)])
    sisdri = np.array([si_sdr_improvement(est[k], oracle[perm[k]], mix)
                       for k in range(num_src)])
    return utt, sdr, sir, sar, sisdr, sisdri


def _write_stats(path: str, values: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write(f"Mean:\t{np.mean(values)}\n")
        f.write(f"Std:\t{np.std(values)}\n")
        f.write(f"Max:\t{np.amax(values)}\n")
        f.write(f"Min:\t{np.amin(values)}\n")


def evaluate_sources(data_dir: str, exp_dir: str, num_workers: int = 0,
                     log=print) -> dict:
    """Score exp_dir/wav against the oracle sources of data_dir. Returns
    the mean of each metric: {'SDR': ..., 'SIR', 'SAR', 'SI-SDR',
    'SI-SDRi'}."""
    results_dir = os.path.join(exp_dir, "results")
    os.makedirs(results_dir, exist_ok=True)
    num_src = read_utt2num_spk(os.path.join(data_dir, "utt2num_spk"))
    entries = read_scp(os.path.join(data_dir, "wav.scp"))
    est_dir = os.path.join(exp_dir, "wav")
    jobs = [(utt, path, num_src[utt], est_dir) for utt, path in entries]
    if num_workers and num_workers > 1:
        import multiprocessing as mp
        # spawn: the parent may hold an initialized CUDA context
        with ProcessPoolExecutor(max_workers=num_workers,
                                 mp_context=mp.get_context("spawn")) as pool:
            results = list(pool.map(_score_one, jobs, chunksize=4))
    else:
        results = [_score_one(j) for j in jobs]

    values = {name: [] for name in METRICS}
    files = {}
    for name in METRICS:
        for kind in ("session", "source"):
            files[kind, name] = open(os.path.join(results_dir, f"{kind}_{name}s.txt"), "w")
    for utt, *per_metric in results:
        for name, vals in zip(METRICS, per_metric):
            files["session", name].write(f"{utt} {sum(vals) / len(vals)}\n")
            files["source", name].write(utt + "".join(f" {v}" for v in vals) + "\n")
            values[name].extend(float(v) for v in vals)
    for f in files.values():
        f.close()

    means = {}
    for name, vals in values.items():
        vals = np.asarray(vals)
        _write_stats(os.path.join(results_dir, f"{name}_stats.txt"), vals)
        means[name] = float(np.mean(vals))
    with open(os.path.join(results_dir, "summary.json"), "w") as f:
        json.dump({"n_utts": len(entries), "mean": means, "scorer": "host-f64"}, f, indent=1)
    log(" ".join(f"mean {k}: {v:.2f}" for k, v in means.items()))
    return means
