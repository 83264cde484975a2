"""Scoring: BSS-eval of the estimated against the oracle sources, in the
reference's result files.

The counterpart of speech_separation_tpu/eval/score.py. For each utterance
of wav.scp, the oracle sources are found by the /mix/ -> /s<i>/
substitution, everything is cut to the first estimate's length, BSS-eval
runs with the permutation search (eval/bss_eval.py, float64 on the host;
with ``device_scoring``, eval/bss_eval_device.py, float64 on the card), and

  results/session_{SDR,SIR,SAR,SI-SDR,SI-SDRi}s.txt   per utterance, mean over sources
  results/source_{...}s.txt                           per utterance, per source
  results/{...}_stats.txt                             Mean/Std/Max/Min over all sources
  results/summary.json                                n_utts, means, scorer

are written. ``num_workers > 1`` scores utterances in a pool of spawned
processes; this module imports numpy and scipy only (the device scorer
is imported where it is called), so they never touch the card.
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


def _si_metrics(oracle, est, mix, perm):
    """SI-SDR and SI-SDRi of each estimate against its assigned source."""
    num_src = oracle.shape[0]
    sisdr = np.array([si_sdr(est[k], oracle[perm[k]]) for k in range(num_src)])
    sisdri = np.array([si_sdr_improvement(est[k], oracle[perm[k]], mix)
                       for k in range(num_src)])
    return sisdr, sisdri


def _score_one(args):
    utt, mix_path, num_src, est_dir = args
    oracle, est, mix = _load_case(utt, mix_path, num_src, est_dir)
    sdr, sir, sar, perm = bss_eval_sources(oracle, est)
    return (utt, sdr, sir, sar, *_si_metrics(oracle, est, mix, perm))


def _case_int16(x: np.ndarray) -> np.ndarray | None:
    """Exact int16 repacking of float audio when every sample is k/32768
    (true of un-resampled PCM16 wavs, which the pipeline writes); None if
    any sample is inexact. Every BSS-eval quantity is invariant to the
    common 2^15 scale, and a power-of-two scale is exact in float64."""
    y = np.rint(x * 32768.0)
    if (np.all(y >= -32768.0) and np.all(y < 32768.0)
            and np.array_equal(y / 32768.0, x)):
        return y.astype(np.int16)
    return None


def pack_signals(signals, num_src: int) -> np.ndarray:
    """(B, n, Lmax) zero-padded from a list of (n, L_b) arrays: int16 when
    every one repacks exactly (a quarter of float64's bytes to the card),
    else float64. References and estimates are packed apart: the metrics
    are invariant to a scale of either."""
    Lmax = max(x.shape[1] for x in signals)
    packed = [_case_int16(x) for x in signals]
    exact = all(x is not None for x in packed)
    out = np.zeros((len(signals), num_src, Lmax), np.int16 if exact else np.float64)
    for i, x in enumerate(packed if exact else signals):
        out[i, :, :x.shape[1]] = x
    return out


def _score_device(jobs, log, device, slab: int = 64, mesh=None):
    """BSS-eval on the card in float64 (eval/bss_eval_device.py), the
    counterpart of the JAX package's slab path. Utterances are grouped by
    source count, length-sorted by their RIFF headers (no audio read) and
    scored in slabs; two loader threads read the next slabs while one scores
    on the card; SI-SDR stays on the host. Utterances the scorer's trust
    gate rejects are rescored by the host f64 scorer, counted and logged.
    With a ``mesh`` each slab's utterances are split over its devices and
    merged back in order (bss_eval_device.bss_eval_sources_batch). Returns
    (results in wav.scp order, fallback count)."""
    import time
    from concurrent.futures import ThreadPoolExecutor

    from ..utils.audio import wav_num_samples
    from .bss_eval_device import bss_eval_sources_batch
    from ..utils.device import resolve_device
    dev = resolve_device(device)

    hdr_len = {job[0]: wav_num_samples(os.path.join(job[3], "s1", job[0] + ".wav"))
               for job in jobs}
    by_count: dict[int, list] = {}
    for job in jobs:
        by_count.setdefault(job[2], []).append(job)
    slabs = []
    for num_src, group in by_count.items():
        group = sorted(group, key=lambda job: hdr_len[job[0]])
        slabs += [(num_src, group[s:s + slab]) for s in range(0, len(group), slab)]

    def load_slab(chunk):
        return [_load_case(utt, mp, n, ed) for utt, mp, n, ed in chunk]

    results, stats = [], {}
    t_sweep0 = time.monotonic()
    t_loadwait = t_pack = t_dev = t_post = 0.0
    with ThreadPoolExecutor(max_workers=2) as pool:
        depth = 2
        futs = [pool.submit(load_slab, slabs[k][1]) for k in range(min(depth, len(slabs)))]
        for k, (num_src, chunk) in enumerate(slabs):
            t0 = time.monotonic()
            cases = futs[k].result()
            t_loadwait += time.monotonic() - t0
            if k + depth < len(slabs):
                futs.append(pool.submit(load_slab, slabs[k + depth][1]))
            t0 = time.monotonic()
            refs = pack_signals([c[0] for c in cases], num_src)
            ests = pack_signals([c[1] for c in cases], num_src)
            t_pack += time.monotonic() - t0
            n_before, fb_before = stats.get("fallbacks", 0), stats.get("fallback_s", 0.0)
            t0 = time.monotonic()
            sdr, sir, sar, perm = bss_eval_sources_batch(refs, ests, device=dev, stats=stats,
                                                         mesh=mesh)
            fb_s = stats["fallback_s"] - fb_before
            t_dev += time.monotonic() - t0 - fb_s
            t0 = time.monotonic()
            for i, ((utt, *_r), (oracle, est, mix)) in enumerate(zip(chunk, cases)):
                results.append((utt, sdr[i], sir[i], sar[i],
                                *_si_metrics(oracle, est, mix, perm[i])))
            futs[k] = None                       # release the slab's audio
            t_post += time.monotonic() - t0 + fb_s
            n_host = stats["fallbacks"] - n_before
            log(f"scored {len(results)}/{len(jobs)} on {dev.type}"
                + (f" ({n_host} host-f64 fallbacks: "
                   + ", ".join(f"{chunk[b][0]} {why}" for b, why in stats["reasons"][-n_host:])
                   + ")" if n_host else ""))
    total = time.monotonic() - t_sweep0
    log(f"device scoring anatomy: total {total:.2f}s = load-wait {t_loadwait:.2f} + pack "
        f"{t_pack:.2f} + device {t_dev:.2f} + host-SI/fallback {t_post:.2f}; "
        f"{stats.get('fallbacks', 0)} host-f64 fallbacks of {len(jobs)}")
    order = {job[0]: i for i, job in enumerate(jobs)}
    return sorted(results, key=lambda r: order[r[0]]), stats.get("fallbacks", 0)


def _write_stats(path: str, values: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write(f"Mean:\t{np.mean(values)}\n")
        f.write(f"Std:\t{np.std(values)}\n")
        f.write(f"Max:\t{np.amax(values)}\n")
        f.write(f"Min:\t{np.amin(values)}\n")


def evaluate_sources(data_dir: str, exp_dir: str, num_workers: int = 0,
                     device_scoring: bool = False, device=None, log=print,
                     mesh=None) -> dict:
    """Score exp_dir/wav against the oracle sources of data_dir. Returns
    the mean of each metric: {'SDR': ..., 'SIR', 'SAR', 'SI-SDR',
    'SI-SDRi'}. ``device_scoring`` runs BSS-eval batched in float64 on
    ``device`` (CUDA by default; it raises when no card is visible), held
    to the host scorer; ``num_workers`` then does not apply. With it, a
    ``mesh`` (parallel/mesh.py) splits each slab over its devices."""
    results_dir = os.path.join(exp_dir, "results")
    num_src = read_utt2num_spk(os.path.join(data_dir, "utt2num_spk"))
    entries = read_scp(os.path.join(data_dir, "wav.scp"))
    est_dir = os.path.join(exp_dir, "wav")
    jobs = [(utt, path, num_src[utt], est_dir) for utt, path in entries]
    fallbacks = None
    if device_scoring:
        results, fallbacks = _score_device(jobs, log, device, mesh=mesh)
    elif num_workers and num_workers > 1:
        import multiprocessing as mp
        # spawn: the parent may hold an initialized CUDA context
        with ProcessPoolExecutor(max_workers=num_workers,
                                 mp_context=mp.get_context("spawn")) as pool:
            results = list(pool.map(_score_one, jobs, chunksize=4))
    else:
        results = [_score_one(j) for j in jobs]

    os.makedirs(results_dir, exist_ok=True)
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
    summary = {"n_utts": len(entries), "mean": means,
               "scorer": "device-f64" if device_scoring else "host-f64"}
    if device_scoring:
        summary["host_fallbacks"] = fallbacks
    with open(os.path.join(results_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    log(" ".join(f"mean {k}: {v:.2f}" for k, v in means.items()))
    return means
