"""Oracle-mask upper bound (the reference's steps/evaluate_oracle.py).

The counterpart of speech_separation_tpu/eval/oracle.py. For every
utterance: the mixture's and each source's STFT (``dsp/stft.
stft_centered_batch``, the hand-written STFT kernel on CUDA, one launch an
utterance), the ideal mask, soft (|S_i| / |mix|) or hard (a one at the
loudest source's bins), the masked mixture resynthesised by
``dsp/stft.istft_batch``, and BSS-eval of the result against the true
sources without the permutation search. Written under
``<data-dir>/oracle_{soft,hard}_mask_eval/``: ``{session,source}_{SDR,SIR,
SAR}s.txt`` with the shard's suffix, and after ``merge_oracle_shards`` the
merged, sorted files and the ``{SDR,SIR,SAR}_stats.txt`` files that the
reference's evaluate_oracle.sh derives with awk.

The JAX module's two deliberate divergences from the reference are kept:
the ``segments`` branch works (the reference's is broken), and the soft
mask is 0 where |mix| == 0 (the reference divides by zero there).

Scoring: the host f64 scorer (eval/bss_eval.py) an utterance at a time,
or with ``device_scoring`` the float64 batched scorer
(eval/bss_eval_device.py) on slabs of ``slab`` utterances, whose trust gate
sends what it cannot vouch for to the host scorer.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..datadir.scp import read_scp, read_segments, source_wavs_for_mix
from ..dsp.stft import (STFTConfig, istft_batch, istft_output_length, num_frames,
                        reflect_pad_center, stft_centered_batch)
from ..utils.audio import load_wav
from ..utils.device import resolve_device
from .bss_eval import bss_eval_sources
from .score import _write_stats, pack_signals

METRICS = ("SDR", "SIR", "SAR")


def _oracle_estimates(signals: list, cfg: STFTConfig, hard_mask: bool, dev) -> np.ndarray:
    """The masked resynthesis of one utterance: signals [mix, s1, ..., sn]
    (an utterance without source files scores the mixture against itself).
    Returns (n, hop * (T - 1)) float32, T the mixture's frame count."""
    max_len = max(len(s) for s in signals)
    n_t = num_frames(max_len, cfg.hop)
    xp = np.zeros((len(signals), max_len + cfg.n_fft), np.float32)
    for i, s in enumerate(signals):
        p = reflect_pad_center(s, cfg.n_fft)
        xp[i, :len(p)] = p
    re, im = stft_centered_batch(torch.from_numpy(xp).to(dev), cfg.n_fft, cfg.hop, n_t)
    T = num_frames(len(signals[0]), cfg.hop)
    re, im = re[:, :T], im[:, :T]
    mix_re, mix_im = re[0], im[0]
    src_re, src_im = (re[1:], im[1:]) if len(signals) > 1 else (re[:1], im[:1])
    mags = torch.sqrt(src_re * src_re + src_im * src_im)
    if hard_mask:
        winner = torch.argmax(mags, dim=0)
        masks = (winner[None] == torch.arange(len(mags), device=dev)[:, None, None])
        masks = masks.to(torch.float32)
    else:
        mix_mag = torch.sqrt(mix_re ** 2 + mix_im ** 2)[None]
        masks = torch.where(mix_mag > 0, mags / torch.where(mix_mag > 0, mix_mag, 1.0),
                            torch.zeros_like(mags))
    counts = torch.full((len(masks),), T, dtype=torch.int64, device=dev)
    y = istft_batch(masks * mix_re[None], masks * mix_im[None], counts, hop=cfg.hop)
    half = cfg.n_fft // 2
    return y[:, half:half + istft_output_length(T, cfg.hop)].cpu().numpy()


def _score_slab(pending: list, dev, log, mesh=None) -> dict:
    """No-permutation BSS-eval of [(seg_id, oracle, est)] on the card (or
    split over ``mesh``), by source count. Returns {seg_id: (sdr, sir,
    sar)}."""
    from .bss_eval_device import bss_eval_sources_batch
    results, stats, why = {}, {}, []
    by_count: dict[int, list] = {}
    for case in pending:
        by_count.setdefault(case[1].shape[0], []).append(case)
    for n, group in by_count.items():
        seen = len(stats.get("reasons", []))
        sdr, sir, sar, _ = bss_eval_sources_batch(
            pack_signals([c[1] for c in group], n), pack_signals([c[2] for c in group], n),
            compute_permutation=False, device=dev, stats=stats, mesh=mesh)
        why += [f"{group[b][0]} {reason}" for b, reason in stats["reasons"][seen:]]
        for i, (sid, _o, _e) in enumerate(group):
            results[sid] = (sdr[i], sir[i], sar[i])
    log(f"oracle: scored {len(pending)} on {dev.type}"
        + (f" ({len(why)} host-f64 fallbacks: {', '.join(why)})" if why else ""))
    return results


def evaluate_oracle(data_dir: str, hard_mask: bool = False, cfg: STFTConfig = STFTConfig(),
                    job_suffix: str = "", device_scoring: bool = False, device=None,
                    slab: int = 32, log=print, mesh=None) -> None:
    """Write the oracle-mask scores of ``data_dir/wav.scp<job_suffix>`` (and
    its ``segments<job_suffix>`` when there is one). The STFT and the
    resynthesis run on ``device`` (CUDA by default; it raises when no card
    is visible); ``device_scoring`` scores there too, in slabs of ``slab``
    utterances; with it, a ``mesh`` (parallel/mesh.py) splits each slab over
    its devices."""
    dev = resolve_device(device)
    kind = "hard" if hard_mask else "soft"
    dir_out = os.path.join(data_dir, f"oracle_{kind}_mask_eval")
    os.makedirs(dir_out, exist_ok=True)
    seg_path = os.path.join(data_dir, "segments" + job_suffix)
    segments = read_segments(seg_path) if os.path.isfile(seg_path) else None
    files = {(prefix, m): open(os.path.join(dir_out, f"{prefix}_{m}s.txt" + job_suffix), "w")
             for prefix in ("session", "source") for m in METRICS}
    pending: list = []

    def emit(seg_id, num_src, sdr, sir, sar):
        for m, vals in zip(METRICS, (sdr, sir, sar)):
            files["session", m].write(f"{seg_id} {sum(vals) / num_src}\n")
            files["source", m].write(seg_id + "".join(f" {v}" for v in vals) + "\n")

    def flush():
        if pending:
            results = _score_slab(pending, dev, log, mesh)
            for sid, oracle, _est in pending:
                emit(sid, oracle.shape[0], *results[sid])
            pending.clear()

    try:
        for reco_id, mix_path in read_scp(os.path.join(data_dir, "wav.scp" + job_suffix)):
            wav_files = source_wavs_for_mix(mix_path)
            num_src = max(len(wav_files) - 1, 1)
            seg_list = (segments.get(reco_id, []) if segments is not None
                        else [(reco_id, 0.0, None)])
            for seg_id, t0, t1 in seg_list:
                duration = None if t1 is None else t1 - t0
                signals = [load_wav(w, sr=cfg.sample_rate, offset=t0, duration=duration)[0]
                           for w in wav_files]
                y = _oracle_estimates(signals, cfg, hard_mask, dev)
                sources = signals[1:] or signals[:1]
                source_length = len(signals[0])
                oracle = np.zeros((num_src, source_length))
                est = np.zeros((num_src, source_length))
                for i in range(num_src):
                    oracle[i] = sources[i][:source_length]
                    est[i, :y.shape[1]] = y[i]
                if device_scoring:
                    pending.append((seg_id, oracle, est))
                    if len(pending) >= slab:
                        flush()
                else:
                    sdr, sir, sar, _ = bss_eval_sources(oracle, est, compute_permutation=False)
                    emit(seg_id, num_src, sdr, sir, sar)
        flush()
    finally:
        for f in files.values():
            f.close()
    log(f"oracle {kind}-mask eval -> {dir_out}")


def merge_oracle_shards(data_dir: str, hard_mask: bool, num_shards: int) -> dict:
    """Merge the shards' result files (sorted, as evaluate_oracle.sh does)
    and write the Mean/Std/Max/Min stats files. Returns the mean of each
    metric."""
    kind = "hard" if hard_mask else "soft"
    dir_out = os.path.join(data_dir, f"oracle_{kind}_mask_eval")
    means = {}
    for m in METRICS:
        for prefix in ("session", "source"):
            name = f"{prefix}_{m}s.txt"
            lines = []
            for i in range(1, num_shards + 1):
                shard = os.path.join(dir_out, name + (f".{i}" if num_shards > 1 else ""))
                if os.path.isfile(shard):
                    with open(shard) as f:
                        lines.extend(f.readlines())
            lines.sort()
            with open(os.path.join(dir_out, name), "w") as f:
                f.writelines(lines)
        values = []
        with open(os.path.join(dir_out, f"source_{m}s.txt")) as f:
            for line in f:
                values.extend(float(v) for v in line.split()[1:])
        values = np.asarray(values)
        _write_stats(os.path.join(dir_out, f"{m}_stats.txt"), values)
        means[m] = float(np.mean(values))
    return means
