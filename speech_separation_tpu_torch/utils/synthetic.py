"""Synthetic two-speaker mini-corpus generator.

The port's own copy of speech_separation_tpu/utils/synthetic.py (the same
seed writes the same wavs). It builds a corpus in the reference's layout,
``<root>/{mix,s1,s2}/<utt>.wav`` (8 kHz int16), for end-to-end runs and
tests: spectrally disjoint sources make separation by masking achievable.

Source 1: low-frequency harmonic tones; source 2: high-frequency filtered
noise. Mixture = s1 + s2 (no SNR jitter by default — deterministic, seeded).
"""

from __future__ import annotations

import os

import numpy as np

from .audio import write_wav_int16


def _tone_voice(rng, n: int, sr: int) -> np.ndarray:
    """Low-band 'speaker': sum of a few harmonics with a random f0 walk."""
    f0 = rng.uniform(120.0, 260.0)
    t = np.arange(n) / sr
    vibrato = 1.0 + 0.02 * np.sin(2 * np.pi * rng.uniform(2.0, 5.0) * t)
    sig = np.zeros(n)
    for h in (1, 2, 3):
        sig += (0.5 / h) * np.sin(2 * np.pi * f0 * h * vibrato * t
                                  + rng.uniform(0, 2 * np.pi))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.5, 1.5) * t) ** 2
    return (0.3 * sig * env).astype(np.float32)


def _noise_voice(rng, n: int, sr: int) -> np.ndarray:
    """High-band 'speaker': noise pushed above ~1.5 kHz by differencing."""
    x = rng.standard_normal(n + 4).astype(np.float32)
    hp = x[4:] - 2 * x[2:-2] + x[:-4]  # crude high-pass
    t = np.arange(n) / sr
    env = 0.5 + 0.5 * np.cos(2 * np.pi * rng.uniform(0.7, 2.0) * t) ** 2
    hp = hp / (np.abs(hp).max() + 1e-9)
    return (0.25 * hp * env).astype(np.float32)


def _am_voice(rng, n: int, sr: int) -> np.ndarray:
    """Mid-band 'speaker': amplitude-modulated carrier around ~800 Hz —
    spectrally between the tone voice (low harmonics) and the noise voice
    (high band), so 3-speaker mixtures stay separable by masking."""
    t = np.arange(n) / sr
    fc = rng.uniform(650.0, 1000.0)
    mod = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(3.0, 8.0) * t
                             + rng.uniform(0, 2 * np.pi))
    sig = np.sin(2 * np.pi * fc * t + rng.uniform(0, 2 * np.pi)) * mod
    env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.4, 1.2) * t) ** 2
    return (0.3 * sig * env).astype(np.float32)


def make_synthetic_corpus_var(root: str, num_utts: int, sr: int = 8000,
                              min_sec: float = 0.6, max_sec: float = 1.4,
                              seed: int = 0, prefix: str = "utt",
                              counts: tuple[int, ...] = (1, 2, 3)
                              ) -> list[str]:
    """Variable-speaker-count corpus: utterance i has counts[i % len]
    sources (reference layout ``<root>/{mix,s1..sN}/<utt>.wav``; only the
    subdirs an utterance uses contain its file, exactly how
    extract_feats.py's /mix/ -> /*/ glob discovers the count). Voices in
    order: low-band tones, high-band noise, mid-band AM — spectrally
    disjoint so masking can separate any subset."""
    rng = np.random.default_rng(seed)
    voices = (_tone_voice, _noise_voice, _am_voice)
    max_count = max(counts)
    if max_count > len(voices):
        raise ValueError(f"at most {len(voices)} speakers supported")
    os.makedirs(os.path.join(root, "mix"), exist_ok=True)
    for s in range(1, max_count + 1):
        os.makedirs(os.path.join(root, f"s{s}"), exist_ok=True)
    utt_ids = []
    for i in range(num_utts):
        n = int(sr * rng.uniform(min_sec, max_sec))
        c = counts[i % len(counts)]
        srcs = [voices[k](rng, n, sr) for k in range(c)]
        mix = np.sum(srcs, axis=0)
        peak = np.abs(mix).max()
        if peak > 0.95:
            srcs = [s / peak for s in srcs]
            mix = mix / peak
        utt = f"{prefix}{i:04d}"
        for k, s in enumerate(srcs):
            write_wav_int16(os.path.join(root, f"s{k + 1}", utt + ".wav"),
                            sr, s)
        write_wav_int16(os.path.join(root, "mix", utt + ".wav"), sr, mix)
        utt_ids.append(utt)
    return utt_ids


def make_synthetic_corpus(root: str, num_utts: int, sr: int = 8000,
                          min_sec: float = 0.6, max_sec: float = 1.4,
                          seed: int = 0, prefix: str = "utt") -> list[str]:
    """Create the corpus; returns the utterance ids."""
    rng = np.random.default_rng(seed)
    for sub in ("mix", "s1", "s2"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    utt_ids = []
    for i in range(num_utts):
        n = int(sr * rng.uniform(min_sec, max_sec))
        s1 = _tone_voice(rng, n, sr)
        s2 = _noise_voice(rng, n, sr)
        mix = s1 + s2
        peak = np.abs(mix).max()
        if peak > 0.95:  # avoid int16 clipping
            s1, s2, mix = s1 / peak, s2 / peak, mix / peak
        utt = f"{prefix}{i:04d}"
        write_wav_int16(os.path.join(root, "s1", utt + ".wav"), sr, s1)
        write_wav_int16(os.path.join(root, "s2", utt + ".wav"), sr, s2)
        write_wav_int16(os.path.join(root, "mix", utt + ".wav"), sr, mix)
        utt_ids.append(utt)
    return utt_ids


def write_id_list(id_lists_dir: str, dataset: str, utt_ids: list[str]) -> None:
    os.makedirs(id_lists_dir, exist_ok=True)
    with open(os.path.join(id_lists_dir, dataset + ".txt"), "w") as f:
        f.write("\n".join(utt_ids) + "\n")
