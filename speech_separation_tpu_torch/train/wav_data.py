"""Waveform-direct input: train straight from ``wav.scp``.

The counterpart of speech_separation_tpu/train/wav_data.py. The host ships
the waveforms, not features: each batch is {'audio': (B, 1+S, Lp), row 0 the
mixture and rows 1..S the sources, each reflect-padded by n_fft//2 around its
own end and then zero-padded, the longest rounded up to a multiple of
``sample_pad_multiple`` plus n_fft; 'sample_lengths' (B,) int32; 'lengths'
(B,) int32 STFT frame counts; 'row_mask'; 'names'}. The audio travels as
int16 (an exact round trip for PCM16 sources, half the bytes of float32),
and the device turns it back into what the model consumes:

- ``audio_to_wave_batch``: the raw samples of a time-domain arch (SepFormer,
  DPRNN, Conv-TasNet): the static n_fft//2 prefix sliced off and every
  sample past a row's length zeroed;
- ``audio_to_feature_batch``: the STFT magnitudes of a spectral arch (uPIT,
  RSH, TCN), through the STFT kernel, frames past a row's count zeroed.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..datadir.scp import read_scp, source_wavs_for_mix, write_scp
from ..dsp.stft import STFTConfig, num_frames, reflect_pad_center, stft_magnitude_batch
from ..utils.audio import load_wav, wav_num_samples

# the framing of every shipped batch (the reference's 512/128 STFT at 8 kHz)
STFT = STFTConfig()


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class WavDataset:
    """``wav.scp``-backed dataset of waveform batches. Caches each
    utterance's sample count (read from the wav headers) in
    ``<data-dir>/utt2num_samples`` on the first scan; ``num_frames`` (STFT
    frame counts) drives length bucketing as ``utt2num_frames`` does."""

    def __init__(self, data_dir: str):
        self.entries = read_scp(os.path.join(data_dir, "wav.scp"))
        if not self.entries:
            raise ValueError(f"empty wav.scp in {data_dir}")
        self.wav_files = [source_wavs_for_mix(path) for _, path in self.entries]
        self.num_spks = np.asarray([max(len(w) - 1, 1) for w in self.wav_files], np.int32)
        cache = os.path.join(data_dir, "utt2num_samples")
        if os.path.isfile(cache):
            n = {k: int(v) for k, v in read_scp(cache)}
            self.num_samples = np.asarray([n[utt] for utt, _ in self.entries], np.int32)
        else:
            self.num_samples = np.asarray(
                [wav_num_samples(path) for _, path in self.entries], np.int32)
            write_scp(cache, ((utt, str(n)) for (utt, _), n
                              in zip(self.entries, self.num_samples)))
        self.num_frames = np.asarray(
            [num_frames(int(n), STFT.hop) for n in self.num_samples], np.int32)

    def __len__(self):
        return len(self.entries)

    def utt_id(self, idx: int) -> str:
        return self.entries[idx][0]


def collate_wav_batch(dataset: WavDataset, idxs: list[int], batch_size: int,
                      sample_pad_multiple: int = 16384) -> dict:
    """One shipped batch of the utterances ``idxs``, padded to
    ``batch_size`` rows (``row_mask`` 0 on the dummies), the normalized
    audio quantized to int16 for the copy."""
    cfg = STFT
    B = batch_size
    S = max(int(dataset.num_spks[i]) for i in idxs)
    max_len = _round_up(max(int(dataset.num_samples[i]) for i in idxs), sample_pad_multiple)
    Lp = max_len + cfg.n_fft

    audio = np.zeros((B, 1 + S, Lp), np.float32)
    sample_lengths = np.zeros((B,), np.int32)
    lengths = np.zeros((B,), np.int32)
    row_mask = np.zeros((B,), np.float32)
    names = []
    for row, i in enumerate(idxs):
        utt, _ = dataset.entries[i]
        sigs = [load_wav(w, sr=cfg.sample_rate)[0] for w in dataset.wav_files[i]]
        if len(sigs) == 1:      # no sources: source 1 is the mixture
            sigs = [sigs[0], sigs[0]]
        for k, s in enumerate(sigs):
            padded = reflect_pad_center(s, cfg.n_fft)
            audio[row, k, : len(padded)] = padded
        n = len(sigs[0])
        sample_lengths[row] = n
        lengths[row] = num_frames(n, cfg.hop)
        row_mask[row] = 1.0
        names.append(utt)
    audio = np.round(audio * 32768.0).clip(-32768, 32767).astype(np.int16)
    return {"audio": audio, "sample_lengths": sample_lengths, "lengths": lengths,
            "row_mask": row_mask, "names": names}


def audio_to_wave_batch(batch: dict, cfg: STFTConfig) -> dict:
    """Shipped audio batch -> the waveform batch of a time-domain arch:
    {'mix_wav' (B, L), 'source_wavs' (B, S, L), 'sample_lengths',
    'row_mask'}, L = Lp - n_fft."""
    audio = batch["audio"].float() / 32768.0
    half = cfg.n_fft // 2
    L = audio.shape[-1] - cfg.n_fft
    wav = audio[:, :, half: half + L]
    n = batch["sample_lengths"]
    smask = (torch.arange(L, device=wav.device)[None, :] < n[:, None]).float()
    wav = wav * smask[:, None, :]
    return {"mix_wav": wav[:, 0], "source_wavs": wav[:, 1:], "sample_lengths": n,
            "row_mask": batch["row_mask"]}


def audio_to_feature_batch(batch: dict, cfg: STFTConfig) -> dict:
    """Shipped audio batch -> the feature batch of a spectral arch:
    {'mix' (B, T, F), 'sources' (B, S, T, F), 'lengths', 'row_mask'},
    T = (Lp - n_fft) // hop + 1, zero past each row's frame count."""
    audio = batch["audio"].float() / 32768.0
    B, C, Lp = audio.shape
    n_t = (Lp - cfg.n_fft) // cfg.hop + 1
    mag = stft_magnitude_batch(audio.reshape(B * C, Lp).contiguous(), cfg.n_fft, cfg.hop,
                               n_t).reshape(B, C, n_t, cfg.num_bins)
    tmask = (torch.arange(n_t, device=mag.device)[None, :]
             < batch["lengths"][:, None]).to(mag.dtype)[:, None, :, None]
    mag = mag * tmask
    return {"mix": mag[:, 0], "sources": mag[:, 1:], "lengths": batch["lengths"],
            "row_mask": batch["row_mask"]}
