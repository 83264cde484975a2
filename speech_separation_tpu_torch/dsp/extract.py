"""Feature extraction: wav.scp -> one STFT npz per utterance + scp index.

The counterpart of speech_separation_tpu/dsp/extract.py. The host decodes
wavs and writes npz files; the STFT of many signals at once (mixtures and
sources are rows of one batch) runs through the hand-written STFT kernel
(ops/stft_kernel.py) on the card, or its plain version for ``device="cpu"``.
Output, as the JAX package and the reference write it:

- train mode: npz with keys ``mix``, ``s1``..``sN``: float32 magnitude
  spectra in (freq, time) layout, the magnitude taken in the kernel;
- test mode: npz with key ``mix``: the mixture's complex64 spectrum,
  assembled on the host from the kernel's re/im planes;
- ``feats_<type>.scp``, ``utt2num_spk`` and ``utt2num_frames`` in wav.scp
  order; num_spk = max(#source files, 1), the sources found by the
  ``/mix/`` -> ``/*/`` glob;
- an optional ``segments`` file: per-segment offset/duration loads;
- a shard suffix ('' or '.N') for the dirs that datadir/split.py writes.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..datadir.scp import read_scp, read_segments, source_wavs_for_mix
from ..utils.audio import load_wav
from .stft import (STFTConfig, num_frames, reflect_pad_center, stft_centered_batch,
                   stft_magnitude_batch)

# utterances whose spectra are held before they are written
GROUP_UTTS = 24


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class _BatchedSTFT:
    """Accumulate signals and run them through one STFT launch.

    Rows are padded to the longest pending signal rounded up to
    ``pad_quantum`` samples; a launch happens when ``max_rows`` signals are
    pending or on ``flush``. Frames past a row's own count are trimmed.
    """

    def __init__(self, cfg: STFTConfig, device: torch.device, max_rows: int = 64,
                 pad_quantum: int = 16384, magnitude: bool = False):
        self.cfg = cfg
        self.device = device
        self.max_rows = max_rows
        self.pad_quantum = pad_quantum
        self.magnitude = magnitude
        self._pending: list[tuple[np.ndarray, object]] = []  # (signal, token)
        self._results: dict[object, np.ndarray | tuple] = {}

    def add(self, signal: np.ndarray, token) -> None:
        self._pending.append((signal, token))
        if len(self._pending) >= self.max_rows:
            self.flush()

    def flush(self) -> None:
        if not self._pending:
            return
        cfg = self.cfg
        bucket_len = _round_up(max(len(s) for s, _ in self._pending), self.pad_quantum)
        n_t = num_frames(bucket_len, cfg.hop)
        xp = np.zeros((len(self._pending), bucket_len + cfg.n_fft), np.float32)
        for i, (s, _) in enumerate(self._pending):
            padded = reflect_pad_center(s, cfg.n_fft)
            xp[i, : len(padded)] = padded
        xp_d = torch.from_numpy(xp).to(self.device)
        if self.magnitude:
            mag = stft_magnitude_batch(xp_d, cfg.n_fft, cfg.hop, n_t).cpu().numpy()
            for i, (s, token) in enumerate(self._pending):
                self._results[token] = mag[i, :num_frames(len(s), cfg.hop)].T  # (freq, time)
        else:
            re, im = stft_centered_batch(xp_d, cfg.n_fft, cfg.hop, n_t)
            re, im = re.cpu().numpy(), im.cpu().numpy()
            for i, (s, token) in enumerate(self._pending):
                T_i = num_frames(len(s), cfg.hop)
                self._results[token] = (re[i, :T_i].T, im[i, :T_i].T)
        self._pending.clear()

    def pop(self, token):
        return self._results.pop(token)


def extract_features(data_dir: str, data_type: str, feat_dir: str,
                     cfg: STFTConfig = STFTConfig(), job_suffix: str = "",
                     compress: bool = True, log=print, device=None) -> None:
    """Extract the features of one (possibly sharded) data dir on
    ``device`` (CUDA by default; it raises when no card is visible).
    ``compress=False`` writes stored (uncompressed) npz files."""
    from ..utils.device import resolve_device
    if data_type not in ("train", "test"):
        raise ValueError(f"data_type must be 'train' or 'test', got {data_type!r}")
    dev = resolve_device(device)
    os.makedirs(feat_dir, exist_ok=True)

    seg_path = os.path.join(data_dir, "segments" + job_suffix)
    segments = read_segments(seg_path) if os.path.isfile(seg_path) else None
    wav_entries = read_scp(os.path.join(data_dir, "wav.scp" + job_suffix))
    train = data_type == "train"
    stft = _BatchedSTFT(cfg, dev, magnitude=train)
    save = np.savez_compressed if compress else np.savez

    feat_lines: list[tuple[str, str]] = []
    spk_lines: list[tuple[str, str]] = []
    frame_lines: list[tuple[str, str]] = []
    # spectra are written as soon as their group's launch is done, so host
    # memory holds one group, not the corpus
    group: list[tuple[str, dict, int]] = []  # (utt_id, {key: token}, num_spk)

    def process_group():
        stft.flush()
        for seg_id, tokens, num_spk in group:
            out_path = os.path.join(feat_dir, seg_id)
            file_dict = {}
            for key, token in tokens.items():
                # contiguous: a transposed view would be stored fortran-ordered
                if train:
                    file_dict[key] = np.ascontiguousarray(stft.pop(token), dtype=np.float32)
                else:
                    re, im = stft.pop(token)
                    file_dict[key] = np.ascontiguousarray(re + 1j * im, dtype=np.complex64)
            save(out_path, **file_dict)
            feat_lines.append((seg_id, out_path + ".npz"))
            spk_lines.append((seg_id, str(num_spk)))
            frame_lines.append((seg_id, str(file_dict["mix"].shape[1])))
        group.clear()

    for reco_id, mix_path in wav_entries:
        wav_files = source_wavs_for_mix(mix_path)
        num_spk = max(len(wav_files) - 1, 1)
        seg_list = (segments.get(reco_id, []) if segments is not None
                    else [(reco_id, 0.0, None)])
        for seg_id, t0, t1 in seg_list:
            duration = None if t1 is None else t1 - t0
            tokens: dict[str, object] = {}
            for i, wav in enumerate(wav_files if train else [mix_path]):
                audio, _ = load_wav(wav, sr=cfg.sample_rate, offset=t0, duration=duration)
                key = "mix" if i == 0 else f"s{i}"
                tokens[key] = (seg_id, key)
                stft.add(audio, tokens[key])
            group.append((seg_id, tokens, num_spk))
            if len(group) >= GROUP_UTTS:
                process_group()
    process_group()

    for name, lines in ((f"feats_{data_type}.scp", feat_lines), ("utt2num_spk", spk_lines),
                        ("utt2num_frames", frame_lines)):
        with open(os.path.join(data_dir, name + job_suffix), "w") as f:
            f.writelines(f"{k} {v}\n" for k, v in lines)
    log(f"extracted {len(feat_lines)} utterances -> {feat_dir}")


def merge_shard_outputs(data_dir: str, split_dir: str, data_type: str,
                        num_shards: int) -> None:
    """Concatenate the shards' scp outputs into the data dir's."""
    for name in (f"feats_{data_type}.scp", "utt2num_spk", "utt2num_frames"):
        with open(os.path.join(data_dir, name), "w") as out:
            for i in range(1, num_shards + 1):
                shard = os.path.join(split_dir, f"{name}.{i}")
                if os.path.isfile(shard):
                    with open(shard) as f:
                        out.write(f.read())
