"""Waveform reconstruction: masked iSTFT -> int16 wavs.

The counterpart of speech_separation_tpu/eval/reconstruct.py. For each
utterance of ``feats_test.scp`` and each source of its mask npz, the masked
spectrum (re * m, im * m) becomes one row of a batched iSTFT
(dsp/stft.istft_batch, f32 products on ``device``) over (utterance x
source) rows. Output, as the reference writes it:
``<exp_dir>/wav/<source>/<utt>.wav``, int16 at x * 32767, hop * (T - 1)
samples.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..datadir.scp import read_scp
from ..dsp.stft import istft_batch, istft_output_length
from ..utils.audio import write_wav_int16


# rows of one iSTFT batch, and the multiple its frame count is padded to
ROWS_PER_BATCH = 64
TIME_PAD_MULTIPLE = 128


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def reconstruct_sources(data_dir: str, exp_dir: str, hop: int = 128,
                        sample_rate: int = 8000, log=print, device=None) -> None:
    """Write the wavs of ``exp_dir/masks`` applied to the test spectra of
    ``data_dir``, on ``device`` (CUDA by default; it raises when no card is
    visible)."""
    from ..utils.device import resolve_device
    dev = resolve_device(device)
    entries = read_scp(os.path.join(data_dir, "feats_test.scp"))
    mask_dir = os.path.join(exp_dir, "masks")
    pending = []  # (utt, source_key, re (T, F), im (T, F), T)

    def flush():
        if not pending:
            return
        T_pad = _round_up(max(p[4] for p in pending), TIME_PAD_MULTIPLE)
        n_bins = pending[0][2].shape[1]
        B = len(pending)
        re = np.zeros((B, T_pad, n_bins), np.float32)
        im = np.zeros((B, T_pad, n_bins), np.float32)
        counts = np.zeros((B,), np.int32)
        for r, (_, _, re_i, im_i, T_i) in enumerate(pending):
            re[r, :T_i] = re_i
            im[r, :T_i] = im_i
            counts[r] = T_i
        y = istft_batch(torch.from_numpy(re).to(dev), torch.from_numpy(im).to(dev),
                        torch.from_numpy(counts).to(dev), hop=hop).cpu().numpy()
        half = n_bins - 1                      # n_fft // 2
        for r, (utt, skey, _, _, T_i) in enumerate(pending):
            wav_path = os.path.join(exp_dir, "wav", skey, utt + ".wav")
            os.makedirs(os.path.dirname(wav_path), exist_ok=True)
            write_wav_int16(wav_path, sample_rate,
                            y[r, half: half + istft_output_length(T_i, hop)])
        pending.clear()

    for utt, feat_path in entries:
        spec = np.load(feat_path)["mix"]                 # (F, T) complex64
        spec_re = spec.real.T.astype(np.float32)         # (T, F)
        spec_im = spec.imag.T.astype(np.float32)
        with np.load(os.path.join(mask_dir, utt + ".npz")) as masks:
            for skey in masks.files:
                m = masks[skey].T.astype(np.float32)     # (T, F)
                pending.append((utt, skey, spec_re * m, spec_im * m, spec_re.shape[0]))
                if len(pending) >= ROWS_PER_BATCH:
                    flush()
    flush()
    log(f"reconstructed {len(entries)} utterances -> {os.path.join(exp_dir, 'wav')}")
