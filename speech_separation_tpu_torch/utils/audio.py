"""Host-side audio I/O (a copy of speech_separation_tpu/utils/audio.py's
serving helpers, on the native decoder of utils/native.py when it is
available, else scipy.io.wavfile):

- integer PCM is normalized to float32 the way librosa does it (int16 /
  32768, int32 / 2**31, uint8 -> [-1, 1)); multi-channel is averaged;
- resampling, only when a file's rate differs from the target, is
  polyphase;
- writing uses the reference's convention: float * 32767 -> int16,
  saturated at the int16 range.
"""

from __future__ import annotations

import os
import struct
from math import gcd

import numpy as np
from scipy.io import wavfile


def load_wav(path: str, sr: int | None = None,
             offset: float = 0.0, duration: float | None = None
             ) -> tuple[np.ndarray, int]:
    """Load a wav file as float32 in [-1, 1), optionally resampled.

    PCM16, PCM32 and float32 files decode through the native runtime when
    it is available: for a mono file the samples are those of the scipy
    path bit for bit (tested); a multi-channel file is averaged in double
    precision there, within one float32 rounding of numpy's mean. Other
    formats, or no native library, take the scipy path."""
    from . import native
    got = None
    if native.available():
        try:
            got = native.read_wav_f32(path)
        except IOError:          # a format the decoder does not take (uint8, f64)
            got = None
    if got is not None:
        x, file_sr = got
    else:
        file_sr, data = wavfile.read(path)
        if data.dtype == np.int16:
            x = data.astype(np.float32) / 32768.0
        elif data.dtype == np.int32:
            x = data.astype(np.float32) / 2147483648.0
        elif data.dtype == np.uint8:
            x = (data.astype(np.float32) - 128.0) / 128.0
        else:  # float32 / float64 wavs are already normalized
            x = data.astype(np.float32)
        if x.ndim > 1:
            x = x.mean(axis=1)

    if offset or duration is not None:
        start = int(round(offset * file_sr))
        stop = len(x) if duration is None else start + int(round(duration * file_sr))
        x = x[start:stop]

    if sr is not None and sr != file_sr:
        g = gcd(sr, file_sr)
        # scipy.signal takes seconds to import: only a resampling load pays it
        from scipy.signal import resample_poly
        x = resample_poly(x, sr // g, file_sr // g).astype(np.float32)
        file_sr = sr
    return x, file_sr


def wav_num_samples(path: str) -> int:
    """Per-channel sample count from the RIFF header alone (no data read);
    falls back to a full load on non-RIFF files."""
    try:
        with open(path, "rb") as f:
            riff, _size, wave = struct.unpack("<4sI4s", f.read(12))
            if riff != b"RIFF" or wave != b"WAVE":
                raise ValueError("not RIFF/WAVE")
            block_align = None
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    raise ValueError("no data chunk")
                cid, csize = struct.unpack("<4sI", hdr)
                if cid == b"fmt ":
                    fmt = f.read(csize)
                    if csize & 1:  # RIFF pads odd chunks with one byte
                        f.seek(1, 1)
                    block_align = struct.unpack("<H", fmt[12:14])[0]
                elif cid == b"data":
                    if not block_align:
                        raise ValueError("data before fmt")
                    return csize // block_align
                else:
                    f.seek(csize + (csize & 1), 1)
    except (OSError, ValueError, struct.error):
        return len(load_wav(path)[0])


def write_wav_int16(path: str, sr: int, x: np.ndarray) -> None:
    """Write a float waveform as int16 with the reference's x*32767 scaling,
    saturated at the int16 range (a sample past +-1.0 clips, not wraps)."""
    y = np.asarray(x) * 32767.0
    wavfile.write(path, sr, np.clip(y, -32768.0, 32767.0).astype(np.int16))


def limit_peak(tracks, limit: float = 32767.0 / 32768.0) -> list:
    """One shared gain bringing every track of an utterance within the
    int16-representable range (no-op when already in range)."""
    peak = max((float(np.max(np.abs(t))) if len(t) else 0.0)
               for t in tracks)
    if peak <= limit:
        return list(tracks)
    g = limit / peak
    return [np.asarray(t) * g for t in tracks]


def separated_track_paths(out_dir: str, wav_path: str,
                          num_spk: int) -> list[str]:
    """Output naming shared by ``separate`` and the server:
    ``<out_dir>/<input stem>_s<k>.wav`` per source."""
    stem = os.path.splitext(os.path.basename(wav_path))[0]
    return [os.path.join(out_dir, f"{stem}_s{s + 1}.wav")
            for s in range(num_spk)]
