"""STFT / iSTFT with librosa semantics, as batched PyTorch functions.

The counterpart of speech_separation_tpu/dsp/stft.py, same semantics:

- periodic ("fftbins") Hann window of length n_fft;
- center=True: each signal is reflect-padded by n_fft//2 on both sides
  (host side, around its own end), then zero-padded to the batch length;
- n_frames = 1 + len(x) // hop;
- the iSTFT windows each inverse frame, overlap-adds, divides by the summed
  squared window of the row's true frames only (guarded against ~0), and
  returns the untrimmed overlap-add; the caller trims n_fft//2 per side.

No complex dtypes: the real DFT is one product with a precomputed
(n_fft, 2*n_bins) matrix with the window folded in. The forward STFT runs
through the hand-written kernel of ops/stft_kernel.py (framing fused into
its loads); the inverse is a plain f32 product plus reshape/pad/add, as the
reference leaves it outside any kernel. ``frame_signal`` cuts the overlapping
frames of the time-domain archs' learned encoder. f32 products must run in full f32,
as the reference's Precision.HIGHEST: SeparationPipeline turns TF32 off.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class STFTConfig:
    """Feature-extraction configuration (n_fft=512, hop=128 at 8 kHz)."""
    n_fft: int = 512
    hop: int = 128
    sample_rate: int = 8000

    @property
    def num_bins(self) -> int:
        return self.n_fft // 2 + 1


def hann_periodic(n_fft: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window: 0.5 - 0.5*cos(2*pi*n/N), n = 0..N-1."""
    n = np.arange(n_fft)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / n_fft)).astype(dtype)


def num_frames(n_samples: int, hop: int) -> int:
    """Frame count for a center=True STFT: 1 + floor(len / hop)."""
    return 1 + n_samples // hop


def istft_output_length(n_frames: int, hop: int) -> int:
    """Samples returned by a center=True iSTFT: hop * (n_frames - 1)."""
    return hop * (n_frames - 1)


def reflect_pad_center(x: np.ndarray, n_fft: int) -> np.ndarray:
    """Host-side center padding: reflect by n_fft//2 on both sides."""
    return np.pad(x, n_fft // 2, mode="reflect")


@lru_cache(maxsize=8)
def _windowed_rdft_matrix(n_fft: int) -> np.ndarray:
    """(n_fft, 2*n_bins) float32 matrix A with the Hann window folded in.

    frames @ A == concat([Re(rfft(frames * w)), Im(rfft(frames * w))], -1)
    """
    n_bins = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    w = hann_periodic(n_fft, np.float64)[:, None]
    return np.concatenate([w * np.cos(ang), w * -np.sin(ang)], axis=1).astype(np.float32)


@lru_cache(maxsize=8)
def _windowed_irdft_matrix(n_fft: int) -> np.ndarray:
    """(2*n_bins, n_fft) float32 matrix B with the synthesis window folded in.

    concat([re, im], -1) @ B == irfft(re + i*im, n_fft) * w
    """
    n_bins = n_fft // 2 + 1
    k = np.arange(n_bins, dtype=np.float64)[:, None]
    n = np.arange(n_fft, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * k * n / n_fft
    coef = np.full((n_bins, 1), 2.0)
    coef[0, 0] = 1.0
    coef[n_bins - 1, 0] = 1.0
    w = hann_periodic(n_fft, np.float64)[None, :]
    top = coef * np.cos(ang) / n_fft * w      # re rows
    bot = coef * -np.sin(ang) / n_fft * w     # im rows
    return np.concatenate([top, bot], axis=0).astype(np.float32)


@lru_cache(maxsize=16)
def _device_matrix(kind: str, n_fft: int, device: torch.device) -> torch.Tensor:
    """One resident copy of a DFT matrix or squared window per device
    (read-only: callers never write to it)."""
    if kind == "rdft":
        m = _windowed_rdft_matrix(n_fft)
    elif kind == "irdft":
        m = _windowed_irdft_matrix(n_fft)
    else:
        w = hann_periodic(n_fft)
        m = w * w
    return torch.from_numpy(np.ascontiguousarray(m)).to(device)


def stft_centered_batch(xp: torch.Tensor, n_fft: int, hop: int, n_t: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched STFT over already center-padded signals.

    xp: (B, Lp) float32, Lp >= (n_t-1)*hop + n_fft. Returns (re, im), each
    (B, n_t, n_fft//2+1) float32. Rows' frames past their true frame count
    are garbage and must be masked or trimmed by the caller.
    """
    from ..ops.stft_kernel import stft
    return stft(xp, n_fft, hop, n_t)


def stft_magnitude_batch(xp: torch.Tensor, n_fft: int, hop: int, n_t: int
                         ) -> torch.Tensor:
    """|STFT| (B, n_t, n_bins), fused in the kernel's epilogue."""
    from ..ops.stft_kernel import stft
    return stft(xp, n_fft, hop, n_t, magnitude=True)


def frame_signal(xp: torch.Tensor, n_fft: int, hop: int, n_t: int) -> torch.Tensor:
    """Overlapping frames: (B, L) -> (B, n_t, n_fft), frame t starting at
    sample t * hop (a strided view; L >= (n_t - 1) * hop + n_fft)."""
    return xp.unfold(-1, n_fft, hop)[:, :n_t]


def _overlap_add_divisible(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Overlap-add for n_fft divisible by hop, with no scatter: chunk k of
    frame t lands at offset (t + k) * hop, so the output is the sum of
    R = n_fft//hop shifted chunk streams.
    Output: (B, (T - 1 + R) * hop) = (B, n_fft + hop*(T-1))."""
    B, T, n_fft = frames.shape
    R = n_fft // hop
    total = (T - 1 + R) * hop
    chunks = frames.reshape(B, T, R, hop)
    out = frames.new_zeros((B, total))
    for k in range(R):
        out[:, k * hop: k * hop + T * hop] += chunks[:, :, k, :].reshape(B, T * hop)
    return out


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    B, T, n_fft = frames.shape
    if n_fft % hop == 0:
        return _overlap_add_divisible(frames, hop)
    # general case: scatter-add on flattened positions
    total = n_fft + hop * (T - 1)
    pos = (torch.arange(T, device=frames.device)[:, None] * hop
           + torch.arange(n_fft, device=frames.device)[None, :]).reshape(-1)
    out = frames.new_zeros((B, total))
    return out.index_add_(1, pos, frames.reshape(B, -1))


def istft_batch(re: torch.Tensor, im: torch.Tensor, frame_counts: torch.Tensor,
                hop: int = 128) -> torch.Tensor:
    """Batched iSTFT with per-sample frame masking.

    re, im: (B, T, n_bins) float32; frame_counts: (B,) int — true frame count
    per row. Returns (B, n_fft + hop*(T-1)) float32, the *untrimmed*
    overlap-add: row i's valid output is
    [n_fft//2 : n_fft//2 + hop*(frame_counts[i]-1)].
    """
    B, T, n_bins = re.shape
    n_fft = 2 * (n_bins - 1)
    Bmat = _device_matrix("irdft", n_fft, re.device)
    mask = (torch.arange(T, device=re.device)[None, :]
            < frame_counts[:, None]).to(re.dtype)

    spec = torch.cat([re, im], dim=-1) * mask[:, :, None]
    frames = torch.matmul(spec, Bmat)
    y = _overlap_add(frames, hop)

    w2 = _device_matrix("window_sq", n_fft, re.device)[None, None, :] * mask[:, :, None]
    wss = _overlap_add(w2, hop)
    tiny = np.finfo(np.float32).tiny
    return torch.where(wss > tiny, y / wss, y)
