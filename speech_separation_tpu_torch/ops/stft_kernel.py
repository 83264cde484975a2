"""Fused framing + Hann window + real-DFT STFT: the wrapper of csrc/stft.cu.

Replaces the TPU kernel speech_separation_tpu/ops/stft_pallas.py::stft_pallas
(same semantics as dsp.stft.stft_centered_batch). On the H100 the work is
bound by memory: each padded row read once and each spectrum written once
(21.1 MB at the serving shape, 6.3 us at 3.35 TB/s), since an FFT needs
about 2.5 n_fft log2(n_fft) operations a frame. ``stft_plan`` names the
launch: the "fft" path (n_fft a power of two from ``FFT_MIN`` to
``N_FFT_CAP``) stages each tile's row span once in shared memory and runs
one FFT a frame; the "direct" path (every other n_fft up to
``DIRECT_N_FFT_CAP``) is the dense f32 product ``frames @ A``. The source note in csrc/stft.cu has the design.

``stft`` launches the kernel for CUDA tensors and runs ``stft_plain`` (unfold
plus matmul) only for CPU tensors; ``stft.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..dsp.stft import _device_matrix, hann_periodic
from ._build import check_launch, cuda_device, library

N_FFT_CAP = 8192     # largest n_fft the FFT path takes
FFT_MIN = 32         # smallest power of two on the FFT path
FFT_POINTS = 4096    # complex points a CTA transforms (F frames of n_fft/2)
PTS = 16             # points a thread holds in one FFT stage
MAX_FRAMES = 64
_DIRECT = {"frames": 128, "warps": 8, "bins": 32, "smem": 4 * 16 * (132 + 64)}
# largest n_fft the direct path takes: n_fft/2 + 1 bins in the grid's 65535
# y tiles of 32
DIRECT_N_FFT_CAP = 2 * (65535 * _DIRECT["bins"] - 1)
_INT_MAX = 2 ** 31 - 1


def _check(xp: torch.Tensor, n_fft: int, hop: int, n_t: int) -> None:
    if n_fft % hop != 0:
        raise ValueError(f"the STFT kernel needs hop ({hop}) to divide n_fft ({n_fft})")
    if xp.dim() != 2 or xp.dtype != torch.float32:
        raise ValueError(f"xp must be (B, Lp) float32, got {tuple(xp.shape)} {xp.dtype}")
    need = (n_t - 1) * hop + n_fft
    if n_t < 1 or xp.shape[1] < need:
        raise ValueError(f"xp rows hold {xp.shape[1]} samples; {n_t} frames need {need}")


def stft_plan(B, Lp, n_t, n_fft, hop, magnitude=False):
    """The launch csrc/stft.cu makes for B rows of Lp samples, n_t frames:
    a dict of ``path`` ("fft": n_fft a power of two in [FFT_MIN, N_FFT_CAP],
    one row and ``frames`` consecutive frames a CTA, the span staged once in
    shared memory, an FFT a frame; "direct": every other n_fft up to
    DIRECT_N_FFT_CAP, 128 frames x 32 bins of the dense product a CTA),
    ``frames`` (a CTA), ``warps`` (a CTA), ``smem`` (shared bytes a CTA),
    ``ctas`` and ``cap`` (the largest n_fft of the path taken). A pure
    function of its arguments, the same as the library's own
    ``sep_stft_plan`` (``magnitude`` changes nothing). Raises ValueError for
    a shape no path takes, naming the cap for n_fft above it."""
    del magnitude
    if n_fft > DIRECT_N_FFT_CAP or n_fft < 2:
        raise ValueError(f"the STFT kernel takes 2 <= n_fft <= {DIRECT_N_FFT_CAP} "
                         f"(DIRECT_N_FFT_CAP: the direct path's grid holds 65535 tiles of "
                         f"{_DIRECT['bins']} bins; the FFT path takes powers of two up to "
                         f"N_FFT_CAP={N_FFT_CAP}), got n_fft={n_fft}")
    if hop < 1 or n_fft % hop != 0:
        raise ValueError(f"the STFT kernel needs hop ({hop}) to divide n_fft ({n_fft})")
    if B < 1 or n_t < 1 or Lp < (n_t - 1) * hop + n_fft:
        raise ValueError(f"B={B} rows of {Lp} samples cannot hold n_t={n_t} frames of "
                         f"{n_fft} at hop {hop}")
    if n_fft & (n_fft - 1) == 0 and FFT_MIN <= n_fft <= N_FFT_CAP:
        M = n_fft // 2
        F = min(MAX_FRAMES, FFT_POINTS // M)
        span = ((F - 1) * hop + n_fft + 6) // 4 * 4      # + up to 3 floats of head
        # + the buffer: the padded transform, or the staged output
        smem = 4 * (span + max(2 * (F * M + F * M // 16), 2 * F * (M + 1) + 12))
        return {"path": "fft", "frames": F, "warps": F * M // PTS // 32, "smem": smem,
                "ctas": B * -(-n_t // F), "cap": N_FFT_CAP}
    n_bins = n_fft // 2 + 1
    ctas = -(-B * n_t // _DIRECT["frames"]) * -(-n_bins // _DIRECT["bins"])
    if ctas > _INT_MAX:
        raise ValueError(f"the direct path's {ctas} CTAs for B={B}, n_t={n_t}, n_fft={n_fft} "
                         f"exceed the {_INT_MAX} a launch counts")
    return {"path": "direct", "frames": _DIRECT["frames"], "warps": _DIRECT["warps"],
            "smem": _DIRECT["smem"], "ctas": ctas, "cap": DIRECT_N_FFT_CAP}


def card_plan(B, Lp, n_t, n_fft, hop, magnitude=False):
    """The plan as the built library computes it (``sep_stft_plan``), in
    stft_plan's keys, or None where the library refuses the shape: what a
    card run holds stft_plan to."""
    vals = [ctypes.c_int(0) for _ in range(6)]
    refused = library("stft").sep_stft_plan(B, Lp, n_t, n_fft, hop, int(magnitude), *vals)
    path, frames, warps, smem, ctas, cap = (v.value for v in vals)
    if refused:
        return None
    return {"path": ("fft", "direct")[path], "frames": frames, "warps": warps, "smem": smem,
            "ctas": ctas, "cap": cap}


@lru_cache(maxsize=8)
def fft_table(n_fft: int) -> np.ndarray:
    """The FFT path's f32 table, each entry rounded from float64: the periodic
    Hann window (n_fft), then exp(-2 pi i k / n_fft) for k < n_fft as
    interleaved (re, im) pairs."""
    k = np.arange(n_fft, dtype=np.float64)
    ang = 2.0 * np.pi * k / n_fft
    tw = np.stack([np.cos(ang), -np.sin(ang)], axis=1).reshape(-1)
    return np.concatenate([hann_periodic(n_fft, np.float64), tw]).astype(np.float32)


@lru_cache(maxsize=16)
def _device_fft_table(n_fft: int, device: torch.device) -> torch.Tensor:
    """One resident copy of ``fft_table`` per device (read-only)."""
    return torch.from_numpy(fft_table(n_fft)).to(device)


def stft_plain(xp: torch.Tensor, n_fft: int, hop: int, n_t: int,
               magnitude: bool = False):
    """The kernel's function in plain PyTorch: unfold the frames, multiply by
    the windowed rDFT matrix in f32."""
    _check(xp, n_fft, hop, n_t)
    n_bins = n_fft // 2 + 1
    frames = xp.unfold(-1, n_fft, hop)[:, :n_t]          # (B, n_t, n_fft)
    spec = torch.matmul(frames, _device_matrix("rdft", n_fft, xp.device))
    re, im = spec[..., :n_bins], spec[..., n_bins:]
    if magnitude:
        return torch.sqrt(re * re + im * im)
    return re.contiguous(), im.contiguous()


def stft(xp: torch.Tensor, n_fft: int, hop: int, n_t: int,
         magnitude: bool = False):
    """Fused STFT over center-padded rows (layout of stft_centered_batch).

    Returns (re, im), each (B, n_t, n_bins) float32, or the magnitude
    (B, n_t, n_bins) when ``magnitude``."""
    if xp.device.type == "cpu":
        return stft_plain(xp, n_fft, hop, n_t, magnitude)
    cuda_device("stft", contiguous=False, xp=xp)
    _check(xp, n_fft, hop, n_t)
    xp = xp.contiguous()
    B, Lp = xp.shape
    plan = stft_plan(B, Lp, n_t, n_fft, hop, magnitude)
    n_bins = n_fft // 2 + 1
    if plan["path"] == "fft":
        table = _device_fft_table(n_fft, xp.device)
    else:
        table = _device_matrix("rdft", n_fft, xp.device)
    out_a = torch.empty((B, n_t, n_bins), dtype=torch.float32, device=xp.device)
    out_b = out_a if magnitude else torch.empty_like(out_a)
    lib = library("stft")
    # the launch and its shared-memory opt-in act on the current device
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        err = lib.sep_stft(xp.data_ptr(), table.data_ptr(), out_a.data_ptr(),
                           out_b.data_ptr(), B, Lp, n_t, n_fft, hop, int(magnitude), stream)
    check_launch(err, "stft", "stft")
    stft.launches += 1
    return out_a if magnitude else (out_a, out_b)


stft.launches = 0
