"""Fused framing + windowed real-DFT STFT: the wrapper of csrc/stft.cu.

Replaces the TPU kernel speech_separation_tpu/ops/stft_pallas.py::stft_pallas
(same semantics as dsp.stft.stft_centered_batch). On the H100 the work is an
f32 product of (B*n_t, n_fft) by (n_fft, 2*n_bins), bound by the f32 FMA
rate (TF32 stays off, matching Precision.HIGHEST); the kernel frames the
padded rows inside its loads so the 4x frame expansion never reaches device
memory, and fuses the magnitude into its epilogue. The source note in
csrc/stft.cu has the tiling.

``stft`` launches the kernel for CUDA tensors and runs ``stft_plain`` (unfold
plus matmul) only for CPU tensors; ``stft.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..dsp.stft import _device_matrix

_lib_handle = None


def _lib():
    global _lib_handle
    if _lib_handle is None:
        from ._build import load
        lib = load("stft")
        lib.sep_stft.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.sep_stft.restype = ctypes.c_int
        lib.sep_stft_error_string.argtypes = [ctypes.c_int]
        lib.sep_stft_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def _check(xp: torch.Tensor, n_fft: int, hop: int, n_t: int) -> None:
    if n_fft % hop != 0:
        raise ValueError(f"the STFT kernel needs hop ({hop}) to divide n_fft ({n_fft})")
    if xp.dim() != 2 or xp.dtype != torch.float32:
        raise ValueError(f"xp must be (B, Lp) float32, got {tuple(xp.shape)} {xp.dtype}")
    need = (n_t - 1) * hop + n_fft
    if n_t < 1 or xp.shape[1] < need:
        raise ValueError(f"xp rows hold {xp.shape[1]} samples; {n_t} frames need {need}")


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
    if xp.device.type != "cuda":
        raise ValueError(f"stft runs on cuda or cpu tensors, not {xp.device}")
    _check(xp, n_fft, hop, n_t)
    xp = xp.contiguous()
    B, Lp = xp.shape
    n_bins = n_fft // 2 + 1
    A = _device_matrix("rdft", n_fft, xp.device)
    out_a = torch.empty((B, n_t, n_bins), dtype=torch.float32, device=xp.device)
    out_b = out_a if magnitude else torch.empty_like(out_a)
    lib = _lib()
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    err = lib.sep_stft(xp.data_ptr(), A.data_ptr(), out_a.data_ptr(), out_b.data_ptr(),
                       B, Lp, n_t, n_fft, hop, int(magnitude), stream)
    if err != 0:
        raise RuntimeError(f"stft kernel launch failed: "
                           f"{lib.sep_stft_error_string(err).decode()}")
    stft.launches += 1
    return out_a if magnitude else (out_a, out_b)


stft.launches = 0
