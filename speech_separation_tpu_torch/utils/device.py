"""The device an entry point runs on, and the float32 set-up of a card's
products that every path shares."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Without a visible card it raises; it never falls back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; the port runs on the GPU "
                           "(pass device='cpu' for the plain PyTorch versions)")
    return dev


def disable_tf32(cudnn: bool = False) -> None:
    """Every float32 product in full float32, as the reference's
    Precision.HIGHEST and f32 dots (TF32 keeps about 3 digits): TF32 off for
    matmuls and, with ``cudnn``, for cuDNN's convolutions too. The flags are
    process-wide."""
    torch.backends.cuda.matmul.allow_tf32 = False
    if cudnn:
        torch.backends.cudnn.allow_tf32 = False
