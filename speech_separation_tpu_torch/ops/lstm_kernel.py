"""LSTM inference recurrence: the wrapper of csrc/lstm_infer.cu.

Replaces the TPU kernel speech_separation_tpu/ops/lstm_pallas.py::
lstm_seq_infer (``_fwd_infer_kernel``): the full T-step recurrence of both
directions of one BLSTM layer in one launch, with prefix masks for the
forward direction and suffix masks for the time-flipped reverse one.

On the H100 the recurrence is a chain of T dependent (B, H) x (H, 4H)
products per direction, and one direction's W_hh (2.88 MB in bf16 at H=600)
is far larger than an SM's shared memory. The kernel splits the hidden units
over a cooperative grid of D * ceil(H/16) CTAs, each keeping its slice of
W_hh resident for the whole sequence and exchanging h_t through L2 with a
grid barrier per step; csrc/lstm_infer.cu has the design note.

``lstm_seq_infer`` launches the kernel for CUDA tensors and runs
``lstm_seq_infer_plain`` (a Python loop over t) only for CPU tensors;
``lstm_seq_infer.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

_lib_handle = None


def _lib():
    global _lib_handle
    if _lib_handle is None:
        from ._build import load
        lib = load("lstm_infer")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sep_lstm_infer.argtypes = ([p, p, i] + [p] * 8
                                       + [i, i, i, i, ctypes.c_uint, p])
        lib.sep_lstm_infer.restype = ctypes.c_int
        lib.sep_lstm_error_string.argtypes = [i]
        lib.sep_lstm_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def _dims(xw, w_hh, h0, c0, lengths, suffix_dirs):
    if xw.dim() != 4 or w_hh.dim() != 3:
        raise ValueError(f"xw must be (T, D, B, 4H) and w_hh (D, H, 4H), got "
                         f"{tuple(xw.shape)} and {tuple(w_hh.shape)}")
    T, D, B, G = xw.shape
    H = G // 4
    if G != 4 * H or tuple(w_hh.shape) != (D, H, G):
        raise ValueError(f"w_hh {tuple(w_hh.shape)} does not match xw {tuple(xw.shape)}")
    for name, s in (("h0", h0), ("c0", c0)):
        if tuple(s.shape) != (D, B, H) or s.dtype != torch.float32:
            raise ValueError(f"{name} must be ({D}, {B}, {H}) float32, got "
                             f"{tuple(s.shape)} {s.dtype}")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be ({B},), got {tuple(lengths.shape)}")
    if xw.dtype not in (torch.float32, torch.bfloat16) or w_hh.dtype != xw.dtype:
        raise ValueError(f"xw and w_hh must both be float32 or both bfloat16, got "
                         f"{xw.dtype} and {w_hh.dtype}")
    if T < 1:
        raise ValueError("xw has no time steps")
    suffix_dirs = tuple(suffix_dirs) if suffix_dirs is not None else (False,) * D
    if len(suffix_dirs) != D:
        raise ValueError(f"suffix_dirs has {len(suffix_dirs)} entries for {D} directions")
    return T, D, B, H, suffix_dirs


def _step_mask(lengths, t, T, suffix_dirs):
    """(D, B, 1) float32: prefix mask t < length, or for a flipped-input
    direction the suffix mask length > T-1-t."""
    return torch.stack([(lengths > (T - 1 - t)) if s else (lengths > t)
                        for s in suffix_dirs]).to(torch.float32)[:, :, None]


def lstm_seq_infer_plain(xw, w_hh, h0, c0, lengths, suffix_dirs=None):
    """The kernel's function in plain PyTorch, one step at a time:
    returns (ys (T, D, B, H), h_last (D, B, H), c_last (D, B, H)), f32."""
    T, D, B, H, suffix_dirs = _dims(xw, w_hh, h0, c0, lengths, suffix_dirs)
    w = w_hh.float()
    h, c = h0, c0
    ys = []
    for t in range(T):
        m = _step_mask(lengths, t, T, suffix_dirs)
        # h_{t-1} is rounded to the weight type; the sum stays f32
        h_in = h.to(w_hh.dtype).float()
        gates = xw[t].float() + torch.bmm(h_in, w)
        ia = torch.sigmoid(gates[..., :H])
        fa = torch.sigmoid(gates[..., H:2 * H])
        ga = torch.tanh(gates[..., 2 * H:3 * H])
        oa = torch.sigmoid(gates[..., 3 * H:])
        c_new = fa * c + ia * ga
        h_new = oa * torch.tanh(c_new)
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        ys.append(m * h_new)
    return torch.stack(ys), h, c


def lstm_seq_infer(xw, w_hh, h0, c0, lengths, suffix_dirs=None):
    """Inference-only recurrence: returns (ys (T, D, B, H) f32,
    h_last (D, B, H) f32, c_last (D, B, H) f32).

    xw: (T, D, B, 4H) gate inputs and w_hh: (D, H, 4H), both bf16 or both
    f32; h0, c0: (D, B, H) f32; lengths: (B,) int; suffix_dirs: per
    direction, True for a time-flipped input (suffix mask)."""
    if xw.device.type == "cpu":
        return lstm_seq_infer_plain(xw, w_hh, h0, c0, lengths, suffix_dirs)
    if xw.device.type != "cuda":
        raise ValueError(f"lstm_seq_infer runs on cuda or cpu tensors, not {xw.device}")
    T, D, B, H, suffix_dirs = _dims(xw, w_hh, h0, c0, lengths, suffix_dirs)
    dev = xw.device
    for name, t in (("w_hh", w_hh), ("h0", h0), ("c0", c0), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, xw on {dev}")
    xw, w_hh = xw.contiguous(), w_hh.contiguous()
    h0, c0 = h0.contiguous(), c0.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    ys = torch.empty((T, D, B, H), dtype=torch.float32, device=dev)
    h_last = torch.empty((D, B, H), dtype=torch.float32, device=dev)
    c_last = torch.empty_like(h_last)
    hbuf = torch.empty((2, D, B, H), dtype=torch.float32, device=dev)
    barrier = torch.zeros((1,), dtype=torch.int32, device=dev)
    suffix_mask = sum(1 << d for d, s in enumerate(suffix_dirs) if s)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.sep_lstm_infer(
        xw.data_ptr(), w_hh.data_ptr(), int(xw.dtype == torch.bfloat16),
        h0.data_ptr(), c0.data_ptr(), lengths.data_ptr(), ys.data_ptr(),
        h_last.data_ptr(), c_last.data_ptr(), hbuf.data_ptr(), barrier.data_ptr(),
        T, D, B, H, suffix_mask, stream)
    if err != 0:
        raise RuntimeError(f"lstm_infer kernel launch failed: "
                           f"{lib.sep_lstm_error_string(err).decode()}")
    lstm_seq_infer.launches += 1
    return ys, h_last, c_last


lstm_seq_infer.launches = 0
