"""ctypes bindings for the native data-loading runtime (csrc/sepio.cpp).

The port's counterpart of speech_separation_tpu/utils/native.py. The
library is built from the port's own source at first use, with g++ and
zlib, and its functions typed, through ops/_build.py (hash-named under
``build/torch_kernels/``, written to a name of its own and renamed into
place, so processes that build it at once are safe). Every entry point has
a pure-Python counterpart that gives the same arrays: the collation in
train/data.py and ``load_wav`` in utils/audio.py use the native path when it
is available and numpy otherwise.

``SEPSEP_NATIVE=0`` turns it off, as in the JAX package. ``status()`` says
whether it loaded, and why not.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

_lock = threading.Lock()
_lib = None
_tried = False
_why_not = ""

_FLOAT_P = ctypes.POINTER(ctypes.c_float)


def _load_library():
    global _lib, _tried, _why_not
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("SEPSEP_NATIVE", "1") == "0":
            _why_not = "turned off (SEPSEP_NATIVE=0)"
            return None
        from ..ops import _build
        try:
            _lib = _build.library("sepio")
        except (RuntimeError, OSError) as e:
            _why_not = f"build or load failed: {e}"
        return _lib


def available() -> bool:
    """Whether the native library is built and loaded (building it at the
    first call)."""
    return _load_library() is not None


def status() -> str:
    """"loaded (<library path>)", or why the library is not available."""
    lib = _load_library()
    return f"loaded ({lib._name})" if lib is not None else f"not available: {_why_not}"


def npz_member_names(path: str) -> list[str] | None:
    """Member names of an npz, or None if native is unavailable."""
    lib = _load_library()
    if lib is None:
        return None
    buf = ctypes.create_string_buffer(4096)
    n = lib.sepio_npz_members(path.encode(), buf, len(buf))
    if n < 0:
        raise IOError(f"sepio_npz_members({path}) failed: {n}")
    return [s for s in buf.value.decode().split("\n") if s]


def load_npz_2d_transposed(path: str, member: str, out: np.ndarray, mode: int = 0,
                           out2: np.ndarray | None = None) -> tuple[int, int]:
    """Inflate the npz member ``member`` (stored (rows, cols)) transposed into
    ``out``, a pre-zeroed C-contiguous float32 (out_rows, out_cols) array.
    mode 0: a float32 copy; 1: |complex| or float32; 2: complex, re into
    ``out`` and im into ``out2``. Returns (true_rows, true_cols) of the
    transposed view, (T, F) for a feature file."""
    lib = _load_library()
    if lib is None:
        raise RuntimeError(f"native loader {status()}")
    for a in (out,) if out2 is None else (out, out2):
        if (a.dtype != np.float32 or a.ndim != 2 or not a.flags.c_contiguous
                or a.shape != out.shape):
            raise ValueError("outputs must be 2-D C-contiguous float32 arrays of one shape")
    if mode == 2 and out2 is None:
        raise ValueError("mode 2 writes the imaginary plane into out2")
    tr, tc = ctypes.c_long(), ctypes.c_long()
    p2 = out2.ctypes.data_as(_FLOAT_P) if out2 is not None else None
    rc = lib.sepio_load_npz_2d_transposed(
        path.encode(), member.encode(), mode, out.ctypes.data_as(_FLOAT_P), p2,
        out.shape[0], out.shape[1], ctypes.byref(tr), ctypes.byref(tc))
    if rc != 0:
        raise IOError(f"sepio_load_npz_2d_transposed({path}:{member}) -> {rc}")
    return tr.value, tc.value


def read_wav_f32(path: str) -> tuple[np.ndarray, int] | None:
    """Decode a wav to float32 mono, or None if native is unavailable."""
    lib = _load_library()
    if lib is None:
        return None
    sr = ctypes.c_int()
    n = lib.sepio_read_wav_f32(path.encode(), None, 0, ctypes.byref(sr))
    if n < 0:
        raise IOError(f"sepio_read_wav_f32({path}) -> {n}")
    out = np.empty(n, np.float32)
    got = lib.sepio_read_wav_f32(path.encode(), out.ctypes.data_as(_FLOAT_P), n,
                                 ctypes.byref(sr))
    if got < 0:
        raise IOError(f"sepio_read_wav_f32({path}) -> {got}")
    return out[:got], sr.value
