"""The port's native sources: their one table, their build, and the seam every
launch goes through.

``TABLE`` names each source of ``csrc/``: its C functions' signatures, its
error-string function and the Python wrappers (``ops/<module>.<function>``)
that launch it. The CUDA sources (``csrc/*.cu``) hold the kernels; one host
C++ source, ``csrc/sepio.cpp`` (the npz and wav loader, utils/native.py), is
built with g++ and zlib. Adding a kernel touches its source, its wrapper
module, one entry here and the ``KERNELS`` of the archs that launch it.

Each source has a plain C interface and is compiled on its own into a shared
library under ``build/torch_kernels/`` of the checkout, named by a hash of
the source and the flags, so an edited source is rebuilt and an unchanged
one is reused. A build writes a name of its own and renames it into place,
so processes that build one source at once never load a file half written.
The first call that needs a library builds it (``library``); ``build``
starts one compiler per source, all at once, for callers that want every
library up front. Nothing here runs when a module is imported: the CPU tests
import every module on a machine without nvcc.

The wrappers share three helpers: ``library`` (the loaded library, its
functions typed from the table), ``check_launch`` (a non-zero status raised
with the library's own message) and ``cuda_device`` (a wrapper's tensors on
one CUDA device, contiguous). ``launch_counters`` returns every wrapper of
the table; each counts its kernel's launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import importlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")


@dataclasses.dataclass(frozen=True)
class Source:
    """One source of csrc/: ``functions`` maps each C function to its
    (restype, argtypes); ``error_string`` names the function that turns a
    non-zero status into a message; ``wrappers`` are the (ops module,
    function) pairs that launch its kernels; ``host``: csrc/<name>.cpp,
    built with g++ and zlib, else csrc/<name>.cu, built with nvcc."""
    functions: dict
    error_string: str | None = None
    wrappers: tuple = ()
    host: bool = False


_p, _i, _u, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_ip, _fp, _lp = (ctypes.POINTER(t) for t in (ctypes.c_int, ctypes.c_float, ctypes.c_long))
_s, _l = ctypes.c_char_p, ctypes.c_long

TABLE = {
    "lstm_fwd": Source(
        {"sep_lstm_infer": (_i, [_p, _p, _i] + [_p] * 8 + [_i, _i, _i, _i, _u, _p]),
         "sep_lstm_fwd": (_i, [_p, _p, _i] + [_p] * 10 + [_i, _i, _i, _i, _u, _p]),
         "sep_lstm_fwd_plan": (_i, [_i, _i, _i, _i] + [_ip] * 5)},
        "sep_lstm_error_string",
        (("lstm_kernel", "lstm_seq_infer"), ("lstm_kernel", "lstm_seq_fwd"))),
    "lstm_bwd": Source(
        {"sep_lstm_bwd": (_i, [_p, _i] + [_p] * 11 + [_i, _i, _i, _i, _u, _p]),
         "sep_lstm_bwd_plan": (_i, [_i, _i, _i, _i] + [_ip] * 5)},
        "sep_lstm_bwd_error_string", (("lstm_kernel", "lstm_seq_bwd"),)),
    "stft": Source(
        {"sep_stft": (_i, [_p] * 4 + [_i] * 6 + [_p]),
         "sep_stft_plan": (_i, [_i] * 6 + [_ip] * 6)},
        "sep_stft_error_string", (("stft_kernel", "stft"),)),
    "attention": Source(
        {"sep_attn_fwd": (_i, [_p] * 5 + [_i, _i, _i, _i, _f, _p]),
         "sep_attn_bwd": (_i, [_p] * 8 + [_i, _i, _i, _i, _f, _p]),
         "sep_attn_plan": (_i, [_i, _i, _i, _i] + [_ip] * 5)},
        "sep_attn_error_string",
        (("attention_kernel", "chunk_attention_fwd"), ("attention_kernel", "chunk_attention_bwd"))),
    "layernorm": Source(
        {"sep_ln_fwd": (_i, [_p] * 6 + [_i, _i, _i, _f, _p]),
         "sep_ln_bwd": (_i, [_p] * 9 + [_i, _i, _i, _p]),
         "sep_ln_part_rows": (_i, [_i])},
        "sep_ln_error_string",
        (("layernorm_kernel", "channel_norm_fwd"), ("layernorm_kernel", "channel_norm_bwd"))),
    "sepio": Source(
        {"sepio_load_npz_2d_transposed": (_i, [_s, _s, _i, _fp, _fp, _l, _l, _lp, _lp]),
         "sepio_npz_members": (_i, [_s, _s, _l]),
         "sepio_read_wav_f32": (_l, [_s, _fp, _l, _ip])},
        host=True),
}
# the CUDA sources of csrc/, one library each
SOURCES = tuple(n for n, s in TABLE.items() if not s.host)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# ptxas' report (registers, shared memory, spills) of each build, by source
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH, /usr/local/cuda/bin): the CUDA "
                       "kernels of speech_separation_tpu_torch build from "
                       "source at first use")


def _gxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found on PATH: csrc/sepio.cpp builds from source "
                           "at first use")
    return found


def _target(name: str) -> Path:
    if TABLE[name].host:
        src, flags = (CSRC / f"{name}.cpp").read_bytes(), GXX_FLAGS
    else:
        # the headers every CUDA source may include count in its hash
        src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu",
                                                *sorted(CSRC.glob("*.cuh"))])
        flags = NVCC_FLAGS
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _command(name: str, out: Path) -> list[str]:
    if TABLE[name].host:
        return [_gxx(), *GXX_FLAGS, "-o", str(out), str(CSRC / f"{name}.cpp"), "-lz"]
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def is_built(name: str) -> bool:
    """Whether ``csrc/<name>.cu`` (or ``.cpp``) is built for its current hash."""
    return _target(name).exists()


def build(names) -> dict[str, Path]:
    """Compile every named source that is not built yet, one compiler
    process each, all started together, each into a name of its own that is
    renamed into place when it is whole. Returns the library path of each
    name."""
    targets = {n: _target(n) for n in names}
    todo = {n: p for n, p in targets.items() if not p.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for n, p in todo.items():
            tmp = p.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = _command(n, tmp)
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp, p, os.path.basename(cmd[0]))
        failed = []
        for n, (proc, tmp, p, compiler) in procs.items():
            out, _ = proc.communicate()
            build_logs[n] = out
            if proc.returncode != 0:
                failed.append(f"{compiler} {n} failed ({proc.returncode}):\n{out}")
                continue
            os.replace(tmp, p)
        if failed:
            raise RuntimeError("\n".join(failed))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (or ``.cpp``), built on
    first use, each of its functions typed as ``TABLE`` says."""
    lib = _libs.get(name)           # every launch asks: no lock once it is loaded
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            src = TABLE[name]
            lib = ctypes.CDLL(str(build([name])[name]))
            for fn, (restype, argtypes) in src.functions.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            if src.error_string:
                getattr(lib, src.error_string).restype = ctypes.c_char_p
                getattr(lib, src.error_string).argtypes = [ctypes.c_int]
            _libs[name] = lib
        return lib


def check_launch(err: int, name: str, what: str) -> None:
    """Raise RuntimeError for a non-zero status of a call into library
    ``name``, with ``what`` and the library's own message."""
    if err != 0:
        message = getattr(library(name), TABLE[name].error_string)(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {message}")


def cuda_device(wrapper: str, contiguous: bool = True, **tensors):
    """The one CUDA device of a wrapper's tensors: the first one's, which
    must be a CUDA device, every other on it too; with ``contiguous`` each
    must be contiguous (a wrapper that copies its operands into contiguous
    ones passes False). Raises ValueError naming the wrapper or the
    tensor."""
    dev = next(iter(tensors.values())).device
    if dev.type != "cuda":
        raise ValueError(f"{wrapper} runs on cuda or cpu tensors, not {dev}")
    for n, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{n} is on {t.device}, not {dev}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{wrapper} takes contiguous tensors; {n} is not")
    return dev


def launch_counters() -> list:
    """Every wrapper of ``TABLE``, in its order: each counts its kernel's
    launches in ``.launches``."""
    return [getattr(importlib.import_module(f"{__package__}.{mod}"), fn)
            for src in TABLE.values() for mod, fn in src.wrappers]
