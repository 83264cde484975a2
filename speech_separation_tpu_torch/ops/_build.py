"""Build the port's native sources with nvcc or g++ and load them.

The CUDA sources (``csrc/*.cu``) hold the kernels; one host C++ source,
``csrc/sepio.cpp`` (the npz and wav loader, utils/native.py), is built with
g++ and zlib. Each source has a plain C interface and is compiled on its own
into a shared library under ``build/torch_kernels/`` of the checkout, named
by a hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is reused. A build writes a name of its own and renames it
into place, so processes that build one source at once never load a file
half written. The first call that needs a library builds it; ``build``
starts one compiler per source, all at once, for callers that want every
library up front. Nothing here runs when a module is imported: the CPU tests
import every module on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
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

# every CUDA source of csrc/ with a plain C interface, one library each
SOURCES = ("lstm_fwd", "lstm_bwd", "stft", "attention", "layernorm")
# the host C++ sources of csrc/, built with g++ (and linked with zlib)
HOST_SOURCES = ("sepio",)

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
    if name in HOST_SOURCES:
        src, flags = (CSRC / f"{name}.cpp").read_bytes(), GXX_FLAGS
    else:
        # the headers every CUDA source may include count in its hash
        src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu",
                                                *sorted(CSRC.glob("*.cuh"))])
        flags = NVCC_FLAGS
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _command(name: str, out: Path) -> list[str]:
    if name in HOST_SOURCES:
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


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (or ``.cpp``), built on
    first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build([name])[name]
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib
