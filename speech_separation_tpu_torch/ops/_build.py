"""Build the port's CUDA sources (``csrc/*.cu``) with nvcc and load them.

Each source has a plain C interface and is compiled on its own into a shared
library under ``build/torch_kernels/`` of the checkout, named by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one is
reused. The first call that launches a kernel builds it; ``build`` starts one
nvcc per source, all at once, for callers that want every kernel up front.
Nothing here runs when a module is imported: the CPU tests import every
module on a machine without nvcc.
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

# every source of csrc/ with a plain C interface, one library each
SOURCES = ("lstm_fwd", "lstm_bwd", "stft", "attention")

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


def _target(name: str) -> Path:
    # the headers every source may include count in every source's hash
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu",
                                            *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def is_built(name: str) -> bool:
    """Whether ``csrc/<name>.cu`` is built for its current hash."""
    return _target(name).exists()


def build(names) -> dict[str, Path]:
    """Compile every named source that is not built yet, one nvcc process
    each, all started together. Returns the library path of each name."""
    targets = {n: _target(n) for n in names}
    todo = {n: p for n, p in targets.items() if not p.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for n, p in todo.items():
            tmp = p.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp, p)
        failed = []
        for n, (proc, tmp, p) in procs.items():
            out, _ = proc.communicate()
            build_logs[n] = out
            if proc.returncode != 0:
                failed.append(f"nvcc {n}.cu failed ({proc.returncode}):\n{out}")
                continue
            os.replace(tmp, p)
        if failed:
            raise RuntimeError("\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build([name])[name]
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib
