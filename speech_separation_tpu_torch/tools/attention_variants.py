"""Time design variants of the bf16 attention kernels (K5) against the
committed ones on one card, in one process.

Each variant is the committed csrc/attention.cu and csrc/attention_mma.cuh
with a few text edits (VARIANTS below: the design choices that the card
decided). Every variant is built with nvcc into build/attention_variants/,
called through ctypes on the same tensors, and timed with CUDA events, the
variants in turns, twice over. Run from the root of a checkout on a machine
with a card:

    python -m speech_separation_tpu_torch.tools.attention_variants \\
        [--variants base,ieee_div] [--shapes 10624,100 12800,83]

It prints the card's name and power limit, then one line per shape,
variant and turn: forward and backward ms (dh=16, every key valid).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import torch

from ..ops import _build

# name -> (what it changes, [(text in the committed sources, its replacement)])
VARIANTS = {
    "base": ("the committed kernels", []),
    "ieee_div": ("w32 = __fdiv_rn(e, sum) for every (query, key), no reciprocal",
                 [("bool slow = false;", "bool slow = true;")]),
    "recompute": ("no backward stores its weights: the key phase recomputes them",
                  [("STORE_BUDGET = 115712", "STORE_BUDGET = 0")]),
    "bwd_passes": ("a backward above the stored path's T goes over key tiles",
                   [("    if (backward && stored <= STORE_BUDGET) return {2, 1, WARPS_STORE, "
                     "stored, N};\n",
                     "    if (backward && stored <= STORE_BUDGET) return {2, 1, WARPS_STORE, "
                     "stored, N};\n    if (backward) return {1, 1, WARPS_PASS, 16 * Tp + 4 * QR"
                     " + 2 * QR * rs2 + 2 * (2 * kt * rs2 + 4 * kt), N};\n")]),
    "cap128": ("whole logit rows in registers only up to T = 128",
               [("constexpr int REG_CAP = 256;", "constexpr int REG_CAP = 128;")]),
    "row_budget_75k": ("a forward CTA takes rows up to 75 KB of shared memory (3 a SM)",
                       [("ROW_BUDGET = 57344", "ROW_BUDGET = 76800")]),
}
OUT = Path(_build.BUILD_DIR).parent / "attention_variants"


def _sources(edits):
    texts = {n: (_build.CSRC / n).read_text() for n in ("attention.cu", "attention_mma.cuh")}
    for old, new in edits:
        hits = [n for n, t in texts.items() if old in t]
        if len(hits) != 1:
            raise ValueError(f"edit {old[:60]!r} matches {len(hits)} sources")
        texts[hits[0]] = texts[hits[0]].replace(old, new)
    return texts


def build(names):
    """Build each named variant; returns its loaded library by name."""
    procs = {}
    for name in names:
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in _sources(VARIANTS[name][1]).items():
            (d / fname).write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "attention.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc of variant {name} failed:\n{out}")
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sep_attn_fwd.argtypes = [p] * 5 + [i, i, i, i, f, p]
        lib.sep_attn_bwd.argtypes = [p] * 8 + [i, i, i, i, f, p]
        libs[name] = lib
    return libs


def _ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        err = fn()
    end.record()
    end.synchronize()
    if err:
        raise RuntimeError(f"launch failed: {err}")
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--shapes", nargs="*", default=["10624,100", "12800,83", "400,1230"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attention_variants: no CUDA device is visible")
    names = args.variants.split(",")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    for name in names:
        print(f"  {name}: {VARIANTS[name][0]}")
    libs = build(names)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    dh, scale = 16, 0.25
    for shape in args.shapes:
        N, T = (int(x) for x in shape.split(","))
        q, k, v, do = (torch.randn((N, T, dh), generator=gen, device="cuda").bfloat16()
                       for _ in range(4))
        mask = torch.ones((N, T), device="cuda")
        o, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
        for turn in range(2):
            for name in (names if turn == 0 else names[::-1]):
                lib = libs[name]
                fwd = _ms(lambda: lib.sep_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                                   mask.data_ptr(), o.data_ptr(), 1, N, T, dh,
                                                   scale, stream), 20)
                bwd = _ms(lambda: lib.sep_attn_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                                   mask.data_ptr(), do.data_ptr(), dq.data_ptr(),
                                                   dk.data_ptr(), dv.data_ptr(), 1, N, T, dh,
                                                   scale, stream), 10)
                print(f"N={N} T={T} turn {turn} {name:15s} fwd {fwd:.4f} ms  bwd {bwd:.4f} ms",
                      flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
