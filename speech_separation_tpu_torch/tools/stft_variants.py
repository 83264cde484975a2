"""Time design variants of the STFT kernel (K2) against each other on one
card, in one process.

Each variant is the committed csrc/stft.cu with a few text edits (VARIANTS
below). "direct" turns the plan's FFT branch off, so every n_fft runs the
direct path: the dense f32 product, which is the port's first STFT kernel
with its text unchanged, so this times that kernel at shapes the committed
plan sends to the FFT. Every variant is built with nvcc into
build/stft_variants/, called through ctypes on the same rows, held against
``stft_plain`` and timed with CUDA events, the variants in turns (a, b, b,
a). Run from the root of a checkout on a machine with a card:

    python -m speech_separation_tpu_torch.tools.stft_variants \\
        [--variants fft,direct] [--shapes serve features]

It prints the card's name and power limit, then one line per shape, mode,
variant and turn: the device ms a call queued behind a sleep (as
``chip_smoke.check_stft`` times K2) and back to back, and the max error
relative to the largest |X|.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import torch

from ..dsp.stft import _device_matrix
from ..ops import _build
from ..ops.stft_kernel import _device_fft_table, stft_plain

# name -> (what it changes, [(text in the committed source, its replacement)])
VARIANTS = {
    "fft": ("the committed kernel", []),
    "direct": ("every n_fft on the direct path (the dense product)",
               [("if ((n_fft & (n_fft - 1)) == 0 && n_fft >= FFT_MIN && n_fft <= N_FFT_CAP) {",
                 "if (false) {")]),
}
# name -> (B, Lp, n_t): serving (16 rows of 8 s), uPIT on-device features
SHAPES = {"serve": (16, 65536 + 512, 513), "features": (300, 49536, 384)}
N_FFT, HOP = 512, 128
OUT = Path(_build.BUILD_DIR).parent / "stft_variants"


def build(names):
    """Build each named variant; returns its loaded library by name."""
    procs = {}
    for name in names:
        text = (_build.CSRC / "stft.cu").read_text()
        for old, new in VARIANTS[name][1]:
            if text.count(old) != 1:
                raise ValueError(f"edit {old[:60]!r} matches {text.count(old)} places")
            text = text.replace(old, new)
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "stft.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "stft.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc of variant {name} failed:\n{out}")
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sep_stft.argtypes = [p] * 4 + [i] * 6 + [p]
        lib.sep_stft.restype = i
        lib.sep_stft_plan.argtypes = [i] * 6 + [ctypes.POINTER(i)] * 6
        lib.sep_stft_plan.restype = i
        libs[name] = lib
    return libs


def _path(lib, B, Lp, n_t):
    vals = [ctypes.c_int(0) for _ in range(6)]
    if lib.sep_stft_plan(B, Lp, n_t, N_FFT, HOP, 0, *vals):
        raise ValueError(f"the variant refuses B={B} Lp={Lp} n_t={n_t}")
    return ("fft", "direct")[vals[0].value]


def _call(lib, table, xp, out_a, out_b, n_t, magnitude):
    B, Lp = xp.shape
    err = lib.sep_stft(xp.data_ptr(), table.data_ptr(), out_a.data_ptr(), out_b.data_ptr(),
                       B, Lp, n_t, N_FFT, HOP, int(magnitude),
                       torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"sep_stft failed: cudaError {err}")


def _queued_ms(fn, iters):
    """Device ms a call, the calls enqueued behind a sleep so that the
    host's cost of each does not show."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _back_to_back_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="fft,direct")
    ap.add_argument("--shapes", nargs="+", default=list(SHAPES))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    libs = build(names)
    dev = torch.device("cuda")
    tables = {"fft": _device_fft_table(N_FFT, dev), "direct": _device_matrix("rdft", N_FFT, dev)}
    gen = torch.Generator(device=dev).manual_seed(1)
    for shape in args.shapes:
        B, Lp, n_t = SHAPES[shape]
        xp = (torch.rand((B, Lp), generator=gen, device=dev) * 2 - 1) * 0.5
        for magnitude in (False, True):
            ref = stft_plain(xp, N_FFT, HOP, n_t, magnitude)
            ref = ref if isinstance(ref, tuple) else (ref,)
            scale = max(float(r.abs().max()) for r in ref)
            outs = [torch.empty((B, n_t, N_FFT // 2 + 1), device=dev) for _ in range(2)]
            for turn, name in enumerate(names + names[::-1]):
                lib, path = libs[name], _path(libs[name], B, Lp, n_t)

                def fn():
                    _call(lib, tables[path], xp, *outs, n_t, magnitude)
                fn()
                got = outs[:1] if magnitude else outs
                err = max(float((g - r).abs().max()) for g, r in zip(got, ref)) / scale
                q = _queued_ms(fn, args.iters)
                b2b = _back_to_back_ms(fn, args.iters)
                print(f"{shape} B={B} n_t={n_t} magnitude={magnitude} {name} (path {path}) "
                      f"turn {turn}: queued {q:.4f} ms, back to back {b2b:.4f} ms, "
                      f"max err {err:.2e} of the largest |X|", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
