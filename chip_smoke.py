#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the final line:
1. device report (nvidia-smi name and power limit, torch device name);
2. build every kernel of the path from csrc/ with nvcc for sm_90a, one nvcc
   per source, all at once;
3. each kernel against its plain PyTorch version on the card, at the
   serving shapes (an 8 s bucket of 16 rows: T=513 frames, 2x600 BLSTM) and
   at a small ragged shape, with the kernel's time, the plain version's
   time, one PyTorch library call's time (a yardstick the port never calls)
   and the least time the card could take (bound_ms);
4. serve: a 2x600 bf16 uPIT with weights from a seed, saved as a reference
   .mdl, behind the port's SeparationServer on a Unix socket; one request,
   then two concurrent ones, then a ping; every output wav is checked, and
   one request's tracks are held against the same pipeline on the CPU
   (plain versions) by SNR. Kernel launch counts are zeroed just before
   the requests and read just after;
5. one JSON line with every kernel and its numbers, then
   {"ok": true, "device": {...}} as the last line.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor / f32 CUDA cores
# Set from the card's own readings (NVIDIA H100 80GB HBM3, 700 W), with about
# ten times room: K1 bf16 1.4e-4, f32 6.3e-7; K2 2.5e-5 abs at |X| <= 23, i.e.
# 1.1e-6 relative; served tracks 72.4 dB against the CPU plain path.
TOL = {"lstm_bf16": 2e-3, "lstm_f32": 1e-5, "stft_rel": 1e-5}
MIN_SNR_DB = 50.0


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of fn over iters calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class Failures(list):
    def check(self, ok: bool, what: str) -> None:
        print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
        if not ok:
            self.append(what)


# ------------------------------------------------------------------ kernels

def lstm_inputs(T, B, H, dtype, lengths, gen):
    dev = "cuda"
    G = 4 * H
    k = 1.0 / np.sqrt(H)
    xw = (0.5 * torch.randn((T, 2, B, G), generator=gen, device=dev)).to(dtype)
    w = ((torch.rand((2, H, G), generator=gen, device=dev) * 2 - 1) * k).to(dtype)
    h0 = torch.randn((2, B, H), generator=gen, device=dev)
    c0 = torch.randn((2, B, H), generator=gen, device=dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return xw, w, h0, c0, lens


def check_lstm(fails: Failures) -> dict:
    from speech_separation_tpu_torch.ops.lstm_kernel import (lstm_seq_infer,
                                                             lstm_seq_infer_plain)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sfx = (False, True)
    # small ragged: rows past one 16-row chunk, units past one 16-unit tile
    for dtype, tol in ((torch.bfloat16, TOL["lstm_bf16"]), (torch.float32, TOL["lstm_f32"])):
        args = lstm_inputs(9, 20, 40, dtype, [9, 1, 4, 9, 7] * 4, gen)
        got = lstm_seq_infer(*args, suffix_dirs=sfx)
        ref = lstm_seq_infer_plain(*args, suffix_dirs=sfx)
        torch.cuda.synchronize()
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        fails.check(err <= tol, f"lstm_infer small ragged {dtype}: max_abs_err {err:.3e} <= {tol}")

    T, B, H = 513, 16, 600
    rng = np.random.default_rng(SEED)
    lengths = [T, 1] + rng.integers(1, T + 1, size=B - 2).tolist()
    out = {}
    for dtype, tol in ((torch.bfloat16, TOL["lstm_bf16"]), (torch.float32, TOL["lstm_f32"])):
        xw, w, h0, c0, lens = args = lstm_inputs(T, B, H, dtype, lengths, gen)
        got = lstm_seq_infer(*args, suffix_dirs=sfx)
        ref = lstm_seq_infer_plain(*args, suffix_dirs=sfx)
        torch.cuda.synchronize()
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        fails.check(err <= tol, f"lstm_infer T={T} B={B} H={H} {dtype}: "
                                f"max_abs_err {err:.3e} <= {tol}")
        ms = cuda_ms(lambda: lstm_seq_infer(*args, suffix_dirs=sfx), iters=10)
        plain_ms = cuda_ms(lambda: lstm_seq_infer_plain(*args, suffix_dirs=sfx),
                           iters=2, warmup=0)
        # cuDNN's bidirectional LSTM over the 257-bin input at the same B, T:
        # a yardstick only (it also does the input projection)
        lstm = torch.nn.LSTM(257, H, bidirectional=True).to("cuda", dtype)
        lstm.flatten_parameters()
        x = torch.randn((T, B, 257), generator=gen, device="cuda").to(dtype)
        with torch.inference_mode():
            library_ms = cuda_ms(lambda: lstm(x), iters=10)
        valid_steps = 2 * sum(lengths)          # both directions
        flops = valid_steps * 2 * H * 4 * H
        io = nbytes(xw, w, h0, c0, lens, *got)
        b_ms, b_by = bound_ms(io, flops, dtype)
        out[dtype] = {"max_abs_err": err, "tolerance": tol, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}
        print(f"  lstm_infer {dtype}: {ms:.3f} ms (plain {plain_ms:.1f}, cuDNN "
              f"{library_ms:.3f}, bound {b_ms:.4f} by {b_by})", flush=True)
    return out


def check_stft(fails: Failures) -> dict:
    from speech_separation_tpu_torch.dsp.stft import _device_matrix
    from speech_separation_tpu_torch.ops.stft_kernel import stft, stft_plain
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    n_fft, hop = 512, 128

    def rel_err(got, ref):
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        scale = max(float(r.abs().max()) for r in ref)
        return max(float((g - r).abs().max()) for g, r in zip(got, ref)), scale

    xs = torch.rand((3, 1000 + n_fft + 37), generator=gen, device="cuda") * 2 - 1
    for magnitude in (False, True):
        err, scale = rel_err(stft(xs, n_fft, hop, 8, magnitude), stft_plain(xs, n_fft, hop, 8, magnitude))
        fails.check(err <= TOL["stft_rel"] * scale,
                    f"stft small ragged magnitude={magnitude}: max_abs_err {err:.3e} "
                    f"<= {TOL['stft_rel']} * {scale:.1f}")

    B, Lp = 16, 65536 + n_fft
    n_t = 1 + 65536 // hop
    xp = (torch.rand((B, Lp), generator=gen, device="cuda") * 2 - 1) * 0.5
    out = {}
    for magnitude in (False, True):
        got = stft(xp, n_fft, hop, n_t, magnitude)
        ref = stft_plain(xp, n_fft, hop, n_t, magnitude)
        err, scale = rel_err(got, ref)
        torch.cuda.synchronize()
        tol = TOL["stft_rel"] * scale
        fails.check(err <= tol, f"stft B={B} n_t={n_t} magnitude={magnitude}: "
                                f"max_abs_err {err:.3e} <= {tol:.3e}")
        ms = cuda_ms(lambda: stft(xp, n_fft, hop, n_t, magnitude), iters=20)
        plain_ms = cuda_ms(lambda: stft_plain(xp, n_fft, hop, n_t, magnitude), iters=20)
        A = _device_matrix("rdft", n_fft, xp.device)
        library_ms = cuda_ms(lambda: torch.matmul(xp.unfold(-1, n_fft, hop)[:, :n_t], A),
                             iters=20)
        flops = 2 * B * n_t * n_fft * A.shape[1]
        outs = got if isinstance(got, tuple) else (got,)
        b_ms, b_by = bound_ms(nbytes(xp, A, *outs), flops, torch.float32)
        out[magnitude] = {"max_abs_err": err, "tolerance": tol, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}
        print(f"  stft magnitude={magnitude}: {ms:.4f} ms (plain {plain_ms:.4f}, "
              f"unfold@A {library_ms:.4f}, bound {b_ms:.4f} by {b_by})", flush=True)
    return out


# -------------------------------------------------------------------- serve

def mixture(n: int, rng) -> np.ndarray:
    """Two synthetic sources: a harmonic tone with vibrato, bursts of noise."""
    t = np.arange(n) / 8000.0
    f0 = 180 + 40 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / 8000.0
    s1 = sum(np.sin(k * phase) / k for k in range(1, 6))
    noise = np.convolve(rng.standard_normal(n), np.ones(4) / 4, mode="same")
    s2 = noise * (np.sin(2 * np.pi * 1.3 * t) > 0)
    mix = s1 + s2
    return (0.5 * mix / np.max(np.abs(mix))).astype(np.float32)


def snr_db(ref: np.ndarray, est: np.ndarray) -> float:
    return float(10 * np.log10(np.sum(ref ** 2) / max(np.sum((ref - est) ** 2), 1e-20)))


def serve_phase(fails: Failures, counters) -> dict:
    """Phase 4: a 2x600 bf16 uPIT served on the card."""
    from speech_separation_tpu_torch.dsp.stft import istft_output_length, num_frames
    from speech_separation_tpu_torch.eval.pipeline import SeparationPipeline
    from speech_separation_tpu_torch.eval.serve import SeparationServer, request
    from speech_separation_tpu_torch.models import upit
    from speech_separation_tpu_torch.utils.audio import (limit_peak, load_wav,
                                                         write_wav_int16)

    work = os.path.join(REPO, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg = upit.Config(feat_dim=257, num_spk=2, hidden=600, num_layers=2)
    model = upit.UPIT(cfg)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    mdl = os.path.join(work, "upit_2x600.mdl")
    torch.save(model.state_dict(), mdl)
    kw = {"compute_dtype": "bfloat16", "zero_init_hidden": "1"}

    rng = np.random.default_rng(SEED)
    wavs = []
    for k, sec in enumerate((3.0, 5.5, 8.0, 6.2)):
        path = os.path.join(work, f"mix{k}.wav")
        write_wav_int16(path, 8000, mixture(int(sec * 8000), rng))
        wavs.append(path)

    pipe = SeparationPipeline(mdl, model_kwargs=kw, batch_size=16, seed=SEED, device="cuda")
    sock_dir = tempfile.mkdtemp(prefix="sepsmoke")
    sock = os.path.join(sock_dir, "s.sock")
    server = SeparationServer(pipe, sock, coalesce=8)
    n_warm = server.warmup([8.0])
    print(f"  warmup: {n_warm} bucket(s)", flush=True)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    replies = {}
    try:
        deadline = time.monotonic() + 60
        while not os.path.exists(sock):
            if time.monotonic() > deadline:
                raise RuntimeError("server never bound its socket")
            time.sleep(0.02)

        for c in counters:
            c.launches = 0
        t0 = time.monotonic()
        replies["r1"] = request(sock, {"wavs": wavs[:1], "out_dir": os.path.join(work, "r1")})

        def send(name, idx):
            replies[name] = request(sock, {"wavs": [wavs[i] for i in idx],
                                           "out_dir": os.path.join(work, name)})

        pair = [threading.Thread(target=send, args=("r2", [1, 2])),
                threading.Thread(target=send, args=("r3", [3]))]
        for th in pair:
            th.start()
        for th in pair:
            th.join(timeout=300)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
        launches = {c.__name__: c.launches for c in counters}
        ping = request(sock, {"cmd": "ping"})
    finally:
        server.shutdown()
        thread.join(timeout=30)
        shutil.rmtree(sock_dir, ignore_errors=True)
    fails.check(not thread.is_alive(), "server thread stopped")

    for name in ("r1", "r2", "r3"):
        rep = replies.get(name, {})
        fails.check(bool(rep.get("ok")), f"request {name} ok ({rep.get('ms')} ms)")
        for wav, paths in rep.get("outputs", {}).items():
            n = len(load_wav(wav)[0])
            want = istft_output_length(num_frames(n, 128), 128)
            for p in paths:
                y, sr = (load_wav(p) if os.path.exists(p) else (np.zeros(0), 0))
                fails.check(sr == 8000 and len(y) == want and np.all(np.isfinite(y)),
                            f"{os.path.basename(p)}: {len(y)} samples, want {want}")
    fails.check(bool(ping.get("ok")) and ping.get("served") == 3,
                f"ping: served {ping.get('served')}, buckets {ping.get('compiled_buckets')}, "
                f"latency {ping.get('latency_ms')}")
    print(f"  requests: r1 {replies['r1'].get('ms')} ms, r2 {replies['r2'].get('ms')} ms, "
          f"r3 {replies['r3'].get('ms')} ms; wall {wall_ms:.1f} ms", flush=True)

    # the first request against the same pipeline on the CPU (plain versions)
    cpu = SeparationPipeline(mdl, model_kwargs=kw, batch_size=16, seed=SEED, device="cpu")
    x = load_wav(wavs[0])[0]
    ref = limit_peak(cpu.separate([x])[0])
    for s, path in enumerate(replies["r1"]["outputs"][wavs[0]]):
        got = load_wav(path)[0]
        snr = snr_db(np.asarray(ref[s], np.float32) * (32767 / 32768), got)
        fails.check(snr >= MIN_SNR_DB, f"r1 track {s + 1} vs CPU plain versions: "
                                       f"SNR {snr:.1f} dB >= {MIN_SNR_DB}")

    # the reference's N(0, 1) initial state, drawn on the card
    rand = SeparationPipeline(mdl, model_kwargs={"compute_dtype": "bfloat16"},
                              batch_size=16, seed=SEED, device="cuda")
    tracks = rand.separate([x])[0]
    fails.check(len(tracks) == 2 and all(np.all(np.isfinite(t)) for t in tracks),
                "random initial state: finite tracks")
    return {"launches": launches, "request_ms": {k: v.get("ms") for k, v in replies.items()},
            "wall_ms": wall_ms}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from speech_separation_tpu_torch.ops import _build
    from speech_separation_tpu_torch.ops.lstm_kernel import lstm_seq_infer
    from speech_separation_tpu_torch.ops.stft_kernel import stft

    t_start = time.monotonic()
    fails = Failures()
    print("== 1. device", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(smi)
    print(f"  torch {torch.__version__} cuda {torch.version.cuda}: {kind}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)
    # the plain versions' f32 products must not run in TF32 (the pipeline
    # owns that setting, and phase 3 runs before any pipeline exists)
    fails.check(not torch.backends.cuda.matmul.allow_tf32, "f32 matmul without TF32")
    torch.backends.cudnn.allow_tf32 = False      # the f32 cuDNN yardstick in full f32

    print("== 2. build", flush=True)
    t0 = time.monotonic()
    _build.build(["lstm_infer", "stft"])
    print(f"  nvcc (parallel): {time.monotonic() - t0:.1f} s", flush=True)
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    print("== 3. kernels against their plain versions", flush=True)
    lstm = check_lstm(fails)
    stft_nums = check_stft(fails)

    print("== 4. serve (2x600 uPIT, bf16)", flush=True)
    served = serve_phase(fails, [lstm_seq_infer, stft])
    launches = served["launches"]
    for name, n in launches.items():
        fails.check(n > 0, f"{name} launched {n} times while serving")

    def row(name, route, source, replaces, nums, extra):
        return {"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": launches[name], **{k: nums[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                **extra}

    kernels = [
        row("lstm_seq_infer", "cuda", "speech_separation_tpu_torch/csrc/lstm_infer.cu",
            "speech_separation_tpu/ops/lstm_pallas.py:288", lstm[torch.bfloat16],
            {"dtype": "bfloat16", "float32": lstm[torch.float32]}),
        row("stft", "cuda", "speech_separation_tpu_torch/csrc/stft.cu",
            "speech_separation_tpu/ops/stft_pallas.py:77", stft_nums[False],
            {"magnitude": stft_nums[True]}),
    ]
    print(f"  serve: {served}", flush=True)
    print(f"  total {time.monotonic() - t_start:.1f} s", flush=True)
    if fails:
        print("chip_smoke FAILED:\n  " + "\n  ".join(fails), file=sys.stderr)
        return 1
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
