"""Benchmark of the PyTorch port on one CUDA card: the root ``bench.py``'s
ten phases, with its names, batches and merged JSON line.

Run as ``python -m speech_separation_tpu_torch.cli.main bench`` (or ``python
-m speech_separation_tpu_torch.bench``). Prints one JSON line after each
phase; the last line is the full merge:
  {"metric": ..., "value": N, "unit": "utts/sec/chip", "detail": {...}}

The headline is the reference's training hot loop at reference scale: uPIT
BLSTM 2x600, 257 bins, 2 speakers, batch 100 of 384 frames, forward + PIT
loss + backward + global-norm clip + Adam, through the port's hand-written
LSTM kernels (K3, K4). The other phases time every arch's full training
step, the STFT -> iSTFT round trip and serving, as the root bench.py does;
together they launch all five kernels.

Each phase runs in a child process (``--phase <name>``), so a CUDA fault or
one phase's allocator peak stays in its child. The parent never initialises
CUDA: it probes the card in a killable child first (no card, or a probe that
fails, ends the run with a message and a non-zero exit; the CPU is never
measured), then builds every kernel source the phases need with nvcc
(``ops/_build.build``, cached by source hash under build/torch_kernels/) and
reports ``build_s``, cold or from the cache. Steps and batches are timed by
the host clock between ``torch.cuda.synchronize()`` calls; no value is read
back inside a timed loop. After the timed loop each training phase, and
serving, traces a few more steps or batches with torch.profiler and reports
the device's idle share: one minus the union of its kernels' and copies'
intervals over the window's wall (the profiler's own host cost is in that
wall). Each child reports its kernels' launch counts.

Budget gate: SEPSEP_BENCH_BUDGET (seconds, default 1700, counted from
process start) bounds the run. A phase whose worst-case wall (``WORST_S``,
measured on an H100) does not fit the remaining budget is skipped and named
under ``skipped_phases``. A phase that fails (a non-zero exit, no result, or
SEPSEP_BENCH_PHASE_TIMEOUT, default 900 s, passed) is a fault: it is named
under ``failed_phases`` and the run exits non-zero. No phase is retried.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULT_TAG = "BENCH_PHASE_RESULT "
# steps or batches in each idle-share window, after the timed loop
PROFILE_STEPS = 3


# --------------------------------------------------------------------------
# measurement bodies (run inside a child process via --phase <name>)
# --------------------------------------------------------------------------

def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def idle_share(fn, n: int) -> dict:
    """The device's idle share over ``n`` calls of ``fn`` under
    torch.profiler: one minus the union of the device's kernel and copy
    intervals over the host's wall for the window, which ends in a
    synchronize. Raises if the trace holds no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        raise RuntimeError("torch.profiler saw no device activity in the idle-share window")
    busy, reached = 0.0, float("-inf")
    for s, e in spans:
        busy += max(0.0, e - max(s, reached))
        reached = max(reached, e)
    return {"idle_share": 1.0 - busy / wall_us, "busy_ms": busy / 1e3 / n,
            "window_ms": wall_us / 1e3 / n}


def _build_model(arch, cfg, dev, state_dict=None):
    """The arch's model with weights from seed 0 (or ``state_dict``) and one
    trainable bias per LSTM direction, on ``dev``, and its optimizer (clip
    0.25, Adam 1e-3)."""
    import torch

    from .train.loop import Optimizer, TrainLoopConfig
    from .utils.device import disable_tf32
    from .utils.weights import fold_lstm_biases
    model = arch.Model(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    if state_dict is not None:
        model.load_state_dict(state_dict)
    fold_lstm_biases(model)
    model.to(dev)
    # f32 products in full f32, as the trainer and the JAX package run them
    disable_tf32()
    return model, Optimizer(model.parameters(), TrainLoopConfig())


def _time_steps(step, dev, iters: int) -> tuple[dict, object, object]:
    """The first call's wall (``compile_s``: the port compiles nothing, so
    this is the first step's library loads and set-up), then ``iters``
    calls timed between synchronizes, then the idle share over
    PROFILE_STEPS more (on a card). Returns (result, first output, last
    timed output)."""
    t0 = time.perf_counter()
    out = first = step()
    _sync(dev)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step()
    _sync(dev)
    dt = (time.perf_counter() - t0) / iters
    res = {"step_ms": dt * 1e3, "compile_s": compile_s}
    if dev.type == "cuda":
        res.update(idle_share(step, PROFILE_STEPS))
    return res, first, out


def bench_train_step(B=100, T=384, iters=20, compute_dtype="bfloat16",
                     arch_name="uPIT", device="cuda", model_kwargs=None,
                     state_dict=None):
    """Full training step of a spectral arch (uPIT, RSH, TCN) on bench.py's
    batch: |N(0, 1)| mixture and source magnitudes from default_rng(0),
    every row T frames long; the initial LSTM states drawn from a generator
    seeded 1 on the device. ``first_loss`` is the first step's loss (at the
    initial weights), ``loss`` the last timed step's."""
    import torch

    from .utils.device import resolve_device
    from .models.registry import get_arch
    from .train.loop import update_step

    dev = resolve_device(device)
    arch = get_arch(arch_name)
    cfg = arch.Config.from_kwargs(compute_dtype=compute_dtype, **(model_kwargs or {}))
    model, optimizer = _build_model(arch, cfg, dev, state_dict)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in spectral_batch(B, T, cfg.num_spk, cfg.feat_dim).items()}
    generator = torch.Generator(device=dev).manual_seed(1)
    res, (first, _), (loss, _) = _time_steps(
        lambda: update_step(arch, model, optimizer, batch, generator), dev, iters)
    res.update(utts_per_sec=B / (res["step_ms"] / 1e3), loss=float(loss),
               first_loss=float(first))
    return res


def bench_train_step_wave(arch_name: str, B=32, n_sec=4.0, iters=10,
                          compute_dtype="bfloat16", remat=True, device="cuda",
                          model_kwargs=None):
    """Full training step of a time-domain arch (SepFormer, DPRNN,
    Conv-TasNet; SI-SNR uPIT) on bench.py's batch: B utterances of n_sec
    seconds at 8 kHz, sources 0.1 * N(0, 1) from default_rng(0), the mixture
    their sum, every row full length. bench.py runs all three without remat
    (its PHASES); so does this one."""
    import torch

    from .utils.device import resolve_device
    from .models.registry import get_arch
    from .train.loop import update_step

    dev = resolve_device(device)
    arch = get_arch(arch_name)
    cfg = arch.Config.from_kwargs(compute_dtype=compute_dtype, remat=remat,
                                  **(model_kwargs or {}))
    model, optimizer = _build_model(arch, cfg, dev)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in wave_batch(B, n_sec, cfg.num_spk).items()}
    res, _, _ = _time_steps(lambda: update_step(arch, model, optimizer, batch, None), dev,
                            iters)
    dt = res["step_ms"] / 1e3
    res.update(utts_per_sec=B / dt, audio_sec_per_sec=B * n_sec / dt)
    return res


def bench_dsp_bandwidth(B=64, n_sec=6.0, iters=20, device="cuda", warmup_s=1.0):
    """STFT (K2, re/im) -> unit mask -> iSTFT round trip on bench.py's
    batch: GB/s of audio samples in and out. Round trips run for
    ``warmup_s`` before the timed ones: 20 round trips of about a
    millisecond alone read 0.91 and 2.91 ms in two processes on the same
    card."""
    import torch

    from .dsp.stft import istft_batch, num_frames, stft_centered_batch
    from .utils.device import resolve_device

    dev = resolve_device(device)
    xp, counts = dsp_batch(B, n_sec)
    n_fft, hop = 512, 128
    n_t = num_frames(int(n_sec * 8000), hop)
    x, c = torch.from_numpy(xp).to(dev), torch.from_numpy(counts).to(dev)

    def roundtrip():
        re, im = stft_centered_batch(x, n_fft, hop, n_t)
        return istft_batch(re, im, c, hop)

    t_end = time.perf_counter() + warmup_s
    y = roundtrip()
    while time.perf_counter() < t_end:
        y = roundtrip()
        _sync(dev)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        y = roundtrip()
    _sync(dev)
    dt = (time.perf_counter() - t0) / iters
    gbytes = (xp.nbytes + y.numel() * y.element_size()) / 1e9
    return {"gb_per_sec": gbytes / dt, "roundtrip_ms": dt * 1e3,
            "audio_sec_per_sec": B * n_sec / dt}


def bench_serving(B=16, n_sec=6.0, rounds=6, clients=8, reqs_per_client=4,
                  upit_kwargs=None, device="cuda"):
    """The serving path (eval/pipeline.py): wav in -> STFT (K2) -> BLSTM
    masks (K1) -> masked iSTFT -> wav out, bench.py's full-size uPIT with
    weights from seed 0, host<->device copies included. (1) B signals of
    0.1 * N(0, 1) from default_rng(0) through the pipeline, timed over
    ``rounds`` batches after a first one, then the idle share over
    PROFILE_STEPS more; (2) per-request p50/p99 latency through the
    resident server (eval/serve.py) under ``clients`` concurrent
    single-file connections of ``reqs_per_client`` requests each."""
    import tempfile
    import threading

    import torch

    from .utils.device import resolve_device
    from .eval.pipeline import SeparationPipeline
    from .eval.serve import SeparationServer, request
    from .models import upit
    from .train.checkpoint import save_checkpoint
    from .utils.audio import write_wav_int16

    dev = resolve_device(device)
    cfg = upit.Config.from_kwargs(**(upit_kwargs or {}))   # full size by default
    model = upit.UPIT(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "m.mdl")
        save_checkpoint(path, model, meta={"arch": "uPIT", "model_kwargs": {
            k: str(v) for k, v in (upit_kwargs or {}).items()}})
        pipe = SeparationPipeline(path, batch_size=B, device=dev)
        sigs = serving_signals(B, n_sec)
        pipe.separate(sigs)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(rounds):
            pipe.separate(sigs)
        _sync(dev)
        dt = (time.perf_counter() - t0) / rounds
        res = {"utts_per_sec": B / dt, "batch_ms": dt * 1e3,
               "audio_sec_per_sec": B * n_sec / dt}
        if dev.type == "cuda":
            res.update(idle_share(lambda: pipe.separate(sigs), PROFILE_STEPS))

        wav_paths = []
        for i in range(clients):
            p = os.path.join(d, f"in_{i}.wav")
            write_wav_int16(p, 8000, (sigs[i % B] * 20000).astype(np.int16))
            wav_paths.append(p)
        sock_path = os.path.join(d, "serve.sock")
        server = SeparationServer(pipe, sock_path, coalesce=clients)
        server.warmup([n_sec])
        st = threading.Thread(target=server.serve_forever, daemon=True)
        st.start()
        deadline = time.time() + 30
        while not os.path.exists(sock_path) and time.time() < deadline:
            time.sleep(0.05)
        errors = []

        def _client(i: int) -> None:
            out_dir = os.path.join(d, f"out_{i}")
            for _ in range(reqs_per_client):
                r = request(sock_path, {"wavs": [wav_paths[i]], "out_dir": out_dir})
                if not r.get("ok"):
                    errors.append(r.get("error", "?"))

        t0 = time.time()
        threads = [threading.Thread(target=_client, args=(i,)) for i in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.time() - t0
        ping = request(sock_path, {"cmd": "ping"})
        request(sock_path, {"cmd": "shutdown"})
        st.join(timeout=10)
        lat = ping.get("latency_ms", {})
        n_req = clients * reqs_per_client
        res.update({"p50_ms": lat.get("p50"), "p99_ms": lat.get("p99"),
                    "concurrent_clients": clients,
                    "server_utts_per_sec": (n_req - len(errors)) / wall,
                    "server_errors": len(errors)})
    return res


# the batches, as bench.py builds them from default_rng(0)

def spectral_batch(B: int, T: int, S: int, F: int) -> dict:
    rng = np.random.default_rng(0)
    return {"mix": np.abs(rng.standard_normal((B, T, F))).astype(np.float32),
            "sources": np.abs(rng.standard_normal((B, S, T, F))).astype(np.float32),
            "lengths": np.full(B, T, np.int32),
            "row_mask": np.ones(B, np.float32)}


def wave_batch(B: int, n_sec: float, S: int) -> dict:
    rng = np.random.default_rng(0)
    L = int(n_sec * 8000)
    srcs = (0.1 * rng.standard_normal((B, S, L))).astype(np.float32)
    return {"mix_wav": srcs.sum(axis=1), "source_wavs": srcs,
            "sample_lengths": np.full(B, L, np.int32),
            "row_mask": np.ones(B, np.float32)}


def dsp_batch(B: int, n_sec: float) -> tuple[np.ndarray, np.ndarray]:
    from .dsp.stft import num_frames
    n_fft, hop = 512, 128
    L = int(n_sec * 8000)
    rng = np.random.default_rng(0)
    xp = rng.standard_normal((B, L + n_fft)).astype(np.float32)
    return xp, np.full(B, num_frames(L, hop), np.int32)


def serving_signals(B: int, n_sec: float) -> list:
    rng = np.random.default_rng(0)
    return [(0.1 * rng.standard_normal(int(8000 * n_sec))).astype(np.float32)
            for _ in range(B)]


# phase name -> zero-arg callable returning the raw result dict, in
# bench.py's order (each family's headline first). SepFormer runs with
# fused_attention=1: its attention through the port's K5 kernel.
PHASES = {
    "upit_bf16": lambda: bench_train_step(),
    "convtasnet": lambda: bench_train_step_wave("ConvTasNet", remat=False),
    "sepformer": lambda: bench_train_step_wave("SepFormer", remat=False,
                                               model_kwargs={"fused_attention": "1"}),
    "dprnn": lambda: bench_train_step_wave("DPRNN", remat=False),
    "rsh": lambda: bench_train_step(iters=10, arch_name="RSH"),
    "dsp": lambda: bench_dsp_bandwidth(),
    "serving": lambda: bench_serving(),
    "tcn": lambda: bench_train_step(iters=10, arch_name="TCN"),
    "upit_f32": lambda: bench_train_step(iters=10, compute_dtype="float32"),
    "upit_b128": lambda: bench_train_step(B=128, iters=10),
}
# each phase's arch, for the kernel sources it needs (models/registry.py);
# dsp runs no model, only the STFT
PHASE_ARCHS = {"upit_bf16": "uPIT", "convtasnet": "ConvTasNet", "sepformer": "SepFormer",
               "dprnn": "DPRNN", "rsh": "RSH", "dsp": None, "serving": "uPIT",
               "tcn": "TCN", "upit_f32": "uPIT", "upit_b128": "uPIT"}

# Worst-case wall seconds of each phase's child: three times its slowest wall
# on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 5: 9-36 s). The
# parent builds the kernels before any phase, so a child's wall is the same
# with a cold or a warm build cache; the cold build itself (41 s of nvcc,
# four sources at once; 0.0 s from the cache) is paid before the first phase
# and counts against the budget.
WORST_S = {"upit_bf16": 65, "convtasnet": 100, "sepformer": 70, "dprnn": 100,
           "rsh": 65, "dsp": 30, "serving": 60, "tcn": 110, "upit_f32": 70,
           "upit_b128": 70}


def phase_sources(names) -> list:
    """The kernel sources the named phases launch, in one list."""
    from .models.registry import ARCH_KERNELS
    wanted = set()
    for name in names:
        arch = PHASE_ARCHS[name]
        wanted.update(ARCH_KERNELS[arch] if arch else ("stft",))
    return sorted(wanted)


def card_name() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed ({r.returncode}): {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def run_phase_child(name: str) -> int:
    """Child-process entry: run one phase on the card and print its raw
    result (with the card, and each kernel's launches) as one tagged JSON
    line."""
    import torch

    from .ops._build import launch_counters
    if not torch.cuda.is_available():
        print("bench: no CUDA device is visible", file=sys.stderr)
        return 2
    counters = launch_counters()
    for c in counters:
        c.launches = 0
    res = PHASES[name]()
    torch.cuda.synchronize()
    res["launches"] = {c.__name__: c.launches for c in counters}
    res["device"] = card_name()
    print(RESULT_TAG + json.dumps(res), flush=True)
    return 0


# --------------------------------------------------------------------------
# parent orchestration (never initialises CUDA in-process)
# --------------------------------------------------------------------------

PROBE_SRC = ("import time,torch;t=time.time();assert torch.cuda.is_available(),'no CUDA "
             "device is visible';x=float(torch.ones((8,8),device='cuda').sum());"
             "print(torch.cuda.device_count(),round(time.time()-t,3),"
             "torch.cuda.get_device_name(0))")


def probe_device(timeout: float = 120.0) -> dict:
    """Probe the card in a killable child: ``{"ok": True, "count",
    "latency_s" (a trivial op's wall, CUDA initialisation included),
    "name"}``, or ``{"ok": False, "error"}``."""
    try:
        r = subprocess.run([sys.executable, "-c", PROBE_SRC], capture_output=True,
                           text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"ok": False, "error": f"no device initialisation within {timeout:.0f} s"}
    line = (r.stdout or "").strip().splitlines()[-1:] if r.returncode == 0 else []
    if line:
        count, latency, name = line[0].split(" ", 2)
        return {"ok": True, "count": int(count), "latency_s": float(latency), "name": name}
    tail = ((r.stderr or "").strip().splitlines() or ["?"])[-1]
    return {"ok": False, "error": f"exit {r.returncode}: {tail}"}


def build_kernels(sources) -> dict:
    """Build the sources with nvcc (cached by hash): ``{"build_s",
    "build": "cold" or "cache"}``, cold if any source was not yet built."""
    from .ops import _build
    cold = any(not _build.is_built(n) for n in sources)
    t0 = time.perf_counter()
    _build.build(sources)
    return {"build_s": time.perf_counter() - t0, "build": "cold" if cold else "cache"}


def run_phase_process(name: str, deadline: float) -> tuple[dict | None, str]:
    """Run one phase in a child process: (raw result, "") or (None, why)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH", "")) if p)
    try:
        r = subprocess.run([sys.executable, "-m", f"{__package__}.bench", "--phase", name],
                           capture_output=True, text=True, timeout=deadline, env=env)
    except subprocess.TimeoutExpired:
        return None, f"timed out after {deadline:.0f}s"
    line = next((ln for ln in r.stdout.splitlines() if ln.startswith(RESULT_TAG)), None)
    if r.returncode == 0 and line:
        return json.loads(line[len(RESULT_TAG):]), ""
    tail = (r.stderr or r.stdout or "").strip().splitlines()[-3:]
    return None, f"rc={r.returncode}: " + " | ".join(tail)


# detail key -> (phase, raw key, round digits); assembled only for phases
# that completed. bench.py's fields, then the port's idle shares.
DETAIL_FIELDS = [
    ("step_ms", "upit_bf16", "step_ms", 2),
    ("compile_s", "upit_bf16", "compile_s", 1),
    ("f32_parity_path_utts_per_sec", "upit_f32", "utts_per_sec", 2),
    ("b128_utts_per_sec", "upit_b128", "utts_per_sec", 2),
    ("rsh_utts_per_sec", "rsh", "utts_per_sec", 2),
    ("rsh_step_ms", "rsh", "step_ms", 2),
    ("tcn_utts_per_sec", "tcn", "utts_per_sec", 2),
    ("tcn_step_ms", "tcn", "step_ms", 2),
    ("convtasnet_utts_per_sec", "convtasnet", "utts_per_sec", 2),
    ("convtasnet_step_ms", "convtasnet", "step_ms", 2),
    ("convtasnet_audio_sec_per_sec", "convtasnet", "audio_sec_per_sec", 0),
    ("dprnn_utts_per_sec", "dprnn", "utts_per_sec", 2),
    ("dprnn_step_ms", "dprnn", "step_ms", 2),
    ("sepformer_utts_per_sec", "sepformer", "utts_per_sec", 2),
    ("sepformer_step_ms", "sepformer", "step_ms", 2),
    ("sepformer_audio_sec_per_sec", "sepformer", "audio_sec_per_sec", 0),
    ("dsp_roundtrip_gb_per_sec", "dsp", "gb_per_sec", 2),
    ("dsp_audio_sec_per_sec", "dsp", "audio_sec_per_sec", 0),
    ("serving_utts_per_sec", "serving", "utts_per_sec", 2),
    ("serving_audio_sec_per_sec", "serving", "audio_sec_per_sec", 0),
    ("serving_p50_ms", "serving", "p50_ms", 2),
    ("serving_p99_ms", "serving", "p99_ms", 2),
    ("serving_concurrent_utts_per_sec", "serving", "server_utts_per_sec", 2),
] + [(f"{p}_idle_share", p, "idle_share", 3)
     for p in ("upit_bf16", "convtasnet", "sepformer", "dprnn", "rsh", "serving", "tcn",
               "upit_f32", "upit_b128")]
IDLE_FIELDS = {k for k, *_ in DETAIL_FIELDS if k.endswith("_idle_share")}


def merged_line(results: dict, failures: dict, probe_latency: float,
                phase_stats: dict | None = None, skipped: dict | None = None,
                build: dict | None = None) -> str:
    """bench.py's merged JSON line for the port: its keys and values but its
    CPU baseline (``vs_baseline``, ``baseline_*``), the card (name and power
    limit) as ``device``, each phase's idle share, and the build's
    ``build_s`` and ``build`` (cold or cache)."""
    head = results.get("upit_bf16")
    value = round(head["utts_per_sec"], 2) if head else 0
    detail = {}
    for out_key, phase, raw_key, nd in DETAIL_FIELDS:
        if phase in results and results[phase].get(raw_key) is not None:
            v = results[phase][raw_key]
            detail[out_key] = round(v, nd) if nd else round(v)
    if probe_latency != float("inf"):
        detail["backend_probe_latency_s"] = round(probe_latency, 3)
    for res in results.values():
        if "device" in res:
            detail["device"] = res["device"]
            break
    if build:
        detail["build_s"] = round(build["build_s"], 2)
        detail["build"] = build["build"]
    if phase_stats:
        detail["phases"] = phase_stats
    if failures:
        detail["failed_phases"] = failures
    if skipped:
        detail["skipped_phases"] = skipped
    if not head:
        detail["error"] = ("headline phase did not complete; see "
                           "failed_phases")
    out = {
        "metric": "uPIT train throughput (B=100, T=384, 2x600 BLSTM, "
                  "full step, bf16+CUDA kernels)",
        "value": value,
        "unit": "utts/sec/chip",
        "detail": detail,
    }
    return json.dumps(out)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def select_phases(arg: str) -> list:
    """A comma list of phase names, kept in PHASES order (all if empty)."""
    names = [n.strip() for n in arg.split(",") if n.strip()]
    unknown = [n for n in names if n not in PHASES]
    if unknown:
        raise SystemExit(f"bench: unknown phase(s) {unknown} (phases: {list(PHASES)})")
    return [n for n in PHASES if not names or n in names]


def run_phases(names, t_start: float, budget: float, phase_timeout: float,
               emit) -> tuple[dict, dict, dict, dict]:
    """Run each phase under the budget gate, calling ``emit(results,
    failures, skipped, phase_stats)`` after each: (results, failures,
    skipped, phase_stats)."""
    results, failures, skipped, phase_stats = {}, {}, {}, {}
    for name in names:
        remaining = budget - (time.time() - t_start)
        if remaining < WORST_S[name]:
            skipped[name] = f"skipped: {remaining:.0f}s left < {WORST_S[name]}s worst-case"
            print(f"# bench: phase {name} SKIPPED ({skipped[name]})", file=sys.stderr,
                  flush=True)
        else:
            print(f"# bench: phase {name}", file=sys.stderr, flush=True)
            t0 = time.time()
            res, why = run_phase_process(name, min(phase_timeout, max(remaining - 10, 60)))
            dt = time.time() - t0
            if res is None:
                failures[name] = why
            else:
                results[name] = res
                phase_stats[name] = {"wall_s": round(dt, 1),
                                     "compile_s": round(res["compile_s"], 1)
                                     if "compile_s" in res else None,
                                     "launches": res.get("launches")}
            print(f"# bench: phase {name} {'ok' if res else 'FAILED (' + why + ')'} "
                  f"[{dt:.0f}s]", file=sys.stderr, flush=True)
        emit(results, failures, skipped, phase_stats)
    return results, failures, skipped, phase_stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench", description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", help="(child) run one phase and print its raw result")
    ap.add_argument("--rsh", action="store_true",
                    help="measure the RSH full train step instead of the phases")
    ap.add_argument("--phases", default="",
                    help="comma list of phases to run (default all, in PHASES order)")
    args = ap.parse_args(argv)
    if args.phase:
        if args.phase not in PHASES:
            raise SystemExit(f"bench: unknown phase {args.phase!r}")
        return run_phase_child(args.phase)

    t_start = time.time()
    names = ["rsh"] if args.rsh else select_phases(args.phases)
    probe = probe_device()
    if not probe["ok"]:
        print(f"bench: the card probe failed ({probe['error']}); the bench measures a "
              "CUDA card and never the CPU", file=sys.stderr)
        return 2
    build = build_kernels(phase_sources(names))
    print(f"# bench: {probe['name']} ({probe['count']} device(s)); kernels "
          f"{phase_sources(names)} built in {build['build_s']:.1f}s ({build['build']})",
          file=sys.stderr, flush=True)
    budget = _env_float("SEPSEP_BENCH_BUDGET", 1700.0)
    phase_timeout = _env_float("SEPSEP_BENCH_PHASE_TIMEOUT", 900.0)

    if args.rsh:
        results, failures, _, _ = run_phases(names, t_start, budget, phase_timeout,
                                             lambda *a: None)
        if failures:
            print(f"bench: rsh failed ({failures['rsh']})", file=sys.stderr)
            return 1
        res = results["rsh"]
        print(json.dumps({"metric": "RSH train throughput (B=100, T=384, S=2, 2x600 BLSTM, "
                                    "full step, bf16+CUDA kernels)",
                          "value": round(res["utts_per_sec"], 2), "unit": "utts/sec/chip",
                          "detail": {"step_ms": round(res["step_ms"], 2),
                                     "compile_s": round(res["compile_s"], 1),
                                     "idle_share": round(res["idle_share"], 3),
                                     "device": res["device"],
                                     "build_s": round(build["build_s"], 2)}}))
        return 0

    def emit(results, failures, skipped, phase_stats):
        print(merged_line(results, failures, probe["latency_s"], phase_stats,
                          skipped, build), flush=True)

    _, failures, _, _ = run_phases(names, t_start, budget, phase_timeout, emit)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
