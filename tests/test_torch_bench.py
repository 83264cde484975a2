"""The port's bench (speech_separation_tpu_torch/bench.py) and its CLI tools
(bench, warmup, doctor) on the CPU, where there is no card and no nvcc.

bench measures only a CUDA card; here its phase bodies run with
device="cpu" at tiny widths to check what they compute and return, never
to time anything. Tolerance: the tiny uPIT step's first loss against the
JAX package's make_update_step on the same batch and weights, rtol 1e-5 (one
f32 forward, sums in another order).
"""

import json
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bench as jbench
from speech_separation_tpu.models import upit as jupit
from speech_separation_tpu.train.loop import (TrainLoopConfig as JaxLoopConfig,
                                              make_optimizer, make_update_step)
from speech_separation_tpu_torch import bench
from speech_separation_tpu_torch.cli.main import main
from speech_separation_tpu_torch.models.registry import ARCH_KERNELS, ARCHS
from speech_separation_tpu_torch.ops import _build, lstm_kernel
from speech_separation_tpu_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(1)  # six xdist workers share the cores: one thread each, for life

TINY = {"uPIT": {"hidden": 8, "num_layers": 1},
        "RSH": {"hidden": 8, "num_layers": 1},
        "TCN": {"channels": 8, "hidden": 12, "blocks": 2, "repeats": 1},
        "SepFormer": {"channels": 8, "heads": 2, "d_ff": 16, "chunk": 8, "blocks": 1,
                      "n_filters": 8, "fused_attention": "1"},
        "DPRNN": {"channels": 8, "rnn_hidden": 8, "chunk": 8, "blocks": 1, "n_filters": 8},
        "ConvTasNet": {"n_filters": 8, "channels": 8, "hidden": 12, "blocks": 2,
                       "repeats": 1}}


# ------------------------------------------------------------- merged line

def _results():
    return {
        "upit_bf16": {"utts_per_sec": 901.234, "step_ms": 110.96, "compile_s": 2.31,
                      "loss": 1.0, "idle_share": 0.123, "device": "NVIDIA H100, 700.00 W"},
        "sepformer": {"utts_per_sec": 210.5, "step_ms": 152.0, "compile_s": 1.2,
                      "audio_sec_per_sec": 842.0, "idle_share": 0.4},
        "dsp": {"gb_per_sec": 33.3, "roundtrip_ms": 1.5, "audio_sec_per_sec": 2.5e5},
        "serving": {"utts_per_sec": 500.0, "batch_ms": 32.0, "audio_sec_per_sec": 3000.0,
                    "p50_ms": 30.0, "p99_ms": 61.0, "server_utts_per_sec": 90.0,
                    "idle_share": 0.5},
    }


@pytest.mark.parametrize("failures", [{}, {"dprnn": "rc=1: CUDA error"}])
def test_merged_line_matches_bench_py(failures):
    stats = {"upit_bf16": {"wall_s": 20.0, "compile_s": 2.3}}
    want = json.loads(jbench.merged_line(_results(), failures, 1.86, 0.5, stats))
    got = json.loads(bench.merged_line(_results(), failures, 0.5, stats))
    # the port's line leaves out bench.py's CPU baseline
    want.pop("vs_baseline")
    for k in ("baseline_utts_per_sec", "baseline_hw"):
        want["detail"].pop(k)
    idle = {k for k in got["detail"] if k.endswith("_idle_share")}
    assert idle == {"upit_bf16_idle_share", "sepformer_idle_share", "serving_idle_share"}
    assert got["detail"]["upit_bf16_idle_share"] == 0.123
    for d in (want, got):
        d["detail"].pop("device")
        # the metric's text names the kernels (Pallas there, CUDA here)
        d.pop("metric")
    for k in idle:
        got["detail"].pop(k)
    assert got == want


def test_merged_line_reports_skips_and_the_build_apart_from_failures():
    line = json.loads(bench.merged_line(
        _results(), {"dprnn": "rc=1"}, 0.5, None,
        skipped={"tcn": "skipped: 10s left < 120s worst-case"},
        build={"build_s": 0.0123, "build": "cache"}))
    d = line["detail"]
    assert d["failed_phases"] == {"dprnn": "rc=1"}
    assert d["skipped_phases"] == {"tcn": "skipped: 10s left < 120s worst-case"}
    assert (d["build_s"], d["build"]) == (0.01, "cache")
    assert line["value"] == 901.23


# ------------------------------------------------------------------ batches

class _Stop(Exception):
    pass


def _capture_jax_batch(monkeypatch, phase: str):
    """The batch bench.py's phase body builds, caught where it first hands
    it on (its model init, optimizer and step stubbed)."""
    import speech_separation_tpu.models.registry as jreg
    import speech_separation_tpu.train.loop as jloop
    seen = {}

    class Cfg:
        num_spk, feat_dim = 2, 257

        def __init__(self, **kw):
            pass

    class Arch:
        Config = Cfg

        @staticmethod
        def init(key, cfg):
            return {}, {}

    class Opt:
        def init(self, params):
            return {}

    def make_step(arch, cfg, optimizer):
        def step(params, state, opt_state, batch, key):
            seen.update({k: np.asarray(v) for k, v in batch.items()})
            raise _Stop
        return step

    monkeypatch.setattr(jreg, "get_arch", lambda name: Arch)
    monkeypatch.setattr(jloop, "make_optimizer", lambda cfg: Opt())
    monkeypatch.setattr(jloop, "make_update_step", make_step)
    if phase == "dsp":
        def jit(fn):
            def run(x, c):
                seen.update(xp=np.asarray(x), counts=np.asarray(c))
                raise _Stop
            return run
        monkeypatch.setattr(jax, "jit", jit)
    if phase == "serving":
        import speech_separation_tpu.eval.pipeline as jpipe
        import speech_separation_tpu.models.upit as jup
        import speech_separation_tpu.train.checkpoint as jckpt

        class Pipe:
            def __init__(self, *a, **kw):
                pass

            def separate(self, sigs):
                seen["sigs"] = [np.asarray(s) for s in sigs]
                raise _Stop
        monkeypatch.setattr(jpipe, "SeparationPipeline", Pipe)
        monkeypatch.setattr(jup, "init", lambda key, cfg: ({}, {}))
        monkeypatch.setattr(jckpt, "save_checkpoint", lambda *a, **kw: None)
    with pytest.raises(_Stop):
        {"spectral": lambda: jbench.bench_train_step(B=3, T=16),
         "wave": lambda: jbench.bench_train_step_wave("DPRNN", B=3, n_sec=0.25),
         "dsp": lambda: jbench.bench_dsp_bandwidth(B=3, n_sec=0.25),
         "serving": lambda: jbench.bench_serving(B=3, n_sec=0.25)}[phase]()
    return seen


@pytest.mark.parametrize("phase", ["spectral", "wave", "dsp", "serving"])
def test_each_phase_batch_is_bench_py_s(monkeypatch, phase):
    want = _capture_jax_batch(monkeypatch, phase)
    if phase == "spectral":
        got = bench.spectral_batch(3, 16, 2, 257)
    elif phase == "wave":
        got = bench.wave_batch(3, 0.25, 2)
    elif phase == "dsp":
        got = dict(zip(("xp", "counts"), bench.dsp_batch(3, 0.25)))
    else:
        got = {"sigs": bench.serving_signals(3, 0.25)}
    assert sorted(got) == sorted(want)
    for k in want:
        for a, b in zip(np.atleast_1d(want[k]) if k != "sigs" else want[k],
                        np.atleast_1d(got[k]) if k != "sigs" else got[k]):
            np.testing.assert_array_equal(a, b)
        if k != "sigs":
            assert want[k].dtype == got[k].dtype and want[k].shape == got[k].shape


# ------------------------------------------------------------- phase bodies

TRAIN_KEYS = {"utts_per_sec", "step_ms", "compile_s"}


@pytest.mark.parametrize("arch", ["uPIT", "RSH", "TCN"])
def test_spectral_phase_body_runs_on_the_cpu(arch):
    res = bench.bench_train_step(B=2, T=8, iters=1, arch_name=arch, device="cpu",
                                 compute_dtype="float32", model_kwargs=TINY[arch])
    assert TRAIN_KEYS | {"loss", "first_loss"} <= set(res)
    assert "idle_share" not in res            # a device metric: the card only
    assert np.isfinite(res["loss"]) and res["step_ms"] > 0


@pytest.mark.parametrize("arch", ["ConvTasNet", "SepFormer", "DPRNN"])
def test_wave_phase_body_runs_on_the_cpu(arch):
    res = bench.bench_train_step_wave(arch, B=2, n_sec=0.05, iters=1, device="cpu",
                                      compute_dtype="float32", remat=False,
                                      model_kwargs=TINY[arch])
    assert TRAIN_KEYS | {"audio_sec_per_sec"} <= set(res)
    assert "idle_share" not in res


def test_dsp_and_serving_bodies_run_on_the_cpu():
    res = bench.bench_dsp_bandwidth(B=2, n_sec=0.25, iters=1, device="cpu", warmup_s=0)
    assert {"gb_per_sec", "roundtrip_ms", "audio_sec_per_sec"} <= set(res)
    res = bench.bench_serving(B=2, n_sec=0.25, rounds=1, clients=2, reqs_per_client=1,
                              upit_kwargs=TINY["uPIT"], device="cpu")
    assert {"utts_per_sec", "batch_ms", "p50_ms", "p99_ms", "server_utts_per_sec"} <= set(res)
    assert res["server_errors"] == 0 and res["p50_ms"] > 0


def test_upit_step_first_loss_matches_jax_update_step():
    B, T = 3, 16
    cfg = jupit.Config(hidden=8, num_layers=1, zero_init_hidden=True)
    params, state = jupit.init(jax.random.PRNGKey(0), cfg)
    optimizer = make_optimizer(JaxLoopConfig())
    step = make_update_step(jupit, cfg, optimizer)
    batch = jax.tree_util.tree_map(jnp.asarray, bench.spectral_batch(B, T, 2, 257))
    # the step donates its arguments: carry the weights over first
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params),
                             jax.tree_util.tree_map(np.asarray, state))
    *_, loss, _ = step(params, state, optimizer.init(params), batch, jax.random.PRNGKey(1))
    res = bench.bench_train_step(B=B, T=T, iters=1, compute_dtype="float32", device="cpu",
                                 model_kwargs={"hidden": 8, "num_layers": 1,
                                               "zero_init_hidden": "1"}, state_dict=sd)
    np.testing.assert_allclose(res["first_loss"], float(loss), rtol=1e-5)


# ------------------------------------------------------------ orchestration

def _stub_parent(monkeypatch, bad=()):
    """bench's parent with the probe, the build and the child processes
    stubbed: each phase runs a stub body in-process; those in ``bad``
    raise, as a child that dies."""
    ran = []

    def run(name, deadline):
        ran.append(name)
        if name in bad:
            return None, "rc=1: RuntimeError: CUDA error: an illegal memory access"
        return {"utts_per_sec": 10.0, "step_ms": 1.0, "compile_s": 0.5, "idle_share": 0.2,
                "launches": {"lstm_seq_fwd": 2}, "device": "stub card, 700.00 W"}, ""

    monkeypatch.setattr(bench, "probe_device", lambda timeout=120.0: {
        "ok": True, "count": 1, "latency_s": 0.1, "name": "stub card"})
    monkeypatch.setattr(bench, "build_kernels", lambda sources: {"build_s": 0.0,
                                                                 "build": "cache"})
    monkeypatch.setattr(bench, "run_phase_process", run)
    return ran


def test_a_failed_phase_is_named_and_the_run_exits_non_zero(monkeypatch, capsys):
    ran = _stub_parent(monkeypatch, bad=("dsp",))
    assert bench.main(["--phases", "dsp,upit_bf16,serving"]) == 1
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ran == ["upit_bf16", "dsp", "serving"]         # PHASES order
    assert list(last["detail"]["failed_phases"]) == ["dsp"]
    assert "skipped_phases" not in last["detail"]
    assert last["detail"]["phases"]["upit_bf16"]["launches"] == {"lstm_seq_fwd": 2}
    with pytest.raises(SystemExit) as e:
        main(["bench", "--phases", "dsp"])
    assert e.value.code == 1


def test_a_budget_skip_is_reported_as_a_skip(monkeypatch, capsys):
    ran = _stub_parent(monkeypatch)
    monkeypatch.setenv("SEPSEP_BENCH_BUDGET", "1000")
    monkeypatch.setitem(bench.WORST_S, "tcn", 1001)
    assert bench.main(["--phases", "upit_bf16,tcn"]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ran == ["upit_bf16"]
    assert list(last["detail"]["skipped_phases"]) == ["tcn"]
    assert "failed_phases" not in last["detail"] and last["value"] == 10.0


def test_phases_keep_bench_order_and_refuse_unknown_names():
    assert list(bench.PHASES) == list(jbench.PHASES)
    assert bench.select_phases("serving,upit_b128,upit_bf16") == [
        "upit_bf16", "serving", "upit_b128"]
    assert bench.select_phases("") == list(jbench.PHASES)
    with pytest.raises(SystemExit, match="unknown phase"):
        bench.select_phases("upit_bf16,nope")
    assert bench.phase_sources(bench.PHASES) == sorted(_build.SOURCES)
    assert bench.phase_sources(["dsp"]) == ["stft"]


# ----------------------------------------------------- no card: no measuring

@pytest.mark.parametrize("cmd", ["bench", "doctor"])
def test_bench_and_doctor_exit_non_zero_without_a_card(cmd, capsys, tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "torch_kernels")
    with pytest.raises(SystemExit) as e:
        main([cmd] + (["--probe-timeout", "120"] if cmd == "doctor" else []))
    assert e.value.code not in (0, None)
    out = capsys.readouterr()
    if cmd == "bench":
        assert "no CUDA device is visible" in out.err and out.out == ""
    else:
        assert "PROBE FAILED" in out.out and "native io (csrc/sepio.cpp): loaded" in out.out


# -------------------------------------------------------------------- warmup

def _fake_plan(D, B, H, dtype=torch.bfloat16):
    """The documented cap of lstm_fwd_plan / lstm_bwd_plan on an H100."""
    if H > (1056 if dtype == torch.bfloat16 else 848):
        raise ValueError(f"lstm at H={H} needs more co-resident CTAs than the cap")
    return {"ctas": D * -(-H // 8)}


def _stub_build(monkeypatch):
    built, calls = set(), []

    def build(names):
        calls.append(list(names))
        built.update(names)
    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(_build, "is_built", lambda n: n in built)
    monkeypatch.setattr(lstm_kernel, "lstm_fwd_plan", _fake_plan)
    monkeypatch.setattr(lstm_kernel, "lstm_bwd_plan", _fake_plan)
    return calls


def test_warmup_builds_each_arch_s_sources_then_hits_the_cache(monkeypatch, capsys):
    calls = _stub_build(monkeypatch)
    main(["warmup", "--batch-size", "4"])
    out = capsys.readouterr().out.splitlines()
    assert calls == [list(ARCH_KERNELS[a]) for a in ARCHS]
    lines = {a: next(ln for ln in out if ln.startswith(f"warmup {a}:")) for a in ARCHS}
    assert "cold build of lstm_fwd, lstm_bwd, stft" in lines["uPIT"]
    assert "cache hit" in lines["RSH"] and "cold build of layernorm" in lines["TCN"]
    assert "cold build of attention" in lines["SepFormer"]
    assert "plans: none" in lines["ConvTasNet"]
    main(["warmup", "--archs", "uPIT,SepFormer"])
    out = capsys.readouterr().out
    assert out.count("cache hit") == 2


def test_warmup_refuses_a_configuration_the_kernels_refuse(monkeypatch, tmp_path):
    _stub_build(monkeypatch)
    conf = tmp_path / "model.conf"
    conf.write_text("hidden=1100\n")
    with pytest.raises(SystemExit, match="refuse.*H=1100"):
        main(["warmup", "--archs", "uPIT", "--model-config", str(conf)])
    conf.write_text("hidden=1000\n")
    main(["warmup", "--archs", "RSH", "--model-config", str(conf)])
    with pytest.raises(SystemExit, match="refuse.*H=1000"):
        main(["warmup", "--archs", "RSH", "--model-config", str(conf),
              "--compute-dtype", "float32"])


# --------------------------------------------- the arch -> kernel source map

# each kernel wrapper of the table, and its plain twin, by the source it stands for
WRAPPER_SOURCES = {fn + twin: name for name, src in _build.TABLE.items()
                   for _, fn in src.wrappers for twin in ("", "_plain")}


@pytest.mark.parametrize("arch_name", list(ARCHS))
def test_arch_kernel_map_names_what_train_and_serve_call(arch_name, monkeypatch, tmp_path):
    """A tiny training step (waveform input for every arch: the STFT of an
    on-device-features step) and a served batch on the CPU, each kernel
    wrapper and its plain twin recorded wherever a module holds it: the
    sources they stand for are the map's. On the CPU ``models/layers.cln``
    calls K6's plain forward, not its wrapper."""
    from speech_separation_tpu_torch.dsp.stft import num_frames
    from speech_separation_tpu_torch.eval.pipeline import SeparationPipeline
    from speech_separation_tpu_torch.models.registry import get_arch
    from speech_separation_tpu_torch.train.checkpoint import save_checkpoint
    from speech_separation_tpu_torch.train.loop import Optimizer, TrainLoopConfig, update_step
    from speech_separation_tpu_torch.train.wav_data import (STFT, audio_to_feature_batch,
                                                            audio_to_wave_batch)
    called = set()
    originals = {fn.__name__ + twin: getattr(sys.modules[fn.__module__], fn.__name__ + twin)
                 for fn in _build.launch_counters() for twin in ("", "_plain")}
    for mod in [m for n, m in sys.modules.items()
                if n.startswith("speech_separation_tpu_torch") and m is not None]:
        for name, fn in originals.items():
            if getattr(mod, name, None) is fn:
                def rec(*a, _fn=fn, _name=name, **kw):
                    called.add(_name)
                    return _fn(*a, **kw)
                monkeypatch.setattr(mod, name, rec)

    arch = get_arch(arch_name)
    cfg = arch.Config.from_kwargs(**TINY[arch_name])
    model = arch.Model(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    L = 2400
    srcs = (0.1 * rng.standard_normal((2, cfg.num_spk, L))).astype(np.float32)
    audio = np.zeros((2, 1 + cfg.num_spk, L + STFT.n_fft), np.float32)
    audio[:, :, STFT.n_fft // 2: STFT.n_fft // 2 + L] = np.concatenate(
        [srcs.sum(1, keepdims=True), srcs], axis=1)
    shipped = {"audio": torch.from_numpy(np.round(audio * 32768).astype(np.int16)),
               "sample_lengths": torch.tensor([L, L - 300], dtype=torch.int32),
               "lengths": torch.tensor([num_frames(L, STFT.hop), num_frames(L - 300, STFT.hop)],
                                       dtype=torch.int32),
               "row_mask": torch.ones(2)}
    to_batch = audio_to_wave_batch if arch.DOMAIN == "time" else audio_to_feature_batch
    batch = to_batch(shipped, STFT)
    update_step(arch, model, Optimizer(model.parameters(), TrainLoopConfig()), batch,
                torch.Generator().manual_seed(1))
    mdl = str(tmp_path / "m.mdl")
    save_checkpoint(mdl, model, meta={"arch": arch.NAME, "model_kwargs": {
        k: str(v) for k, v in TINY[arch_name].items()}})
    SeparationPipeline(mdl, batch_size=2, device="cpu").separate([srcs[0].sum(0)])
    assert sorted({WRAPPER_SOURCES[n] for n in called}) == sorted(ARCH_KERNELS[arch_name])
