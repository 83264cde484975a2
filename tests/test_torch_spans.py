"""The span recorder (speech_separation_tpu_torch/utils/spans.py) and the
training step's spans: nothing is recorded without a profiler; under one, an
update records ``train.step`` holding ``train.forward`` (holding
``train.loss``), ``train.backward`` and ``train.optimizer`` on the step's
thread, on ``time.monotonic_ns()``; a mixed batch's step records a forward,
a loss and a backward per sub-batch; recording leaves the step's numbers as
they are; the bounded list counts what it drops."""

import contextlib
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from speech_separation_tpu_torch.models.registry import get_arch
from speech_separation_tpu_torch.train.loop import (Optimizer, TrainLoopConfig, accumulate_step,
                                                    update_step)
from speech_separation_tpu_torch.utils import spans

torch.set_num_threads(1)  # six xdist workers share the cores: one thread each, for life

TINY = {"uPIT": {"feat_dim": "16", "hidden": "8", "num_layers": "1", "zero_init_hidden": "1"},
        "RSH": {"feat_dim": "16", "hidden": "8", "num_layers": "1"},
        "DPRNN": {"rnn_hidden": "8", "channels": "8", "n_filters": "8", "blocks": "1",
                  "chunk": "8"}}
STEP_TREE = {"train.step": None, "train.forward": "train.step", "train.loss": "train.forward",
             "train.backward": "train.step", "train.optimizer": "train.step"}


@contextlib.contextmanager
def profiling():
    """A CPU-activity torch.profiler session, which turns the recorder on."""
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        yield
    finally:
        prof.stop()


def feature_batch(B: int, S: int, seed: int, T: int = 12, F: int = 16) -> dict:
    g = torch.Generator().manual_seed(seed)
    lengths = torch.tensor([T] + [T - 3] * (B - 1), dtype=torch.int32)
    valid = (torch.arange(T)[None, :] < lengths[:, None]).float()
    src = torch.rand((B, S, T, F), generator=g) * valid[:, None, :, None]
    return {"mix": src.sum(dim=1), "sources": src, "lengths": lengths,
            "row_mask": torch.ones(B)}


def wave_batch(B: int, seed: int, L: int = 160) -> dict:
    g = torch.Generator().manual_seed(seed)
    src = 0.1 * torch.randn((B, 2, L), generator=g)
    return {"mix_wav": src.sum(dim=1), "source_wavs": src,
            "sample_lengths": torch.full((B,), L, dtype=torch.int32), "row_mask": torch.ones(B)}


def setup(name: str, seed: int = 0):
    arch = get_arch(name)
    torch.manual_seed(seed)
    model = arch.Model(arch.Config.from_kwargs(**TINY[name]))
    opt = Optimizer(model.parameters(), TrainLoopConfig(arch=name, batch_size=3))
    batch = wave_batch(3, seed) if name == "DPRNN" else feature_batch(3, 2, seed)
    return arch, model, opt, batch, torch.Generator().manual_seed(seed)


def test_nothing_records_without_a_profiler():
    spans.clear()
    assert spans.span("a") is spans.span("b")
    with spans.span("train.step"), spans.span("train.forward"):
        pass
    arch, model, opt, batch, gen = setup("uPIT")
    update_step(arch, model, opt, batch, gen)
    assert spans.recorded() == [] and spans.dropped() == 0


def check_tree(recs: list) -> None:
    """Names, parents, one thread (this one) and nesting of one step's spans."""
    by_name = {}
    for r in recs:
        assert r.name in STEP_TREE and r.parent == STEP_TREE[r.name], r
        assert r.thread == threading.get_native_id() and r.start_ns <= r.end_ns, r
        by_name.setdefault(r.name, []).append(r)
    (step,) = by_name["train.step"]
    for r in recs:
        if r.parent is not None:
            parents = by_name[r.parent]
            assert any(p.start_ns <= r.start_ns and r.end_ns <= p.end_ns for p in parents), r
    (opt,) = by_name["train.optimizer"]
    assert max(b.end_ns for b in by_name["train.backward"]) <= opt.start_ns
    assert step.start_ns <= min(f.start_ns for f in by_name["train.forward"])


@pytest.mark.parametrize("name", ["uPIT", "DPRNN"])
def test_update_step_records_its_spans(name):
    arch, model, opt, batch, gen = setup(name)
    spans.clear()
    with profiling():
        update_step(arch, model, opt, batch, gen)
    recs = spans.recorded()
    assert sorted(r.name for r in recs) == sorted(STEP_TREE)
    check_tree(recs)


@pytest.mark.parametrize("name", ["uPIT", "RSH"])
def test_accumulate_step_records_a_loss_and_a_backward_per_sub_batch(name):
    arch, model, opt, _, gen = setup(name)
    counts = (2, 3) if name == "RSH" else (2, 2)
    subs = [feature_batch(2, s, seed) for seed, s in enumerate(counts + (2,))]
    spans.clear()
    with profiling():
        accumulate_step(arch, model, opt, subs, gen)
    recs = spans.recorded()
    n = {k: sum(r.name == k for r in recs) for k in STEP_TREE}
    assert n == {"train.step": 1, "train.forward": 3, "train.loss": 3, "train.backward": 3,
                 "train.optimizer": 1}
    check_tree(recs)


def test_span_times_are_the_monotonic_clock():
    spans.clear()
    with profiling():
        with spans.span("outer"):
            time.sleep(0.001)
            inside = time.monotonic_ns()
            with spans.span("inner"):
                pass
    inner, outer = spans.recorded()
    assert outer.start_ns < inside < outer.end_ns
    assert (inner.name, inner.parent, outer.parent) == ("inner", "outer", None)
    assert inside <= inner.start_ns <= inner.end_ns <= outer.end_ns


def test_only_the_profiled_thread_records():
    """torch.profiler's on-state belongs to the thread that started it (and
    the autograd threads it hands it to): another thread's spans stay off."""
    spans.clear()
    seen = {}

    def worker():
        seen["on"] = torch.autograd._profiler_enabled()
        with spans.span("worker"):
            pass

    with profiling():
        with spans.span("main"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive() and seen["on"] is False
    (main,) = spans.recorded()
    assert (main.name, main.thread) == ("main", threading.get_native_id())


@pytest.mark.parametrize("name", ["uPIT", "DPRNN"])
def test_step_is_bit_identical_with_recording_on_and_off(name):
    results = []
    for on in (False, True):
        arch, model, opt, batch, gen = setup(name, seed=4)
        spans.clear()
        with profiling() if on else contextlib.nullcontext():
            loss, norm = update_step(arch, model, opt, batch, gen)
        assert bool(spans.recorded()) == on
        results.append((loss, norm, {n: p.detach().clone() for n, p in model.named_parameters()}))
    (l0, n0, p0), (l1, n1, p1) = results
    assert torch.equal(l0, l1) and torch.equal(torch.as_tensor(n0), torch.as_tensor(n1))
    assert p0.keys() == p1.keys() and all(torch.equal(p0[k], p1[k]) for k in p0)


def test_the_bounded_list_counts_what_it_drops():
    rec = spans.Recorder(limit=3)
    with profiling():
        for k in range(5):
            with rec.span(f"s{k}"):
                pass
    assert [r.name for r in rec.recorded()] == ["s0", "s1", "s2"] and rec.dropped() == 2
    rec.clear()
    assert rec.recorded() == [] and rec.dropped() == 0


def test_chrome_events_sit_on_the_traces_wall_clock():
    """A span's event starts at its monotonic start plus the wall clock's lead
    over the monotonic one, counted in microseconds after the trace's base."""
    s = spans.Span("train.step", None, 7, 5_000_000_000, 5_000_250_000)
    base = time.time_ns() - 10**9
    (ev,) = spans.chrome_events([s], base, 11)
    want_us = (s.start_ns + time.time_ns() - time.monotonic_ns() - base) / 1e3
    assert abs(ev["ts"] - want_us) < 5e3
    assert (ev["name"], ev["ph"], ev["pid"], ev["tid"], ev["dur"]) == (
        "train.step", "X", 11, 7, 250.0)
