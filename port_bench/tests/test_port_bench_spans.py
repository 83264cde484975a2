"""The program spans' arithmetic (harness/spans.py and the readers that use
it): each device event goes to the innermost main-thread span open at its
launch, so a span's share is its self time's, whatever thread launched it;
each idle gap goes to the span open when it starts; no number where the
spans do not cover the window's device events."""

import sys
from typing import NamedTuple

import pytest

from port_bench.harness import core
from port_bench.harness import spans as hs
from port_bench.harness.trace import Trace

MAIN, AUTOGRAD = 101, 202
NEW = ("forward_ms", "loss_ms", "backward_ms", "idle_in_step_ms")


class Span(NamedTuple):
    name: str
    parent: str | None
    thread: int
    start_ns: int
    end_ns: int


def sp(name, parent, start, end, thread=MAIN):
    return Span(name, parent, thread, round(start * 1e9), round(end * 1e9))


def one_step():
    """One step over [1, 9] s of a 10 s window; every kernel's launch and its
    time on the device (seconds)."""
    spans = [sp("train.step", None, 1, 9), sp("train.forward", "train.step", 1.5, 4),
             sp("train.loss", "train.forward", 3, 4), sp("train.backward", "train.step", 4.5, 7),
             sp("train.optimizer", "train.step", 7.5, 8.5),
             # another thread's span is no main-thread span
             sp("other", None, 4.9, 5.5, thread=AUTOGRAD)]
    launches = {1: 1.2, 2: 1.6, 3: 3.2, 4: 5.0, 5: 8.0}
    events = [("zero", "gpu_memset", 1.25, 1.3, 1), ("enc", "kernel", 2.0, 2.5, 2),
              ("pit", "gpu_memcpy", 3.3, 3.4, 3), ("bwd", "kernel", 5.1, 6.1, 4),
              ("adam", "kernel", 8.0, 8.2, 5)]
    return Trace(events, (0.0, 10.0), launches), spans


class FakeRun:
    def __init__(self, trace):
        self.trace_data, self.notes = trace, []

    def note(self, line):
        self.notes.append(line)


def read_all(monkeypatch, trace, spans):
    monkeypatch.setattr(hs, "program_spans", lambda: spans)
    run = FakeRun(trace)
    return {m: core.metric_reader(m).read(run) for m in NEW}, run


def test_timeline_names_the_innermost_open_span():
    bounds, labels = hs.timeline([(0, 10, "a"), (2, 5, "b"), (5, 8, "c"), (6, 7, "d")])
    assert [hs.label_at(bounds, labels, t) for t in (-1, 0, 2, 4.9, 5, 6.5, 7, 8, 11)] == [
        None, "a", "b", "b", "c", "d", "c", "a", None]


def test_events_go_to_the_innermost_span_at_their_launch(monkeypatch):
    trace, spans = one_step()
    a = hs.attribute(trace, spans)
    assert a.steps == 1 and a.coverage == 1.0
    assert a.device_s == pytest.approx({"train.step": 0.05, "train.forward": 0.5,
                                        "train.loss": 0.1, "train.backward": 1.0,
                                        "train.optimizer": 0.2})
    got, _ = read_all(monkeypatch, trace, spans)
    # forward's self time leaves its train.loss child out; the backward's
    # kernel launched from autograd's thread while the main thread waited
    assert got["forward_ms"] == pytest.approx(500.0) and got["loss_ms"] == pytest.approx(100.0)
    assert got["backward_ms"] == pytest.approx(1000.0)


def test_a_gap_is_named_by_the_span_open_at_its_start(monkeypatch):
    trace, spans = one_step()
    a = hs.attribute(trace, spans)
    # the gap from 3.4 s (the copy's end) to 5.1 s starts inside train.loss
    assert a.idle_s == pytest.approx({hs.OUTSIDE: 1.25, "train.step": 0.7, "train.forward": 0.8,
                                      "train.loss": 1.7, "train.backward": 1.9,
                                      "train.optimizer": 1.8})
    got, run = read_all(monkeypatch, trace, spans)
    assert got["idle_in_step_ms"] == pytest.approx(1e3 * (0.7 + 0.8 + 1.7 + 1.9 + 1.8))
    # one step: its idle time is part of the window's
    assert got["idle_in_step_ms"] / 1e3 <= trace.window_s - trace.busy_s
    assert "train.loss 1700.0000" in run.notes[0]


def test_two_steps_are_counted_per_step(monkeypatch):
    trace, spans = one_step()
    shift = 10.0
    spans2 = spans + [s._replace(start_ns=s.start_ns + round(shift * 1e9),
                                 end_ns=s.end_ns + round(shift * 1e9)) for s in spans]
    events = trace.events + [(n, c, s + shift, e + shift, k + 10) for n, c, s, e, k in trace.events]
    launches = {**trace.launch_time, **{k + 10: t + shift for k, t in trace.launch_time.items()}}
    got, _ = read_all(monkeypatch, Trace(events, (0.0, 20.0), launches), spans2)
    assert got["forward_ms"] == pytest.approx(500.0) and got["backward_ms"] == pytest.approx(1000.0)


@pytest.mark.parametrize("case", ["no_step", "outside_launch", "no_launch_time", "no_spans"])
def test_no_number_without_cover(monkeypatch, case):
    trace, spans = one_step()
    if case == "no_step":
        spans = [s for s in spans if s.name != "train.step"]
    elif case == "outside_launch":
        # one of five events launched outside every step: 80% covered
        trace.launch_time[5] = 9.5
    elif case == "no_launch_time":
        del trace.launch_time[4]
    else:
        spans = []
    assert hs.attribute(trace, spans) is None
    got, _ = read_all(monkeypatch, trace, spans)
    assert got == dict.fromkeys(NEW)


def test_spans_outside_the_window_are_left_out():
    trace, spans = one_step()
    early = [s._replace(start_ns=s.start_ns - 10**10, end_ns=s.end_ns - 10**10) for s in spans]
    assert hs.attribute(trace, early + spans).steps == 1


def test_a_program_without_the_recorder_gives_no_spans(monkeypatch):
    monkeypatch.setitem(sys.modules, "speech_separation_tpu_torch.utils.spans", None)
    assert hs.program_spans() == []


def test_traced_run_on_the_cpu_reports_no_device_numbers():
    """A traced tiny run on the CPU (no device events): the port's spans
    cover the window's steps, and the readers report nothing, without error."""
    from port_bench.tests.helpers import run_tiny
    from speech_separation_tpu_torch.utils import spans as program
    res, run = run_tiny("upit-train-b100", seconds=0.2, trace=True, float32=True)
    t0, t1 = run.window
    steps = [s for s in program.recorded() if s.name == "train.step"
             and t0 <= s.start_ns * 1e-9 and s.end_ns * 1e-9 <= t1]
    assert len(steps) == run.records["train"]["steps"]
    assert not set(NEW) & set(res["metrics"])
