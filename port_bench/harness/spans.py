"""The program's own spans in a traced run, tied to the device trace.

The port records spans (``speech_separation_tpu_torch.utils.spans``: name,
parent, thread, start and end on ``time.monotonic_ns()``) while a profiler
runs, so in a ``--trace 1`` run they cover the window. That is the host clock
``harness/trace.py`` maps CUPTI's timestamps onto, so no conversion is needed
beyond ns to seconds.

``attribute`` keeps the spans inside the window on the main thread (the one
that opened ``train.step``) and gives

- each device event in the window to the innermost main-thread span open at
  its launch on the host (``Trace.launch_time``, whatever thread launched it:
  the backward's kernels launch on autograd's thread while the main thread
  waits inside ``train.backward``), so a span's share is its self time's;
- each idle gap between the busy spans to the innermost main-thread span open
  when the gap starts, or to none outside every ``train.step``.

It returns None where the window holds no ``train.step`` span or no device
event, or where fewer than 99% of the window's device events launched inside
a ``train.step`` span: a clock out of line or a missing span, not a number.
A program without the recorder gives no spans, so None.
"""

from __future__ import annotations

import bisect
import weakref
from typing import NamedTuple

STEP = "train.step"
COVERAGE = 0.99
OUTSIDE = "outside train.step"


class Attribution(NamedTuple):
    steps: int                 # train.step spans in the window
    names: frozenset           # every main-thread span name seen there
    device_s: dict             # innermost span -> device seconds launched in its self time
    idle_s: dict               # innermost span (or OUTSIDE) -> idle seconds of gaps starting there
    coverage: float            # share of the window's device events launched inside train.step


def program_spans() -> list:
    """The port's recorded spans; none from a program without the recorder."""
    try:
        from speech_separation_tpu_torch.utils.spans import recorded
    except ImportError:
        return []
    return recorded()


def timeline(spans: list) -> tuple:
    """(bounds, labels) of properly nested (start, end, name) spans:
    ``labels[i]`` is the innermost span open on [bounds[i], bounds[i + 1]),
    None where none is."""
    bounds, labels, stack = [], [], []

    def mark(t, label):
        if bounds and bounds[-1] == t:
            labels[-1] = label
        else:
            bounds.append(t)
            labels.append(label)

    def close_until(t):
        while stack and stack[-1][1] <= t:
            end = stack.pop()[1]
            mark(end, stack[-1][2] if stack else None)

    for s in sorted(spans, key=lambda s: (s[0], -s[1])):
        close_until(s[0])
        stack.append(s)
        mark(s[0], s[2])
    close_until(float("inf"))
    return bounds, labels


def label_at(bounds: list, labels: list, t: float):
    i = bisect.bisect_right(bounds, t) - 1
    return labels[i] if i >= 0 else None


def within(intervals: list, t: float) -> bool:
    """Whether ``t`` lies in one of the sorted, disjoint (start, end)."""
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return i >= 0 and t < intervals[i][1]


def gaps(trace) -> list:
    """The idle (start, end) intervals of the window between busy spans."""
    t0, t1 = trace.window
    out, reached = [], t0
    for s, e in trace.busy_spans:
        if s > reached:
            out.append((reached, s))
        reached = max(reached, e)
    if t1 > reached:
        out.append((reached, t1))
    return out


def attribute(trace, spans: list) -> Attribution | None:
    t0, t1 = trace.window
    inside = [(s.start_ns * 1e-9, s.end_ns * 1e-9, s.name, s.thread) for s in spans
              if s.end_ns * 1e-9 > t0 and s.start_ns * 1e-9 < t1]
    steps = [s for s in inside if s[2] == STEP]
    if not steps:
        return None
    main = steps[0][3]
    mine = [s[:3] for s in inside if s[3] == main]
    bounds, labels = timeline(mine)
    step_iv = sorted((a, b) for a, b, name in mine if name == STEP)
    events = [ev for ev in trace.events if ev[3] > t0 and ev[2] < t1]
    if not events:
        return None
    device_s, covered = {}, 0
    for _, _, s, e, corr in events:
        at = trace.launch_time.get(corr)
        if at is None or not within(step_iv, at):
            continue
        covered += 1
        label = label_at(bounds, labels, at)
        device_s[label] = device_s.get(label, 0.0) + (e - s)
    coverage = covered / len(events)
    if coverage < COVERAGE:
        return None
    idle_s = {}
    for s, e in gaps(trace):
        label = label_at(bounds, labels, s) if within(step_iv, s) else OUTSIDE
        idle_s[label] = idle_s.get(label, 0.0) + (e - s)
    return Attribution(len(step_iv), frozenset(s[2] for s in mine), device_s, idle_s, coverage)


_of_run: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def of_run(run) -> Attribution | None:
    """``attribute`` over a traced run's trace and the port's spans, once a
    run for all its readers."""
    if run not in _of_run:
        trace = run.trace_data
        _of_run[run] = None if trace is None else attribute(trace, program_spans())
    return _of_run[run]


def self_ms(run, name: str) -> float | None:
    """Device ms a step of the events launched in span ``name``'s self time;
    None where the window has no attribution or no such span."""
    a = of_run(run)
    if a is None or name not in a.names:
        return None
    return 1e3 * a.device_s.get(name, 0.0) / a.steps
