"""The device trace of a ``--trace 1`` run, reduced to what the readers use.

``Tracer`` runs torch.profiler's CUDA activity (CUPTI: every kernel, copy
and set on the card, and every runtime call that launched one, from any
thread) over the window; host-side operator recording stays off, as it
slows a host-bound loop several times. The first profiler start of a
process initialises CUPTI (about 12 s on an H100 host), so ``prepare`` runs
one empty profile during set-up. The trace's timestamps count from its
``baseTimeNanoseconds`` on the wall clock; sampling the wall and monotonic
clocks together ties them to the host intervals the generators log. The trace
is exported as Chrome JSON to ``TMPDIR`` and read back once.

``Trace`` holds, in host monotonic seconds: every device event (kernel,
copy, set) with its launch time on the host where the trace links one,
the window, and the busy time: the union of the device events' intervals
inside the window (one card). ``idle_gaps`` labels each gap between device
events by the host interval it fell in.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    def __init__(self, events: list, window: tuple, launches: dict):
        # events: (name, cat, start, end, correlation), host monotonic seconds
        self.events = events
        self.window = window
        self.launch_time = launches          # correlation -> host launch time
        t0, t1 = window
        self.window_s = t1 - t0
        spans = sorted((max(s, t0), min(e, t1)) for _, _, s, e, _ in events
                       if e > t0 and s < t1)
        self.busy_spans = union(spans)
        self.busy_s = sum(e - s for s, e in self.busy_spans)

    def kernels(self, match) -> list:
        """(name, start, end, correlation) of the kernels whose name
        ``match`` accepts."""
        return [(n, s, e, c) for n, cat, s, e, c in self.events if cat == "kernel" and match(n)]

    def top_ops(self, k: int = 10) -> list:
        totals: dict = {}
        for n, _, s, e, _ in self.events:
            totals[n] = totals.get(n, 0.0) + (e - s)
        return [[n[:200], t] for n, t in sorted(totals.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, intervals: list, k: int = 10) -> list:
        """The ``k`` longest gaps between busy spans inside the window, each
        named by the host interval (label) its start lies in, or
        'host outside harness intervals'."""
        t0, t1 = self.window
        gaps, reached = [], t0
        for s, e in self.busy_spans:
            if s > reached:
                gaps.append((reached, s))
            reached = max(reached, e)
        if t1 > reached:
            gaps.append((reached, t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:k]:
            labels = sorted({lab for lab, a, b in intervals if a <= s < b})
            out.append([" + ".join(labels) or "host outside harness intervals", e - s])
        return out


def union(spans: list) -> list:
    """The union of sorted (start, end) spans, as disjoint sorted spans."""
    out = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def parse_chrome_trace(doc: dict, wall_minus_mono: float) -> tuple:
    """(device events, launch times by correlation) of a torch.profiler
    Chrome trace, in host monotonic seconds: a timestamp is microseconds
    after the trace's ``baseTimeNanoseconds`` on the wall clock, and
    ``wall_minus_mono`` is the wall clock less the monotonic one."""
    evs = doc["traceEvents"]
    base = doc.get("baseTimeNanoseconds", 0) * 1e-9 - wall_minus_mono
    devices, launches = [], {}
    for e in evs:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        args = e.get("args") or {}
        corr = args.get("correlation")
        if cat in DEVICE_CATS:
            s = base + e["ts"] * 1e-6
            devices.append((e.get("name", ""), cat, s, s + e.get("dur", 0) * 1e-6, corr))
        elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
            launches[corr] = base + e["ts"] * 1e-6
    return devices, launches


def wall_minus_mono() -> float:
    """The wall clock less the monotonic one, from the closest of a few
    paired readings."""
    best = None
    for _ in range(5):
        m0 = time.monotonic()
        w = time.time()
        m1 = time.monotonic()
        if best is None or m1 - m0 < best[0]:
            best = (m1 - m0, w - 0.5 * (m0 + m1))
    return best[1]


class Tracer:
    """torch.profiler's CUDA activity over the window of a traced run."""

    def __init__(self):
        self.prof = None
        self.t_start = self.t_stop = None

    @staticmethod
    def _profile():
        import torch
        from torch.profiler import ProfilerActivity, profile
        # without a card (the benchmark's own CPU tests) the host's operators
        # stand in, so the rest of a traced run can be driven there
        act = ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU
        return profile(activities=[act])

    def prepare(self) -> None:
        """One empty profile: CUPTI's initialisation, in set-up."""
        prof = self._profile()
        prof.start()
        prof.stop()

    def start(self) -> None:
        self.prof = self._profile()
        self.prof.start()
        self.t_start = time.monotonic()

    def stop(self) -> None:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t_stop = time.monotonic()
        self.prof.stop()

    def read(self, window: tuple | None = None) -> Trace:
        """The trace over ``window`` (host monotonic start and end; by
        default from the tracer's start to its stop)."""
        offset = wall_minus_mono()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="port_bench_trace_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
        finally:
            os.unlink(path)
        self.prof = None
        devices, launches = parse_chrome_trace(doc, offset)
        return Trace(devices, window or (self.t_start, self.t_stop), launches)
