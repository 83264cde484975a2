"""Spans of the training step's layers, recorded while a torch.profiler
session runs.

``span(name)`` is a context manager. While a profiler is on
(``torch.autograd._profiler_enabled()``: the benchmark's traced window, the
trainer's ``--profile-dir`` steps) it records a :class:`Span`: its name, the
name of the span it opened inside (a thread-local stack), the OS thread id
and its start and end on ``time.monotonic_ns()``, the host clock that a
CUPTI trace's timestamps are mapped onto, so spans and device events share
one time base. Otherwise it returns one shared no-op and allocates nothing.
The check is the calling thread's: torch.profiler is on in the thread that
started it (and in the autograd threads it hands its state to), so spans
are recorded on the thread that runs the profiled steps.
Records go to a bounded list in memory (``recorded()``, ``clear()``);
spans past the bound are counted in ``dropped()``. Nothing is written to
disk here: ``chrome_events`` gives the records as a Chrome trace's events.

The spans (train/loop.py, models/): ``train.step`` around an update,
``train.forward`` around the arch's loss function (the model, then the
objective), ``train.loss`` inside it around the objective that follows the
model's output, ``train.backward`` around each ``.backward()`` (the
backward's kernels launch on autograd's thread while this thread waits
inside it) and ``train.optimizer`` around ``Optimizer.step``; inside
``train.forward``, ``sepformer.intra`` and ``sepformer.inter`` around each
of SepFormer's paths (models/sepformer.py), one of each a dual-path block.
"""

from __future__ import annotations

import threading
import time
from typing import NamedTuple

from torch.autograd import _profiler_enabled

LIMIT = 1 << 16


class Span(NamedTuple):
    name: str
    parent: str | None
    thread: int
    start_ns: int
    end_ns: int


class _Off:
    """The span while nothing records: one shared object, no work."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("recorder", "name", "parent", "start_ns")

    def __init__(self, recorder: Recorder, name: str):
        self.recorder, self.name = recorder, name

    def __enter__(self):
        stack, _ = self.recorder._thread()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.start_ns = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        end = time.monotonic_ns()
        stack, thread = self.recorder._thread()
        stack.pop()
        self.recorder._add((self.name, self.parent, thread, self.start_ns, end))
        return False


class Recorder:
    """A bounded list of spans, filled only while a profiler is on."""

    def __init__(self, limit: int = LIMIT):
        self.limit = limit
        self._records: list[tuple] = []
        self._dropped = 0
        self._lock = threading.Lock()
        self._local = threading.local()

    def span(self, name: str):
        if not _profiler_enabled():
            return _OFF
        return _On(self, name)

    def _thread(self) -> tuple:
        """(this thread's stack of open span names, its OS thread id)."""
        state = getattr(self._local, "state", None)
        if state is None:
            state = self._local.state = ([], threading.get_native_id())
        return state

    def _add(self, record: tuple) -> None:
        with self._lock:
            if len(self._records) < self.limit:
                self._records.append(record)
            else:
                self._dropped += 1

    def recorded(self) -> list[Span]:
        with self._lock:
            return [Span(*r) for r in self._records]

    def dropped(self) -> int:
        return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._dropped = 0


RECORDER = Recorder()
span = RECORDER.span
recorded = RECORDER.recorded
dropped = RECORDER.dropped
clear = RECORDER.clear


def wall_minus_monotonic_ns() -> int:
    """The wall clock less the monotonic one, in ns, from the closest of a
    few paired readings."""
    best = None
    for _ in range(5):
        m0 = time.monotonic_ns()
        w = time.time_ns()
        m1 = time.monotonic_ns()
        if best is None or m1 - m0 < best[0]:
            best = (m1 - m0, w - (m0 + m1) // 2)
    return best[1]


def chrome_events(records: list[Span], base_ns: int, pid: int) -> list[dict]:
    """The records as Chrome trace ``X`` events of a trace whose timestamps
    are microseconds after ``base_ns`` on the wall clock (torch.profiler's
    ``baseTimeNanoseconds``), on the rows of their threads."""
    offset = wall_minus_monotonic_ns() - base_ns
    return [{"ph": "X", "cat": "user_annotation", "name": s.name, "pid": pid, "tid": s.thread,
             "ts": (s.start_ns + offset) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": {"parent": s.parent}} for s in records]
