"""The trace's arithmetic: the device's busy time is the union of its
events' intervals inside the window, gaps are named by the host interval
they fall in, and a Chrome trace's clock is tied to the host's."""

import pytest

from port_bench.harness.trace import Trace, parse_chrome_trace, union


def test_union_of_overlapping_intervals():
    assert union([(0, 2), (1, 3), (5, 6), (6, 7)]) == [(0, 3), (5, 7)]


def test_busy_and_idle_share_on_hand_made_intervals():
    events = [("k1", "kernel", 1.0, 3.0, 1), ("k2", "kernel", 2.0, 4.0, 2),
              ("copy", "gpu_memcpy", 6.0, 7.0, 3), ("late", "kernel", 9.5, 12.0, 4)]
    tr = Trace(events, (0.0, 10.0), {})
    assert tr.busy_s == 3.0 + 1.0 + 0.5
    assert 1.0 - tr.busy_s / tr.window_s == pytest.approx(0.55)
    gaps = tr.idle_gaps([("step", 0.0, 5.0)], k=2)
    assert gaps == [["host outside harness intervals", 2.5], ["step", 2.0]]


def test_top_ops_sum_by_name():
    events = [("a", "kernel", 0.0, 1.0, 1), ("b", "kernel", 1.0, 3.0, 2), ("a", "kernel", 3.0, 5.0, 3)]
    assert Trace(events, (0.0, 5.0), {}).top_ops(1) == [["a", 3.0]]


def test_chrome_trace_clock_is_tied_to_the_host():
    doc = {"baseTimeNanoseconds": 1_000_000_000_000,
           "traceEvents": [
               {"ph": "X", "cat": "kernel", "name": "k", "ts": 2_000_000.0, "dur": 500.0,
                "args": {"correlation": 7}},
               {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1_999_000.0,
                "dur": 5.0, "args": {"correlation": 7}},
               {"ph": "i", "cat": "kernel", "name": "marker", "ts": 0.0}]}
    # the wall clock reads 990 s more than the monotonic one
    devices, launches = parse_chrome_trace(doc, 990.0)
    (name, cat, start, end, corr), = devices
    assert (name, cat, corr) == ("k", "kernel", 7)
    assert start == pytest.approx(12.0, abs=1e-9) and end == pytest.approx(12.0005, abs=1e-9)
    assert abs(launches[7] - 11.999) < 1e-9
