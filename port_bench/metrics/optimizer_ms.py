"""optimizer_ms (ms): device time a step of the kernels launched while the
host was inside the optimizer's ``step`` (the gradient reduce, the clip and
Adam), each kernel tied to its launch through the trace's correlation ids."""

import bisect


def read(run):
    t, trace = run.records.get("train"), run.trace_data
    spans = sorted((a, b) for label, a, b in run.intervals if label == "optimizer")
    if not t or trace is None or not spans or not trace.launch_time:
        return None
    starts = [a for a, _ in spans]
    total, found = 0.0, False
    for _, cat, s, e, corr in trace.events:
        at = trace.launch_time.get(corr)
        if at is None:
            continue
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and at < spans[i][1]:
            total += e - s
            found = True
    return 1e3 * total / t["steps"] if found else None
