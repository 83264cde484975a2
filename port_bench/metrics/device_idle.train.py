"""device_idle.train (share): one minus the union of the card's kernel, copy and
set intervals over the traced window (harness/trace.py)."""


def read(run):
    trace = run.trace_data
    if trace is None or trace.window_s <= 0:
        return None
    return 1.0 - trace.busy_s / trace.window_s
