"""train_mfu (%): the model's product operations of every step in the traced
window, forward and backward (three forwards), over the rows' true lengths
and with no recompute (the configuration's reference counts them), over the
window's wall (the mean step wall times the steps) and the precision's peak
(harness/peaks.py)."""

from port_bench.harness.peaks import FLOPS


def read(run):
    t, trace = run.records.get("train"), run.trace_data
    if not t or trace is None or not t["steps"]:
        return None
    model = run.config["model"]
    flops = sum(run.reference.train_flops(model, lens) for lens in t["lengths"])
    return 100.0 * flops / trace.window_s / FLOPS[run.config["precision"]]
