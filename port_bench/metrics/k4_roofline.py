"""k4_roofline (%): the recurrence's backward (K4: ``lstm_bwd_kernel``,
csrc/lstm_bwd.cu) against its roofline, over every launch in the traced
window: the sum of each launch's bound over the sum of the launches' device
times.

A launch's shape comes from the configuration (the reference's
``lstm_launches`` for each step's batch) and is checked against the trace's
count and ``ops.lstm_kernel.lstm_seq_bwd.launches``. Its bound is the work
the call needs: each input read once (w_hh, the saved cells and gates and
the incoming ys gradient in the product dtype; the initial cell, the final
states' gradients in float32, the lengths) and each output written once
(the gate gradients in the product dtype, the initial states' gradients in
float32) at the memory's rate, or one (1, 4H) x (4H, H) product a true
step, row and direction at the dtype's peak, whichever is longer."""

from port_bench.harness.peaks import bound_s

COUNTER = "lstm_seq_bwd"


def match(name: str) -> bool:
    return "lstm_bwd_kernel" in name


def bytes_and_flops(T: int, B: int, H: int, lengths, e: int) -> tuple:
    G = 4 * H
    state = 2 * B * H * 4
    nbytes = (2 * H * G * e + state + 4 * B + T * 2 * B * H * e + T * 2 * B * G * e
              + T * 2 * B * H * e + 2 * state + T * 2 * B * G * e + 2 * state)
    return nbytes, 2 * sum(lengths) * 2 * H * G


def read(run):
    t, trace = run.records.get("train"), run.trace_data
    if not t or trace is None:
        return None
    dtype = run.config["precision"]
    e = 2 if dtype == "bfloat16" else 4
    shapes = [s for lens in t["lengths"]
              for s in run.reference.lstm_launches(run.config["model"], t["T"], lens)]
    ks = trace.kernels(match)
    if not ks or len(ks) != len(shapes) or t["launches"].get(COUNTER) != len(shapes):
        return None
    bound = sum(bound_s(*bytes_and_flops(T, B, H, lens, e), dtype) for T, B, H, lens in shapes)
    return 100.0 * bound / sum(end - start for _, start, end, _ in ks)
