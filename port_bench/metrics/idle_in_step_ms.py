"""idle_in_step_ms (ms): the device's idle time a step in the gaps between
its busy spans that start while the main thread is inside ``train.step``
(harness/spans.py). The split by the innermost span open at each gap's start
goes to the run's notes, so a gap at ``train.loss`` is named, beside the
device time a step by the innermost span open at each event's launch."""

from port_bench.harness.spans import OUTSIDE, of_run


def per_step_text(seconds: dict, steps: int) -> str:
    ms = sorted(((str(k), 1e3 * v / steps) for k, v in seconds.items()), key=lambda x: -x[1])
    return ", ".join(f"{k} {v:.4f}" for k, v in ms)


def read(run):
    a = of_run(run)
    if a is None:
        return None
    run.note(f"port_bench: {a.steps} steps; {100 * a.coverage:.3f}% of the device events "
             f"launched inside train.step; device ms a step by innermost span: "
             f"{per_step_text(a.device_s, a.steps)}; idle ms a step by innermost span at the "
             f"gap's start: {per_step_text(a.idle_s, a.steps)}")
    return 1e3 * sum(v for k, v in a.idle_s.items() if k != OUTSIDE) / a.steps
