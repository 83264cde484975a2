"""One run of one cell, from its name to its result line."""

from __future__ import annotations

import math
import sys

from port_bench.harness import core


class ForbiddenModules(RuntimeError):
    pass


def device_info(run) -> dict:
    import torch
    if run.device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
                "memory_peak_bytes": int(run.memory_peak_bytes)}
    return {"platform": run.device, "kind": run.device, "count": 1,
            "memory_peak_bytes": int(run.memory_peak_bytes)}


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: str, t_process: float,
             overrides: dict | None = None, fault: str | None = None) -> tuple:
    """Run the cell once; returns (result dict, Run). Raises
    ForbiddenModules if JAX or the JAX package was loaded by then."""
    bench = core.benchmark()
    run = core.Run(cell, seed, seconds, trace, device, t_process, overrides, fault)
    core.traffic_generator(run.traffic["kind"]).run(run)
    bad = core.forbidden_modules()
    if bad:
        raise ForbiddenModules(", ".join(bad))
    metrics = core.result_metrics(run, bench)
    dev = device_info(run)
    out = {"correct": run.correct(), "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": dev}
    if trace and run.trace_data is not None:
        dev["busy_s"] = run.trace_data.busy_s
        dev["window_s"] = run.trace_data.window_s
        out["breakdown"] = {"device_ops": run.trace_data.top_ops(10),
                            "idle_gaps": run.trace_data.idle_gaps(run.intervals, 10)}
    out["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in run.checks.items()}
    return out, run


def finite_or_none(obj):
    """JSON has no inf or nan: such a number is written as null."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: finite_or_none(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [finite_or_none(v) for v in obj]
    return obj


def print_checks(run) -> None:
    for line in core.checks_text(run):
        print(f"check {line}", file=sys.stderr, flush=True)
