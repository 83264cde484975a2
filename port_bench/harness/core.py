"""Finding a cell's files by name, the context of one run, and its result.

A cell (``workloads/<cell>.json``) names its configuration
(``configs/<config>.json``) and carries its traffic: a ``kind``, whose
generator is ``traffic/<kind>.py``, and the mix's parameters. Which metrics a
cell reports comes from ``BENCHMARK.json``: its end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``, each per-layer one
read by ``metrics/<metric>.py``. So a later change adds a configuration, a
cell or a metric as new files and new entries, and edits none of these.

The generator fills a :class:`Run`: the window's host interval, the end-to-end
values, what the readers need (host intervals, per-step records, the parsed
device trace), and the numbers compared for ``correct``, each beside its
limit.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
# top-level module names that may not be loaded in a run's process: JAX and
# the JAX package the port was made from (compared as whole names, so
# speech_separation_tpu_torch passes)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "speech_separation_tpu")
# every build or kernel cache a run may fill, at fixed paths in the checkout
# (the port's own kernels build into build/torch_kernels/ of the checkout)
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/port_bench/torch_extensions",
              "TRITON_CACHE_DIR": "build/port_bench/triton",
              "CUDA_CACHE_PATH": "build/port_bench/cuda_cache"}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_spec(name: str) -> dict:
    return load_json(BENCH_DIR / "workloads" / f"{name}.json")


def config_spec(name: str) -> dict:
    return load_json(BENCH_DIR / "configs" / f"{name}.json")


def load_file_module(path: Path, name: str):
    """A module loaded from ``path`` (a plugin whose file name, like
    ``device_idle.train.py``, need not be an identifier)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic_generator(kind: str):
    return load_file_module(BENCH_DIR / "traffic" / f"{kind}.py", f"port_bench_traffic_{kind}")


def metric_reader(name: str):
    return load_file_module(BENCH_DIR / "metrics" / f"{name}.py", f"port_bench_metric_{name}")


def reference_module(arch: str):
    """The plain reference of an arch: ``reference/<arch lower-cased>.py``."""
    return importlib.import_module(f"port_bench.reference.{arch.lower()}")


def metrics_of(bench: dict, cell: str, section: str) -> list:
    """The entries of ``bench[section]`` that the cell reports: those that
    list it under ``workloads``, and those with no ``workloads`` key."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    return sorted(n for n in list(sys.modules) if n.split(".")[0] in FORBIDDEN)


def set_cache_dirs(root: Path = ROOT) -> None:
    for var, rel in CACHE_DIRS.items():
        path = root / rel
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


class Run:
    """One run of one cell: what the traffic generator measured and recorded,
    for the result line and the per-layer readers."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool, device: str,
                 t_process: float, overrides: dict | None = None, fault: str | None = None):
        overrides = overrides or {}
        self.cell_name = cell
        self.cell = {**cell_spec(cell), **overrides.get("cell", {})}
        conf = config_spec(self.cell["config"])
        self.config = {**conf, "model": {**conf["model"], **overrides.get("model", {})},
                       "precision": overrides.get("precision", conf["precision"])}
        self.traffic = {**self.cell["traffic"], **overrides.get("traffic", {})}
        self.seed, self.seconds, self.trace, self.device = seed, seconds, trace, device
        # a fault planted underneath the timed path (the benchmark's own
        # tests and readings.py only; run.py never sets one)
        self.fault = fault
        self.t_process = t_process
        self.setup_s = math.nan
        self.window = None                    # (start, end), host monotonic seconds
        self.e2e: dict = {}                   # end-to-end metric -> value
        self.intervals: list = []             # (label, start, end), host monotonic
        self.records: dict = {}               # what the per-layer readers read
        self.checks: dict = {}                # compared number -> (value, limit)
        self.attempted = self.failed = 0
        self.memory_peak_bytes = 0
        self.trace_data = None                # harness/trace.Trace of a traced run

    @property
    def reference(self):
        return reference_module(self.config["arch"])

    def start_window(self) -> float:
        """Mark the first timed step: set-up ends here."""
        t = time.monotonic()
        self.setup_s = t - self.t_process
        return t

    @contextlib.contextmanager
    def interval(self, label: str):
        """A host interval the readers can map device work onto."""
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.intervals.append((label, t0, time.monotonic()))

    def check(self, name: str, value: float, limit: float) -> None:
        self.checks[name] = (float(value), float(limit))

    def correct(self) -> bool:
        return (self.failed == 0 and bool(self.checks)
                and all(v <= lim for v, lim in self.checks.values()))

    def phase(self, label: str) -> None:
        """Note how far into the process a step of set-up (or after) ends."""
        self.note(f"port_bench: {label} at {time.monotonic() - self.t_process:.3f} s")

    def note(self, line: str) -> None:
        print(line, file=sys.stderr, flush=True)


def result_metrics(run: Run, bench: dict) -> dict:
    """The cell's end-to-end metrics (untraced run) or per-layer metrics
    (traced run), each with its unit; a reader that finds nothing to read
    leaves its metric out."""
    out = {}
    if not run.trace:
        for m in metrics_of(bench, run.cell_name, "end_to_end"):
            value = run.setup_s if m["name"] == "setup_s" else run.e2e.get(m["name"])
            if value is not None and math.isfinite(value):
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out
    for m in metrics_of(bench, run.cell_name, "per_layer"):
        value = metric_reader(m["name"]).read(run)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def checks_text(run: Run) -> list:
    return [f"{name} {value!r} limit {limit!r}" for name, (value, limit) in run.checks.items()]
