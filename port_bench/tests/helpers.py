"""Tiny sizes at which the benchmark's cells run on the CPU in its tests."""

import time

import torch

from port_bench.harness.runner import run_cell

torch.set_num_threads(1)

TRAIN = {
    "upit-train-b100": {"model": {"hidden": 8, "feat_dim": 16},
                        "traffic": {"batch": 4, "frames": 12, "min_frames": 6, "max_frames": 12}},
    "dprnn-train-b32": {"model": {"rnn_hidden": 8, "channels": 8, "n_filters": 8, "blocks": 1,
                                  "chunk": 8},
                        "traffic": {"batch": 4, "seconds": 0.02}},
}
F32 = {"precision": "float32"}


def tiny(cell: str, float32: bool = False) -> dict:
    ov = TRAIN[cell]
    if not float32:
        return ov
    return {**ov, **F32, "model": {**ov["model"], "compute_dtype": "float32"}}


def run_tiny(cell: str, seed: int = 5, seconds: float = 0.5, trace: bool = False,
             fault: str | None = None, float32: bool = False, **extra):
    """run.py's run of a cell at a tiny size on the CPU, without its look for
    a card."""
    return run_cell(cell, seed, seconds, trace, "cpu", time.monotonic(),
                    overrides={**tiny(cell, float32), **extra}, fault=fault)
