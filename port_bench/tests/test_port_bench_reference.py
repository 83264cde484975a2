"""The plain references agree with the port at a tiny size on the CPU: in
float32 the port's training step is the reference's to rounding."""

import math

import pytest
import torch

from port_bench.harness import core
from port_bench.reference import upit as ref_upit
from port_bench.reference.common import rounding
from port_bench.tests.helpers import run_tiny, tiny
from port_bench.traffic import train_steps as ts


@pytest.mark.parametrize("cell", ["upit-train-b100", "dprnn-train-b32"])
def test_training_steps_match_the_reference_in_float32(cell):
    _, run = run_tiny(cell, seconds=0.05, float32=True)
    values = {k: v for k, (v, _) in run.checks.items()}
    assert {"out_gap", "change_gap"} <= set(values)
    assert all(v < 1e-5 for v in values.values()), values


def test_the_reference_sees_half_a_batch_as_another_loss():
    run = core.Run("upit-train-b100", 4, 1.0, False, "cpu", 0.0, tiny("upit-train-b100"))
    dev = torch.device("cpu")
    _, _, _, params = ts.build(run, dev)
    batches, _ = ts.make_batches(run, dev)
    q = rounding("bfloat16")
    whole = float(ref_upit.loss(params, run.config["model"], batches[0], q)[0])
    rows = batches[0]["row_mask"].shape[0] // 2
    half = float(ref_upit.loss(params, run.config["model"],
                               {k: v[:rows] for k, v in batches[0].items()}, q)[0])
    assert math.isfinite(whole) and abs(whole - half) / whole > 1e-3
