"""``correct`` comes out false when it should: each fault a cell can have,
planted underneath the timed path, and the control (the reference with fp8
products in the program's place), at a size a test run can hold. The runs
skip run.py's look for a card and drive the rest of a run on the CPU; the
float32 runs show the same run is correct without the fault."""

import pytest
import torch

from port_bench.harness import core
from port_bench.reference.common import rounding
from port_bench.tests.helpers import run_tiny, tiny
from port_bench.traffic import train_steps as ts

TRAIN = ["upit-train-b100", "dprnn-train-b32"]


@pytest.mark.parametrize("cell", TRAIN)
def test_sound_run_is_correct(cell):
    res, _ = run_tiny(cell, seconds=0.6, float32=True)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in TRAIN for f in ("frozen", "half_batch")])
def test_fault_is_not_correct(cell, fault):
    res, _ = run_tiny(cell, seconds=0.6, fault=fault, float32=True)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", TRAIN)
def test_half_the_batch_runs_every_row_and_fails_a_loss_number(cell):
    """The fault takes the loss over half the rows while the model runs all
    of them: every output matches, and a number that sees each row's share
    of the loss (the first loss, or the gradient the outputs receive) fails."""
    res, run = run_tiny(cell, seconds=0.05, fault="half_batch", float32=True)
    values = {k: v for k, (v, _) in run.checks.items()}
    assert values["out_gap"] < 1e-5, values
    assert not res["correct"]
    assert any(values.get(k, 0.0) > run.cell["checks"][k] for k in ("loss1_gap", "outgrad_gap")
               if k in run.cell["checks"]), values


def reference(run, params, batches, precision):
    """The reference's three steps and first outputs at ``precision``."""
    out = ts.reference_steps(run, params, batches[:3], precision)
    out.update(ts.reference_outputs(run, params, batches[0], precision))
    return out


@pytest.mark.parametrize("cell", TRAIN)
def test_training_control_is_not_correct(cell):
    run = core.Run(cell, 11, 0.0, False, "cpu", 0.0, tiny(cell))
    dev = torch.device("cpu")
    _, _, _, params = ts.build(run, dev)
    batches, _ = ts.make_batches(run, dev)
    ctl = ts.compare(reference(run, params, batches, "fp8"),
                     reference(run, params, batches, run.config["precision"]))
    assert any(ctl[k] > lim for k, lim in run.cell["checks"].items()), ctl


def test_rounding_of_the_control_is_coarser_than_the_configurations():
    x = torch.linspace(-1, 1, 1001)
    bf16 = (rounding("bfloat16")(x) - x).abs().max()
    fp8 = (rounding("fp8")(x) - x).abs().max()
    assert fp8 > 8 * bf16


@pytest.mark.cuda
@pytest.mark.parametrize("cell", TRAIN)
def test_on_the_card_program_passes_and_control_fails_at_the_cells_size(cell, cuda_device):
    from port_bench.readings import program_readings
    run = core.Run(cell, 2 ** 31 + 17, 0.0, False, "cuda", 0.0)
    got, params, batches = program_readings(run, cuda_device)
    ref = reference(run, params, batches, run.config["precision"])
    sound = ts.compare(got, ref)
    ctl = ts.compare(reference(run, params, batches, "fp8"), ref)
    limits = run.cell["checks"]
    assert all(sound[k] <= lim for k, lim in limits.items()), sound
    assert any(ctl[k] > lim for k, lim in limits.items()), ctl
