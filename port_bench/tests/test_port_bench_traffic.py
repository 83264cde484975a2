"""The traffic generator gives the same batches for one seed and others for
another, and every seed the same set of sizes."""

import numpy as np
import pytest
import torch

from port_bench.harness import core
from port_bench.tests.helpers import tiny
from port_bench.traffic import train_steps


def batches(cell: str, seed: int):
    run = core.Run(cell, seed, 1.0, False, "cpu", 0.0, tiny(cell))
    return train_steps.make_batches(run, torch.device("cpu"))


@pytest.mark.parametrize("cell", ["upit-train-b100", "dprnn-train-b32"])
def test_training_batches_follow_the_seed(cell):
    (a, la), (b, lb), (c, lc) = batches(cell, 7), batches(cell, 7), batches(cell, 2 ** 31 + 9)
    for x, y, z in zip(a, b, c):
        for k in x:
            assert torch.equal(x[k], y[k])
        key = "mix" if "mix" in x else "mix_wav"
        assert not torch.equal(x[key], z[key])
    assert np.array_equal(la, lb)
    assert sorted(la.ravel()) == sorted(lc.ravel())
    rows = [r for x in a for r in x["row_mask"]]
    assert len({tuple(x["row_mask"].shape) for x in a}) == 1 and all(float(r) == 1.0 for r in rows)


def test_spectral_rows_are_zero_past_their_length():
    (a, lens) = batches("upit-train-b100", 3)
    for x, ln in zip(a, lens):
        for r, n in enumerate(ln):
            assert float(x["mix"][r, n:].abs().sum()) == 0.0
            assert float(x["mix"][r, :n].abs().sum()) > 0.0
