"""The frozen counts: each kernel reader's bound reproduces, at the shapes
chip_smoke.py measures, the bound of the port's kernel table (K3 0.2774 and
K4 0.2775 ms at T=384, B=100, H=600), and the model counts are the models'
own arithmetic."""

import numpy as np
import pytest

from port_bench.harness import core
from port_bench.harness.peaks import bound_s
from port_bench.reference import dprnn, upit

K = {name: core.metric_reader(name) for name in ("k3_roofline", "k4_roofline")}
UPIT = core.config_spec("upit-2x600")["model"]
DPRNN = core.config_spec("dprnn-luo2020")["model"]


def ms(reader, *shape, dtype="bfloat16"):
    return 1e3 * bound_s(*reader.bytes_and_flops(*shape), dtype)


def smoke_lengths(T: int, B: int, seed: int) -> list:
    """chip_smoke.py's ragged lengths at its kernel shapes."""
    return [T, 1] + np.random.default_rng(seed).integers(1, T + 1, size=B - 2).tolist()


@pytest.mark.parametrize("name,T,B,seed,want", [
    ("k3_roofline", 384, 100, 2, 0.2774),
    ("k4_roofline", 384, 100, 2, 0.2775),
])
def test_lstm_bounds_match_the_kernel_table(name, T, B, seed, want):
    assert round(ms(K[name], T, B, 600, smoke_lengths(T, B, seed), 2), 4) == want


def test_bounds_are_set_by_bytes_for_bf16_and_grow_with_true_steps_only_in_operations():
    full = K["k3_roofline"].bytes_and_flops(384, 100, 600, [384] * 100, 2)
    half = K["k3_roofline"].bytes_and_flops(384, 100, 600, [192] * 100, 2)
    assert full[0] == half[0] and full[1] == 2 * half[1]


def test_upit_forward_is_26_74_mflop_a_frame():
    per_frame = upit.forward_flops_per_frame(UPIT)
    parts = 2 * 2 * 257 * 2400 + 2 * 2 * 1200 * 2400 + 2 * (2 * 2 * 600 * 2400) + 2 * 1200 * 514
    assert per_frame == parts
    assert round(per_frame / 1e6, 2) == 26.74
    assert upit.train_flops(UPIT, [100, 200]) == 3 * 300 * per_frame


def test_dprnn_launch_shapes_and_operations():
    launches = dprnn.lstm_launches(DPRNN, 32000, [32000] * 32)
    assert len(launches) == 2 * DPRNN["blocks"]
    (t_a, rows_a, h_a, lens_a), (t_b, rows_b, h_b, lens_b) = launches[:2]
    assert (t_a, rows_a, h_a) == (100, 32 * 81, 128) and (t_b, rows_b) == (81, 32 * 100)
    # a chunk's steps run from its start (the front pad's included) to the
    # last real latent frame; every row's inter-chunk pass runs all 81 chunks
    assert sum(lens_a) == 32 * sum(min(max(3999 - (50 * c - 50), 0), 100) for c in range(81))
    assert set(lens_b) == {81}
    per_utt = dprnn.forward_flops(DPRNN, 32000)
    assert 41e9 < per_utt < 42e9
