"""layer_norm_ms reads K6's kernels alone, a step at a time, and gives
nothing where the trace holds none of them (a program without K6)."""

import types

import pytest

from port_bench.harness import core
from port_bench.harness.trace import Trace

READER = core.metric_reader("layer_norm_ms")


def fake_run(names_and_durations, steps=2):
    events = []
    t = 0.0
    for k, (name, dur) in enumerate(names_and_durations):
        events.append((name, "kernel", t, t + dur, k))
        t += dur
    notes = []
    return types.SimpleNamespace(records={"train": {"steps": steps}},
                                 trace_data=Trace(events, (0.0, t), {}), note=notes.append,
                                 notes=notes)


def test_layer_norm_ms_sums_k6_kernels_a_step():
    run = fake_run([("void (anonymous namespace)::chan_ln_fwd<__nv_bfloat16, 8, 1>(...)", 1e-3),
                    ("void (anonymous namespace)::chan_ln_bwd<__nv_bfloat16, 8, 1>(...)", 2e-3),
                    ("(anonymous namespace)::chan_ln_bwd_params(float const*, ...)", 5e-4),
                    ("void at::native::vectorized_elementwise_kernel<4, ...>", 7e-3),
                    ("void sepattn::attn_fwd_rows<32, 16, true>(...)", 3e-3)])
    assert READER.read(run) == pytest.approx(1e3 * 3.5e-3 / 2)
    assert run.notes == ["port_bench: layer_norm_ms: launches a step chan_ln_bwd 0.5, "
                         "chan_ln_bwd_params 0.5, chan_ln_fwd 0.5"]


def test_layer_norm_ms_is_none_without_k6_or_a_trace():
    assert READER.read(fake_run([("void at::native::reduce_kernel<...>", 1e-3)])) is None
    run = fake_run([("chan_ln_fwd", 1e-3)])
    run.trace_data = None
    assert READER.read(run) is None
