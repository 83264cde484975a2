"""The plain version of the port's LSTM inference kernel
(speech_separation_tpu_torch/ops/lstm_kernel.py) against the TPU kernel
lstm_seq_infer run in interpret mode, with a prefix and a suffix direction.

Tolerances: f32 weights atol 2e-5 (the JAX kernel tests' own); bf16 weights
atol 2e-2 (h_{t-1} is rounded to bf16 before each product, so a sum that
lands on the other side of a rounding boundary moves h by one bf16 step).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speech_separation_tpu.ops.lstm_pallas import lstm_seq_infer as jax_infer
from speech_separation_tpu_torch.ops.lstm_kernel import (lstm_seq_infer,
                                                         lstm_seq_infer_plain)

torch.set_num_threads(1)  # six xdist workers share the cores: one thread each, for life


def _inputs(T=16, D=2, B=4, H=24, seed=0):
    rng = np.random.default_rng(seed)
    G = 4 * H
    xw = (0.5 * rng.standard_normal((T, D, B, G))).astype(np.float32)
    w = (0.3 * rng.standard_normal((D, H, G))).astype(np.float32)
    h0 = rng.standard_normal((D, B, H)).astype(np.float32)
    c0 = rng.standard_normal((D, B, H)).astype(np.float32)
    lengths = np.asarray([T, T - 5, 1, 7][:B], np.int32)  # lengths 1 and T
    return xw, w, h0, c0, lengths


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_plain_matches_pallas_interpret(dtype, tol):
    xw, w, h0, c0, lengths = _inputs()
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = jax_infer(jnp.asarray(xw).astype(jdt), jnp.asarray(w).astype(jdt),
                    jnp.asarray(h0), jnp.asarray(c0), jnp.asarray(lengths),
                    interpret=True, suffix_dirs=(False, True))
    got = lstm_seq_infer(torch.from_numpy(xw).to(tdt), torch.from_numpy(w).to(tdt),
                         torch.from_numpy(h0), torch.from_numpy(c0),
                         torch.from_numpy(lengths), suffix_dirs=(False, True))
    for name, g, r in zip(("ys", "h_last", "c_last"), got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r, np.float32), atol=tol,
                                   err_msg=name)


def test_masked_steps_pass_the_carry_through():
    """Prefix direction: zero output from each row's length on; suffix
    direction: zero output before T - length, and a row of length 1 keeps h0
    until the last step."""
    xw, w, h0, c0, lengths = _inputs(T=10, B=4, H=8, seed=1)
    ys, h_last, _ = lstm_seq_infer_plain(
        torch.from_numpy(xw), torch.from_numpy(w), torch.from_numpy(h0),
        torch.from_numpy(c0), torch.from_numpy(lengths), suffix_dirs=(False, True))
    T = xw.shape[0]
    for b, L in enumerate(lengths):
        assert torch.all(ys[L:, 0, b] == 0)
        assert torch.all(ys[: T - L, 1, b] == 0)
        assert torch.all(ys[T - L:, 1, b] != 0)
    # a length-1 row: the forward carry after step 0 is the final state
    b1 = int(np.nonzero(lengths == 1)[0][0])
    np.testing.assert_array_equal(h_last[0, b1].numpy(), ys[0, 0, b1].numpy())


def test_wrapper_rejects_bad_shapes():
    xw, w, h0, c0, lengths = _inputs(T=4, B=2, H=8)
    with pytest.raises(ValueError, match="w_hh"):
        lstm_seq_infer(torch.from_numpy(xw), torch.from_numpy(w[:, :4]),
                       torch.from_numpy(h0), torch.from_numpy(c0),
                       torch.from_numpy(lengths))
