"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and skip without one. They import no JAX, so on
a machine with a card they run without the JAX package's test setup:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f32 atol 1e-5 (same math, other summation order); bf16 atol
2e-2 (one bf16 step of a rounded h_{t-1}); STFT atol 5e-5 of the largest
|X| (an f32 sum of n_fft products).
"""

import numpy as np
import pytest
import torch

from speech_separation_tpu_torch.ops.lstm_kernel import (lstm_seq_infer,
                                                         lstm_seq_infer_plain)
from speech_separation_tpu_torch.ops.stft_kernel import stft, stft_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("T,B,H", [(1, 1, 8), (11, 5, 24), (7, 33, 40)])
def test_lstm_kernel_matches_plain(cuda, dtype, tol, T, B, H):
    g = torch.Generator(device=cuda).manual_seed(T * 100 + B)
    xw = (0.5 * torch.randn((T, 2, B, 4 * H), generator=g, device=cuda)).to(dtype)
    w = (0.3 * torch.randn((2, H, 4 * H), generator=g, device=cuda)).to(dtype)
    h0 = torch.randn((2, B, H), generator=g, device=cuda)
    c0 = torch.randn((2, B, H), generator=g, device=cuda)
    lengths = torch.tensor(([T, 1] * B)[:B], dtype=torch.int32, device=cuda)
    before = lstm_seq_infer.launches
    got = lstm_seq_infer(xw, w, h0, c0, lengths, suffix_dirs=(False, True))
    ref = lstm_seq_infer_plain(xw, w, h0, c0, lengths, suffix_dirs=(False, True))
    torch.cuda.synchronize()
    assert lstm_seq_infer.launches == before + 1
    for name, a, b in zip(("ys", "h_last", "c_last"), got, ref):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), atol=tol, err_msg=name)


@pytest.mark.parametrize("magnitude", [False, True])
def test_stft_kernel_matches_plain(cuda, magnitude):
    g = torch.Generator(device=cuda).manual_seed(1)
    xp = torch.rand((5, 3 * 4096 + 512 + 7), generator=g, device=cuda) * 2 - 1
    n_t = 1 + 3 * 4096 // 128
    got = stft(xp, 512, 128, n_t, magnitude)
    ref = stft_plain(xp, 512, 128, n_t, magnitude)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    scale = max(float(r.abs().max()) for r in ref)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), atol=5e-5 * scale)


def test_kernels_refuse_what_they_do_not_take(cuda):
    with pytest.raises(ValueError, match="divide"):
        stft(torch.zeros((1, 2048), device=cuda), 512, 96, 4)
    xw = torch.zeros((3, 2, 2, 32), device=cuda)
    with pytest.raises(ValueError, match="h0"):
        lstm_seq_infer(xw, torch.zeros((2, 8, 32), device=cuda),
                       torch.zeros((2, 2, 4), device=cuda), torch.zeros((2, 2, 8), device=cuda),
                       torch.ones(2, dtype=torch.int32, device=cuda))
