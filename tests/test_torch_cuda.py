"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and skip without one. They import no JAX, so on
a machine with a card they run without the JAX package's test setup:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f32 atol 1e-5 (same math, other summation order); bf16 atol
2e-2 (one bf16 step of a rounded h_{t-1}); STFT atol 5e-5 of the largest
|X| (an f32 sum of n_fft products against an f32 FFT, each within about
1e-6 of the exact DFT). Gradients are compared divided by
max(1, max |reference|): against the plain backward on the same saves at
the forward's tolerances (K4 alone at chip_smoke.py's: f32 1.5e-5, bf16
2e-2); against autograd through the plain forward at
1e-4 in f32 (sums over T steps in another order) and 2e-2 in bf16 (the
backward reads bf16-rounded saves, as the TPU kernel does). The attention
kernel (K5) against its plain versions: f32 1e-5, bf16 2e-2 of
max(1, max |reference|) (one bf16 rounding of each weight and output, at
places where a sum in another order can round the other way).
"""

import numpy as np
import pytest
import torch

from speech_separation_tpu_torch.ops.lstm_kernel import (lstm_seq, lstm_seq_bwd,
                                                         lstm_seq_bwd_plain, lstm_seq_fwd,
                                                         lstm_seq_fwd_plain, lstm_seq_infer,
                                                         lstm_seq_infer_plain)
from speech_separation_tpu_torch.ops.stft_kernel import stft, stft_plain

torch.set_num_threads(1)  # six xdist workers share the cores: one thread each, for life

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


def _stft_close(cuda, B, Lp, n_t, n_fft, hop, magnitude, offset=0, seed=0):
    """The kernel against its plain version at 5e-5 of the largest |X|, on
    rows whose storage starts ``offset`` floats past an aligned address."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    flat = torch.rand((B * Lp + offset,), generator=g, device=cuda) * 2 - 1
    xp = flat[offset:].view(B, Lp)
    before = stft.launches
    got = stft(xp, n_fft, hop, n_t, magnitude)
    ref = stft_plain(xp, n_fft, hop, n_t, magnitude)
    torch.cuda.synchronize()
    assert stft.launches == before + 1
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    scale = max(float(r.abs().max()) for r in ref)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), atol=5e-5 * scale)
    return got


@pytest.mark.parametrize("magnitude", [False, True])
@pytest.mark.parametrize("hop_div", [2, 4])
@pytest.mark.parametrize("n_fft", [64, 128, 256, 512, 1024, 2048, 4096, 8192])
def test_stft_fft_path_every_power_of_two(cuda, n_fft, hop_div, magnitude):
    from speech_separation_tpu_torch.ops.stft_kernel import stft_plan
    hop = n_fft // hop_div
    n_t = 37
    Lp = (n_t - 1) * hop + n_fft + 3
    assert stft_plan(3, Lp, n_t, n_fft, hop)["path"] == "fft"
    _stft_close(cuda, 3, Lp, n_t, n_fft, hop, magnitude, offset=1, seed=n_fft + hop_div)


@pytest.mark.parametrize("magnitude", [False, True])
@pytest.mark.parametrize("n_t", [1, 15, 16, 17, 513])
def test_stft_tile_edges_odd_rows_misaligned(cuda, n_t, magnitude):
    """n_t around the 16-frame tile, B odd, a row length that is not a
    multiple of 4 and rows that start off a 16-byte boundary."""
    for offset in (0, 1, 2, 3):
        _stft_close(cuda, 5, (n_t - 1) * 128 + 512 + 5, n_t, 512, 128, magnitude,
                    offset=offset, seed=n_t + offset)


@pytest.mark.parametrize("magnitude", [False, True])
@pytest.mark.parametrize("n_fft,hop", [(384, 128), (320, 160), (96, 32), (8, 4), (16384, 4096)])
def test_stft_direct_path(cuda, n_fft, hop, magnitude):
    """Sizes that are not powers of two, and a power of two above the FFT
    path's cap, take the dense product."""
    from speech_separation_tpu_torch.ops.stft_kernel import stft_plan
    n_t = 29
    Lp = (n_t - 1) * hop + n_fft + 1
    assert stft_plan(3, Lp, n_t, n_fft, hop)["path"] == "direct"
    _stft_close(cuda, 3, Lp, n_t, n_fft, hop, magnitude, offset=3, seed=n_fft)


@pytest.mark.parametrize("magnitude", [False, True])
def test_stft_kernel_is_deterministic(cuda, magnitude):
    g = torch.Generator(device=cuda).manual_seed(5)
    xp = torch.rand((16, 65536 + 512), generator=g, device=cuda) * 2 - 1
    first = stft(xp, 512, 128, 513, magnitude)
    again = stft(xp, 512, 128, 513, magnitude)
    torch.cuda.synchronize()
    first = first if isinstance(first, tuple) else (first,)
    again = again if isinstance(again, tuple) else (again,)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_stft_plan_is_the_cards_plan(cuda):
    """stft_plan, a pure function tested on the CPU, is the launch the built
    library makes (sep_stft_plan), powers of two above the FFT path's cap go
    to the direct path, and both refuse above the direct path's cap."""
    from speech_separation_tpu_torch.ops.stft_kernel import (DIRECT_N_FFT_CAP, N_FFT_CAP,
                                                             card_plan, stft_plan)
    for B, n_t in ((1, 1), (3, 17), (16, 513), (300, 384)):
        n_fft = 2
        while n_fft <= N_FFT_CAP:
            for hop in (n_fft, max(1, n_fft // 4)):
                Lp = (n_t - 1) * hop + n_fft + 7
                assert card_plan(B, Lp, n_t, n_fft, hop) == stft_plan(B, Lp, n_t, n_fft, hop)
            n_fft *= 2
        for n_fft, hop in ((384, 128), (320, 160), (6000, 1000), (2 * N_FFT_CAP, N_FFT_CAP),
                           (DIRECT_N_FFT_CAP, DIRECT_N_FFT_CAP // 2)):
            Lp = (n_t - 1) * hop + n_fft
            assert card_plan(B, Lp, n_t, n_fft, hop) == stft_plan(B, Lp, n_t, n_fft, hop)
    assert card_plan(1, 4 * N_FFT_CAP, 1, 2 * N_FFT_CAP, N_FFT_CAP)["path"] == "direct"
    assert card_plan(1, 4 * DIRECT_N_FFT_CAP, 1, DIRECT_N_FFT_CAP + 2, 2) is None


def test_stft_refuses_above_its_cap(cuda):
    from speech_separation_tpu_torch.ops.stft_kernel import DIRECT_N_FFT_CAP
    n_fft = DIRECT_N_FFT_CAP + 2
    with pytest.raises(ValueError, match=f"n_fft <= {DIRECT_N_FFT_CAP}"):
        stft(torch.zeros((1, 2 * n_fft), device=cuda), n_fft, n_fft // 4, 2)


def test_kernels_refuse_what_they_do_not_take(cuda):
    with pytest.raises(ValueError, match="divide"):
        stft(torch.zeros((1, 2048), device=cuda), 512, 96, 4)
    xw = torch.zeros((3, 2, 2, 32), device=cuda)
    with pytest.raises(ValueError, match="h0"):
        lstm_seq_infer(xw, torch.zeros((2, 8, 32), device=cuda),
                       torch.zeros((2, 2, 4), device=cuda), torch.zeros((2, 2, 8), device=cuda),
                       torch.ones(2, dtype=torch.int32, device=cuda))


def _lstm_args(cuda, dtype, T, B, H, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    xw = (0.5 * torch.randn((T, 2, B, 4 * H), generator=g, device=cuda)).to(dtype)
    w = (0.3 * torch.randn((2, H, 4 * H), generator=g, device=cuda)).to(dtype)
    h0 = torch.randn((2, B, H), generator=g, device=cuda)
    c0 = torch.randn((2, B, H), generator=g, device=cuda)
    lengths = torch.tensor(([T, 1, max(1, T // 2)] * B)[:B], dtype=torch.int32, device=cuda)
    return xw, w, h0, c0, lengths


def _scaled_close(a, b, tol, name):
    b = b.float().cpu().numpy()
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a.float().cpu().numpy() / scale, b / scale, atol=tol,
                               err_msg=name)


SFX = (False, True)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("T,B,H", [(1, 1, 8), (11, 5, 24), (7, 33, 40)])
def test_lstm_training_kernels_match_plain(cuda, dtype, tol, T, B, H):
    """K3 on all five outputs, then K4 on the same saves and cotangents."""
    args = _lstm_args(cuda, dtype, T, B, H, T * 100 + B)
    before = (lstm_seq_fwd.launches, lstm_seq_bwd.launches)
    got = lstm_seq_fwd(*args, save_dtype=dtype, suffix_dirs=SFX)
    ref = lstm_seq_fwd_plain(*args, save_dtype=dtype, suffix_dirs=SFX)
    for name, a, b in zip(("ys", "cs", "gates", "h_last", "c_last"), got, ref):
        assert a.dtype == b.dtype, name
        np.testing.assert_allclose(a.float().cpu().numpy(), b.float().cpu().numpy(),
                                   atol=tol, err_msg=name)
    _, w, _, c0, lengths = args
    _, cs, gates, _, _ = ref
    g = torch.Generator(device=cuda).manual_seed(7)
    dys = torch.randn(cs.shape, generator=g, device=cuda).to(dtype)
    dh_last = torch.randn(c0.shape, generator=g, device=cuda)
    dc_last = torch.randn(c0.shape, generator=g, device=cuda)
    bargs = (w, c0, lengths, cs, gates, dys, dh_last, dc_last)
    got = lstm_seq_bwd(*bargs, save_dtype=dtype, suffix_dirs=SFX)
    ref = lstm_seq_bwd_plain(*bargs, save_dtype=dtype, suffix_dirs=SFX)
    torch.cuda.synchronize()
    assert (lstm_seq_fwd.launches, lstm_seq_bwd.launches) == (before[0] + 1, before[1] + 1)
    for name, a, b in zip(("dxw", "dh0", "dc0"), got, ref):
        _scaled_close(a, b, tol, name)


# chip_smoke.py's TRAIN_TOL for K3 (fwd_f32 2e-5, fwd_bf16 4e-2, divided by
# max(1, max |reference|)); K1 at this file's tolerances (absolute f32 1e-5,
# bf16 2e-2)
FWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 4e-2}
INFER_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _fwd_args(cuda, dtype, T, B, H, seed):
    """The forward's inputs at the model's scale: W_hh uniform in
    +-1/sqrt(H) (the reference's initialisation), xw 0.5 N(0, 1); lengths
    T, 1 and T // 2 in turn."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    xw = (0.5 * torch.randn((T, 2, B, 4 * H), generator=g, device=cuda)).to(dtype)
    w = ((torch.rand((2, H, 4 * H), generator=g, device=cuda) * 2 - 1) / H ** 0.5).to(dtype)
    h0 = torch.randn((2, B, H), generator=g, device=cuda)
    c0 = torch.randn((2, B, H), generator=g, device=cuda)
    lengths = torch.tensor(([T, 1, max(1, T // 2)] * B)[:B], dtype=torch.int32, device=cuda)
    return xw, w, h0, c0, lengths


def _check_fwd(cuda, dtype, T, B, H):
    """K3 on all five outputs and K1 on its three, against their plain
    versions, one launch each."""
    args = _fwd_args(cuda, dtype, T, B, H, T * 1000 + B + H)
    before = (lstm_seq_fwd.launches, lstm_seq_infer.launches)
    got = lstm_seq_fwd(*args, save_dtype=dtype, suffix_dirs=SFX)
    ref = lstm_seq_fwd_plain(*args, save_dtype=dtype, suffix_dirs=SFX)
    for name, a, b in zip(("ys", "cs", "gates", "h_last", "c_last"), got, ref):
        assert a.dtype == b.dtype, name
        _scaled_close(a, b, FWD_TOL[dtype], name)
    got = lstm_seq_infer(*args, suffix_dirs=SFX)
    ref = lstm_seq_infer_plain(*args, suffix_dirs=SFX)
    torch.cuda.synchronize()
    assert (lstm_seq_fwd.launches, lstm_seq_infer.launches) == (before[0] + 1, before[1] + 1)
    for name, a, b in zip(("ys", "h_last", "c_last"), got, ref):
        assert a.dtype == b.dtype == torch.float32, name
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), atol=INFER_TOL[dtype],
                                   err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B,H", [(1, 17, 24), (7, 1, 40), (5, 100, 20), (3, 9, 25),
                                   (4, 33, 36), (4, 17, 600), (9, 100, 598), (1, 100, 600),
                                   (3, 128, 600), (2, 200, 600), (2, 300, 40),
                                   (2, 1000, 24), (3, 33, 601), (6, 100, 601)])
def test_lstm_fwd_kernels_tiling_edges(cuda, dtype, T, B, H):
    """K3 and K1 against their plain versions where the tiling has edges: B
    not a multiple of 16 (a partial m-tile), B above one group of the ring's
    rows (at most 128 rows; at H=600 112 in bf16, 48 in f32), H not a
    multiple of the 8 units per CTA (a partial last CTA, zero pad columns in
    the exchange), H not a multiple of 16 (a partial last k-step) or of the
    chunk (128 columns in bf16, 64 in f32), xw rows aligned to 16, 8, 4 or
    (odd H in bf16: plain loads) 2 bytes, T=1; lengths 1 and T, a prefix and
    a suffix direction."""
    _check_fwd(cuda, dtype, T, B, H)


def test_lstm_fwd_kernels_at_the_dprnn_shape(cuda):
    """DPRNN's intra-chunk BLSTM: H=128, B=3200 rows (25 groups of 128), 100
    steps, bf16."""
    _check_fwd(cuda, torch.bfloat16, 100, 3200, 128)


@pytest.mark.parametrize("dtype,H", [(torch.float32, 848), (torch.bfloat16, 1056)])
def test_lstm_fwd_kernels_at_the_widest_h(cuda, dtype, H):
    """The widest H whose grid an H100 holds at two CTAs per SM: 2 * 132 CTAs
    of 8 units in bf16; in f32, W_hh's columns at H=848 leave room beside
    them for a ring of one 8-row group only."""
    from speech_separation_tpu_torch.ops.lstm_kernel import lstm_fwd_plan
    plan = lstm_fwd_plan(2, 100, H, dtype)
    assert plan["per_sm"] == 2, plan
    _check_fwd(cuda, dtype, 2, 100, H)


@pytest.mark.parametrize("B", [100, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_fwd_kernels_are_deterministic(cuda, dtype, B):
    """Two launches on the same inputs give bit-identical ys, cs, gates,
    h_last and c_last (K3) and ys, h_last, c_last (K1): each gate sum has one
    owner and a fixed order."""
    args = _fwd_args(cuda, dtype, 12, B, 600, 5)
    for names, run in ((("ys", "cs", "gates", "h_last", "c_last"),
                        lambda: lstm_seq_fwd(*args, save_dtype=dtype, suffix_dirs=SFX)),
                       (("ys", "h_last", "c_last"),
                        lambda: lstm_seq_infer(*args, suffix_dirs=SFX))):
        first, second = run(), run()
        torch.cuda.synchronize()
        assert len(first) == len(names)
        for name, a, b in zip(names, first, second):
            assert torch.equal(a, b), name


def test_lstm_fwd_refuses_a_grid_that_cannot_be_resident(cuda):
    """At H=600 the forward's 150 CTAs sit two to an SM whatever B. At
    H=1064 it needs 2 * 133 CTAs, more than an H100's 132 SMs hold at two
    each: both instances raise, naming that cap, and launch nothing. In f32
    at H=856, W_hh's columns leave no room for a second CTA on an SM, so the
    cap is one CTA per SM."""
    from speech_separation_tpu_torch.ops.lstm_kernel import lstm_fwd_plan
    for dtype in (torch.bfloat16, torch.float32):
        for B in (1, 100, 128, 200, 1000):
            plan = lstm_fwd_plan(2, B, 600, dtype)
            sms = plan["sms"]
            assert (plan["ctas"], plan["per_sm"], plan["cap"]) == (150, 2, 2 * sms), plan
    before = (lstm_seq_fwd.launches, lstm_seq_infer.launches)
    args = _fwd_args(cuda, torch.bfloat16, 1, 100, 1064, 3)
    with pytest.raises(ValueError, match=rf"cap of {2 * sms} \(2 per SM"):
        lstm_seq_fwd(*args, save_dtype=torch.bfloat16, suffix_dirs=SFX)
    with pytest.raises(ValueError, match=rf"cap of {2 * sms} \(2 per SM"):
        lstm_seq_infer(*args, suffix_dirs=SFX)
    with pytest.raises(ValueError, match=rf"cap of {sms} \(1 per SM"):
        lstm_fwd_plan(2, 100, 856, torch.float32)
    assert (lstm_seq_fwd.launches, lstm_seq_infer.launches) == before


def _bwd_args(cuda, dtype, T, B, H, seed):
    """K4's inputs: the plain forward's saves and random cotangents."""
    args = _lstm_args(cuda, dtype, T, B, H, seed)
    _, cs, gates, _, _ = lstm_seq_fwd_plain(*args, save_dtype=dtype, suffix_dirs=SFX)
    _, w, _, c0, lengths = args
    g = torch.Generator(device=cuda).manual_seed(seed + 1)
    dys = torch.randn(cs.shape, generator=g, device=cuda).to(dtype)
    dh_last = torch.randn(c0.shape, generator=g, device=cuda)
    dc_last = torch.randn(c0.shape, generator=g, device=cuda)
    return w, c0, lengths, cs, gates, dys, dh_last, dc_last


# chip_smoke.py's TRAIN_TOL for K4: bwd_f32 1.5e-5, bwd_bf16 2e-2
BWD_TOL = [(torch.float32, 1.5e-5), (torch.bfloat16, 2e-2)]


def _check_bwd(cuda, dtype, tol, T, B, H):
    bargs = _bwd_args(cuda, dtype, T, B, H, T * 1000 + B + H)
    before = lstm_seq_bwd.launches
    got = lstm_seq_bwd(*bargs, save_dtype=dtype, suffix_dirs=SFX)
    ref = lstm_seq_bwd_plain(*bargs, save_dtype=dtype, suffix_dirs=SFX)
    torch.cuda.synchronize()
    assert lstm_seq_bwd.launches == before + 1
    for name, a, b in zip(("dxw", "dh0", "dc0"), got, ref):
        assert a.dtype == b.dtype, name
        _scaled_close(a, b, tol, name)


@pytest.mark.parametrize("dtype,tol", BWD_TOL)
@pytest.mark.parametrize("T,B,H", [(1, 17, 24), (7, 1, 40), (5, 100, 20), (3, 17, 36),
                                   (4, 17, 600), (9, 100, 598), (3, 128, 600),
                                   (2, 200, 600), (2, 300, 40), (2, 1000, 24),
                                   (4, 9, 25), (3, 33, 601)])
def test_lstm_bwd_kernel_tiling_edges(cuda, dtype, tol, T, B, H):
    """K4 against its plain version where the tiling has edges: B not a
    multiple of 16 (a partial m-tile), B above one group of the ring's rows
    (at most 128 rows a group: 2, 3 and 8 groups here), H not a multiple of
    the 8 units per CTA (a partial last CTA), 4H not a multiple of the
    chunk (128 columns in bf16, 32 in f32: a partial last chunk), an odd H
    (dxw rows copied 8 bytes at a time in bf16), T=1; lengths 1 and T, a
    prefix and a suffix direction."""
    _check_bwd(cuda, dtype, tol, T, B, H)


@pytest.mark.parametrize("dtype,tol,H", [(torch.float32, 1.5e-5, 864),
                                         (torch.bfloat16, 2e-2, 1056)])
def test_lstm_bwd_kernel_at_the_widest_h(cuda, dtype, tol, H):
    """The widest H whose grid an H100 holds: 2 * 132 CTAs of 8 units in
    bf16; in f32, W_hh's rows at H=864 leave room beside them for a ring of
    one 16-row m-tile only."""
    from speech_separation_tpu_torch.ops.lstm_kernel import lstm_bwd_plan
    plan = lstm_bwd_plan(2, 100, H, dtype)
    assert plan["per_sm"] == 2, plan
    _check_bwd(cuda, dtype, tol, 2, 100, H)


@pytest.mark.parametrize("B", [100, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_bwd_kernel_is_deterministic(cuda, dtype, B):
    """Two launches on the same inputs give bit-identical dxw, dh0 and dc0:
    each dh entry has one owner and a fixed order of its sum."""
    bargs = _bwd_args(cuda, dtype, 12, B, 600, 5)
    first = lstm_seq_bwd(*bargs, save_dtype=dtype, suffix_dirs=SFX)
    second = lstm_seq_bwd(*bargs, save_dtype=dtype, suffix_dirs=SFX)
    torch.cuda.synchronize()
    for name, a, b in zip(("dxw", "dh0", "dc0"), first, second):
        assert torch.equal(a, b), name


def test_lstm_bwd_refuses_a_grid_that_cannot_be_resident(cuda):
    """At H=600 the backward's 150 CTAs sit two to an SM whatever B. At
    H=1200 it needs 2 * 150 CTAs; two still fit on an SM, so an H100's 132
    SMs hold 264, and the wrapper raises, naming that cap, and launches
    nothing. In f32 at H=1056, W_hh's rows leave no room for a second CTA
    on an SM, so the cap is one CTA per SM."""
    from speech_separation_tpu_torch.ops.lstm_kernel import lstm_bwd_plan
    for dtype in (torch.bfloat16, torch.float32):
        for B in (1, 100, 128, 200, 1000):
            plan = lstm_bwd_plan(2, B, 600, dtype)
            sms = plan["sms"]
            assert (plan["ctas"], plan["per_sm"], plan["cap"]) == (150, 2, 2 * sms), plan
    before = lstm_seq_bwd.launches
    bargs = _bwd_args(cuda, torch.bfloat16, 1, 100, 1200, 3)
    with pytest.raises(ValueError, match=rf"cap of {2 * sms} \(2 per SM"):
        lstm_seq_bwd(*bargs, save_dtype=torch.bfloat16, suffix_dirs=SFX)
    with pytest.raises(ValueError, match=rf"cap of {sms} \(1 per SM"):
        lstm_bwd_plan(2, 100, 1056, torch.float32)
    assert lstm_seq_bwd.launches == before


@pytest.mark.parametrize("T,B", [(100, 2656), (83, 3200)])
def test_lstm_kernels_pass_length_zero_rows_through(cuda, T, B):
    """K1, K3 and K4 at DPRNN's BLSTM shapes (H=128, bf16), where chunks that
    lie wholly in a row's padding give rows of length 0 (and 1): such a row's
    state passes through every kernel exactly, its gate gradients are zero,
    and every output is within the tolerances above of the plain versions."""
    dt, H = torch.bfloat16, 128
    xw, w, h0, c0, _ = _fwd_args(cuda, dt, T, B, H, T + B)
    lengths = torch.tensor(([0, 1, T, 0, T // 3] * B)[:B], dtype=torch.int32, device=cuda)
    zero = lengths == 0
    args = (xw, w, h0, c0, lengths)
    ys, h_last, c_last = lstm_seq_infer(*args, suffix_dirs=SFX)
    for name, a, b in zip(("ys", "h_last", "c_last"), (ys, h_last, c_last),
                          lstm_seq_infer_plain(*args, suffix_dirs=SFX)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), atol=INFER_TOL[dt],
                                   err_msg=name)
    got = lstm_seq_fwd(*args, save_dtype=dt, suffix_dirs=SFX)
    ref = lstm_seq_fwd_plain(*args, save_dtype=dt, suffix_dirs=SFX)
    for name, a, b in zip(("ys", "cs", "gates", "h_last", "c_last"), got, ref):
        _scaled_close(a, b, FWD_TOL[dt], name)
    g = torch.Generator(device=cuda).manual_seed(3)
    dh_last = torch.randn(c0.shape, generator=g, device=cuda)
    dc_last = torch.randn(c0.shape, generator=g, device=cuda)
    bargs = (w, c0, lengths, ref[1], ref[2],
             torch.randn(ref[1].shape, generator=g, device=cuda).to(dt), dh_last, dc_last)
    dxw, dh0, dc0 = lstm_seq_bwd(*bargs, save_dtype=dt, suffix_dirs=SFX)
    for name, a, b in zip(("dxw", "dh0", "dc0"), (dxw, dh0, dc0),
                          lstm_seq_bwd_plain(*bargs, save_dtype=dt, suffix_dirs=SFX)):
        _scaled_close(a, b, 2e-2, name)
    torch.cuda.synchronize()
    for a, b in ((h_last, h0), (c_last, c0), (got[3], h0), (got[4], c0), (dh0, dh_last),
                 (dc0, dc_last)):
        assert torch.equal(a[:, zero], b[:, zero])
    assert not dxw[:, :, zero].any()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_lstm_seq_gradients_match_plain_autograd(cuda, dtype, tol):
    """lstm_seq (K3 forward, K4 backward, dW_hh outside) against autograd
    through the plain forward, on the card."""
    T, B, H = 13, 20, 40
    base = _lstm_args(cuda, dtype, T, B, H, 11)
    lengths = base[4]
    g = torch.Generator(device=cuda).manual_seed(12)
    cot = torch.randn((T, 2, B, H), generator=g, device=cuda)

    def grads(fn):
        ts = [t.detach().clone().requires_grad_(True) for t in base[:4]]
        ys, h_last, c_last = fn(ts)
        (torch.sum(ys.float() * cot) + torch.sum(torch.sin(h_last))
         + 0.1 * torch.sum(c_last ** 2)).backward()
        return [t.grad for t in ts]

    def plain(ts):
        ys, _, _, h_last, c_last = lstm_seq_fwd_plain(*ts, lengths, dtype, SFX)
        return ys, h_last, c_last

    got = grads(lambda ts: lstm_seq(*ts, lengths, dtype, SFX))
    ref = grads(plain)
    torch.cuda.synchronize()
    for name, a, b in zip(("dxw", "dw_hh", "dh0", "dc0"), got, ref):
        assert a.dtype == b.dtype, name
        _scaled_close(a, b, tol, name)


def test_blstm_training_gives_every_parameter_a_gradient(cuda):
    from speech_separation_tpu_torch.models import upit
    cfg = upit.Config(feat_dim=20, num_spk=2, hidden=24, num_layers=2,
                      compute_dtype="bfloat16")
    model = upit.UPIT(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    B, T = 5, 9
    lengths = torch.tensor([T, 4, 1, 9, 6], dtype=torch.int32, device=cuda)
    valid = (torch.arange(T, device=cuda)[None, :, None] < lengths[:, None, None])
    batch = {"mix": torch.rand((B, T, 20), generator=g, device=cuda) * valid,
             "sources": torch.rand((B, 2, T, 20), generator=g, device=cuda) * valid[:, None],
             "lengths": lengths, "row_mask": torch.ones(B, device=cuda)}
    before = (lstm_seq_fwd.launches, lstm_seq_bwd.launches, lstm_seq_infer.launches)
    loss, _ = upit.loss_fn(model, batch, g, True)
    loss.backward()
    torch.cuda.synchronize()
    assert (lstm_seq_fwd.launches, lstm_seq_bwd.launches, lstm_seq_infer.launches) == (
        before[0] + 2, before[1] + 2, before[2])
    for name, p in model.blstm.named_parameters():
        assert p.grad is not None and float(p.grad.abs().max()) > 0, name


def test_training_kernels_refuse_what_they_do_not_take(cuda):
    xw, w, h0, c0, lengths = _lstm_args(cuda, torch.float32, 3, 2, 8, 0)
    with pytest.raises(ValueError, match="save_dtype"):
        lstm_seq_fwd(xw, w, h0, c0, lengths, save_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="xw"):
        lstm_seq_fwd(xw.bfloat16(), w, h0, c0, lengths, save_dtype=torch.float32)
    ys, cs, gates, _, _ = lstm_seq_fwd(xw, w, h0, c0, lengths, save_dtype=torch.float32)
    with pytest.raises(ValueError, match="dys"):
        lstm_seq_bwd(w, c0, lengths, cs, gates, ys[:2], h0, c0, save_dtype=torch.float32)
    with pytest.raises(ValueError, match="cs"):
        lstm_seq_bwd(w, c0, lengths, cs.bfloat16(), gates, ys, h0, c0,
                     save_dtype=torch.float32)
    with pytest.raises(RuntimeError, match="lstm_seq"):
        lstm_seq_infer(xw, w.requires_grad_(True), h0, c0, lengths)
    with torch.no_grad():
        lstm_seq_infer(xw, w, h0, c0, lengths)


def test_side_stream_copy_delivers_the_batch(cuda):
    """The trainer's transfer copies pinned arrays on a side stream; after
    _wait_for_copy the current stream reads exactly the collated arrays, for
    feature batches and for shipped waveform batches."""
    from speech_separation_tpu_torch.train import loop
    rng = np.random.default_rng(0)
    common = {"lengths": np.array([32, 20, 5, 0], np.int32),
              "row_mask": np.array([1, 1, 1, 0], np.float32), "names": ["a", "b", "c"]}
    features = {"mix": rng.random((4, 32, 257), dtype=np.float32),
                "sources": rng.random((4, 2, 32, 257), dtype=np.float32), **common}
    audio = {"audio": rng.integers(-2 ** 15, 2 ** 15, (4, 3, 4608)).astype(np.int16),
             "sample_lengths": np.array([4000, 2500, 600, 0], np.int32), **common}
    for batch, keys in ((features, loop.FEATURE_KEYS), (audio, loop.AUDIO_KEYS)):
        got = loop._wait_for_copy(loop.to_device(batch, cuda, torch.cuda.Stream(cuda), keys))
        assert "ready" not in got and got["n_real"] == 3 and got["names"] == batch["names"]
        for k in keys:
            assert got[k].device.type == "cuda", k
            np.testing.assert_array_equal(got[k].cpu().numpy(), batch[k], err_msg=k)


# ----------------------------------------------------------- K5 attention

def _attn_args(cuda, dtype, N, T, dh, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v, do = (torch.randn((N, T, dh), generator=g, device=cuda).to(dtype)
                   for _ in range(4))
    lens = torch.randint(1, T + 1, (N,), generator=g, device=cuda)
    lens[min(1, N - 1)] = 0                       # a fully-masked row
    mask = (torch.arange(T, device=cuda)[None, :] < lens[:, None]).float()
    return q, k, v, mask, do


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("N,T,dh", [(1, 1, 16), (13, 20, 8), (37, 100, 16), (5, 300, 16),
                                    (3, 1100, 4), (4, 70, 64)])
def test_attention_kernels_match_plain(cuda, dtype, tol, N, T, dh):
    """K5 forward and backward against their plain versions, scaled by
    max(1, max |reference|); T=300 and T=1100 take more than one key tile."""
    from speech_separation_tpu_torch.ops.attention_kernel import (
        chunk_attention_bwd, chunk_attention_bwd_plain, chunk_attention_fwd,
        chunk_attention_fwd_plain)
    q, k, v, mask, do = _attn_args(cuda, dtype, N, T, dh, N * 1000 + T)
    before = (chunk_attention_fwd.launches, chunk_attention_bwd.launches)
    o = chunk_attention_fwd(q, k, v, mask)
    grads = chunk_attention_bwd(q, k, v, mask, do)
    torch.cuda.synchronize()
    assert (chunk_attention_fwd.launches, chunk_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert o.dtype == dtype and all(t.dtype == dtype for t in grads)
    _scaled_close(o, chunk_attention_fwd_plain(q, k, v, mask), tol, "o")
    for name, a, b in zip(("dq", "dk", "dv"), grads,
                          chunk_attention_bwd_plain(q, k, v, mask, do)):
        _scaled_close(a, b, tol, name)


def test_attention_kernel_refuses_what_it_does_not_take(cuda):
    from speech_separation_tpu_torch.ops.attention_kernel import (
        MAX_T_BWD, chunk_attention_bwd, chunk_attention_fwd)
    q, k, v, mask, do = _attn_args(cuda, torch.float32, 3, 8, 16, 0)
    with pytest.raises(ValueError, match="dtype"):
        chunk_attention_fwd(q, k.bfloat16(), v, mask)
    with pytest.raises(ValueError, match="dtype"):
        chunk_attention_bwd(q, k, v, mask, do.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        chunk_attention_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, mask)
    with pytest.raises(ValueError, match="dh"):
        chunk_attention_fwd(*(t[..., :12].contiguous() for t in (q, k, v)), mask)
    big = torch.zeros((1, MAX_T_BWD + 1, 4), device=cuda)
    with pytest.raises(ValueError, match=str(MAX_T_BWD)):
        chunk_attention_bwd(big, big, big, torch.ones((1, MAX_T_BWD + 1), device=cuda), big)


def test_fused_sepformer_step_launches_the_attention_kernels(cuda):
    """A fused SepFormer forward and backward on the card launches K5's
    forward once per attention layer and its backward once per layer, and
    gives every parameter a gradient."""
    from speech_separation_tpu_torch.models import sepformer
    from speech_separation_tpu_torch.ops.attention_kernel import (chunk_attention_bwd,
                                                                  chunk_attention_fwd)
    cfg = sepformer.Config(n_filters=16, channels=16, heads=2, d_ff=24, chunk=8, blocks=2,
                           fused_attention=True, compute_dtype="bfloat16")
    model = sepformer.SepFormer(cfg, torch.Generator().manual_seed(0)).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    srcs = 0.1 * torch.randn((3, 2, 800), generator=g, device=cuda)
    lengths = torch.tensor([800, 555, 123], dtype=torch.int32, device=cuda)
    srcs = srcs * (torch.arange(800, device=cuda)[None, None] < lengths[:, None, None])
    batch = {"mix_wav": srcs.sum(1), "source_wavs": srcs, "sample_lengths": lengths,
             "row_mask": torch.ones(3, device=cuda)}
    before = (chunk_attention_fwd.launches, chunk_attention_bwd.launches)
    loss, _ = sepformer.loss_fn(model, batch, None, True)
    loss.backward()
    torch.cuda.synchronize()
    assert (chunk_attention_fwd.launches, chunk_attention_bwd.launches) == (
        before[0] + 4, before[1] + 4)
    assert torch.isfinite(loss)
    for name, p in model.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name


def _attn_edge_args(cuda, N, T, dh, seed):
    """bf16 rows with ragged key masks: row 1 fully masked and, where N > 2,
    row 2 whose only valid key is the last."""
    q, k, v, mask, do = _attn_args(cuda, torch.bfloat16, N, T, dh, seed)
    if N > 2:
        mask[2] = 0.0
        mask[2, -1] = 1.0
    return q, k, v, mask, do


@pytest.mark.parametrize("dh", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("T", [1, 15, 16, 17, 83, 100, 104, 129, 256, 257, 1230])
def test_attention_bf16_kernels_at_tile_edges(cuda, T, dh):
    """The bf16 kernels (tensor cores; registers up to REG_CAP = 256, passes
    above) against their plain versions at 2e-2 of max(1, max |reference|),
    at the edges of the 16-row m-tiles, the register cap and the key tiles,
    with N odd."""
    from speech_separation_tpu_torch.ops.attention_kernel import (
        REG_CAP, chunk_attention_bwd, chunk_attention_bwd_plain, chunk_attention_fwd,
        chunk_attention_fwd_plain)
    assert REG_CAP == 256
    q, k, v, mask, do = _attn_edge_args(cuda, 3, T, dh, T * 10 + dh)
    o = chunk_attention_fwd(q, k, v, mask)
    grads = chunk_attention_bwd(q, k, v, mask, do)
    torch.cuda.synchronize()
    _scaled_close(o, chunk_attention_fwd_plain(q, k, v, mask), 2e-2, "o")
    for name, a, b in zip(("dq", "dk", "dv"), grads,
                          chunk_attention_bwd_plain(q, k, v, mask, do)):
        _scaled_close(a, b, 2e-2, name)
    assert bool(torch.isfinite(o).all())


@pytest.mark.parametrize("dh", [16, 64])
def test_attention_bf16_backward_at_its_cap(cuda, dh):
    """The bf16 backward at T = MAX_T_BWD (the passes path's per-query
    statistics fill the most shared memory) against its plain version."""
    from speech_separation_tpu_torch.ops.attention_kernel import (
        MAX_T_BWD, chunk_attention_bwd, chunk_attention_bwd_plain)
    q, k, v, mask, do = _attn_edge_args(cuda, 1, MAX_T_BWD, dh, dh)
    grads = chunk_attention_bwd(q, k, v, mask, do)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), grads,
                          chunk_attention_bwd_plain(q, k, v, mask, do)):
        _scaled_close(a, b, 2e-2, name)


@pytest.mark.parametrize("N,T", [(37, 100), (12, 83), (5, 300)])
def test_attention_bf16_kernels_are_deterministic(cuda, N, T):
    """A second launch on the same inputs gives bit-identical outputs: every
    sum has one owner and a fixed order, and there are no atomics."""
    from speech_separation_tpu_torch.ops.attention_kernel import (chunk_attention_bwd,
                                                                  chunk_attention_fwd)
    q, k, v, mask, do = _attn_edge_args(cuda, N, T, 16, N + T)
    first = (chunk_attention_fwd(q, k, v, mask), *chunk_attention_bwd(q, k, v, mask, do))
    again = (chunk_attention_fwd(q, k, v, mask), *chunk_attention_bwd(q, k, v, mask, do))
    torch.cuda.synchronize()
    for name, a, b in zip(("o", "dq", "dk", "dv"), first, again):
        assert torch.equal(a, b), name


def test_attention_plan_is_the_cards_plan(cuda):
    """attention_plan, a pure function tested on the CPU, is the launch the
    built library makes (sep_attn_plan)."""
    from speech_separation_tpu_torch.ops.attention_kernel import (DH_SUPPORTED, attention_plan,
                                                                  card_plan)
    for N in (1, 3, 400, 10624, 12800):
        for T in (1, 17, 83, 100, 129, 256, 257, 1230, 8192):
            for dh in DH_SUPPORTED:
                for backward in (False, True):
                    assert card_plan(N, T, dh, backward) == attention_plan(
                        N, T, dh, torch.bfloat16, backward), (N, T, dh, backward)


def test_attention_bf16_backward_refuses_above_its_cap(cuda):
    from speech_separation_tpu_torch.ops.attention_kernel import MAX_T_BWD, chunk_attention_bwd
    big = torch.zeros((1, MAX_T_BWD + 1, 16), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=str(MAX_T_BWD)):
        chunk_attention_bwd(big, big, big, torch.ones((1, MAX_T_BWD + 1), device=cuda), big)


# ------------------------------------------- the launch's device (K2, K5, K1)

def _on_device(dev):
    """K2, K5 (bf16 and f32, forward and backward) and K1 on ``dev``, at
    shapes whose launches opt in to more than 48 KB of shared memory
    (STFT n_fft=8192: 67600 bytes; bf16 attention backward at T=1230:
    58112; the f32 attention backward at T=4096: over 49152)."""
    from speech_separation_tpu_torch.ops.attention_kernel import (chunk_attention_bwd,
                                                                  chunk_attention_fwd)
    g = torch.Generator(device=dev).manual_seed(7)
    out = {"stft": stft(torch.randn((4, 32768), generator=g, device=dev), 8192, 2048, 13)}
    for dtype, N, T in ((torch.bfloat16, 8, 1230), (torch.float32, 2, 4096)):
        q, k, v, do = (torch.randn((N, T, 16), generator=g, device=dev).to(dtype)
                       for _ in range(4))
        mask = torch.ones((N, T), device=dev)
        out[f"attn_fwd_{dtype}"] = chunk_attention_fwd(q, k, v, mask)
        out[f"attn_bwd_{dtype}"] = chunk_attention_bwd(q, k, v, mask, do)
    xw = torch.randn((9, 2, 5, 96), generator=g, device=dev)
    w = 0.3 * torch.randn((2, 24, 96), generator=g, device=dev)
    h0, c0 = (torch.randn((2, 5, 24), generator=g, device=dev) for _ in range(2))
    out["lstm"] = lstm_seq_infer(xw, w, h0, c0, torch.full((5,), 9, dtype=torch.int32,
                                                           device=dev))
    torch.cuda.synchronize(dev)
    return out


def _same_outputs(a, b):
    for name in a:
        for x, y in zip(*(t if isinstance(t, tuple) else (t,) for t in (a[name], b[name]))):
            assert torch.equal(x.cpu(), y.cpu()), name


def test_kernels_launch_on_the_tensors_card_not_the_current_one(cuda):
    """With cuda:0 current, K2, K5 and K1 on cuda:1 tensors launch there
    (each launch under its tensor's device, the shared-memory opt-in made
    for that device too) and give cuda:0's outputs."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    torch.cuda.set_device(0)
    first = _on_device(torch.device("cuda", 1))     # cuda:1's opt-ins before cuda:0's
    ref = _on_device(torch.device("cuda", 0))
    again = _on_device(torch.device("cuda", 1))
    assert torch.cuda.current_device() == 0
    _same_outputs(first, ref)
    _same_outputs(again, ref)


def test_kernels_give_one_result_under_any_current_device_context(cuda):
    """On one card: the launches made from a new thread (whose current
    device is the default) and inside a device context give the outputs of
    a plain call, bit for bit."""
    import threading
    ref = _on_device(torch.device("cuda", 0))
    got = {}

    def in_thread():
        with torch.cuda.device(0):
            got["ctx"] = _on_device(torch.device("cuda", 0))
        got["bare"] = _on_device(torch.device("cuda", 0))
    t = threading.Thread(target=in_thread)
    t.start()
    t.join()
    _same_outputs(got["ctx"], ref)
    _same_outputs(got["bare"], ref)


# ---------------------------------------------- ops/mxu.py's tensor-core products
#
# Each product of the training step's bf16-rounded operands, at the main
# shapes (uPIT: the two BLSTM projections over 38,400 rows, the 1,200 x 514
# head, dW_hh over 38,400 rows; DPRNN: the BLSTM projection over 259,200
# rows, the 256 -> 64 linear layer, dW_hh over 259,200 rows), forward and
# every gradient (a forward result rounded to bf16 is the float32 product,
# the rest run on the tensor cores), held with today's float32 product of
# the same rounded operands to the exact sum (a float64 product). A float32
# result: within 1e-5 relative L2 of it. A result rounded to bf16: each element within one
# and a half bf16 steps of the exact sum (its rounding and one more step)
# plus 2**-15 of the sum of its terms' magnitudes (more than the worst case
# of a float32 sum in pieces of at most 1,200 terms whose tensor-core
# accumulation truncates; where a sum cancels, the last is what is left),
# and off the exact sum's rounding on at most 0.1% of the elements more
# than today's product (itself off it on up to 0.4% of a 259,200-term sum's
# elements, H100). Both settings of allow_bf16_reduced_precision_reduction
# give the same bits and are left as they were; the counters count each
# product by case.

def _held_to_exact(name, got, old, exact, terms, rounded):
    if not rounded:
        err = float((got.double() - exact).norm() / exact.norm())
        assert err <= 1e-5, (name, err)
        return
    slack = (got.double() - exact).abs() - 1.5 * 2.0 ** -7 * exact.abs() - 2.0 ** -15 * terms
    assert float(slack.max()) <= 0, (name, float(slack.max()))
    want = exact.to(torch.bfloat16).float()
    new_share, old_share = (float((t.float() != want).float().mean()) for t in (got, old))
    assert new_share <= old_share + 1e-3, (name, new_share, old_share)


def _mxu_case(case, dev):
    """(new, old, exact) callables' leaves for one product: returns
    (leaves, cotangent, new, old, exact outputs and gradients, rounded
    flags, the counts (tensor_core, f32) of one forward and backward)."""
    from speech_separation_tpu_torch.models import layers
    from speech_separation_tpu_torch.ops import mxu
    g = torch.Generator(device=dev).manual_seed(len(case))

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (scale * torch.randn(shape, generator=g, device=dev)).to(dtype)
    bf = torch.bfloat16
    if case in ("upit.proj1", "upit.proj2", "dprnn.proj"):
        D, B, T, K, N = {"upit.proj1": (2, 100, 384, 257, 2400),
                         "upit.proj2": (2, 100, 384, 1200, 2400),
                         "dprnn.proj": (2, 2592, 100, 64, 512)}[case]
        leaves = [rnd(D, B, T, K, scale=0.5, dtype=bf), rnd(D, 1, K, N, scale=0.04, dtype=bf)]
        new = lambda x, w: mxu.held_dot(x, w, bf, bf)
        old = lambda x, w: torch.matmul(x.float(), w.float()).to(bf)

        def exact(x, w, gy):
            xd, wd, gd = x.double(), w.double(), gy.double()
            return (xd @ wd, gd @ wd.transpose(-1, -2),
                    torch.einsum("dbtk,dbtn->dkn", xd, gd)[:, None])
        return leaves, rnd(D, B, T, N, scale=1e-3, dtype=bf), new, old, exact, \
            (True, True, True), (2, 1)
    if case == "upit.head":
        leaves = [rnd(100, 384, 1200), rnd(514, 1200, scale=0.03)]
        new = lambda y, w: mxu.rounded_dot(y, w.t(), bf)
        old = lambda y, w: torch.matmul(y.to(bf).float(), w.t().to(bf).float())

        def exact(y, w, gy):
            yd, wd, gd = y.to(bf).double(), w.to(bf).double(), gy.double()
            return yd @ wd.t(), gd @ wd, torch.einsum("btk,btn->nk", yd, gd)
        return leaves, rnd(100, 384, 514, scale=1e-3), new, old, exact, \
            (False, True, True), (1, 2)
    if case == "dprnn.linear":
        leaves = [rnd(2592, 100, 256, dtype=bf), rnd(256, 64, scale=0.06), rnd(64, scale=0.06)]
        new = lambda x, w, b: layers.dot(x, {"w": w, "b": b}, bf, bf)
        old = lambda x, w, b: (torch.matmul(x.float(), w.to(bf).float()) + b).to(bf)

        def exact(x, w, b, gy):
            xd, wd, gd = x.double(), w.to(bf).double(), gy.double()
            return (xd @ wd + b.double(), gd @ wd.t(), torch.einsum("rtk,rtn->kn", xd, gd),
                    gd.sum((0, 1)))
        return leaves, rnd(2592, 100, 64, scale=1e-3, dtype=bf), new, old, exact, \
            (True, True, True, False), (2, 1)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["upit.proj1", "upit.proj2", "upit.head", "dprnn.proj",
                                  "dprnn.linear"])
def test_mxu_products_on_the_tensor_cores(cuda, case):
    from speech_separation_tpu_torch.ops import mxu
    leaves, gy, new, old, exact, rounded, counts = _mxu_case(case, cuda)

    def run(fn):
        ls = [t.detach().clone().requires_grad_(True) for t in leaves]
        y = fn(*ls)
        y.backward(gy)
        return [y.detach()] + [t.grad for t in ls]
    saved = torch._C._get_cublas_allow_bf16_reduced_precision_reduction()
    try:
        results = []
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
            set_to = torch._C._get_cublas_allow_bf16_reduced_precision_reduction()
            before = (mxu.mxu_dot.tensor_core, mxu.mxu_dot.f32)
            results.append(run(new))
            torch.cuda.synchronize()
            assert (mxu.mxu_dot.tensor_core - before[0], mxu.mxu_dot.f32 - before[1]) == counts
            assert torch._C._get_cublas_allow_bf16_reduced_precision_reduction() == set_to
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = saved
    for a, b in zip(*results):
        assert torch.equal(a, b), case
    ref = run(old)
    want = exact(*[t.detach() for t in leaves], gy)
    terms = exact(*[t.detach().abs() for t in leaves], gy.abs())
    for name, got, o, e, m, r in zip(("out", "dx", "dw", "db"), results[0], ref, want, terms,
                                     rounded):
        _held_to_exact(f"{case} {name}", got, o, e.reshape(got.shape), m.reshape(got.shape), r)


@pytest.mark.parametrize("T,B,H", [(384, 100, 600), (100, 2592, 128)])
def test_mxu_dw_hh_on_the_tensor_cores(cuda, T, B, H):
    """dW_hh over T*B rows (uPIT 38,400; DPRNN 259,200) against today's
    float32 einsum, both held to the float64 sum: one tensor-core product."""
    from speech_separation_tpu_torch.ops import lstm_kernel, mxu
    g = torch.Generator(device=cuda).manual_seed(T)
    bf = torch.bfloat16
    ys = (0.5 * torch.randn((T, 2, B, H), generator=g, device=cuda)).to(bf)
    dxw = (1e-3 * torch.randn((T, 2, B, 4 * H), generator=g, device=cuda)).to(bf)
    h0 = torch.randn((2, B, H), generator=g, device=cuda)
    lengths = torch.randint(1, T + 1, (B,), generator=g, device=cuda).int()
    before = mxu.mxu_dot.tensor_core
    got = lstm_kernel._dw_hh(ys, h0, lengths, SFX, dxw, bf)
    assert mxu.mxu_dot.tensor_core == before + 1 and got.dtype == bf
    h_prev = lstm_kernel._h_prev(ys, h0, lengths, SFX)
    old = torch.einsum("tdbh,tdbg->dhg", h_prev.float(), dxw.float()).to(bf)
    exact = torch.einsum("tdbh,tdbg->dhg", h_prev.double(), dxw.double())
    terms = torch.einsum("tdbh,tdbg->dhg", h_prev.double().abs(), dxw.double().abs())
    _held_to_exact(f"dw_hh {T}x{B}", got, old, exact, terms, True)
