"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and skip without one. They import no JAX, so on
a machine with a card they run without the JAX package's test setup:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f32 atol 1e-5 (same math, other summation order); bf16 atol
2e-2 (one bf16 step of a rounded h_{t-1}); STFT atol 5e-5 of the largest
|X| (an f32 sum of n_fft products). Gradients are compared divided by
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
