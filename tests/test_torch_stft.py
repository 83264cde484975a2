"""The port's STFT/iSTFT (speech_separation_tpu_torch/dsp/stft.py and the
plain version of the STFT kernel) against the JAX package, on the CPU.

Tolerances: the same f32 products summed in another order, on values of a
few units (|X| <= ~50 here): atol 1e-4 on spectra, 2e-5 on waveforms. The
numpy model of the kernel's FFT path (f32 table, complex64 stages) against
the plain product and the TPU kernel: 1e-5 of the largest |X|, the card's
tolerance (an f32 FFT and an f32 product each land within about 1e-6 of the
exact DFT relative to the largest bin).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speech_separation_tpu.dsp import stft as jstft
from speech_separation_tpu.ops.stft_pallas import stft_pallas
from speech_separation_tpu_torch.dsp import stft as tstft
from speech_separation_tpu_torch.ops.stft_kernel import (DIRECT_N_FFT_CAP, N_FFT_CAP, fft_table,
                                                         stft, stft_plain, stft_plan)

torch.set_num_threads(1)  # six xdist workers share the cores: one thread each, for life

SPEC_ATOL = 1e-4
WAVE_ATOL = 2e-5


def _padded_batch(lengths, n_fft=512, hop=128, seed=0):
    rng = np.random.default_rng(seed)
    sigs = [(0.3 * rng.standard_normal(n)).astype(np.float32) for n in lengths]
    n_t = jstft.num_frames(max(lengths), hop)
    xp = np.zeros((len(sigs), max(lengths) + n_fft), np.float32)
    for r, s in enumerate(sigs):
        p = jstft.reflect_pad_center(s, n_fft)
        xp[r, :len(p)] = p
    counts = np.asarray([jstft.num_frames(n, hop) for n in lengths], np.int32)
    return sigs, xp, counts, n_t


def test_helpers_match():
    for n_fft in (256, 512):
        np.testing.assert_array_equal(tstft.hann_periodic(n_fft),
                                      jstft.hann_periodic(n_fft))
        np.testing.assert_array_equal(tstft._windowed_rdft_matrix(n_fft),
                                      jstft._windowed_rdft_matrix(n_fft))
        np.testing.assert_array_equal(tstft._windowed_irdft_matrix(n_fft),
                                      jstft._windowed_irdft_matrix(n_fft))
    assert tstft.num_frames(3000, 128) == jstft.num_frames(3000, 128)
    assert tstft.istft_output_length(24, 128) == jstft.istft_output_length(24, 128)


def test_stft_centered_batch_matches_jax():
    _, xp, _, n_t = _padded_batch((2900, 1500, 700))
    re_j, im_j = jstft.stft_centered_batch(jnp.asarray(xp), n_fft=512, hop=128, n_t=n_t)
    re_t, im_t = tstft.stft_centered_batch(torch.from_numpy(xp), 512, 128, n_t)
    np.testing.assert_allclose(re_t.numpy(), np.asarray(re_j), atol=SPEC_ATOL)
    np.testing.assert_allclose(im_t.numpy(), np.asarray(im_j), atol=SPEC_ATOL)
    mag_j = jstft.stft_magnitude_batch(jnp.asarray(xp), n_fft=512, hop=128, n_t=n_t)
    mag_t = tstft.stft_magnitude_batch(torch.from_numpy(xp), 512, 128, n_t)
    np.testing.assert_allclose(mag_t.numpy(), np.asarray(mag_j), atol=SPEC_ATOL)


@pytest.mark.parametrize("magnitude", [False, True])
def test_stft_plain_matches_pallas_interpret(magnitude):
    """The kernel's plain version against the TPU kernel run in interpret
    mode, both modes, on ragged rows."""
    _, xp, _, n_t = _padded_batch((2000, 1100, 300), seed=1)
    ref = stft_pallas(jnp.asarray(xp), n_fft=512, hop=128, n_t=n_t,
                      magnitude=magnitude, interpret=True)
    got = stft(torch.from_numpy(xp), 512, 128, n_t, magnitude=magnitude)
    if magnitude:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=SPEC_ATOL)
    else:
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=SPEC_ATOL)


def test_stft_rejects_hop_not_dividing_n_fft():
    xp = torch.zeros((1, 1000))
    with pytest.raises(ValueError, match="divide"):
        stft_plain(xp, 512, 120, 3)


@pytest.mark.parametrize("hop", [128, 96])
def test_istft_batch_matches_jax_ragged(hop):
    """Ragged frame counts, garbage frames past each row's count, and the
    scatter overlap-add for a hop that does not divide n_fft."""
    rng = np.random.default_rng(2)
    B, T, F = 3, 20, 257
    re = rng.standard_normal((B, T, F)).astype(np.float32)
    im = rng.standard_normal((B, T, F)).astype(np.float32)
    counts = np.asarray([20, 13, 1], np.int32)
    ref = jstft.istft_batch(jnp.asarray(re), jnp.asarray(im), jnp.asarray(counts), hop=hop)
    got = tstft.istft_batch(torch.from_numpy(re), torch.from_numpy(im),
                            torch.from_numpy(counts), hop=hop)
    assert got.shape == ref.shape
    got, ref = got.numpy(), np.asarray(ref)
    # the kept region of each row (the center trim drops n_fft//2 per side)
    for r, n in enumerate(counts):
        L = tstft.istft_output_length(int(n), hop)
        np.testing.assert_allclose(got[r, 256: 256 + L], ref[r, 256: 256 + L],
                                   atol=WAVE_ATOL)
    # near the row ends the window sum is ~1e-4, so 1/wss amplifies the
    # order of the f32 sums: there the tolerance is relative
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=WAVE_ATOL)


def test_stft_istft_round_trip_matches_numpy_reference():
    sigs, xp, counts, n_t = _padded_batch((2500, 1300), seed=3)
    re, im = tstft.stft_centered_batch(torch.from_numpy(xp), 512, 128, n_t)
    y = tstft.istft_batch(re, im, torch.from_numpy(counts), hop=128).numpy()
    for r, s in enumerate(sigs):
        L = tstft.istft_output_length(int(counts[r]), 128)
        ref = jstft.istft_np(jstft.stft_np(s), hop=128)
        np.testing.assert_allclose(y[r, 256: 256 + L], ref, atol=WAVE_ATOL)


# ---- the kernel's FFT path (csrc/stft.cu) modelled in numpy ----

def _radices(M):
    """The Stockham radix order of the kernel: radix 16 while 16 divides
    what is left, then one 8, 4 or 2 (M = 256: 16, 16)."""
    lm = M.bit_length() - 1
    return [16] * (lm // 4) + {0: [], 1: [2], 2: [4], 3: [8]}[lm % 4]


def _fft_model(xp, n_fft, hop, n_t, magnitude):
    """What the kernel computes on its FFT path, with its index arithmetic:
    frames windowed from the f32 table and packed as z[n] = x[2n] + i x[2n+1];
    Stockham stages where butterfly j reads points j + r M/R, twiddles point r
    by table entry 2 r (j mod Ns) M / (Ns R), and writes point s to
    (j - j mod Ns) R + j mod Ns + s Ns; then the real-split step, bins k and
    M - k from one pair, X[M/2] = conj Z[M/2]."""
    table = fft_table(n_fft)
    win, tw = table[:n_fft], table[n_fft:].view(np.complex64)
    M = n_fft // 2
    idx = np.arange(n_t)[:, None] * hop + np.arange(n_fft)[None, :]
    xw = xp[:, idx] * win                                   # (B, n_t, n_fft) f32
    z = (xw[..., 0::2] + 1j * xw[..., 1::2]).astype(np.complex64)
    Ns = 1
    for R in _radices(M):
        bpf = M // R
        j = np.arange(bpf)
        jm = j % Ns
        r = np.arange(R)[:, None]
        v = z[..., j[None, :] + r * bpf] * tw[r * jm[None, :] * (2 * M // (Ns * R))]
        dft = np.exp(-2j * np.pi * np.outer(np.arange(R), np.arange(R)) / R)
        out = np.einsum("sr,...rj->...sj", dft, v.astype(np.complex128)).astype(np.complex64)
        z = np.empty_like(z)
        z[..., (j - jm) * R + jm + r * Ns] = out
        Ns *= R
    k = np.arange(M // 2 + 1)
    a, c = z[..., k], np.conj(z[..., (M - k) % M])
    e, o = (a + c) / 2, (a - c) / 2j
    wo = tw[k] * o
    X = np.empty(z.shape[:-1] + (M + 1,), np.complex64)
    X[..., k] = e + wo
    X[..., M - k] = np.conj(e - wo)
    X[..., M // 2] = np.conj(z[..., M // 2])
    if magnitude:
        return np.abs(X).astype(np.float32)
    return X.real.astype(np.float32), X.imag.astype(np.float32)


def test_fft_radix_order():
    assert _radices(256) == [16, 16]
    assert _radices(16) == [16]
    assert _radices(4096) == [16, 16, 16]
    assert _radices(2048) == [16, 16, 8]
    assert _radices(1024) == [16, 16, 4]
    assert _radices(512) == [16, 16, 2]


@pytest.mark.parametrize("magnitude", [False, True])
def test_fft_model_matches_plain_and_pallas_interpret(magnitude):
    """The FFT path's algorithm against the kernel's plain version and the
    TPU kernel in interpret mode, at 1e-5 of the largest |X|."""
    _, xp, _, n_t = _padded_batch((2000, 1100, 300), seed=4)
    got = _fft_model(xp, 512, 128, n_t, magnitude)
    plain = stft_plain(torch.from_numpy(xp), 512, 128, n_t, magnitude)
    pallas = stft_pallas(jnp.asarray(xp), n_fft=512, hop=128, n_t=n_t,
                         magnitude=magnitude, interpret=True)
    got, plain, pallas = ((t,) if not isinstance(t, tuple) else t for t in (got, plain, pallas))
    scale = max(float(np.abs(np.asarray(r)).max()) for r in plain)
    for g, p, j in zip(got, plain, pallas):
        np.testing.assert_allclose(g, p.numpy(), rtol=0, atol=1e-5 * scale)
        np.testing.assert_allclose(g, np.asarray(j), rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("n_fft,hop", [(32, 8), (64, 16), (128, 64), (256, 64), (1024, 256),
                                       (2048, 512), (4096, 1024)])
def test_fft_model_matches_plain_at_every_radix_tail(n_fft, hop):
    """Every last radix (none, 2, 4, 8) at the sizes the FFT path takes."""
    rng = np.random.default_rng(n_fft)
    n_t = 7
    xp = rng.uniform(-1, 1, (2, (n_t - 1) * hop + n_fft + 3)).astype(np.float32)
    got = _fft_model(xp, n_fft, hop, n_t, False)
    ref = stft_plain(torch.from_numpy(xp), n_fft, hop, n_t)
    scale = max(float(r.abs().max()) for r in ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r.numpy(), rtol=0, atol=1e-5 * scale)


def test_fft_table_against_float64():
    for n_fft in (32, 512, N_FFT_CAP):
        t = fft_table(n_fft)
        assert t.dtype == np.float32 and t.shape == (3 * n_fft,)
        np.testing.assert_array_equal(t[:n_fft], tstft.hann_periodic(n_fft))
        ref = np.exp(-2j * np.pi * np.arange(n_fft) / n_fft)
        tw = t[n_fft:].astype(np.float64).reshape(-1, 2)
        # each entry is its float64 value rounded to f32
        np.testing.assert_array_equal(tw[:, 0], ref.real.astype(np.float32))
        np.testing.assert_array_equal(tw[:, 1], ref.imag.astype(np.float32))
        assert np.abs(tw[:, 0] + 1j * tw[:, 1] - ref).max() <= 2 ** -24 * np.sqrt(2)


def test_stft_plan_at_the_serving_and_training_shapes():
    serve = stft_plan(16, 65536 + 512, 513, 512, 128)
    # span (15*128 + 512 + 3 floats of head, to 16 bytes) + 16 frames x 256
    # points padded one in 16
    assert serve == {"path": "fft", "frames": 16, "warps": 8, "smem": 4 * 2436 + 8 * 4352,
                     "ctas": 16 * 33, "cap": N_FFT_CAP}
    train = stft_plan(300, 49536, 384, 512, 128, magnitude=True)
    assert train == dict(serve, ctas=300 * 24)


@pytest.mark.parametrize("n_t,tiles", [(1, 1), (15, 1), (16, 1), (17, 2), (513, 33)])
def test_stft_plan_tile_edges(n_t, tiles):
    plan = stft_plan(3, (n_t - 1) * 128 + 512, n_t, 512, 128)
    assert plan["frames"] == 16 and plan["ctas"] == 3 * tiles


def test_stft_plan_paths_and_cap():
    for n_fft, F, warps in ((32, 64, 2), (64, 64, 4), (128, 64, 8), (1024, 8, 8),
                            (N_FFT_CAP, 1, 8)):
        plan = stft_plan(2, 3 * n_fft, 2, n_fft, n_fft // 2)
        assert (plan["path"], plan["frames"], plan["warps"]) == ("fft", F, warps), n_fft
        assert plan["smem"] <= 227 * 1024
    # every other n_fft with hop | n_fft, powers of two above N_FFT_CAP too,
    # takes the direct path up to its own cap
    for n_fft, hop in ((384, 128), (320, 160), (16, 8), (8, 4), (6000, 1000),
                       (N_FFT_CAP + 2, 2), (2 * N_FFT_CAP, N_FFT_CAP),
                       (DIRECT_N_FFT_CAP, DIRECT_N_FFT_CAP // 2)):
        plan = stft_plan(5, 4 * n_fft, 3, n_fft, hop)
        assert (plan["path"], plan["cap"]) == ("direct", DIRECT_N_FFT_CAP), n_fft
        assert plan["ctas"] == -(-15 // 128) * -(-(n_fft // 2 + 1) // 32)
    assert -(-(DIRECT_N_FFT_CAP // 2 + 1) // 32) == 65535
    with pytest.raises(ValueError, match=f"n_fft <= {DIRECT_N_FFT_CAP}"):
        stft_plan(1, 4 * DIRECT_N_FFT_CAP, 1, DIRECT_N_FFT_CAP + 2, 2)
    with pytest.raises(ValueError, match=f"n_fft <= {DIRECT_N_FFT_CAP}"):
        stft_plan(1, 4 * DIRECT_N_FFT_CAP, 1, 2 * DIRECT_N_FFT_CAP, DIRECT_N_FFT_CAP)
    with pytest.raises(ValueError, match="CTAs"):
        stft_plan(2 ** 20, 2 ** 21, 2 ** 14, 2 ** 20, 2 ** 6)
    with pytest.raises(ValueError, match="divide"):
        stft_plan(1, 2048, 4, 512, 96)
    with pytest.raises(ValueError, match="cannot hold"):
        stft_plan(1, 1000, 5, 512, 128)
