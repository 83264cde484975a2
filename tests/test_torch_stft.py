"""The port's STFT/iSTFT (speech_separation_tpu_torch/dsp/stft.py and the
plain version of the STFT kernel) against the JAX package, on the CPU.

Tolerances: the same f32 products summed in another order, on values of a
few units (|X| <= ~50 here): atol 1e-4 on spectra, 2e-5 on waveforms.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speech_separation_tpu.dsp import stft as jstft
from speech_separation_tpu.ops.stft_pallas import stft_pallas
from speech_separation_tpu_torch.dsp import stft as tstft
from speech_separation_tpu_torch.ops.stft_kernel import stft, stft_plain

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
