"""BSS-eval source-separation metrics: SDR / SIR / SAR (+ SI-SDR).

The port's own copy of speech_separation_tpu/eval/bss_eval.py, the host
float64 scorer (numpy and scipy.linalg.toeplitz only; it never imports
torch, so the scorer's worker processes never touch the card). It
implements the BSS-eval v3 "sources" variant (Vincent, Gribonval & Fevotte,
2006) that the reference obtains from mir_eval.separation.bss_eval_sources
(reference steps/evaluate_sources.py:57, steps/evaluate_oracle.py:118):

For each (estimate e, true source s_j) pair, the estimate is decomposed by
least-squares projection onto the subspace spanned by all true sources
delayed by 0..511 samples (512-tap distortion filters):

    s_target = P_{s_j, 0..511}(e)        projection onto the target's delays
    P_all    = P_{all sources}(e)
    e_interf = P_all - s_target
    e_artif  = e - P_all

    SDR = 10 log10 ||s_target||^2 / ||e_interf + e_artif||^2
    SIR = 10 log10 ||s_target||^2 / ||e_interf||^2
    SAR = 10 log10 ||s_target + e_interf||^2 / ||e_artif||^2

With ``compute_permutation=True`` all nsrc^2 pairs are evaluated and the
speaker permutation maximizing the mean SIR is chosen (mir_eval's rule);
``compute_permutation=False`` scores the identity pairing (the oracle path,
reference evaluate_oracle.py:118).

The Gram matrix of delayed sources is block-Toeplitz; correlations are
computed by FFT (host numpy — scoring is a host-side pipeline stage) and the
512*nsrc linear system solved densely.
"""

from __future__ import annotations

import itertools

import numpy as np
from scipy.linalg import toeplitz


FLEN = 512  # distortion-filter length used by BSS-eval v3 / mir_eval


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _correlations(sources: np.ndarray, est: np.ndarray, flen: int):
    """All source/source and source/estimate cross-correlations by FFT.

    sources: (n, L), est: (L,). Returns
      r[i, j, d] = sum_t sources[i, t] * sources[j, t + d],  d in (-flen, flen)
      c[i, a]    = sum_t sources[i, t] * est[t + a],         a in [0, flen)
    """
    n, L = sources.shape
    n_fft = _next_pow2(L + flen)
    SF = np.fft.rfft(sources, n_fft, axis=1)
    EF = np.fft.rfft(est, n_fft)

    # cross-correlation via conj(SF_i) * SF_j : index d >= 0 at [d], d < 0 at [n_fft+d]
    r_full = np.fft.irfft(np.conj(SF)[:, None, :] * SF[None, :, :], n_fft, axis=2)
    c_full = np.fft.irfft(np.conj(SF) * EF[None, :], n_fft, axis=1)
    return r_full, c_full


def _build_gram(r_full: np.ndarray, flen: int) -> np.ndarray:
    """Block-Toeplitz Gram matrix G[(i,a),(j,b)] = r_ij(a - b)."""
    n = r_full.shape[0]
    G = np.empty((n * flen, n * flen))
    for i in range(n):
        for j in range(n):
            # first column: r_ij(a), a = 0..flen-1 ; first row: r_ij(-b)
            col = r_full[i, j, :flen]
            row = np.concatenate([[r_full[i, j, 0]],
                                  r_full[i, j, -(flen - 1):][::-1]])
            G[i * flen:(i + 1) * flen, j * flen:(j + 1) * flen] = toeplitz(col, row)
    return G


def _filter_sum(sources: np.ndarray, coefs: np.ndarray, out_len: int) -> np.ndarray:
    """sum_i conv(sources[i], coefs[i])[:out_len] via FFT."""
    n, L = sources.shape
    flen = coefs.shape[1]
    n_fft = _next_pow2(L + flen)
    SF = np.fft.rfft(sources, n_fft, axis=1)
    CF = np.fft.rfft(coefs, n_fft, axis=1)
    y = np.fft.irfft((SF * CF).sum(axis=0), n_fft)
    return y[:out_len]


def _project(sources: np.ndarray, est: np.ndarray, flen: int) -> np.ndarray:
    """Least-squares projection of est onto span{sources delayed 0..flen-1}.

    sources: (n, L), est: (L,). Returns the projection, length L + flen - 1.
    """
    n, L = sources.shape
    out_len = L + flen - 1
    r_full, c_full = _correlations(sources, est, flen)
    G = _build_gram(r_full, flen)
    D = c_full[:, :flen].reshape(n * flen)
    try:
        C = np.linalg.solve(G, D)
    except np.linalg.LinAlgError:
        C = np.linalg.lstsq(G, D, rcond=None)[0]
    return _filter_sum(sources, C.reshape(n, flen), out_len)


def _decompose(sources: np.ndarray, est: np.ndarray, j: int, flen: int):
    """(s_target, e_interf, e_artif), each of length L + flen - 1."""
    L = sources.shape[1]
    out_len = L + flen - 1
    s_target = _project(sources[j:j + 1], est, flen)
    p_all = _project(sources, est, flen)
    e_interf = p_all - s_target
    e_full = np.zeros(out_len)
    e_full[:L] = est
    e_artif = e_full - p_all
    return s_target, e_interf, e_artif


def _ratio_db(num: np.ndarray, den: np.ndarray) -> float:
    return float(10.0 * np.log10(np.sum(num ** 2) / np.sum(den ** 2)))


def bss_eval_sources(reference_sources: np.ndarray,
                     estimated_sources: np.ndarray,
                     compute_permutation: bool = True,
                     flen: int = FLEN):
    """SDR/SIR/SAR for a set of estimates vs references.

    Args:
      reference_sources: (nsrc, L)
      estimated_sources: (nsrc, L)
      compute_permutation: search speaker assignment maximizing mean SIR
        (mir_eval's selection rule); False scores the identity pairing.

    Returns (sdr, sir, sar, perm) — each (nsrc,) float64; perm[k] is the
    index of the reference source assigned to estimate k.
    """
    refs = np.asarray(reference_sources, dtype=np.float64)
    ests = np.asarray(estimated_sources, dtype=np.float64)
    assert refs.shape == ests.shape and refs.ndim == 2
    nsrc = refs.shape[0]

    if compute_permutation:
        pairs = [(k, j) for k in range(nsrc) for j in range(nsrc)]
    else:
        pairs = [(k, k) for k in range(nsrc)]

    sdr_m = np.full((nsrc, nsrc), np.nan)
    sir_m = np.full((nsrc, nsrc), np.nan)
    sar_m = np.full((nsrc, nsrc), np.nan)
    for k, j in pairs:
        s_target, e_interf, e_artif = _decompose(refs, ests[k], j, flen)
        sdr_m[k, j] = _ratio_db(s_target, e_interf + e_artif)
        sir_m[k, j] = _ratio_db(s_target, e_interf)
        sar_m[k, j] = _ratio_db(s_target + e_interf, e_artif)

    if not compute_permutation:
        idx = np.arange(nsrc)
        return (sdr_m[idx, idx], sir_m[idx, idx], sar_m[idx, idx], idx)

    best_perm, best_mean = None, -np.inf
    for perm in itertools.permutations(range(nsrc)):
        mean_sir = np.mean([sir_m[k, perm[k]] for k in range(nsrc)])
        if mean_sir > best_mean:
            best_mean, best_perm = mean_sir, perm
    perm = np.asarray(best_perm)
    rows = np.arange(nsrc)
    return sdr_m[rows, perm], sir_m[rows, perm], sar_m[rows, perm], perm


# ---------------------------------------------------------------------------
# SI-SDR — the scale-invariant metric (Le Roux et al. 2019); not in the
# reference's scoring, but written beside it. Pure numpy.
# ---------------------------------------------------------------------------

def si_sdr(est: np.ndarray, ref: np.ndarray, zero_mean: bool = True) -> float:
    est = np.asarray(est, np.float64)
    ref = np.asarray(ref, np.float64)
    if zero_mean:
        est = est - est.mean()
        ref = ref - ref.mean()
    alpha = np.dot(est, ref) / np.dot(ref, ref)
    target = alpha * ref
    noise = est - target
    return float(10.0 * np.log10(np.sum(target ** 2) / np.sum(noise ** 2)))


def si_sdr_improvement(est: np.ndarray, ref: np.ndarray, mix: np.ndarray) -> float:
    """SI-SDRi: estimate SI-SDR minus the unprocessed mixture's SI-SDR."""
    n = min(len(est), len(ref), len(mix))
    return si_sdr(est[:n], ref[:n]) - si_sdr(mix[:n], ref[:n])
