"""BSS-eval on the card: the host scorer's algorithm, batched over
utterances, in float64.

The counterpart of speech_separation_tpu/eval/bss_eval_jax.py, with another
design. The JAX module works in float32 (the TPU has no float64): a
shifted-copies matrix, two-float products, an f32 LU polished by two-float
refinement. On near-singular Grams that refinement can pass its trust gate
with a wrong joint projection (SIR and SAR off while SDR agrees). The H100
computes float64 natively, so this module runs eval/bss_eval.py's own
decomposition in ``torch.float64`` and is held to that host scorer:

- correlations by ``torch.fft.rfft``/``irfft`` over next_pow2(L + flen), as
  bss_eval.py's ``_correlations``;
- the block-Toeplitz Gram G[(i,a),(j,b)] = r_ij(a - b) of the delayed
  sources, gathered from the 2*flen - 1 lags of each r_ij by one index
  map (bss_eval_jax.py's ``_toeplitz_gram_2f`` map);
- the joint projection of every estimate from one LU of G a batch
  (``lu_factor_ex``, ``lu_solve``, the n estimates as right-hand sides),
  each target's projection from one LU of its diagonal flen x flen block;
- the projections by FFT filtering (bss_eval.py's ``_filter_sum``);
- the permutation by the mean-SIR argmax, on the host, in
  ``itertools.permutations`` order with the host's strict ``>``, so ties
  break as the host breaks them.

No shifted-copies matrix is built: it would hold n*flen*(L+flen-1) values an
utterance (328 MB in f64 for 2 sources of 5 s at 8 kHz). Utterances are
sorted by their length (the last non-zero sample of any of their signals)
and each sub-batch is cut to its own longest. That pays only where a set's
lengths straddle a power of two of L + flen (on a corpus of 4.5-6 s at 8
kHz every utterance transforms at 65536, so it saves nothing there); it
costs one argsort. Zero padding does not change any quantity (zeros add
nothing to a correlation), so ragged sets batch exactly up to the order of
the sums.

The trust gate. An utterance is rescored by the host f64 scorer when
``lu_factor_ex`` reports a zero pivot, when an output is not finite, or when
the first-order error that the solves' residuals put into a metric exceeds
``GATE_DB``. The gate's derivation: with r = G C - D the residual of a solve,
the projection's energy ||S C||^2 = C.D moves by 2 C.r to first order; the
interference energy ||P_all - s_target||^2 by 2 (C - C_t).r (C_t the target's
coefficients in the joint layout; the interference is orthogonal to the
target's span); the energies of e - s_target and e - P_all move only at
second order, by r.G^-1 r, which one more ``lu_solve`` of r gives. Each dB
metric 10 log10(N / M) then moves by 10/ln(10) * (dN/N + dM/M). ``GATE_DB``
is 1e-7 dB, a tenth of the 1e-6 dB within which the card is held to the host
(chip_smoke.py phase 23). The residuals are computed in f64, so their own
rounding (about nf * eps * |G| |C|) sets a floor far below the gate on any
system whose LU is sound.

The products, FFTs and solves are PyTorch library calls (cuBLAS, cuFFT,
cuSOLVER or MAGMA, as ``torch.backends.cuda.preferred_linalg_library``
picks): the JAX package computes them outside any Pallas kernel.
"""

from __future__ import annotations

import itertools
import math
import time

import numpy as np
import torch

from .bss_eval import FLEN, _next_pow2, bss_eval_sources

GATE_DB = 1e-7                    # the largest first-order metric error trusted
_DB = 10.0 / math.log(10.0)
_MAX_BATCH_CAP = 64


def bytes_per_utterance(n: int, L: int, flen: int = FLEN) -> int:
    """The scorer's working set for one utterance of n sources and L
    samples, in bytes: with n_fft = next_pow2(L + flen) and nf = n * flen,
    8 * (6 n^2 + 4 n) * n_fft (the signals, their spectra, the n^2
    correlation spectra and their inverse transforms, the target
    projections) + 24 * nf^2 (the Gram, its LU and the residual
    products)."""
    n_fft = _next_pow2(L + flen)
    return 8 * (6 * n * n + 4 * n) * n_fft + 24 * (n * flen) ** 2


def default_max_batch(n: int, L: int, flen: int = FLEN, device=None) -> int:
    """Utterances a sub-batch: a quarter of the card's free memory (1 GiB
    on the CPU) over ``bytes_per_utterance``, between 1 and 64."""
    dev = torch.device(device or "cpu")
    if dev.type == "cuda":
        free, _total = torch.cuda.mem_get_info(dev)
        budget = free // 4
    else:
        budget = 1 << 30
    return int(max(1, min(_MAX_BATCH_CAP, budget // bytes_per_utterance(n, L, flen))))


def _lag_index(n: int, flen: int, device) -> torch.Tensor:
    """Index of G[(i,a),(j,b)] = r_ij(a - b) into the (n, n, 2 flen - 1)
    lags, lag d stored at d + flen - 1."""
    i, a, j, b = np.meshgrid(np.arange(n), np.arange(flen), np.arange(n), np.arange(flen),
                             indexing="ij")
    idx = (i * n + j) * (2 * flen - 1) + (a - b + flen - 1)
    return torch.from_numpy(idx.reshape(-1)).to(device)


def _lu_factor(G: torch.Tensor):
    """``torch.linalg.lu_factor_ex``, on the CPU one matrix at a time:
    PyTorch's batched CPU LU (MKL) can hang once ``torch.set_num_threads``
    has changed the intra-op thread count, and one matrix alone does not."""
    if G.device.type != "cpu":
        return torch.linalg.lu_factor_ex(G)
    parts = zip(*(torch.linalg.lu_factor_ex(g) for g in G.reshape(-1, *G.shape[-2:])))
    return tuple(torch.stack(p).reshape(*G.shape[:-2], *p[0].shape) for p in parts)


def _solve(G: torch.Tensor, D: torch.Tensor):
    """X = G^-1 D by one LU, with the residual r = G X - D, the second-order
    term r.G^-1 r per right-hand side, and the LU's pivot report (info > 0:
    a zero pivot). G (..., m, m), D (..., m, k)."""
    LU, piv, info = _lu_factor(G)
    X = torch.linalg.lu_solve(LU, piv, D)
    r = G @ X - D
    second = (r * torch.linalg.lu_solve(LU, piv, r)).sum(-2).abs()     # (..., k)
    return X, r, second, info


def _score_chunk(refs: torch.Tensor, ests: torch.Tensor, flen: int):
    """refs, ests (B, n, L) float64 on one device. Returns the (B, k, j)
    SDR/SIR/SAR matrices (estimate k against source j), the first-order
    error estimate of each in dB and the (B,) zero-pivot flags."""
    B, n, L = refs.shape
    nf = n * flen
    n_fft = _next_pow2(L + flen)
    out_len = L + flen - 1
    SF = torch.fft.rfft(refs, n_fft)                                   # (B, n, K)
    EF = torch.fft.rfft(ests, n_fft)
    cSF = SF.conj()
    # r_ij(d) = sum_t s_i[t] s_j[t + d] at d mod n_fft; c_ik(a) likewise
    r_full = torch.fft.irfft(cSF[:, :, None] * SF[:, None], n_fft)    # (B, i, j, n_fft)
    c_full = torch.fft.irfft(cSF[:, :, None] * EF[:, None], n_fft)    # (B, i, k, n_fft)
    lags = torch.cat([r_full[..., n_fft - flen + 1:], r_full[..., :flen]], -1)
    del r_full
    G = lags.reshape(B, -1)[:, _lag_index(n, flen, refs.device)].reshape(B, nf, nf)
    Dk = c_full[..., :flen]                                            # (B, i, k, a)
    del c_full

    # joint projection of every estimate: G C = D, rows (i, a), columns k
    D = Dk.permute(0, 1, 3, 2).reshape(B, nf, n)
    C, r, second, info = _solve(G, D)
    # each target j alone: its diagonal block, the same estimates
    Gj = torch.stack([G[:, j * flen:(j + 1) * flen, j * flen:(j + 1) * flen]
                      for j in range(n)], 1)                           # (B, j, a, b)
    Dj = Dk.permute(0, 1, 3, 2)                                        # (B, j, a, k)
    Ct, rt, second_t, info_t = _solve(Gj, Dj)
    singular = (info != 0) | (info_t != 0).any(1)

    # P_all[k] = sum_i s_i * C[i, :, k]; s_target[k, j] = s_j * Ct[j, :, k]
    CF = torch.fft.rfft(C.reshape(B, n, flen, n).permute(0, 3, 1, 2), n_fft)    # (B, k, i, K)
    P = torch.fft.irfft((SF[:, None] * CF).sum(2), n_fft)[..., :out_len]       # (B, k, out)
    CtF = torch.fft.rfft(Ct.permute(0, 3, 1, 2), n_fft)                        # (B, k, j, K)
    st = torch.fft.irfft(SF[:, None] * CtF, n_fft)[..., :out_len]              # (B, k, j, out)
    e = torch.nn.functional.pad(ests, (0, flen - 1))                           # (B, k, out)
    e_interf = P[:, :, None] - st
    e_artif = (e - P)[:, :, None].expand_as(st)

    def energy(x):
        return (x * x).sum(-1)

    E_t = energy(st)
    E_i = energy(e_interf)
    E_ia = energy(e_interf + e_artif)
    E_a = energy(e_artif)
    E_ta = energy(st + e_interf)
    sdr = _DB * torch.log(E_t / E_ia)
    sir = _DB * torch.log(E_t / E_i)
    sar = _DB * torch.log(E_ta / E_a)

    # first-order energy errors from the residuals (the module docstring)
    dE_t = 2 * (Ct * rt).sum(2).abs().transpose(1, 2)                 # (B, k, j)
    dE_all = 2 * (C * r).sum(1).abs()[:, :, None]                     # (B, k, 1)
    Cb = C.reshape(B, n, flen, n)                                     # (B, i, a, k)
    Ct_in_joint = torch.zeros((B, n, n, flen, n), dtype=C.dtype, device=C.device)
    for j in range(n):
        Ct_in_joint[:, j, j] = Ct[:, j]
    diff = (Cb[:, None] - Ct_in_joint).reshape(B, n, nf, n)           # (B, j, (i,a), k)
    dE_i = 2 * (diff * r[:, None]).sum(2).abs().transpose(1, 2)       # (B, k, j)
    dE_ia = second_t.transpose(1, 2)                                  # (B, k, j)
    dE_a = second[:, :, None]
    # an exact zero (one source: the interference is nothing) moves by 0
    rel = lambda dE, E: torch.where(dE == 0, torch.zeros_like(dE), dE / E)
    err = torch.stack([_DB * (rel(dE_t, E_t) + rel(dE_ia, E_ia)),
                       _DB * (rel(dE_t, E_t) + rel(dE_i, E_i)),
                       _DB * (rel(dE_all, E_ta) + rel(dE_a, E_a))], -1).amax(-1)
    return sdr, sir, sar, err, singular


def _select(sdr_m, sir_m, sar_m, compute_permutation: bool):
    """The host scorer's choice on one utterance's (n, n) matrices."""
    n = sdr_m.shape[0]
    idx = np.arange(n)
    if not compute_permutation:
        return sdr_m[idx, idx], sir_m[idx, idx], sar_m[idx, idx], idx
    best_perm, best_mean = None, -np.inf
    for perm in itertools.permutations(range(n)):
        mean_sir = np.mean([sir_m[k, perm[k]] for k in range(n)])
        if mean_sir > best_mean:
            best_mean, best_perm = mean_sir, perm
    perm = np.asarray(best_perm)
    return sdr_m[idx, perm], sir_m[idx, perm], sar_m[idx, perm], perm


def _effective_length(x: np.ndarray) -> int:
    """One past the last column of (n, L) that is not all zero (0 if none)."""
    nz = np.flatnonzero(np.any(x != 0, axis=0))
    return int(nz[-1]) + 1 if nz.size else 0


def bss_eval_sources_batch(reference_sources, estimated_sources, compute_permutation=True,
                           flen: int = FLEN, max_batch: int | None = None, device=None,
                           stats: dict | None = None, mesh=None):
    """BSS-eval of a batch of utterances on ``device`` (CUDA by default),
    float64 throughout.

    Args:
      reference_sources, estimated_sources: (B, n, L) arrays (float or
        int16 PCM; every metric is invariant to a common scale), zero-padded
        to a common L (the padding does not change the metrics).
      compute_permutation: search the assignment of estimates to sources
        that maximises the mean SIR (mir_eval's rule); False scores the
        identity pairing.
      max_batch: utterances a sub-batch (default ``default_max_batch``).
      stats: a dict that, when given, gets ``fallbacks`` (utterances the
        trust gate sent to the host f64 scorer, each with its row and
        reason under ``reasons``) and ``gate_db_max`` (the largest
        first-order error estimate among the trusted ones) and
        ``fallback_s`` (the host seconds those rescorings took).

      mesh: a mesh (parallel/mesh.py) of more than one entry splits the
        utterances over its devices in order, each part scored there (the
        parts of distinct devices at once) and merged back in order, with no
        collectives: every quantity is per utterance. ``device`` then does
        not apply.

    Returns (sdr, sir, sar, perm) numpy arrays, each (B, n); perm[b, k] is
    the reference source assigned to estimate k.
    """
    if stats is not None:
        stats.setdefault("fallbacks", 0)
        stats.setdefault("reasons", [])
        stats.setdefault("gate_db_max", 0.0)
        stats.setdefault("fallback_s", 0.0)
    refs = np.asarray(reference_sources)
    ests = np.asarray(estimated_sources)
    if mesh is not None and mesh.size > 1:
        return _over_mesh(refs, ests, compute_permutation, flen, max_batch, stats, mesh)
    from ..utils.device import resolve_device
    dev = resolve_device(device)
    assert refs.shape == ests.shape and refs.ndim == 3, (refs.shape, ests.shape)
    B, n, L = refs.shape
    out = [np.zeros((B, n)) for _ in range(3)] + [np.zeros((B, n), np.int64)]
    if B == 0:
        return tuple(out)
    lengths = np.array([max(_effective_length(refs[b]), _effective_length(ests[b]), 1)
                        for b in range(B)])
    order = np.argsort(lengths, kind="stable")
    if max_batch is None:
        max_batch = default_max_batch(n, int(lengths.max()), flen, dev)
    for s in range(0, B, max_batch):
        rows = order[s:s + max_batch]
        Lc = int(lengths[rows].max())
        to_dev = lambda x: torch.from_numpy(
            np.ascontiguousarray(x[rows, :, :Lc])).to(dev).to(torch.float64)
        sdr, sir, sar, err, singular = _score_chunk(to_dev(refs), to_dev(ests), flen)
        sdr, sir, sar, err, singular = (t.cpu().numpy() for t in (sdr, sir, sar, err, singular))
        for m, b in enumerate(rows):
            # SIR is +inf where the interference is exactly nothing (one
            # source), as the host scorer gives it
            finite = (all(np.all(np.isfinite(x[m])) for x in (sdr, sar, err))
                      and not np.any(np.isnan(sir[m]) | (sir[m] == -np.inf)))
            gate = float(err[m].max()) if finite else np.inf
            reason = ("zero pivot" if singular[m] else "not finite" if not finite
                      else f"gate {gate:.2e} dB" if gate > GATE_DB else None)
            if reason is None:
                res = _select(sdr[m], sir[m], sar[m], compute_permutation)
                if stats is not None:
                    stats["gate_db_max"] = max(stats["gate_db_max"], gate)
            else:
                t0 = time.monotonic()
                length = int(lengths[b])
                res = bss_eval_sources(refs[b, :, :length].astype(np.float64),
                                       ests[b, :, :length].astype(np.float64),
                                       compute_permutation, flen)
                if stats is not None:
                    stats["fallback_s"] += time.monotonic() - t0
                    stats["fallbacks"] += 1
                    stats["reasons"].append((int(b), reason))
            for o, v in zip(out, res):
                o[b] = v
    return tuple(out)


def _over_mesh(refs, ests, compute_permutation, flen, max_batch, stats, mesh):
    """bss_eval_sources_batch with its utterances split over ``mesh``."""
    from ..parallel.mesh import run_replicas
    parts = np.array_split(np.arange(refs.shape[0]), mesh.size)
    part_stats = [{} for _ in parts]
    outs = run_replicas(mesh, lambda i: bss_eval_sources_batch(
        refs[parts[i]], ests[parts[i]], compute_permutation, flen, max_batch,
        device=mesh.devices[i], stats=part_stats[i]))
    if stats is not None:
        for rows, st in zip(parts, part_stats):
            stats["fallbacks"] += st["fallbacks"]
            stats["reasons"] += [(int(rows[b]), why) for b, why in st["reasons"]]
            stats["gate_db_max"] = max(stats["gate_db_max"], st["gate_db_max"])
            stats["fallback_s"] += st["fallback_s"]
    return tuple(np.concatenate(x) for x in zip(*outs))
