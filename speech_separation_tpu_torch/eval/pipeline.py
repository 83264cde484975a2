"""Batched separation: waveforms in, separated waveforms out.

The counterpart of speech_separation_tpu/eval/pipeline.py. Per batch the
device runs, for a spectral arch (uPIT, RSH, TCN): STFT of the center-padded
rows (the hand-written STFT kernel on CUDA), magnitude, masks (uPIT and RSH:
BLSTM through the hand-written recurrence kernel, eval-mode BN, head,
sigmoid, RSH one pass a speaker, its count given per call; TCN: its dilated
conv stack), then the masked iSTFT with per-row frame masking; for a
time-domain arch (SepFormer, DPRNN, Conv-TasNet): the arch's ``separate`` on
the raw zero-padded samples (SepFormer's attention through the hand-written
attention kernel, DPRNN's BLSTMs through the recurrence kernel), each track
trimmed to its input's length. Live streams go through eval/streaming.py.
Audio is bucketed by padded length; the pipeline counts the buckets it has
run, (frame count or padded sample count, num_spk), which the server
reports.

This is the serving API. With a ``mesh`` (parallel/mesh.py) of more than
one entry it separates data-parallel, as the JAX package's pipeline does:
one model replica a mesh entry, every batch padded to ``batch_size``
(rounded up to a multiple of the mesh's size) and its rows split over the
replicas in order, the initial states drawn for the whole batch and split,
so each row's tracks are the single-device pipeline's (inference is
row-independent: eval-mode BN uses the running statistics). Replicas on
distinct devices run at once; replicas on one device in turn
(``mesh.run_replicas``).
"""

from __future__ import annotations

import itertools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..dsp.stft import (STFTConfig, istft_batch, istft_output_length,
                        num_frames, reflect_pad_center, stft_centered_batch)
from ..models.upit import initial_state
from ..parallel.mesh import replicate_module, run_replicas
from ..utils.device import disable_tf32
from .infer import load_model


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _best_source_perm(prev: np.ndarray, cur: np.ndarray,
                      margin: float = 1e-3) -> np.ndarray:
    """Permutation of ``cur``'s source rows best matching ``prev`` over a
    shared overlap region, by summed normalized correlation. (S, ov)
    arrays. (Near-)silent rows carry no evidence and are zeroed; the
    identity wins unless an alternative beats it by ``margin``, so a
    speaker pausing across a window boundary does not flip the tracks."""
    S = prev.shape[0]
    ov = prev.shape[1]
    na = np.linalg.norm(prev, axis=1)
    nb = np.linalg.norm(cur, axis=1)
    # silence threshold: RMS below ~1e-4 of full scale has no speaker evidence
    floor = 1e-4 * np.sqrt(ov)
    corr = (prev @ cur.T) / np.outer(na + 1e-12, nb + 1e-12)
    corr[na < floor, :] = 0.0
    corr[:, nb < floor] = 0.0
    scores = {p: sum(corr[i, p[i]] for i in range(S))
              for p in itertools.permutations(range(S))}
    identity = tuple(range(S))
    best = max(scores, key=lambda p: scores[p])
    if scores[best] <= scores[identity] + margin:
        best = identity
    return np.asarray(best)


class SeparationPipeline:
    """Batched waveform-to-waveforms separation with shape bucketing, on
    ``device`` (CUDA by default; it raises when no card is visible)."""

    def __init__(self, model_path: str, arch_name: str = "",
                 model_kwargs: dict | None = None,
                 stft_cfg: STFTConfig = STFTConfig(),
                 batch_size: int = 16, length_quantum: int = 16384,
                 num_spk: int | None = None, seed: int = 0, device=None, mesh=None):
        if mesh is not None and mesh.size < 2:
            mesh = None                      # one device: no replicas
        self.arch, self.cfg, self.model = load_model(
            model_path, arch_name, model_kwargs, device if mesh is None else mesh.devices[0])
        self.device = next(self.model.parameters()).device
        self.mesh = mesh
        if mesh is not None:
            n = mesh.size
            if batch_size % n:
                rounded = -(-batch_size // n) * n
                print(f"note: pipeline batch_size {batch_size} -> {rounded} "
                      f"(must divide over {n} data-parallel devices)")
                batch_size = rounded
            self.replicas = replicate_module(self.model, mesh)
        self.domain = self.arch.DOMAIN
        # every f32 product of the path in full f32
        disable_tf32()
        self.stft_cfg = stft_cfg
        self.batch_size = batch_size
        self.length_quantum = length_quantum
        self.num_spk = num_spk or self.cfg.num_spk
        # initial LSTM states (the reference's N(0, 1) draw per batch)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.buckets: set[tuple[int, int]] = set()

    @torch.inference_mode()
    def _separate_batch(self, xp: np.ndarray, counts: np.ndarray, n_t: int,
                        num_spk: int) -> np.ndarray:
        """(B, Lp) padded rows -> (B, S, n_fft + hop*(n_t-1)) untrimmed tracks
        (spectral), or (B, S, Lp) (time domain, n_t = Lp)."""
        self.buckets.add((n_t, num_spk))
        if self.mesh is None:
            return self._separate_rows(self.model, self.device, xp, counts, n_t, num_spk)
        per = xp.shape[0] // self.mesh.size
        state = None
        if self.arch.NAME in ("uPIT", "RSH"):
            # the whole batch's draw, as one device makes it, then split
            state = initial_state(self.cfg, xp.shape[0], self.generator, self.device)

        def replica(i):
            rows, dev = slice(i * per, (i + 1) * per), self.mesh.devices[i]
            st = None if state is None else tuple(s[:, :, rows].to(dev) for s in state)
            return self._separate_rows(self.replicas[i], dev, xp[rows], counts[rows], n_t,
                                       num_spk, st)
        return np.concatenate(run_replicas(self.mesh, replica))

    def _separate_rows(self, model, dev, xp, counts, n_t, num_spk, state=None):
        """_separate_batch's rows on one device, with ``model`` there; the
        initial states drawn here, or ``state`` (their rows of a batch's)."""
        xp_d = torch.from_numpy(xp).to(dev)
        counts_d = torch.from_numpy(counts).to(dev)
        if self.domain == "time":
            return self.arch.separate(model, xp_d, counts_d).cpu().numpy()
        scfg = self.stft_cfg
        F = scfg.num_bins
        B = xp.shape[0]
        re, im = stft_centered_batch(xp_d, scfg.n_fft, scfg.hop, n_t)
        tmask = (torch.arange(n_t, device=dev)[None, :]
                 < counts_d[:, None]).to(torch.float32)[:, :, None]
        mag = torch.sqrt(re * re + im * im) * tmask
        batch = {"mix": mag, "lengths": counts_d,
                 "row_mask": torch.ones((B,), dtype=torch.float32, device=dev)}
        given = {} if state is None else {"state": state}
        if self.arch.NAME == "RSH":
            masks = self.arch.infer_masks(model, batch, self.generator, num_spk, **given)
        else:
            flat = self.arch.infer_masks(model, batch, self.generator, **given)
            masks = flat.reshape(B, n_t, num_spk, F).permute(0, 2, 1, 3)
        # masked iSTFT over (B*S) rows
        re_s = (re[:, None] * masks).reshape(B * num_spk, n_t, F)
        im_s = (im[:, None] * masks).reshape(B * num_spk, n_t, F)
        y = istft_batch(re_s, im_s, counts_d.repeat_interleave(num_spk), hop=scfg.hop)
        return y.reshape(B, num_spk, -1).cpu().numpy()

    def separate_stream(self, loader, lengths, num_spk: int | None = None,
                        prefetch: int = 2, pad_batches: bool = False):
        """Streaming separation core: yields ``(index, [tracks])`` per input
        with bounded host memory — at most ``prefetch`` length-sorted batches
        of audio are resident, loaded by background threads while the device
        separates the current batch.

        ``loader(i)`` returns waveform i; ``lengths[i]`` is its (possibly
        approximate) sample count, used only to order and bucket.
        ``pad_batches=True`` zero-pads every batch to the full
        ``batch_size`` (pad rows have 1 frame of silence and are never
        yielded), so every request size runs the same batch shape — the
        serving mode. Rows are independent (eval-mode BN uses running
        statistics), so results do not depend on the padding."""
        scfg = self.stft_cfg
        S = num_spk or self.num_spk
        if self.arch.NAME != "RSH" and S != self.cfg.num_spk:
            # a fixed head emits exactly cfg.num_spk masks; only RSH's
            # iterative extraction takes a count per call
            raise ValueError(
                f"this {self.arch.NAME} model separates exactly {self.cfg.num_spk} "
                f"speakers (num_spk={S} requested); per-request speaker "
                "counts need an RSH model")
        # with a mesh every batch is padded to batch_size, as the JAX
        # package's pipeline pads it, so it divides over the replicas
        pad_batches = pad_batches or self.mesh is not None
        order = sorted(range(len(lengths)), key=lambda i: lengths[i])
        groups = [order[s: s + self.batch_size]
                  for s in range(0, len(order), self.batch_size)]

        def load_group(idxs):
            group = [np.asarray(loader(i), np.float32) for i in idxs]
            max_len = _round_up(max(len(s) for s in group), self.length_quantum)
            B = self.batch_size if pad_batches else len(group)
            if self.domain == "time":
                # raw zero-padded samples; the bucket key is the padded
                # sample count (pad rows: 1 sample of silence)
                xp = np.zeros((B, max_len), np.float32)
                counts = np.ones((B,), np.int32)
                for r, s in enumerate(group):
                    xp[r, : len(s)] = s
                    counts[r] = len(s)
                return xp, counts, max_len
            n_t = num_frames(max_len, scfg.hop)
            xp = np.zeros((B, max_len + scfg.n_fft), np.float32)
            counts = np.ones((B,), np.int32)  # pad rows: 1 frame of silence
            for r, s in enumerate(group):
                padded = reflect_pad_center(s, scfg.n_fft)
                xp[r, : len(padded)] = padded
                counts[r] = num_frames(len(s), scfg.hop)
            return xp, counts, n_t

        with ThreadPoolExecutor(max_workers=2) as pool:
            futs = [pool.submit(load_group, g) for g in groups[:prefetch]]
            for k, idxs in enumerate(groups):
                xp, counts, n_t = futs[k].result()
                futs[k] = None  # release the batch buffers after use
                if k + prefetch < len(groups):
                    futs.append(pool.submit(load_group, groups[k + prefetch]))
                y = self._separate_batch(xp, counts, n_t, S)
                if self.domain == "time":
                    for r, i in enumerate(idxs):
                        yield i, [y[r, s, : int(counts[r])] for s in range(S)]
                    continue
                half = scfg.n_fft // 2
                for r, i in enumerate(idxs):
                    L_out = istft_output_length(int(counts[r]), scfg.hop)
                    yield i, [y[r, s, half: half + L_out] for s in range(S)]

    def separate(self, signals: list[np.ndarray],
                 num_spk: int | None = None) -> list[list[np.ndarray]]:
        """Separate a list of waveforms. Returns, per input, num_spk
        estimated source waveforms: of length hop*(T_i - 1) from a spectral
        arch, of the input's length from a time-domain one."""
        out: list[list[np.ndarray]] = [None] * len(signals)
        for i, tracks in self.separate_stream(
                signals.__getitem__, [len(s) for s in signals], num_spk):
            out[i] = tracks
        return out

    def separate_long(self, signal: np.ndarray, num_spk: int | None = None,
                      window_sec: float = 8.0, overlap_sec: float = 1.0
                      ) -> list[np.ndarray]:
        """Long-form separation: window + batch + align + crossfade.

        The signal is cut into overlapping windows of one shape, all windows
        are separated in batches, and the per-window tracks are stitched:
        each window's source order is aligned to the previous window by
        normalized correlation over the shared overlap, and the overlap is
        linearly crossfaded (weights renormalized by the accumulated
        coverage). Window and overlap are rounded to hop multiples and the
        mix is zero-padded to a hop multiple, so the tracks cover the whole
        input; the pad samples are trimmed off."""
        sr = self.stft_cfg.sample_rate
        S = num_spk or self.num_spk
        x = np.asarray(signal, np.float32)
        stft_hop = self.stft_cfg.hop
        if not 0 < overlap_sec < window_sec:
            raise ValueError(f"need 0 < overlap ({overlap_sec}) < window "
                             f"({window_sec}) seconds")
        W = max(_round_up(int(window_sec * sr), stft_hop), 2 * stft_hop)
        V = min(max(_round_up(int(overlap_sec * sr), stft_hop), stft_hop),
                W - stft_hop)
        orig_len = len(x)
        x = np.pad(x, (0, -len(x) % stft_hop))
        if len(x) <= W:
            tracks = self.separate([x], S)[0]
            # hop-multiple input => full-length iSTFT output
            return [np.asarray(t, np.float32)[:orig_len] for t in tracks]
        hop = W - V
        starts = list(range(0, max(len(x) - V, 1), hop))
        outs = self.separate([x[s: s + W] for s in starts], S)

        acc = np.zeros((S, len(x)), np.float64)
        wacc = np.zeros(len(x), np.float64)
        prev_tail = None        # previous window's tracks over the overlap
        last = len(starts) - 1
        for k, (s0, tracks) in enumerate(zip(starts, outs)):
            t = np.stack(tracks)                       # (S, Lk), Lk <= W
            Lk = t.shape[1]
            if prev_tail is not None:
                ov = min(prev_tail.shape[1], Lk)
                if ov > 0:
                    t = t[_best_source_perm(prev_tail[:, :ov], t[:, :ov])]
            wgt = np.ones(Lk)
            if k > 0:
                r = min(V, Lk)
                wgt[:r] = np.arange(r) / r             # ramp up
            if k < last:
                r = min(V, Lk)
                wgt[Lk - r:] = np.minimum(wgt[Lk - r:],
                                          1.0 - np.arange(r) / r)  # ramp down
            acc[:, s0: s0 + Lk] += t * wgt
            wacc[s0: s0 + Lk] += wgt
            prev_tail = t[:, hop:] if Lk > hop else t[:, :0]
        return [(acc[s, :orig_len]
                 / np.maximum(wacc[:orig_len], 1e-12)).astype(np.float32)
                for s in range(S)]
