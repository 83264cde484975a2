#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card and
check them.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the final line:
1. device report (nvidia-smi name and power limit, torch device name);
2. build every kernel of the paths from csrc/ with nvcc for sm_90a, one nvcc
   per source, all at once;
3. each kernel against its plain PyTorch version on the card, with the
   kernel's time, the plain version's time, one PyTorch library call's time
   (a yardstick the port never calls) and the least time the card could
   take (bound_ms): the serving kernels (LSTM inference, STFT) at the
   serving shapes (an 8 s bucket of 16 rows: T=513 frames, 2x600 BLSTM),
   the training kernels (LSTM training forward and backward) at the
   training shape (T=384, B=100, H=600), all also at a small ragged shape;
   the backward also launched twice on the same inputs (bit-identical
   outputs), with its time per step beside cuDNN's and its launch plan
   (CTAs, CTAs resident per SM, shared memory, rows of a ring group);
   the differentiable recurrence's gradients against autograd through the
   plain forward; and the attention kernel (forward and backward) at a small
   ragged shape, at SepFormer's training intra- and inter-chunk shapes
   (N=10624, T=100 and N=12800, T=83, dh=16) and at a long inter-chunk shape
   (T=1230, a 60 s request);
4. serve: a 2x600 bf16 uPIT with weights from a seed, saved as a reference
   .mdl, behind the port's SeparationServer on a Unix socket; one request,
   then two concurrent ones, then a ping; every output wav is checked, and
   one request's tracks are held against the same pipeline on the CPU
   (plain versions) by SNR. Kernel launch counts are zeroed just before
   the requests and read just after;
5. train: the port's train() on a synthetic npz corpus made from the seed
   (120 training and 40 CV utterances of 4.5-6 s, so every batch pads to
   T=384), 2x600 bf16 uPIT at B=100 with the reference's N(0, 1) initial
   state, 5 epochs (10 steps, CV at epoch 5); losses, files, launch counts
   (zeroed just before, read just after), each epoch's wall against its
   summed step time, and final.mdl separating a wav on the card;
6. one training step (loss and every gradient) on the card against the
   same step on the CPU (plain versions), same weights and initial state;
7. serve SepFormer: the full-width bf16 SepFormer with fused attention
   (random weights from the seed, saved by the port's checkpoint writer) in
   SeparationServer, three requests of 3-8 s as in phase 4; tracks checked,
   and held against the CPU plain path by SNR; attention launches counted;
8. train SepFormer: train() on a synthetic mix/s1/s2 wav corpus (64 training
   and 16 CV utterances of 4 s) at B=32 with --on-device-features, 5 epochs
   (10 steps, CV at epoch 5); losses, files, ms per step, launch counts;
9. one SepFormer training step on the card, fused attention against the
   einsum path at B=32 (loss and every gradient by relative L2), then the
   fused step on the card against the CPU at B=4;
10. one JSON line with every kernel and its numbers, then
   {"ok": true, "device": {...}} as the last line.

``python3 chip_smoke.py --profile`` traces full-width SepFormer training
steps with torch.profiler and prints where their time goes.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor / f32 CUDA cores
# Set from the card's own readings (NVIDIA H100 80GB HBM3, 700 W), with about
# ten times room: K1 bf16 1.4e-4, f32 6.3e-7; K2 2.5e-5 abs at |X| <= 23, i.e.
# 1.1e-6 relative; served tracks 72.4 dB against the CPU plain path.
TOL = {"lstm_bf16": 2e-3, "lstm_f32": 1e-5, "stft_rel": 1e-5}
MIN_SNR_DB = 50.0
# The training kernels (K3 forward, K4 backward) against their plain
# versions, and lstm_seq's gradients against autograd through the plain
# forward, as max |error| / max(1, max |reference|); the card-against-CPU
# training step by relative L2 error (loss, worst gradient). Set from the
# card's first readings (NVIDIA H100 80GB HBM3, 700 W) with about ten times
# room: K3 bf16 3.9e-3 (one bf16 step of a saved value), f32 2.4e-6; K4 bf16
# 1.9e-3, f32 1.4e-6; gradients bf16 6.4e-3, f32 6.7e-6; step loss 1.5e-7,
# gradients 3.7e-3.
TRAIN_TOL = {"fwd_bf16": 4e-2, "fwd_f32": 2e-5, "bwd_bf16": 2e-2, "bwd_f32": 1.5e-5,
             "grad_bf16": 6e-2, "grad_f32": 7e-5, "step_loss": 1.5e-6, "step_grad": 4e-2}
# The attention kernel (K5) against its plain versions, as max |error| /
# max(1, max |reference|), forward and backward; SepFormer's served tracks
# against the CPU by SNR; its training step fused against einsum and card
# against CPU by relative L2 error (loss, worst gradient). Set from the card's
# first readings (NVIDIA H100 80GB HBM3, 700 W) with about ten times room:
# K5 bf16 1.8e-3 forward, 2.5e-3 backward; f32 3.3e-7, 6.9e-7; served tracks
# 45.0 dB; fused against einsum loss 2.7e-5, gradients 3.1e-3; card against
# CPU loss 1.7e-4, gradients 5.6e-3.
ATTN_TOL = {"bf16": 3e-2, "f32": 1e-5}
SEPFORMER_TOL = {"min_snr_db": 35.0, "fused_loss": 3e-4, "fused_grad": 3e-2,
                 "cpu_loss": 2e-3, "cpu_grad": 6e-2}
# exp runs on the SFU: 16 results per SM and clock (4 per SM sub-partition),
# 132 SMs, at the 1.98 GHz boost clock (H100 SXM)
SFU_PER_S = 132 * 16 * 1.98e9


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of fn over iters calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class Failures(list):
    def check(self, ok: bool, what: str) -> None:
        print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
        if not ok:
            self.append(what)


# ------------------------------------------------------------------ kernels

def lstm_inputs(T, B, H, dtype, lengths, gen):
    dev = "cuda"
    G = 4 * H
    k = 1.0 / np.sqrt(H)
    xw = (0.5 * torch.randn((T, 2, B, G), generator=gen, device=dev)).to(dtype)
    w = ((torch.rand((2, H, G), generator=gen, device=dev) * 2 - 1) * k).to(dtype)
    h0 = torch.randn((2, B, H), generator=gen, device=dev)
    c0 = torch.randn((2, B, H), generator=gen, device=dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return xw, w, h0, c0, lens


def check_lstm(fails: Failures) -> dict:
    from speech_separation_tpu_torch.ops.lstm_kernel import (lstm_seq_infer,
                                                             lstm_seq_infer_plain)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sfx = (False, True)
    # small ragged: rows past one 16-row chunk, units past one 16-unit tile
    for dtype, tol in ((torch.bfloat16, TOL["lstm_bf16"]), (torch.float32, TOL["lstm_f32"])):
        args = lstm_inputs(9, 20, 40, dtype, [9, 1, 4, 9, 7] * 4, gen)
        got = lstm_seq_infer(*args, suffix_dirs=sfx)
        ref = lstm_seq_infer_plain(*args, suffix_dirs=sfx)
        torch.cuda.synchronize()
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        fails.check(err <= tol, f"lstm_infer small ragged {dtype}: max_abs_err {err:.3e} <= {tol}")

    T, B, H = 513, 16, 600
    rng = np.random.default_rng(SEED)
    lengths = [T, 1] + rng.integers(1, T + 1, size=B - 2).tolist()
    out = {}
    for dtype, tol in ((torch.bfloat16, TOL["lstm_bf16"]), (torch.float32, TOL["lstm_f32"])):
        xw, w, h0, c0, lens = args = lstm_inputs(T, B, H, dtype, lengths, gen)
        got = lstm_seq_infer(*args, suffix_dirs=sfx)
        ref = lstm_seq_infer_plain(*args, suffix_dirs=sfx)
        torch.cuda.synchronize()
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        fails.check(err <= tol, f"lstm_infer T={T} B={B} H={H} {dtype}: "
                                f"max_abs_err {err:.3e} <= {tol}")
        ms = cuda_ms(lambda: lstm_seq_infer(*args, suffix_dirs=sfx), iters=10)
        plain_ms = cuda_ms(lambda: lstm_seq_infer_plain(*args, suffix_dirs=sfx),
                           iters=2, warmup=0)
        # cuDNN's bidirectional LSTM over the 257-bin input at the same B, T:
        # a yardstick only (it also does the input projection)
        lstm = torch.nn.LSTM(257, H, bidirectional=True).to("cuda", dtype)
        lstm.flatten_parameters()
        x = torch.randn((T, B, 257), generator=gen, device="cuda").to(dtype)
        with torch.inference_mode():
            library_ms = cuda_ms(lambda: lstm(x), iters=10)
        valid_steps = 2 * sum(lengths)          # both directions
        flops = valid_steps * 2 * H * 4 * H
        io = nbytes(xw, w, h0, c0, lens, *got)
        b_ms, b_by = bound_ms(io, flops, dtype)
        out[dtype] = {"max_abs_err": err, "tolerance": tol, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}
        print(f"  lstm_infer {dtype}: {ms:.3f} ms (plain {plain_ms:.1f}, cuDNN "
              f"{library_ms:.3f}, bound {b_ms:.4f} by {b_by})", flush=True)
    return out


def check_stft(fails: Failures) -> dict:
    from speech_separation_tpu_torch.dsp.stft import _device_matrix
    from speech_separation_tpu_torch.ops.stft_kernel import stft, stft_plain
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    n_fft, hop = 512, 128

    def rel_err(got, ref):
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        scale = max(float(r.abs().max()) for r in ref)
        return max(float((g - r).abs().max()) for g, r in zip(got, ref)), scale

    xs = torch.rand((3, 1000 + n_fft + 37), generator=gen, device="cuda") * 2 - 1
    for magnitude in (False, True):
        err, scale = rel_err(stft(xs, n_fft, hop, 8, magnitude), stft_plain(xs, n_fft, hop, 8, magnitude))
        fails.check(err <= TOL["stft_rel"] * scale,
                    f"stft small ragged magnitude={magnitude}: max_abs_err {err:.3e} "
                    f"<= {TOL['stft_rel']} * {scale:.1f}")

    B, Lp = 16, 65536 + n_fft
    n_t = 1 + 65536 // hop
    xp = (torch.rand((B, Lp), generator=gen, device="cuda") * 2 - 1) * 0.5
    out = {}
    for magnitude in (False, True):
        got = stft(xp, n_fft, hop, n_t, magnitude)
        ref = stft_plain(xp, n_fft, hop, n_t, magnitude)
        err, scale = rel_err(got, ref)
        torch.cuda.synchronize()
        tol = TOL["stft_rel"] * scale
        fails.check(err <= tol, f"stft B={B} n_t={n_t} magnitude={magnitude}: "
                                f"max_abs_err {err:.3e} <= {tol:.3e}")
        ms = cuda_ms(lambda: stft(xp, n_fft, hop, n_t, magnitude), iters=20)
        plain_ms = cuda_ms(lambda: stft_plain(xp, n_fft, hop, n_t, magnitude), iters=20)
        A = _device_matrix("rdft", n_fft, xp.device)
        library_ms = cuda_ms(lambda: torch.matmul(xp.unfold(-1, n_fft, hop)[:, :n_t], A),
                             iters=20)
        flops = 2 * B * n_t * n_fft * A.shape[1]
        outs = got if isinstance(got, tuple) else (got,)
        b_ms, b_by = bound_ms(nbytes(xp, A, *outs), flops, torch.float32)
        out[magnitude] = {"max_abs_err": err, "tolerance": tol, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}
        print(f"  stft magnitude={magnitude}: {ms:.4f} ms (plain {plain_ms:.4f}, "
              f"unfold@A {library_ms:.4f}, bound {b_ms:.4f} by {b_by})", flush=True)
    return out


def scaled_err(got, ref) -> float:
    """max |got - ref| / max(1, max |ref|), over tensors of one output."""
    ref = ref.float()
    return float((got.float() - ref).abs().max()) / max(1.0, float(ref.abs().max()))


def rel_l2(got, ref) -> float:
    ref = ref.float().cpu()
    return float((got.float().cpu() - ref).norm() / ref.norm().clamp_min(1e-30))


def check_lstm_train(fails: Failures) -> dict:
    """K3 (training forward) and K4 (backward) against their plain versions,
    on the same saves and cotangents, at a small ragged shape and at the
    training shape; lstm_seq's gradients against autograd through the
    plain forward at the training shape."""
    from speech_separation_tpu_torch.ops.lstm_kernel import (
        lstm_bwd_plan, lstm_seq, lstm_seq_bwd, lstm_seq_bwd_plain, lstm_seq_fwd,
        lstm_seq_fwd_plain)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    sfx = (False, True)
    names_f = ("ys", "cs", "gates", "h_last", "c_last")
    names_b = ("dxw", "dh0", "dc0")

    def cotangents(cs, c0):
        return (torch.randn(cs.shape, generator=gen, device="cuda").to(cs.dtype),
                torch.randn(c0.shape, generator=gen, device="cuda"),
                torch.randn(c0.shape, generator=gen, device="cuda"))

    def compare(args, dtype, label):
        got = lstm_seq_fwd(*args, save_dtype=dtype, suffix_dirs=sfx)
        ref = lstm_seq_fwd_plain(*args, save_dtype=dtype, suffix_dirs=sfx)
        err_f = max(scaled_err(g, r) for g, r in zip(got, ref))
        _, w, _, c0, lens = args
        bargs = (w, c0, lens, ref[1], ref[2], *cotangents(ref[1], c0))
        got_b = lstm_seq_bwd(*bargs, save_dtype=dtype, suffix_dirs=sfx)
        ref_b = lstm_seq_bwd_plain(*bargs, save_dtype=dtype, suffix_dirs=sfx)
        torch.cuda.synchronize()
        err_b = max(scaled_err(g, r) for g, r in zip(got_b, ref_b))
        key = "bf16" if dtype == torch.bfloat16 else "f32"
        fails.check(err_f <= TRAIN_TOL["fwd_" + key],
                    f"lstm_fwd {label} {dtype} ({', '.join(names_f)}): "
                    f"max_abs_err {err_f:.3e} <= {TRAIN_TOL['fwd_' + key]}")
        fails.check(err_b <= TRAIN_TOL["bwd_" + key],
                    f"lstm_bwd {label} {dtype} ({', '.join(names_b)}): "
                    f"max_abs_err {err_b:.3e} <= {TRAIN_TOL['bwd_' + key]}")
        return err_f, err_b, got, bargs, got_b

    for dtype in (torch.bfloat16, torch.float32):
        compare(lstm_inputs(9, 20, 40, dtype, [9, 1, 4, 9, 7] * 4, gen), dtype,
                "small ragged")

    T, B, H = 384, 100, 600
    rng = np.random.default_rng(SEED + 2)
    lengths = [T, 1] + rng.integers(1, T + 1, size=B - 2).tolist()
    valid_steps = 2 * sum(lengths)                # both directions
    flops = valid_steps * 2 * H * 4 * H           # one (1, H) x (H, 4H) per step and row
    out = {"fwd": {}, "bwd": {}, "grad": {}}
    for dtype in (torch.bfloat16, torch.float32):
        args = lstm_inputs(T, B, H, dtype, lengths, gen)
        err_f, err_b, got, bargs, got_b = compare(args, dtype, f"T={T} B={B} H={H}")
        again = lstm_seq_bwd(*bargs, save_dtype=dtype, suffix_dirs=sfx)
        fails.check(all(torch.equal(a, b) for a, b in zip(got_b, again)),
                    f"lstm_bwd T={T} B={B} H={H} {dtype}: a second launch gives "
                    f"bit-identical {', '.join(names_b)}")
        del again
        plan = lstm_bwd_plan(2, B, H, dtype)
        ms_f = cuda_ms(lambda: lstm_seq_fwd(*args, save_dtype=dtype, suffix_dirs=sfx), 5)
        plain_f = cuda_ms(lambda: lstm_seq_fwd_plain(*args, save_dtype=dtype,
                                                     suffix_dirs=sfx), 1, warmup=0)
        ms_b = cuda_ms(lambda: lstm_seq_bwd(*bargs, save_dtype=dtype, suffix_dirs=sfx), 5)
        plain_b = cuda_ms(lambda: lstm_seq_bwd_plain(*bargs, save_dtype=dtype,
                                                     suffix_dirs=sfx), 1, warmup=0)
        # cuDNN's bidirectional LSTM over the layer-2 input (2H) at the same T
        # and B, in training: its forward against K3, its backward against K4
        # (yardsticks only: they also do the input projection and its
        # gradient)
        lstm = torch.nn.LSTM(2 * H, H, bidirectional=True).to("cuda", dtype)
        lstm.flatten_parameters()
        x = torch.randn((T, B, 2 * H), generator=gen, device="cuda").to(dtype)
        x.requires_grad_(True)
        lib_f = cuda_ms(lambda: lstm(x), 5)
        y, _ = lstm(x)
        gy = torch.randn(y.shape, generator=gen, device="cuda").to(dtype)
        lib_b = 0.0
        for i in range(6):
            y, _ = lstm(x)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            y.backward(gy)
            e1.record()
            e1.synchronize()
            lib_b += e0.elapsed_time(e1) if i else 0.0   # the first is a warm-up
        lib_b /= 5
        del lstm, x, y, gy
        b_f = bound_ms(nbytes(*args, *got), flops, dtype)
        b_b = bound_ms(nbytes(*bargs, *got_b), flops, dtype)
        out["fwd"][dtype] = {"max_abs_err": err_f, "ms": ms_f, "plain_ms": plain_f,
                             "bound_ms": b_f[0], "bound_by": b_f[1], "library_ms": lib_f}
        out["bwd"][dtype] = {"max_abs_err": err_b, "ms": ms_b, "plain_ms": plain_b,
                             "bound_ms": b_b[0], "bound_by": b_b[1], "library_ms": lib_b,
                             "us_per_step": 1e3 * ms_b / T,
                             "library_us_per_step": 1e3 * lib_b / T,
                             "ctas": plan["ctas"], "ctas_per_sm": plan["per_sm"],
                             "smem": plan["smem"], "group_rows": plan["rows"]}
        print(f"  lstm_fwd {dtype}: {ms_f:.3f} ms (plain {plain_f:.1f}, cuDNN fwd "
              f"{lib_f:.3f}, bound {b_f[0]:.4f} by {b_f[1]})", flush=True)
        print(f"  lstm_bwd {dtype}: {ms_b:.3f} ms (plain {plain_b:.1f}, cuDNN bwd "
              f"{lib_b:.3f}, bound {b_b[0]:.4f} by {b_b[1]}); per step "
              f"{1e3 * ms_b / T:.2f} us (cuDNN {1e3 * lib_b / T:.2f} us); {plan['ctas']} "
              f"CTAs, {plan['per_sm']} per SM resident ({plan['cap']} on "
              f"{plan['sms']} SMs), {plan['smem']} B shared, {plan['rows']}-row groups",
              flush=True)
        del got, bargs, got_b

        # the differentiable recurrence: K3 forward, K4 backward and dW_hh
        # outside, against autograd through the plain forward
        xw, w, h0, c0, lens = args
        cot = torch.randn((T, 2, B, H), generator=gen, device="cuda")

        def grads(fn):
            ts = [t.detach().clone().requires_grad_(True) for t in (xw, w, h0, c0)]
            ys, h_last, c_last = fn(ts)
            (torch.sum(ys.float() * cot) + torch.sum(torch.sin(h_last))
             + 0.1 * torch.sum(c_last ** 2)).backward()
            return [t.grad for t in ts]

        def plain(ts):
            ys, _, _, h_last, c_last = lstm_seq_fwd_plain(*ts, lens, dtype, sfx)
            return ys, h_last, c_last

        got_g = grads(lambda ts: lstm_seq(*ts, lens, dtype, sfx))
        ref_g = grads(plain)
        key = "grad_" + ("bf16" if dtype == torch.bfloat16 else "f32")
        errs = {n: scaled_err(g, r) for n, g, r in
                zip(("dxw", "dw_hh", "dh0", "dc0"), got_g, ref_g)}
        out["grad"][dtype] = errs
        fails.check(max(errs.values()) <= TRAIN_TOL[key],
                    f"lstm_seq gradients {dtype} vs autograd through the plain "
                    f"forward: {', '.join(f'{n} {e:.3e}' for n, e in errs.items())} "
                    f"<= {TRAIN_TOL[key]}")
        del args, got_g, ref_g
        torch.cuda.empty_cache()
    return out


def attention_inputs(N, T, dh, dtype, gen, lengths=None):
    """q, k, v, do (N, T, dh) and a key mask with the given valid counts
    (random in 1..T, and row 1 fully masked, when none are given)."""
    dev = "cuda"
    q, k, v, do = (torch.randn((N, T, dh), generator=gen, device=dev).to(dtype)
                   for _ in range(4))
    if lengths is None:
        lengths = torch.randint(1, T + 1, (N,), generator=gen, device=dev)
        lengths[1] = 0
    mask = (torch.arange(T, device=dev)[None, :] < lengths[:, None]).float()
    return q, k, v, mask, do


def attention_bound_ms(q, io_bytes: int, products: int) -> tuple[float, str]:
    """The larger of the bytes' time and the operations' time: ``products``
    (N, T, T, dh) products at the dtype's peak, or one exp per (query, key)
    at the SFU rate, whichever is longer."""
    N, T, dh = q.shape
    t_bytes = io_bytes / HBM_BYTES_PER_S
    t_ops = max(products * 2 * N * T * T * dh / PEAK_FLOPS[q.dtype], N * T * T / SFU_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def sdpa_ms(q, k, v, mask, do) -> tuple[float, float]:
    """F.scaled_dot_product_attention on the same rows (heads folded into
    the batch, the mask as an additive bias): forward ms, and the backward
    through autograd alone. A yardstick only: the port never calls it."""
    import torch.nn.functional as F
    bias = ((1.0 - mask) * -1e9).to(q.dtype)[:, None, None, :]
    q4, k4, v4, do4 = (t[:, None] for t in (q, k, v, do))
    with torch.no_grad():
        fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=bias), 10)
    leaves = [t.detach().requires_grad_(True) for t in (q4, k4, v4)]
    bwd = 0.0
    for i in range(6):
        out = F.scaled_dot_product_attention(*leaves, attn_mask=bias)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out.backward(do4)
        e1.record()
        e1.synchronize()
        bwd += e0.elapsed_time(e1) if i else 0.0      # the first is a warm-up
    return fwd, bwd / 5


def check_attention(fails: Failures) -> dict:
    """K5 forward and backward against their plain versions on the same
    inputs: at a small ragged shape (N odd, one fully-masked row), at
    SepFormer's training intra- and inter-chunk shapes and at a long
    inter-chunk shape (five key tiles), with times, bounds and SDPA's times."""
    from speech_separation_tpu_torch.ops.attention_kernel import (
        chunk_attention_bwd, chunk_attention_bwd_plain, chunk_attention_fwd,
        chunk_attention_fwd_plain)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)

    def compare(args, label):
        q, k, v, mask, do = args
        key = "bf16" if q.dtype == torch.bfloat16 else "f32"
        o = chunk_attention_fwd(q, k, v, mask)
        grads = chunk_attention_bwd(q, k, v, mask, do)
        err_f = scaled_err(o, chunk_attention_fwd_plain(q, k, v, mask))
        err_b = max(scaled_err(g, r) for g, r in
                    zip(grads, chunk_attention_bwd_plain(q, k, v, mask, do)))
        torch.cuda.synchronize()
        fails.check(err_f <= ATTN_TOL[key], f"chunk_attention_fwd {label} {q.dtype}: "
                                            f"max_abs_err {err_f:.3e} <= {ATTN_TOL[key]}")
        fails.check(err_b <= ATTN_TOL[key], f"chunk_attention_bwd {label} {q.dtype} (dq, dk, "
                                            f"dv): max_abs_err {err_b:.3e} <= {ATTN_TOL[key]}")
        return err_f, err_b, o, grads

    def measure(args, label):
        q, k, v, mask, do = args
        err_f, err_b, o, grads = compare(args, label)
        ms_f = cuda_ms(lambda: chunk_attention_fwd(q, k, v, mask), 20)
        ms_b = cuda_ms(lambda: chunk_attention_bwd(q, k, v, mask, do), 10)
        plain_f = cuda_ms(lambda: chunk_attention_fwd_plain(q, k, v, mask), 3)
        plain_b = cuda_ms(lambda: chunk_attention_bwd_plain(q, k, v, mask, do), 3)
        lib_f, lib_b = sdpa_ms(q, k, v, mask, do)
        b_f = attention_bound_ms(q, nbytes(q, k, v, mask, o), 2)
        # the backward recomputes QK^T, then dV, dW, dQ and dK: five products
        b_b = attention_bound_ms(q, nbytes(q, k, v, mask, do, *grads), 5)
        N, T, dh = q.shape
        print(f"  chunk_attention {label} {q.dtype}: fwd {ms_f:.4f} ms (plain {plain_f:.3f}, "
              f"SDPA {lib_f:.4f}, bound {b_f[0]:.4f} by {b_f[1]}); bwd {ms_b:.4f} ms (plain "
              f"{plain_b:.3f}, SDPA {lib_b:.4f}, bound {b_b[0]:.4f} by {b_b[1]})", flush=True)
        shape = {"N": N, "T": T, "dh": dh}
        return ({"max_abs_err": err_f, "ms": ms_f, "plain_ms": plain_f, "bound_ms": b_f[0],
                 "bound_by": b_f[1], "library_ms": lib_f, **shape},
                {"max_abs_err": err_b, "ms": ms_b, "plain_ms": plain_b, "bound_ms": b_b[0],
                 "bound_by": b_b[1], "library_ms": lib_b, **shape})

    for dtype in (torch.bfloat16, torch.float32):
        compare(attention_inputs(37, 20, 16, dtype, gen), "small ragged N=37 T=20")

    out = {"fwd": {}, "bwd": {}}
    # training, intra-chunk: B=32 4 s utterances (4000 valid of 4095 encoder
    # frames) -> 83 chunks of K=100 frames, 4 heads: N = 32 * 83 * 4; the
    # key masks of the model's chunks: full, but half of chunk 80 and none
    # of chunks 81 and 82
    N, T = 10624, 100
    lens = torch.full((N,), T, device="cuda")
    lens.view(32, 83, 4)[:, 80] = 50
    lens.view(32, 83, 4)[:, 81:] = 0
    for dtype in (torch.bfloat16, torch.float32):
        f, b = measure(attention_inputs(N, T, 16, dtype, gen, lens), "training intra N=10624 T=100")
        out["fwd"][dtype], out["bwd"][dtype] = f, b
        torch.cuda.empty_cache()
    # training, inter-chunk: N = 32 * 100 * 4 rows over the 83 chunks, of
    # which 81 hold frames
    f, b = measure(attention_inputs(12800, 83, 16, torch.bfloat16, gen,
                                    torch.full((12800,), 81, device="cuda")),
                   "training inter N=12800 T=83")
    out["fwd"]["inter"], out["bwd"]["inter"] = f, b
    # serving, inter-chunk: one 60 s request -> 1230 chunks; N = 100 * 4
    f, b = measure(attention_inputs(400, 1230, 16, torch.bfloat16, gen), "long inter T=1230")
    out["fwd"]["long"], out["bwd"]["long"] = f, b
    compare(attention_inputs(400, 1230, 16, torch.float32, gen), "long inter T=1230")
    torch.cuda.empty_cache()
    return out


# -------------------------------------------------------------------- serve

def mixture(n: int, rng) -> np.ndarray:
    """Two synthetic sources: a harmonic tone with vibrato, bursts of noise."""
    t = np.arange(n) / 8000.0
    f0 = 180 + 40 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / 8000.0
    s1 = sum(np.sin(k * phase) / k for k in range(1, 6))
    noise = np.convolve(rng.standard_normal(n), np.ones(4) / 4, mode="same")
    s2 = noise * (np.sin(2 * np.pi * 1.3 * t) > 0)
    mix = s1 + s2
    return (0.5 * mix / np.max(np.abs(mix))).astype(np.float32)


def snr_db(ref: np.ndarray, est: np.ndarray) -> float:
    return float(10 * np.log10(np.sum(ref ** 2) / max(np.sum((ref - est) ** 2), 1e-20)))


def serve_requests(fails: Failures, pipe, work: str, wavs: list, groups, counters,
                   want_len) -> tuple[dict, dict, float]:
    """Serve ``pipe`` through SeparationServer on a Unix socket (one 8 s
    bucket warmed up): request r1 with the wavs of ``groups[0]``, then r2
    and r3 with ``groups[1]`` and ``groups[2]`` at once, then a ping. Launch
    counts are zeroed just before the requests and read just after. Checks
    every reply and output wav (``want_len(n)`` samples for an n-sample
    input) and that the server stopped; returns (replies, launches, wall
    ms)."""
    from speech_separation_tpu_torch.eval.serve import SeparationServer, request
    from speech_separation_tpu_torch.utils.audio import load_wav

    sock_dir = tempfile.mkdtemp(prefix="sepsmoke")
    sock = os.path.join(sock_dir, "s.sock")
    server = SeparationServer(pipe, sock, coalesce=8)
    print(f"  warmup: {server.warmup([8.0])} bucket(s)", flush=True)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    replies = {}

    def send(name, idx):
        replies[name] = request(sock, {"wavs": [wavs[i] for i in idx],
                                       "out_dir": os.path.join(work, name)})

    try:
        deadline = time.monotonic() + 60
        while not os.path.exists(sock):
            if time.monotonic() > deadline:
                raise RuntimeError("server never bound its socket")
            time.sleep(0.02)
        for c in counters:
            c.launches = 0
        t0 = time.monotonic()
        send("r1", groups[0])
        pair = [threading.Thread(target=send, args=(f"r{k + 2}", groups[k + 1]))
                for k in range(2)]
        for th in pair:
            th.start()
        for th in pair:
            th.join(timeout=300)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
        launches = {c.__name__: c.launches for c in counters}
        ping = request(sock, {"cmd": "ping"})
    finally:
        server.shutdown()
        thread.join(timeout=30)
        shutil.rmtree(sock_dir, ignore_errors=True)
    fails.check(not thread.is_alive(), "server thread stopped")

    for name in ("r1", "r2", "r3"):
        rep = replies.get(name, {})
        fails.check(bool(rep.get("ok")), f"request {name} ok ({rep.get('ms')} ms)")
        for wav, paths in rep.get("outputs", {}).items():
            want = want_len(len(load_wav(wav)[0]))
            for p in paths:
                y, sr = (load_wav(p) if os.path.exists(p) else (np.zeros(0), 0))
                fails.check(sr == 8000 and len(y) == want and np.all(np.isfinite(y)),
                            f"{os.path.basename(p)}: {len(y)} samples, want {want}")
    fails.check(bool(ping.get("ok")) and ping.get("served") == 3,
                f"ping: served {ping.get('served')}, buckets {ping.get('compiled_buckets')}, "
                f"latency {ping.get('latency_ms')}")
    print(f"  requests: r1 {replies['r1'].get('ms')} ms, r2 {replies['r2'].get('ms')} ms, "
          f"r3 {replies['r3'].get('ms')} ms; wall {wall_ms:.1f} ms; launches {launches}",
          flush=True)
    return replies, launches, wall_ms


def serve_phase(fails: Failures, counters) -> dict:
    """Phase 4: a 2x600 bf16 uPIT served on the card."""
    from speech_separation_tpu_torch.dsp.stft import istft_output_length, num_frames
    from speech_separation_tpu_torch.eval.pipeline import SeparationPipeline
    from speech_separation_tpu_torch.models import upit
    from speech_separation_tpu_torch.utils.audio import (limit_peak, load_wav,
                                                         write_wav_int16)

    work = os.path.join(REPO, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg = upit.Config(feat_dim=257, num_spk=2, hidden=600, num_layers=2)
    model = upit.UPIT(cfg)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    mdl = os.path.join(work, "upit_2x600.mdl")
    torch.save(model.state_dict(), mdl)
    kw = {"compute_dtype": "bfloat16", "zero_init_hidden": "1"}

    rng = np.random.default_rng(SEED)
    wavs = []
    for k, sec in enumerate((3.0, 5.5, 8.0, 6.2)):
        path = os.path.join(work, f"mix{k}.wav")
        write_wav_int16(path, 8000, mixture(int(sec * 8000), rng))
        wavs.append(path)

    pipe = SeparationPipeline(mdl, model_kwargs=kw, batch_size=16, seed=SEED, device="cuda")
    replies, launches, wall_ms = serve_requests(
        fails, pipe, work, wavs, ([0], [1, 2], [3]), counters,
        lambda n: istft_output_length(num_frames(n, 128), 128))

    # the first request against the same pipeline on the CPU (plain versions)
    cpu = SeparationPipeline(mdl, model_kwargs=kw, batch_size=16, seed=SEED, device="cpu")
    x = load_wav(wavs[0])[0]
    ref = limit_peak(cpu.separate([x])[0])
    for s, path in enumerate(replies["r1"]["outputs"][wavs[0]]):
        got = load_wav(path)[0]
        snr = snr_db(np.asarray(ref[s], np.float32) * (32767 / 32768), got)
        fails.check(snr >= MIN_SNR_DB, f"r1 track {s + 1} vs CPU plain versions: "
                                       f"SNR {snr:.1f} dB >= {MIN_SNR_DB}")

    # the reference's N(0, 1) initial state, drawn on the card
    rand = SeparationPipeline(mdl, model_kwargs={"compute_dtype": "bfloat16"},
                              batch_size=16, seed=SEED, device="cuda")
    tracks = rand.separate([x])[0]
    fails.check(len(tracks) == 2 and all(np.all(np.isfinite(t)) for t in tracks),
                "random initial state: finite tracks")
    return {"launches": launches, "request_ms": {k: v.get("ms") for k, v in replies.items()},
            "wall_ms": wall_ms}


# -------------------------------------------------------------------- train

def sources(n: int, rng) -> tuple[np.ndarray, np.ndarray]:
    """Two synthetic speakers: a harmonic tone with vibrato, bursts of noise."""
    t = np.arange(n) / 8000.0
    f0 = rng.uniform(120, 250) + 30 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / 8000.0
    s1 = 0.3 * sum(np.sin(k * phase) / k for k in range(1, 6))
    noise = np.convolve(rng.standard_normal(n), np.ones(4) / 4, mode="same")
    s2 = 0.3 * noise * (np.sin(2 * np.pi * rng.uniform(0.8, 2.0) * t) > 0)
    return s1.astype(np.float32), s2.astype(np.float32)


def magnitude(x: np.ndarray, n_fft: int = 512, hop: int = 128) -> np.ndarray:
    """(n_fft/2+1, 1 + len/hop) STFT magnitude of a centered, reflect-padded
    signal with a Hann window: the reference's feature layout."""
    xp = np.pad(x, n_fft // 2, mode="reflect")
    frames = np.lib.stride_tricks.sliding_window_view(xp, n_fft)[::hop]
    spec = np.fft.rfft(frames * np.hanning(n_fft + 1)[:-1], axis=-1)
    return np.abs(spec).T.astype(np.float32)


def write_corpus(root: str, n: int, rng, prefix: str) -> tuple[str, np.ndarray]:
    """A data dir of n npz feature files (mix, s1, s2 magnitudes) of 4.5-6 s
    utterances at 8 kHz; returns the dir and the first mixture waveform."""
    os.makedirs(root)
    lines, first = [], None
    for i in range(n):
        s1, s2 = sources(int(8000 * rng.uniform(4.5, 6.0)), rng)
        utt = f"{prefix}{i:04d}"
        path = os.path.join(root, utt + ".npz")
        np.savez(path, mix=magnitude(s1 + s2), s1=magnitude(s1), s2=magnitude(s2))
        lines.append(f"{utt} {path}\n")
        if first is None:
            first = s1 + s2
    with open(os.path.join(root, "feats_train.scp"), "w") as f:
        f.writelines(lines)
    return root, first


def check_trained(fails: Failures, res: dict, exp: str) -> list:
    """Checks on a 5-epoch train() run: epoch losses finite and falling, one
    CV loss at epoch 5, the loss files and checkpoints written. Returns the
    epoch losses."""
    losses = [loss for _, loss in res["epoch_losses"]]
    fails.check(len(losses) == 5 and all(np.isfinite(losses)) and losses[-1] < losses[0],
                f"epoch losses finite and falling: {losses}")
    fails.check(len(res["cv_losses"]) == 1 and np.isfinite(res["cv_losses"][0][1]),
                f"cv loss at epoch 5: {res['cv_losses']}")
    for rel in ("train_stats/train_loss.txt", "train_stats/cv_loss.txt",
                "intermediate_models/init.mdl", "intermediate_models/005.mdl", "final.mdl"):
        fails.check(os.path.isfile(os.path.join(exp, rel)), f"{rel} written")
    return losses


def train_phase(fails: Failures, counters) -> dict:
    """Phase 5: 2x600 bf16 uPIT trained through train() on the card."""
    from speech_separation_tpu_torch.eval.pipeline import SeparationPipeline
    from speech_separation_tpu_torch.train.loop import TrainLoopConfig, train

    work = os.path.join(REPO, "build", "chip_smoke_train")
    shutil.rmtree(work, ignore_errors=True)
    rng = np.random.default_rng(SEED + 3)
    t0 = time.monotonic()
    tr, _ = write_corpus(os.path.join(work, "tr"), 120, rng, "tr")
    cv, wav = write_corpus(os.path.join(work, "cv"), 40, rng, "cv")
    print(f"  corpus: {time.monotonic() - t0:.1f} s", flush=True)
    exp = os.path.join(work, "exp")
    cfg = TrainLoopConfig(batch_size=100, num_epochs=5, time_pad_multiple=128, seed=SEED)

    for c in counters:
        c.launches = 0
    res = train(tr, exp, cfg, cv_data_dir=cv, model_kwargs={"compute_dtype": "bfloat16"},
                device="cuda", log=lambda m: print("  " + m, flush=True))
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}

    losses = check_trained(fails, res, exp)
    steps = res["steps"]
    fails.check(len(steps) == 10, f"{len(steps)} training steps")
    for name in ("lstm_seq_fwd", "lstm_seq_bwd"):
        fails.check(launches[name] == 20, f"{name} launched {launches[name]} times "
                                          "while training (2 layers x 10 steps)")
    fails.check(launches["lstm_seq_infer"] > 0,
                f"lstm_seq_infer launched {launches['lstm_seq_infer']} times in the CV pass")
    # each epoch is one full batch and one of 20 real rows padded to B=100:
    # ms/step of the full batches alone, and real rows over all later steps
    full = [m for m, n in steps[1:] if n == cfg.batch_size]
    part = [m for m, n in steps[1:] if n < cfg.batch_size]
    ms = [m for m, _ in steps[1:]]
    ms_per_step = float(np.mean(full))
    utts_per_s = sum(n for _, n in steps[1:]) / (sum(ms) / 1e3)
    print(f"  epochs (wall s, steps s): "
          f"{[(round(w, 3), round(st, 3)) for _, w, st in res['epoch_times']]}", flush=True)
    print(f"  full-batch steps after the first: {ms_per_step:.2f} ms/step (min "
          f"{min(full):.2f}, max {max(full):.2f}; {len(full)} steps); 20-row steps "
          f"{np.mean(part):.2f} ms/step; real rows over all steps after the first: "
          f"{utts_per_s:.1f} utts/s; first step {steps[0][0]:.1f} ms", flush=True)

    pipe = SeparationPipeline(os.path.join(exp, "final.mdl"),
                              model_kwargs={"compute_dtype": "bfloat16"}, device="cuda")
    tracks = pipe.separate([wav])[0]
    fails.check(len(tracks) == 2 and all(np.all(np.isfinite(t)) for t in tracks),
                "final.mdl separates a wav on the card into finite tracks")
    return {"launches": launches, "ms_per_step": ms_per_step, "utts_per_s": utts_per_s,
            "epoch_losses": losses, "cv_loss": res["cv_losses"],
            "epoch_times": res["epoch_times"], "train_dir": tr}


def step_phase(fails: Failures, train_dir: str) -> dict:
    """Phase 6: one training step, card against CPU, 2x600 bf16 on 8 rows of
    the training corpus, same weights and initial state."""
    import copy

    from speech_separation_tpu_torch.models import upit
    from speech_separation_tpu_torch.train.data import (BatchPlan, FeatureDataset,
                                                        make_device_batch)
    from speech_separation_tpu_torch.utils.weights import fold_lstm_biases

    ds = FeatureDataset(train_dir)
    batch = make_device_batch([ds.load(i) for i in range(8)],
                              BatchPlan(batch_size=8, time_pad_multiple=128))
    cfg = upit.Config(compute_dtype="bfloat16")
    model = upit.UPIT(cfg)
    model.reset_parameters(torch.Generator().manual_seed(SEED + 4))
    fold_lstm_biases(model.blstm)
    rng = np.random.default_rng(SEED + 4)
    state = [torch.from_numpy(rng.standard_normal((2, 2, 8, 600)).astype(np.float32))
             for _ in range(2)]
    out = {}
    for dev in ("cuda", "cpu"):
        m = copy.deepcopy(model).to(dev)
        b = {k: torch.from_numpy(batch[k]).to(dev) for k in
             ("mix", "sources", "lengths", "row_mask")}
        t0 = time.monotonic()
        loss, _ = upit.contract_loss(m, b, *(s.to(dev) for s in state), train=True)
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
        print(f"  {dev} step: {(time.monotonic() - t0) * 1e3:.0f} ms, loss {loss.item():.6f}",
              flush=True)
        out[dev] = (loss.detach(), {n: p.grad for n, p in m.named_parameters()
                                    if p.grad is not None})
    loss_err = rel_l2(out["cuda"][0], out["cpu"][0])
    grad_err = {n: rel_l2(g, out["cpu"][1][n]) for n, g in out["cuda"][1].items()}
    worst = max(grad_err, key=grad_err.get)
    fails.check(loss_err <= TRAIN_TOL["step_loss"],
                f"step loss card vs CPU: rel err {loss_err:.3e} <= {TRAIN_TOL['step_loss']}")
    fails.check(len(grad_err) == 16 and grad_err[worst] <= TRAIN_TOL["step_grad"],
                f"step gradients card vs CPU ({len(grad_err)} parameters): worst {worst} "
                f"rel err {grad_err[worst]:.3e} <= {TRAIN_TOL['step_grad']}")
    print("  gradient rel errs: " + ", ".join(f"{n} {e:.2e}" for n, e in grad_err.items()),
          flush=True)
    return {"loss_rel_err": loss_err, "grad_rel_err": grad_err}


# ------------------------------------------------------------- SepFormer

SEPFORMER_KW = {"compute_dtype": "bfloat16", "fused_attention": "1"}


def serve_sepformer_phase(fails: Failures, counters) -> dict:
    """Phase 7: the full-width bf16 SepFormer with fused attention, served."""
    from speech_separation_tpu_torch.eval.pipeline import SeparationPipeline
    from speech_separation_tpu_torch.models import sepformer
    from speech_separation_tpu_torch.train.checkpoint import save_checkpoint
    from speech_separation_tpu_torch.utils.audio import load_wav, write_wav_int16

    work = os.path.join(REPO, "build", "chip_smoke_sepformer_serve")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg = sepformer.Config.from_kwargs(**SEPFORMER_KW)
    model = sepformer.SepFormer(cfg, torch.Generator().manual_seed(SEED))
    mdl = os.path.join(work, "sepformer.mdl")
    save_checkpoint(mdl, model, meta={"arch": "SepFormer", "model_kwargs": SEPFORMER_KW})
    rng = np.random.default_rng(SEED + 6)
    wavs = []
    for k, sec in enumerate((3.0, 5.5, 8.0)):
        path = os.path.join(work, f"mix{k}.wav")
        write_wav_int16(path, 8000, mixture(int(sec * 8000), rng))
        wavs.append(path)

    pipe = SeparationPipeline(mdl, batch_size=16, seed=SEED, device="cuda")
    fails.check(pipe.arch.NAME == "SepFormer" and pipe.cfg == cfg,
                f"the .state meta gives {pipe.arch.NAME} {pipe.cfg}")
    replies, launches, wall_ms = serve_requests(fails, pipe, work, wavs, ([0], [1], [2]),
                                                counters, lambda n: n)
    fails.check(launches["chunk_attention_fwd"] > 0,
                f"chunk_attention_fwd launched {launches['chunk_attention_fwd']} times "
                "while serving")

    # r1's mixture on the card (the serving pipeline) and on the CPU (plain
    # versions), as float tracks
    x = load_wav(wavs[0])[0]
    got = pipe.separate([x])[0]
    cpu = SeparationPipeline(mdl, batch_size=16, seed=SEED, device="cpu")
    ref = cpu.separate([x])[0]
    snrs = [snr_db(np.asarray(r), np.asarray(g)) for r, g in zip(ref, got)]
    fails.check(min(snrs) >= SEPFORMER_TOL["min_snr_db"],
                f"r1 tracks vs CPU plain versions: SNR {', '.join(f'{v:.1f}' for v in snrs)} "
                f"dB >= {SEPFORMER_TOL['min_snr_db']}")
    return {"launches": launches, "request_ms": {k: v.get("ms") for k, v in replies.items()},
            "wall_ms": wall_ms, "snr_db": snrs}


def write_wav_corpus(root: str, n: int, rng, prefix: str, sec: float = 4.0) -> str:
    """n utterances of ``sec`` seconds in the mix/s1/s2 layout under
    root/corpus, listed in root/data/wav.scp; returns the data dir."""
    from speech_separation_tpu_torch.utils.audio import write_wav_int16
    corpus, data = os.path.join(root, "corpus"), os.path.join(root, "data")
    for sub in ("mix", "s1", "s2"):
        os.makedirs(os.path.join(corpus, sub))
    os.makedirs(data)
    lines = []
    for i in range(n):
        s1, s2 = sources(int(8000 * sec), rng)
        mix = s1 + s2
        g = min(1.0, 0.9 / float(np.max(np.abs(mix))))
        utt = f"{prefix}{i:04d}"
        for sub, x in (("mix", mix), ("s1", s1), ("s2", s2)):
            write_wav_int16(os.path.join(corpus, sub, utt + ".wav"), 8000, x * g)
        lines.append(f"{utt} {os.path.join(corpus, 'mix', utt + '.wav')}\n")
    with open(os.path.join(data, "wav.scp"), "w") as f:
        f.writelines(lines)
    return data


def train_sepformer_phase(fails: Failures, counters) -> dict:
    """Phase 8: the full-width bf16 SepFormer trained through train()."""
    from speech_separation_tpu_torch.eval.pipeline import SeparationPipeline
    from speech_separation_tpu_torch.train.loop import TrainLoopConfig, train
    from speech_separation_tpu_torch.utils.audio import load_wav

    work = os.path.join(REPO, "build", "chip_smoke_sepformer_train")
    shutil.rmtree(work, ignore_errors=True)
    rng = np.random.default_rng(SEED + 7)
    t0 = time.monotonic()
    tr = write_wav_corpus(os.path.join(work, "tr"), 64, rng, "tr")
    cv = write_wav_corpus(os.path.join(work, "cv"), 16, rng, "cv")
    print(f"  corpus: {time.monotonic() - t0:.1f} s", flush=True)
    exp = os.path.join(work, "exp")
    cfg = TrainLoopConfig(arch="SepFormer", batch_size=32, num_epochs=5, seed=SEED,
                          on_device_features=True)
    for c in counters:
        c.launches = 0
    res = train(tr, exp, cfg, cv_data_dir=cv, model_kwargs=SEPFORMER_KW, device="cuda",
                log=lambda m: print("  " + m, flush=True))
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    losses = check_trained(fails, res, exp)
    steps = res["steps"]
    fails.check(len(steps) == 10 and all(n == 32 for _, n in steps),
                f"{len(steps)} training steps of 32 rows")
    # 8 attention layers (4 blocks x intra, inter): each step runs the
    # forward and the backward of each once; the CV batch runs the forward
    fails.check(launches["chunk_attention_fwd"] == 8 * 11,
                f"chunk_attention_fwd launched {launches['chunk_attention_fwd']} times "
                "(8 layers x (10 steps + 1 CV batch))")
    fails.check(launches["chunk_attention_bwd"] == 8 * 10,
                f"chunk_attention_bwd launched {launches['chunk_attention_bwd']} times "
                "(8 layers x 10 steps)")
    ms = [m for m, _ in steps[1:]]
    print(f"  steps after the first: {np.mean(ms):.2f} ms/step (min {min(ms):.2f}, max "
          f"{max(ms):.2f}); first step {steps[0][0]:.1f} ms; epochs (wall s, steps s): "
          f"{[(round(w, 3), round(st, 3)) for _, w, st in res['epoch_times']]}", flush=True)

    pipe = SeparationPipeline(os.path.join(exp, "final.mdl"), device="cuda")
    x = load_wav(os.path.join(work, "cv", "corpus", "mix", "cv0000.wav"))[0]
    tracks = pipe.separate([x])[0]
    fails.check(len(tracks) == 2 and all(len(t) == len(x) and np.all(np.isfinite(t))
                                         for t in tracks),
                "final.mdl separates a wav on the card into finite tracks")
    return {"launches": launches, "ms_per_step": float(np.mean(ms)), "epoch_losses": losses,
            "cv_loss": res["cv_losses"], "epoch_times": res["epoch_times"], "train_dir": tr}


def sepformer_step_phase(fails: Failures, train_dir: str) -> dict:
    """Phase 9: one SepFormer step on the card, fused attention against the
    einsum path at B=32; then the fused step on the card against the CPU at
    B=4. Same weights, same batch."""
    import copy
    import dataclasses

    from speech_separation_tpu_torch.dsp.stft import STFTConfig
    from speech_separation_tpu_torch.models import sepformer
    from speech_separation_tpu_torch.train.wav_data import (WavDataset, audio_to_wave_batch,
                                                            collate_wav_batch)

    ds = WavDataset(train_dir)
    shipped = collate_wav_batch(ds, list(range(32)), 32)
    cfg = sepformer.Config.from_kwargs(**SEPFORMER_KW)
    base = sepformer.SepFormer(cfg, torch.Generator().manual_seed(SEED + 8))

    def step(fused: bool, dev: str, rows: int):
        m = copy.deepcopy(base).to(dev)
        m.cfg = dataclasses.replace(cfg, fused_attention=fused)
        b = audio_to_wave_batch({k: torch.from_numpy(shipped[k][:rows]).to(dev) for k in
                                 ("audio", "sample_lengths", "row_mask")}, STFTConfig())
        t0 = time.monotonic()
        loss, _ = sepformer.loss_fn(m, b, None, True)
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
        print(f"  {dev} {'fused' if fused else 'einsum'} step, B={rows}: "
              f"{(time.monotonic() - t0) * 1e3:.0f} ms, loss {loss.item():.6f}", flush=True)
        return loss.detach(), {n: p.grad for n, p in m.named_parameters()}

    def compare(a, b, what, tol_loss, tol_grad):
        loss_err = rel_l2(a[0], b[0])
        grad_err = {n: rel_l2(g, b[1][n]) for n, g in a[1].items()}
        worst = max(grad_err, key=grad_err.get)
        fails.check(loss_err <= tol_loss, f"{what} loss: rel err {loss_err:.3e} <= {tol_loss}")
        fails.check(len(grad_err) == len(list(base.parameters()))
                    and grad_err[worst] <= tol_grad,
                    f"{what} gradients ({len(grad_err)} parameters): worst {worst} rel err "
                    f"{grad_err[worst]:.3e} <= {tol_grad}")
        return {"loss_rel_err": loss_err, "worst": worst, "worst_rel_err": grad_err[worst]}

    fused = step(True, "cuda", 32)
    einsum = step(False, "cuda", 32)
    out = {"fused_vs_einsum": compare(fused, einsum, "B=32 fused vs einsum on the card",
                                      SEPFORMER_TOL["fused_loss"], SEPFORMER_TOL["fused_grad"])}
    del fused, einsum
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = compare(step(True, "cuda", 4), step(True, "cpu", 4),
                                 "B=4 fused step card vs CPU", SEPFORMER_TOL["cpu_loss"],
                                 SEPFORMER_TOL["cpu_grad"])
    return out


def _kernel_group(name: str) -> str:
    if "attn_fwd_kernel" in name:
        return "K5 forward"
    if "attn_bwd_kernel" in name:
        return "K5 backward"
    if any(s in name.lower() for s in ("gemm", "cutlass", "xmma", "gemv")):
        return "products (cuBLAS)"
    if "elementwise" in name or "vectorized" in name:
        return "elementwise"
    if "reduce" in name.lower():
        return "reductions"
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return "copies and fills"
    return "other"


def profile_main() -> int:
    """Where the time of one full-width bf16 SepFormer training step goes
    (B=32, 4 s utterances padded to 32768 samples, update_step: loss,
    backward, clip, Adam), with fused attention and with the einsum path:
    3 warm-up steps, then 5 steps under torch.profiler. Prints per step the
    host's wall, the device's busy time (the union of its kernels' and
    copies' intervals) and its idle share, device time by kernel group, and
    the 12 kernels that take longest, then one JSON line of it all."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from speech_separation_tpu_torch.models import sepformer
    from speech_separation_tpu_torch.train.loop import Optimizer, TrainLoopConfig, update_step

    dev = torch.device("cuda")
    steps = 5
    gen = torch.Generator(device=dev).manual_seed(SEED)
    B, L = 32, 32768
    n = torch.full((B,), 32000, dtype=torch.int32, device=dev)
    srcs = 0.1 * torch.randn((B, 2, L), generator=gen, device=dev)
    srcs = srcs * (torch.arange(L, device=dev) < n[:, None, None])
    batch = {"mix_wav": srcs.sum(1), "source_wavs": srcs, "sample_lengths": n,
             "row_mask": torch.ones(B, device=dev)}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    result = {}
    for fused in ("1", "0"):
        cfg = sepformer.Config.from_kwargs(compute_dtype="bfloat16", fused_attention=fused)
        model = sepformer.SepFormer(cfg, torch.Generator().manual_seed(SEED)).to(dev)
        opt = Optimizer(model.parameters(), TrainLoopConfig())
        for _ in range(3):
            float(update_step(sepformer, model, opt, batch, None)[0])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                float(update_step(sepformer, model, opt, batch, None)[0])
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        spans, by_kernel = [], {}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            start, end = e.time_range.start, e.time_range.end
            spans.append((start, end))
            k = by_kernel.setdefault(e.name, [0.0, 0])
            k[0] += (end - start) / 1e3 / steps
            k[1] += 1
        busy, reached = 0.0, float("-inf")       # the union of the spans, in us
        for s, e in sorted(spans):
            busy += max(0.0, e - max(s, reached))
            reached = max(reached, e)
        busy = busy / 1e3 / steps
        groups = {}
        for name, (ms, _) in by_kernel.items():
            g = _kernel_group(name)
            groups[g] = groups.get(g, 0.0) + ms
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
        label = "fused" if fused == "1" else "einsum"
        print(f"== SepFormer step, {label} attention: wall {wall_ms:.2f} ms, device busy "
              f"{busy:.2f} ms, idle share {1 - busy / wall_ms:.3f}", flush=True)
        for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
            print(f"  {g}: {ms:.3f} ms ({100 * ms / busy:.1f}% of busy)")
        for name, (ms, count) in top:
            print(f"    {ms:8.3f} ms  {count // steps:4d}x  {name[:110]}")
        result[label] = {"wall_ms": wall_ms, "busy_ms": busy, "idle_share": 1 - busy / wall_ms,
                         "groups_ms": groups,
                         "launches_per_step": sum(c for _, c in by_kernel.values()) / steps,
                         "top": [[name, ms, count // steps] for name, (ms, count) in top]}
        del model, opt
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


def main() -> int:
    if sys.argv[1:] == ["--profile"]:
        return profile_main()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from speech_separation_tpu_torch.ops import _build
    from speech_separation_tpu_torch.ops.attention_kernel import (chunk_attention_bwd,
                                                                  chunk_attention_fwd)
    from speech_separation_tpu_torch.ops.lstm_kernel import (lstm_seq_bwd, lstm_seq_fwd,
                                                             lstm_seq_infer)
    from speech_separation_tpu_torch.ops.stft_kernel import stft

    t_start = time.monotonic()
    fails = Failures()
    print("== 1. device", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(smi)
    print(f"  torch {torch.__version__} cuda {torch.version.cuda}: {kind}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)
    # the plain versions' f32 products must not run in TF32 (the pipeline
    # owns that setting, and phase 3 runs before any pipeline exists)
    fails.check(not torch.backends.cuda.matmul.allow_tf32, "f32 matmul without TF32")
    torch.backends.cudnn.allow_tf32 = False      # the f32 cuDNN yardstick in full f32

    print("== 2. build", flush=True)
    t0 = time.monotonic()
    _build.build(["lstm_fwd", "lstm_bwd", "stft", "attention"])
    print(f"  nvcc (parallel): {time.monotonic() - t0:.1f} s", flush=True)
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    print("== 3. kernels against their plain versions", flush=True)
    lstm = check_lstm(fails)
    stft_nums = check_stft(fails)
    lstm_train = check_lstm_train(fails)
    attention = check_attention(fails)
    print(f"  phase 3 done at {time.monotonic() - t_start:.1f} s", flush=True)

    print("== 4. serve (2x600 uPIT, bf16)", flush=True)
    served = serve_phase(fails, [lstm_seq_infer, stft])
    launches = dict(served["launches"])
    for name, n in launches.items():
        fails.check(n > 0, f"{name} launched {n} times while serving")

    print("== 5. train (2x600 uPIT, bf16, B=100)", flush=True)
    trained = train_phase(fails, [lstm_seq_fwd, lstm_seq_bwd, lstm_seq_infer])
    launches.update({k: trained["launches"][k] for k in ("lstm_seq_fwd", "lstm_seq_bwd")})

    k34_ms = 2 * sum(lstm_train[p][torch.bfloat16]["ms"] for p in ("fwd", "bwd"))
    print(f"  K3 and K4 at the step's shape (2 layers, timed apart in phase 3): "
          + ", ".join(f"{k} {2 * lstm_train[p][torch.bfloat16]['ms']:.2f} ms "
                      f"({200 * lstm_train[p][torch.bfloat16]['ms'] / trained['ms_per_step']:.1f}%)"
                      for k, p in (("K3", "fwd"), ("K4", "bwd")))
          + f"; together {k34_ms:.2f} of {trained['ms_per_step']:.2f} ms per step", flush=True)

    print("== 6. one training step, card against CPU", flush=True)
    step = step_phase(fails, trained["train_dir"])
    print(f"  phase 6 done at {time.monotonic() - t_start:.1f} s", flush=True)

    attn_counters = [chunk_attention_fwd, chunk_attention_bwd]
    print("== 7. serve (SepFormer, bf16, fused attention)", flush=True)
    served_sf = serve_sepformer_phase(fails, attn_counters)

    print("== 8. train (SepFormer, bf16, fused attention, B=32, 4 s)", flush=True)
    trained_sf = train_sepformer_phase(fails, attn_counters)
    launches.update(trained_sf["launches"])

    k5_ms = 4 * sum(attention[p][s]["ms"] for p in ("fwd", "bwd")
                    for s in (torch.bfloat16, "inter"))
    print(f"  K5 at the step's shapes (4 intra and 4 inter layers, forward and backward, "
          f"timed apart in phase 3): {k5_ms:.2f} ms of {trained_sf['ms_per_step']:.2f} ms "
          f"per step ({100 * k5_ms / trained_sf['ms_per_step']:.1f}%)", flush=True)

    print("== 9. one SepFormer step: fused against einsum, card against CPU", flush=True)
    step_sf = sepformer_step_phase(fails, trained_sf["train_dir"])

    def row(name, route, source, replaces, nums, extra):
        return {"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": launches[name], **{k: nums[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                **extra}

    kernels = [
        row("lstm_seq_infer", "cuda", "speech_separation_tpu_torch/csrc/lstm_fwd.cu",
            "speech_separation_tpu/ops/lstm_pallas.py:288", lstm[torch.bfloat16],
            {"dtype": "bfloat16", "float32": lstm[torch.float32]}),
        row("stft", "cuda", "speech_separation_tpu_torch/csrc/stft.cu",
            "speech_separation_tpu/ops/stft_pallas.py:77", stft_nums[False],
            {"magnitude": stft_nums[True]}),
        row("lstm_seq_fwd", "cuda", "speech_separation_tpu_torch/csrc/lstm_fwd.cu",
            "speech_separation_tpu/ops/lstm_pallas.py:175", lstm_train["fwd"][torch.bfloat16],
            {"dtype": "bfloat16", "float32": lstm_train["fwd"][torch.float32]}),
        row("lstm_seq_bwd", "cuda", "speech_separation_tpu_torch/csrc/lstm_bwd.cu",
            "speech_separation_tpu/ops/lstm_pallas.py:400", lstm_train["bwd"][torch.bfloat16],
            {"dtype": "bfloat16", "float32": lstm_train["bwd"][torch.float32]}),
    ]
    for name, part, line in (("chunk_attention_fwd", "fwd", 82), ("chunk_attention_bwd", "bwd", 99)):
        nums = attention[part]
        kernels.append(row(name, "cuda", "speech_separation_tpu_torch/csrc/attention.cu",
                           f"speech_separation_tpu/ops/attention_pallas.py:{line}",
                           nums[torch.bfloat16],
                           {"dtype": "bfloat16", "float32": nums[torch.float32],
                            "inter": nums["inter"], "long": nums["long"],
                            "serve_launches": served_sf["launches"][name]}))
    print(f"  serve: {served}", flush=True)
    print(f"  train: {({k: v for k, v in trained.items() if k != 'train_dir'})}", flush=True)
    print(f"  lstm_seq gradients: {lstm_train['grad']}", flush=True)
    print(f"  card vs CPU step: {step}", flush=True)
    print(f"  SepFormer serve: {served_sf}", flush=True)
    print(f"  SepFormer train: {({k: v for k, v in trained_sf.items() if k != 'train_dir'})}",
          flush=True)
    print(f"  SepFormer step: {step_sf}", flush=True)
    print(f"  total {time.monotonic() - t_start:.1f} s", flush=True)
    if fails:
        print("chip_smoke FAILED:\n  " + "\n  ".join(fails), file=sys.stderr)
        return 1
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
