#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, recipe, streaming and
evaluation paths (uPIT, SepFormer, RSH, DPRNN, TCN, Conv-TasNet; the
float64 device scorer, the oracle, the JAX package's checkpoints; the
training extras: the packed feature cache, the native loader, the hang
watchdog, the profiler; data-parallel training, separation and scoring;
tensor-parallel training steps) on one CUDA card and check them.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the final line:
1. device report (nvidia-smi name and power limit, torch device name);
2. build every kernel of the paths from csrc/ with nvcc for sm_90a, and the
   native loader (csrc/sepio.cpp) with g++, one compiler per source, all at
   once;
3. each kernel against its plain PyTorch version on the card, with the
   kernel's time, the plain version's time, one PyTorch library call's time
   (a yardstick the port never calls) and the least time the card could
   take (bound_ms): the serving kernels (LSTM inference, STFT) at the
   serving shapes (an 8 s bucket of 16 rows: T=513 frames, 2x600 BLSTM),
   the STFT also at the uPIT on-device-features shape (300 rows, T=384),
   both modes, with a bit-identical second launch, torch.stft (cuFFT) as its
   yardstick, its plan held to the library's (sep_stft_plan), odd rows of a
   length that is not a multiple of 4, and the direct path at n_fft=384 and
   320; its times are queued behind a sleep, so the wrapper's host cost does
   not show;
   the training kernels (LSTM training forward and backward) at the
   training shape (T=384, B=100, H=600), all also at a small ragged shape;
   the training forward and the backward each also launched twice on the
   same inputs (bit-identical outputs), each with its time per step beside
   cuDNN's (the forward's cuDNN time the median of seven repeats, with its
   range) and its launch plan (CTAs, CTAs resident per SM, shared memory,
   rows of a ring group);
   the differentiable recurrence's gradients against autograd through the
   plain forward; and the attention kernel (forward and backward) at a small
   ragged shape, at SepFormer's training intra- and inter-chunk shapes
   (N=10624, T=100 and N=12800, T=83, dh=16) and at a long inter-chunk shape
   (T=1230, a 60 s request), its bf16 kernels also launched twice on the same
   inputs (bit-identical outputs), with their launch plan (attention_plan,
   held to the library's own) and the HMMA (tensor-core) instructions that
   cuobjdump finds in their SASS; the channelwise LayerNorm (K6) forward and
   backward at SepFormer's training rows (132,000 x 256, bf16) and at TCN's
   257 bins, against its plain versions, launched twice (bit-identical), its
   times beside the plain cln's (forward, and its autograd backward), the
   bytes bound and F.layer_norm's (a yardstick the port never calls);
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
10. recipe: the reference's staged recipe through the port's CLI, in process
   (cli.main.main) in build/chip_smoke_recipe/: corpora from
   utils/synthetic.py (train 120, CV 40, test 100 utterances of 4.5-6 s);
   run-train stages 0-2 (prepare, extract with K2 in magnitude mode, train a
   2x600 bf16 uPIT at B=100 for 5 epochs with K3/K4); run-eval stages 0-4 on
   the test set at B=100 with --nj 8 (extract with K2 in re/im mode, masks
   with K1 at B=100, T=384, reconstruct, the host f64 scorer in 8 spawned
   workers); extract again in 4 spawned worker processes (--nj 4 --mj 4);
   run-eval --on-device-features --device-scoring into a second model
   dir (the float64 device scorer of phase 23). K2 and
   K1 are first held against their plain versions at the recipe's shapes.
   Checks: the files as the reference writes them, the workers' features
   against the in-process ones, each kernel's launches in
   the stage that should launch it (zeroed before each command, read at each
   stage's marker line), the staged and fused mean SDR, and the first 8 test
   utterances' run-eval on the card against the CPU (both with
   zero_init_hidden=1): features, tracks by SNR and each source's SDR.
   Prints each stage's wall and the mean SDR/SIR/SAR/SI-SDRi;
11. K1, K3 and K4 at DPRNN's BLSTM shapes (H=128, bf16; 2656 rows of 100
   steps and 3200 rows of 83, length-0 and length-1 rows among them) against
   their plain versions: a bit-identical second launch, a length-0 row's
   state passed through exactly, the launch plan, time, bound and cuDNN's
   nn.LSTM(64->128, bidirectional) time; then lstm_seq's gradients through
   two chained calls (the first's h_last/c_last the second's h0/c0, as RSH
   carries its state) against autograd through the plain forward at T=384,
   B=100, H=600 bf16;
12. train RSH: train() on npz features extracted on the card from
   utils/synthetic.make_synthetic_corpus_var corpora (200 training and 40 CV
   utterances of 4.5-6 s with 2 and 3 speakers, so T=384), 2x600 bf16 at
   B=100 with the reference's N(0, 1) initial state, 5 epochs: 10 steps of
   one speaker count each (ms per step by count, K3/K4 launches 2S a step);
   then 2 steps of the reference's mixed batches on a 1/2/3-speaker corpus;
13. one RSH step at S=2 and S=3 on the card against the CPU, zero initial
   state, in bf16 and in f32: loss, assignments, every gradient and BN's
   running statistics, each pass's loss and the (h, c) it carries on; the
   CPU's bf16 step against its f32 one, and a fault control in each dtype
   (the carried state zeroed between passes) that must fail the bounds;
14. RSH eval: run-eval stages 0-4 through the CLI on 100 test utterances of 2
   and 3 speakers (masks of S passes with K1, reconstruction, the host
   scorer; stage walls and mean SDR), then SeparationServer requests asking
   for 3, 2 and 3 sources, one request's tracks against the CPU by SNR;
15. train DPRNN: the JAX package's defaults in bf16 (6 blocks, H=128), B=32
   on 4 s wavs with --on-device-features, 5 epochs (10 steps, CV at epoch
   5); ms per step, peak memory, launches (K3/K4 12 a step);
16. one DPRNN step on the card against the CPU at B=4, in bf16 and in f32,
   with the same controls (the fault: block 0's intra-chunk forward
   direction fed time-reversed);
17. serve DPRNN: three requests of 3, 5.5 and 8 s (batches padded with
   1-sample rows, whose chunks lie in padding: length-0 rows of the
   intra-chunk BLSTM), then the three as one ragged batch against the CPU
   by SNR; K1 launches counted (12 a batch);
18. remat: one 2x600 bf16 uPIT step and one RSH step (S=2) at B=100, T=384
   (phase 5's corpus) with remat=1 against remat=0, same weights, batch and
   initial state: loss, every gradient and BN's running statistics against
   the plain step's own rerun noise, both peak memories, and K3's launches
   (twice as many with remat: the recompute runs the forward again);
19. TCN at the JAX package's defaults in bf16 (257 -> 256 channels, hidden
   512, kernel 3, 8 x 4 blocks): train() at B=100 on phase 5's npz corpus
   (T=384), 10 epochs, the loss falling (ms per step, peak memory); 2 steps
   of --on-device-features on phase 8's wavs (one K2 launch a step); one
   step on the card against the CPU in bf16 and in f32, with the CPU's bf16
   step against its f32 one and a fault control in each dtype;
   three requests of 3, 5.5 and 8 s through
   SeparationServer (K2 counted, one a batch) and the tracks against the CPU
   by SNR;
20. Conv-TasNet at the JAX package's defaults in bf16 (N=256, L=32, stride
   16, B=128, H=512, 8 x 3 blocks, gLN, relu): train --on-device-features at
   B=32 on phase 8's 4 s wavs (1999 latent frames), 5 epochs, without
   remat; one step at B=4 (with the same controls) and three served
   requests against the CPU;
21. live streaming: a full-width causal TCN (16-frame chunks) and a
   full-width causal Conv-TasNet (16 latent frames) each in a StreamingPool
   of capacity 8: 8 concurrent streams of 3-8 s pushed in uneven blocks, and
   a 9th opened in the slot of the first to close; in f32 each stream
   against the offline pipeline on the card and against the same stream
   alone; ms per chunk and the real-time factor at capacity 8 in bf16; one
   stream through the server's stream_open/push/close on a Unix socket;
22. the port's tools through cli.main.main: doctor (the card, nvcc, every
   kernel built, the native loader loaded), warmup (every arch's kernels
   from the build cache, their launch plans at the training shapes) and
   bench with the phases upit_bf16, sepformer, dprnn, dsp and serving,
   each in a child process: the merged line's phases, numbers and build,
   and each child's launches;
23. device scoring: the linalg backend and one 64-utterance LU under
   cuSOLVER and MAGMA; copies of phase 10's uPIT tracks and phase 14's RSH
   tracks (2 and 3 sources) rescored by `score --device-scoring` (float64
   on the card, eval/bss_eval_device.py), every result row held to the host
   scorer's within SCORE_DB with the same permutation, the walls side by
   side with the anatomy line and the fallbacks; `run-eval --stage 4
   --device-scoring` on a copy of phase 10's model dir; phase 10's model
   written as the JAX package's SEPTPU01 checkpoint (the script's own
   msgpack encoder) and run through `run-eval --stage 2 --device-scoring`
   (masks identical to phase 10's, K1 counted); a fault control scoring the
   same tracks with flen=511, which must miss SCORE_DB on every utterance;
24. oracle: `oracle` soft and hard on phase 10's 100 test utterances with
   --device-scoring (K2 counted, one launch an utterance) and with the host
   scorer in 8 spawned workers, rows within SCORE_DB; the soft mask's
   --device-scoring command again with --device cpu (the plain STFT and the
   same scorer on the CPU), each row within a bound derived from K2's
   contract;
25. training extras on phase 5's corpus: pack-features at f32 and f16; one
   batch of 100 by the numpy, native (csrc/sepio.cpp, built with g++ in
   phase 2) and cache collations, bit-equal (f16 within 1e-3), each timed;
   a 2x600 bf16 uPIT trained at B=100 from each (the same epoch losses; the
   f16 cache's within 2e-3, its batches crossing at half the bytes; K3/K4
   counted; each epoch's wall against its step time); `train
   --hang-watchdog-sec --profile-dir --train-copy-location` through the CLI
   (a spawned CUDA child: 0 restarts, final.mdl equal to the unsupervised
   run's, the features staged, the trace naming K3 and K4); and a fault
   control whose child is stopped after its epoch-5 checkpoint, killed by
   the watchdog and restarted from it (1 restart, the same final.mdl);
   phase 22's doctor reports the native loader loaded;
26. data parallel on one card (two ranks on cuda:0 over gloo; two pipeline
   replicas on cuda:0, run in turn): (a) phase 5's uPIT training (2x600
   bf16, B=100, 5 epochs) over two ranks, each rank collating the whole batch
   from phase 25's copy of the set with the native loader and keeping its
   rows, its losses against phase 5's, each
   step's wall beside phase 5's, final.mdl separating a wav; (b) one uPIT
   step over two ranks against one process on 100 rows of phase 5's corpus
   (same weights, batch and initial states: loss, every gradient as reduced,
   BN's running statistics, within DP_TOL), and the three fault controls (BN
   statistics per rank, T per rank, gradients averaged under per-rank
   norms), each of which must fail those bounds; (c) one RSH step of a mixed
   batch whose sub-batches (3, 5 and 1 rows of 1, 2 and 3 speakers) do not
   divide over the ranks; (d) one full-width bf16 SepFormer step with fused
   attention at B=8 (K5 and K6 on each rank, counted over the ranks); (e) 20 requests through a pipeline of
   two replicas (batch_size 15 -> 16 with the note) against one device; (f)
   `separate --data-parallel` through the CLI (the one-device note, wavs
   bit-identical to the run without it) and `score --device-scoring` over a
   two-entry mesh on phase 10's test set, rows within 1e-9 dB of one
   device's; (g) rank 1 raising at its second step, the run ending non-zero
   at once ((b)-(d)'s ranks and (g)'s run beside the one-process steps, (e)
   and (f)); every kernel's launches in the phase (summed over the ranks);
27. tensor parallel on one card (four ranks on cuda:0 over gloo, data 2 x
   model 2, spawned once for every job): one step of phase 26 (b)'s 2x600
   uPIT job (100 rows of phase 5's corpus, the same weights and initial
   states) with the head split over the model group and with the LSTM's gate
   rows split too (lstm_gates), and one step of the default Conv-TasNet with
   Megatron blocks on 8 of phase 8's 4 s wavs, each in bf16 and f32, against
   the same step in one process (phase 26's for uPIT): the loss, the clip's
   norm (one value on every rank), every gradient as reduced and assembled,
   BN's running statistics and the parameters' updates, within TP_TOL; the
   four fault controls (a gather's backward summing its blocks, a replicated
   input's gradient not summed over the model group, the gradients and the
   loss's norm summed over every rank, gLN's statistics over the rank's block)
   in both dtypes, each of which must fail those bounds; the uPIT bf16 step's
   time under each placement beside phase 26 (a)'s and phase 5's; every
   kernel's launches in the phase (summed over the ranks);
28. the training step's products outside the kernels (ops/mxu.py): each
   product of a uPIT step (B=100, T=384) and of a DPRNN step (B=32, 4 s) at
   its shape, today's float32 product of the rounded operands against
   mxu_dot's as the step runs it (bf16 operands on the tensor cores,
   float32 sums; float32 where ops/mxu.py's rule keeps it), and the four
   transformer-layer products of the published SepFormer's step (132,000
   rows of sepformer-train-b16: 256->768, 256->256, 256->1024, 1024->256,
   with bias, rounded to bf16) through rounded_dot (the float32 product)
   against any_order_dot (the tensor cores), each time beside its bound,
   the kernels behind it (no float32 GEMM behind a bf16 product) and its
   gap from today's result; the counters of one step of each;
29. one JSON line with every kernel and its numbers (with the recipe's
   launch counts, each LSTM kernel's numbers at DPRNN's shapes and its
   launches on each RSH, DPRNN, remat, SEPTPU01 and phase 25 path, K2's on
   the TCN and oracle paths, the launches of each bench phase of phase 22 and
   of phases 26 and 27), then {"ok": true, "device": {...}} as the last line.

``python3 chip_smoke.py --profile`` traces full-width SepFormer training
steps with torch.profiler and prints where their time goes.
"""

from __future__ import annotations

import base64
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
# K6 (the channelwise LayerNorm) against its plain versions on the card, by
# relative L2: y and dx are each rounded once to bf16 (an element that rounds
# the other way differs by one ulp), dg and db are float32 sums over the rows
# in another order.
LN_TOL = {"y": 4e-3, "dx": 4e-3, "dg_db": 1e-5}
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
    from speech_separation_tpu_torch.ops.lstm_kernel import (lstm_fwd_plan, lstm_seq_infer,
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
        plan = lstm_fwd_plan(2, B, H, dtype)
        out[dtype] = {"max_abs_err": err, "tolerance": tol, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
                      "us_per_step": 1e3 * ms / T, **plan_keys(plan)}
        print(f"  lstm_infer {dtype}: {ms:.3f} ms (plain {plain_ms:.1f}, cuDNN "
              f"{library_ms:.3f}, bound {b_ms:.4f} by {b_by}); per step "
              f"{1e3 * ms / T:.2f} us; {plan_text(plan)}", flush=True)
    return out


def plan_keys(plan: dict) -> dict:
    return {"ctas": plan["ctas"], "ctas_per_sm": plan["per_sm"], "smem": plan["smem"],
            "group_rows": plan["rows"]}


def plan_text(plan: dict) -> str:
    return (f"{plan['ctas']} CTAs, {plan['per_sm']} per SM resident ({plan['cap']} on "
            f"{plan['sms']} SMs), {plan['smem']} B shared, {plan['rows']}-row groups")


def median_range(xs) -> dict:
    return {"median": float(np.median(xs)), "min": float(min(xs)), "max": float(max(xs)),
            "n": len(xs)}


def queued_ms(fn, iters: int) -> float:
    """Mean device time of fn over iters calls enqueued behind a sleep on the
    stream, so that the host's cost of each call (the wrapper, the launch)
    does not show: for kernels shorter than their launch."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)      # about 20 ms, longer than enqueuing the calls
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check_stft(fails: Failures) -> dict:
    """K2 against its plain version: small ragged rows, odd B with a row
    length that is not a multiple of 4, the direct path at two sizes that are
    not powers of two, the plan against the library's, and at the serving
    (B=16, n_t=513) and uPIT on-device-features (300 rows, n_t=384) shapes in
    both modes, each with a bit-identical second launch and its times beside
    unfold @ A and torch.stft (cuFFT), timed queued behind a sleep."""
    from speech_separation_tpu_torch.dsp.stft import _device_matrix, hann_periodic
    from speech_separation_tpu_torch.ops.stft_kernel import (DIRECT_N_FFT_CAP, card_plan, stft,
                                                             stft_plain, stft_plan)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    n_fft, hop = 512, 128

    def rel_err(got, ref):
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        scale = max(float(r.abs().max()) for r in ref)
        return max(float((g - r).abs().max()) for g, r in zip(got, ref)), scale

    def check(xp, n_fft, hop, n_t, what):
        for magnitude in (False, True):
            err, scale = rel_err(stft(xp, n_fft, hop, n_t, magnitude),
                                 stft_plain(xp, n_fft, hop, n_t, magnitude))
            fails.check(err <= TOL["stft_rel"] * scale,
                        f"stft {what} magnitude={magnitude}: max_abs_err {err:.3e} "
                        f"<= {TOL['stft_rel']} * {scale:.1f}")

    xs = torch.rand((3, 1000 + n_fft + 37), generator=gen, device="cuda") * 2 - 1
    check(xs, n_fft, hop, 8, "small ragged")
    xs = torch.rand((5, 3 * 4096 + n_fft + 7), generator=gen, device="cuda") * 2 - 1
    check(xs, n_fft, hop, 1 + 3 * 4096 // hop, f"B=5 Lp={xs.shape[1]} (not a multiple of 4)")
    for nf, hp in ((384, 128), (320, 160)):
        xs = torch.rand((3, 40 * hp + nf + 5), generator=gen, device="cuda") * 2 - 1
        path = stft_plan(3, xs.shape[1], 41, nf, hp)["path"]
        fails.check(path == "direct", f"stft n_fft={nf} hop={hp} takes the direct path ({path})")
        check(xs, nf, hp, 41, f"direct n_fft={nf} hop={hp}")
    plan_shapes = [(16, 65536 + n_fft, 513, n_fft, hop), (300, 49536, 384, n_fft, hop),
                   (3, 1549, 8, n_fft, hop), (5, 20000, 3, 8192, 4096), (7, 999, 60, 16, 8),
                   (2, 5000, 30, 384, 128), (2, 5000, 30, 320, 160), (1, 100, 20, 8, 4),
                   (1, 40000, 2, 16384, 8192)]
    same = all(card_plan(*a) == stft_plan(*a) for a in plan_shapes)
    above_fft = card_plan(1, 40000, 2, 16384, 8192)["path"] == "direct"
    refused = card_plan(1, 4 * DIRECT_N_FFT_CAP, 1, DIRECT_N_FFT_CAP + 2, 2) is None
    fails.check(same and above_fft and refused,
                f"stft_plan equals sep_stft_plan at {len(plan_shapes)} shapes, n_fft=16384 "
                f"takes the direct path and both refuse above {DIRECT_N_FFT_CAP}")

    window = torch.from_numpy(hann_periodic(n_fft)).cuda()
    A = _device_matrix("rdft", n_fft, torch.device("cuda"))
    out = {}
    for name, (B, Lp, n_t) in (("serve", (16, 65536 + n_fft, 513)),
                               ("features", (300, 49536, 384))):
        xp = (torch.rand((B, Lp), generator=gen, device="cuda") * 2 - 1) * 0.5
        plan = stft_plan(B, Lp, n_t, n_fft, hop)
        out[name] = {"shape": {"B": B, "Lp": Lp, "n_t": n_t, "n_fft": n_fft, "hop": hop},
                     "plan": plan}

        def torch_stft(magnitude):
            X = torch.stft(xp, n_fft, hop, window=window, center=False, return_complex=True)
            return X.abs() if magnitude else X

        for magnitude in (False, True):
            got = stft(xp, n_fft, hop, n_t, magnitude)
            again = stft(xp, n_fft, hop, n_t, magnitude)
            ref = stft_plain(xp, n_fft, hop, n_t, magnitude)
            err, scale = rel_err(got, ref)
            X = torch_stft(magnitude).transpose(1, 2)
            lib_err, _ = rel_err((X,) if magnitude else (X.real, X.imag), ref)
            torch.cuda.synchronize()
            tol = TOL["stft_rel"] * scale
            what = f"stft {name} B={B} n_t={n_t} magnitude={magnitude}"
            fails.check(err <= tol, f"{what}: max_abs_err {err:.3e} <= {tol:.3e}")
            fails.check(lib_err <= tol, f"{what}: torch.stft agrees, {lib_err:.3e} <= {tol:.3e}")
            pairs = zip(got if isinstance(got, tuple) else (got,),
                        again if isinstance(again, tuple) else (again,))
            fails.check(all(torch.equal(a, b) for a, b in pairs),
                        f"{what}: a second launch is bit-identical")
            ms = queued_ms(lambda: stft(xp, n_fft, hop, n_t, magnitude), iters=50)
            plain_ms = queued_ms(lambda: stft_plain(xp, n_fft, hop, n_t, magnitude), iters=10)
            unfold_ms = queued_ms(lambda: torch.matmul(xp.unfold(-1, n_fft, hop)[:, :n_t], A),
                                  iters=10)
            library_ms = queued_ms(lambda: torch_stft(magnitude), iters=20)
            unqueued_ms = cuda_ms(lambda: stft(xp, n_fft, hop, n_t, magnitude), iters=50)
            # the function's least work: an FFT's 2.5 n log2 n operations a
            # frame at the f32 rate, each row read once, each output written once
            flops = 2.5 * n_fft * np.log2(n_fft) * B * n_t
            outs = got if isinstance(got, tuple) else (got,)
            b_ms, b_by = bound_ms(nbytes(xp, *outs), flops, torch.float32)
            out[name]["magnitude" if magnitude else "re_im"] = {
                "max_abs_err": err, "tolerance": tol, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
                "unfold_matmul_ms": unfold_ms, "unqueued_ms": unqueued_ms,
                "timing": "ms, plain_ms, library_ms, unfold_matmul_ms: queued_ms (calls "
                          "enqueued behind a sleep); unqueued_ms: cuda_ms (back to back)"}
            print(f"  stft {name} magnitude={magnitude}: {ms:.4f} ms (plain {plain_ms:.4f}, "
                  f"unfold@A {unfold_ms:.4f}, torch.stft {library_ms:.4f}, bound {b_ms:.4f} "
                  f"by {b_by}; {ms / b_ms:.2f}x the bound; back to back without the queue "
                  f"{unqueued_ms:.4f} ms a call)", flush=True)
        print(f"  stft {name} plan: {plan}", flush=True)
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
        lstm_bwd_plan, lstm_fwd_plan, lstm_seq, lstm_seq_bwd, lstm_seq_bwd_plain,
        lstm_seq_fwd, lstm_seq_fwd_plain)
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
        again = lstm_seq_fwd(*args, save_dtype=dtype, suffix_dirs=sfx)
        fails.check(all(torch.equal(a, b) for a, b in zip(got, again)),
                    f"lstm_fwd T={T} B={B} H={H} {dtype}: a second launch gives "
                    f"bit-identical {', '.join(names_f)}")
        again = lstm_seq_bwd(*bargs, save_dtype=dtype, suffix_dirs=sfx)
        fails.check(all(torch.equal(a, b) for a, b in zip(got_b, again)),
                    f"lstm_bwd T={T} B={B} H={H} {dtype}: a second launch gives "
                    f"bit-identical {', '.join(names_b)}")
        del again
        plan_f = lstm_fwd_plan(2, B, H, dtype)
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
        # the forward's yardstick: the median (and range) of seven repeats of
        # a 5-call mean, as cuDNN's time varies from run to run
        lib_fs = [cuda_ms(lambda: lstm(x), 5) for _ in range(7)]
        lib_f = float(np.median(lib_fs))
        y, _ = lstm(x)
        gy = torch.randn(y.shape, generator=gen, device="cuda").to(dtype)
        lib_bs = []
        for i in range(6):
            y, _ = lstm(x)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            y.backward(gy)
            e1.record()
            e1.synchronize()
            if i:                                        # the first is a warm-up
                lib_bs.append(e0.elapsed_time(e1))
        lib_b = float(np.mean(lib_bs))
        del lstm, x, y, gy
        b_f = bound_ms(nbytes(*args, *got), flops, dtype)
        b_b = bound_ms(nbytes(*bargs, *got_b), flops, dtype)
        out["fwd"][dtype] = {"max_abs_err": err_f, "ms": ms_f, "plain_ms": plain_f,
                             "bound_ms": b_f[0], "bound_by": b_f[1], "library_ms": lib_f,
                             "library_repeats": median_range(lib_fs),
                             "us_per_step": 1e3 * ms_f / T,
                             "library_us_per_step": 1e3 * lib_f / T, **plan_keys(plan_f)}
        out["bwd"][dtype] = {"max_abs_err": err_b, "ms": ms_b, "plain_ms": plain_b,
                             "bound_ms": b_b[0], "bound_by": b_b[1], "library_ms": lib_b,
                             "us_per_step": 1e3 * ms_b / T,
                             "library_us_per_step": 1e3 * lib_b / T,
                             "library_repeats": median_range(lib_bs), **plan_keys(plan)}
        lr = out["fwd"][dtype]["library_repeats"]
        print(f"  lstm_fwd {dtype}: {ms_f:.3f} ms (plain {plain_f:.1f}, cuDNN fwd median "
              f"{lib_f:.3f} of {lr['n']}, range {lr['min']:.3f}-{lr['max']:.3f}, bound "
              f"{b_f[0]:.4f} by {b_f[1]}); per step {1e3 * ms_f / T:.2f} us (cuDNN "
              f"{1e3 * lib_f / T:.2f} us); {plan_text(plan_f)}", flush=True)
        print(f"  lstm_bwd {dtype}: {ms_b:.3f} ms (plain {plain_b:.1f}, cuDNN bwd "
              f"{lib_b:.3f}, median {float(np.median(lib_bs)):.3f}, range "
              f"{min(lib_bs):.3f}-{max(lib_bs):.3f}, bound {b_b[0]:.4f} by {b_b[1]}); per "
              f"step {1e3 * ms_b / T:.2f} us (cuDNN {1e3 * lib_b / T:.2f} us); "
              f"{plan_text(plan)}", flush=True)
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


def backward_ms(forward, leaves, dy, iters: int = 5) -> float:
    """Mean device time of the autograd backward of ``forward(*leaves)``
    alone (a fresh forward before each, outside the timed region)."""
    total = 0.0
    for i in range(iters + 1):
        out = forward(*leaves)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out.backward(dy)
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1) if i else 0.0      # the first is a warm-up
        for t in leaves:
            t.grad = None
    return total / iters


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
    return fwd, backward_ms(lambda *a: F.scaled_dot_product_attention(*a, attn_mask=bias),
                            leaves, do4)


def attention_sass_hmma() -> dict:
    """The tensor-core instructions (HMMA) in the SASS of each bf16 K5
    kernel of the built library, by kernel name, from cuobjdump."""
    from speech_separation_tpu_torch.ops import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_build.build(["attention"])["attention"])],
                          capture_output=True, text=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
        elif "HMMA" in line and name and "sepattn" in name:
            counts[name] = counts.get(name, 0) + 1
    return counts


def check_attention(fails: Failures) -> dict:
    """K5 forward and backward against their plain versions on the same
    inputs: at a small ragged shape (N odd, one fully-masked row), at
    SepFormer's training intra- and inter-chunk shapes and at a long
    inter-chunk shape (ten key tiles), with times, bounds and SDPA's times;
    for bf16 also a second launch (bit-identical outputs), the launch plan
    (attention_plan, held to the library's own) and the HMMA count of each
    kernel's SASS."""
    from speech_separation_tpu_torch.ops.attention_kernel import (
        attention_plan, card_plan, chunk_attention_bwd, chunk_attention_bwd_plain,
        chunk_attention_fwd, chunk_attention_fwd_plain)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    hmma = attention_sass_hmma()
    for part in ("fwd", "bwd"):
        n = sum(c for name, c in hmma.items() if f"attn_{part}_" in name)
        fails.check(n > 0, f"bf16 attention {part} kernels: {n} HMMA in their SASS ("
                           + ", ".join(f"{c} {name}" for name, c in sorted(hmma.items())
                                       if f"attn_{part}_" in name) + ")")

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
        N, T, dh = q.shape
        plans = {}
        if q.dtype == torch.bfloat16:
            again = (chunk_attention_fwd(q, k, v, mask), *chunk_attention_bwd(q, k, v, mask, do))
            torch.cuda.synchronize()
            fails.check(all(torch.equal(a, b) for a, b in zip((o, *grads), again)),
                        f"chunk_attention {label} {q.dtype}: a second launch gives "
                        f"bit-identical o, dq, dk, dv")
            del again
            for part, bwd in (("fwd", False), ("bwd", True)):
                plans[part] = attention_plan(N, T, dh, q.dtype, backward=bwd)
                fails.check(plans[part] == card_plan(N, T, dh, bwd),
                            f"attention_plan {label} {part} is the library's: {plans[part]}")
        ms_f = cuda_ms(lambda: chunk_attention_fwd(q, k, v, mask), 20)
        ms_b = cuda_ms(lambda: chunk_attention_bwd(q, k, v, mask, do), 10)
        plain_f = cuda_ms(lambda: chunk_attention_fwd_plain(q, k, v, mask), 3)
        plain_b = cuda_ms(lambda: chunk_attention_bwd_plain(q, k, v, mask, do), 3)
        lib_f, lib_b = sdpa_ms(q, k, v, mask, do)
        b_f = attention_bound_ms(q, nbytes(q, k, v, mask, o), 2)
        # the backward recomputes QK^T, then dV, dW, dQ and dK: five products
        b_b = attention_bound_ms(q, nbytes(q, k, v, mask, do, *grads), 5)
        print(f"  chunk_attention {label} {q.dtype}: fwd {ms_f:.4f} ms (plain {plain_f:.3f}, "
              f"SDPA {lib_f:.4f}, bound {b_f[0]:.4f} by {b_f[1]}); bwd {ms_b:.4f} ms (plain "
              f"{plain_b:.3f}, SDPA {lib_b:.4f}, bound {b_b[0]:.4f} by {b_b[1]})", flush=True)
        shape = {"N": N, "T": T, "dh": dh}
        hm = {part: sum(c for name, c in hmma.items() if f"attn_{part}_" in name)
              for part in ("fwd", "bwd")} if plans else {}
        return tuple({"max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": b[0],
                      "bound_by": b[1], "library_ms": lib, **shape,
                      **({"plan": plans[part], "hmma": hm[part]} if plans else {})}
                     for part, err, ms, plain, b, lib in (
                         ("fwd", err_f, ms_f, plain_f, b_f, lib_f),
                         ("bwd", err_b, ms_b, plain_b, b_b, lib_b)))

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


def check_layernorm(fails: Failures) -> dict:
    """K6 forward and backward against their plain versions at SepFormer's
    training rows (16 rows x 33 chunks x 250 frames of 256 channels, bf16,
    every 97th row zero as pad frames are) and at TCN's 257 bins, each
    launched twice (bit-identical outputs), with times beside the plain
    cln's (its forward, and its autograd backward), F.layer_norm's (bf16
    scale and shift: a yardstick the port never calls) and the bytes bound:
    the forward reads x and writes y, the backward reads x and dy and writes
    dx (g, b, the statistics and dg, db counted too). The plain forward is
    cln's body, so autograd through it is the plain cln's backward."""
    import torch.nn.functional as F

    from speech_separation_tpu_torch.ops.layernorm_kernel import (channel_norm_bwd,
                                                                  channel_norm_bwd_plain,
                                                                  channel_norm_fwd,
                                                                  channel_norm_fwd_plain)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    out = {}

    def cln_formula(x, g, b):
        return channel_norm_fwd_plain(x, g, b)[0]

    for label, R, H in (("sepformer", 132000, 256), ("tcn", 100 * 384, 257)):
        x = (2.0 * torch.randn((R, H), generator=gen, device="cuda") + 0.5).bfloat16()
        x[::97] = 0
        dy = torch.randn((R, H), generator=gen, device="cuda").bfloat16()
        g = 0.9 + 0.2 * torch.rand(H, generator=gen, device="cuda")
        b = 0.1 * torch.rand(H, generator=gen, device="cuda") - 0.05
        y, mu, rstd = channel_norm_fwd(x, g, b)
        dx, dg, db = channel_norm_bwd(x, g, mu, rstd, dy)
        again = (*channel_norm_fwd(x, g, b), *channel_norm_bwd(x, g, mu, rstd, dy))
        y_p, mu_p, rstd_p = channel_norm_fwd_plain(x, g, b)
        dx_p, dg_p, db_p = channel_norm_bwd_plain(x, g, mu_p, rstd_p, dy)
        torch.cuda.synchronize()
        errs = {"y": rel_l2(y, y_p), "dx": rel_l2(dx, dx_p),
                "dg_db": max(rel_l2(dg, dg_p), rel_l2(db, db_p))}
        for k, e in errs.items():
            fails.check(e <= LN_TOL[k], f"channel_norm {label} ({R}, {H}) bf16 {k} against the "
                                        f"plain version: rel L2 {e:.3e} <= {LN_TOL[k]}")
        fails.check(all(torch.equal(a, r) for a, r in zip((y, mu, rstd, dx, dg, db), again)),
                    f"channel_norm {label}: a second launch gives bit-identical y, mu, rstd, "
                    f"dx, dg, db")
        del again, y_p, dx_p
        # warmed past the card's clock ramp (the first timing read 0.105 ms
        # against 0.058 after it)
        ms_f = cuda_ms(lambda: channel_norm_fwd(x, g, b), 50, warmup=20)
        ms_b = cuda_ms(lambda: channel_norm_bwd(x, g, mu, rstd, dy), 50, warmup=20)
        with torch.no_grad():
            plain_f = cuda_ms(lambda: cln_formula(x, g, b), 10)
            lib_f = cuda_ms(lambda: F.layer_norm(x, (H,), g.bfloat16(), b.bfloat16(), 1e-6), 10)
        leaves = [t.detach().clone().requires_grad_(True) for t in (x, g, b)]
        plain_b = backward_ms(cln_formula, leaves, dy)
        lib_leaves = [t.detach().clone().requires_grad_(True) for t in (x, g.bfloat16(),
                                                                        b.bfloat16())]
        lib_b = backward_ms(lambda xx, gg, bb: F.layer_norm(xx, (H,), gg, bb, 1e-6), lib_leaves,
                            dy)
        b_f = bound_ms(nbytes(x, y, g, b, mu, rstd), 0, torch.bfloat16)
        b_b = bound_ms(nbytes(x, dy, dx, g, mu, rstd, dg, db), 0, torch.bfloat16)
        print(f"  channel_norm {label} ({R}, {H}) bf16: fwd {ms_f:.4f} ms (plain cln "
              f"{plain_f:.4f}, F.layer_norm {lib_f:.4f}, bound {b_f[0]:.4f}: "
              f"{100 * b_f[0] / ms_f:.1f}%); bwd {ms_b:.4f} ms (plain cln's autograd "
              f"{plain_b:.4f}, F.layer_norm's {lib_b:.4f}, bound {b_b[0]:.4f}: "
              f"{100 * b_b[0] / ms_b:.1f}%); rel L2 {errs}", flush=True)
        out[label] = {part: {"rel_l2_err": errs["y" if part == "fwd" else "dx"], "ms": ms,
                             "plain_ms": plain, "bound_ms": bd[0], "bound_by": bd[1],
                             "library_ms": lib, "R": R, "H": H}
                      for part, ms, plain, bd, lib in (("fwd", ms_f, plain_f, b_f, lib_f),
                                                       ("bwd", ms_b, plain_b, b_b, lib_b))}
        del x, dy, y, dx, leaves, lib_leaves
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
                   want_len, num_spks=(None, None, None)) -> tuple[dict, dict, float]:
    """Serve ``pipe`` through SeparationServer on a Unix socket (one 8 s
    bucket warmed up): request r1 with the wavs of ``groups[0]``, then r2
    and r3 with ``groups[1]`` and ``groups[2]`` at once, then a ping; request
    k asks for ``num_spks[k]`` sources where that is not None. Launch
    counts are zeroed just before the requests and read just after. Checks
    every reply and output wav (``want_len(n)`` samples for an n-sample
    input, as many wavs as sources asked for) and that the server stopped;
    returns (replies, launches, wall ms)."""
    from speech_separation_tpu_torch.eval.serve import SeparationServer, request
    from speech_separation_tpu_torch.utils.audio import load_wav

    sock_dir = tempfile.mkdtemp(prefix="sepsmoke")
    sock = os.path.join(sock_dir, "s.sock")
    server = SeparationServer(pipe, sock, coalesce=8)
    print(f"  warmup: {server.warmup([8.0])} bucket(s)", flush=True)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    replies = {}

    def send(name, idx, num_spk):
        payload = {"wavs": [wavs[i] for i in idx], "out_dir": os.path.join(work, name)}
        if num_spk is not None:
            payload["num_spk"] = num_spk
        replies[name] = request(sock, payload)

    try:
        deadline = time.monotonic() + 60
        while not os.path.exists(sock):
            if time.monotonic() > deadline:
                raise RuntimeError("server never bound its socket")
            time.sleep(0.02)
        for c in counters:
            c.launches = 0
        t0 = time.monotonic()
        send("r1", groups[0], num_spks[0])
        pair = [threading.Thread(target=send, args=(f"r{k + 2}", groups[k + 1],
                                                    num_spks[k + 1]))
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

    for name, num_spk in zip(("r1", "r2", "r3"), num_spks):
        rep = replies.get(name, {})
        fails.check(bool(rep.get("ok")), f"request {name} ok ({rep.get('ms')} ms)")
        for wav, paths in rep.get("outputs", {}).items():
            fails.check(len(paths) == (num_spk or pipe.num_spk),
                        f"{name}: {len(paths)} tracks for {os.path.basename(wav)}")
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


def check_trained(fails: Failures, res: dict, exp: str, epochs: int = 5) -> list:
    """Checks on a train() run of ``epochs`` epochs: epoch losses finite and
    falling, a CV loss every 5 epochs, the loss files and checkpoints
    written. Returns the epoch losses."""
    losses = [loss for _, loss in res["epoch_losses"]]
    fails.check(len(losses) == epochs and all(np.isfinite(losses)) and losses[-1] < losses[0],
                f"epoch losses finite and falling: {losses}")
    cv = res["cv_losses"]
    fails.check([e for e, _ in cv] == list(range(5, epochs + 1, 5))
                and all(np.isfinite(loss) for _, loss in cv), f"cv loss every 5 epochs: {cv}")
    for rel in ("train_stats/train_loss.txt", "train_stats/cv_loss.txt",
                "intermediate_models/init.mdl", "final.mdl",
                *(f"intermediate_models/{e:03d}.mdl" for e in range(5, epochs + 1, 5))):
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
    from unittest import mock

    from speech_separation_tpu_torch.models import upit
    from speech_separation_tpu_torch.models.spectral import contract_loss
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
        loss, _ = contract_loss(m, b, *(s.to(dev) for s in state), train=True)
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
        print(f"  {dev} step: {(time.monotonic() - t0) * 1e3:.0f} ms, loss {loss.item():.6f}",
              flush=True)
        out[dev] = (loss.detach(), {n: p.grad for n, p in m.named_parameters()
                                    if p.grad is not None})
    loss_err = rel_l2(out["cuda"][0], out["cpu"][0])
    # The CPU reference's own summation noise, a reading beside the check:
    # the same CPU loss with the recurrent product summed exactly (in f64,
    # then rounded to f32) in place of torch.bmm's f32 order.
    bmm = torch.bmm
    b = {k: torch.from_numpy(batch[k]) for k in ("mix", "sources", "lengths", "row_mask")}
    with mock.patch.object(torch, "bmm", lambda x, y: bmm(x.double(), y.double()).float()):
        exact, _ = contract_loss(copy.deepcopy(model), b, *state, train=True)
    noise = {"cpu_vs_exact_product": rel_l2(out["cpu"][0], exact.detach()),
             "card_vs_exact_product": rel_l2(out["cuda"][0], exact.detach())}
    print(f"  loss rel err: card vs CPU {loss_err:.3e}; CPU (torch.bmm's f32 order) vs the "
          f"exact-product CPU loss {noise['cpu_vs_exact_product']:.3e}; card vs the "
          f"exact-product loss {noise['card_vs_exact_product']:.3e}", flush=True)
    grad_err = {n: rel_l2(g, out["cpu"][1][n]) for n, g in out["cuda"][1].items()}
    worst = max(grad_err, key=grad_err.get)
    fails.check(loss_err <= TRAIN_TOL["step_loss"],
                f"step loss card vs CPU: rel err {loss_err:.3e} <= {TRAIN_TOL['step_loss']}")
    fails.check(len(grad_err) == 16 and grad_err[worst] <= TRAIN_TOL["step_grad"],
                f"step gradients card vs CPU ({len(grad_err)} parameters): worst {worst} "
                f"rel err {grad_err[worst]:.3e} <= {TRAIN_TOL['step_grad']}")
    print("  gradient rel errs: " + ", ".join(f"{n} {e:.2e}" for n, e in grad_err.items()),
          flush=True)
    return {"loss_rel_err": loss_err, "grad_rel_err": grad_err, **noise}


# ------------------------------------------------------------- SepFormer

SEPFORMER_KW = {"compute_dtype": "bfloat16", "fused_attention": "1"}
# the published structure at the paper's widths, as sepformer-train-b16 runs it
SEPFORMER_PUBLISHED = {**SEPFORMER_KW, "n_filters": "256", "channels": "256", "heads": "8",
                       "d_ff": "1024", "chunk": "250", "blocks": "2", "published": "1",
                       "layers": "8"}


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
    for name in ("chunk_attention_fwd", "channel_norm_fwd"):
        fails.check(launches[name] > 0, f"{name} launched {launches[name]} times while serving")

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
    # two LayerNorms (K6) a layer, no path norm in the compact model
    fails.check(launches["channel_norm_fwd"] == 16 * 11 and launches["channel_norm_bwd"] == 16 * 10,
                f"channel_norm_fwd / _bwd launched {launches['channel_norm_fwd']} / "
                f"{launches['channel_norm_bwd']} times (16 norms x 11 forwards / 10 backwards)")
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


# ------------------------------------------------------------------ recipe

# The recipe (phase 10) on the card against the same recipe on the CPU (plain
# versions), on the first RECIPE_CPU_UTTS test utterances with
# zero_init_hidden=1 on both sides (the reference's N(0, 1) initial state is
# drawn on the generator's device, so a card draw and a CPU draw differ):
# test features by max |error| / max |X| (K2's contract), reconstructed
# tracks by SNR (MIN_SNR_DB, as phase 4 holds served tracks), each source's
# SDR in dB; the staged and fused runs' mean SDR in dB (BSS-eval ignores the
# fused path's per-utterance gain).
RECIPE_TOL = {"feat_rel": TOL["stft_rel"], "sdr_db": 0.05, "fused_mean_sdr_db": 0.1}
RECIPE_CPU_UTTS = 8
RECIPE_CORPUS = (("rtr", 120, 1), ("rcv", 40, 2), ("rtt", 100, 3))   # set, utterances, seed
RECIPE_MODEL_CONF = "hidden=600\nnum_layers=2\ncompute_dtype=bfloat16\n"


class StageLog:
    """A stdout that echoes the CLI's lines indented and stamps each one with
    the host's clock and the kernels' launch counts at that moment: the
    recipe's stage markers ("### ... (stage N) ###") and per-set lines split
    its wall and its launches by stage."""

    def __init__(self, counters):
        self.counters = counters
        self.lines: list[tuple[float, str, dict]] = []
        self._buf = ""

    def write(self, s: str) -> int:
        self._buf += s
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            self.lines.append((time.monotonic(), line,
                               {c.__name__: c.launches for c in self.counters}))
            sys.__stdout__.write("    " + line + "\n")
        return len(s)

    def flush(self) -> None:
        sys.__stdout__.flush()

    def run(self, argv: list) -> None:
        """Run the port's CLI in process with this log as stdout; the call's
        end is stamped as a line of its own."""
        import contextlib
        from speech_separation_tpu_torch.cli.main import main as cli
        for c in self.counters:
            c.launches = 0
        with contextlib.redirect_stdout(self):
            print(f"$ {' '.join(argv)}")
            cli(argv)
            torch.cuda.synchronize()
            print("$ done")

    def spans(self, marks) -> dict:
        """{name: (wall s, launches)} of each span from a line holding one of
        ``marks`` (name, text) to the next mark or the call's end."""
        hits = []
        for t, line, counts in self.lines:
            for name, text in marks:
                if text in line:
                    hits.append((name, t, counts))
        end_t, _, end_counts = self.lines[-1]
        out = {}
        for k, (name, t, counts) in enumerate(hits):
            t1, c1 = (hits[k + 1][1], hits[k + 1][2]) if k + 1 < len(hits) else (end_t, end_counts)
            out[name] = (t1 - t, {n: c1[n] - counts[n] for n in counts})
        return out


def check_recipe_kernels(fails: Failures) -> dict:
    """K2 and K1 at the recipe's shapes against their plain versions: the
    extraction's launch of 64 rows of 6 s buckets (49152 samples, 385 frames)
    in both modes, and eval-masks' K1 at B=100 rows of 4.5-6 s (T=384), bf16."""
    from speech_separation_tpu_torch.ops.lstm_kernel import lstm_seq_infer, lstm_seq_infer_plain
    from speech_separation_tpu_torch.ops.stft_kernel import stft, stft_plain
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    out = {}
    B, Lp, n_t = 64, 49152 + 512, 385
    xp = (torch.rand((B, Lp), generator=gen, device="cuda") * 2 - 1) * 0.5
    for magnitude in (False, True):
        got = stft(xp, 512, 128, n_t, magnitude)
        ref = stft_plain(xp, 512, 128, n_t, magnitude)
        got, ref = (got, ref) if magnitude else (torch.cat(got), torch.cat(ref))
        err, scale = float((got - ref).abs().max()), float(ref.abs().max())
        tol = TOL["stft_rel"] * scale
        fails.check(err <= tol, f"stft extraction B={B} n_t={n_t} magnitude={magnitude}: "
                                f"max_abs_err {err:.3e} <= {tol:.3e}")
        out["stft_magnitude" if magnitude else "stft_re_im"] = {
            "shape": [B, Lp, n_t], "max_abs_err": err, "tolerance": tol,
            "ms": cuda_ms(lambda: stft(xp, 512, 128, n_t, magnitude), iters=20)}
    T, B, H = 384, 100, 600
    lengths = np.random.default_rng(SEED + 10).integers(282, 377, size=B).tolist()
    args = lstm_inputs(T, B, H, torch.bfloat16, lengths, gen)
    got = lstm_seq_infer(*args, suffix_dirs=(False, True))
    ref = lstm_seq_infer_plain(*args, suffix_dirs=(False, True))
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    fails.check(err <= TOL["lstm_bf16"], f"lstm_infer eval-masks T={T} B={B} H={H} bf16: "
                                         f"max_abs_err {err:.3e} <= {TOL['lstm_bf16']}")
    out["lstm_seq_infer"] = {"shape": [T, B, H], "max_abs_err": err, "tolerance": TOL["lstm_bf16"],
                             "ms": cuda_ms(lambda: lstm_seq_infer(*args, suffix_dirs=(False, True)),
                                           iters=5)}
    return out


def _scp(path: str) -> dict:
    with open(path) as f:
        return dict(line.rstrip("\n").split(" ", 1) for line in f if line.strip())


def feature_err(ref_dir: str, got_dir: str) -> float:
    """The largest max |error| / max |X| over the test features of two data
    dirs (inf when their utterances differ)."""
    ref = _scp(os.path.join(ref_dir, "feats_test.scp"))
    got = _scp(os.path.join(got_dir, "feats_test.scp"))
    if sorted(ref) != sorted(got):
        return float("inf")
    err = 0.0
    for utt, path in ref.items():
        with np.load(path) as a, np.load(got[utt]) as b:
            err = max(err, float(np.max(np.abs(b["mix"] - a["mix"])) / np.max(np.abs(a["mix"]))))
    return err


def _source_sdrs(out_dir: str) -> dict:
    with open(os.path.join(out_dir, "results", "source_SDRs.txt")) as f:
        return {ln.split()[0]: [float(v) for v in ln.split()[1:]] for ln in f}


def check_recipe_outputs(fails: Failures, data_dir: str, out_dir: str, staged: bool) -> dict:
    """The files of one run-eval as the reference writes them: mask npz
    (s1, s2; (F, T) float32; T the utterance's frame count), test features
    (complex64, (F, T)), int16 8 kHz tracks of hop * (T - 1) samples, the
    result files and summary.json. Returns the summary."""
    from scipy.io import wavfile

    from speech_separation_tpu_torch.utils.audio import load_wav
    wav = _scp(os.path.join(data_dir, "wav.scp"))
    frames = {u: 1 + len(load_wav(p)[0]) // 128 for u, p in wav.items()}
    bad = []
    if staged:
        feats = _scp(os.path.join(data_dir, "feats_test.scp"))
        nf = {u: int(v) for u, v in _scp(os.path.join(data_dir, "utt2num_frames")).items()}
        for utt, path in feats.items():
            with np.load(path) as f:
                if f.files != ["mix"] or f["mix"].dtype != np.complex64 \
                        or f["mix"].shape != (257, frames[utt]) or nf[utt] != frames[utt]:
                    bad.append(f"features {utt}")
            with np.load(os.path.join(out_dir, "masks", utt + ".npz")) as m:
                if sorted(m.files) != ["s1", "s2"] or any(
                        m[k].dtype != np.float32 or m[k].shape != (257, frames[utt])
                        or not np.all((m[k] >= 0) & (m[k] <= 1)) for k in m.files):
                    bad.append(f"masks {utt}")
        fails.check(sorted(feats) == sorted(wav), f"features of {len(feats)} utterances")
    for utt in wav:
        for s in ("s1", "s2"):
            path = os.path.join(out_dir, "wav", s, utt + ".wav")
            sr, y = wavfile.read(path) if os.path.isfile(path) else (0, np.zeros(0))
            if sr != 8000 or y.dtype != np.int16 or len(y) != 128 * (frames[utt] - 1):
                bad.append(f"wav {s}/{utt}")
    res = os.path.join(out_dir, "results")
    names = [f"{k}_{m}s.txt" for k in ("session", "source")
             for m in ("SDR", "SIR", "SAR", "SI-SDR", "SI-SDRi")]
    names += [f"{m}_stats.txt" for m in ("SDR", "SIR", "SAR", "SI-SDR", "SI-SDRi")]
    missing = [n for n in names + ["summary.json"] if not os.path.isfile(os.path.join(res, n))]
    with open(os.path.join(res, "summary.json")) as f:
        summary = json.load(f)
    sdrs = _source_sdrs(out_dir)
    fails.check(not bad and not missing and summary["n_utts"] == len(wav)
                and sorted(sdrs) == sorted(wav)
                and all(len(v) == 2 and np.all(np.isfinite(v)) for v in sdrs.values()),
                f"{out_dir}: {len(wav)} utterances' "
                + ("features, masks, " if staged else "") + "tracks and result files as the "
                f"reference writes them (bad {bad[:4]}, missing {missing})")
    return summary


def recipe_phase(fails: Failures, counters) -> dict:
    """Phase 10: the reference's staged recipe through the port's CLI, in
    process: run-train stages 0-2 (2x600 bf16 uPIT, B=100, 5 epochs) and
    run-eval stages 0-4 on the card, then run-eval --on-device-features
    --device-scoring, then the first test utterances' recipe on the card
    against the CPU."""
    from speech_separation_tpu_torch.utils.synthetic import make_synthetic_corpus, write_id_list

    kernels = check_recipe_kernels(fails)
    work = os.path.join(REPO, "build", "chip_smoke_recipe")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        t0 = time.monotonic()
        roots = {}
        for name, n, seed in RECIPE_CORPUS:
            roots[name] = os.path.join(work, "corpus", name)
            ids = make_synthetic_corpus(roots[name], n, min_sec=4.5, max_sec=6.0, seed=SEED + seed,
                                        prefix=name)
            write_id_list("id_lists", name, ids)
            if name == "rtt":
                write_id_list("id_lists", "rtt8", ids[:RECIPE_CPU_UTTS])
                roots["rtt8"] = roots[name]
        with open("id_lists/path.json", "w") as f:
            json.dump(roots, f)
        with open("model.conf", "w") as f:
            f.write(RECIPE_MODEL_CONF)
        with open("zero.conf", "w") as f:
            f.write("zero_init_hidden=1\n")
        corpus_s = time.monotonic() - t0
        print(f"  corpora (mix/s1/s2 wavs of 4.5-6 s): {corpus_s:.1f} s", flush=True)

        walls, launches = {}, {}
        train = StageLog(counters)
        train.run(["run-train", "--arch", "uPIT", "--train-set", "rtr", "--cv-set", "rcv",
                   "--model-config", "model.conf", "--batch-size", "100", "--num-epochs", "5",
                   "--device", "cuda"])
        for name, (wall, counts) in train.spans([
                ("prepare", "(stage 0)"), ("extract rtr", "(stage 1)"),
                ("extract rcv", "-> feats/rtr_train"), ("train", "(stage 2)"),
                ("", "-> feats/rcv_train")]).items():
            if name:
                walls[name], launches[name] = wall, counts
        walls["run-train"] = train.lines[-1][0] - train.lines[0][0]
        exp = "exp/uPIT_rtr"
        for rel in ("final.mdl", "final.state", "conf", "arch.json", "arch.py",
                    "train_stats/train_loss.txt", "train_stats/cv_loss.txt"):
            fails.check(os.path.isfile(os.path.join(exp, rel)), f"run-train wrote {exp}/{rel}")
        with open(os.path.join(exp, "train_stats", "train_loss.txt")) as f:
            losses = [float(ln.split()[1]) for ln in f]
        fails.check(len(losses) == 5 and all(np.isfinite(losses)) and losses[-1] < losses[0],
                    f"run-train epoch losses finite and falling: {losses}")

        ev = StageLog(counters)
        ev.run(["run-eval", "--model-dir", exp, "--test-sets", "rtt", "--batch-size", "100",
                "--nj", "8", "--device", "cuda"])
        for name, (wall, counts) in ev.spans([
                ("prepare rtt", "(stage 0)"), ("extract rtt", "(stage 1)"),
                ("masks", "(stage 2)"), ("reconstruct", "(stage 3)"),
                ("score", "(stage 4)")]).items():
            walls[name], launches[name] = wall, counts
        walls["run-eval"] = ev.lines[-1][0] - ev.lines[0][0]
        staged = check_recipe_outputs(fails, "data/rtt", f"{exp}/output_final/rtt", True)

        # extraction in 4 shards by 4 spawned workers, each opening the card
        # and loading the kernel itself, against the in-process features
        os.makedirs("data_mj/rtt")
        shutil.copy("data/rtt/wav.scp", "data_mj/rtt")
        mj = StageLog(counters)
        mj.run(["extract", "data_mj/rtt", "test", "feats_mj", "--nj", "4", "--mj", "4",
                "--device", "cuda"])
        walls["extract rtt, 4 worker processes"] = mj.lines[-1][0] - mj.lines[0][0]
        mj_err = feature_err("data/rtt", "data_mj/rtt")
        fails.check(mj_err <= RECIPE_TOL["feat_rel"],
                    f"test features of 4 spawned workers against in-process: max_abs_err / "
                    f"max|X| {mj_err:.3e} <= {RECIPE_TOL['feat_rel']}")

        # the fused path into a model dir of its own (its outputs go under it),
        # scored by the float64 device scorer (phase 23 holds it to the host's)
        fused_exp = "exp/uPIT_rtr_fused"
        os.makedirs(fused_exp)
        for name in ("final.mdl", "final.state", "conf"):
            shutil.copy(os.path.join(exp, name), fused_exp)
        fu = StageLog(counters)
        fu.run(["run-eval", "--model-dir", fused_exp, "--test-sets", "rtt", "--batch-size", "100",
                "--nj", "8", "--stage", "1", "--on-device-features", "--device-scoring",
                "--device", "cuda"])
        for name, (wall, counts) in fu.spans([("fused separate", "(stages 1-3 combined)"),
                                              ("fused score", "(stage 4)")]).items():
            walls[name], launches[name] = wall, counts
        fused = check_recipe_outputs(fails, "data/rtt", f"{fused_exp}/output_final/rtt", False)
        d_sdr = abs(staged["mean"]["SDR"] - fused["mean"]["SDR"])
        fails.check(d_sdr <= RECIPE_TOL["fused_mean_sdr_db"],
                    f"mean SDR staged {staged['mean']['SDR']:.4f} vs fused "
                    f"{fused['mean']['SDR']:.4f} dB: {d_sdr:.4f} <= "
                    f"{RECIPE_TOL['fused_mean_sdr_db']}")

        # the first test utterances on the card and on the CPU, zero initial state
        for dev in ("cuda", "cpu"):
            d = f"exp/c8_{dev}"
            os.makedirs(d)
            for name in ("final.mdl", "final.state"):
                shutil.copy(os.path.join(exp, name), d)
            log = StageLog(counters)
            log.run(["run-eval", "--model-dir", d, "--test-sets", "rtt8", "--model-config",
                     "zero.conf", "--batch-size", "8", "--nj", "8", "--data-root",
                     f"data_{dev}", "--featdir", f"feats_{dev}", "--device", dev])
            walls[f"{RECIPE_CPU_UTTS} utterances on {dev}"] = log.lines[-1][0] - log.lines[0][0]
        cpu_cmp = compare_recipe_devices(fails)
        cpu_cmp["spawned_workers_feature_rel_err"] = mj_err
    finally:
        os.chdir(cwd)

    stage_launches = {
        "extract (run-train stage 1)": {k: launches["extract rtr"][k] + launches["extract rcv"][k]
                                        for k in launches["extract rtr"]},
        "train (run-train stage 2)": launches["train"],
        "extract (run-eval stage 1)": launches["extract rtt"],
        "masks (run-eval stage 2)": launches["masks"],
        "reconstruct (run-eval stage 3)": launches["reconstruct"],
        "fused separate (run-eval --on-device-features)": launches["fused separate"],
    }
    for stage, names in (("extract (run-train stage 1)", ["stft"]),
                         ("train (run-train stage 2)", ["lstm_seq_fwd", "lstm_seq_bwd",
                                                        "lstm_seq_infer"]),
                         ("extract (run-eval stage 1)", ["stft"]),
                         ("masks (run-eval stage 2)", ["lstm_seq_infer"]),
                         ("fused separate (run-eval --on-device-features)",
                          ["stft", "lstm_seq_infer"])):
        for name in names:
            n = stage_launches[stage][name]
            fails.check(n > 0, f"{name} launched {n} times in {stage}")
    n = stage_launches["masks (run-eval stage 2)"]["lstm_seq_infer"]
    fails.check(n == 2, f"lstm_seq_infer launched {n} times in masks (2 layers x 1 batch of 100)")
    total = {k: sum(c[k] for c in stage_launches.values()) for k in launches["masks"]}
    print("  stage walls (s): " + ", ".join(f"{k} {v:.2f}" for k, v in walls.items()), flush=True)
    print(f"  staged means: {staged['mean']}", flush=True)
    print(f"  fused means: {fused['mean']}", flush=True)
    print(f"  launches by stage: {stage_launches}", flush=True)
    return {"kernels": kernels, "walls_s": walls, "corpus_s": corpus_s,
            "staged_mean": staged["mean"],
            "fused_mean": fused["mean"], "launches": total, "stage_launches": stage_launches,
            "card_vs_cpu": cpu_cmp, "train_losses": losses}


def compare_recipe_devices(fails: Failures) -> dict:
    """The card's and the CPU's run-eval of the first test utterances:
    features, tracks and SDR (RECIPE_TOL, MIN_SNR_DB)."""
    from speech_separation_tpu_torch.utils.audio import load_wav
    feats = {dev: _scp(f"data_{dev}/rtt8/feats_test.scp") for dev in ("cuda", "cpu")}
    feat_err = feature_err("data_cpu/rtt8", "data_cuda/rtt8")
    fails.check(feat_err <= RECIPE_TOL["feat_rel"],
                f"test features card vs CPU: max_abs_err / max|X| {feat_err:.3e} <= "
                f"{RECIPE_TOL['feat_rel']}")
    snrs = []
    for utt in feats["cpu"]:
        for s in ("s1", "s2"):
            ref = load_wav(f"exp/c8_cpu/output_final/rtt8/wav/{s}/{utt}.wav")[0]
            got = load_wav(f"exp/c8_cuda/output_final/rtt8/wav/{s}/{utt}.wav")[0]
            snrs.append(snr_db(ref, got) if len(ref) == len(got) else -np.inf)
    fails.check(min(snrs) >= MIN_SNR_DB,
                f"reconstructed tracks card vs CPU: SNR min {min(snrs):.1f} dB >= {MIN_SNR_DB}")
    sdr = {dev: _source_sdrs(f"exp/c8_{dev}/output_final/rtt8") for dev in ("cuda", "cpu")}
    d_sdr = max(abs(a - b) for utt in sdr["cpu"] for a, b in zip(sdr["cuda"][utt], sdr["cpu"][utt]))
    fails.check(sorted(sdr["cuda"]) == sorted(sdr["cpu"]) and d_sdr <= RECIPE_TOL["sdr_db"],
                f"each source's SDR card vs CPU: max difference {d_sdr:.4f} dB <= "
                f"{RECIPE_TOL['sdr_db']}")
    return {"feature_rel_err": feat_err, "track_snr_db_min": min(snrs),
            "sdr_max_diff_db": d_sdr}


# --------------------------------------------------------- recurrent archs

# DPRNN's BLSTM shapes (H=128 over 64 channels) at B=32 utterances of 4 s,
# padded to 32768 samples: 4095 encoder frames in 83 chunks of 100, so the
# intra-chunk BLSTM runs 32 * 83 rows of 100 steps and the inter-chunk one
# 32 * 100 rows of 83 steps. name -> (T, rows).
DPRNN_SHAPES = {"intra": (100, 2656), "inter": (83, 3200)}
RSH_KW = {"compute_dtype": "bfloat16"}
DPRNN_KW = {"compute_dtype": "bfloat16"}
# One RSH and one DPRNN training step card against CPU by relative L2 error,
# in bf16 and in f32 (loss; every gradient, and their median; RSH's BN running
# statistics), and their served tracks against the CPU by SNR (set from the
# card's first readings with 20 dB of room: RSH 68.1 dB, DPRNN 43.1 dB). Each
# step bound is derived (NVIDIA H100 80GB HBM3, 700 W): the geometric mean of
# the largest sound reading (card against CPU over weight seeds 0 and 1, RSH
# at S=2 and S=3) and the smallest reading of a fault control against the
# card's step (RSH: the carried state zeroed between passes; DPRNN: block 0's
# intra-chunk forward direction fed time-reversed), so each bound sits as far
# below the fault as above the sound step; never looser than before. Readings
# (sound -> bound <- fault): RSH bf16 loss 2.7e-5 -> 3.3e-5 <- 4.1e-5, worst
# gradient 1.6e-2 -> 2.2e-2 <- 3.0e-2, median 7.7e-3 -> 1.1e-2 <- 1.6e-2, BN
# 7.3e-5 -> 5.6e-4 <- 4.3e-3; RSH f32 loss 1.1e-7 -> 2.5e-6 <- 5.5e-5, worst
# 4.1e-6 -> 3.3e-4 <- 2.6e-2, median 2.0e-6 -> 1.7e-4 <- 1.5e-2, BN 1.6e-7 ->
# 2.6e-5 <- 4.3e-3; DPRNN bf16 loss 1.8e-4 -> 1.7e-3 <- 1.7e-2, worst 6.6e-3 ->
# 6.4e-2 <- 0.62, median 4.6e-3 -> 4.1e-2 <- 0.36; DPRNN f32 loss 1.4e-7 ->
# 4.9e-5 <- 1.7e-2, worst 3.2e-5 -> 4.5e-3 <- 0.62, median 2.0e-5 -> 2.7e-3 <-
# 0.36. In f32 the card's step is the order of sums alone (RSH's carried h and
# c 3.3e-7 after each pass, not growing); in bf16 a value that lands on the
# other side of a rounding boundary moves by a bf16 step, so the zeroed carry
# stands 1.2-1.4x clear of the card's own bf16 gap in the loss and the
# gradients and 7.7x in BN's statistics. K1, K3 and K4 at DPRNN's shapes read
# 1.4e-4, 3.9e-3 and 1.9e-3 against TOL's and TRAIN_TOL's limits; the chained
# gradients 5.6e-3 against TRAIN_TOL["grad_bf16"].
RECURRENT_TOL = {"rsh": {"loss": 3.3e-5, "grad": 2.2e-2, "grad_median": 1.1e-2, "bn": 5.6e-4},
                 "rsh_f32": {"loss": 2.5e-6, "grad": 3.3e-4, "grad_median": 1.7e-4,
                             "bn": 2.6e-5},
                 "dprnn": {"loss": 1.7e-3, "grad": 6.4e-2, "grad_median": 4.1e-2},
                 "dprnn_f32": {"loss": 4.9e-5, "grad": 4.5e-3, "grad_median": 2.7e-3},
                 "rsh_min_snr_db": 48.0, "dprnn_min_snr_db": 23.0}


def ragged_lengths(T: int, B: int, rng) -> list:
    """B lengths as a ragged DPRNN batch gives them: most rows full, an
    eighth drawn from 0..T, and 0, 1, T, 0, 1 in the first five rows."""
    lengths = np.full(B, T)
    k = B // 8
    lengths[:k] = rng.integers(0, T + 1, size=k)
    lengths[:5] = [0, 1, T, 0, 1]
    return lengths.tolist()


def cudnn_lstm_ms(T: int, B: int, n_in: int, H: int, dtype, gen) -> dict:
    """cuDNN's bidirectional nn.LSTM(n_in -> H) at the same T and B, a
    yardstick only (it also does the input projection and its gradient):
    inference, the training forward (median of five repeats) and the
    backward (mean of three after a warm-up)."""
    lstm = torch.nn.LSTM(n_in, H, bidirectional=True).to("cuda", dtype)
    lstm.flatten_parameters()
    x = torch.randn((T, B, n_in), generator=gen, device="cuda").to(dtype)
    with torch.inference_mode():
        infer = cuda_ms(lambda: lstm(x), 5)
    x.requires_grad_(True)
    fwd = [cuda_ms(lambda: lstm(x), 3) for _ in range(5)]
    y, _ = lstm(x)
    gy = torch.randn(y.shape, generator=gen, device="cuda").to(dtype)
    bwd = []
    for i in range(4):
        y, _ = lstm(x)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        y.backward(gy)
        e1.record()
        e1.synchronize()
        if i:
            bwd.append(e0.elapsed_time(e1))
    return {"infer": infer, "fwd": float(np.median(fwd)), "fwd_repeats": median_range(fwd),
            "bwd": float(np.mean(bwd)), "bwd_repeats": median_range(bwd)}


def check_recurrent_kernels(fails: Failures) -> dict:
    """K1, K3 and K4 at DPRNN's two BLSTM shapes (H=128, bf16, thousands of
    rows, length-0 and length-1 rows among them) against their plain
    versions, each launched twice (bit-identical), with its plan, time,
    bound and cuDNN's time; a length-0 row's state passes through every
    kernel exactly. Then lstm_seq's gradients through two chained calls (the
    first's h_last/c_last the second's h0/c0, as RSH carries its state from
    pass to pass) against autograd through the plain forward at T=384,
    B=100, H=600 bf16."""
    from speech_separation_tpu_torch.ops.lstm_kernel import (
        lstm_bwd_plan, lstm_fwd_plan, lstm_seq, lstm_seq_bwd, lstm_seq_bwd_plain,
        lstm_seq_fwd, lstm_seq_fwd_plain, lstm_seq_infer, lstm_seq_infer_plain)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    rng = np.random.default_rng(SEED + 11)
    sfx, dt, H = (False, True), torch.bfloat16, 128
    out = {}
    for shape, (T, B) in DPRNN_SHAPES.items():
        lengths = ragged_lengths(T, B, rng)
        args = lstm_inputs(T, B, H, dt, lengths, gen)
        xw, w, h0, c0, lens = args
        zero = lens == 0
        label = f"DPRNN {shape} T={T} B={B} H={H} bf16"
        runs = {
            "lstm_seq_infer": (lambda: lstm_seq_infer(*args, suffix_dirs=sfx),
                               lambda: lstm_seq_infer_plain(*args, suffix_dirs=sfx)),
            "lstm_seq_fwd": (lambda: lstm_seq_fwd(*args, save_dtype=dt, suffix_dirs=sfx),
                             lambda: lstm_seq_fwd_plain(*args, save_dtype=dt, suffix_dirs=sfx)),
        }
        ref_f = runs["lstm_seq_fwd"][1]()
        bargs = (w, c0, lens, ref_f[1], ref_f[2],
                 torch.randn(ref_f[1].shape, generator=gen, device="cuda").to(dt),
                 torch.randn(c0.shape, generator=gen, device="cuda"),
                 torch.randn(c0.shape, generator=gen, device="cuda"))
        runs["lstm_seq_bwd"] = (lambda: lstm_seq_bwd(*bargs, save_dtype=dt, suffix_dirs=sfx),
                                lambda: lstm_seq_bwd_plain(*bargs, save_dtype=dt,
                                                           suffix_dirs=sfx))
        lib = cudnn_lstm_ms(T, B, 64, H, dt, gen)
        valid_steps = 2 * sum(lengths)
        flops = valid_steps * 2 * H * 4 * H
        nums = {}
        for name, (kernel, plain) in runs.items():
            got, again = kernel(), kernel()
            ref = ref_f if name == "lstm_seq_fwd" else plain()
            torch.cuda.synchronize()
            if name == "lstm_seq_infer":
                err, tol = max(float((g - r).abs().max()) for g, r in zip(got, ref)), TOL["lstm_bf16"]
                state = [(got[1], h0), (got[2], c0)]
            elif name == "lstm_seq_fwd":
                err, tol = max(scaled_err(g, r) for g, r in zip(got, ref)), TRAIN_TOL["fwd_bf16"]
                state = [(got[3], h0), (got[4], c0)]
            else:
                err, tol = max(scaled_err(g, r) for g, r in zip(got, ref)), TRAIN_TOL["bwd_bf16"]
                state = [(got[1], bargs[6]), (got[2], bargs[7])]
            fails.check(err <= tol, f"{name} {label}: max_abs_err {err:.3e} <= {tol}")
            fails.check(all(torch.equal(a, b) for a, b in zip(got, again)),
                        f"{name} {label}: a second launch is bit-identical")
            fails.check(all(torch.equal(s[:, zero], s0[:, zero]) for s, s0 in state),
                        f"{name} {label}: the {int(zero.sum())} length-0 rows' final state "
                        "is their initial one")
            ms = cuda_ms(kernel, 5)
            plain_ms = cuda_ms(plain, 1, warmup=0)
            io = nbytes(*(bargs if name == "lstm_seq_bwd" else args), *got)
            b_ms, b_by = bound_ms(io, flops, dt)
            plan = (lstm_bwd_plan if name == "lstm_seq_bwd" else lstm_fwd_plan)(2, B, H, dt)
            lib_ms = lib[{"lstm_seq_infer": "infer", "lstm_seq_fwd": "fwd",
                          "lstm_seq_bwd": "bwd"}[name]]
            nums[name] = {"max_abs_err": err, "tolerance": tol, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                          "us_per_step": 1e3 * ms / T, **plan_keys(plan)}
            print(f"  {name} {label}: {ms:.3f} ms ({1e3 * ms / T:.2f} us a step; plain "
                  f"{plain_ms:.1f}, cuDNN {lib_ms:.3f}, bound {b_ms:.4f} by {b_by}); "
                  f"{plan_text(plan)}", flush=True)
            del got, again, ref
        print(f"  cuDNN nn.LSTM(64->128, bidirectional) {label}: {lib}", flush=True)
        out[shape] = {"T": T, "rows": B, "length_0_rows": int(zero.sum()), **nums}
        del args, bargs, ref_f
        torch.cuda.empty_cache()
    out["chained"] = check_chained_gradients(fails, gen)
    return out


def check_chained_gradients(fails: Failures, gen) -> dict:
    """Gradients of a loss through two chained lstm_seq calls (K3 forward,
    K4 backward with the second call's dh0/dc0 as the first's non-zero
    dh_last/dc_last) against autograd through the plain forward."""
    from speech_separation_tpu_torch.ops.lstm_kernel import (lstm_seq, lstm_seq_bwd,
                                                             lstm_seq_fwd, lstm_seq_fwd_plain)
    T, B, H, dt, sfx = 384, 100, 600, torch.bfloat16, (False, True)
    lengths = [T, 1] + np.random.default_rng(SEED + 12).integers(1, T + 1, size=B - 2).tolist()
    xa, w, h0, c0, lens = lstm_inputs(T, B, H, dt, lengths, gen)
    xb = (0.5 * torch.randn(xa.shape, generator=gen, device="cuda")).to(dt)
    cot = torch.randn((T, 2, B, H), generator=gen, device="cuda")

    def grads(fwd):
        ts = [t.detach().clone().requires_grad_(True) for t in (xa, xb, w, h0, c0)]
        ys1, h1, c1 = fwd(ts[0], ts[2], ts[3], ts[4])
        ys2, h2, c2 = fwd(ts[1], ts[2], h1, c1)
        (torch.sum(ys1.float() * cot) + torch.sum(ys2.float() ** 2) + torch.sum(torch.sin(h2))
         + 0.1 * torch.sum(c2 ** 2)).backward()
        return [t.grad for t in ts]

    def plain(x, w_, h, c):
        ys, _, _, h_last, c_last = lstm_seq_fwd_plain(x, w_, h, c, lens, dt, sfx)
        return ys, h_last, c_last

    before = (lstm_seq_fwd.launches, lstm_seq_bwd.launches)
    got = grads(lambda x, w_, h, c: lstm_seq(x, w_, h, c, lens, dt, sfx))
    torch.cuda.synchronize()
    launched = (lstm_seq_fwd.launches - before[0], lstm_seq_bwd.launches - before[1])
    ref = grads(plain)
    errs = {n: scaled_err(g, r) for n, g, r in
            zip(("dxw1", "dxw2", "dw_hh", "dh0", "dc0"), got, ref)}
    fails.check(launched == (2, 2) and max(errs.values()) <= TRAIN_TOL["grad_bf16"],
                f"lstm_seq gradients through two chained calls T={T} B={B} H={H} bf16 vs "
                f"autograd through the plain forward ({launched[0]} K3, {launched[1]} K4 "
                f"launches): {', '.join(f'{n} {e:.3e}' for n, e in errs.items())} <= "
                f"{TRAIN_TOL['grad_bf16']}")
    return errs


def quiet(*_):
    pass


def write_feature_set(root: str, n: int, seed: int, prefix: str, counts) -> str:
    """A corpus of n utterances of 4.5-6 s with the speaker counts ``counts``
    in turn (utils/synthetic.make_synthetic_corpus_var, seeded) and its data
    dir with training features extracted on the card (K2, stored npz);
    returns the data dir."""
    from speech_separation_tpu_torch.dsp.extract import extract_features
    from speech_separation_tpu_torch.utils.synthetic import make_synthetic_corpus_var
    corpus, data = os.path.join(root, "corpus"), os.path.join(root, "data")
    ids = make_synthetic_corpus_var(corpus, n, min_sec=4.5, max_sec=6.0, seed=seed,
                                    prefix=prefix, counts=counts)
    os.makedirs(data)
    with open(os.path.join(data, "wav.scp"), "w") as f:
        f.writelines(f"{u} {os.path.join(corpus, 'mix', u + '.wav')}\n" for u in ids)
    extract_features(data, "train", os.path.join(root, "feats"), compress=False, log=quiet,
                     device="cuda")
    return data


def step_counts(data_dir: str, epochs: int, batch_size: int) -> list:
    """The speaker count of each of train()'s steps on an RSH corpus (its
    plan_batches with the trainer's plan)."""
    from speech_separation_tpu_torch.train.data import BatchPlan, FeatureDataset, plan_batches
    ds = FeatureDataset(data_dir)
    plan = BatchPlan(batch_size=batch_size, group_by_num_spk=True, seed=SEED)
    return [int(ds.num_spks[b[0]]) for e in range(epochs)
            for b in plan_batches(ds, plan, e, lengths=ds.num_frames, num_spks=ds.num_spks)]


def train_rsh_phase(fails: Failures, counters) -> dict:
    """Phase 12: a 2x600 bf16 RSH trained through train() on the card at
    B=100 (one speaker count a batch), then 2 steps of the reference's
    mixed batches."""
    from speech_separation_tpu_torch.train.loop import TrainLoopConfig, train

    work = os.path.join(REPO, "build", "chip_smoke_rsh_train")
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.monotonic()
    tr = write_feature_set(os.path.join(work, "tr"), 200, SEED + 12, "tr", (2, 3))
    cv = write_feature_set(os.path.join(work, "cv"), 40, SEED + 13, "cv", (2, 3))
    mixed = write_feature_set(os.path.join(work, "mixed"), 100, SEED + 14, "mx", (1, 2, 3))
    print(f"  corpora and features (200 + 40 of 2/3 speakers, 100 of 1/2/3): "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    exp = os.path.join(work, "exp")
    cfg = TrainLoopConfig(arch="RSH", batch_size=100, num_epochs=5, seed=SEED)
    for c in counters:
        c.launches = 0
    res = train(tr, exp, cfg, cv_data_dir=cv, model_kwargs=RSH_KW, device="cuda",
                log=lambda m: print("  " + m, flush=True))
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    losses = check_trained(fails, res, exp)
    counts = step_counts(tr, 5, 100)
    steps = res["steps"]
    fails.check(len(steps) == 10 and sorted(counts) == [2] * 5 + [3] * 5
                and all(n == 100 for _, n in steps),
                f"{len(steps)} training steps of 100 rows, speaker counts {counts}")
    want = 2 * sum(counts)
    for name in ("lstm_seq_fwd", "lstm_seq_bwd"):
        fails.check(launches[name] == want, f"{name} launched {launches[name]} times while "
                                            f"training (2 layers x S passes a step: {want})")
    fails.check(launches["lstm_seq_infer"] == 2 * (2 + 3),
                f"lstm_seq_infer launched {launches['lstm_seq_infer']} times in the CV pass "
                "(2 layers x (2 + 3) passes)")
    by_s = {S: [m for (m, _), c in zip(steps, counts) if c == S][1:] for S in (2, 3)}
    print(f"  steps after each count's first: S=2 {np.mean(by_s[2]):.2f} ms/step (min "
          f"{min(by_s[2]):.2f}, max {max(by_s[2]):.2f}); S=3 {np.mean(by_s[3]):.2f} "
          f"(min {min(by_s[3]):.2f}, max {max(by_s[3]):.2f}); first step {steps[0][0]:.1f} ms "
          f"(S={counts[0]}); epochs (wall s, steps s): "
          f"{[(round(w, 3), round(st, 3)) for _, w, st in res['epoch_times']]}", flush=True)

    # the reference's mixed batches: 100 utterances of 1, 2 and 3 speakers,
    # two batches of 50, each split into three sub-batches (rows padded to 32)
    for c in counters:
        c.launches = 0
    mres = train(mixed, os.path.join(work, "exp_mixed"),
                 TrainLoopConfig(arch="RSH", batch_size=50, num_epochs=1, seed=SEED,
                                 reference_batching=True),
                 model_kwargs=RSH_KW, device="cuda", log=lambda m: print("  " + m, flush=True))
    torch.cuda.synchronize()
    mixed_launches = {c.__name__: c.launches for c in counters}
    msteps = mres["steps"]
    mloss = mres["epoch_losses"][0][1]
    fails.check(len(msteps) == 2 and all(n == 50 for _, n in msteps) and np.isfinite(mloss),
                f"mixed batches: {len(msteps)} steps of {[n for _, n in msteps]} rows, loss {mloss}")
    for name in ("lstm_seq_fwd", "lstm_seq_bwd"):
        fails.check(mixed_launches[name] == 2 * 2 * (1 + 2 + 3),
                    f"{name} launched {mixed_launches[name]} times in 2 mixed steps "
                    "(2 layers x (1 + 2 + 3) passes a step)")
    print(f"  mixed-batch steps: {[round(m, 2) for m, _ in msteps]} ms", flush=True)
    return {"launches": launches, "ms_per_step": {S: float(np.mean(v)) for S, v in by_s.items()},
            "step_counts": counts, "epoch_losses": losses, "cv_loss": res["cv_losses"],
            "epoch_times": res["epoch_times"], "mixed_launches": mixed_launches,
            "mixed_step_ms": [m for m, _ in msteps], "mixed_loss": mloss,
            "train_dir": tr, "exp": exp}


def grad_errs(got: dict, ref: dict, bound: float) -> dict:
    """Each gradient of ``got`` against ``ref`` by relative L2: the worst, the
    median and how many lie over ``bound``."""
    err = {n: rel_l2(g, ref[n]) for n, g in got.items()}
    worst = max(err, key=err.get)
    return {"worst": worst, "worst_err": err[worst],
            "median_err": float(np.median(list(err.values()))),
            "over_bound": sum(e > bound for e in err.values()), "n": len(err)}


def step_errs(got: dict, ref: dict, tol: dict) -> dict:
    """One training step's results (``model_step`` / ``rsh_step``) against
    another's by relative L2: the loss, the gradients (``grad_errs``
    against ``tol["grad"]``) and, where there are, BN's running
    statistics."""
    out = {"loss_rel_err": rel_l2(got["loss"], ref["loss"]),
           **grad_errs(got["grads"], ref["grads"], tol["grad"])}
    if "bn" in got:
        out["bn_rel_err"] = max(rel_l2(a, b) for a, b in zip(got["bn"], ref["bn"]))
    return out


def check_step(fails: Failures, what: str, e: dict, tol: dict, n_params: int) -> None:
    """A card step against the CPU's (``step_errs``) within ``tol``: the
    loss, every gradient, the median gradient and BN's statistics."""
    fails.check(e["loss_rel_err"] <= tol["loss"],
                f"{what} loss: rel err {e['loss_rel_err']:.3e} <= {tol['loss']}")
    fails.check(e["n"] == n_params and e["over_bound"] == 0
                and e["median_err"] <= tol["grad_median"],
                f"{what} gradients ({e['n']} parameters): worst {e['worst']} rel err "
                f"{e['worst_err']:.3e} <= {tol['grad']}, median {e['median_err']:.3e} <= "
                f"{tol['grad_median']}")
    if "bn_rel_err" in e:
        fails.check(e["bn_rel_err"] <= tol["bn"],
                    f"{what} BN running statistics: rel err {e['bn_rel_err']:.3e} <= "
                    f"{tol['bn']}")


def check_fault(fails: Failures, what: str, e: dict, tol: dict) -> None:
    """A fault control against the card's step (``step_errs``) must fail
    the bounds the card's step is held to: its loss, its median gradient,
    most of its gradients or BN's statistics over them."""
    bn = e.get("bn_rel_err")
    fails.check(e["loss_rel_err"] > tol["loss"] or e["median_err"] > tol["grad_median"]
                or e["over_bound"] > e["n"] // 2 or (bn is not None and bn > tol["bn"]),
                f"{what}: loss rel err {e['loss_rel_err']:.3e} (bound {tol['loss']}); "
                f"median gradient {e['median_err']:.3e} (bound {tol['grad_median']}), worst "
                f"{e['worst']} {e['worst_err']:.3e}, {e['over_bound']} of {e['n']} over "
                f"{tol['grad']}" + (f"; BN {bn:.3e} (bound {tol['bn']})" if bn is not None
                                    else "") + ": caught")


def print_effect(what: str, e: dict) -> None:
    """The sound control: how far bf16 storage itself moves the step (the
    CPU's bf16 step against its f32 step)."""
    print(f"  {what}, bf16 against f32 on the CPU: loss rel err {e['loss_rel_err']:.3e}, "
          f"worst gradient {e['worst']} {e['worst_err']:.3e}, median {e['median_err']:.3e}"
          + (f", BN {e['bn_rel_err']:.3e}" if "bn_rel_err" in e else ""), flush=True)


def rsh_step(model, batch: dict, dev: str, zero_carry: bool = False) -> dict:
    """One RSH training step (rsh.loss_fn) of a copy of ``model`` on ``dev``:
    the loss, every gradient, the assignments, BN's running statistics, each
    pass's share of the loss and the (h, c) each pass hands to the next (read
    by a forward hook). With ``zero_carry`` a pre-hook zeroes the state each
    pass starts from: the fault control."""
    import copy

    from speech_separation_tpu_torch.models import rsh
    m = copy.deepcopy(model).to(dev)
    b = {k: torch.from_numpy(batch[k]).to(dev) for k in ("mix", "sources", "lengths",
                                                         "row_mask")}
    states = []
    m.register_forward_hook(lambda _m, _a, out: states.append(
        tuple(s.detach().cpu() for s in out[1])))
    if zero_carry:
        m.register_forward_pre_hook(lambda _m, a: (*a[:3], *(torch.zeros_like(s)
                                                              for s in a[3:5])))
    t0 = time.monotonic()
    loss, aux = rsh.loss_fn(m, b, None, True)
    loss.backward()
    if dev == "cuda":
        torch.cuda.synchronize()
    ms = (time.monotonic() - t0) * 1e3
    with torch.no_grad():
        B, S = b["sources"].shape[:2]
        idx = aux["assignments"]
        claimed = b["sources"][torch.arange(B, device=dev)[:, None], idx]   # (B, S, T, F)
        err = torch.sum(torch.square(aux["masks"] * b["mix"][:, None] - claimed), dim=(2, 3))
        pass_loss = torch.sum(err * b["row_mask"][:, None], dim=0) / S / aux["norm"]
    return {"ms": ms, "loss": loss.detach().cpu(), "assignments": idx.cpu(),
            "grads": {n: p.grad.cpu() for n, p in m.named_parameters() if p.grad is not None},
            "bn": (m.bn.running_mean.cpu(), m.bn.running_var.cpu()),
            "pass_loss": pass_loss.cpu(), "states": states}


def rsh_step_phase(fails: Failures, train_dir: str) -> dict:
    """Phase 13: one RSH step (2x600, 4 rows of the training corpus, zero
    initial state) at S=2 and S=3 on the card against the CPU, in bf16 and
    in f32: loss, assignments, every gradient, BN's running statistics, and
    each pass's loss and carried (h, c). Controls, on the CPU: the bf16 step
    against the f32 one (printed), and in each dtype the carried state
    zeroed between passes, a fault that must fail that dtype's bounds."""
    from speech_separation_tpu_torch.models import rsh
    from speech_separation_tpu_torch.train.data import (BatchPlan, FeatureDataset,
                                                        make_device_batch)
    from speech_separation_tpu_torch.utils.weights import fold_lstm_biases

    ds = FeatureDataset(train_dir)
    result = {}
    for S in (2, 3):
        idxs = [i for i in range(len(ds)) if ds.num_spks[i] == S][:4]
        batch = make_device_batch([ds.load(i) for i in idxs],
                                  BatchPlan(batch_size=4, time_pad_multiple=128))
        runs, res = {}, {}
        for dtype, key in (("bfloat16", "rsh"), ("float32", "rsh_f32")):
            m = rsh.RSH(rsh.Config.from_kwargs(**{**RSH_KW, "compute_dtype": dtype},
                                               zero_init_hidden="1"))
            m.reset_parameters(torch.Generator().manual_seed(SEED + 15))
            fold_lstm_biases(m.blstm)
            card, cpu = runs[("cuda", key)], runs[("cpu", key)] = (
                rsh_step(m, batch, "cuda"), rsh_step(m, batch, "cpu"))
            fault = runs[("fault", key)] = rsh_step(m, batch, "cpu", zero_carry=True)
            for run in ("cuda", "cpu", "fault"):
                r = runs[(run, key)]
                print(f"  S={S} {dtype} {run} step: {r['ms']:.0f} ms, loss "
                      f"{r['loss'].item():.6f}, passes "
                      f"{[round(x, 6) for x in r['pass_loss'].tolist()]}", flush=True)
            per_pass = [{"loss": rel_l2(card["pass_loss"][p], cpu["pass_loss"][p]),
                         "h": rel_l2(card["states"][p][0], cpu["states"][p][0]),
                         "c": rel_l2(card["states"][p][1], cpu["states"][p][1])}
                        for p in range(S)]
            print(f"  S={S} {dtype} card vs CPU, each pass (loss, carried h, c rel L2): "
                  + "; ".join(f"pass {p + 1}: {e['loss']:.3e}, {e['h']:.3e}, {e['c']:.3e}"
                              for p, e in enumerate(per_pass)), flush=True)
            fails.check(torch.equal(card["assignments"], cpu["assignments"]),
                        f"RSH S={S} {dtype} step card vs CPU: the same greedy assignments")
            e = step_errs(card, cpu, RECURRENT_TOL[key])
            check_step(fails, f"RSH S={S} {dtype} step card vs CPU", e, RECURRENT_TOL[key], 16)
            fe = step_errs(card, fault, RECURRENT_TOL[key])
            check_fault(fails, f"RSH S={S} {dtype} fault control, the carried state zeroed "
                               "between passes", fe, RECURRENT_TOL[key])
            res[dtype] = {**e, "per_pass": per_pass, "fault": fe}
        res["bf16_effect"] = step_errs(runs[("cpu", "rsh")], runs[("cpu", "rsh_f32")],
                                       RECURRENT_TOL["rsh"])
        print_effect(f"RSH S={S}", res["bf16_effect"])
        result[S] = res
    return result


def check_rsh_outputs(fails: Failures, data_dir: str, out_dir: str) -> dict:
    """One RSH run-eval's files: per utterance the masks s1..sS (S from
    utt2num_spk; (257, T) float32) and S int16 tracks of hop * (T - 1)
    samples, and summary.json over every utterance. Returns the summary."""
    from scipy.io import wavfile

    from speech_separation_tpu_torch.utils.audio import load_wav
    wav = _scp(os.path.join(data_dir, "wav.scp"))
    spk = {u: int(v) for u, v in _scp(os.path.join(data_dir, "utt2num_spk")).items()}
    bad = []
    for utt, path in wav.items():
        frames = 1 + len(load_wav(path)[0]) // 128
        keys = [f"s{k + 1}" for k in range(spk[utt])]
        with np.load(os.path.join(out_dir, "masks", utt + ".npz")) as m:
            if sorted(m.files) != keys or any(m[k].dtype != np.float32
                                              or m[k].shape != (257, frames) for k in keys):
                bad.append(f"masks {utt}")
        for k in keys:
            p = os.path.join(out_dir, "wav", k, utt + ".wav")
            sr, y = wavfile.read(p) if os.path.isfile(p) else (0, np.zeros(0))
            if sr != 8000 or y.dtype != np.int16 or len(y) != 128 * (frames - 1):
                bad.append(f"wav {k}/{utt}")
    with open(os.path.join(out_dir, "results", "summary.json")) as f:
        summary = json.load(f)
    fails.check(not bad and summary["n_utts"] == len(wav)
                and all(np.isfinite(v) for v in summary["mean"].values()),
                f"{out_dir}: {len(wav)} utterances' masks of S passes, S tracks each and "
                f"finite means (counts {sorted(set(spk.values()))}; bad {bad[:4]})")
    return summary


def rsh_eval_phase(fails: Failures, counters, exp: str) -> dict:
    """Phase 14: run-eval stages 0-4 through the CLI with phase 12's RSH on
    100 test utterances of 2 and 3 speakers (masks of S passes with K1 in
    batches of one count), then SeparationServer requests asking for 3, 2
    and 3 sources, one request's tracks held against the CPU by SNR."""
    from speech_separation_tpu_torch.dsp.stft import istft_output_length, num_frames
    from speech_separation_tpu_torch.eval.pipeline import SeparationPipeline
    from speech_separation_tpu_torch.utils.audio import limit_peak, load_wav, write_wav_int16
    from speech_separation_tpu_torch.utils.synthetic import make_synthetic_corpus_var, write_id_list

    work = os.path.join(REPO, "build", "chip_smoke_rsh_eval")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "exp", "RSH"))
    for name in ("final.mdl", "final.state"):
        shutil.copy(os.path.join(exp, name), os.path.join(work, "exp", "RSH"))
    cwd = os.getcwd()
    os.chdir(work)
    try:
        root = os.path.join(work, "corpus", "rtt")
        ids = make_synthetic_corpus_var(root, 100, min_sec=4.5, max_sec=6.0, seed=SEED + 16,
                                        prefix="rtt", counts=(2, 3))
        write_id_list("id_lists", "rtt", ids)
        with open("id_lists/path.json", "w") as f:
            json.dump({"rtt": root}, f)
        ev = StageLog(counters)
        ev.run(["run-eval", "--model-dir", "exp/RSH", "--test-sets", "rtt", "--batch-size",
                "100", "--nj", "8", "--device", "cuda"])
        spans = ev.spans([("prepare", "(stage 0)"), ("extract", "(stage 1)"),
                          ("masks", "(stage 2)"), ("reconstruct", "(stage 3)"),
                          ("score", "(stage 4)")])
        walls = {k: w for k, (w, _) in spans.items()}
        launches = {k: c for k, (_, c) in spans.items()}
        summary = check_rsh_outputs(fails, "data/rtt", "exp/RSH/output_final/rtt")
    finally:
        os.chdir(cwd)
    n = launches["masks"]["lstm_seq_infer"]
    fails.check(n == 2 * (2 + 3), f"lstm_seq_infer launched {n} times in masks (2 layers x "
                                  "(2 + 3) passes: one batch of each count)")
    fails.check(launches["extract"]["stft"] > 0,
                f"stft launched {launches['extract']['stft']} times in extract")
    print(f"  stage walls (s): {', '.join(f'{k} {v:.2f}' for k, v in walls.items())}",
          flush=True)
    print(f"  means: {summary['mean']}", flush=True)

    mdl = os.path.join(work, "exp", "RSH", "final.mdl")
    kw = {"zero_init_hidden": "1"}
    pipe = SeparationPipeline(mdl, model_kwargs=kw, batch_size=16, seed=SEED, device="cuda")
    fails.check(pipe.arch.NAME == "RSH" and pipe.cfg.compute_dtype == "bfloat16",
                f"the .state meta gives {pipe.arch.NAME} {pipe.cfg}")
    rng = np.random.default_rng(SEED + 17)
    wavs = []
    for k, sec in enumerate((3.0, 5.5, 8.0, 6.2)):
        path = os.path.join(work, f"mix{k}.wav")
        write_wav_int16(path, 8000, mixture(int(sec * 8000), rng))
        wavs.append(path)
    replies, serve_launches, wall_ms = serve_requests(
        fails, pipe, work, wavs, ([0], [1, 2], [3]), counters,
        lambda n: istft_output_length(num_frames(n, 128), 128), num_spks=(3, 2, 3))
    fails.check(serve_launches["lstm_seq_infer"] > 0,
                f"lstm_seq_infer launched {serve_launches['lstm_seq_infer']} times while serving")
    cpu = SeparationPipeline(mdl, model_kwargs=kw, batch_size=16, seed=SEED, device="cpu")
    x = load_wav(wavs[0])[0]
    ref = limit_peak(cpu.separate([x], 3)[0])
    snrs = [snr_db(np.asarray(r, np.float32) * (32767 / 32768), load_wav(p)[0])
            for r, p in zip(ref, replies["r1"]["outputs"][wavs[0]])]
    fails.check(len(snrs) == 3 and min(snrs) >= RECURRENT_TOL["rsh_min_snr_db"],
                f"r1's 3 tracks vs CPU plain versions: SNR {', '.join(f'{v:.1f}' for v in snrs)} "
                f"dB >= {RECURRENT_TOL['rsh_min_snr_db']}")
    return {"walls_s": walls, "launches": {k: launches[k] for k in ("extract", "masks")},
            "mean": summary["mean"], "serve_launches": serve_launches,
            "request_ms": {k: v.get("ms") for k, v in replies.items()}, "snr_db": snrs}


def train_dprnn_phase(fails: Failures, counters) -> dict:
    """Phase 15: DPRNN at the JAX package's defaults in bf16 (6 blocks, 64
    channels, H=128 BLSTMs, chunks of 100) trained through train() at B=32
    on 4 s wavs with --on-device-features, 5 epochs (10 steps, CV at 5)."""
    from speech_separation_tpu_torch.eval.pipeline import SeparationPipeline
    from speech_separation_tpu_torch.train.loop import TrainLoopConfig, train
    from speech_separation_tpu_torch.utils.audio import load_wav

    work = os.path.join(REPO, "build", "chip_smoke_dprnn_train")
    shutil.rmtree(work, ignore_errors=True)
    rng = np.random.default_rng(SEED + 18)
    t0 = time.monotonic()
    tr = write_wav_corpus(os.path.join(work, "tr"), 64, rng, "tr")
    cv = write_wav_corpus(os.path.join(work, "cv"), 16, rng, "cv")
    print(f"  corpus: {time.monotonic() - t0:.1f} s", flush=True)
    exp = os.path.join(work, "exp")
    cfg = TrainLoopConfig(arch="DPRNN", batch_size=32, num_epochs=5, seed=SEED,
                          on_device_features=True)
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    res = train(tr, exp, cfg, cv_data_dir=cv, model_kwargs=DPRNN_KW, device="cuda",
                log=lambda m: print("  " + m, flush=True))
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = check_trained(fails, res, exp)
    steps = res["steps"]
    fails.check(len(steps) == 10 and all(n == 32 for _, n in steps),
                f"{len(steps)} training steps of 32 rows")
    # 6 blocks x (intra, inter) BLSTMs: each step runs each one's training
    # forward and backward once, the CV batch its inference forward
    for name, want in (("lstm_seq_fwd", 120), ("lstm_seq_bwd", 120), ("lstm_seq_infer", 12)):
        fails.check(launches[name] == want,
                    f"{name} launched {launches[name]} times (12 BLSTMs x "
                    f"{'1 CV batch' if name == 'lstm_seq_infer' else '10 steps'})")
    ms = [m for m, _ in steps[1:]]
    print(f"  steps after the first: {np.mean(ms):.2f} ms/step (min {min(ms):.2f}, max "
          f"{max(ms):.2f}); first step {steps[0][0]:.1f} ms; peak memory {peak_gb:.2f} GB; "
          f"epochs (wall s, steps s): "
          f"{[(round(w, 3), round(st, 3)) for _, w, st in res['epoch_times']]}", flush=True)
    pipe = SeparationPipeline(os.path.join(exp, "final.mdl"), device="cuda")
    x = load_wav(os.path.join(work, "cv", "corpus", "mix", "cv0000.wav"))[0]
    tracks = pipe.separate([x])[0]
    fails.check(len(tracks) == 2 and all(len(t) == len(x) and np.all(np.isfinite(t))
                                         for t in tracks),
                "final.mdl separates a wav on the card into finite tracks")
    return {"launches": launches, "ms_per_step": float(np.mean(ms)), "epoch_losses": losses,
            "cv_loss": res["cv_losses"], "epoch_times": res["epoch_times"],
            "peak_memory_gb": peak_gb, "train_dir": tr}


def model_step(model, dev: str, make_batch, loss_fn, prepare=None) -> dict:
    """One training step of a copy of ``model`` on ``dev`` (``prepare`` may
    register hooks on the copy first): the loss, every gradient, its ms."""
    import copy
    m = copy.deepcopy(model).to(dev)
    if prepare is not None:
        prepare(m)
    b = make_batch(dev)
    t0 = time.monotonic()
    loss, _ = loss_fn(m, b, None, True)
    loss.backward()
    if dev == "cuda":
        torch.cuda.synchronize()
    return {"ms": (time.monotonic() - t0) * 1e3, "loss": loss.detach().cpu(),
            "grads": {n: p.grad.cpu() for n, p in m.named_parameters() if p.grad is not None}}


def reversed_within(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, T, ...) rows reversed in time within each row's length."""
    t = torch.arange(x.shape[1], device=x.device)[None, :]
    n = lengths.to(torch.long)[:, None]
    idx = torch.where(t < n, n - 1 - t, t)
    return torch.gather(x, 1, idx.view(*idx.shape, *[1] * (x.dim() - 2)).expand_as(x))


def reverse_forward_direction(blstm) -> None:
    """The fault control of the DPRNN step: ``blstm``'s forward direction is
    fed its rows time-reversed (within each row's length), the reverse
    direction as before. A forward hook runs the BLSTM again on the reversed
    rows and puts that run's forward half, turned back, in place of the
    forward half."""
    def hook(mod, args, kwargs, out):
        x, lengths, *rest = args
        y_rev, _ = mod.forward(reversed_within(x, lengths), lengths, *rest, **kwargs)
        y, state = out
        H = mod.hidden
        return torch.cat([reversed_within(y_rev[..., :H], lengths), y[..., H:]], dim=-1), state
    blstm.register_forward_hook(hook, with_kwargs=True)


def dprnn_step_phase(fails: Failures, train_dir: str) -> dict:
    """Phase 16: one DPRNN step (B=4 of the training corpus) on the card
    against the CPU, in bf16 and in f32: loss and every gradient. Controls,
    on the CPU: the bf16 step against the f32 one (printed), and in each
    dtype block 0's intra-chunk BLSTM with its forward direction fed
    time-reversed, a fault that must fail that dtype's bounds."""
    from speech_separation_tpu_torch.dsp.stft import STFTConfig
    from speech_separation_tpu_torch.models import dprnn
    from speech_separation_tpu_torch.train.wav_data import (WavDataset, audio_to_wave_batch,
                                                            collate_wav_batch)
    shipped = collate_wav_batch(WavDataset(train_dir), list(range(4)), 4)

    def make_batch(dev):
        return audio_to_wave_batch({k: torch.from_numpy(shipped[k]).to(dev) for k in
                                    ("audio", "sample_lengths", "row_mask")}, STFTConfig())

    def fault(m):
        reverse_forward_direction(m.blocks[0]["intra_rnn"])

    result, cpu_runs = {}, {}
    for dtype, key in (("bfloat16", "dprnn"), ("float32", "dprnn_f32")):
        model = dprnn.DPRNN(dprnn.Config.from_kwargs(**{**DPRNN_KW, "compute_dtype": dtype}),
                            torch.Generator().manual_seed(SEED + 19))
        card = model_step(model, "cuda", make_batch, dprnn.loss_fn)
        cpu = cpu_runs[dtype] = model_step(model, "cpu", make_batch, dprnn.loss_fn)
        bad = model_step(model, "cpu", make_batch, dprnn.loss_fn, fault)
        for run, r in (("cuda", card), ("cpu", cpu), ("fault", bad)):
            print(f"  {dtype} {run} step, B=4: {r['ms']:.0f} ms, loss {r['loss'].item():.6f}",
                  flush=True)
        e = step_errs(card, cpu, RECURRENT_TOL[key])
        check_step(fails, f"DPRNN {dtype} step card vs CPU", e, RECURRENT_TOL[key],
                   len(list(model.parameters())))
        fe = step_errs(card, bad, RECURRENT_TOL[key])
        check_fault(fails, f"DPRNN {dtype} fault control, block 0's intra-chunk forward "
                           "direction fed time-reversed", fe, RECURRENT_TOL[key])
        result[dtype] = {**e, "fault": fe}
    result["bf16_effect"] = step_errs(cpu_runs["bfloat16"], cpu_runs["float32"],
                                      RECURRENT_TOL["dprnn"])
    print_effect("DPRNN", result["bf16_effect"])
    return result


def serve_dprnn_phase(fails: Failures, counters) -> dict:
    """Phase 17: the full-width bf16 DPRNN (random weights from the seed)
    in SeparationServer, three requests of 3, 5.5 and 8 s: batches padded
    with 1-sample rows, whose chunks past the first lie wholly in padding;
    the three mixtures as one ragged batch on the card against the CPU."""
    from speech_separation_tpu_torch.eval.pipeline import SeparationPipeline
    from speech_separation_tpu_torch.models import dprnn
    from speech_separation_tpu_torch.train.checkpoint import save_checkpoint
    from speech_separation_tpu_torch.utils.audio import load_wav, write_wav_int16

    work = os.path.join(REPO, "build", "chip_smoke_dprnn_serve")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    model = dprnn.DPRNN(dprnn.Config.from_kwargs(**DPRNN_KW),
                        torch.Generator().manual_seed(SEED + 20))
    mdl = os.path.join(work, "dprnn.mdl")
    save_checkpoint(mdl, model, meta={"arch": "DPRNN", "model_kwargs": DPRNN_KW})
    rng = np.random.default_rng(SEED + 21)
    wavs = []
    for k, sec in enumerate((3.0, 5.5, 8.0)):
        path = os.path.join(work, f"mix{k}.wav")
        write_wav_int16(path, 8000, mixture(int(sec * 8000), rng))
        wavs.append(path)
    pipe = SeparationPipeline(mdl, batch_size=16, seed=SEED, device="cuda")
    fails.check(pipe.arch.NAME == "DPRNN", f"the .state meta gives {pipe.arch.NAME} {pipe.cfg}")
    replies, launches, wall_ms = serve_requests(fails, pipe, work, wavs, ([0], [1], [2]),
                                                counters, lambda n: n)
    fails.check(launches["lstm_seq_infer"] > 0 and launches["lstm_seq_infer"] % 12 == 0,
                f"lstm_seq_infer launched {launches['lstm_seq_infer']} times while serving "
                "(12 a batch)")
    xs = [load_wav(w)[0] for w in wavs]
    for c in counters:
        c.launches = 0
    got = pipe.separate(xs)
    ragged_launches = {c.__name__: c.launches for c in counters}
    ref = SeparationPipeline(mdl, batch_size=16, seed=SEED, device="cpu").separate(xs)
    snrs = [snr_db(np.asarray(r), np.asarray(g)) for rs, gs in zip(ref, got)
            for r, g in zip(rs, gs)]
    fails.check(ragged_launches["lstm_seq_infer"] == 12 and min(snrs) >= RECURRENT_TOL[
        "dprnn_min_snr_db"],
                f"3 s, 5.5 s and 8 s as one ragged batch ({ragged_launches['lstm_seq_infer']} "
                f"K1 launches) vs CPU plain versions: SNR min {min(snrs):.1f} dB >= "
                f"{RECURRENT_TOL['dprnn_min_snr_db']}")
    return {"launches": launches, "request_ms": {k: v.get("ms") for k, v in replies.items()},
            "wall_ms": wall_ms, "snr_db": snrs}


# ------------------------------------------------------------------ remat

# remat against no remat on the card (phase 18): the same step with the
# forward recomputed in the backward, on the same weights, batch and initial
# state. Only the order of a few sums may differ (the scatter-add behind the
# permutation gather's backward runs on atomics), so each is held to the
# step's own rerun noise, the plain step run twice, with a floor of 1e-6 rel
# L2 (a few f32 roundings, 6e-8 each, of a reordered sum).
REMAT_FLOOR = 1e-6


def remat_phase(fails: Failures, counters, train_dir: str) -> dict:
    """Phase 18: a 2x600 bf16 uPIT step and an RSH step (S=2) at B=100,
    T=384 with remat=1 against remat=0: loss, every gradient, BN's running
    statistics, each step's peak memory above the resident model and batch,
    and the training kernels' launches."""
    import copy

    from speech_separation_tpu_torch.models import rsh, upit
    from speech_separation_tpu_torch.train.data import (BatchPlan, FeatureDataset,
                                                        make_device_batch)
    from speech_separation_tpu_torch.utils.weights import fold_lstm_biases

    ds = FeatureDataset(train_dir)
    batch = make_device_batch([ds.load(i) for i in range(100)],
                              BatchPlan(batch_size=100, time_pad_multiple=128))
    b = {k: torch.from_numpy(batch[k]).cuda() for k in ("mix", "sources", "lengths",
                                                           "row_mask")}
    fails.check(tuple(b["mix"].shape[:2]) == (100, 384), f"remat batch {tuple(b['mix'].shape)}")
    out = {}
    for arch, mod in (("uPIT", upit), ("RSH", rsh)):
        base = mod.Model(mod.Config(compute_dtype="bfloat16"))
        base.reset_parameters(torch.Generator().manual_seed(SEED + 22))
        fold_lstm_biases(base.blstm)
        base.cuda()

        def step(remat: bool):
            m = copy.deepcopy(base)
            m.cfg = mod.Config(compute_dtype="bfloat16", remat=remat)
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            for c in counters:
                c.launches = 0
            t0 = time.perf_counter()
            # the same N(0, 1) initial state each time, drawn on the card
            loss, _ = mod.loss_fn(m, b, torch.Generator(device="cuda").manual_seed(SEED), True)
            loss.backward()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            return {"loss": loss.detach(), "ms": ms,
                    "grads": {n: p.grad for n, p in m.named_parameters() if p.grad is not None},
                    "bn": torch.cat([m.bn.running_mean, m.bn.running_var]),
                    "launches": {c.__name__: c.launches for c in counters},
                    "peak_gb": (torch.cuda.max_memory_allocated() - resident) / 1e9}

        # warm-ups: cuBLAS handles, the allocator, checkpoint's first call
        # (6.4 s on the card)
        step(False), step(True)
        plain, rerun, remat = step(False), step(False), step(True)

        def errs(a, c):
            g = {n: rel_l2(a["grads"][n], c["grads"][n]) for n in c["grads"]}
            return {"loss": rel_l2(a["loss"], c["loss"]), "grad": max(g.values()),
                    "bn": rel_l2(a["bn"], c["bn"]), "n_grads": len(g)}

        noise, err = errs(rerun, plain), errs(remat, plain)
        for k in ("loss", "grad", "bn"):
            bound = max(REMAT_FLOOR, 2 * noise[k])
            fails.check(err[k] <= bound,
                        f"{arch} remat vs plain {k}: rel err {err[k]:.3e} <= {bound:.1e} "
                        f"(rerun noise {noise[k]:.3e})")
        fails.check(err["n_grads"] == len(remat["grads"]) == 16,
                    f"{arch}: {err['n_grads']} gradients compared")
        S = 2 if arch == "RSH" else 1
        for name, plain_n, remat_n in (("lstm_seq_fwd", 2 * S, 4 * S),
                                       ("lstm_seq_bwd", 2 * S, 2 * S)):
            fails.check(plain["launches"][name] == plain_n and remat["launches"][name] == remat_n,
                        f"{arch} {name} launched {plain['launches'][name]} times without remat "
                        f"(want {plain_n}), {remat['launches'][name]} with (want {remat_n}: "
                        "the recompute runs the forward again)")
        print(f"  {arch}: step {plain['ms']:.1f} ms, peak {plain['peak_gb']:.2f} GB above the "
              f"resident model and batch; remat step {remat['ms']:.1f} ms, peak "
              f"{remat['peak_gb']:.2f} GB", flush=True)
        out[arch] = {"plain": {k: plain[k] for k in ("ms", "peak_gb", "launches")},
                     "remat": {k: remat[k] for k in ("ms", "peak_gb", "launches")},
                     "rel_err": err, "rerun_noise": noise}
        del base, plain, rerun, remat
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------ TCN and Conv-TasNet

# The full-width bf16 TCN and Conv-TasNet on the card against the CPU (plain
# PyTorch, same weights and inputs): a training step's loss and each
# gradient by relative L2, as the other card-against-CPU steps hold them;
# served tracks by SNR. The trunks store bf16, so a value on the other side
# of a bf16 rounding boundary moves by one bf16 step (3.9e-3 relative) and
# the blocks carry it on: 1e-3 for the loss (a mean over every frame), and
# 30 dB for served tracks (one bf16 step is 48 dB below the signal). The
# gradient bound, 6e-2, sits between the sound readings and a fault's (an
# H100, 700 W): card against CPU, the worst gradient 2.5e-2 (TCN
# blocks.5.prelu1) and 4.3e-2 (Conv-TasNet in_ln.g, a per-channel gain
# whose gradient sums every frame and cancels); the same weights in f32 on
# the CPU, 3.0e-2 and 5.7e-2; the first block's depthwise kernel reversed
# in time, the median gradient 8.2e-2 (TCN) and 2.2 (Conv-TasNet). The same
# step in f32 on the card against f32 on the CPU moves by the order of sums
# alone, so a fault smaller than bf16's own effect shows there; its bounds are
# derived as RECURRENT_TOL's (the geometric mean of the largest sound reading,
# TCN and Conv-TasNet at weight seeds 0 and 1, and the smallest reading of the
# same fault in f32): loss 2.9e-7 -> 1.2e-5 <- 4.5e-4, worst gradient 6.1e-4
# -> 9.8e-3 <- 0.16, median 2.5e-4 -> 4.2e-3 <- 7.0e-2. Each step runs the
# controls and checks that each dtype's fault fails that dtype's bounds.
TCN_KW = {"compute_dtype": "bfloat16"}
CONVTASNET_KW = {"compute_dtype": "bfloat16"}
CONV_TOL = {"step": {"loss": 1e-3, "grad": 6e-2, "grad_median": 6e-2},
            "step_f32": {"loss": 1.2e-5, "grad": 9.8e-3, "grad_median": 4.2e-3},
            "min_snr_db": 30.0}


def step_controls(model, cfg_cls, kw: dict) -> dict:
    """The card-against-CPU step's other models, same weights: the f32
    compute model (``f32``: the f32 step's, and in bf16 the sound control),
    and each dtype's fault, the first block's depthwise kernel reversed in
    time, a convolution where the reference cross-correlates (``fault``,
    ``fault_f32``: most gradients must fail the bound)."""
    out = {}
    for key, dtype, fault in (("f32", "float32", False), ("fault", kw["compute_dtype"], True),
                              ("fault_f32", "float32", True)):
        m = type(model)(cfg_cls.from_kwargs(**{**kw, "compute_dtype": dtype}))
        m.load_state_dict(model.state_dict())
        if fault:
            with torch.no_grad():
                m.blocks[0].dw.copy_(m.blocks[0].dw.flip(0))
        out[key] = m
    return out


def card_vs_cpu_step(fails: Failures, what: str, model, controls: dict, loss_fn,
                     make_batch) -> dict:
    """One training step of ``model`` (bf16) on the card and on the CPU
    (plain versions) on the same batch, the loss and every gradient by
    relative L2 within CONV_TOL["step"]; then the same in f32
    (``controls["f32"]``) within CONV_TOL["step_f32"]. The CPU's bf16 step
    against its f32 one is printed (the bf16 effect); each dtype's fault
    control must fail that dtype's bounds."""
    runs = {"cuda": (model, "cuda"), "cpu": (model, "cpu"), "fault": (controls["fault"], "cpu"),
            "cuda f32": (controls["f32"], "cuda"), "cpu f32": (controls["f32"], "cpu"),
            "fault f32": (controls["fault_f32"], "cpu")}
    out = {}
    for run, (m, dev) in runs.items():
        out[run] = model_step(m, dev, make_batch, loss_fn)
        print(f"  {what} {run} step: {out[run]['ms']:.0f} ms, loss "
              f"{out[run]['loss'].item():.6f}", flush=True)
    # the last block's residual projection feeds nothing: no gradient
    n_params = len(list(model.parameters())) - 2
    result = {}
    for sfx, key in (("", "step"), (" f32", "step_f32")):
        tol = CONV_TOL[key]
        e = step_errs(out["cuda" + sfx], out["cpu" + sfx], tol)
        check_step(fails, f"{what}{sfx} step card vs CPU", e, tol, n_params)
        fe = step_errs(out["cuda" + sfx], out["fault" + sfx], tol)
        check_fault(fails, f"{what}{sfx} fault control, blocks.0.dw reversed", fe, tol)
        result["bfloat16" if not sfx else "float32"] = {**e, "fault": fe}
    result["bf16_effect"] = step_errs(out["cpu"], out["cpu f32"], CONV_TOL["step"])
    print_effect(what, result["bf16_effect"])
    return result


def served_against_cpu(fails: Failures, what: str, pipe, mdl: str, xs: list) -> list:
    """The three mixtures as one ragged batch on the card against the same
    pipeline on the CPU, by SNR."""
    from speech_separation_tpu_torch.eval.pipeline import SeparationPipeline
    got = pipe.separate(xs)
    ref = SeparationPipeline(mdl, batch_size=16, seed=SEED, device="cpu").separate(xs)
    snrs = [snr_db(np.asarray(r), np.asarray(g)) for rs, gs in zip(ref, got)
            for r, g in zip(rs, gs)]
    fails.check(min(snrs) >= CONV_TOL["min_snr_db"],
                f"{what}: 3 s, 5.5 s and 8 s as one batch vs CPU plain versions: SNR min "
                f"{min(snrs):.1f} dB >= {CONV_TOL['min_snr_db']}")
    return snrs


def write_mixtures(work: str, seed: int) -> list:
    from speech_separation_tpu_torch.utils.audio import write_wav_int16
    rng = np.random.default_rng(seed)
    wavs = []
    for k, sec in enumerate((3.0, 5.5, 8.0)):
        path = os.path.join(work, f"mix{k}.wav")
        write_wav_int16(path, 8000, mixture(int(sec * 8000), rng))
        wavs.append(path)
    return wavs


def tcn_phase(fails: Failures, stft_counter, train_dir: str, wav_dir: str) -> dict:
    """Phase 19: the JAX package's default TCN (257 -> 256 channels, hidden
    512, 8 x 4 blocks) in bf16: train() at B=100 on phase 5's npz corpus
    (T=384), 10 epochs; 2 steps of train --on-device-features on phase 8's
    wavs (K2 a step); one step card against CPU; three served requests."""
    from speech_separation_tpu_torch.dsp.stft import istft_output_length, num_frames
    from speech_separation_tpu_torch.eval.pipeline import SeparationPipeline
    from speech_separation_tpu_torch.models import tcn
    from speech_separation_tpu_torch.train.checkpoint import save_checkpoint
    from speech_separation_tpu_torch.train.data import (BatchPlan, FeatureDataset,
                                                        make_device_batch)
    from speech_separation_tpu_torch.train.loop import TrainLoopConfig, train
    from speech_separation_tpu_torch.utils.audio import load_wav

    work = os.path.join(REPO, "build", "chip_smoke_tcn")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    torch.cuda.empty_cache()
    n_params = sum(p.numel() for p in tcn.TCN(tcn.Config()).parameters())
    exp = os.path.join(work, "exp")
    torch.cuda.reset_peak_memory_stats()
    res = train(train_dir, exp, TrainLoopConfig(arch="TCN", batch_size=100, num_epochs=10,
                                                seed=SEED),
                cv_data_dir=os.path.join(os.path.dirname(train_dir), "cv"),
                model_kwargs=TCN_KW, device="cuda", log=lambda m: print("  " + m, flush=True))
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # Adam at the reference's 1e-3 from a random 13M-parameter init: the
    # epoch losses rise over epochs 2-4 and are back at epoch 1's by epoch 5
    # (3.77, 4.08, 4.59, 4.39, 3.81 on the card), so 10 epochs
    losses = check_trained(fails, res, exp, epochs=10)
    steps = res["steps"]
    full = [m for m, n in steps[1:] if n == 100]
    fails.check(len(steps) == 20 and len(full) == 9, f"{len(steps)} training steps")
    ms_per_step = float(np.mean(full))
    print(f"  {n_params} parameters; full-batch steps after the first: {ms_per_step:.2f} "
          f"ms/step (min {min(full):.2f}, max {max(full):.2f}); first step "
          f"{steps[0][0]:.1f} ms; peak memory {peak_gb:.2f} GB; epochs (wall s, steps s): "
          f"{[(round(w, 3), round(st, 3)) for _, w, st in res['epoch_times']]}", flush=True)
    del res
    torch.cuda.empty_cache()

    # the waveform-direct input: K2 makes each batch's features on the card
    stft_counter.launches = 0
    wres = train(wav_dir, os.path.join(work, "exp_wav"),
                 TrainLoopConfig(arch="TCN", batch_size=32, num_epochs=1, seed=SEED,
                                 on_device_features=True),
                 model_kwargs=TCN_KW, device="cuda", log=quiet)
    torch.cuda.synchronize()
    train_k2 = stft_counter.launches
    wloss = wres["epoch_losses"][0][1]
    fails.check(len(wres["steps"]) == 2 and np.isfinite(wloss) and train_k2 == 2,
                f"TCN --on-device-features: {len(wres['steps'])} steps, loss {wloss:.4f}, "
                f"K2 launched {train_k2} times (one a step)")
    del wres

    ds = FeatureDataset(train_dir)
    fbatch = make_device_batch([ds.load(i) for i in range(8)],
                               BatchPlan(batch_size=8, time_pad_multiple=128))
    model = tcn.TCN(tcn.Config.from_kwargs(**TCN_KW), torch.Generator().manual_seed(SEED + 23))
    step = card_vs_cpu_step(
        fails, "TCN", model, step_controls(model, tcn.Config, TCN_KW), tcn.loss_fn,
        lambda dev: {k: torch.from_numpy(fbatch[k]).to(dev)
                     for k in ("mix", "sources", "lengths", "row_mask")})

    mdl = os.path.join(work, "tcn.mdl")
    save_checkpoint(mdl, model, meta={"arch": "TCN", "model_kwargs": TCN_KW})
    wavs = write_mixtures(work, SEED + 24)
    pipe = SeparationPipeline(mdl, batch_size=16, seed=SEED, device="cuda")
    fails.check(pipe.arch.NAME == "TCN" and pipe.cfg.compute_dtype == "bfloat16",
                f"the .state meta gives {pipe.arch.NAME} {pipe.cfg}")
    replies, launches, wall_ms = serve_requests(
        fails, pipe, work, wavs, ([0], [1], [2]), [stft_counter],
        lambda n: istft_output_length(num_frames(n, 128), 128))
    # one K2 launch a served batch: r1 alone, r2 and r3 together or apart
    fails.check(launches["stft"] in (2, 3),
                f"stft launched {launches['stft']} times for 3 requests (one a batch)")
    snrs = served_against_cpu(fails, "TCN", pipe, mdl, [load_wav(w)[0] for w in wavs])
    return {"params": n_params, "ms_per_step": ms_per_step, "peak_memory_gb": peak_gb,
            "epoch_losses": losses, "train_k2_launches": train_k2, "step": step,
            "serve_launches": launches, "wall_ms": wall_ms,
            "request_ms": {k: v.get("ms") for k, v in replies.items()}, "snr_db": snrs}


def convtasnet_phase(fails: Failures, wav_dir: str) -> dict:
    """Phase 20: the JAX package's default Conv-TasNet (N=256, L=32, stride
    16, B=128, H=512, 8 x 3 blocks, gLN, relu) in bf16: train
    --on-device-features at B=32 on phase 8's 4 s wavs (1999 latent
    frames), 5 epochs; one step card against CPU at B=4; three served
    requests."""
    from speech_separation_tpu_torch.dsp.stft import STFTConfig
    from speech_separation_tpu_torch.eval.pipeline import SeparationPipeline
    from speech_separation_tpu_torch.models import convtasnet
    from speech_separation_tpu_torch.train.checkpoint import save_checkpoint
    from speech_separation_tpu_torch.train.loop import TrainLoopConfig, train
    from speech_separation_tpu_torch.train.wav_data import (WavDataset, audio_to_wave_batch,
                                                            collate_wav_batch)
    from speech_separation_tpu_torch.utils.audio import load_wav

    work = os.path.join(REPO, "build", "chip_smoke_convtasnet")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    torch.cuda.empty_cache()
    cv_dir = os.path.join(os.path.dirname(os.path.dirname(wav_dir)), "cv", "data")
    cfg = TrainLoopConfig(arch="ConvTasNet", batch_size=32, num_epochs=5, seed=SEED,
                          on_device_features=True)
    exp = os.path.join(work, "exp")
    torch.cuda.reset_peak_memory_stats()
    # B=32 fits without remat (the step's peak is printed below)
    res = train(wav_dir, exp, cfg, cv_data_dir=cv_dir, model_kwargs=CONVTASNET_KW,
                device="cuda", log=lambda m: print("  " + m, flush=True))
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = check_trained(fails, res, exp)
    steps = res["steps"]
    fails.check(len(steps) == 10 and all(n == 32 for _, n in steps),
                f"{len(steps)} training steps of 32 rows")
    ms = [m for m, _ in steps[1:]]
    ms_per_step = float(np.mean(ms))
    print(f"  remat off; steps after the first: "
          f"{ms_per_step:.2f} ms/step (min {min(ms):.2f}, max {max(ms):.2f}); first step "
          f"{steps[0][0]:.1f} ms; peak memory {peak_gb:.2f} GB; epochs (wall s, steps s): "
          f"{[(round(w, 3), round(st, 3)) for _, w, st in res['epoch_times']]}", flush=True)
    del res
    torch.cuda.empty_cache()

    shipped = collate_wav_batch(WavDataset(wav_dir), list(range(4)), 4)
    model = convtasnet.ConvTasNet(convtasnet.Config.from_kwargs(**CONVTASNET_KW),
                                  torch.Generator().manual_seed(SEED + 25))
    step = card_vs_cpu_step(
        fails, "Conv-TasNet", model,
        step_controls(model, convtasnet.Config, CONVTASNET_KW), convtasnet.loss_fn,
        lambda dev: audio_to_wave_batch({k: torch.from_numpy(shipped[k]).to(dev) for k in
                                         ("audio", "sample_lengths", "row_mask")},
                                        STFTConfig()))

    mdl = os.path.join(work, "convtasnet.mdl")
    save_checkpoint(mdl, model, meta={"arch": "ConvTasNet", "model_kwargs": CONVTASNET_KW})
    wavs = write_mixtures(work, SEED + 26)
    pipe = SeparationPipeline(mdl, batch_size=16, seed=SEED, device="cuda")
    fails.check(pipe.arch.NAME == "ConvTasNet" and pipe.domain == "time",
                f"the .state meta gives {pipe.arch.NAME} {pipe.cfg}")
    replies, _, wall_ms = serve_requests(fails, pipe, work, wavs, ([0], [1], [2]), [],
                                         lambda n: n)
    snrs = served_against_cpu(fails, "Conv-TasNet", pipe, mdl, [load_wav(w)[0] for w in wavs])
    return {"remat": False, "ms_per_step": ms_per_step, "peak_memory_gb": peak_gb,
            "epoch_losses": losses, "step": step, "wall_ms": wall_ms,
            "request_ms": {k: v.get("ms") for k, v in replies.items()}, "snr_db": snrs}


# --------------------------------------------------------------- streaming

# Phase 21 holds, in f32 compute, each stream's output against the offline
# pipeline on the card at the JAX package's 2e-5 (tests/test_streaming.py,
# tests/test_streaming_time.py) and each pooled stream against the same stream
# alone at its 2e-6 (TCN) and 1e-6 (Conv-TasNet), all scaled by max(1, max
# |reference|): a random full-width model's tracks are not bounded by 1, and
# an f32 rounding is relative. A served stream adds the pcm16 step, 1/32768.
STREAM_TOL = {"offline": 2e-5, "pool": {"TCN": 2e-6, "ConvTasNet": 1e-6},
              "pcm16": 1.0 / 32768}
STREAM_CHUNK = 16              # frames a chunk: STFT frames (TCN), latent frames (Conv-TasNet)


def max_err(got, ref) -> float:
    """max |got - ref| / max(1, max |ref|) over S tracks."""
    ref = np.stack(ref)
    return float(np.abs(np.stack(got) - ref).max() / max(1.0, float(np.abs(ref).max())))


def drive_pool(pool, xs: list, rng) -> tuple[dict, list]:
    """Streams xs[:-1] open at once (at most the pool's capacity) and take
    uneven blocks of 100-3000 samples a round, the pool stepping until no
    slot has a full chunk; the first stream to end is closed and xs[-1]
    opens in its freed slot. Returns ({stream: [S tracks]}, the slot each
    stream had)."""
    S = pool.S
    slot_of = [pool.open() for _ in xs[:-1]] + [None]
    pos = [0] * len(xs)
    out = {i: [[] for _ in range(S)] for i in range(len(xs))}
    stream_at = {slot: i for i, slot in enumerate(slot_of[:-1])}

    def take(results):
        for slot, tracks in results.items():
            for s in range(S):
                out[stream_at[slot]][s].append(tracks[s])

    live = set(range(len(xs) - 1))
    while live:
        for i in sorted(live):
            n = int(rng.integers(100, 3000))
            pool.push(slot_of[i], xs[i][pos[i]: pos[i] + n])
            pos[i] += n
        while True:
            r = pool.step()
            if not r:
                break
            take(r)
        for i in sorted(live):
            if pos[i] >= len(xs[i]):
                take({slot_of[i]: pool.close(slot_of[i])})
                live.discard(i)
                if slot_of[-1] is None:             # the late stream takes this slot
                    slot_of[-1] = pool.open()
                    stream_at[slot_of[-1]] = len(xs) - 1
                    live.add(len(xs) - 1)
    return {i: [np.concatenate(t) for t in o] for i, o in out.items()}, slot_of


def stream_phase(fails: Failures, stft_counter) -> dict:
    """Phase 21: a full-width causal TCN (16-frame chunks, 256 ms) and a
    full-width causal Conv-TasNet (16 latent frames, 32 ms), each in a
    StreamingPool of capacity 8: 8 concurrent streams of 3-8 s in uneven
    blocks and a 9th in the slot the first to end frees, held in f32 against
    the offline pipeline and against each stream alone; then ms per chunk
    and the real-time factor at capacity 8 in bf16; then one stream through
    the server's stream_open/push/close on a Unix socket."""
    from speech_separation_tpu_torch.eval.pipeline import SeparationPipeline
    from speech_separation_tpu_torch.eval.serve import SeparationServer, request
    from speech_separation_tpu_torch.eval.streaming import StreamingPool, StreamingSeparator
    from speech_separation_tpu_torch.models import convtasnet, tcn
    from speech_separation_tpu_torch.train.checkpoint import save_checkpoint

    work = os.path.join(REPO, "build", "chip_smoke_stream")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED + 27)
    xs = [mixture(int(8000 * sec), rng) for sec in rng.uniform(3.0, 8.0, 9)]
    out = {}
    mdls = {}
    for arch, mod, hop in (("TCN", tcn, 128), ("ConvTasNet", convtasnet, 16)):
        kw = {"causal": "1"}
        model = mod.Model(mod.Config.from_kwargs(**kw), torch.Generator().manual_seed(SEED + 28))
        mdl = mdls[arch] = os.path.join(work, f"{arch}.mdl")
        save_checkpoint(mdl, model, meta={"arch": arch, "model_kwargs": kw})
        stft_counter.launches = 0
        t0 = time.monotonic()
        pool = StreamingPool(mdl, capacity=8, chunk_frames=STREAM_CHUNK, device="cuda")
        got, slots = drive_pool(pool, xs, np.random.default_rng(SEED + 29))
        pool_s = time.monotonic() - t0
        solo = [_solo(StreamingSeparator(mdl, chunk_frames=STREAM_CHUNK, device="cuda"), x)
                for x in xs]
        stream_k2 = stft_counter.launches
        off = SeparationPipeline(mdl, batch_size=16, device="cuda").separate(xs)
        fails.check(slots[-1] in slots[:-1],
                    f"{arch}: the late stream took freed slot {slots[-1]} (slots {slots})")
        e_off = max(max_err(got[i], off[i]) for i in range(len(xs)))
        e_solo = max(max_err(got[i], solo[i]) for i in range(len(xs)))
        lens_ok = all(len(got[i][s]) == len(off[i][s]) == len(solo[i][s])
                      for i in range(len(xs)) for s in range(2))
        fails.check(lens_ok and e_off <= STREAM_TOL["offline"],
                    f"{arch}: 9 pooled streams vs the offline pipeline: max err {e_off:.2e} <= "
                    f"{STREAM_TOL['offline']} of max(1, max |ref|)")
        fails.check(e_solo <= STREAM_TOL["pool"][arch],
                    f"{arch}: pooled streams vs each stream alone: max err {e_solo:.2e} <= "
                    f"{STREAM_TOL['pool'][arch]} of max(1, max |ref|)")
        fails.check(stream_k2 == 0, f"{arch} streaming launched K2 {stream_k2} times (its "
                                    "DFTs are products)")

        # bf16 at capacity 8: every slot busy, steady chunks
        bpool = StreamingPool(mdl, capacity=8, chunk_frames=STREAM_CHUNK, device="cuda",
                              model_kwargs={"compute_dtype": "bfloat16"})
        chunk_samples = STREAM_CHUNK * hop
        slots8 = [bpool.open() for _ in range(8)]
        feed = mixture(chunk_samples * 80 + 1024, rng)
        for s in slots8:
            bpool.push(s, feed)
        for _ in range(5):
            bpool.step()
        t0 = time.perf_counter()
        n_steps = 50
        for _ in range(n_steps):
            r = bpool.step()
        ms_chunk = (time.perf_counter() - t0) * 1e3 / n_steps   # step() returns host arrays
        fails.check(len(r) == 8, f"{arch} bf16: {len(r)} slots advanced a step")
        rtf = 8 * chunk_samples / 8000 / (ms_chunk / 1e3)
        print(f"  {arch}: f32 pool run {pool_s:.1f} s; bf16 at capacity 8: {ms_chunk:.2f} ms a "
              f"chunk of {chunk_samples} samples ({1e3 * chunk_samples / 8000:.0f} ms) a slot: "
              f"real-time factor {rtf:.1f} (audio s per card s)", flush=True)
        out[arch] = {"offline_err": e_off, "pool_vs_solo_err": e_solo, "slots": slots,
                     "bf16_ms_per_chunk": ms_chunk, "real_time_factor": rtf,
                     "chunk_ms_audio": 1e3 * chunk_samples / 8000}
        del pool, bpool

    # one live stream through the server on a Unix socket (the TCN pool)
    sock_dir = tempfile.mkdtemp(prefix="sepstream")
    sock = os.path.join(sock_dir, "s.sock")
    server = SeparationServer(SeparationPipeline(mdls["TCN"], batch_size=2, device="cuda"), sock,
                              stream_pool=StreamingPool(mdls["TCN"], capacity=8,
                                                        chunk_frames=STREAM_CHUNK,
                                                        device="cuda"))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    x = (np.round(xs[0] * 32768) / 32768).astype(np.float32)     # pcm16-exact input
    tracks = [[], []]
    try:
        deadline = time.monotonic() + 60
        while not os.path.exists(sock):
            if time.monotonic() > deadline:
                raise RuntimeError("server never bound its socket")
            time.sleep(0.02)
        opened = request(sock, {"cmd": "stream_open"})
        slot = opened.get("slot")
        replies = [opened]
        for i in range(0, len(x), 1500):
            pcm = np.clip(np.rint(x[i: i + 1500] * 32768), -32768, 32767).astype("<i2")
            replies.append(request(sock, {"cmd": "stream_push", "slot": slot,
                                          "pcm16": base64.b64encode(pcm.tobytes()).decode()}))
        replies.append(request(sock, {"cmd": "stream_close", "slot": slot}))
        for rep in replies[1:]:
            for s, t in enumerate(rep.get("tracks", [])):
                tracks[s].append(np.frombuffer(base64.b64decode(t), "<i2") / 32768.0)
    finally:
        server.shutdown()
        thread.join(timeout=30)
        shutil.rmtree(sock_dir, ignore_errors=True)
    fails.check(not thread.is_alive() and all(r.get("ok") for r in replies),
                f"served stream: {len(replies)} replies ok, server stopped")
    ref = _solo(StreamingSeparator(mdls["TCN"], chunk_frames=STREAM_CHUNK, device="cuda"), x)
    ref = [np.clip(r, -1.0, 32767 / 32768) for r in ref]
    got = [np.concatenate(t) if t else np.zeros(0) for t in tracks]
    ok = all(len(g) == len(r) for g, r in zip(got, ref))
    e = max_err(got, ref) if ok else float("inf")
    bound = STREAM_TOL["pool"]["TCN"] + STREAM_TOL["pcm16"]
    fails.check(ok and e <= bound, f"served stream (TCN) vs the stream alone: max err {e:.2e} "
                                   f"<= {bound:.2e} of max(1, max |ref|)")
    out["served_stream_err"] = e
    return out


def _solo(sep, x) -> list:
    """A whole stream through one StreamingSeparator: [S tracks]."""
    first, tail = sep.push(x), sep.close()
    return [np.concatenate([a, b]) for a, b in zip(first, tail)]


# ------------------------------------------------------------------ tools

# Phase 22's bench subset: one phase for each kernel (K3/K4 upit_bf16, K5
# sepformer, K3/K4 at H=128 dprnn, K2 dsp, K1 and K2 serving), and the
# launches each child must report: per training step K3 and K4 twice (uPIT,
# 2 layers) or 12 times (DPRNN, 6 blocks x 2 BLSTMs), K5 forward and backward
# 8 times (SepFormer, 4 blocks x 2 layers) and K6 forward and backward 16
# times (two LayerNorms a layer); K2 in dsp's round trips. A
# training phase runs 1 + iters + 3 steps (the first, the timed loop, the
# idle-share window); dsp a second of round trips, then 20.
BENCH_SUBSET = ("upit_bf16", "sepformer", "dprnn", "dsp", "serving")
BENCH_LAUNCHES = {
    "upit_bf16": {"lstm_seq_fwd": 2 * 24, "lstm_seq_bwd": 2 * 24},
    "sepformer": {"chunk_attention_fwd": 8 * 14, "chunk_attention_bwd": 8 * 14,
                  "channel_norm_fwd": 16 * 14, "channel_norm_bwd": 16 * 14},
    "dprnn": {"lstm_seq_fwd": 12 * 14, "lstm_seq_bwd": 12 * 14},
    "dsp": {"stft": None},
    "serving": {"lstm_seq_infer": None, "stft": None},      # None: any number above 0
}


def _cli(argv: list) -> tuple[int, str]:
    """cli.main.main(argv) in this process: (exit code, its standard
    output)."""
    import contextlib
    import io

    from speech_separation_tpu_torch.cli.main import main as cli_main
    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf):
        try:
            cli_main(argv)
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else 1
    return code, buf.getvalue()


def tools_phase(fails: Failures) -> dict:
    """Phase 22: the port's doctor, warmup and bench through cli.main.main.
    doctor exits 0 with the card, nvcc and every kernel built; warmup finds
    each arch's kernels in the build cache (phase 2 built them) and checks
    their plans at the training shapes; bench runs BENCH_SUBSET in child
    processes, each its own CUDA context: its merged line holds the five
    phases with finite numbers and no failed or skipped phase, the build from
    the cache in under a second, and each child's kernel launches."""
    torch.cuda.empty_cache()          # the children need the card's memory
    t0 = time.monotonic()
    code, out = _cli(["doctor"])
    print("  " + out.strip().replace("\n", "\n  "), flush=True)
    from speech_separation_tpu_torch.ops._build import SOURCES
    fails.check(code == 0 and "PROBE FAILED" not in out
                and out.count("built (") == len(SOURCES),
                f"doctor exits {code}, the card probed and {len(SOURCES)} kernel sources built")
    fails.check("native io (csrc/sepio.cpp): loaded" in out,
                "doctor reports the native loader loaded")
    doctor_s = time.monotonic() - t0
    t0 = time.monotonic()
    code, out = _cli(["warmup"])
    print("  " + out.strip().replace("\n", "\n  "), flush=True)
    warm = [ln for ln in out.splitlines() if ln.startswith("warmup ")]
    fails.check(code == 0 and len(warm) == 6 and all("cache hit" in ln for ln in warm),
                f"warmup exits {code}: {len(warm)} archs ready, each from the cache")
    warmup_s = time.monotonic() - t0
    t0 = time.monotonic()
    code, out = _cli(["bench", "--phases", ",".join(BENCH_SUBSET)])
    bench_s = time.monotonic() - t0
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    line = json.loads(lines[-1]) if lines else {"detail": {}}
    d = line["detail"]
    print(f"  bench ({bench_s:.1f} s): {json.dumps(line)}", flush=True)
    fails.check(code == 0 and sorted(d.get("phases", {})) == sorted(BENCH_SUBSET)
                and "failed_phases" not in d and "skipped_phases" not in d,
                f"bench exits {code} with phases {sorted(d.get('phases', {}))}, failed "
                f"{d.get('failed_phases')}, skipped {d.get('skipped_phases')}")
    numbers = [line.get("value")] + [v for k, v in d.items()
                                     if isinstance(v, (int, float)) and k != "build_s"]
    fails.check(len(numbers) > 10 and all(np.isfinite(v) and v > 0 for v in numbers),
                f"bench: {len(numbers)} numbers, each finite and above 0")
    fails.check(d.get("build") == "cache" and d.get("build_s", 1.0) < 1.0,
                f"bench's build after warmup: {d.get('build')}, {d.get('build_s')} s (< 1 s)")
    launches = {p: s.get("launches", {}) for p, s in d.get("phases", {}).items()}
    for phase, want in BENCH_LAUNCHES.items():
        got = launches.get(phase, {})
        ok = all((got.get(k, 0) > 0) if n is None else got.get(k) == n
                 for k, n in want.items())
        ok = ok and all(n == 0 for k, n in got.items() if k not in want)
        fails.check(ok, f"bench {phase}'s child launched {got} (want {want}, others 0)")
    return {"line": line, "launches": launches, "doctor_s": doctor_s, "warmup_s": warmup_s,
            "bench_s": bench_s}


# --------------------------------------------------------- device scoring

# The float64 device scorer (phase 23) against the host f64 scorer's rows of
# phases 10 and 14: every SDR/SIR/SAR/SI-SDR/SI-SDRi within SCORE_DB with the
# same permutation. The scorer's trust gate sends to the host whatever its
# residuals say may miss 1e-7 dB (eval/bss_eval_device.GATE_DB); a row that
# misses SCORE_DB calls for that gate, not for this bound. The fault control
# scores the same utterances with flen = 511 and must miss SCORE_DB on every
# one. The oracle (phase 24): device-scored rows against host-scored rows
# within SCORE_DB; the card's soft-mask rows against the same command with
# --device cpu (the plain STFT; the same float64 scorer, so the STFT is all
# that differs) within a bound derived per row from K2's
# contract (stft_perturbation): the estimate may move by rho of the source's
# norm; the error signal of a row at x dB is 10^(-x/20) of the signal, so its
# norm moves by at most rho * 10^(x/20) relative, its energy by twice that,
# and x by 10/ln(10) times the energy's relative change.
SCORE_DB = 1e-6
ORACLE_UTTS = 100


def msgpack_bytes(x) -> bytes:
    """msgpack as flax.serialization writes a checkpoint payload: maps with
    str keys, ints, str, and arrays as ext type 1 of [shape, dtype name,
    C-order bytes]. The script's own encoder (no msgpack on this machine)."""
    import struct

    def sized(n, small, codes, small_limit):
        if n < small_limit:
            return bytes([small | n])
        for code, fmt in codes:
            if n < 1 << (8 * struct.calcsize(fmt)):
                return bytes([code]) + struct.pack(fmt, n)
        raise ValueError(n)

    if isinstance(x, dict):
        out = sized(len(x), 0x80, ((0xDE, ">H"), (0xDF, ">I")), 16)
        return out + b"".join(msgpack_bytes(k) + msgpack_bytes(v) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return sized(len(x), 0x90, ((0xDC, ">H"), (0xDD, ">I")), 16) + b"".join(
            msgpack_bytes(v) for v in x)
    if isinstance(x, str):
        b = x.encode()
        return sized(len(b), 0xA0, ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I")), 32) + b
    if isinstance(x, bytes):
        return sized(len(x), 0x00, ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I")), 0) + x
    if isinstance(x, (int, np.integer)) and not isinstance(x, bool):
        return bytes([int(x)]) if 0 <= x < 128 else b"\xd3" + struct.pack(">q", int(x))
    if isinstance(x, np.ndarray):
        data = msgpack_bytes([list(x.shape), x.dtype.name, np.ascontiguousarray(x).tobytes()])
        for code, fmt in ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I")):
            if len(data) < 1 << (8 * struct.calcsize(fmt)):
                return bytes([code]) + struct.pack(fmt, len(data)) + b"\x01" + data
    raise TypeError(type(x))


def write_septpu01(path: str, mdl: str, meta: dict, epoch: int) -> None:
    """A port uPIT checkpoint written as the JAX package's SEPTPU01 file: the
    magic, a <I header length, the JSON header, then the params and state
    trees in the JAX layout (w_ih, w_hh transposed; one summed bias b)."""
    import struct
    sd = {k: v.float().numpy() for k, v in torch.load(mdl, weights_only=True).items()
          if k != "bn.num_batches_tracked"}
    n_layers = len([k for k in sd if k.startswith("blstm.weight_ih_l") and "reverse" not in k])
    blstm = {str(i): {d: {"w_ih": np.ascontiguousarray(sd[f"blstm.weight_ih_l{i}{s}"].T),
                          "w_hh": np.ascontiguousarray(sd[f"blstm.weight_hh_l{i}{s}"].T),
                          "b": sd[f"blstm.bias_ih_l{i}{s}"] + sd[f"blstm.bias_hh_l{i}{s}"]}
                      for d, s in (("fwd", ""), ("bwd", "_reverse"))} for i in range(n_layers)}
    payload = {"params": {"blstm": blstm,
                          "bn": {"gamma": sd["bn.weight"], "beta": sd["bn.bias"]},
                          "lin": {"w": np.ascontiguousarray(sd["lin.weight"].T),
                                  "b": sd["lin.bias"]}},
               "state": {"bn": {"mean": sd["bn.running_mean"], "var": sd["bn.running_var"]}}}
    header = json.dumps({"epoch": epoch, "meta": meta}).encode()
    with open(path, "wb") as f:
        f.write(b"SEPTPU01" + struct.pack("<I", len(header)) + header + msgpack_bytes(payload))


def _result_rows(exp: str) -> dict:
    """{metric: {utt: values}} of a scored output dir."""
    rows = {}
    for m in ("SDR", "SIR", "SAR", "SI-SDR", "SI-SDRi"):
        with open(os.path.join(exp, "results", f"source_{m}s.txt")) as f:
            rows[m] = {ln.split()[0]: np.array(ln.split()[1:], float) for ln in f}
    return rows


def row_diff(got: dict, want: dict) -> float:
    """The largest |difference| over every metric and row (inf when the
    utterances differ)."""
    d = 0.0
    for m in want:
        if sorted(got[m]) != sorted(want[m]):
            return float("inf")
        for utt, w in want[m].items():
            g = got[m][utt]
            same_inf = (np.isinf(g) & (g == w))
            d = max(d, float(np.max(np.where(same_inf, 0.0, np.abs(g - w)), initial=0.0)))
    return d


def _copy_wavs(src_out: str, dst_out: str) -> None:
    shutil.rmtree(dst_out, ignore_errors=True)
    shutil.copytree(os.path.join(src_out, "wav"), os.path.join(dst_out, "wav"))


def _anatomy(log) -> str:
    return next((ln.strip() for _, ln, _ in log.lines if "device scoring anatomy" in ln), "")


def linalg_timing() -> dict:
    """The linalg backend PyTorch picks, and one joint solve's LU of a
    64-utterance sub-batch (64 x 1024 x 1024 f64, 2 sources) under each
    backend, CUDA-event means."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    A = torch.randn((64, 1024, 1024), generator=gen, device="cuda", dtype=torch.float64)
    G = A @ A.transpose(1, 2) + 1024 * torch.eye(1024, device="cuda", dtype=torch.float64)
    D = torch.randn((64, 1024, 2), generator=gen, device="cuda", dtype=torch.float64)
    default = torch.backends.cuda.preferred_linalg_library()
    out = {"preferred_linalg_library": str(default)}
    try:
        for lib in ("cusolver", "magma"):
            torch.backends.cuda.preferred_linalg_library(lib)
            out[f"{lib}_lu_ms"] = cuda_ms(lambda: torch.linalg.lu_factor_ex(G), iters=5)
            LU, piv, _ = torch.linalg.lu_factor_ex(G)
            out[f"{lib}_lu_solve_ms"] = cuda_ms(lambda: torch.linalg.lu_solve(LU, piv, D),
                                                iters=5)
    finally:
        torch.backends.cuda.preferred_linalg_library(default)
    return out


def device_scoring_phase(fails: Failures, counters, recipe: dict, eval_rsh: dict) -> dict:
    """Phase 23: the float64 device scorer on the card. Copies of phase 10's
    uPIT tracks and phase 14's RSH tracks rescored by `score
    --device-scoring`; `run-eval --stage 4 --device-scoring` on a copy of
    phase 10's model dir; phase 10's model written as the JAX package's
    SEPTPU01 checkpoint and run through `run-eval --stage 2
    --device-scoring`; the flen=511 fault control."""
    from speech_separation_tpu_torch.eval.bss_eval_device import bss_eval_sources_batch
    from speech_separation_tpu_torch.eval.score import _load_case, pack_signals
    from speech_separation_tpu_torch.datadir.scp import read_scp, read_utt2num_spk
    out = {"linalg": linalg_timing()}
    print(f"  linalg: {out['linalg']}", flush=True)
    recipe_dir = os.path.join(REPO, "build", "chip_smoke_recipe")
    rsh_dir = os.path.join(REPO, "build", "chip_smoke_rsh_eval")
    cases = (("uPIT", recipe_dir, "exp/uPIT_rtr/output_final/rtt", recipe["walls_s"]["score"]),
             ("RSH", rsh_dir, "exp/RSH/output_final/rtt", eval_rsh["walls_s"]["score"]))
    cwd = os.getcwd()
    try:
        for arch, work, host_out, host_wall in cases:
            os.chdir(work)
            want = _result_rows(host_out)
            dev_out = host_out.replace("exp/", "exp_device/")
            _copy_wavs(host_out, dev_out)
            log = StageLog(counters)
            log.run(["score", "data/rtt", dev_out, "--device-scoring", "--device", "cuda"])
            wall = log.lines[-1][0] - log.lines[0][0]
            with open(os.path.join(dev_out, "results", "summary.json")) as f:
                summary = json.load(f)
            d = row_diff(_result_rows(dev_out), want)
            fails.check(d <= SCORE_DB and summary["scorer"] == "device-f64",
                        f"{arch}: score --device-scoring rows against the host's "
                        f"(phase {10 if arch == 'uPIT' else 14}): max |difference| {d:.3e} dB "
                        f"<= {SCORE_DB}, the same permutation")
            print(f"  {arch}: device scorer {wall:.2f} s ({summary['host_fallbacks']} host-f64 "
                  f"fallbacks) against the host scorer's {host_wall:.2f} s (8 spawned "
                  f"workers); {_anatomy(log)}", flush=True)
            out[arch] = {"wall_s": wall, "host_wall_s": host_wall, "max_diff_db": d,
                         "fallbacks": summary["host_fallbacks"], "anatomy": _anatomy(log)}

        os.chdir(recipe_dir)
        # run-eval stage 4 with --device-scoring, on a copy of phase 10's model dir
        exp4 = "exp/uPIT_rtr_stage4"
        shutil.rmtree(exp4, ignore_errors=True)
        os.makedirs(exp4)
        for name in ("final.mdl", "final.state", "conf"):
            shutil.copy(os.path.join("exp/uPIT_rtr", name), exp4)
        _copy_wavs("exp/uPIT_rtr/output_final/rtt", f"{exp4}/output_final/rtt")
        log = StageLog(counters)
        log.run(["run-eval", "--model-dir", exp4, "--test-sets", "rtt", "--stage", "4",
                 "--device-scoring", "--device", "cuda"])
        want = _result_rows("exp/uPIT_rtr/output_final/rtt")
        d = row_diff(_result_rows(f"{exp4}/output_final/rtt"), want)
        fails.check(d <= SCORE_DB, f"run-eval --stage 4 --device-scoring rows against the "
                                   f"host's: max |difference| {d:.3e} dB <= {SCORE_DB}")
        out["run_eval_stage4"] = {"wall_s": log.lines[-1][0] - log.lines[0][0], "max_diff_db": d}

        # phase 10's model as the JAX package's checkpoint: run-eval stages 2-4
        from speech_separation_tpu_torch.train.checkpoint import load_checkpoint
        meta = load_checkpoint("exp/uPIT_rtr/final.mdl")["meta"]
        exp_j = "exp/uPIT_rtr_septpu01"
        shutil.rmtree(exp_j, ignore_errors=True)
        os.makedirs(exp_j)
        write_septpu01(os.path.join(exp_j, "final.mdl"), "exp/uPIT_rtr/final.mdl", meta, 5)
        log = StageLog(counters)
        log.run(["run-eval", "--model-dir", exp_j, "--test-sets", "rtt", "--stage", "2",
                 "--batch-size", "100", "--device-scoring", "--device", "cuda"])
        spans = log.spans([("masks", "(stage 2)"), ("reconstruct", "(stage 3)"),
                           ("score", "(stage 4)")])
        mask_err = 0.0
        for utt, _ in read_scp("data/rtt/wav.scp"):
            with np.load(f"exp/uPIT_rtr/output_final/rtt/masks/{utt}.npz") as a, \
                    np.load(f"{exp_j}/output_final/rtt/masks/{utt}.npz") as b:
                mask_err = max(mask_err, max(float(np.abs(a[k] - b[k]).max()) for k in a.files))
        d = row_diff(_result_rows(f"{exp_j}/output_final/rtt"), want)
        k1 = spans["masks"][1]["lstm_seq_infer"]
        fails.check(mask_err == 0.0 and d <= SCORE_DB and k1 == 2,
                    f"run-eval --stage 2 --device-scoring on a SEPTPU01 checkpoint of phase "
                    f"10's model: masks max |difference| {mask_err:.3e} (0: the same weights "
                    f"and initial state), rows {d:.3e} dB <= {SCORE_DB}, K1 launched {k1} "
                    f"times in masks (2)")
        out["septpu01"] = {"walls_s": {k: w for k, (w, _) in spans.items()},
                           "mask_max_diff": mask_err, "max_diff_db": d, "k1_launches": k1}

        # the fault control: the same utterances scored with flen = 511
        entries = read_scp("data/rtt/wav.scp")
        n_src = read_utt2num_spk("data/rtt/utt2num_spk")
        est_dir = "exp/uPIT_rtr/output_final/rtt/wav"
        loaded = [_load_case(u, p, n_src[u], est_dir) for u, p in entries]
        sdr, sir, sar, _ = bss_eval_sources_batch(pack_signals([c[0] for c in loaded], 2),
                                                  pack_signals([c[1] for c in loaded], 2),
                                                  flen=511, device="cuda")
        dev = [max(np.max(np.abs(x[i] - want[m][u])) for x, m in ((sdr, "SDR"), (sir, "SIR"),
                                                                     (sar, "SAR")))
               for i, (u, _) in enumerate(entries)]
        fails.check(min(dev) > SCORE_DB, f"fault control (flen=511): every utterance misses "
                                         f"{SCORE_DB} dB, the smallest deviation "
                                         f"{min(dev):.3e} dB")
        out["fault_flen511_min_dev_db"] = float(min(dev))
    finally:
        os.chdir(cwd)
    return out


def oracle_rows(data_dir: str, kind: str) -> dict:
    rows = {}
    for m in ("SDR", "SIR", "SAR"):
        with open(os.path.join(data_dir, f"oracle_{kind}_mask_eval", f"source_{m}s.txt")) as f:
            rows[m] = {ln.split()[0]: np.array(ln.split()[1:], float) for ln in f}
    return rows


def stft_perturbation(data_dir: str) -> dict:
    """{utt: rho_i per source}: the relative perturbation of each soft-mask
    estimate that K2's contract allows. K2 is within TOL["stft_rel"] of
    max |X| in every bin, so a bin of mask * X = |S_i| e^(j arg X) moves by
    at most 2 TOL max|X| (|S_i| and the phase's X); over F*T bins the
    estimate moves by 2 TOL max|X| sqrt(F T) in norm (the iSTFT is close
    to a tight frame), against the source's ||S_i||. The STFTs here are
    numpy float64 on the host."""
    from speech_separation_tpu_torch.datadir.scp import read_scp, source_wavs_for_mix
    from speech_separation_tpu_torch.dsp.stft import hann_periodic
    from speech_separation_tpu_torch.utils.audio import load_wav
    w = hann_periodic(512, np.float64)

    def spec(x):
        xp = np.pad(x.astype(np.float64), 256, mode="reflect")
        n_t = 1 + len(x) // 128
        frames = np.lib.stride_tricks.sliding_window_view(xp, 512)[::128][:n_t]
        return np.abs(np.fft.rfft(frames * w, axis=1))

    rho = {}
    for utt, mix_path in read_scp(os.path.join(data_dir, "wav.scp")):
        mix, *srcs = [spec(load_wav(p)[0]) for p in source_wavs_for_mix(mix_path)]
        peak = 2 * TOL["stft_rel"] * mix.max() * np.sqrt(mix.size)
        rho[utt] = np.array([peak / np.linalg.norm(s) for s in srcs])
    return rho


def oracle_phase(fails: Failures, stft_counter) -> dict:
    """Phase 24: `oracle` soft and hard on phase 10's 100 test utterances,
    with --device-scoring in process (K2 counted) and with the host scorer in
    8 spawned workers (--nj 8 --mj 8); the soft mask's --device-scoring
    command again with --device cpu (the plain STFT, the same float64
    scorer on the CPU), against the card."""
    recipe_dir = os.path.join(REPO, "build", "chip_smoke_recipe")
    cwd = os.getcwd()
    out = {}
    try:
        os.chdir(recipe_dir)
        for kind in ("soft", "hard"):
            flag = ["--hard-mask"] if kind == "hard" else []
            stft_counter.launches = 0
            t0 = time.monotonic()
            code, text = _cli(["oracle", "data/rtt", "--device-scoring", "--device", "cuda",
                               *flag])
            dev_wall = time.monotonic() - t0
            launches = stft_counter.launches
            dev_rows = oracle_rows("data/rtt", kind)
            mean_sdr = float(np.mean(np.concatenate(list(dev_rows["SDR"].values()))))
            fb = sum(int(ln.split("(")[1].split()[0]) for ln in text.splitlines()
                     if "host-f64 fallbacks" in ln)
            t0 = time.monotonic()
            code_h, _ = _cli(["oracle", "data/rtt", "--nj", "8", "--mj", "8", "--device",
                              "cuda", *flag])
            host_wall = time.monotonic() - t0
            d = row_diff(dev_rows, oracle_rows("data/rtt", kind))
            fails.check(code == 0 and code_h == 0 and d <= SCORE_DB
                        and launches == ORACLE_UTTS,
                        f"oracle {kind}: device-scored rows against host-scored: max "
                        f"|difference| {d:.3e} dB <= {SCORE_DB}; K2 launched {launches} "
                        f"times ({ORACLE_UTTS}: one an utterance)")
            print(f"  oracle {kind}: --device-scoring {dev_wall:.2f} s ({fb} host-f64 "
                  f"fallbacks), host scorer (8 workers) {host_wall:.2f} s; mean SDR "
                  f"{mean_sdr:.4f} dB; K2 launches {launches}", flush=True)
            out[kind] = {"device_wall_s": dev_wall, "host_wall_s": host_wall,
                         "max_diff_db": d, "k2_launches": launches, "mean_sdr": mean_sdr,
                         "fallbacks": fb}
            if kind == "soft":
                card_rows = dev_rows
        t0 = time.monotonic()
        code, _ = _cli(["oracle", "data/rtt", "--device-scoring", "--device", "cpu"])
        cpu_wall = time.monotonic() - t0
        cpu_rows = oracle_rows("data/rtt", "soft")
        rho = stft_perturbation("data/rtt")
        worst = 0.0        # the largest difference as a share of its derived bound
        for m in cpu_rows:
            for utt, w in cpu_rows[m].items():
                bound = 10 / np.log(10) * 2 * rho[utt][:len(w)] * 10 ** (w / 20)
                worst = max(worst, float(np.max(np.abs(card_rows[m][utt] - w) / bound)))
        fails.check(code == 0 and sorted(cpu_rows["SDR"]) == sorted(card_rows["SDR"])
                    and worst <= 1.0,
                    f"oracle soft on the card against --device cpu (plain STFT): every row "
                    f"within its derived bound (the largest share of it {worst:.3f})")
        out["soft_cpu"] = {"wall_s": cpu_wall, "worst_share_of_bound": worst}
    finally:
        os.chdir(cwd)
    return out


# ------------------------------------------------------- training extras

def _count_lines(data_dir: str) -> None:
    """utt2num_frames and utt2num_spk of a dir of npz training features."""
    frames, spks = [], []
    with open(os.path.join(data_dir, "feats_train.scp")) as f:
        for ln in f:
            utt, path = ln.split()
            with np.load(path) as feat:
                frames.append(f"{utt} {feat['mix'].shape[1]}\n")
                spks.append(f"{utt} {len(feat.files) - 1}\n")
    for name, lines in (("utt2num_frames", frames), ("utt2num_spk", spks)):
        with open(os.path.join(data_dir, name), "w") as f:
            f.writelines(lines)


def _same_tensors(a: str, b: str) -> bool:
    x, y = torch.load(a, weights_only=True), torch.load(b, weights_only=True)
    return x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)


def _input_reading(res: dict) -> dict:
    """Each epoch's wall against its summed step time, and the bytes each
    step's batch sent to the card."""
    walls = [(round(w, 3), round(st, 3)) for _, w, st in res["epoch_times"]]
    ms = [m for m, _ in res["steps"][1:]]
    return {"epochs_wall_steps_s": walls, "mean_step_ms": float(np.mean(ms)),
            "h2d_bytes_full_batch": max(res["h2d_bytes"])}


def extras_phase(fails: Failures, counters, train_dir: str) -> dict:
    """Phase 25: the training extras on phase 5's uPIT npz corpus (120
    training utterances of 4.5-6 s, T=384; its 40 CV utterances). Three data
    dirs over the same npz files pick the three collations: no utt2num
    files (numpy), utt2num_frames and utt2num_spk (native, csrc/sepio.cpp
    built with g++), and packed caches (pack-features at f32 and f16). One
    batch of each is held bit-equal (f16 within 1e-3 of the batch's largest
    magnitude) and timed; then a 2x600 bf16 uPIT trains at B=100 on each:
    numpy, native and f16 for 5 epochs, the f32 cache for 10 with CV; the
    per-epoch losses equal (f16 within 2e-3 relative), the f16 batches
    crossing at half the bytes, K3/K4 counted. Then `train
    --hang-watchdog-sec` through the CLI with --profile-dir and
    --train-copy-location: a spawned CUDA child, 0 restarts, final.mdl
    equal to the f32-cache run's, the features staged, the trace naming K3
    and K4; and beside it on the card a fault control: a supervised run
    whose child is stopped (SIGSTOP) after its epoch-5 checkpoint, killed by
    the watchdog and restarted from that checkpoint, ending in the same
    final.mdl."""
    import dataclasses
    import re
    import signal

    from speech_separation_tpu_torch.datadir.stage import staged_path
    from speech_separation_tpu_torch.train import data as tdata
    from speech_separation_tpu_torch.train.loop import TrainLoopConfig, train
    from speech_separation_tpu_torch.train.watchdog import train_supervised
    from speech_separation_tpu_torch.utils import native

    work = os.path.join(REPO, "build", "chip_smoke_extras")
    shutil.rmtree(work, ignore_errors=True)
    cv = os.path.join(os.path.dirname(train_dir), "cv")
    status = native.status()
    fails.check(native.available(), f"native loader: {status}")
    dirs = {name: os.path.join(work, name) for name in ("numpy", "native", "cache32", "cache16")}
    for name, d in dirs.items():
        os.makedirs(d)
        shutil.copy(os.path.join(train_dir, "feats_train.scp"), d)
        if name != "numpy":
            _count_lines(d)
    pack_s = {}
    for name, dtype in (("cache32", "float32"), ("cache16", "float16")):
        t0 = time.monotonic()
        code, out = _cli(["pack-features", dirs[name], "train", "--dtype", dtype,
                          "--cache-path", os.path.join(work, f"{name}.bin")])
        pack_s[name] = time.monotonic() - t0
        print(f"  {out.strip()} ({pack_s[name]:.2f} s)", flush=True)
        fails.check(code == 0, f"pack-features --dtype {dtype} exits {code}")

    # one batch of 100 by each collation
    logs = []
    sets = {name: tdata.FeatureDataset(d, log=logs.append) for name, d in dirs.items()}
    print("  " + "\n  ".join(logs), flush=True)
    want = {"numpy": "numpy", "native": "native", "cache32": "cache", "cache16": "cache"}
    for name, ds in sets.items():
        fails.check(ds.collation == want[name], f"{name} dir collates by {ds.collation}")
    plan = tdata.BatchPlan(batch_size=100, time_pad_multiple=128, seed=SEED)
    idxs = tdata.plan_batches(sets["numpy"], plan, 0)[0]
    batches, collate_ms = {}, {}
    for name, ds in sets.items():
        tdata.collate(ds, idxs, plan)                       # warm the page cache
        t0 = time.perf_counter()
        batches[name] = tdata.collate(ds, idxs, plan)
        collate_ms[name] = (time.perf_counter() - t0) * 1e3
    ref = batches["numpy"]
    for name in ("native", "cache32"):
        b = batches[name]
        fails.check(b["names"] == ref["names"] and all(
            b[k].dtype == ref[k].dtype and np.array_equal(b[k], ref[k])
            for k in ("mix", "sources", "lengths", "row_mask")),
            f"{name} batch bit-equal to the numpy one ({b['mix'].shape})")
    b16 = batches["cache16"]
    f16_err = max(float(np.abs(b16[k].astype(np.float32) - ref[k]).max() / np.abs(ref[k]).max())
                  for k in ("mix", "sources"))
    fails.check(b16["mix"].dtype == np.float16 and b16["sources"].dtype == np.float16
                and f16_err <= 1e-3, f"f16 batch in float16, {f16_err:.2e} of the largest "
                                     "magnitude from the f32 one (<= 1e-3)")
    print(f"  one batch of 100 (ms, page cache warm): "
          f"{ {k: round(v, 2) for k, v in collate_ms.items()} }", flush=True)

    kw = {"compute_dtype": "bfloat16"}
    cfg = TrainLoopConfig(batch_size=100, num_epochs=5, time_pad_multiple=128, seed=SEED,
                          make_plots=False)

    def run(name, data_dir, epochs, cv_dir=""):
        for c in counters:
            c.launches = 0
        lines = []
        res = train(data_dir, os.path.join(work, f"exp_{name}"),
                    dataclasses.replace(cfg, num_epochs=epochs), cv_data_dir=cv_dir,
                    model_kwargs=kw, device="cuda", log=lines.append)
        torch.cuda.synchronize()
        res["launches"] = {c.__name__: c.launches for c in counters}
        res["reading"] = _input_reading(res)
        how = next(ln for ln in lines if ln.startswith("feature collation"))
        print(f"  {name}: {how}; {res['reading']}; launches {res['launches']}", flush=True)
        return res

    runs = {"numpy": run("numpy", dirs["numpy"], 5), "native": run("native", dirs["native"], 5),
            "cache32": run("cache32", dirs["cache32"], 10, cv),
            "cache16": run("cache16", dirs["cache16"], 5)}
    losses = {k: [loss for _, loss in r["epoch_losses"]][:5] for k, r in runs.items()}
    for name, r in runs.items():
        fails.check(r["collation"] == want[name], f"{name} run collated by {r['collation']}")
    for name in ("native", "cache32"):
        fails.check(losses[name] == losses["numpy"],
                    f"{name} epoch losses equal the numpy path's: {losses[name]}")
    f16_rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cache16"], losses["cache32"]))
    fails.check(f16_rel <= 2e-3, f"f16-cache losses within {f16_rel:.2e} of the f32 cache's "
                                 "(<= 2e-3 relative)")
    h32 = runs["cache32"]["reading"]["h2d_bytes_full_batch"]
    h16 = runs["cache16"]["reading"]["h2d_bytes_full_batch"]
    fails.check(h16 < 0.51 * h32, f"f16 batch crosses in {h16} bytes, f32 in {h32}")
    for name, steps in (("cache32", 20), ("cache16", 10)):
        got = runs[name]["launches"]
        fails.check(got["lstm_seq_fwd"] == got["lstm_seq_bwd"] == 2 * steps,
                    f"{name}: K3 {got['lstm_seq_fwd']}, K4 {got['lstm_seq_bwd']} launches "
                    f"(2 layers x {steps} steps)")
    fails.check(runs["cache32"]["launches"]["lstm_seq_infer"] > 0, "K1 launched in the CV pass")

    # the watchdog with the profiler and staging, through the CLI; beside it
    # on the card, so that the children's start-up overlaps, the fault
    # control: a supervised run whose child is stopped after its epoch-5
    # checkpoint
    exp = os.path.join(work, "exp_fault")
    log, result, stopped = [], {}, []
    th = threading.Thread(target=lambda: result.update(train_supervised(
        dirs["cache32"], exp, dataclasses.replace(cfg, num_epochs=10), hang_timeout_s=5.0,
        first_timeout_s=300.0, max_restarts=1, cv_data_dir=cv, model_kwargs=kw,
        device="cuda", poll_s=0.25, log=log.append)))

    def stop_after_epoch5():
        state5 = os.path.join(exp, "intermediate_models", "005.state")
        while th.is_alive() and not os.path.isfile(state5):
            time.sleep(0.02)
        if th.is_alive():
            with open(os.path.join(exp, ".train.lock")) as f:
                stopped.append(int(f.read()))
            os.kill(stopped[0], signal.SIGSTOP)

    stopper = threading.Thread(target=stop_after_epoch5)
    t0 = time.monotonic()
    th.start()
    stopper.start()
    conf = os.path.join(work, "model.conf")
    with open(conf, "w") as f:
        f.write("compute_dtype=bfloat16\n")
    prof, stage = os.path.join(work, "profile"), os.path.join(work, "staged")
    code, out = _cli(["train", "uPIT", dirs["native"], os.path.join(work, "exp_watchdog"),
                      "--cv-data-dir", cv, "--model-config", conf, "--batch-size", "100",
                      "--num-epochs", "10", "--time-pad-multiple", "128", "--seed", str(SEED),
                      "--no-plots", "--hang-watchdog-sec", "60",
                      "--hang-first-timeout-sec", "300", "--profile-dir", prof,
                      "--train-copy-location", stage, "--device", "cuda"])
    watchdog_s = time.monotonic() - t0
    print(f"  supervised run ({watchdog_s:.1f} s): {out.strip()}", flush=True)
    final = os.path.join(work, "exp_cache32", "final.mdl")
    fails.check(code == 0 and "after 0 restart(s)" in out, f"supervised run exits {code}, "
                                                            "0 restarts")
    fails.check(_same_tensors(os.path.join(work, "exp_watchdog", "final.mdl"), final),
                "the supervised child's final.mdl equals the unsupervised run's")
    staged = [staged_path(path, stage) for _, path in sets["numpy"].entries]
    fails.check(all(os.path.isfile(p) for p in staged), f"{len(staged)} feature files staged")
    trace = ""
    if os.path.isfile(os.path.join(prof, "trace.json")):
        with open(os.path.join(prof, "trace.json")) as f:
            trace = f.read()
    k3 = len(re.findall(r"lstm_fwd_kernel<[^>]*true>", trace))
    k4 = len(re.findall(r"lstm_bwd_kernel<", trace))
    fails.check(k3 > 0 and k4 > 0, f"the profile trace names K3 ({k3} events) and K4 ({k4})")

    th.join(600)
    stopper.join(60)
    fault_s = time.monotonic() - t0
    stopped = stopped[0] if stopped else None
    print(f"  fault control ({fault_s:.1f} s, from the same start): child {stopped} "
          f"stopped; {log}", flush=True)
    fails.check(stopped is not None and result.get("restarts") == 1
                and "watchdog: resuming from epoch 5" in log,
                f"the stopped child killed and restarted from epoch 5: {result}")
    fails.check(_same_tensors(os.path.join(exp, "final.mdl"), final),
                "the restarted run's final.mdl equals the uninterrupted run's")
    return {"native": status, "pack_s": pack_s, "collate_ms": collate_ms,
            "f16_batch_err": f16_err, "f16_loss_rel": f16_rel,
            "readings": {k: r["reading"] for k, r in runs.items()},
            "launches": {k: r["launches"] for k, r in runs.items()},
            "losses": losses, "watchdog_s": watchdog_s, "fault_s": fault_s,
            "trace_k3_k4": (k3, k4), "native_dir": dirs["native"]}


# ---------------------------------------------------------- data parallel

# Phase 26 runs the data-parallel paths on one card: two ranks on cuda:0
# (gloo: NCCL refuses two ranks on one device; without MPS their kernels
# take the card in turns), and two pipeline replicas on cuda:0 (in turn:
# the LSTM kernels' grid barrier needs every CTA resident). A data-parallel
# step is held to the one-process step on the same weights, batch and
# initial states by relative L2 (step_errs: loss, every gradient as reduced
# over the ranks, BN's running statistics), within DP_TOL, and each fault
# control (parallel/ranks.FAULTS: BN statistics per rank, T per rank,
# gradients averaged under per-rank norms) must fail those bounds. Each bound
# is derived as RECURRENT_TOL's: the geometric mean of the largest sound
# reading (uPIT, RSH's mixed batch and SepFormer in bf16; uPIT in f32) and
# the smallest fault reading of the same dtype (BN's only over the two faults
# that touch BN), on an NVIDIA H100 80GB HBM3 at 700 W. In bf16 every weight
# gradient leaves a bf16 product rounded to bf16 on each rank, so the two
# ranks' sum carries a bf16 rounding that one process's does not (about 2e-3
# of every gradient); in f32 the step moves by the order of sums alone.
# Readings (sound -> bound <- fault): bf16 loss 1.7e-7 -> 4.9e-6 <- 1.4e-4,
# worst gradient 4.7e-3 -> 8.4e-3 <- 1.5e-2, median 4.4e-3 -> 6.6e-3 <-
# 9.9e-3, BN 4.1e-5 -> 1.3e-3 <- 4.3e-2; f32 loss 0 (taken as one f32
# rounding, 6e-8) -> 2.9e-6 <- 1.4e-4, worst gradient 3.3e-6 -> 1.8e-4 <-
# 1.0e-2, median 3.9e-7 -> 6.0e-5 <- 9.1e-3, BN 9.1e-8 -> 6.3e-5 <- 4.3e-2.
# In bf16 the averaged gradients stand 1.5x clear of the sound step in the
# median gradient and 29x in the loss.
DP_MESH = ["cuda:0", "cuda:0"]
DP_TOL = {"bf16": {"loss": 4.9e-6, "grad": 8.4e-3, "grad_median": 6.6e-3, "bn": 1.3e-3},
          "f32": {"loss": 2.9e-6, "grad": 1.8e-4, "grad_median": 6.0e-5, "bn": 6.3e-5}}
# phase 26 (a)'s epoch losses against phase 5's (the same run in one
# process), relative: ten times the first reading (4.6e-5)
DP_TRAIN_RTOL = 5e-4
# separated tracks, two replicas against one device: max |difference| over
# the tracks' peak, thirty times the first reading (3.3e-7)
DP_TRACK_TOL = 1e-5
DP_SCORE_DB = 1e-9


def _dp_result(r: dict) -> dict:
    """A steps_over_ranks result in step_errs's form."""
    out = {"loss": torch.tensor(r["loss"]), "grads": r["grads"]}
    if "bn.running_mean" in r["buffers"]:
        out["bn"] = [r["buffers"]["bn.running_mean"], r["buffers"]["bn.running_var"]]
    return out


def _dp_weights(model, seed: int) -> dict:
    from speech_separation_tpu_torch.utils.weights import fold_lstm_biases
    model.reset_parameters(torch.Generator().manual_seed(seed))
    fold_lstm_biases(model)
    return model.state_dict()


def _dp_step_jobs(train_dir: str, sf_train_dir: str) -> dict:
    """Phase 26 (b)-(d)'s step jobs at full width: uPIT 2x600 in bf16 and in
    f32 on 100 rows of phase 5's corpus sorted by length with T padded to a
    multiple of 32 (so rank 0's rows, the shortest, pad to less than the
    batch's T), each with the three fault controls ("<job>/<fault>"); RSH 2x600 bf16 on a mixed batch of 3, 5 and 1 rows
    of 1, 2 and 3 speakers (no sub-batch divides over two ranks); SepFormer
    bf16 with fused attention on 8 rows of phase 8's wavs."""
    from speech_separation_tpu_torch.models import rsh, sepformer, upit
    from speech_separation_tpu_torch.train.data import (BatchPlan, FeatureDataset,
                                                        make_device_batch)
    from speech_separation_tpu_torch.train.wav_data import WavDataset, collate_wav_batch
    ds = FeatureDataset(train_dir, log=quiet)
    samples = sorted((ds.load(i) for i in range(len(ds))), key=lambda s: s["mix"].shape[0])
    batch = make_device_batch(samples[:100], BatchPlan(batch_size=100, time_pad_multiple=32))
    bf16 = {"compute_dtype": "bfloat16"}
    upit_job = {"arch": "uPIT", "model_kwargs": bf16, "batch": batch, "seed": SEED,
                "time_pad_multiple": 32,
                "weights": _dp_weights(upit.UPIT(upit.Config(compute_dtype="bfloat16")),
                                       SEED + 26)}
    rng = np.random.default_rng(SEED + 26)

    def sub(n, S):
        lengths = rng.integers(280, 385, size=n).astype(np.int32)
        mix = np.abs(rng.standard_normal((n, 384, 257))).astype(np.float32)
        sources = np.abs(rng.standard_normal((n, S, 384, 257))).astype(np.float32)
        for b, t in enumerate(lengths):
            mix[b, t:] = 0.0
            sources[b, :, t:] = 0.0
        return {"mix": mix, "sources": sources, "lengths": lengths,
                "row_mask": np.ones((n,), np.float32)}

    upit_f32 = dict(upit_job, model_kwargs={})
    jobs = {"upit": upit_job, "upit_f32": upit_f32,
            **{f"{n}/{f}": dict(job, faults=(f,)) for n, job in
               (("upit", upit_job), ("upit_f32", upit_f32))
               for f in ("bn_per_rank", "time_per_rank", "mean_grads")},
            "rsh_mixed": {"arch": "RSH", "model_kwargs": bf16, "seed": SEED,
                          "batch": [sub(3, 1), sub(5, 2), sub(1, 3)],
                          "weights": _dp_weights(rsh.RSH(rsh.Config(
                              compute_dtype="bfloat16")), SEED + 27)},
            "sepformer": {"arch": "SepFormer", "model_kwargs": SEPFORMER_KW, "seed": SEED,
                          "batch": collate_wav_batch(WavDataset(sf_train_dir), list(range(8)),
                                                     8),
                          "weights": sepformer.SepFormer(sepformer.Config.from_kwargs(
                              **SEPFORMER_KW), torch.Generator().manual_seed(SEED + 28))
                          .state_dict()}}
    return jobs


def data_parallel_phase(fails: Failures, counters, train_dir: str, sf_train_dir: str,
                        phase5: dict, native_dir: str) -> dict:
    """Phase 26: data-parallel training, separation and scoring on one card
    (module docstring, item 26). (a) trains from ``native_dir``, phase 25's
    copy of phase 5's training set with its per-utterance counts: each rank
    collates every batch with the native loader and keeps its rows."""
    from speech_separation_tpu_torch.eval.pipeline import SeparationPipeline
    from speech_separation_tpu_torch.eval.score import evaluate_sources
    from speech_separation_tpu_torch.parallel import ranks
    from speech_separation_tpu_torch.parallel.checks import steps_over_ranks
    from speech_separation_tpu_torch.parallel.mesh import make_mesh, pad_rows
    from speech_separation_tpu_torch.train.loop import TrainLoopConfig, train
    from speech_separation_tpu_torch.utils.audio import load_wav, write_wav_int16

    torch.cuda.empty_cache()          # the ranks need the card's memory
    mesh = make_mesh(devices=DP_MESH)
    out, launches = {}, {c.__name__: 0 for c in counters}

    def add(counts):
        for k, n in counts.items():
            launches[k] += n

    # (a) uPIT trained over two ranks, as phase 5 trained it in one process
    work = os.path.join(REPO, "build", "chip_smoke_dp")
    shutil.rmtree(work, ignore_errors=True)
    exp = os.path.join(work, "exp")
    cfg = TrainLoopConfig(batch_size=100, num_epochs=5, time_pad_multiple=128, seed=SEED)
    t0 = time.monotonic()
    res = train(native_dir, exp, cfg, cv_data_dir=os.path.join(os.path.dirname(train_dir), "cv"),
                model_kwargs={"compute_dtype": "bfloat16"}, mesh=mesh,
                log=lambda m: print("  " + m, flush=True))
    wall = time.monotonic() - t0
    fails.check(res["collation"] == "native", f"(a) each rank collated its batches with the "
                                              f"{res['collation']} loader (native)")
    got = ranks.launch.kernel_launches
    add(got)
    losses = check_trained(fails, res, exp)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, phase5["epoch_losses"])]
    fails.check(len(losses) == len(phase5["epoch_losses"]) and max(rel) <= DP_TRAIN_RTOL,
                f"(a) epoch losses over two ranks against phase 5's one process: worst rel "
                f"diff {max(rel):.3e} <= {DP_TRAIN_RTOL}")
    for name in ("lstm_seq_fwd", "lstm_seq_bwd"):
        fails.check(got[name] == 40, f"(a) {name} launched {got[name]} times over the ranks "
                                     "(2 layers x 10 steps x 2 ranks)")
    fails.check(got["lstm_seq_infer"] == 4, f"(a) lstm_seq_infer launched "
                f"{got['lstm_seq_infer']} times in the CV pass (2 layers x 2 ranks)")
    ms = [m for m, _ in res["steps"][1:]]
    print(f"  (a) two ranks on one card (NVIDIA H100, gloo): {wall:.1f} s in train(); steps "
          f"after the first {np.mean(ms):.2f} ms (min {min(ms):.2f}, max {max(ms):.2f}); "
          f"phase 5's one process {phase5['ms_per_step']:.2f} ms (full batches); first step "
          f"{res['steps'][0][0]:.1f} ms; losses {losses} against phase 5's "
          f"{phase5['epoch_losses']}; epoch walls against summed steps (s) "
          f"{[(round(w, 3), round(st, 3)) for _, w, st in res['epoch_times']]}", flush=True)
    rng = np.random.default_rng(SEED + 29)
    wav = os.path.join(work, "mix.wav")
    write_wav_int16(wav, 8000, mixture(5 * 8000, rng))
    pipe = SeparationPipeline(os.path.join(exp, "final.mdl"),
                              model_kwargs={"compute_dtype": "bfloat16"}, device="cuda")
    tracks = pipe.separate([load_wav(wav)[0]])[0]
    fails.check(len(tracks) == 2 and all(np.all(np.isfinite(t)) for t in tracks),
                "(a) the two ranks' final.mdl separates a wav on the card into finite tracks")
    out["train"] = {"wall_s": wall, "ms_per_step": float(np.mean(ms)), "losses": losses,
                    "loss_rel_diff": max(rel), "launches": got}

    # (b)-(d) one step of each job over two ranks, and (g) rank 1 raising at
    # its second step while rank 0 waits in the step's collectives, each in a
    # thread of its own while this process runs the same steps alone, then
    # (e) and (f): the spawned ranks' start-ups overlap
    jobs = _dp_step_jobs(train_dir, sf_train_dir)
    names = list(jobs)
    spawned, failing = {}, {}

    def over_ranks():
        t = time.monotonic()
        try:
            spawned["results"] = dict(zip(names, steps_over_ranks([jobs[n] for n in names],
                                                                  mesh=mesh)))
            # read at once; (g)'s launch raises before it would set it
            spawned["launches"] = dict(ranks.launch.kernel_launches)
        except Exception as e:
            spawned["error"] = repr(e)
        spawned["wall_s"] = time.monotonic() - t

    def fail_rank():
        t = time.monotonic()
        try:
            steps_over_ranks([jobs["upit"], dict(jobs["upit"], raise_on_rank=1)], mesh=mesh)
            failing["error"] = None
        except ranks.RankFailed as e:
            failing["error"] = str(e)
        failing["wall_s"] = time.monotonic() - t

    threads = [threading.Thread(target=over_ranks), threading.Thread(target=fail_rank)]
    for th in threads:
        th.start()
    sound = [n for n in names if "/" not in n]
    t0 = time.monotonic()
    single = dict(zip(sound, steps_over_ranks(
        [dict(jobs[n], batch=[pad_rows(sb, 2) for sb in jobs[n]["batch"]]
              if isinstance(jobs[n]["batch"], list) else pad_rows(jobs[n]["batch"], 2))
         for n in sound], device="cuda")))
    print(f"  the same {len(sound)} steps in one process: {time.monotonic() - t0:.1f} s",
          flush=True)

    # (e) serving through two replicas on cuda:0 against one device
    for c in counters:
        c.launches = 0
    sigs = [mixture(int(n), rng) for n in rng.integers(3 * 8000, 8 * 8000, size=20)]
    model = os.path.join(exp, "final.mdl")
    bf16 = {"compute_dtype": "bfloat16"}
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dp = SeparationPipeline(model, model_kwargs=bf16, batch_size=15, device="cuda",
                                mesh=mesh)
    fails.check(dp.batch_size == 16 and "batch_size 15 -> 16" in buf.getvalue(),
                f"(e) pipeline batch_size 15 -> {dp.batch_size} with the note: "
                f"{buf.getvalue().strip()!r}")
    t0 = time.monotonic()
    got_tracks = dp.separate(sigs)
    torch.cuda.synchronize()
    dp_s = time.monotonic() - t0
    served = {c.__name__: c.launches for c in counters}
    add(served)
    single_pipe = SeparationPipeline(model, model_kwargs=bf16, batch_size=16, device="cuda")
    want = [None] * len(sigs)
    t0 = time.monotonic()
    for i, t in single_pipe.separate_stream(sigs.__getitem__, [len(s) for s in sigs],
                                            pad_batches=True):
        want[i] = t
    one_s = time.monotonic() - t0
    d = max(float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))), 1e-12)
            for g, w in zip(got_tracks, want) for a, b in zip(g, w))
    fails.check(d <= DP_TRACK_TOL, f"(e) 20 requests through two replicas against one device: "
                                   f"max |difference| / peak {d:.3e} <= {DP_TRACK_TOL}")
    fails.check(served["stft"] == 4 and served["lstm_seq_infer"] == 8,
                f"(e) stft {served['stft']} and lstm_seq_infer {served['lstm_seq_infer']} "
                "launches (2 batches x 2 replicas; 2 layers each)")
    print(f"  (e) two replicas {dp_s:.2f} s, one device {one_s:.2f} s for 20 requests of "
          f"3-8 s", flush=True)
    out["serve"] = {"max_rel_diff": d, "replicas_s": dp_s, "one_device_s": one_s,
                    "launches": served}

    # (f) the CLI: separate --data-parallel on one card, then the device
    # scorer over a two-entry mesh on phase 10's test set
    for c in counters:
        c.launches = 0
    sep = os.path.join(work, "sep")
    code1, _ = _cli(["separate", model, os.path.join(sep, "one"), wav])
    code2, said = _cli(["separate", model, os.path.join(sep, "dp"), wav, "--data-parallel"])
    add({c.__name__: c.launches for c in counters})
    names_one = sorted(os.listdir(os.path.join(sep, "one")))
    same = code1 == code2 == 0 and names_one == sorted(os.listdir(os.path.join(sep, "dp"))) \
        and all(open(os.path.join(sep, "one", n), "rb").read()
                == open(os.path.join(sep, "dp", n), "rb").read() for n in names_one)
    fails.check(same and "note: --data-parallel with one visible device; running "
                "single-device" in said,
                f"(f) separate --data-parallel on one card: the note, and {len(names_one)} "
                "wavs bit-identical to the run without it")
    recipe = os.path.join(REPO, "build", "chip_smoke_recipe")
    tracks_dir = os.path.join(recipe, "exp", "uPIT_rtr", "output_final", "rtt")
    rows = {}
    t0 = time.monotonic()
    for tag, m in (("one", None), ("two", mesh)):
        dst = os.path.join(work, f"score_{tag}")
        _copy_wavs(tracks_dir, dst)
        evaluate_sources(os.path.join(recipe, "data", "rtt"), dst, device_scoring=True,
                         device="cuda", mesh=m, log=quiet)
        rows[tag] = _result_rows(dst)
    d = row_diff(rows["two"], rows["one"])
    fails.check(d <= DP_SCORE_DB, f"(f) score --device-scoring over a two-entry mesh "
                                  f"({len(rows['one']['SDR'])} utterances): max |difference| "
                                  f"{d:.3e} dB <= {DP_SCORE_DB}")
    out["score"] = {"max_diff_db": d, "wall_s": time.monotonic() - t0}

    for th in threads:
        th.join()
    fails.check("results" in spawned, f"(b)-(d) {len(names)} steps over two ranks ran "
                                      f"({spawned.get('error')})")
    over = spawned.get("results", {})
    got = spawned.get("launches", {})
    add(got)
    print(f"  (b)-(d) {len(names)} steps over two ranks: {spawned['wall_s']:.1f} s, "
          f"launches {got}", flush=True)
    for name in ("chunk_attention_fwd", "chunk_attention_bwd"):
        fails.check(got.get(name) == 16, f"(d) {name} launched {got.get(name)} times over the "
                                         "ranks (8 layers x 2 ranks)")
    for name in ("channel_norm_fwd", "channel_norm_bwd"):
        fails.check(got.get(name) == 32, f"(d) {name} launched {got.get(name)} times over the "
                                         "ranks (16 norms x 2 ranks)")
    errs = {}
    for n in over:
        sound_name, _, fault = n.partition("/")
        tol = DP_TOL["f32" if sound_name == "upit_f32" else "bf16"]
        e = step_errs(_dp_result(over[n]), _dp_result(single[sound_name]), tol)
        errs[n] = e
        part = {"rsh_mixed": "c", "sepformer": "d"}.get(sound_name, "b")
        if fault:
            check_fault(fails, f"({part}) {sound_name}: fault control {fault}", e, tol)
        else:
            check_step(fails, f"({part}) {n} over two ranks against one process", e, tol,
                       len(single[n]["grads"]))
    out["steps"] = errs
    fails.check(failing.get("error") is not None and "rank 1 of 2 exited with code 1"
                in failing["error"] and failing["wall_s"] < ranks.TIMEOUT_S,
                f"(g) rank 1 raising at step 2 ends the run: {failing.get('error')!r} after "
                f"{failing.get('wall_s', float('nan')):.1f} s (the group's timeout "
                f"{ranks.TIMEOUT_S:.0f} s)")
    out["failing_rank"] = failing
    for name, n in launches.items():
        fails.check(n > 0, f"{name} launched {n} times in phase 26")
    out["launches"] = launches
    # phase 27 holds its uPIT steps to these one-process steps (same jobs)
    reused = {n: {"job": jobs[n], "single": single[n]} for n in ("upit", "upit_f32")}
    return out, reused


# -------------------------------------------------------- tensor parallel

# Phase 27 runs tensor parallelism on one card: four ranks on cuda:0 over
# gloo, data 2 x model 2 (parallel/mesh.make_mesh(data=2, model=2)), one
# spawn for every job. Each job's step is held to the same step in one
# process (phase 26's for uPIT: the same weights, rows and initial states):
# the loss, the clip's global norm (every rank must see one value), every
# gradient as reduced over the data group and assembled from its model
# group's blocks, BN's running statistics, and each parameter's update (the
# updated parameter less the weight it started from), by relative L2 within
# TP_TOL; each fault control (parallel/ranks.FAULTS: gather_sums,
# no_input_reduce and world_sums on uPIT's head placement, shard_norm_stats
# on Conv-TasNet) must fail those bounds. TP_TOL is derived as DP_TOL is, for
# each arch and dtype: the geometric mean of the largest sound reading and
# the smallest fault reading, over the faults that move that quantity (a
# sound 0 taken as one f32 rounding, 6e-8), on an NVIDIA H100 80GB HBM3 at
# 700 W. No tensor-parallel fault moves uPIT's loss or BN's statistics (each
# acts on gradients only), so those two keep DP_TOL's bounds for the same job.
# Readings (sound -> bound <- fault):
# uPIT bf16 (head-only and lstm_gates alike; every gradient one bf16 rounding
#   off, the data axis's, as in phase 26): clip norm 4.9e-6 -> 9.4e-4 <- 1.8e-1
#   (no_input_reduce), worst gradient 2.2e-3 -> 4.0e-2 <- 7.2e-1, median
#   2.0e-3 -> 3.7e-2 <- 6.9e-1, updates 2.3e-2 -> 1.6e-1 <- 1.07;
# uPIT f32: clip norm 0 -> 1.0e-4 <- 1.8e-1, worst gradient 3.3e-6 -> 1.5e-3 <-
#   7.2e-1, median 4.4e-7 -> 5.5e-4 <- 6.9e-1, updates 1.1e-5 -> 3.5e-3 <- 1.07;
# Conv-TasNet bf16: loss 4.9e-4 -> 2.6e-3 <- 1.4e-2, clip norm 4.3e-3 -> 2.9e-2
#   <- 1.9e-1, worst gradient 5.8e-2 -> 1.5e-1 <- 3.7e-1, median 2.8e-2 ->
#   8.7e-2 <- 2.7e-1, updates 3.1e-1 -> 4.8e-1 <- 7.2e-1 (2.3x);
# Conv-TasNet f32: loss 0 -> 3.0e-5 <- 1.5e-2, clip norm 5.4e-6 -> 1.0e-3 <-
#   2.0e-1, worst gradient 7.4e-4 -> 1.7e-2 <- 3.8e-1, median 1.7e-4 -> 6.8e-3
#   <- 2.8e-1, updates 1.3e-1 -> 3.0e-1 <- 7.3e-1.
# The full-width Conv-TasNet step sits near its own rounding floor: the
# phase prints how far one process moves when its weights move by one ulp.
# gather_sums leaves the updates as they are (Adam's first step is nearly
# lr sign(g)) and world_sums the median gradient (it moves the split head's
# alone); each is caught by the others.
TP_MESH = ["cuda:0"] * 4
TP_TOL = {"uPIT": {"bf16": {"loss": 4.9e-6, "norm": 9.4e-4, "grad": 4.0e-2,
                            "grad_median": 3.7e-2, "bn": 1.3e-3, "param": 1.6e-1},
                   "f32": {"loss": 2.9e-6, "norm": 1.0e-4, "grad": 1.5e-3,
                           "grad_median": 5.5e-4, "bn": 6.3e-5, "param": 3.5e-3}},
          "ConvTasNet": {"bf16": {"loss": 2.6e-3, "norm": 2.9e-2, "grad": 1.5e-1,
                                  "grad_median": 8.7e-2, "param": 4.8e-1},
                         "f32": {"loss": 3.0e-5, "norm": 1.0e-3, "grad": 1.7e-2,
                                 "grad_median": 6.8e-3, "param": 3.0e-1}}}
# Conv-TasNet's rows: the first 8 of phase 8's 4 s training wavs (phase 20
# trains on batches of 32, whose one-process bf16 step peaks at 34.4 GB; four
# ranks and the one-process reference share the card here)
TP_CT_ROWS = 8
TP_FAULTS = {"head": ("gather_sums", "no_input_reduce", "world_sums"),
             "convtasnet": ("shard_norm_stats",)}


def tp_errs(got: dict, ref: dict, weights: dict, tol: dict) -> dict:
    """A tensor-parallel step's result against one process's
    (``step_errs`` plus the clip's norm, the ranks' agreement on it and the
    parameters' updates by relative L2, the worst)."""
    e = step_errs(_dp_result(got), _dp_result(ref), tol)
    e["norm_rel_err"] = abs(got["clip_norm"] - ref["clip_norm"]) / abs(ref["clip_norm"])
    e["norms_agree"] = len(set(got["clip_norms"])) == 1
    upd = {n: rel_l2(got["params"][n] - weights[n], ref["params"][n] - weights[n])
           for n in ref["grads"]}
    e["param_worst"] = max(upd, key=upd.get)
    e["param_rel_err"] = upd[e["param_worst"]]
    return e


def check_tp_step(fails: Failures, what: str, e: dict, tol: dict, n_params: int) -> None:
    check_step(fails, what, e, tol, n_params)
    fails.check(e["norm_rel_err"] <= tol["norm"] and e["norms_agree"],
                f"{what} clip norm: rel err {e['norm_rel_err']:.3e} <= {tol['norm']}, one "
                f"value on every rank ({e['norms_agree']})")
    fails.check(e["param_rel_err"] <= tol["param"],
                f"{what} parameter updates: worst {e['param_worst']} rel err "
                f"{e['param_rel_err']:.3e} <= {tol['param']}")


def check_tp_fault(fails: Failures, what: str, e: dict, tol: dict) -> None:
    """A fault control must fail a bound the sound step meets: its loss, the
    clip's norm, the median gradient, most gradients, BN or the updates."""
    bn = e.get("bn_rel_err")
    caught = (e["loss_rel_err"] > tol["loss"] or e["norm_rel_err"] > tol["norm"]
              or e["median_err"] > tol["grad_median"] or e["over_bound"] > e["n"] // 2
              or (bn is not None and bn > tol["bn"]) or e["param_rel_err"] > tol["param"])
    fails.check(caught, f"{what}: loss {e['loss_rel_err']:.3e} ({tol['loss']}), clip norm "
                        f"{e['norm_rel_err']:.3e} ({tol['norm']}), median gradient "
                        f"{e['median_err']:.3e} ({tol['grad_median']}), {e['over_bound']} of "
                        f"{e['n']} gradients over {tol['grad']} (worst {e['worst']} "
                        f"{e['worst_err']:.3e})" + (f", BN {bn:.3e} ({tol['bn']})" if bn
                                                    is not None else "")
                        + f", updates {e['param_rel_err']:.3e} ({tol['param']}): caught")


def _tp_jobs(upit: dict, sf_train_dir: str) -> tuple[dict, dict]:
    """Phase 27's jobs ("<placement>/<dtype>[/<fault>]") and Conv-TasNet's
    one-process jobs by dtype: uPIT 2x600 on phase 26's job (100 rows of
    phase 5's corpus), head-only and lstm_gates, the bf16 ones also timed;
    Conv-TasNet at its defaults on TP_CT_ROWS of phase 8's wavs."""
    from speech_separation_tpu_torch.models import convtasnet
    from speech_separation_tpu_torch.train.wav_data import WavDataset, collate_wav_batch
    ct = {"arch": "ConvTasNet", "model_kwargs": CONVTASNET_KW, "seed": SEED,
          "batch": collate_wav_batch(WavDataset(sf_train_dir), list(range(TP_CT_ROWS)),
                                     TP_CT_ROWS),
          "weights": _dp_weights(convtasnet.ConvTasNet(convtasnet.Config.from_kwargs(
              **CONVTASNET_KW)), SEED + 30)}
    cts = {"bf16": ct, "f32": dict(ct, model_kwargs={**CONVTASNET_KW, "compute_dtype": "float32"})}
    jobs = {}
    for dt, up in (("bf16", upit["upit"]["job"]), ("f32", upit["upit_f32"]["job"])):
        for tp in ("head", "lstm_gates"):
            jobs[f"{tp}/{dt}"] = dict(up, tp=tp, time_steps=3 if dt == "bf16" else 0)
        jobs[f"convtasnet/{dt}"] = dict(cts[dt], tp="convtasnet")
        for tp, faults in TP_FAULTS.items():
            base = up if tp == "head" else cts[dt]
            for f in faults:
                jobs[f"{tp}/{dt}/{f}"] = dict(base, tp=tp, faults=(f,))
    return jobs, cts


def tensor_parallel_phase(fails: Failures, counters, sf_train_dir: str, upit: dict,
                          step_ms: dict) -> dict:
    """Phase 27: tensor parallelism on one card (module docstring, item 27).
    ``upit`` holds phase 26's uPIT jobs and their one-process results;
    ``step_ms`` the uPIT bf16 step of phase 5 (one process) and phase 26 (a)
    (two data-parallel ranks), printed beside the dp2 x tp2 steps."""
    from speech_separation_tpu_torch.parallel import ranks
    from speech_separation_tpu_torch.parallel.checks import steps_over_ranks
    from speech_separation_tpu_torch.parallel.mesh import make_mesh

    torch.cuda.empty_cache()          # the ranks need the card's memory
    mesh = make_mesh(data=2, model=2, devices=TP_MESH)
    jobs, cts = _tp_jobs(upit, sf_train_dir)
    names = list(jobs)
    spawned = {}

    def over_ranks():
        t = time.monotonic()
        try:
            spawned["results"] = dict(zip(names, steps_over_ranks([jobs[n] for n in names],
                                                                  mesh=mesh)))
            spawned["launches"] = dict(ranks.launch.kernel_launches)
        except Exception as e:
            spawned["error"] = repr(e)
        spawned["wall_s"] = time.monotonic() - t

    th = threading.Thread(target=over_ranks)
    th.start()
    # Conv-TasNet's one-process steps while the ranks start, and the same
    # with its weights moved by one ulp (a random relative 1.2e-7): how far
    # the step moves by rounding alone
    gen = torch.Generator().manual_seed(SEED + 31)
    nudged = {k: v * (1 + 1.2e-7 * torch.randn(v.shape, generator=gen))
              for k, v in cts["bf16"]["weights"].items()}
    t0 = time.monotonic()
    runs = steps_over_ranks([*cts.values(), *(dict(j, weights=nudged) for j in cts.values())],
                            device="cuda")
    one_s = time.monotonic() - t0
    single = {("convtasnet", dt): r for dt, r in zip(cts, runs)}
    for dt, r in zip(cts, runs[len(cts):]):
        e = step_errs(_dp_result(r), _dp_result(single["convtasnet", dt]),
                      TP_TOL["ConvTasNet"][dt])
        print(f"  Conv-TasNet {dt} in one process, weights moved one ulp: loss "
              f"{e['loss_rel_err']:.3e}, gradients worst {e['worst']} {e['worst_err']:.3e} "
              f"median {e['median_err']:.3e}", flush=True)
    single.update({(tp, dt): upit[n]["single"] for n, dt in (("upit", "bf16"),
                                                             ("upit_f32", "f32"))
                   for tp in ("head", "lstm_gates")})
    th.join()
    fails.check("results" in spawned, f"{len(names)} steps over data 2 x model 2 ranks ran "
                                      f"({spawned.get('error')})")
    over = spawned.get("results", {})
    launches = {c.__name__: spawned.get("launches", {}).get(c.__name__, 0) for c in counters}
    print(f"  {len(names)} steps over four ranks: {spawned['wall_s']:.1f} s (Conv-TasNet's "
          f"one-process steps beside them {one_s:.1f} s), launches {launches}; each job's "
          f"wall (s) {({n: round(r['wall_s'], 2) for n, r in over.items()})}", flush=True)
    errs = {}
    for n, got in over.items():
        tp, dt, *fault = n.split("/")
        ref = single[tp, dt]
        tol = TP_TOL[jobs[n]["arch"]][dt]
        e = tp_errs(got, ref, jobs[n]["weights"], tol)
        errs[n] = e
        if fault:
            check_tp_fault(fails, f"{tp} {dt}: fault control {fault[0]}", e, tol)
        else:
            check_tp_step(fails, f"{tp} {dt} over dp2 x tp2 against one process", e, tol,
                          len(ref["grads"]))
            print(f"    readings: loss {e['loss_rel_err']:.3e}, clip norm "
                  f"{e['norm_rel_err']:.3e}, gradients worst {e['worst']} {e['worst_err']:.3e} "
                  f"median {e['median_err']:.3e}, BN {e.get('bn_rel_err', float('nan')):.3e}, "
                  f"updates worst {e['param_worst']} {e['param_rel_err']:.3e}", flush=True)
    # uPIT: 10 jobs x 2 layers x 4 ranks, and 2 x 3 timed steps x 2 layers x 4 ranks
    for name in ("lstm_seq_fwd", "lstm_seq_bwd"):
        fails.check(launches[name] == 128, f"{name} launched {launches[name]} times over the "
                                           "four ranks (16 uPIT steps x 2 layers x 4 ranks)")
    timed = {tp: over[f"{tp}/bf16"]["step_ms"] for tp in ("head", "lstm_gates")
             if f"{tp}/bf16" in over}
    print(f"  uPIT bf16 step at B=100 on one card ({torch.cuda.get_device_name(0)}): dp2 x tp2 "
          + ", ".join(f"{tp} {np.mean(ms):.2f} ms ({min(ms):.2f}-{max(ms):.2f})"
                      for tp, ms in timed.items())
          + f"; phase 26's dp2 {step_ms['dp2']:.2f} ms; phase 5's one process "
            f"{step_ms['one']:.2f} ms", flush=True)
    return {"steps": errs, "step_ms": timed, "wall_s": spawned["wall_s"], "launches": launches}


def _kernel_group(name: str) -> str:
    if "attn_fwd_" in name:                 # attn_fwd_kernel (f32), _rows, _passes (bf16)
        return "K5 forward"
    if "attn_bwd_" in name:
        return "K5 backward"
    if "chan_ln_" in name:                  # chan_ln_fwd, chan_ln_bwd, chan_ln_bwd_params
        return "K6 LayerNorm"
    if any(s in name.lower() for s in ("gemm", "cutlass", "xmma", "gemv")):
        return "products (cuBLAS)"
    if "elementwise" in name or "vectorized" in name:
        return "elementwise"
    if "reduce" in name.lower():
        return "reductions"
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return "copies and fills"
    return "other"


# The training step's products outside the kernels (phase 28): each at its
# main shape, today's float32 product of the bf16-rounded operands (operands
# already cast to float32, its rounding included) against ops/mxu.mxu_dot,
# bf16 operands on the tensor cores with float32 sums, as the step now runs
# it (uPIT's 257 bins padded to 264, the long weight-gradient sums in pieces
# of at most mxu.SUM_TERMS), beside the least time the card could take
# (bound_ms: the operands read once, the result written once, or the
# operations at the peak of the product's dtype). The forward's results
# rounded to bf16 (uPIT's and DPRNN's BLSTM projections, DPRNN's linear
# layers and the dual-path bottleneck) and the float32-cotangent gradients
# stay in float32 by rule (ops/mxu.py) and are timed as they run.
# SepFormer's four transformer-layer products (qkv, out, ff1, ff2 at the
# 132,000 rows of a sepformer-train-b16 path, with their float32 bias) are
# timed as rounded_dot runs them by that rule, the operands' float32 copies
# included, against any_order_dot, which sums them on the tensor cores.
# Checks: no float32 GEMM kernel (simt, f32f32) behind a bf16 product, each
# result within relative L2 of today's of 1e-5 (float32) or 2**-8 (rounded
# to bf16, where another order of the sum moves some elements by a step;
# tests/test_torch_cuda.py holds uPIT's and DPRNN's to the float64 sum),
# and the counters of one uPIT step (B=100, T=384), one DPRNN step (B=32,
# 4 s) and one published SepFormer step (B=4, 4 s; the counts do not
# depend on the batch).

def _kernel_names(fn) -> list:
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_time_total > 0 and "Memset" not in e.key})


def _step_counts(model, batch, loss_fn) -> dict:
    from speech_separation_tpu_torch.ops.mxu import mxu_dot
    keys = ("tensor_core", "f32", "any_order")
    before = {k: getattr(mxu_dot, k) for k in keys}
    loss, _ = loss_fn(model, batch, torch.Generator(device="cuda").manual_seed(SEED), True)
    loss.backward()
    torch.cuda.synchronize()
    return {k: getattr(mxu_dot, k) - before[k] for k in keys}


def products_phase(fails: Failures) -> dict:
    import torch.nn.functional as F
    from speech_separation_tpu_torch.models import dprnn, sepformer, upit
    from speech_separation_tpu_torch.ops.mxu import any_order_dot, mxu_dot, rounded_dot

    gen = torch.Generator(device="cuda").manual_seed(SEED + 28)
    bf, f32 = torch.bfloat16, torch.float32

    def rnd(*shape, scale=1.0, dtype=bf):
        return (scale * torch.randn(shape, generator=gen, device="cuda")).to(dtype)

    def pad(t, dim):
        return F.pad(t, (0, 0, 0, 7) if dim == -2 else (0, 7))

    def cases(arch):
        """(name, a, b, result dtype, uses a step, bias): each product of one
        step; a bias marks SepFormer's transformer-layer products."""
        if arch == "sepformer":
            # LayerNorm'd rows (or ReLU'd for ff2) by U(+-1/sqrt(k)) weights and biases
            return [(name, rnd(132000, k), rnd(k, n, scale=(3 * k) ** -0.5),
                     bf, 32, rnd(n, scale=(3 * k) ** -0.5, dtype=f32))
                    for name, k, n in (("qkv", 256, 768), ("out", 256, 256),
                                       ("ff1", 256, 1024), ("ff2", 1024, 256))]
        if arch == "upit":
            x1, w1 = pad(rnd(2, 38400, 257, scale=0.5), -1), pad(rnd(2, 257, 2400, scale=0.06), -2)
            x, w = rnd(2, 38400, 1200, scale=0.5), rnd(2, 1200, 2400, scale=0.03)
            gy, hp = rnd(2, 38400, 2400, scale=1e-3), rnd(2, 38400, 600, scale=0.5)
            y, wh = rnd(38400, 1200, scale=0.5), rnd(514, 1200, scale=0.03).t()
            gh = rnd(38400, 514, scale=1e-3, dtype=f32)
            return [("projection 1 (f32)", x1.float(), w1.float(), bf, 1),
                    ("projection 1 dW", x1.transpose(1, 2), gy, bf, 1),
                    ("projection 2 (f32)", x.float(), w.float(), bf, 1),
                    ("projection 2 dx", gy, w.transpose(1, 2), bf, 1),
                    ("projection 2 dW", x.transpose(1, 2), gy, bf, 1),
                    ("dW_hh", hp.transpose(1, 2), gy, bf, 2), ("head", y, wh, f32, 1),
                    ("head dx (f32)", gh, wh.float().t(), f32, 1),
                    ("head dW (f32)", y.float().t(), gh, f32, 1)]
        x, w = rnd(2, 259200, 64, scale=0.5), rnd(2, 64, 512, scale=0.1)
        gy, hp = rnd(2, 259200, 512, scale=1e-3), rnd(2, 259200, 128, scale=0.5)
        xl, wl, gl = rnd(259200, 256, scale=0.5), rnd(256, 64, scale=0.06), rnd(259200, 64, scale=1e-3)
        return [("projection (f32)", x.float(), w.float(), bf, 12),
                ("projection dx", gy, w.transpose(1, 2), bf, 12),
                ("projection dW", x.transpose(1, 2), gy, bf, 12), ("dW_hh", hp.transpose(1, 2), gy, bf, 12),
                ("linear 256->64 (f32)", xl.float(), wl.float(), bf, 12), ("linear dx", gl, wl.t(), bf, 12),
                ("linear dW", xl.t(), gl, bf, 12)]

    out = {}
    for arch in ("upit", "dprnn", "sepformer"):
        rows, new_sum, old_sum = {}, 0.0, 0.0
        for name, a, b, odt, uses, *bias in cases(arch):
            if bias:
                new = lambda: any_order_dot(a, b, bf, odt, bias[0])
                old = lambda: rounded_dot(a, b, bf, odt, bias[0])
            else:
                af, bf_ = a.float(), b.float()
                new = lambda: mxu_dot(a, b, odt)
                old = lambda: torch.matmul(af, bf_).to(odt)
            got, ref = new().float(), old().float()
            gap = float((got - ref).norm() / ref.norm().clamp_min(1e-30))
            ms, old_ms = cuda_ms(new, 10), cuda_ms(old, 10)
            k, m, n = a.shape[-1], a.shape[-2], b.shape[-1]
            flops = 2 * (a.numel() // (m * k)) * m * n * k
            io = nbytes(a, b, *bias) + got.numel() * (2 if odt == bf else 4)
            bound, by = bound_ms(io, flops, a.dtype)
            names = _kernel_names(new)
            fails.check(gap <= (2.0 ** -8 if odt == bf else 1e-5),
                        f"{arch} {name}: {gap:.2e} from today's product")
            if a.dtype == bf:
                fails.check(not any("simt" in k_ or "f32f32_f32f32" in k_ for k_ in names),
                            f"{arch} {name} runs no float32 GEMM kernel")
            rows[name] = {"ms": ms, "f32_ms": old_ms, "bound_ms": bound, "bound_by": by,
                          "gap": gap, "uses": uses, "kernels": names}
            new_sum, old_sum = new_sum + uses * ms, old_sum + uses * old_ms
            print(f"  {arch} {name} {tuple(a.shape)} x {tuple(b.shape)} -> {odt}: {ms:.3f} ms, "
                  f"today's f32 {old_ms:.3f} ms, bound {bound:.3f} ms ({by}), "
                  f"{100 * bound / ms:.1f}% of it; x{uses} a step; {names}", flush=True)
            del got, ref
            af = bf_ = None     # the float32 copies, freed before the next case
        out[arch] = {"products": rows, "step_ms": new_sum, "f32_step_ms": old_sum}
        print(f"  {arch}: the step's products {new_sum:.2f} ms against today's {old_sum:.2f} ms",
              flush=True)
        torch.cuda.empty_cache()

    cfg = upit.Config(hidden=600, num_layers=2, zero_init_hidden=True, compute_dtype="bfloat16")
    with torch.device("cuda"):
        model = upit.Model(cfg)
        B, T = 100, 384
        mix = torch.rand((B, T, 257), generator=gen, device="cuda")
        batch = {"mix": mix, "sources": torch.rand((B, 2, T, 257), generator=gen, device="cuda"),
                 "lengths": torch.full((B,), T, dtype=torch.int32), "row_mask": torch.ones(B)}
    out["upit"]["counts"] = _step_counts(model, batch, upit.loss_fn)
    del model, batch
    with torch.device("cuda"):
        model = dprnn.Model(dprnn.Config(compute_dtype="bfloat16"))
        src = 0.1 * torch.randn((32, 2, 32000), generator=gen, device="cuda")
        batch = {"mix_wav": src.sum(1), "source_wavs": src,
                 "sample_lengths": torch.full((32,), 32000, dtype=torch.int32),
                 "row_mask": torch.ones(32)}
    out["dprnn"]["counts"] = _step_counts(model, batch, dprnn.loss_fn)
    del model, batch, src
    with torch.device("cuda"):
        model = sepformer.Model(sepformer.Config.from_kwargs(**SEPFORMER_PUBLISHED))
        src = 0.1 * torch.randn((4, 2, 32000), generator=gen, device="cuda")
        batch = {"mix_wav": src.sum(1), "source_wavs": src,
                 "sample_lengths": torch.full((4,), 32000, dtype=torch.int32),
                 "row_mask": torch.ones(4)}
    out["sepformer"]["counts"] = _step_counts(model, batch, sepformer.loss_fn)
    del model, batch, src
    torch.cuda.empty_cache()
    # uPIT: the head forward, 3 projection gradients and 2 dW_hh on the
    # tensor cores, the 2 projections (rounded to bf16) and the head's 2
    # gradients in float32; DPRNN: 3 forward products (encoder, head,
    # decoder) and 62 backward ones on the tensor cores, the 25 forward
    # products rounded to bf16 and 5 float32-cotangent gradients in float32;
    # neither takes any_order_dot. SepFormer (2 blocks x 2 paths x 8 layers):
    # any_order_dot's 128 forward products (4 a layer) and their 256
    # gradients, the forward's 6 float32 results (encoder, head, the gate's
    # three, decoder) and the bottleneck's 2 gradients on the tensor cores;
    # the bottleneck's forward (rounded to bf16) and 11 float32-cotangent
    # gradients (the encoder's dW; the head's, the gate's three and the
    # decoder's dx and dW) in float32
    for arch, want in (("upit", {"tensor_core": 6, "f32": 4, "any_order": 0}),
                       ("dprnn", {"tensor_core": 65, "f32": 30, "any_order": 0}),
                       ("sepformer", {"tensor_core": 392, "f32": 12, "any_order": 128})):
        fails.check(out[arch]["counts"] == want,
                    f"{arch} step: mxu_dot counted {out[arch]['counts']} (want {want})")
    return out


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
    from speech_separation_tpu_torch.ops.layernorm_kernel import (channel_norm_bwd,
                                                                  channel_norm_fwd)
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
    _build.build(_build.TABLE)
    print(f"  nvcc and g++ (parallel): {time.monotonic() - t0:.1f} s", flush=True)
    for name, log in _build.build_logs.items():
        for line in log.splitlines():       # each kernel's name, then its registers and spills
            if "Function properties for" in line:
                print(f"  {name}: {line.split('Function properties for')[1].strip()}")
            elif "registers" in line or "spill" in line:
                print(f"  {name}:   {line.strip()}")

    print("== 3. kernels against their plain versions", flush=True)
    lstm = check_lstm(fails)
    stft_nums = check_stft(fails)
    lstm_train = check_lstm_train(fails)
    attention = check_attention(fails)
    layernorm = check_layernorm(fails)
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
    ln_counters = [channel_norm_fwd, channel_norm_bwd]
    print("== 7. serve (SepFormer, bf16, fused attention)", flush=True)
    served_sf = serve_sepformer_phase(fails, attn_counters + ln_counters)

    print("== 8. train (SepFormer, bf16, fused attention, B=32, 4 s)", flush=True)
    trained_sf = train_sepformer_phase(fails, attn_counters + ln_counters)
    launches.update(trained_sf["launches"])

    k5_ms = 4 * sum(attention[p][s]["ms"] for p in ("fwd", "bwd")
                    for s in (torch.bfloat16, "inter"))
    print(f"  K5 at the step's shapes (4 intra and 4 inter layers, forward and backward, "
          f"timed apart in phase 3): {k5_ms:.2f} ms of {trained_sf['ms_per_step']:.2f} ms "
          f"per step ({100 * k5_ms / trained_sf['ms_per_step']:.1f}%)", flush=True)

    print("== 9. one SepFormer step: fused against einsum, card against CPU", flush=True)
    step_sf = sepformer_step_phase(fails, trained_sf["train_dir"])
    print(f"  phase 9 done at {time.monotonic() - t_start:.1f} s", flush=True)

    print("== 10. recipe: run-train and run-eval through the CLI (2x600 uPIT, bf16)", flush=True)
    t10 = time.monotonic()
    recipe = recipe_phase(fails, [stft, lstm_seq_infer, lstm_seq_fwd, lstm_seq_bwd,
                                  *attn_counters])
    print(f"  phase 10: {time.monotonic() - t10:.1f} s", flush=True)

    lstm_counters = [lstm_seq_infer, lstm_seq_fwd, lstm_seq_bwd]
    print("== 11. K1, K3, K4 at DPRNN's shapes; gradients through chained calls", flush=True)
    recurrent = check_recurrent_kernels(fails)

    print("== 12. train (2x600 RSH, bf16, B=100; then mixed batches)", flush=True)
    t12 = time.monotonic()
    trained_rsh = train_rsh_phase(fails, lstm_counters)

    print("== 13. one RSH step, card against CPU", flush=True)
    step_rsh = rsh_step_phase(fails, trained_rsh["train_dir"])

    print("== 14. RSH run-eval through the CLI, then served with 2 and 3 sources", flush=True)
    eval_rsh = rsh_eval_phase(fails, [stft, *lstm_counters], trained_rsh["exp"])
    print(f"  phases 12-14: {time.monotonic() - t12:.1f} s", flush=True)

    print("== 15. train (DPRNN, bf16, B=32, 4 s)", flush=True)
    t15 = time.monotonic()
    trained_dprnn = train_dprnn_phase(fails, lstm_counters)

    print("== 16. one DPRNN step, card against CPU", flush=True)
    step_dprnn = dprnn_step_phase(fails, trained_dprnn["train_dir"])

    print("== 17. serve (DPRNN, bf16): ragged batches with length-0 chunks", flush=True)
    served_dprnn = serve_dprnn_phase(fails, lstm_counters)
    print(f"  phases 15-17: {time.monotonic() - t15:.1f} s", flush=True)

    print("== 18. remat: uPIT and RSH steps (2x600 bf16, B=100) with and without", flush=True)
    t18 = time.monotonic()
    remat = remat_phase(fails, lstm_counters, trained["train_dir"])
    print(f"  phase 18: {time.monotonic() - t18:.1f} s", flush=True)

    print("== 19. TCN (bf16, 257 -> 256 x 512, 8 x 4 blocks): train, step, serve", flush=True)
    t19 = time.monotonic()
    tcn_nums = tcn_phase(fails, stft, trained["train_dir"], trained_sf["train_dir"])
    print(f"  phase 19: {time.monotonic() - t19:.1f} s", flush=True)

    print("== 20. Conv-TasNet (bf16, N=256, H=512, 8 x 3 blocks, gLN): train (B=32, 4 s), "
          "step, serve", flush=True)
    t20 = time.monotonic()
    convtasnet_nums = convtasnet_phase(fails, trained_sf["train_dir"])
    print(f"  phase 20: {time.monotonic() - t20:.1f} s", flush=True)

    print("== 21. live streaming: causal TCN and Conv-TasNet pools of 8, then the server",
          flush=True)
    t21 = time.monotonic()
    streaming = stream_phase(fails, stft)
    print(f"  phase 21: {time.monotonic() - t21:.1f} s", flush=True)

    print("== 22. tools: doctor, warmup and bench (5 phases) through the CLI", flush=True)
    t22 = time.monotonic()
    tools = tools_phase(fails)
    print(f"  phase 22: {time.monotonic() - t22:.1f} s", flush=True)

    print("== 23. device scoring: score and run-eval --device-scoring (float64 on the card), "
          "a SEPTPU01 checkpoint through run-eval", flush=True)
    t23 = time.monotonic()
    scoring = device_scoring_phase(fails, [stft, *lstm_counters], recipe, eval_rsh)
    print(f"  phase 23: {time.monotonic() - t23:.1f} s", flush=True)

    print("== 24. oracle: soft and hard masks, device and host scoring, card and CPU",
          flush=True)
    t24 = time.monotonic()
    oracle = oracle_phase(fails, stft)
    print(f"  phase 24: {time.monotonic() - t24:.1f} s", flush=True)

    print("== 25. training extras: pack-features, the three collations, the f16 cache, "
          "the watchdog, the profiler, staging", flush=True)
    t25 = time.monotonic()
    extras = extras_phase(fails, lstm_counters, trained["train_dir"])
    print(f"  phase 25: {time.monotonic() - t25:.1f} s", flush=True)

    print("== 26. data parallel on one card: uPIT trained over two ranks; uPIT, RSH "
          "(mixed) and SepFormer steps over two ranks against one process, with fault "
          "controls; two pipeline replicas; the CLI; the scorer over a mesh; a failing rank",
          flush=True)
    t26 = time.monotonic()
    dp, dp_upit = data_parallel_phase(fails, [stft, *lstm_counters, *attn_counters,
                                              *ln_counters],
                                      trained["train_dir"], trained_sf["train_dir"], trained,
                                      extras["native_dir"])
    print(f"  phase 26: {time.monotonic() - t26:.1f} s", flush=True)

    print("== 27. tensor parallel on one card: uPIT (head-only and lstm_gates) and "
          "Conv-TasNet steps over data 2 x model 2 ranks against one process, bf16 and f32, "
          "with fault controls", flush=True)
    t27 = time.monotonic()
    tp = tensor_parallel_phase(fails, [stft, *lstm_counters, *attn_counters],
                               trained_sf["train_dir"], dp_upit,
                               {"one": trained["ms_per_step"], "dp2": dp["train"]["ms_per_step"]})
    del dp_upit
    print(f"  phase 27: {time.monotonic() - t27:.1f} s", flush=True)

    print("== 28. the training step's products: today's f32 against the tensor cores",
          flush=True)
    t28 = time.monotonic()
    products = products_phase(fails)
    print(f"  phase 28: {time.monotonic() - t28:.1f} s", flush=True)
    paths = {"rsh_train": trained_rsh["launches"], "rsh_mixed": trained_rsh["mixed_launches"],
             "rsh_masks": eval_rsh["launches"]["masks"], "rsh_serve": eval_rsh["serve_launches"],
             "dprnn_train": trained_dprnn["launches"], "dprnn_serve": served_dprnn["launches"],
             **{f"{arch.lower()}_{mode}_step": remat[arch][mode]["launches"]
                for arch in ("uPIT", "RSH") for mode in ("plain", "remat")},
             "septpu01_masks": {"lstm_seq_infer": scoring["septpu01"]["k1_launches"]},
             **{f"extras_{k}_train": c for k, c in extras["launches"].items()}}

    def row(name, route, source, replaces, nums, extra):
        lstm_extra = {}
        if name.startswith("lstm_seq"):
            lstm_extra = {"dprnn": {shape: recurrent[shape][name] for shape in DPRNN_SHAPES},
                          "path_launches": {p: c[name] for p, c in paths.items() if name in c}}
        return {"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": launches[name], **{k: nums[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                "recipe_launches": recipe["launches"][name],
                "data_parallel_launches": dp["launches"][name],
                "tensor_parallel_launches": tp["launches"][name],
                "bench_launches": {p: c[name] for p, c in tools["launches"].items()
                                   if c.get(name)}, **extra, **lstm_extra}

    kernels = [
        row("lstm_seq_infer", "cuda", "speech_separation_tpu_torch/csrc/lstm_fwd.cu",
            "speech_separation_tpu/ops/lstm_pallas.py:288", lstm[torch.bfloat16],
            {"dtype": "bfloat16", "float32": lstm[torch.float32],
             "recipe": recipe["kernels"]["lstm_seq_infer"]}),
        row("stft", "cuda", "speech_separation_tpu_torch/csrc/stft.cu",
            "speech_separation_tpu/ops/stft_pallas.py:77", stft_nums["serve"]["re_im"],
            {"unfold_matmul_ms": stft_nums["serve"]["re_im"]["unfold_matmul_ms"],
             "magnitude": stft_nums["serve"]["magnitude"], "plan": stft_nums["serve"]["plan"],
             "shape": stft_nums["serve"]["shape"], "features": stft_nums["features"],
             "recipe": {k: recipe["kernels"][k] for k in ("stft_re_im", "stft_magnitude")},
             "path_launches": {"tcn_serve": tcn_nums["serve_launches"]["stft"],
                               "tcn_train_on_device_features": tcn_nums["train_k2_launches"],
                               "oracle_soft": oracle["soft"]["k2_launches"],
                               "oracle_hard": oracle["hard"]["k2_launches"]}}),
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
                           {"dtype": "bfloat16", "plan": nums[torch.bfloat16]["plan"],
                            "hmma": nums[torch.bfloat16]["hmma"], "float32": nums[torch.float32],
                            "inter": nums["inter"], "long": nums["long"],
                            "serve_launches": served_sf["launches"][name]}))
    for name, part in (("channel_norm_fwd", "fwd"), ("channel_norm_bwd", "bwd")):
        kernels.append({"name": name, "route": "cuda",
                        "source": "speech_separation_tpu_torch/csrc/layernorm.cu",
                        "replaces": "none: speech_separation_tpu/models/tcn.py:150 _cln, "
                                    "plain jnp that XLA fuses",
                        "launches": trained_sf["launches"][name], "dtype": "bfloat16",
                        **layernorm["sepformer"][part], "tcn": layernorm["tcn"][part],
                        "serve_launches": served_sf["launches"][name]})
    print(f"  serve: {served}", flush=True)
    print(f"  train: {({k: v for k, v in trained.items() if k != 'train_dir'})}", flush=True)
    print(f"  lstm_seq gradients: {lstm_train['grad']}", flush=True)
    print(f"  card vs CPU step: {step}", flush=True)
    print(f"  SepFormer serve: {served_sf}", flush=True)
    print(f"  SepFormer train: {({k: v for k, v in trained_sf.items() if k != 'train_dir'})}",
          flush=True)
    print(f"  SepFormer step: {step_sf}", flush=True)
    print(f"  recipe: {({k: v for k, v in recipe.items() if k != 'stage_launches'})}",
          flush=True)
    print(f"  lstm_seq gradients through chained calls: {recurrent['chained']}", flush=True)
    print(f"  RSH train: {({k: v for k, v in trained_rsh.items() if k not in ('train_dir', 'exp')})}",
          flush=True)
    print(f"  RSH step: {step_rsh}", flush=True)
    print(f"  RSH eval and serve: {eval_rsh}", flush=True)
    print(f"  DPRNN train: {({k: v for k, v in trained_dprnn.items() if k != 'train_dir'})}",
          flush=True)
    print(f"  DPRNN step: {step_dprnn}", flush=True)
    print(f"  DPRNN serve: {served_dprnn}", flush=True)
    print(f"  remat: {remat}", flush=True)
    print(f"  TCN: {tcn_nums}", flush=True)
    print(f"  Conv-TasNet: {convtasnet_nums}", flush=True)
    print(f"  streaming: {streaming}", flush=True)
    print(f"  tools: doctor {tools['doctor_s']:.1f} s, warmup {tools['warmup_s']:.1f} s, "
          f"bench {tools['bench_s']:.1f} s", flush=True)
    print(f"  device scoring: {scoring}", flush=True)
    print(f"  oracle: {oracle}", flush=True)
    print(f"  training extras: {extras}", flush=True)
    print(f"  data parallel: {dp}", flush=True)
    print(f"  tensor parallel: {tp}", flush=True)
    print(f"  products: {products}", flush=True)
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
