"""Training steps back to back through the port's ``train.loop.update_step``.

Set-up builds one model and its ``Optimizer`` from the seed, with the
trainer's one bias per LSTM direction, and a ring of four distinct batches
made on the card from the seed. It drives that same object through its
first three steps (the first builds and loads the kernels) on ring batches
0, 1 and 2, records each step's loss, the first clipped gradient (Adam's
first moment after one step, over 1 - beta1) and each leaf's change after
the three, then hands it to the window, which cycles the ring from batch 3.

The mix's parameters: ``batch`` rows; for a spectral arch ``frames`` (the
padded T) and ``min_frames``, ``max_frames`` (each row's true length: a
fixed set of evenly spaced lengths, shuffled by the seed, so every seed
carries the same audio); for a waveform arch ``seconds`` a row, every row
whole. Each row's sources get gains 10^U(-0.5, 0.5) of their own, so rows'
losses differ.

End to end: ``train_audio_s_per_s``, the true audio seconds of every step
over the window's wall (host clock, ending in a synchronize). ``correct``:
the plain reference follows the same three steps from the same weights on
the same batches; compared are (as the cell's ``checks`` list them) the
worst row's gap of the first step's outputs, the median row's gap of the
loss's gradient with respect to them (each row's share of the loss, as the
backward receives it), the first step's loss, the worst leaf's first
gradient norm and the worst leaf's change after three steps, each relative
to the reference (reference/common.leaf_gaps for the leaves). The later
steps' losses are printed, not compared: a row whose two speaker orders all
but tie can take the other order under rounding, and Adam's first updates
(about lr times the gradient's sign) carry that on, so they swing from seed
to seed far more than the first step's (PERF.md has the readings).
"""

from __future__ import annotations

import gc
import math
import time
import types

import numpy as np
import torch

from port_bench.harness.trace import Tracer
from port_bench.reference.common import leaf_gaps, no_tf32, rounding, three_steps

RING = 4


def _lengths(tr: dict, seed: int) -> np.ndarray:
    """(RING, batch) true lengths: the same evenly spaced set for every seed,
    in the seed's order."""
    n = RING * tr["batch"]
    if "frames" in tr:
        vals = np.round(np.linspace(tr["min_frames"], tr["max_frames"], n)).astype(np.int64)
    else:
        vals = np.full(n, int(round(tr["seconds"] * tr["sample_rate"])), np.int64)
    return np.random.default_rng(seed).permutation(vals).reshape(RING, tr["batch"])


def make_batches(run, dev) -> tuple:
    """The ring of batches on ``dev`` and their rows' true lengths."""
    tr, model = run.traffic, run.config["model"]
    lengths = _lengths(tr, run.seed)
    gen = torch.Generator(device=dev).manual_seed(run.seed)
    S, B = model["num_spk"], tr["batch"]
    batches = []
    for k in range(RING):
        lens = torch.as_tensor(lengths[k], device=dev)
        gains = 10.0 ** (torch.rand((B, S), generator=gen, device=dev) - 0.5)
        if "frames" in tr:
            T, F = tr["frames"], model["feat_dim"]
            valid = (torch.arange(T, device=dev)[None, :] < lens[:, None]).float()
            src = torch.randn((B, S, T, F), generator=gen, device=dev).abs()
            src = src * gains[:, :, None, None] * valid[:, None, :, None]
            batches.append({"mix": src.sum(dim=1), "sources": src,
                            "lengths": lens.to(torch.int32),
                            "row_mask": torch.ones(B, device=dev)})
        else:
            L = int(lengths.max())
            valid = (torch.arange(L, device=dev)[None, :] < lens[:, None]).float()
            src = 0.1 * torch.randn((B, S, L), generator=gen, device=dev)
            src = src * gains[:, :, None] * valid[:, None, :]
            batches.append({"mix_wav": src.sum(dim=1), "source_wavs": src,
                            "sample_lengths": lens.to(torch.int32),
                            "row_mask": torch.ones(B, device=dev)})
    return batches, lengths


def audio_seconds(run, lengths) -> float:
    """True audio seconds of rows: frames times the hop, or samples."""
    tr = run.traffic
    unit = tr["hop"] / tr["sample_rate"] if "frames" in tr else 1.0 / tr["sample_rate"]
    return float(np.sum(lengths)) * unit


def half_loss_rows(batch: dict) -> dict:
    """The batch with the loss's row weights (``row_mask``) nought over its
    second half, so the loss is the mean over the first half: a fault's
    input. The model still runs every row."""
    mask = batch["row_mask"].clone()
    mask[mask.shape[0] // 2:] = 0
    return {**batch, "row_mask": mask}


def build(run, dev):
    """(arch, model, optimizer, initial leaves) from the seed, as the
    trainer builds them."""
    from speech_separation_tpu_torch.models.registry import get_arch
    from speech_separation_tpu_torch.train.loop import Optimizer, TrainLoopConfig
    from speech_separation_tpu_torch.utils.weights import fold_lstm_biases

    conf = run.config
    arch = get_arch(conf["arch"])
    run.phase("program imported")
    cfg = arch.Config.from_kwargs(**{k: str(v) for k, v in conf["model"].items()})
    params = run.reference.init_params(conf["model"], torch.Generator(device=dev).manual_seed(
        run.seed), dev)
    run.phase("weights drawn")
    with torch.device(dev):
        model = arch.Model(cfg)
    model.load_state_dict(params)
    fold_lstm_biases(model)
    opt = Optimizer(model.parameters(), TrainLoopConfig(arch=arch.NAME,
                                                        batch_size=run.traffic["batch"]))
    run.phase("model and optimizer")
    return arch, model, opt, params


def first_steps(run, model, opt, batches, step):
    """The three set-up steps through ``step``: losses, the first step's
    outputs, the first clipped gradient's and the change's norm of each
    trained leaf."""
    trained = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    p0 = {n: p.detach().clone() for n, p in trained}
    losses, grad1, kept = [], {}, {}
    for k in range(3):
        losses.append(step(batches[k], kept if k == 0 else None))
        run.phase(f"set-up step {k + 1} queued")
        if k == 0:
            b1 = opt.adam.defaults["betas"][0]
            grad1 = {n: (opt.adam.state[p]["exp_avg"] / (1 - b1)).norm() for n, p in trained
                     if p in opt.adam.state}
    change = {n: (p.detach() - p0[n]).norm() for n, p in trained}
    return {"losses": [float(x) for x in losses], "grad1": {n: float(v) for n, v in grad1.items()},
            "change": {n: float(v) for n, v in change.items()}, "outputs": kept["outputs"],
            "outgrads": kept.get("outgrads")}


def reference_steps(run, params: dict, batches: list, precision: str) -> dict:
    """The plain reference's three steps from the same leaves and batches."""
    model = run.config["model"]
    q = rounding(precision)
    fixed = {n: v for n, v in params.items() if n.startswith(("bn.running", "bn.num"))
             or ".bias_hh_" in n}
    trained = {n: v for n, v in params.items() if n not in fixed}
    ref = run.reference
    return three_steps(trained, batches,
                       lambda live, batch: ref.loss({**fixed, **live}, model, batch, q))


def reference_outputs(run, params: dict, batch: dict, precision: str) -> dict:
    """The plain reference's forward outputs for the first batch and, where
    its reference has ``output_grads``, the loss's gradient with respect to
    them."""
    ref = run.reference
    with torch.no_grad():
        out = ref.outputs(params, run.config["model"], batch, rounding(precision)).detach()
    grads = getattr(ref, "output_grads", None)
    return {"outputs": out,
            "outgrads": None if grads is None else grads(out, run.config["model"], batch)}


def row_gaps(got: torch.Tensor | None, want: torch.Tensor | None) -> torch.Tensor | None:
    """Each row's relative L2 gap between two (B, ...) tensors; rows missing
    or of another shape read inf; None where either side has none."""
    if got is None or want is None:
        return None
    if got.shape != want.shape:
        return torch.full((max(want.shape[0], 1),), math.inf)
    d = (got.float() - want.float()).flatten(1).norm(dim=1)
    return d / want.float().flatten(1).norm(dim=1).clamp_min(1e-30)


def median_row(gaps: torch.Tensor | None) -> float:
    """The median row's gap (the upper middle one of an even count); nan
    where there are none."""
    if gaps is None:
        return math.nan
    return float(gaps.sort().values[gaps.numel() // 2])


def compare(got: dict, ref: dict) -> dict:
    """The numbers compared, from the program's (or a control's) readings
    and the reference's."""
    gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got["losses"], ref["losses"])]
    grad_gap, grad_leaf, left_out = leaf_gaps(got["grad1"], ref["grad1"], ref["grad1"])
    change_gap, change_leaf, _ = leaf_gaps(got["change"], ref["change"], ref["grad1"])
    return {"out_gap": float(row_gaps(got["outputs"], ref["outputs"]).max()),
            "outgrad_gap": median_row(row_gaps(got["outgrads"], ref["outgrads"])),
            "loss1_gap": gaps[0],
            "grad_gap": grad_gap, "change_gap": change_gap, "loss_gaps": gaps,
            "grad_leaf": grad_leaf, "change_leaf": change_leaf, "left_out": left_out}


def keeping_outputs(arch, entry, keep: dict):
    """``entry`` whose loss also keeps in ``keep`` what the model produced
    for the batch it was given (``outputs``): the uPIT contract's masked
    estimates (its aux's ``masked``), or the estimated sources that a
    waveform arch hands to its module's ``pit_si_snr_loss``, and for the
    latter the gradient the backward brings them from the loss
    (``outgrads``). The step computes what it computes without this."""
    def loss_fn(m, b, g, t):
        wave = getattr(arch, "pit_si_snr_loss", None)
        if wave is not None:
            def kept(est, batch, num_spk):
                keep["outputs"] = est.detach().clone()
                if est.requires_grad:
                    est.register_hook(lambda gr: keep.__setitem__("outgrads", gr.detach().clone()))
                return wave(est, batch, num_spk)
            arch.pit_si_snr_loss = kept
        try:
            loss, aux = entry.loss_fn(m, b, g, t)
        finally:
            if wave is not None:
                arch.pit_si_snr_loss = wave
        if "masked" in aux:
            keep["outputs"] = aux["masked"].detach().clone()
        return loss, aux
    return types.SimpleNamespace(loss_fn=loss_fn)


def program_step(run, arch, model, opt):
    """The window's call: ``update_step`` on one batch, with the cell's
    planted fault (tests and readings only) underneath."""
    from speech_separation_tpu_torch.train.loop import update_step
    gen = torch.Generator(device=next(model.parameters()).device).manual_seed(run.seed)
    entry = arch
    if run.fault == "half_batch":
        # the loss over the first half of the rows, the forward over all of
        # them: a normalisation that takes the batch's rows (uPIT's
        # BatchNorm) still sees every row
        entry = types.SimpleNamespace(
            loss_fn=lambda m, b, g, t: arch.loss_fn(m, half_loss_rows(b), g, t))
        bn = getattr(model, "bn", None)
        if bn is not None:
            bn_forward = bn.forward
            bn.forward = lambda x, row_mask, train=False: bn_forward(
                x, torch.ones_like(row_mask), train)
    if run.fault == "frozen":
        opt.step = lambda: None

    def step(batch, keep=None):
        """One update; with ``keep`` (a dict) the model's outputs for the
        batch, and what the backward brings them, are kept in it."""
        call = entry if keep is None else keeping_outputs(arch, entry, keep)
        loss, _ = update_step(call, model, opt, batch, gen)
        return loss.detach()
    return step


def run(run) -> None:
    from speech_separation_tpu_torch.ops import lstm_kernel

    dev = torch.device(run.device)
    no_tf32()
    tracer = Tracer() if run.trace else None
    if tracer:
        tracer.prepare()
    run.phase("imports and tracer")
    arch, model, opt, params = build(run, dev)
    batches, lengths = make_batches(run, dev)
    run.phase("batches")
    step = program_step(run, arch, model, opt)
    got = first_steps(run, model, opt, batches, step)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    run.phase("three first steps")

    if run.trace:
        inner = opt.step

        def traced_step():
            with run.interval("optimizer"):
                inner()
        opt.step = traced_step
    counters = (lstm_kernel.lstm_seq_fwd, lstm_kernel.lstm_seq_bwd)
    before = [c.launches for c in counters]
    if tracer:
        tracer.start()
    start = run.start_window()
    ring, losses, k = [], [], 3
    while True:
        with run.interval("step"):
            losses.append(step(batches[k % RING]))
        ring.append(k % RING)
        k += 1
        if time.monotonic() - start >= run.seconds:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize()
    end = time.monotonic()
    if tracer:
        tracer.stop()
    run.window = (start, end)
    run.attempted = len(ring)
    run.failed = int((~torch.isfinite(torch.stack(losses))).sum())
    run.e2e["train_audio_s_per_s"] = sum(audio_seconds(run, lengths[i]) for i in ring) / (end - start)
    pad = run.traffic.get("frames") or int(lengths.max())
    run.records["train"] = {
        "steps": len(ring), "T": pad, "lengths": [lengths[i].tolist() for i in ring],
        "launches": {c.__name__: c.launches - b for c, b in zip(counters, before)}}
    if dev.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    if tracer:
        run.trace_data = tracer.read((start, end))

    # the program's state goes before the reference runs in its place
    del model, opt, step, losses
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_steps(run, params, batches[:3], run.config["precision"])
    ref.update(reference_outputs(run, params, batches[0], run.config["precision"]))
    run.phase("reference")
    nums = compare(got, ref)
    run.note(f"port_bench: worst leaves: first gradient {nums['grad_leaf']}, change "
             f"{nums['change_leaf']}; left out by the reference's gradient: {nums['left_out']}")
    run.note(f"port_bench: losses program {got['losses']} reference {ref['losses']}; "
             f"gaps {nums['loss_gaps']} (steps 2 and 3 not compared: PERF.md)")
    for name, limit in run.cell["checks"].items():
        run.check(name, nums[name], limit)
