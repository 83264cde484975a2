"""The readings that a training cell's limits of ``correct`` are set from, on
the card, in one process: for each seed the program's compared numbers (its
first three steps at the cell's own size against the plain reference), for
the first ``--control`` seeds the control's (the reference with fp8
products in the program's place), and for the first ``--fault-seeds``
seeds each fault's (planted underneath the program's step).

    python3 port_bench/readings.py --workload upit-train-b100 --seeds 1-12 \\
        --control 3 --faults half_batch --fault-seeds 3

One JSON line a reading on standard output. The benchmark's own runs never
run this.
"""

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def seeds_of(text: str) -> list:
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b) + 1)) if b else [int(a)]
    return out


def program_readings(run, dev, fault=None):
    """The program's set-up steps (with ``fault`` planted), freed after."""
    import torch

    from port_bench.traffic import train_steps as ts
    run.fault = fault
    arch, model, opt, params = ts.build(run, dev)
    batches, _ = ts.make_batches(run, dev)
    got = ts.first_steps(run, model, opt, batches, ts.program_step(run, arch, model, opt))
    del model, opt
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return got, params, batches


def gradient_rows(got: dict, ref: dict) -> dict:
    """Where the first step's output gradients are read: the worst row's
    gap, and the row that holds the largest share of the reference's
    squared gradient norm, with that share and its own gap."""
    from port_bench.traffic import train_steps as ts
    gaps = ts.row_gaps(got["outgrads"], ref["outgrads"])
    if gaps is None:
        return {}
    sq = ref["outgrads"].float().flatten(1).norm(dim=1) ** 2
    top = int(sq.argmax())
    return {"outgrad_worst": float(gaps.max()), "outgrad_worst_row": int(gaps.argmax()),
            "outgrad_top_row": top, "outgrad_top_share": float(sq[top] / sq.sum()),
            "outgrad_top_gap": float(gaps[top])}


def diagnose(run, dev) -> dict:
    """The first step's speaker orders: rows whose best order differs
    between the program and the reference, and the reference's smallest
    relative margin between a row's two best orders."""
    import torch

    from port_bench.reference.common import rounding
    from port_bench.traffic import train_steps as ts
    arch, model, opt, params = ts.build(run, dev)
    batches, _ = ts.make_batches(run, dev)
    _, aux = arch.loss_fn(model, batches[0], None, True)
    got = aux["best_perm"]
    per = []
    with torch.no_grad():
        run.reference.loss(params, run.config["model"], batches[0],
                           rounding(run.config["precision"]), per)
    per = torch.cat(per)
    top2 = per.topk(2, dim=1, largest=False).values
    margin = ((top2[:, 1] - top2[:, 0]) / top2.abs().sum(dim=1).clamp_min(1e-30))
    return {"flipped_rows": int((got.to(per.device) != per.argmin(dim=1)).sum()),
            "min_margin": float(margin.min()), "median_margin": float(margin.median())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="e.g. 1-12 or 3,5,9")
    p.add_argument("--control", type=int, default=3, help="seeds that also read the control")
    p.add_argument("--faults", default="", help="comma-separated: half_batch")
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--device", default="cuda")
    p.add_argument("--diagnose", action="store_true",
                   help="also read, at the first step, each row's best speaker order in the "
                        "program and the reference and the reference's margin between orders")
    args = p.parse_args(argv)

    import torch

    from port_bench.harness import core
    from port_bench.traffic import train_steps as ts
    if args.device == "cuda" and not torch.cuda.is_available():
        print("port_bench readings: no CUDA card", file=sys.stderr)
        return 2
    core.set_cache_dirs()
    dev = torch.device(args.device)
    faults = [f for f in args.faults.split(",") if f]
    for i, seed in enumerate(seeds_of(args.seeds)):
        run = core.Run(args.workload, seed, 0.0, False, args.device, T_PROCESS)
        t0 = time.monotonic()
        got, params, batches = program_readings(run, dev)
        ref = ts.reference_steps(run, params, batches[:3], run.config["precision"])
        ref.update(ts.reference_outputs(run, params, batches[0], run.config["precision"]))
        rows = [("program", {**ts.compare(got, ref), **gradient_rows(got, ref)})]
        if i < args.control:
            ctl = ts.reference_steps(run, params, batches[:3], "fp8")
            ctl.update(ts.reference_outputs(run, params, batches[0], "fp8"))
            rows.append(("control_fp8", ts.compare(ctl, ref)))
        if i < args.fault_seeds:
            for fault in faults:
                bad, _, _ = program_readings(run, dev, fault)
                rows.append((fault, {**ts.compare(bad, ref), **gradient_rows(bad, ref)}))
        if args.diagnose:
            rows.append(("orders", diagnose(run, dev)))
        for kind, nums in rows:
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                              "seconds": time.monotonic() - t0, **nums}), flush=True)
        del params, batches
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
