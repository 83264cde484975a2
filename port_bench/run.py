"""Run one cell of the port's benchmark once, on the card it is started on.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints its notes on standard error, ending with each number compared for
``correct`` beside its limit, and as the last line of standard output one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; last, ``checks``. Exits non-zero
with no result when no CUDA card (or fewer than the cell asks for) is
visible, when the port cannot be imported, or when JAX or the JAX package
is loaded once the window has closed.
"""

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() else "nvidia-smi: no output"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from port_bench.harness import core
    from port_bench.harness.runner import (ForbiddenModules, finite_or_none, print_checks,
                                           run_cell)
    cells = {w["name"]: w for w in core.benchmark()["workloads"]}
    if args.workload not in cells:
        print(f"port_bench: no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    core.set_cache_dirs()
    print(f"port_bench: card {card_line()}; torch {torch.__version__}", file=sys.stderr)
    try:
        result, run = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                               "cuda", T_PROCESS)
    except ForbiddenModules as e:
        print(f"port_bench: JAX or the JAX package was loaded: {e}", file=sys.stderr)
        return 3
    print_checks(run)
    print(json.dumps(finite_or_none(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
