"""layer_norm_ms (ms): device time a step of K6, the channelwise LayerNorm
(csrc/layernorm.cu: ``chan_ln_fwd``, ``chan_ln_bwd`` and the backward's sum of
the parameter gradients, ``chan_ln_bwd_params``), over every launch in the
traced window. None where the trace holds none of them: a program whose
LayerNorm is plain PyTorch passes, or a cell whose model runs no ``_cln``.
The run's notes give the launches a step of each kernel."""


def match(name: str) -> bool:
    return "chan_ln_" in name


def read(run):
    t, trace = run.records.get("train"), run.trace_data
    if not t or trace is None:
        return None
    ks = trace.kernels(match)
    if not ks:
        return None
    counts: dict = {}
    for name, *_ in ks:
        kind = next(k for k in ("chan_ln_fwd", "chan_ln_bwd_params", "chan_ln_bwd") if k in name)
        counts[kind] = counts.get(kind, 0) + 1
    run.note("port_bench: layer_norm_ms: launches a step "
             + ", ".join(f"{k} {n / t['steps']:g}" for k, n in sorted(counts.items())))
    return 1e3 * sum(end - start for _, start, end, _ in ks) / t["steps"]
