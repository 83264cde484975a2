"""Architecture registry of the port: the JAX package's six archs.

Each arch module exposes ``NAME``, ``DOMAIN``, ``KERNELS``, ``Config`` (with
``from_kwargs``), ``Model`` (the ``nn.Module`` built from a config, with
``reset_parameters(generator)``) and ``loss_fn(model, batch, generator,
train)``. A ``DOMAIN = "spectrum"`` arch (uPIT, RSH, TCN) trains on
STFT-magnitude batches and serves through ``infer_masks`` (RSH's takes the
speaker count of the call); a ``DOMAIN = "time"`` arch (SepFormer, DPRNN,
Conv-TasNet) trains on waveform batches and serves through ``separate``. The
causal TCN and Conv-TasNet also stream (eval/streaming.py).
"""

from __future__ import annotations

from . import convtasnet, dprnn, rsh, sepformer, tcn, upit

ARCHS = {"uPIT": upit, "RSH": rsh, "TCN": tcn, "DPRNN": dprnn, "SepFormer": sepformer,
         "ConvTasNet": convtasnet}

# The kernel sources (ops/_build.TABLE) each arch's training and serving
# launch, as its module declares them; warmup, doctor and bench read this map.
ARCH_KERNELS = {name: module.KERNELS for name, module in ARCHS.items()}


def get_arch(name: str):
    """Resolve an arch by registry name (case-insensitive)."""
    for k, v in ARCHS.items():
        if k.lower() == name.lower():
            return v
    raise NotImplementedError(
        f"unknown architecture {name!r} (the port has: {sorted(ARCHS)})")
