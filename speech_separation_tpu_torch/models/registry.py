"""Architecture registry of the port.

Each arch module exposes ``NAME``, ``DOMAIN``, ``Config`` (with
``from_kwargs``), ``Model`` (the ``nn.Module`` built from a config, with
``reset_parameters(generator)``) and ``loss_fn(model, batch, generator,
train)``. A ``DOMAIN = "spectrum"`` arch (uPIT, RSH) trains on
STFT-magnitude batches and serves through ``infer_masks`` (RSH's takes the
speaker count of the call); a ``DOMAIN = "time"`` arch (SepFormer, DPRNN)
trains on waveform batches and serves through ``separate``. The other archs
of the JAX package (TCN, Conv-TasNet) are queued in ROADMAP.md.
"""

from __future__ import annotations

from . import dprnn, rsh, sepformer, upit

ARCHS = {"uPIT": upit, "RSH": rsh, "DPRNN": dprnn, "SepFormer": sepformer}


def get_arch(name: str):
    """Resolve an arch by registry name (case-insensitive)."""
    for k, v in ARCHS.items():
        if k.lower() == name.lower():
            return v
    raise NotImplementedError(
        f"architecture {name!r} is not ported to PyTorch yet (ported: "
        f"{sorted(ARCHS)}); see ROADMAP.md for the order of the port")

