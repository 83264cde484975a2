"""Architecture registry of the port.

Each arch module exposes ``NAME``, ``Config`` (with ``from_kwargs``), an
``nn.Module`` built from the config, ``loss_fn`` (the training objective)
and ``infer_masks``. The port has uPIT only so far; the other archs of the
JAX package are queued in ROADMAP.md.
"""

from __future__ import annotations

from . import upit

ARCHS = {"uPIT": upit}


def get_arch(name: str):
    """Resolve an arch by registry name (case-insensitive)."""
    for k, v in ARCHS.items():
        if k.lower() == name.lower():
            return v
    raise NotImplementedError(
        f"architecture {name!r} is not ported to PyTorch yet (ported: "
        f"{sorted(ARCHS)}); see ROADMAP.md for the order of the port")
