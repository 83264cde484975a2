"""Architecture registry of the port: the JAX package's six archs.

Each arch module exposes ``NAME``, ``DOMAIN``, ``Config`` (with
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

# The kernel sources (csrc/<name>.cu, ops/_build.SOURCES) each arch's
# training and serving launch: the BLSTM archs the LSTM recurrences (K1, K3
# lstm_fwd; K4 lstm_bwd), the spectral ones the STFT (K2) for on-device
# features and serving, SepFormer the chunk attention (K5, with
# fused_attention=1), TCN and SepFormer the channelwise LayerNorm (K6,
# layernorm). DPRNN works on waveforms and Conv-TasNet runs no hand-written
# kernel with its default global norm (norm="cln" and the causal streaming
# model build K6 at first use). warmup, doctor and bench read this map.
ARCH_KERNELS = {"uPIT": ("lstm_fwd", "lstm_bwd", "stft"),
                "RSH": ("lstm_fwd", "lstm_bwd", "stft"),
                "DPRNN": ("lstm_fwd", "lstm_bwd"),
                "TCN": ("stft", "layernorm"),
                "SepFormer": ("attention", "layernorm"),
                "ConvTasNet": ()}


def get_arch(name: str):
    """Resolve an arch by registry name (case-insensitive)."""
    for k, v in ARCHS.items():
        if k.lower() == name.lower():
            return v
    raise NotImplementedError(
        f"unknown architecture {name!r} (the port has: {sorted(ARCHS)})")
