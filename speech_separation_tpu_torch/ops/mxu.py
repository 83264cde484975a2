"""Compute-dtype matmul helper for the mask head.

The counterpart of speech_separation_tpu/ops/mxu.py::head_dot, which feeds
the head product in the model's compute dtype with float32 accumulation
(``preferred_element_type``). ``torch.matmul`` on bf16 tensors would return
bf16, so the port rounds the inputs to the compute dtype and multiplies in
full f32: the same math, as a plain product outside any kernel.
"""

from __future__ import annotations

import torch

from ..parallel.ranks import copy_to_model


def head_dot(y: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """y @ w with inputs rounded to ``dtype`` and a float32 result."""
    return torch.matmul(y.to(dtype).float(), w.to(dtype).float())


def column_dot(y: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``head_dot`` of a ``y`` that every rank of the model group holds
    whole by this rank's block of ``w``'s output columns (a column-parallel
    product). The copy to the model group sits on the rounded input, so the
    ranks' partial gradients of ``y`` are summed in float32 and rounded to
    ``dtype`` once, as one process rounds its whole product's."""
    return torch.matmul(copy_to_model(y.to(dtype).float()), w.to(dtype).float())

