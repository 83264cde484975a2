"""Compute-dtype matmul helper for the mask head.

The counterpart of speech_separation_tpu/ops/mxu.py::head_dot, which feeds
the head product in the model's compute dtype with float32 accumulation
(``preferred_element_type``). ``torch.matmul`` on bf16 tensors would return
bf16, so the port rounds the inputs to the compute dtype and multiplies in
full f32: the same math, as a plain product outside any kernel.
"""

from __future__ import annotations

import torch


def head_dot(y: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """y @ w with inputs rounded to ``dtype`` and a float32 result."""
    return torch.matmul(y.to(dtype).float(), w.to(dtype).float())
