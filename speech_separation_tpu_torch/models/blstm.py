"""Bidirectional multi-layer LSTM in PyTorch, for training and inference.

The counterpart of speech_separation_tpu/models/blstm.py:

- the input projection x @ W_ih + b of all steps is one product hoisted out
  of the recurrence; the recurrence of both directions runs in one call per
  layer (the hand-written kernels on CUDA, their plain versions on the CPU),
  for either compute dtype;
- when autograd will want gradients (grad mode on and a parameter that
  requires grad) the recurrence is ops/lstm_kernel.lstm_seq, the
  differentiable training forward whose outputs are in the compute dtype
  (bf16 in bf16 mode, as the JAX package's ``save_activations=True``);
  otherwise it is lstm_seq_infer, which saves nothing and records no graph;
- variable lengths follow packed-sequence semantics by masking: at padded
  steps the carry passes through and the output is zero. The reverse
  direction runs on the time-flipped input with a suffix mask, so each
  row's padding is consumed first with the state still h0, then its frames
  in true reverse order;
- gate order (i, f, g, o); the initial state is the caller's (the reference
  draws it from N(0, 1) per batch, kept by ``random_hidden``).

Parameters carry torch.nn.LSTM's names (``weight_ih_l0``, ``..._reverse``)
so a reference ``.mdl`` state dict loads as it is. The two biases are
summed in f32 at use, as the JAX package stores them summed.

Tensor parallelism over the gate axis (``tp == "lstm_gates"``,
parallel/mesh.shard_params): each rank holds a contiguous block of the 4H
gate rows of every ``weight_ih``, ``weight_hh`` and bias, computes its
columns of the input projection from the replicated input, and gathers the
projection and ``weight_hh`` whole over the model group. The recurrence
kernels cannot exchange state with another process at each step, so every
rank of the group runs the whole recurrence; the gathers' backward hands
each rank its block of the gradients.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.lstm_kernel import lstm_seq, lstm_seq_infer
from ..ops.mxu import held_dot
from ..parallel import ranks
from ..parallel.ranks import copy_to_model, gather_from_model


def random_hidden(generator: torch.Generator, num_layers: int, batch: int,
                  hidden: int):
    """Reference quirk: initial (h0, c0) ~ N(0, 1) per batch, drawn from
    ``generator`` on its device. Shapes: (num_layers, 2, B, H) each. Over
    parallel ranks, whose batch is their data index's ``batch`` rows of the
    global one, every rank draws the global batch's states from the same
    generator and keeps its data index's rows: the generators stay in step,
    each row gets the state one device would give it, and the ranks of a
    model group get the same states."""
    r = ranks.current()
    parts, i = (r.data, r.data_index) if r is not None else (1, 0)
    shape = (num_layers, 2, batch * parts, hidden)
    h0 = torch.randn(shape, generator=generator, device=generator.device)
    c0 = torch.randn(shape, generator=generator, device=generator.device)
    if parts == 1:
        return h0, c0
    rows = slice(i * batch, (i + 1) * batch)
    return h0[:, :, rows].contiguous(), c0[:, :, rows].contiguous()


class BLSTM(nn.Module):
    """Multi-layer bidirectional LSTM with the BLSTM layout of the JAX
    package: outputs (B, T, 2H), forward direction first."""

    # "lstm_gates": the gate rows split over the model group (parallel/mesh.place)
    tp: str | None = None

    def __init__(self, input_dim: int, hidden: int, num_layers: int = 2):
        super().__init__()
        self.input_dim, self.hidden, self.num_layers = input_dim, hidden, num_layers
        for layer in range(num_layers):
            in_dim = input_dim if layer == 0 else 2 * hidden
            for sfx in ("", "_reverse"):
                self.register_parameter(f"weight_ih_l{layer}{sfx}",
                                        nn.Parameter(torch.empty(4 * hidden, in_dim)))
                self.register_parameter(f"weight_hh_l{layer}{sfx}",
                                        nn.Parameter(torch.empty(4 * hidden, hidden)))
                self.register_parameter(f"bias_ih_l{layer}{sfx}",
                                        nn.Parameter(torch.empty(4 * hidden)))
                self.register_parameter(f"bias_hh_l{layer}{sfx}",
                                        nn.Parameter(torch.empty(4 * hidden)))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """torch.nn.LSTM's default init: U(-k, k), k = 1/sqrt(hidden)."""
        k = 1.0 / math.sqrt(self.hidden)
        with torch.no_grad():
            for p in self.parameters():
                p.uniform_(-k, k, generator=generator)

    def _direction(self, layer: int, sfx: str):
        g = lambda n: getattr(self, f"{n}_l{layer}{sfx}")
        return g("weight_ih"), g("weight_hh"), g("bias_ih") + g("bias_hh")

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, h0: torch.Tensor,
                c0: torch.Tensor, compute_dtype: torch.dtype = torch.float32):
        """x: (B, T, in) float32, zero past each row's length; lengths: (B,)
        int; h0, c0: (num_layers, 2, B, H), direction 0 = forward.

        Returns (out (B, T, 2H) with zeros at padded steps, f32 for
        inference and in compute_dtype for training, (h_n, c_n) each
        (num_layers, 2, B, H) f32)."""
        train = torch.is_grad_enabled() and any(p.requires_grad for p in self.parameters())
        gates = self.tp == "lstm_gates"
        out = x
        h_finals, c_finals = [], []
        for layer in range(self.num_layers):
            wf_ih, wf_hh, bf = self._direction(layer, "")
            wb_ih, wb_hh, bb = self._direction(layer, "_reverse")
            out_c = out.to(compute_dtype)
            x_rev = torch.flip(out_c, dims=(1,))
            if compute_dtype == torch.bfloat16:
                # the JAX bf16 path: a direction-batched product of bf16
                # inputs with f32 accumulation, ROUNDED to bf16, then the
                # bf16 bias added in bf16 (a second rounding)
                x_pair = torch.stack([out_c, x_rev])                      # (2, B, T, F)
                if gates:
                    # the gradient of the rounded input summed in f32 over the
                    # group, then rounded once, as one process rounds it
                    x_pair = copy_to_model(x_pair.float())
                w_pair = torch.stack([wf_ih.t(), wb_ih.t()]).to(compute_dtype)
                b_pair = torch.stack([bf, bb]).to(compute_dtype)         # (2, 4H)
                xw = held_dot(x_pair, w_pair[:, None], compute_dtype, compute_dtype)
                xw = xw + b_pair[:, None, None, :]
            else:
                if gates:
                    out_c = copy_to_model(out_c)
                    x_rev = torch.flip(out_c, dims=(1,))
                xw = torch.stack([torch.matmul(out_c, wf_ih.t()) + bf,
                                  torch.matmul(x_rev, wb_ih.t()) + bb])
            if gates:
                # each rank's gate columns, then the whole 4H
                xw = gather_from_model(xw, dim=-1)
                wf_hh, wb_hh = gather_from_model(wf_hh, 0), gather_from_model(wb_hh, 0)
            xw = xw.permute(2, 0, 1, 3).contiguous()                      # (T, 2, B, 4H)
            w_hh = torch.stack([wf_hh.t(), wb_hh.t()]).to(compute_dtype).contiguous()
            state = (h0[layer].contiguous(), c0[layer].contiguous(), lengths)
            if train:
                ys, h_last, c_last = lstm_seq(xw, w_hh, *state, save_dtype=compute_dtype,
                                              suffix_dirs=(False, True))
            else:
                ys, h_last, c_last = lstm_seq_infer(xw, w_hh, *state,
                                                    suffix_dirs=(False, True))
            y_fwd = ys[:, 0].transpose(0, 1)
            # outputs at suffix-masked steps are zero, so flipping back
            # leaves zeros past each row's length
            y_bwd = torch.flip(ys[:, 1].transpose(0, 1), dims=(1,))
            out = torch.cat([y_fwd, y_bwd], dim=-1)
            h_finals.append(h_last)
            c_finals.append(c_last)
        return out, (torch.stack(h_finals), torch.stack(c_finals))
