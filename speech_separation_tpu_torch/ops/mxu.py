"""Products of compute-dtype operands with float32 sums, outside the kernels.

The counterpart of speech_separation_tpu/ops/mxu.py::head_dot, which feeds
a product in the model's compute dtype with float32 accumulation
(``preferred_element_type``). The port's products of that kind (the mask
heads, the linear layers of TCN, Conv-TasNet, SepFormer and DPRNN, the
BLSTM's input projection, the recurrence's dW_hh) all come here.

A bf16 x bf16 product is exact in float32, so a tensor-core product of
bf16 operands with a float32 accumulator does the arithmetic of a float32
product of the rounded operands, in another order of the sum and, below,
with the accumulator's own rounding. ``mxu_dot`` is that one product:

- both operands bf16: on the tensor cores, the sum in float32, the result
  float32 or rounded once to bf16. cuBLAS may reduce a split-K product's
  partial sums in the output type; for a bf16 result ``mxu_dot`` turns
  that off itself for the call (``allow_bf16_reduced_precision_reduction``
  False, under a lock, restored after), whatever the process has set.
  Hopper's tensor cores add into their float32 accumulator with
  truncation, so a long sum drifts toward zero: off the float64 sum by
  4.4e-5 relative (L2) over 38,400 terms and 3.0e-4 over 259,200 (H100),
  where a float32 product on the CUDA cores is off by 2.5e-6 and 8.0e-6,
  and a result rounded to bf16 then falls on the lower side of a rounding
  on about 1% more of its elements. So a contraction of more than
  ``SUM_TERMS`` terms (the weight gradients, over every row of the batch;
  uPIT's layer-2 input gradient, over 2,400) is cut into equal pieces of
  at most that many (K padded with zeros to a whole number of them), each
  summed on the tensor cores, and the pieces' float32 sums are added in
  float32 (one batched product and one sum): 1.2e-6 off the float64 sum,
  as uPIT's 1,200-term projection is;
- both operands float32: a float32 product (TF32 stays as the process has
  it: off, ``train/loop.py``).

``mxu_dot`` runs on CUDA tensors only: every CPU path below is the plain
product. ``mxu_dot.tensor_core`` and ``mxu_dot.f32`` count the products
by case, and ``mxu_dot.any_order`` the forward products that
``any_order_dot`` sums on the tensor cores (each of those is also one of
``tensor_core``'s).

``rounded_dot`` and ``any_order_dot`` are the differentiable products of
the models: on a CUDA tensor with a bf16 compute dtype each is
``_RoundedDot``, whose forward and backward both run on ``mxu_dot``, each
product's case following the dtypes and the function called, never the
values:

- the forward: a float32 result (a head under its sigmoid, an encoder) on
  the tensor cores. A result rounded to bf16 takes one of two cases, by the
  function its call site calls:

  - ``rounded_dot`` (``held_dot``, ``column_dot``, ``models/layers.dot``
    and ``row_dot``): the float32 product of the same operands, so that its
    roundings are the ones the plain product makes. These are the BLSTM's
    input projections and DPRNN's intra and inter projections, which feed
    a recurrence, and the trunks' products: the dual-path bottleneck (DPRNN
    runs it too) and TCN's and Conv-TasNet's linear layers. Any other order
    of the sum, a more exact one too, rounds about 0.1% of the elements to
    the other neighbour, and a recurrence carries those whole bf16 steps to
    the loss: a 2x600 uPIT step's loss moves 6.9e-6 relative on the tensor
    cores and 1.5e-5 with sums of 8 terms, against 6.6e-7 between the
    float32 product and the CPU (H100), where the card-against-CPU check
    holds it to 1.5e-6;
  - ``any_order_dot`` (SepFormer's transformer layers, ``qkv``, ``out``,
    ``ff1`` and ``ff2``, and no other call site): on the tensor cores, the
    bf16 operands summed in float32, the bias added to that sum, then the
    one rounding. No recurrence consumes these results, and SepFormer's
    checks hold its step to bounds that another order of the sum passes;
- the backward: a result rounded to bf16 gets a bf16 cotangent, so both
  gradient products run on the tensor cores; a float32 result gets a
  float32 cotangent (a sigmoid's, a loss's), which is not rounded, so both
  gradient products stay in float32.

Each gradient comes back in its operand's dtype: a bf16 operand's rounded
once from the float32 sum, a float32 one (an operand that already holds
bf16 values, for a reduce over the model group before the rounding) the
float32 sum itself. Everywhere else (CPU tensors, a float32 compute dtype)
the product is the plain one: the operands rounded to the compute dtype
and multiplied in float32, which autograd differentiates, bit for bit as
before.
"""

from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from ..parallel.ranks import copy_to_model

_flag_lock = threading.Lock()


SUM_TERMS = 1200   # the most terms one tensor-core sum takes


def _matmul(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """a @ b by cuBLAS with a float32 accumulator, the result in out_dtype."""
    fn = torch.mm if a.dim() == 2 else torch.bmm
    if a.dtype == torch.float32:
        return fn(a, b).to(out_dtype)
    k = a.shape[-1]
    if k > SUM_TERMS:
        # each matrix pair as s products of c terms (c a multiple of 8, at
        # most SUM_TERMS; K padded with zeros to s * c), their float32 sums
        # added, then the one rounding to out_dtype
        s = -(-k // SUM_TERMS)
        c = -(-k // (8 * s)) * 8
        if s * c > k:
            a, b = F.pad(a, (0, s * c - k)), F.pad(b, (0, 0, 0, s * c - k))
        m, n = a.shape[-2], b.shape[-1]
        out = torch.empty((*a.shape[:-2], m, n), dtype=out_dtype, device=a.device)
        for o, ai, bi in zip(out.view(-1, m, n), a.reshape(-1, m, s * c),
                             b.reshape(-1, s * c, n)):
            o.copy_(torch.bmm(ai.unflatten(-1, (s, c)).movedim(-2, -3), bi.unflatten(-2, (s, c)),
                              out_dtype=torch.float32).sum(0))
        return out
    if out_dtype == torch.float32:
        return fn(a, b, out_dtype=torch.float32)
    m = torch.backends.cuda.matmul
    with _flag_lock:
        saved = torch._C._get_cublas_allow_bf16_reduced_precision_reduction()
        m.allow_bf16_reduced_precision_reduction = False
        try:
            return fn(a, b)
        finally:
            m.allow_bf16_reduced_precision_reduction = saved


def mxu_dot(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """a (M, K) @ b (K, N), or batched (D, M, K) @ (D, K, N), with a float32
    sum and the result in ``out_dtype``; a and b both bf16 (the tensor
    cores) or both float32."""
    if a.dtype != b.dtype or a.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"mxu_dot takes two bf16 or two float32 operands, got "
                         f"{a.dtype} and {b.dtype}")
    if a.dtype == torch.bfloat16:
        mxu_dot.tensor_core += 1
    else:
        mxu_dot.f32 += 1
    return _matmul(a, b, out_dtype)


mxu_dot.tensor_core = 0
mxu_dot.f32 = 0
mxu_dot.any_order = 0


def _mt(t: torch.Tensor) -> torch.Tensor:
    return t.transpose(-1, -2)


class _RoundedDot(torch.autograd.Function):
    """x @ w (+ bias) on ``mxu_dot``: x (..., K) by w (K, N), or x (D, ..., K)
    by w (D, 1, ..., 1, K, N), one matrix a leading index; x and w hold
    bf16 values (bf16 tensors, or float32 ones of bf16 values); the float32
    bias is added to the float32 sum before the one rounding to
    ``out_dtype``; the forward product on the tensor cores for a float32
    result. For one rounded to bf16, ``any_order`` (set by the function
    called, ``any_order_dot`` or ``held_dot``) chooses the case: on the
    tensor cores (counted in ``mxu_dot.any_order``), else the float32
    product. The backward is the same in both. A K that is not a multiple
    of 8 (257 STFT bins) is padded with zeros, which add nothing, so that
    every operand's rows, and dW's, start 16-byte aligned, as cuBLAS's fast
    kernels need."""

    @staticmethod
    def forward(ctx, x, w, bias, out_dtype, any_order):
        K, N = w.shape[-2:]
        batched = w.dim() > 2
        a = x.to(torch.bfloat16).reshape((x.shape[0], -1, K) if batched else (-1, K))
        b = w.to(torch.bfloat16).reshape((-1, K, N) if batched else (K, N))
        if K % 8:
            a, b = F.pad(a, (0, -K % 8)), F.pad(b, (0, 0, 0, -K % 8))
        if out_dtype == torch.float32:
            y = mxu_dot(a, b, torch.float32)
        elif any_order:
            mxu_dot.any_order += 1
            y = mxu_dot(a, b, torch.float32 if bias is not None else out_dtype)
        else:
            # rounded as the plain product rounds it: the float32 product
            y = mxu_dot(a.float(), b.float(), torch.float32 if bias is not None else out_dtype)
        if bias is not None:
            y = y.add_(bias).to(out_dtype)
        ctx.save_for_backward(a, b)
        ctx.x_meta, ctx.w_meta = (x.shape, x.dtype), (w.shape, w.dtype)
        ctx.bias_dtype = None if bias is None else bias.dtype
        return y.reshape(*x.shape[:-1], N)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        (x_shape, x_dtype), (w_shape, w_dtype) = ctx.x_meta, ctx.w_meta
        K = w_shape[-2]
        g = g.reshape(*a.shape[:-1], b.shape[-1])
        if g.dtype != torch.bfloat16:
            # a float32 cotangent is not rounded: both products in float32
            g, a, b = g.float(), a.float(), b.float()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = mxu_dot(g, _mt(b), x_dtype)[..., :K].reshape(x_shape)
        if ctx.needs_input_grad[1]:
            dw = mxu_dot(_mt(a), g, w_dtype)[..., :K, :].reshape(w_shape)
        if ctx.needs_input_grad[2]:
            db = g.reshape(-1, g.shape[-1]).sum(0, dtype=torch.float32).to(ctx.bias_dtype)
        return dx, dw, db, None, None


def tensor_cores(device: torch.device, dtype: torch.dtype) -> bool:
    """Whether ``rounded_dot`` runs on ``mxu_dot`` on this device for this
    compute dtype: CUDA and bf16 only."""
    return device.type == "cuda" and dtype == torch.bfloat16


def held_dot(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype,
             out_dtype: torch.dtype = torch.float32,
             bias: torch.Tensor | None = None) -> torch.Tensor:
    """``rounded_dot`` of operands that already hold ``dtype`` values, each
    gradient in its operand's dtype: a float32 holder of bf16 values gets
    the float32 sum, unrounded (the tensor-parallel paths round it after
    the reduce over the model group)."""
    if tensor_cores(x.device, dtype) and out_dtype in (torch.float32, torch.bfloat16):
        return _RoundedDot.apply(x, w, bias, out_dtype, False)
    y = torch.matmul(x.float(), w.float())
    if bias is not None:
        y = y + bias
    return y.to(out_dtype)


def rounded_dot(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype,
                out_dtype: torch.dtype = torch.float32,
                bias: torch.Tensor | None = None) -> torch.Tensor:
    """x @ w (+ bias) with both operands rounded to ``dtype``, the sum (and
    the bias) in float32, the result in ``out_dtype`` (rounded once). w is
    (K, N), or (D, 1, ..., 1, K, N) for an x of (D, ..., K)."""
    return held_dot(x.to(dtype), w.to(dtype), dtype, out_dtype, bias)


def any_order_dot(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype,
                  out_dtype: torch.dtype = torch.float32,
                  bias: torch.Tensor | None = None) -> torch.Tensor:
    """``rounded_dot`` whose result rounded to bf16 is summed on the tensor
    cores on the card, in their order of the sum, not the float32
    product's: for products whose roundings no recurrence carries to the
    loss (SepFormer's transformer layers, the module docstring). The same
    backward, saved tensors and gradient dtypes as ``rounded_dot``; on the
    CPU, or in float32, the plain product, bit for bit."""
    x, w = x.to(dtype), w.to(dtype)
    if tensor_cores(x.device, dtype) and out_dtype in (torch.float32, torch.bfloat16):
        return _RoundedDot.apply(x, w, bias, out_dtype, True)
    return held_dot(x, w, dtype, out_dtype, bias)


def column_dot(y: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``rounded_dot`` of a ``y`` that every rank of the model group holds
    whole by this rank's block of ``w``'s output columns (a column-parallel
    product). The copy to the model group sits on the rounded input, held
    in float32, so the ranks' partial gradients of ``y`` are summed in
    float32 and rounded to ``dtype`` once, as one process rounds its whole
    product's."""
    return held_dot(copy_to_model(y.to(dtype).float()), w.to(dtype), dtype)
