"""Fused masked chunk attention (K5): the wrappers of csrc/attention.cu.

Replaces the TPU kernel speech_separation_tpu/ops/attention_pallas.py::
chunk_attention (forward body ``_fwd_kernel``, recompute backward
``_bwd_kernel``, one custom VJP). SepFormer with ``fused_attention=1`` runs
every intra- and inter-chunk attention through it: q, k, v (N, T, dh) with the
heads folded into N, a key mask (N, T) float32 (1 at valid keys). Per row:

- logits in float32: (q . k) * scale + (1 - m) * (-1e9), scale = 1/sqrt(dh)
  unless given; then max-subtract, exp, divide by the sum. A row whose keys
  are all masked gets uniform weights (the mean of v), not NaN;
- the weights are cast to v's dtype before AV, AV sums in float32, and the
  output is in q's dtype;
- the backward recomputes the float32 weights from q and k: dv from the
  rounded weights, the softmax VJP ds = (w32 * (dw - sum(dw * w32))) * scale
  from the float32 ones, dq = ds k and dk = ds^T q, all summed in float32 and
  cast to q's dtype; the mask gets zeros.

``chunk_attention_fwd`` and ``chunk_attention_bwd`` launch their kernels for
CUDA tensors (or raise) and run their plain versions (``*_plain``, batched
products of the same arithmetic) only for CPU tensors; ``<wrapper>.launches``
counts kernel launches. ``chunk_attention`` is the differentiable call, a
``torch.autograd.Function`` whose forward is the one and whose backward is
the other, so the CPU runs the same VJP rule as the TPU kernel, not autograd
through the plain forward (the two differ in bf16).

The kernels take dh in ``DH_SUPPORTED``, contiguous tensors of one dtype
(float32 or bfloat16), any T in the forward and T up to ``MAX_T_BWD`` in the
backward, which keeps float32 statistics of each query of a row in shared
memory (three in float32, four in bfloat16). ``attention_plan`` names the
launch of a shape: in bfloat16 the products run on the tensor cores, with
whole logit rows in registers up to T = ``REG_CAP`` and passes over streamed
key tiles above; float32 stays on the CUDA cores (the tensor cores take
float32 only as TF32).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import check_launch, cuda_device, library

DH_SUPPORTED = (4, 8, 16, 32, 64)
MAX_T_BWD = 8192
REG_CAP = 256              # T up to which a bf16 warp keeps whole logit rows in registers
SMEM_MAX = 232448          # 227 KB, the most shared memory one CTA may take on an H100
# csrc/attention_mma.cuh: warps of a registers-path and of a passes-path CTA,
# rows of a registers-path CTA at most, and the shared bytes such a CTA may
# take for more than one row; warps and shared bytes at most of a backward
# CTA that stores its weights for the key phase
_WARPS_REG, _WARPS_PASS, _ROWS_MAX, _ROW_BUDGET = 4, 8, 8, 57344
_WARPS_STORE, _STORE_BUDGET = 8, 115712


def _scale(dh: int, scale) -> float:
    """The logits' scale as the float32 value the reference multiplies by."""
    return float(np.float32(1.0 / np.sqrt(dh) if scale is None else scale))


def _check(q, k, v, key_mask, do=None):
    if q.dim() != 3:
        raise ValueError(f"q must be (N, T, dh), got {tuple(q.shape)}")
    N, T, dh = q.shape
    named = {"k": k, "v": v, **({} if do is None else {"do": do})}
    for name, t in named.items():
        if tuple(t.shape) != (N, T, dh):
            raise ValueError(f"{name} must be {(N, T, dh)} like q, got {tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise ValueError(f"q, k, v and do share one dtype: q is {q.dtype}, "
                             f"{name} is {t.dtype}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q, k, v must be float32 or bfloat16, got {q.dtype}")
    if tuple(key_mask.shape) != (N, T) or key_mask.dtype != torch.float32:
        raise ValueError(f"key_mask must be ({N}, {T}) float32, got "
                         f"{tuple(key_mask.shape)} {key_mask.dtype}")
    return N, T, dh


def attention_plan(N, T, dh, dtype=torch.bfloat16, backward=False):
    """The launch csrc/attention.cu makes for (N, T, dh) rows of ``dtype``,
    forward or backward: a dict of ``path`` ("registers": bf16, T <= ``REG_CAP``,
    whole rows in shared memory and logit rows in registers; "stored": as
    "registers", a backward whose weights and ds also fit shared memory, where
    the key phase reads them instead of recomputing them, one row a CTA;
    "passes": bf16 above ``REG_CAP``, key tiles streamed, max, sum then
    weights; "cuda_cores": float32),
    ``rows`` (rows a CTA), ``warps`` (a CTA), ``smem`` (shared bytes a CTA),
    ``ctas`` and ``cap`` (``REG_CAP``). A pure function of its arguments (the
    bf16 plan is the card's own ``sep_attn_plan``). Raises ValueError for dh
    outside ``DH_SUPPORTED`` and, naming the cap, for a backward above
    ``MAX_T_BWD``."""
    if dh not in DH_SUPPORTED:
        raise ValueError(f"chunk attention takes dh in {DH_SUPPORTED}, got {dh}")
    if backward and T > MAX_T_BWD:
        raise ValueError(f"the chunk_attention_bwd kernel takes T <= {MAX_T_BWD} (float32 "
                         f"statistics of every query in shared memory), got T={T}")
    if dtype == torch.float32:
        kt = min(T, 4096 // dh)
        smem = 4 * (2 * kt * dh + kt + (3 * T if backward else 0))
        return {"path": "cuda_cores", "rows": 1, "warps": min(8, -(-T // 32)), "smem": smem,
                "ctas": N, "cap": REG_CAP}
    dhp = max(16, dh)
    Tp, rs2, kt = -(-T // 16) * 16, 2 * (dhp + 8), 64 if dhp >= 64 else 128
    mt = Tp // 16
    if T <= REG_CAP:
        stored = 4 * Tp * rs2 + 4 * Tp + 6 * Tp * (Tp + 8)
        if backward and stored <= _STORE_BUDGET:
            return {"path": "stored", "rows": 1, "warps": _WARPS_STORE, "smem": stored,
                    "ctas": N, "cap": REG_CAP}
        per_row = 4 * Tp * rs2 + 20 * Tp if backward else 3 * Tp * rs2 + 4 * Tp

        def slots(r):                 # warp task slots of a CTA of r rows
            return _WARPS_REG * -(-r * mt // _WARPS_REG)

        rows = 1
        for r in range(2, min(_ROWS_MAX, N) + 1):
            if r * per_row > _ROW_BUDGET:
                break
            if r * mt * slots(rows) > rows * mt * slots(r):
                rows = r
        return {"path": "registers", "rows": rows, "warps": _WARPS_REG,
                "smem": rows * per_row, "ctas": -(-N // rows), "cap": REG_CAP}
    qr = 16 * _WARPS_PASS
    ring = 2 * (2 * kt * rs2 + 4 * kt)
    if backward:
        smem, ctas = 16 * Tp + 4 * qr + 2 * qr * rs2 + ring, N
    else:
        smem, ctas = qr * rs2 + ring, N * -(-T // qr)
    return {"path": "passes", "rows": 1, "warps": _WARPS_PASS, "smem": smem, "ctas": ctas,
            "cap": REG_CAP}


def card_plan(N, T, dh, backward=False):
    """The bf16 plan as the built library computes it (``sep_attn_plan``),
    in attention_plan's keys: what a card run holds attention_plan to."""
    vals = [ctypes.c_int(0) for _ in range(5)]
    library("attention").sep_attn_plan(int(backward), N, T, dh, *vals)
    path, rows, warps, smem, ctas = (v.value for v in vals)
    return {"path": ("registers", "passes", "stored")[path], "rows": rows, "warps": warps,
            "smem": smem, "ctas": ctas, "cap": REG_CAP}


def _weights(q, k, key_mask, scale):
    """The float32 softmax weights, step by step as the TPU kernel."""
    s = torch.bmm(q.float(), k.float().transpose(1, 2))
    s = s * scale + (1.0 - key_mask)[:, None, :] * (-1e9)
    s = s - torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s)
    return e / torch.sum(e, dim=-1, keepdim=True)


def chunk_attention_fwd_plain(q, k, v, key_mask, scale=None):
    """The forward in plain PyTorch: o (N, T, dh) in q's dtype."""
    _check(q, k, v, key_mask)
    w = _weights(q, k, key_mask, _scale(q.shape[-1], scale)).to(v.dtype)
    return torch.bmm(w.float(), v.float()).to(q.dtype)


def chunk_attention_bwd_plain(q, k, v, key_mask, do, scale=None):
    """The backward in plain PyTorch: (dq, dk, dv) in q's dtype."""
    _check(q, k, v, key_mask, do)
    scale = _scale(q.shape[-1], scale)
    w32 = _weights(q, k, key_mask, scale)
    wv = w32.to(v.dtype).float()
    dof = do.float()
    dv = torch.bmm(wv.transpose(1, 2), dof)
    dw = torch.bmm(dof, v.float().transpose(1, 2))
    ds = w32 * (dw - torch.sum(dw * w32, dim=-1, keepdim=True))
    ds = ds * scale
    dq = torch.bmm(ds, k.float())
    dk = torch.bmm(ds.transpose(1, 2), q.float())
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def chunk_attention_fwd(q, k, v, key_mask, scale=None):
    """K5's forward: o (N, T, dh) in q's dtype."""
    if q.device.type == "cpu":
        return chunk_attention_fwd_plain(q, k, v, key_mask, scale)
    N, T, dh = _check(q, k, v, key_mask)
    cuda_device("chunk_attention_fwd", q=q, k=k, v=v, key_mask=key_mask)
    attention_plan(N, T, dh, q.dtype)
    o = torch.empty_like(q)
    # the launch and its shared-memory opt-in act on the current device
    with torch.cuda.device(q.device):
        err = library("attention").sep_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(), o.data_ptr(),
            int(q.dtype == torch.bfloat16), N, T, dh, _scale(dh, scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(err, "attention", "chunk_attention_fwd")
    chunk_attention_fwd.launches += 1
    return o


def chunk_attention_bwd(q, k, v, key_mask, do, scale=None):
    """K5's backward: (dq, dk, dv) in q's dtype."""
    if q.device.type == "cpu":
        return chunk_attention_bwd_plain(q, k, v, key_mask, do, scale)
    N, T, dh = _check(q, k, v, key_mask, do)
    cuda_device("chunk_attention_bwd", q=q, k=k, v=v, key_mask=key_mask, do=do)
    attention_plan(N, T, dh, q.dtype, backward=True)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    with torch.cuda.device(q.device):
        err = library("attention").sep_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), int(q.dtype == torch.bfloat16),
            N, T, dh, _scale(dh, scale), torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(err, "attention", "chunk_attention_bwd")
    chunk_attention_bwd.launches += 1
    return dq, dk, dv


chunk_attention_fwd.launches = 0
chunk_attention_bwd.launches = 0


class _ChunkAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_mask, scale):
        ctx.save_for_backward(q, k, v, key_mask)
        ctx.scale = scale
        return chunk_attention_fwd(q, k, v, key_mask, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_mask = ctx.saved_tensors
        dq, dk, dv = chunk_attention_bwd(q, k, v, key_mask, do.contiguous(), ctx.scale)
        dm = torch.zeros_like(key_mask) if ctx.needs_input_grad[3] else None
        return dq, dk, dv, dm, None


def chunk_attention(q, k, v, key_mask, scale=None):
    """Differentiable fused masked attention over whole rows: q, k, v
    (N, T, dh), key_mask (N, T) float32; returns (N, T, dh) in q's dtype."""
    return _ChunkAttention.apply(q, k, v, key_mask, scale)
