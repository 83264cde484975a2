"""LSTM recurrences: the wrappers of csrc/lstm_fwd.cu and csrc/lstm_bwd.cu.

Three kernels, each replacing one TPU kernel of
speech_separation_tpu/ops/lstm_pallas.py and each running the full T-step
recurrence of both directions of one BLSTM layer in one launch, with prefix
masks for the forward direction and suffix masks for the time-flipped
reverse one:

- ``lstm_seq_infer`` (``lstm_seq_infer``, ``_fwd_infer_kernel``): the
  inference forward, ys in f32;
- ``lstm_seq_fwd`` (``lstm_seq_fwd``, ``_fwd_kernel``): the training
  forward, which also saves the carried cell states and the
  post-activation gates; ys, cs and gates in ``save_dtype``;
- ``lstm_seq_bwd`` (``lstm_seq_bwd``, ``_bwd_kernel``): reverse time over
  the saves, giving the pre-activation gate gradients dxw (zero at masked
  steps), dh0 and dc0.

``lstm_seq`` is the differentiable recurrence (the port of the JAX
package's ``lstm_seq`` custom VJP): a ``torch.autograd.Function`` whose
forward is ``lstm_seq_fwd`` and whose backward is ``lstm_seq_bwd`` plus
dW_hh = sum_t h_{t-1}^T dgates_t as one product outside the kernel (on the
tensor cores in bf16 on a card, ops/mxu.mxu_dot).

On the H100 each recurrence is a chain of T dependent small products per
direction, and one direction's W_hh (2.88 MB in bf16 at H=600) is far larger
than an SM's shared memory. The kernels split the hidden units over a
cooperative grid (D * ceil(H/8) CTAs of 8 units, two per SM), each CTA
keeping its slice of W_hh resident for the whole sequence and exchanging the
step's state through L2 with a grid barrier per step; the CUDA sources have
the design notes. ``lstm_fwd_plan`` and ``lstm_bwd_plan`` give the launch
for a shape and refuse one whose grid cannot be co-resident.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs its
plain PyTorch version (``*_plain``, a Python loop over t) only for CPU
tensors; ``<wrapper>.launches`` counts kernel launches. The kernels take
``save_dtype`` equal to the weights' dtype only, the pairing the training
path makes; the plain versions take any pairing.
"""

from __future__ import annotations

import ctypes

import torch

from . import mxu
from ._build import check_launch, cuda_device, library


def _check_state(name, s, D, B, H):
    if tuple(s.shape) != (D, B, H) or s.dtype != torch.float32:
        raise ValueError(f"{name} must be ({D}, {B}, {H}) float32, got "
                         f"{tuple(s.shape)} {s.dtype}")


def _suffix(suffix_dirs, D):
    suffix_dirs = tuple(suffix_dirs) if suffix_dirs is not None else (False,) * D
    if len(suffix_dirs) != D:
        raise ValueError(f"suffix_dirs has {len(suffix_dirs)} entries for {D} directions")
    return suffix_dirs


def _dims(xw, w_hh, h0, c0, lengths, suffix_dirs):
    if xw.dim() != 4 or w_hh.dim() != 3:
        raise ValueError(f"xw must be (T, D, B, 4H) and w_hh (D, H, 4H), got "
                         f"{tuple(xw.shape)} and {tuple(w_hh.shape)}")
    T, D, B, G = xw.shape
    H = G // 4
    if G != 4 * H or tuple(w_hh.shape) != (D, H, G):
        raise ValueError(f"w_hh {tuple(w_hh.shape)} does not match xw {tuple(xw.shape)}")
    _check_state("h0", h0, D, B, H)
    _check_state("c0", c0, D, B, H)
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be ({B},), got {tuple(lengths.shape)}")
    if T < 1:
        raise ValueError("xw has no time steps")
    return T, D, B, H, _suffix(suffix_dirs, D)


def _kernel_types(w_hh, *pairs):
    """The kernels' one type rule: every named tensor in w_hh's dtype,
    float32 or bfloat16."""
    if w_hh.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"w_hh must be float32 or bfloat16, got {w_hh.dtype}")
    for name, dtype in pairs:
        if dtype != w_hh.dtype:
            raise ValueError(f"the kernel takes {name} in w_hh's dtype {w_hh.dtype}, "
                             f"got {dtype}")


def _suffix_bits(suffix_dirs) -> int:
    return sum(1 << d for d, s in enumerate(suffix_dirs) if s)


def _step_mask(lengths, t, T, suffix_dirs):
    """(D, B, 1) float32: prefix mask t < length, or for a flipped-input
    direction the suffix mask length > T-1-t."""
    return torch.stack([(lengths > (T - 1 - t)) if s else (lengths > t)
                        for s in suffix_dirs]).to(torch.float32)[:, :, None]


# ------------------------------------------------------------------ forward

def lstm_seq_fwd_plain(xw, w_hh, h0, c0, lengths, save_dtype=torch.bfloat16,
                       suffix_dirs=None):
    """The training forward in plain PyTorch, step by step as _fwd_kernel:
    returns (ys, cs (T, D, B, H) and gates (T, D, B, 4H) in save_dtype,
    h_last, c_last (D, B, H) f32)."""
    T, D, B, H, suffix_dirs = _dims(xw, w_hh, h0, c0, lengths, suffix_dirs)
    w = w_hh.float()
    h, c = h0, c0
    ys, cs, gs = [], [], []
    for t in range(T):
        m = _step_mask(lengths, t, T, suffix_dirs)
        # h_{t-1} is rounded to the weight type; the sum stays f32
        gates = xw[t].float() + torch.bmm(h.to(w_hh.dtype).float(), w)
        ia = torch.sigmoid(gates[..., :H])
        fa = torch.sigmoid(gates[..., H:2 * H])
        ga = torch.tanh(gates[..., 2 * H:3 * H])
        oa = torch.sigmoid(gates[..., 3 * H:])
        c_new = fa * c + ia * ga
        h_new = oa * torch.tanh(c_new)
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        ys.append((m * h_new).to(save_dtype))
        cs.append(c.to(save_dtype))
        gs.append(torch.cat([ia, fa, ga, oa], dim=-1).to(save_dtype))
    return torch.stack(ys), torch.stack(cs), torch.stack(gs), h, c


def lstm_seq_infer_plain(xw, w_hh, h0, c0, lengths, suffix_dirs=None):
    """The inference forward in plain PyTorch: returns (ys (T, D, B, H),
    h_last (D, B, H), c_last (D, B, H)), f32."""
    ys, _, _, h, c = lstm_seq_fwd_plain(xw, w_hh, h0, c0, lengths, torch.float32,
                                        suffix_dirs)
    return ys, h, c


_plans: dict = {}


def _plan(kernel, what, D, B, H, dtype):
    """The launch plan of csrc/<kernel>.cu for a shape on the current card
    (see lstm_fwd_plan), or ValueError naming the cap."""
    key = (kernel, torch.cuda.current_device(), D, B, H, dtype)
    if key in _plans:
        return _plans[key]
    vals = [ctypes.c_int(0) for _ in range(5)]
    fn = getattr(library(kernel), f"sep_{kernel}_plan")
    err = fn(int(dtype == torch.bfloat16), D, B, H, *(ctypes.byref(v) for v in vals))
    check_launch(err, kernel, f"{kernel} plan")
    ctas, per_sm, sms, smem, rows = (v.value for v in vals)
    plan = {"ctas": ctas, "per_sm": per_sm, "sms": sms, "cap": per_sm * sms,
            "smem": smem, "rows": rows}
    if ctas > plan["cap"]:
        raise ValueError(
            f"{what} at D={D}, B={B}, H={H} {dtype} needs {ctas} co-resident "
            f"CTAs, above the cap of {plan['cap']} ({per_sm} per SM x {sms} SMs at "
            f"{smem} bytes of shared memory each)")
    _plans[key] = plan
    return plan


def lstm_fwd_plan(D, B, H, dtype=torch.bfloat16):
    """The launch csrc/lstm_fwd.cu makes for a shape on the current card (the
    training and the inference instance alike): a dict of ``ctas`` (D *
    ceil(H/8)), ``per_sm`` (CTAs that can be resident on one SM at its
    shared memory, the fewer of the two instances'), ``sms``, ``cap``
    (per_sm * sms), ``smem`` (bytes per CTA, whatever B) and ``rows`` (the
    batch rows of one group of its h ring). Raises ValueError, naming the
    cap, for a grid that cannot be co-resident (the cooperative launch and
    the per-step grid barrier need every CTA resident at once): on an H100,
    H above 1056, or above 848 in float32."""
    return _plan("lstm_fwd", "lstm_seq_fwd / lstm_seq_infer", D, B, H, dtype)


def _launch_fwd(xw, w_hh, h0, c0, lengths, suffix_dirs, save_dtype):
    """One launch of csrc/lstm_fwd.cu: the inference instance when
    save_dtype is None, else the training instance."""
    T, D, B, H, suffix_dirs = _dims(xw, w_hh, h0, c0, lengths, suffix_dirs)
    _kernel_types(w_hh, ("xw", xw.dtype),
                  *(() if save_dtype is None else (("save_dtype", save_dtype),)))
    dev = xw.device
    with torch.cuda.device(dev):
        lstm_fwd_plan(D, B, H, w_hh.dtype)
    xw, w_hh = xw.contiguous(), w_hh.contiguous()
    h0, c0 = h0.contiguous(), c0.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    h_last = torch.empty((D, B, H), dtype=torch.float32, device=dev)
    c_last = torch.empty_like(h_last)
    # the kernel's exchange of h in the weight type, rows padded to 8 elements
    hbuf = torch.empty((2, D, B, -(-H // 8) * 8), dtype=w_hh.dtype, device=dev)
    barrier = torch.zeros((1,), dtype=torch.int32, device=dev)
    bf16 = int(w_hh.dtype == torch.bfloat16)
    lib = library("lstm_fwd")
    stream = torch.cuda.current_stream(dev).cuda_stream
    if save_dtype is None:
        ys = torch.empty((T, D, B, H), dtype=torch.float32, device=dev)
        # the launch plans on, and launches to, the current device
        with torch.cuda.device(dev):
            err = lib.sep_lstm_infer(
                xw.data_ptr(), w_hh.data_ptr(), bf16, h0.data_ptr(), c0.data_ptr(),
                lengths.data_ptr(), ys.data_ptr(), h_last.data_ptr(), c_last.data_ptr(),
                hbuf.data_ptr(), barrier.data_ptr(), T, D, B, H, _suffix_bits(suffix_dirs),
                stream)
        check_launch(err, "lstm_fwd", "lstm_infer")
        return ys, h_last, c_last
    ys = torch.empty((T, D, B, H), dtype=save_dtype, device=dev)
    cs = torch.empty_like(ys)
    gates = torch.empty((T, D, B, 4 * H), dtype=save_dtype, device=dev)
    with torch.cuda.device(dev):
        err = lib.sep_lstm_fwd(
            xw.data_ptr(), w_hh.data_ptr(), bf16, h0.data_ptr(), c0.data_ptr(),
            lengths.data_ptr(), ys.data_ptr(), cs.data_ptr(), gates.data_ptr(),
            h_last.data_ptr(), c_last.data_ptr(), hbuf.data_ptr(), barrier.data_ptr(),
            T, D, B, H, _suffix_bits(suffix_dirs), stream)
    check_launch(err, "lstm_fwd", "lstm_fwd")
    return ys, cs, gates, h_last, c_last


def lstm_seq_infer(xw, w_hh, h0, c0, lengths, suffix_dirs=None):
    """Inference-only recurrence: returns (ys (T, D, B, H) f32,
    h_last (D, B, H) f32, c_last (D, B, H) f32). It records no autograd
    graph: on CUDA it refuses inputs that require grad (``lstm_seq`` is
    the differentiable recurrence).

    xw: (T, D, B, 4H) gate inputs and w_hh: (D, H, 4H), both bf16 or both
    f32; h0, c0: (D, B, H) f32; lengths: (B,) int; suffix_dirs: per
    direction, True for a time-flipped input (suffix mask)."""
    if xw.device.type == "cpu":
        return lstm_seq_infer_plain(xw, w_hh, h0, c0, lengths, suffix_dirs)
    cuda_device("lstm_seq_infer", contiguous=False, xw=xw, w_hh=w_hh, h0=h0, c0=c0,
                lengths=lengths)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xw, w_hh, h0, c0)):
        raise RuntimeError("lstm_seq_infer gives no gradient (its kernel records no "
                           "autograd graph); use lstm_seq for a differentiable "
                           "recurrence, or run under torch.no_grad()")
    out = _launch_fwd(xw, w_hh, h0, c0, lengths, suffix_dirs, None)
    lstm_seq_infer.launches += 1
    return out


def lstm_seq_fwd(xw, w_hh, h0, c0, lengths, save_dtype=torch.bfloat16,
                 suffix_dirs=None):
    """Training forward: returns (ys, cs, gates, h_last, c_last) as
    ``lstm_seq_fwd_plain``. On CUDA, xw, w_hh and save_dtype share one
    dtype (bf16 or f32)."""
    if xw.device.type == "cpu":
        return lstm_seq_fwd_plain(xw, w_hh, h0, c0, lengths, save_dtype, suffix_dirs)
    cuda_device("lstm_seq_fwd", contiguous=False, xw=xw, w_hh=w_hh, h0=h0, c0=c0,
                lengths=lengths)
    out = _launch_fwd(xw, w_hh, h0, c0, lengths, suffix_dirs, save_dtype)
    lstm_seq_fwd.launches += 1
    return out


lstm_seq_infer.launches = 0
lstm_seq_fwd.launches = 0


# ----------------------------------------------------------------- backward

def _bwd_dims(w_hh, c0, lengths, cs, gates, dys, dh_last, dc_last, suffix_dirs):
    if gates.dim() != 4:
        raise ValueError(f"gates must be (T, D, B, 4H), got {tuple(gates.shape)}")
    T, D, B, G = gates.shape
    H = G // 4
    if G != 4 * H or tuple(w_hh.shape) != (D, H, G):
        raise ValueError(f"w_hh {tuple(w_hh.shape)} does not match gates "
                         f"{tuple(gates.shape)}")
    for name, t in (("cs", cs), ("dys", dys)):
        if tuple(t.shape) != (T, D, B, H):
            raise ValueError(f"{name} must be ({T}, {D}, {B}, {H}), got {tuple(t.shape)}")
    for name, s in (("c0", c0), ("dh_last", dh_last), ("dc_last", dc_last)):
        _check_state(name, s, D, B, H)
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be ({B},), got {tuple(lengths.shape)}")
    return T, D, B, H, _suffix(suffix_dirs, D)


def lstm_seq_bwd_plain(w_hh, c0, lengths, cs, gates, dys, dh_last, dc_last,
                       save_dtype=torch.bfloat16, suffix_dirs=None):
    """The reverse-time gradient in plain PyTorch, step by step as
    _bwd_kernel: returns (dxw (T, D, B, 4H) save_dtype, dh0, dc0 f32)."""
    T, D, B, H, suffix_dirs = _bwd_dims(w_hh, c0, lengths, cs, gates, dys,
                                        dh_last, dc_last, suffix_dirs)
    wT = w_hh.float().transpose(1, 2)                     # (D, 4H, H)
    dh, dc = dh_last, dc_last
    dxw = [None] * T
    for t in range(T - 1, -1, -1):
        m = _step_mask(lengths, t, T, suffix_dirs)
        g = gates[t].float()
        ia, fa, ga, oa = g[..., :H], g[..., H:2 * H], g[..., 2 * H:3 * H], g[..., 3 * H:]
        c_t = cs[t].float()
        # c_{t-1}: the saved (rounded) state, or c0 at the first step
        c_prev = cs[t - 1].float() if t > 0 else c0
        dh_new = m * (dh + dys[t].float())
        tanh_c = torch.tanh(c_t)
        dc_new = m * dc + dh_new * oa * (1.0 - tanh_c * tanh_c)
        di = dc_new * ga
        df = dc_new * c_prev
        dg = dc_new * ia
        do = dh_new * tanh_c
        dgates = torch.cat([di * ia * (1.0 - ia), df * fa * (1.0 - fa),
                            dg * (1.0 - ga * ga), do * oa * (1.0 - oa)], dim=-1)
        dxw[t] = dgates.to(save_dtype)
        # dgates are rounded to the weight type before the product
        dh = (1.0 - m) * dh + torch.bmm(dgates.to(w_hh.dtype).float(), wT)
        dc = (1.0 - m) * dc + dc_new * fa
    return torch.stack(dxw), dh, dc


def lstm_bwd_plan(D, B, H, dtype=torch.bfloat16):
    """The launch csrc/lstm_bwd.cu makes for a shape on the current card:
    a dict of ``ctas`` (D * ceil(H/8)), ``per_sm`` (CTAs that can be
    resident on one SM at its shared memory), ``sms``, ``cap`` (per_sm *
    sms), ``smem`` (bytes per CTA, whatever B) and ``rows`` (the batch rows
    of one group of its dxw ring). Raises ValueError, naming the cap, for a
    grid that cannot be co-resident (the cooperative launch and the
    per-step grid barrier need every CTA resident at once): on an H100, H
    above 1056, or above 864 in float32."""
    return _plan("lstm_bwd", "lstm_seq_bwd", D, B, H, dtype)


def lstm_seq_bwd(w_hh, c0, lengths, cs, gates, dys, dh_last, dc_last,
                 save_dtype=torch.bfloat16, suffix_dirs=None):
    """Reverse-time gradient: returns (dxw (T, D, B, 4H) save_dtype, dh0,
    dc0 (D, B, H) f32). On CUDA, w_hh, cs, gates, dys and save_dtype share
    one dtype (bf16 or f32)."""
    if gates.device.type == "cpu":
        return lstm_seq_bwd_plain(w_hh, c0, lengths, cs, gates, dys, dh_last,
                                  dc_last, save_dtype, suffix_dirs)
    dev = cuda_device("lstm_seq_bwd", contiguous=False, gates=gates, w_hh=w_hh, c0=c0,
                      lengths=lengths, cs=cs, dys=dys, dh_last=dh_last, dc_last=dc_last)
    T, D, B, H, suffix_dirs = _bwd_dims(w_hh, c0, lengths, cs, gates, dys,
                                        dh_last, dc_last, suffix_dirs)
    _kernel_types(w_hh, ("save_dtype", save_dtype), ("cs", cs.dtype),
                  ("gates", gates.dtype), ("dys", dys.dtype))
    with torch.cuda.device(dev):
        lstm_bwd_plan(D, B, H, w_hh.dtype)
    w_hh, cs, gates, dys = (t.contiguous() for t in (w_hh, cs, gates, dys))
    c0, dh_last, dc_last = (t.contiguous() for t in (c0, dh_last, dc_last))
    lengths = lengths.to(torch.int32).contiguous()
    dxw = torch.empty((T, D, B, 4 * H), dtype=save_dtype, device=dev)
    dh0 = torch.empty((D, B, H), dtype=torch.float32, device=dev)
    dc0 = torch.empty_like(dh0)
    barrier = torch.zeros((1,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = library("lstm_bwd").sep_lstm_bwd(
            w_hh.data_ptr(), int(w_hh.dtype == torch.bfloat16), c0.data_ptr(),
            lengths.data_ptr(), cs.data_ptr(), gates.data_ptr(), dys.data_ptr(),
            dh_last.data_ptr(), dc_last.data_ptr(), dxw.data_ptr(), dh0.data_ptr(),
            dc0.data_ptr(), barrier.data_ptr(), T, D, B, H, _suffix_bits(suffix_dirs),
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "lstm_bwd", "lstm_bwd")
    lstm_seq_bwd.launches += 1
    return dxw, dh0, dc0


lstm_seq_bwd.launches = 0


# ------------------------------------------------------- differentiable call

def _h_prev(ys, h0, lengths, suffix_dirs, dim=1):
    """h_{t-1} of every step, (T, D, B, H) in ys's dtype (h0 rounded to it),
    or (D, T, B, H) with ``dim=0``, from the saved ys. ys holds m * h_new,
    which differs from the carried state only at masked steps, where dgates
    is zero; the initial state is patched in at t = 0 of a prefix
    direction, and over a suffix direction's whole pad zone up to and
    including its first valid step (t <= T - length)."""
    T = ys.shape[0]
    h0 = h0.to(ys.dtype)
    shift = torch.cat([torch.zeros_like(ys[:1]), ys[:-1]])
    dirs = []
    for d, suffix in enumerate(suffix_dirs):
        if suffix:
            zone = (torch.arange(T, device=ys.device)[:, None]
                    <= (T - lengths.to(ys.device))[None, :])      # (T, B)
            dirs.append(torch.where(zone[:, :, None], h0[d][None], shift[:, d]))
        else:
            dirs.append(torch.cat([h0[d][None], ys[:-1, d]]))
    return torch.stack(dirs, dim=dim)


def _dw_hh(ys, h0, lengths, suffix_dirs, dxw, w_dtype):
    """dW_hh = sum_t h_{t-1}^T dgates_t (D, H, 4H) in w_dtype: operands in
    the save type, the sum in f32, rounded once. On a card in bf16, one
    direction-batched product on the tensor cores (ops/mxu.mxu_dot)."""
    if mxu.tensor_cores(dxw.device, dxw.dtype):
        T, D, B, G = dxw.shape
        h_prev = _h_prev(ys, h0, lengths, suffix_dirs, dim=0).reshape(D, T * B, -1)
        g = dxw.transpose(0, 1).reshape(D, T * B, G)
        return mxu.mxu_dot(h_prev.transpose(1, 2), g, w_dtype)
    h_prev = _h_prev(ys, h0, lengths, suffix_dirs).to(dxw.dtype).float()
    return torch.einsum("tdbh,tdbg->dhg", h_prev, dxw.float()).to(w_dtype)


class _LstmSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xw, w_hh, h0, c0, lengths, save_dtype, suffix_dirs):
        ys, cs, gates, h_last, c_last = lstm_seq_fwd(xw, w_hh, h0, c0, lengths,
                                                     save_dtype, suffix_dirs)
        ctx.save_for_backward(w_hh, h0, c0, lengths, ys, cs, gates)
        ctx.xw_dtype, ctx.save_dtype = xw.dtype, save_dtype
        ctx.suffix_dirs = _suffix(suffix_dirs, xw.shape[1])
        return ys, h_last, c_last

    @staticmethod
    def backward(ctx, dys, dh_last, dc_last):
        w_hh, h0, c0, lengths, ys, cs, gates = ctx.saved_tensors
        sd = ctx.save_dtype
        dxw, dh0, dc0 = lstm_seq_bwd(w_hh, c0, lengths, cs, gates, dys.to(sd),
                                     dh_last.float(), dc_last.float(), sd,
                                     ctx.suffix_dirs)
        dw_hh = _dw_hh(ys, h0, lengths, ctx.suffix_dirs, dxw, w_hh.dtype)
        return dxw.to(ctx.xw_dtype), dw_hh, dh0, dc0, None, None, None


def lstm_seq(xw, w_hh, h0, c0, lengths, save_dtype=torch.bfloat16, suffix_dirs=None):
    """Differentiable full-sequence recurrence: returns (ys (T, D, B, H)
    save_dtype, h_last, c_last (D, B, H) f32). Gradients flow to xw, w_hh,
    h0 and c0; unused cotangents of h_last and c_last count as zeros."""
    return _LstmSeq.apply(xw, w_hh, h0, c0, lengths, save_dtype, suffix_dirs)
