"""Shared pieces of the plain references: product rounding, the optimizer
(global-norm clip, then Adam), and the per-leaf gaps that decide
``correct`` for a training cell."""

from __future__ import annotations

import torch

FP8_MAX = 448.0   # largest finite float8_e4m3fn


def rounding(precision: str):
    """The rounding of a product's inputs: 'bfloat16' (the configurations'
    precision), 'fp8' (per-tensor scaled float8_e4m3fn: the control, the
    next precision below) or 'float32' (none)."""
    if precision == "bfloat16":
        return lambda x: x.to(torch.bfloat16).float()
    if precision == "fp8":
        return _Fp8.apply
    if precision == "float32":
        return lambda x: x
    raise ValueError(f"unknown precision {precision!r}")


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Fp8(torch.autograd.Function):
    """Per-tensor scaled float8_e4m3fn rounding, of the value going forward
    and of its gradient going back."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


def dot(a: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    """a @ b with both inputs rounded by ``q`` and a float32 sum."""
    return torch.matmul(q(a), q(b))


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class ClipAdam:
    """Clip the gradients by their global norm (scaled by max_norm / norm
    only when norm >= max_norm), then Adam (torch's update: bias-corrected
    moments, eps added to the corrected root)."""

    def __init__(self, params: dict, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, max_norm=0.25):
        self.params = params
        self.lr, self.b1, self.b2, self.eps, self.max_norm = lr, b1, b2, eps, max_norm
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.k = 0

    @torch.no_grad()
    def step(self, grads: dict) -> dict:
        """Update the parameters in place; returns the clipped gradients."""
        norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads.values())).float()
        scale = torch.where(norm < self.max_norm, torch.ones_like(norm), self.max_norm / norm)
        clipped = {n: g * scale for n, g in grads.items()}
        self.k += 1
        bc1, bc2 = 1 - self.b1 ** self.k, 1 - self.b2 ** self.k
        for n, p in self.params.items():
            g = clipped[n]
            self.m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = self.v[n].sqrt() / bc2 ** 0.5 + self.eps
            p.sub_(self.lr / bc1 * self.m[n] / denom)
        return clipped


def three_steps(params: dict, batches: list, loss_fn) -> dict:
    """Three training steps of ``loss_fn(params, batch)`` from ``params``
    (a dict of the trained float32 leaves, not changed): each step's loss,
    each leaf's norm of the first clipped gradient, and of its change after
    the three. ``loss_fn`` returns a list of partial losses over blocks of
    rows whose sum is the loss; each is backpropagated on its own."""
    live = {n: p.detach().clone().requires_grad_(True) for n, p in params.items()}
    opt = ClipAdam(live)
    losses, grad1 = [], None
    for k, batch in enumerate(batches[:3]):
        grads = {n: torch.zeros_like(p) for n, p in live.items()}
        total = 0.0
        for part in loss_fn(live, batch):
            g = torch.autograd.grad(part, list(live.values()), allow_unused=True)
            for (n, _), gi in zip(live.items(), g):
                if gi is not None:
                    grads[n] += gi
            total += float(part.detach())
        losses.append(total)
        clipped = opt.step(grads)
        if k == 0:
            grad1 = {n: float(g.norm()) for n, g in clipped.items()}
    change = {n: float((live[n].detach() - params[n]).norm()) for n in params}
    return {"losses": losses, "grad1": grad1, "change": change}


def leaf_gaps(got: dict, ref: dict, ref_grad1: dict) -> tuple:
    """The worst leaf's gap |got - ref| / max(ref, median leaf of ref), over
    the leaves whose reference first gradient is at least a thousandth of
    the median leaf's (a leaf whose gradient is nought to rounding, such as
    a bias that a normalisation cancels, moves under Adam by round-off
    alone). A leaf the program does not report reads 0. Returns (gap, leaf,
    left-out leaves)."""
    gs = sorted(ref_grad1.values())
    g_med = gs[len(gs) // 2]
    kept = [n for n in ref if ref_grad1[n] >= 1e-3 * g_med]
    vals = sorted(ref[n] for n in kept)
    med = vals[len(vals) // 2]
    worst, leaf = 0.0, ""
    for n in kept:
        gap = abs(got.get(n, 0.0) - ref[n]) / max(ref[n], med, 1e-30)
        if gap > worst or leaf == "":
            worst, leaf = gap, n
    return worst, leaf, sorted(set(ref) - set(kept))


def draw(specs: list, generator: torch.Generator, device) -> dict:
    """Leaves drawn from one uniform draw on ``device``: ``specs`` lists
    (name, shape, low, high), each leaf U(low, high) (low == high gives a
    constant), in order, from one ``torch.rand`` call of their total size."""
    sizes = [int(torch.Size(shape).numel()) for _, shape, _, _ in specs]
    u = torch.rand(sum(sizes), generator=generator, device=device)
    out, at = {}, 0
    for (name, shape, lo, hi), n in zip(specs, sizes):
        out[name] = (lo + (hi - lo) * u[at: at + n]).reshape(shape)
        at += n
    return out


def blstm_specs(prefix: str, in_dim: int, hidden: int, layers: int) -> list:
    """torch.nn.LSTM's leaves and default draw, U(-1/sqrt(H), 1/sqrt(H)),
    with one bias per direction: ``bias_hh`` is zero, as the trainer keeps
    it."""
    k = hidden ** -0.5
    specs = []
    for layer in range(layers):
        d_in = in_dim if layer == 0 else 2 * hidden
        for sfx in ("", "_reverse"):
            specs += [(f"{prefix}weight_ih_l{layer}{sfx}", (4 * hidden, d_in), -k, k),
                      (f"{prefix}weight_hh_l{layer}{sfx}", (4 * hidden, hidden), -k, k),
                      (f"{prefix}bias_ih_l{layer}{sfx}", (4 * hidden,), -k, k),
                      (f"{prefix}bias_hh_l{layer}{sfx}", (4 * hidden,), 0.0, 0.0)]
    return specs


def blstm_layer(x: torch.Tensor, lengths: torch.Tensor, p: dict, prefix: str, layer: int,
                q) -> torch.Tensor:
    """One bidirectional LSTM layer over (B, T, I) with per-row lengths and
    a zero initial state, gate order (i, f, g, o): the forward direction over
    each row's frames, the reverse one over them backwards; (B, T, 2H), zero
    past each row's length. Plain: one step of both directions at a time."""
    B, T, _ = x.shape

    def leaf(n, sfx):
        return p[f"{prefix}{n}_l{layer}{sfx}"]

    H = leaf("weight_hh", "").shape[1]
    xw = torch.stack([dot(x, leaf("weight_ih", s).t(), q) + leaf("bias_ih", s) + leaf("bias_hh", s)
                      for s in ("", "_reverse")])                          # (2, B, T, 4H)
    w_hh = q(torch.stack([leaf("weight_hh", "").t(), leaf("weight_hh", "_reverse").t()]))
    mask = (torch.arange(T, device=x.device)[None, :] < lengths[:, None]).float()
    h = x.new_zeros((2, B, H))
    c = x.new_zeros((2, B, H))
    fwd, bwd = [None] * T, [None] * T
    for s in range(T):
        tf, tb = s, T - 1 - s
        g = torch.stack([xw[0, :, tf], xw[1, :, tb]]) + torch.bmm(q(h), w_hh)
        i, f, gg, o = g.split(H, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        m = torch.stack([mask[:, tf], mask[:, tb]])[..., None]
        c = m * c_new + (1 - m) * c
        h = m * h_new + (1 - m) * h
        y = m * h_new
        fwd[tf], bwd[tb] = y[0], y[1]
    return torch.cat([torch.stack(fwd, 1), torch.stack(bwd, 1)], dim=-1)

