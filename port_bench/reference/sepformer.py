"""Plain reference of SepFormer (Subakan, Ravanelli, Cornell, Bronzi and
Zhong, "Attention is All You Need in Speech Separation", ICASSP 2021,
arXiv:2010.13154) in its published structure, after SpeechBrain's WSJ0-2mix
recipe: a ReLU linear encoder over 50%-overlapping frames, global layer
norm and a bottleneck, 50%-overlap chunks, dual-path blocks (per path a
stack of pre-LN transformer layers, the sinusoidal positional encoding
added once to the stack's input and a final LayerNorm, then a masked global
layer norm on the path's output and a residual around the path), a PReLU
and linear head, overlap-add merge, the output gate tanh(x W_t + b_t) *
sigmoid(x W_s + b_s) and a 1x1 without bias, ReLU masks over the latents,
a linear decoder with overlap-add; trained by utterance-level PIT over
negative SI-SNR.

A layer is x + MHA(LN(x)) then x + FFN(LN(x)) with a ReLU FFN; the
attention's logits are materialised in float32 with the keys past each
row's true frames (intra) or chunks (inter) masked additively, the softmax
in float32, and the weights rounded like every product's inputs.

Leaves carry the port's ``.mdl`` names (``enc``,
``blocks.0.intra.layers.3.qkv.w`` in (in, out) layout,
``blocks.0.intra.ln.g``, ``blocks.0.intra.gln.g``, ``gate_tanh.w``,
``gate_end``, ...). Also here: SepFormer's product operations, and the
attention calls a step launches. The configuration's ``assumed`` lists
each departure from SpeechBrain.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import dot, draw
from .dprnn import (gln, latent_frames, num_chunks, output_grads,  # noqa: F401
                    overlap_add, pit_per_perm)

# rows of one block of the reference's training pass: each block's loss is
# backpropagated on its own (SepFormer has no statistic across rows); a 4 s
# row keeps about 11 GB of float32 activations, most of them the intra
# paths' materialised (heads, 250, 250) logits and weights, on a card the
# program has left
ROW_BLOCK = 4
LN_EPS = 1e-6     # each layer's LayerNorms and the stack's final one
PATH_EPS = 1e-8   # the global layer norm around each path


def init_params(model: dict, generator: torch.Generator, device) -> dict:
    """Every leaf from the seed's generator on ``device``, in one draw: the
    encoder U(+-1/sqrt(filter_len)), the decoder and the gate's 1x1
    U(+-1/sqrt(n_filters)), linear layers U(+-1/sqrt(n_in)), the norms'
    scale and shift around identity, PReLU 0.25."""
    N, L, C = model["n_filters"], model["filter_len"], model["channels"]
    S, F_ = model["num_spk"], model["d_ff"]

    def lin(name, n_in, n_out):
        k = n_in ** -0.5
        return [(f"{name}.w", (n_in, n_out), -k, k), (f"{name}.b", (n_out,), -k, k)]

    def norm(name, dim):
        return [(f"{name}.g", (dim,), 0.9, 1.1), (f"{name}.b", (dim,), -0.05, 0.05)]

    specs = [("enc", (L, N), -L ** -0.5, L ** -0.5), ("dec", (N, L), -N ** -0.5, N ** -0.5),
             ("head_prelu", (C,), 0.25, 0.25), *norm("in_ln", N),
             *lin("bottleneck", N, C), *lin("head", C, N * S),
             *lin("gate_tanh", N, N), *lin("gate_sigmoid", N, N),
             ("gate_end", (N, N), -N ** -0.5, N ** -0.5)]
    for b in range(model["blocks"]):
        for path in ("intra", "inter"):
            pre = f"blocks.{b}.{path}."
            for layer in range(model["layers"]):
                lp = f"{pre}layers.{layer}."
                specs += [*norm(lp + "ln1", C), *lin(lp + "qkv", C, 3 * C),
                          *lin(lp + "out", C, C), *norm(lp + "ln2", C),
                          *lin(lp + "ff1", C, F_), *lin(lp + "ff2", F_, C)]
            specs += norm(pre + "ln", C) + norm(pre + "gln", C)
    return draw(specs, generator, device)


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the channels of each position."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * g + b


def path_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, mask: torch.Tensor
              ) -> torch.Tensor:
    """Global layer norm of (B, C, K, H) over each utterance's true
    positions (``mask`` (B, C, K, 1)) and all channels, eps 1e-8."""
    cnt = torch.clamp_min(mask.sum(dim=(1, 2, 3), keepdim=True) * x.shape[-1], 1.0)
    mu = (x * mask).sum(dim=(1, 2, 3), keepdim=True) / cnt
    var = (((x - mu) * mask) ** 2).sum(dim=(1, 2, 3), keepdim=True) / cnt
    return (x - mu) * torch.rsqrt(var + PATH_EPS) * g + b


def positional_encoding(T: int, H: int, device) -> torch.Tensor:
    """Sinusoidal PE (T, H): sin at even channels, cos at odd ones."""
    pos = torch.arange(T, dtype=torch.float64, device=device)[:, None]
    div = torch.exp(torch.arange(0, H, 2, dtype=torch.float64, device=device)
                    * (-math.log(10000.0) / H))
    pe = torch.zeros((T, H), dtype=torch.float64, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div[: H // 2])
    return pe.float()


def linear(x: torch.Tensor, p: dict, name: str, q) -> torch.Tensor:
    return dot(x, p[name + ".w"], q) + p[name + ".b"]


def transformer_layer(x: torch.Tensor, p: dict, pre: str, key_mask: torch.Tensor, heads: int,
                      q) -> torch.Tensor:
    """One pre-LN layer over axis 1 of x (R, T, H); key_mask (R, T) 1.0 at
    the true keys."""
    R, T, H = x.shape
    dh = H // heads
    y = layer_norm(x, p[pre + "ln1.g"], p[pre + "ln1.b"])
    qkv = linear(y, p, pre + "qkv", q).reshape(R, T, 3, heads, dh).permute(2, 0, 3, 1, 4)
    qh, kh, vh = qkv[0], qkv[1], qkv[2]                                   # (R, heads, T, dh)
    logits = dot(qh, kh.transpose(-1, -2), q) * dh ** -0.5
    logits = logits + (1.0 - key_mask)[:, None, None, :] * (-1e9)
    o = dot(torch.softmax(logits, dim=-1), vh, q).permute(0, 2, 1, 3).reshape(R, T, H)
    x = x + linear(o, p, pre + "out", q)
    y = layer_norm(x, p[pre + "ln2.g"], p[pre + "ln2.b"])
    return x + linear(torch.relu(linear(y, p, pre + "ff1", q)), p, pre + "ff2", q)


def path(x: torch.Tensor, p: dict, pre: str, key_mask: torch.Tensor, model: dict, q
         ) -> torch.Tensor:
    """A path's stack over axis 1 of x (R, T, H): the PE added once, the
    layers, the final LayerNorm."""
    x = x + positional_encoding(x.shape[1], x.shape[2], x.device)
    for layer in range(model["layers"]):
        x = transformer_layer(x, p, f"{pre}layers.{layer}.", key_mask, model["heads"], q)
    return layer_norm(x, p[pre + "ln.g"], p[pre + "ln.b"])


def separate(p: dict, model: dict, wav: torch.Tensor, n: torch.Tensor, q) -> torch.Tensor:
    """(B, L) waveforms, (B,) sample counts -> (B, S, L) estimates."""
    B, Ls = wav.shape
    K, P = model["chunk"], model["chunk"] // 2
    Nf, S, stride = model["n_filters"], model["num_spk"], model["stride"]
    n_t = latent_frames(model, Ls)
    frames = wav.unfold(-1, model["filter_len"], stride)[:, :n_t]
    vt = torch.clamp(torch.div(n + stride - 1, stride, rounding_mode="floor"), 1, n_t)
    tmask = (torch.arange(n_t, device=wav.device)[None, :] < vt[:, None]).float()[..., None]
    w = torch.relu(dot(frames, p["enc"], q)) * tmask                      # (B, T, N)
    h = linear(gln(w, p["in_ln.g"], p["in_ln.b"], tmask), p, "bottleneck", q) * tmask
    C = num_chunks(model, n_t)
    back = (-(P + n_t) % P) + P
    rows = F.pad(h, (0, 0, P, back)).reshape(B, -1, P, h.shape[-1])
    h = torch.cat([rows[:, :-1], rows[:, 1:]], dim=2)                      # (B, C, K, H)
    starts = torch.arange(C, device=wav.device) * P - P
    clens = torch.clamp(vt[:, None] - starts[None, :], 0, K)               # (B, C)
    cmask = (torch.arange(K, device=wav.device)[None, None, :] < clens[..., None]).float()[..., None]
    n_chunks = torch.clamp_min(torch.div(vt + P - 1, P, rounding_mode="floor") + 1, 1)
    kmask_intra = cmask[..., 0].reshape(B * C, K)
    kmask_inter = ((torch.arange(C, device=wav.device)[None, :] < n_chunks[:, None]).float()
                   [:, None, :].expand(B, K, C).reshape(B * K, C))
    Hc = h.shape[-1]
    for b in range(model["blocks"]):
        pre = f"blocks.{b}."
        y = path(h.reshape(B * C, K, Hc), p, pre + "intra.", kmask_intra, model, q)
        y = path_norm(y.reshape(B, C, K, Hc), p[pre + "intra.gln.g"], p[pre + "intra.gln.b"],
                      cmask)
        h = (h + y) * cmask
        y = path(h.transpose(1, 2).reshape(B * K, C, Hc), p, pre + "inter.", kmask_inter, model, q)
        y = path_norm(y.reshape(B, K, C, Hc).transpose(1, 2), p[pre + "inter.gln.g"],
                      p[pre + "inter.gln.b"], cmask)
        h = (h + y) * cmask
    act = torch.where(h >= 0, h, h * p["head_prelu"])
    out = linear(act, p, "head", q) * cmask                                # (B, C, K, S*N)
    merged = F.pad(out[:, :, :P], (0, 0, 0, 0, 0, 1)) + F.pad(out[:, :, P:], (0, 0, 0, 0, 1, 0))
    merged = merged.reshape(B, (C + 1) * P, -1)[:, P: P + n_t] * 0.5
    x = merged.reshape(B, n_t, S, Nf)
    gate = torch.tanh(linear(x, p, "gate_tanh", q)) * torch.sigmoid(linear(x, p, "gate_sigmoid", q))
    m = torch.relu(dot(gate, p["gate_end"], q)) * tmask[:, :, None, :]
    masked = (w[:, :, None, :] * m).permute(0, 2, 1, 3).reshape(B * S, n_t, Nf)
    y = overlap_add(dot(masked, p["dec"], q), stride)
    y = F.pad(y, (0, max(0, Ls - y.shape[-1])))[:, :Ls]
    return y.reshape(B, S, Ls)


def loss(p: dict, model: dict, batch: dict, q, per_perm_out: list | None = None):
    """PIT negative SI-SNR of a waveform batch (``mix_wav`` (B, L),
    ``source_wavs`` (B, S, L), ``sample_lengths``): the least over speaker
    orders per row, summed, over S and the number of rows; in blocks of
    ROW_BLOCK rows, whose partial losses sum to it. Without
    ``per_perm_out`` the blocks' losses come one at a time, each computed
    when it is asked for, so a caller that backpropagates each before it
    takes the next holds one block's graph at a time (the whole batch's
    would not fit the card). With it, every block is computed at once (a
    list; meant for a pass without gradients) and ``per_perm_out``
    collects each row's loss under each speaker order."""
    blocks = _loss_blocks(p, model, batch, q, per_perm_out)
    return blocks if per_perm_out is None else list(blocks)


def _loss_blocks(p: dict, model: dict, batch: dict, q, per_perm_out: list | None):
    mix, src, n = batch["mix_wav"], batch["source_wavs"], batch["sample_lengths"]
    B = mix.shape[0]
    S = model["num_spk"]
    for r in range(0, B, ROW_BLOCK):
        rows = slice(r, r + ROW_BLOCK)
        per_perm = pit_per_perm(separate(p, model, mix[rows], n[rows], q), src[rows], n[rows], S)
        if per_perm_out is not None:
            per_perm_out.append(per_perm.detach())
        yield per_perm.min(dim=1).values.sum() / S / B


def outputs(p: dict, model: dict, batch: dict, q) -> torch.Tensor:
    """The training forward's estimated sources, (B, S, L), in blocks of
    ROW_BLOCK rows."""
    mix, n = batch["mix_wav"], batch["sample_lengths"]
    return torch.cat([separate(p, model, mix[r: r + ROW_BLOCK], n[r: r + ROW_BLOCK], q)
                      for r in range(0, mix.shape[0], ROW_BLOCK)])


def forward_flops(model: dict, n_samples: int) -> float:
    """Product operations of one utterance's forward at ``n_samples``: the
    encoder and the bottleneck a latent frame; per block, path, layer and
    chunk position the qkv, out, ff1 and ff2 products and the attention's
    QK^T and AV over the path's T keys (the chunk for intra, the chunks for
    inter); the head a chunk position; the gate's three products and the
    decoder a latent frame and source. Norms, masks, the softmax and the
    loss are not products."""
    N, Lf, C = model["n_filters"], model["filter_len"], model["channels"]
    S, F_, K = model["num_spk"], model["d_ff"], model["chunk"]
    n_t = latent_frames(model, n_samples)
    chunks = num_chunks(model, n_t)
    positions = chunks * K
    dense = 2 * C * 3 * C + 2 * C * C + 2 * (2 * C * F_)
    attention = 4 * K * C + 4 * chunks * C      # QK^T and AV: intra, then inter
    per_frame = 2 * Lf * N + 2 * N * C + S * (3 * 2 * N * N + 2 * N * Lf)
    return (n_t * per_frame
            + positions * (model["blocks"] * model["layers"] * (2 * dense + attention)
                           + 2 * C * N * S))


def train_flops(model: dict, sample_lengths) -> float:
    """Forward and backward (three forwards) of every row; the rows are
    whole segments, so each counts at its own length."""
    return 3.0 * sum(forward_flops(model, int(n)) for n in sample_lengths)


def lstm_launches(model: dict, n_samples: int, sample_lengths) -> list:
    """SepFormer runs no recurrence."""
    return []


def attention_launches(model: dict, n_samples: int, sample_lengths) -> list:
    """(N, T, dh) of each attention call (K5 with ``fused_attention``) of one
    pass over a batch of rows padded to ``n_samples``, in order: per block
    ``layers`` intra-chunk calls (T = chunk over B * chunks * heads rows),
    then ``layers`` inter-chunk ones (T = chunks over B * chunk * heads
    rows). The backward runs one call for each, in the reverse order."""
    if str(model.get("fused_attention", False)).lower() not in ("1", "true"):
        return []
    B, K, heads = len(sample_lengths), model["chunk"], model["heads"]
    C = num_chunks(model, latent_frames(model, n_samples))
    dh = model["channels"] // heads
    path_calls = [(B * C * heads, K, dh)] * model["layers"] + [(B * K * heads, C, dh)] * model["layers"]
    return path_calls * model["blocks"]
