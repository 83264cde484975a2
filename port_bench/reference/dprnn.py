"""Plain reference of DPRNN (Luo, Chen and Yoshioka, "Dual-path RNN",
arXiv:1910.06379), as the port's defaults configure it: a ReLU linear
encoder over 50%-overlapping frames, global layer norm and a bottleneck,
50%-overlap chunks, dual-path blocks (an intra-chunk and an inter-chunk
bidirectional LSTM, each with a linear projection, a masked global layer
norm and a residual), a PReLU and linear head, overlap-add merge, ReLU
masks over the latents, a linear decoder with overlap-add; trained by
utterance-level PIT over negative SI-SNR.

Leaves carry the port's ``.mdl`` names (``enc``, ``blocks.0.intra_rnn.*``
as torch.nn.LSTM's, ``blocks.0.intra_proj.w`` in (in, out) layout, ...).
Also here: DPRNN's product operations, and the recurrences a step launches.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from .common import blstm_layer, blstm_specs, dot, draw

# rows of one block of the reference's training pass: each block's loss is
# backpropagated on its own (DPRNN has no statistic across rows); 32 rows of
# 4 s keep about 50 GB of activations, on a card the program has left
ROW_BLOCK = 32


def init_params(model: dict, generator: torch.Generator, device) -> dict:
    """Every leaf from the seed's generator on ``device``, in one draw: the
    encoder U(+-1/sqrt(filter_len)), the decoder U(+-1/sqrt(n_filters)),
    linear layers U(+-1/sqrt(n_in)), the BLSTMs as torch.nn.LSTM (one bias
    per direction), the norms' scale and shift around identity, PReLU 0.25."""
    N, L, C = model["n_filters"], model["filter_len"], model["channels"]
    Hr, S = model["rnn_hidden"], model["num_spk"]

    def linear(name, n_in, n_out):
        k = n_in ** -0.5
        return [(f"{name}.w", (n_in, n_out), -k, k), (f"{name}.b", (n_out,), -k, k)]

    def norm(name, dim):
        return [(f"{name}.g", (dim,), 0.9, 1.1), (f"{name}.b", (dim,), -0.05, 0.05)]

    specs = [("enc", (L, N), -L ** -0.5, L ** -0.5), ("dec", (N, L), -N ** -0.5, N ** -0.5),
             ("head_prelu", (C,), 0.25, 0.25), *norm("in_ln", N),
             *linear("bottleneck", N, C), *linear("head", C, N * S)]
    for b in range(model["blocks"]):
        for path in ("intra", "inter"):
            specs += blstm_specs(f"blocks.{b}.{path}_rnn.", C, Hr, 1)
            specs += linear(f"blocks.{b}.{path}_proj", 2 * Hr, C)
            specs += norm(f"blocks.{b}.{path}_ln", C)
    return draw(specs, generator, device)


def latent_frames(model: dict, n_samples: int) -> int:
    return (n_samples - model["filter_len"]) // model["stride"] + 1


def num_chunks(model: dict, n_t: int) -> int:
    """Chunks of K = 2P latent frames, hop P, over P zeros in front, the
    frames, and zeros behind to a whole hop plus P."""
    P = model["chunk"] // 2
    return (P + n_t + (-(P + n_t) % P) + P) // P - 1


def gln(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Global layer norm: one mean and variance per utterance over its true
    positions (``mask``, broadcast over the channels) and all channels."""
    axes = tuple(range(1, x.dim()))
    cnt = torch.clamp_min(mask.sum(dim=axes, keepdim=True) * x.shape[-1] / mask.shape[-1], 1.0)
    mu = (x * mask).sum(dim=axes, keepdim=True) / cnt
    var = (((x - mu) * mask) ** 2).sum(dim=axes, keepdim=True) / cnt
    return (x - mu) * torch.rsqrt(var + 1e-6) * g + b


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(R, T, n) frames, frame t at t * hop -> (R, n + hop * (T - 1))."""
    R, T, n = frames.shape
    pos = (torch.arange(T, device=frames.device)[:, None] * hop
           + torch.arange(n, device=frames.device)[None, :]).reshape(-1)
    out = frames.new_zeros((R, n + hop * (T - 1)))
    return out.index_add(1, pos, frames.reshape(R, -1))


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
    h = (dot(gln(w, p["in_ln.g"], p["in_ln.b"], tmask), p["bottleneck.w"], q)
         + p["bottleneck.b"]) * tmask
    C = num_chunks(model, n_t)
    back = (-(P + n_t) % P) + P
    rows = F.pad(h, (0, 0, P, back)).reshape(B, -1, P, h.shape[-1])
    h = torch.cat([rows[:, :-1], rows[:, 1:]], dim=2)                      # (B, C, K, H)
    starts = torch.arange(C, device=wav.device) * P - P
    clens = torch.clamp(vt[:, None] - starts[None, :], 0, K)               # (B, C)
    cmask = (torch.arange(K, device=wav.device)[None, None, :] < clens[..., None]).float()[..., None]
    n_chunks = torch.clamp_min(torch.div(vt + P - 1, P, rounding_mode="floor") + 1, 1)
    klens = clens.reshape(-1)
    ilens = n_chunks[:, None].expand(B, K).reshape(-1)
    Hc = h.shape[-1]
    for b in range(model["blocks"]):
        pre = f"blocks.{b}."
        y = blstm_layer(h.reshape(B * C, K, Hc), klens, p, pre + "intra_rnn.", 0, q)
        y = (dot(y, p[pre + "intra_proj.w"], q) + p[pre + "intra_proj.b"]).reshape(B, C, K, Hc)
        h = (h + gln(y, p[pre + "intra_ln.g"], p[pre + "intra_ln.b"], cmask)) * cmask
        y = blstm_layer(h.transpose(1, 2).reshape(B * K, C, Hc), ilens, p, pre + "inter_rnn.", 0, q)
        y = (dot(y, p[pre + "inter_proj.w"], q) + p[pre + "inter_proj.b"])
        y = y.reshape(B, K, C, Hc).transpose(1, 2)
        h = (h + gln(y, p[pre + "inter_ln.g"], p[pre + "inter_ln.b"], cmask)) * cmask
    act = torch.where(h >= 0, h, h * p["head_prelu"])
    out = (dot(act, p["head.w"], q) + p["head.b"]) * cmask                  # (B, C, K, S*N)
    merged = F.pad(out[:, :, :P], (0, 0, 0, 0, 0, 1)) + F.pad(out[:, :, P:], (0, 0, 0, 0, 1, 0))
    merged = merged.reshape(B, (C + 1) * P, -1)[:, P: P + n_t] * 0.5
    m = torch.relu(merged.reshape(B, n_t, S, Nf)) * tmask[:, :, None, :]
    masked = (w[:, :, None, :] * m).permute(0, 2, 1, 3).reshape(B * S, n_t, Nf)
    y = overlap_add(dot(masked, p["dec"], q), stride)
    y = F.pad(y, (0, max(0, Ls - y.shape[-1])))[:, :Ls]
    return y.reshape(B, S, Ls)


def neg_si_snr(est: torch.Tensor, ref: torch.Tensor, smask: torch.Tensor) -> torch.Tensor:
    """(B, S_est, S_ref) negative SI-SNR in dB over each row's true samples,
    both signals zero-meaned there; eps 1e-8 guards."""
    sm = smask[:, None, :]
    cnt = torch.clamp_min(smask.sum(dim=-1), 1.0)[:, None, None]
    est = (est - (est * sm).sum(-1, keepdim=True) / cnt) * sm
    ref = (ref - (ref * sm).sum(-1, keepdim=True) / cnt) * sm
    d = torch.einsum("bil,bjl->bij", est, ref)
    ref_pow = (ref ** 2).sum(-1)
    est_pow = (est ** 2).sum(-1)
    s_t = d ** 2 / (ref_pow[:, None, :] + 1e-8)
    e_n = torch.clamp_min(est_pow[:, :, None] - s_t, 0.0)
    return -10.0 * torch.log10((s_t + 1e-8) / (e_n + 1e-8))


def pit_per_perm(est: torch.Tensor, src: torch.Tensor, n: torch.Tensor, S: int) -> torch.Tensor:
    """(B, S!) each row's negative SI-SNR summed over its speakers, under
    each speaker order, of (B, S, L) estimates against the sources over the
    rows' true samples ``n``."""
    smask = (torch.arange(est.shape[-1], device=est.device)[None, :] < n[:, None]).float()
    pair = neg_si_snr(est * smask[:, None, :], src, smask)
    return torch.stack([sum(pair[:, i, perm[i]] for i in range(S))
                        for perm in itertools.permutations(range(S))], dim=1)


def loss(p: dict, model: dict, batch: dict, q, per_perm_out: list | None = None) -> list:
    """PIT negative SI-SNR of a waveform batch (``mix_wav`` (B, L),
    ``source_wavs`` (B, S, L), ``sample_lengths``): the least over speaker
    orders per row, summed, over S and the number of rows; in blocks of
    ROW_BLOCK rows, whose partial losses sum to it. ``per_perm_out``
    collects each row's loss under each speaker order."""
    mix, src, n = batch["mix_wav"], batch["source_wavs"], batch["sample_lengths"]
    B = mix.shape[0]
    S = model["num_spk"]
    parts = []
    for r in range(0, B, ROW_BLOCK):
        rows = slice(r, r + ROW_BLOCK)
        est = separate(p, model, mix[rows], n[rows], q)
        per_perm = pit_per_perm(est, src[rows], n[rows], S)
        if per_perm_out is not None:
            per_perm_out.append(per_perm.detach())
        parts.append(per_perm.min(dim=1).values.sum() / S / B)
    return parts


def output_grads(est: torch.Tensor, model: dict, batch: dict) -> torch.Tensor:
    """The gradient of the batch's PIT loss (as ``loss`` takes it: each
    row's least order, over S and the number of rows) with respect to the
    (B, S, L) estimates: every row's share of the loss, as the backward
    receives it from the loss."""
    est = est.detach().float().requires_grad_(True)
    per_perm = pit_per_perm(est, batch["source_wavs"], batch["sample_lengths"],
                            model["num_spk"])
    total = per_perm.min(dim=1).values.sum() / model["num_spk"] / est.shape[0]
    return torch.autograd.grad(total, est)[0]


def outputs(p: dict, model: dict, batch: dict, q) -> torch.Tensor:
    """The training forward's estimated sources, (B, S, L), in blocks of
    ROW_BLOCK rows."""
    mix, n = batch["mix_wav"], batch["sample_lengths"]
    return torch.cat([separate(p, model, mix[r: r + ROW_BLOCK], n[r: r + ROW_BLOCK], q)
                      for r in range(0, mix.shape[0], ROW_BLOCK)])


def forward_flops(model: dict, n_samples: int) -> float:
    """Product operations of one utterance's forward at ``n_samples``: the
    encoder, the bottleneck, per block and chunk position the input
    projection and recurrence of both directions and the projection back,
    for both paths, the head over the chunk positions, and the decoder of
    each source. Norms, masks and the loss are not products."""
    N, Lf, Cc = model["n_filters"], model["filter_len"], model["channels"]
    Hr, S = model["rnn_hidden"], model["num_spk"]
    n_t = latent_frames(model, n_samples)
    positions = num_chunks(model, n_t) * model["chunk"]
    rnn = 2 * (2 * Cc * 4 * Hr) + 2 * (2 * Hr * 4 * Hr) + 2 * (2 * Hr) * Cc
    per_frame = 2 * Lf * N + 2 * N * Cc + S * 2 * N * Lf
    return n_t * per_frame + positions * (model["blocks"] * 2 * rnn + 2 * Cc * N * S)


def train_flops(model: dict, sample_lengths) -> float:
    """Forward and backward (three forwards) of every row; the rows are
    whole segments, so each counts at its own length."""
    return 3.0 * sum(forward_flops(model, int(n)) for n in sample_lengths)


def lstm_launches(model: dict, n_samples: int, sample_lengths) -> list:
    """The recurrences one pass over a batch runs, in order: per block the
    intra-chunk (T = chunk, rows = B * chunks, each chunk's true frames) and
    the inter-chunk one (T = chunks, rows = B * chunk, each row's chunks)."""
    K, P, stride = model["chunk"], model["chunk"] // 2, model["stride"]
    n_t = latent_frames(model, n_samples)
    C = num_chunks(model, n_t)
    klens, ilens = [], []
    for n in sample_lengths:
        vt = min(max(-(-int(n) // stride), 1), n_t)
        klens += [min(max(vt - (c * P - P), 0), K) for c in range(C)]
        ilens += [max(-(-vt // P) + 1, 1)] * K
    H = model["rnn_hidden"]
    return [(K, len(klens), H, klens), (C, len(ilens), H, ilens)] * model["blocks"]
