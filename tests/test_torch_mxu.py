"""ops/mxu.py on the CPU: the products of bf16-rounded operands with float32
sums (speech_separation_tpu_torch/ops/mxu.py).

On the CPU every call site keeps the plain product, the operands rounded to
the compute dtype and multiplied in float32, bit for bit as the code before
``rounded_dot`` computed it: the mask head (``rounded_dot``), the
column-parallel head (``column_dot``), the linear layers of TCN, Conv-TasNet,
SepFormer and DPRNN (``layers.dot``), the BLSTM's direction-batched input
projection and the recurrence's dW_hh. Those old expressions are written out
here as the references. SepFormer's transformer layers take ``any_order_dot``,
which on the CPU is that same plain product.

The card's path (``_RoundedDot`` on ``mxu_dot``) runs here too where a test
lets the CPU stand in for the card (``as_card``): ``mxu_dot`` then forms each
product in float32 from the same operands through torch.mm / torch.bmm,
which is what the tensor cores compute up to the order of the sum. Tolerances, set from the dtypes: float32
results within 1e-5 relative (one f32 sum in another order); results rounded
to bf16 at most one bf16 step (2**-7 relative) apart; a training step
through it against the plain step: loss within 1e-4 relative, each gradient
within 2e-2 relative L2 (a bf16 rounding that falls the other way moves what
follows by about one bf16 step).
"""

import pytest
import torch

from speech_separation_tpu_torch.models import blstm, dprnn, layers, sepformer, tcn, upit
from speech_separation_tpu_torch.ops import lstm_kernel, mxu
from speech_separation_tpu_torch.parallel.ranks import copy_to_model

torch.set_num_threads(1)  # six xdist workers share the cores: one thread each, for life

BF16 = torch.bfloat16
F32 = torch.float32


def _rand(*shape, seed=0, dtype=F32, requires_grad=True):
    g = torch.Generator().manual_seed(seed)
    t = torch.randn(shape, generator=g).to(dtype)
    return t.requires_grad_(requires_grad)


def _grads(fn, *leaves, seed=7):
    """fn(*leaves) and each leaf's gradient under one fixed cotangent."""
    for t in leaves:
        t.grad = None
    y = fn(*leaves)
    g = torch.Generator().manual_seed(seed)
    y.backward(torch.randn(y.shape, generator=g).to(y.dtype))
    return y.detach(), [t.grad for t in leaves]


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


def _fake_cublas(orig):
    """torch.mm / torch.bmm as the card's cuBLAS takes them: with
    ``out_dtype`` (CUDA only in torch) the product of the operands in
    float32, the result in out_dtype."""
    def fn(a, b, out_dtype=None):
        if out_dtype is None:
            return orig(a, b)
        return orig(a.float(), b.float()).to(out_dtype)
    return fn


@pytest.fixture
def as_card(monkeypatch):
    """The CPU standing in for the card: rounded_dot and dW_hh take the
    tensor-core case there in bf16, and ops/mxu.py's own product
    (``_matmul``: the pieces of a long sum, the flag around a bf16 result)
    runs on torch.mm / torch.bmm given cuBLAS's ``out_dtype``; the counters
    start from 0."""
    monkeypatch.setattr(mxu, "tensor_cores",
                        lambda device, dtype: device.type in ("cuda", "cpu") and dtype == BF16)
    monkeypatch.setattr(torch, "mm", _fake_cublas(torch.mm))
    monkeypatch.setattr(torch, "bmm", _fake_cublas(torch.bmm))
    monkeypatch.setattr(mxu.mxu_dot, "tensor_core", 0)
    monkeypatch.setattr(mxu.mxu_dot, "f32", 0)
    monkeypatch.setattr(mxu.mxu_dot, "any_order", 0)


# ------------------------------------------------- the plain path, bit for bit

@pytest.mark.parametrize("x_dtype", [F32, BF16])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_head_dot_on_the_cpu_is_the_plain_product(x_dtype, dtype):
    y, w = _rand(3, 5, 12, dtype=x_dtype), _rand(10, 12, seed=1)
    got = _grads(lambda a, b: mxu.rounded_dot(a, b.t(), dtype), y, w)
    ref = _grads(lambda a, b: torch.matmul(a.to(dtype).float(), b.t().to(dtype).float()), y, w)
    _same(got[0], ref[0])
    for a, b in zip(got[1], ref[1]):
        _same(a, b)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_column_dot_on_the_cpu_is_the_plain_product(dtype):
    y, w = _rand(4, 7, 16), _rand(16, 6, seed=1)
    got = _grads(lambda a, b: mxu.column_dot(a, b, dtype), y, w)
    ref = _grads(lambda a, b: torch.matmul(copy_to_model(a.to(dtype).float()),
                                           b.to(dtype).float()), y, w)
    _same(got[0], ref[0])
    for a, b in zip(got[1], ref[1]):
        _same(a, b)


@pytest.mark.parametrize("out_dtype", [None, F32, BF16])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_linear_dot_on_the_cpu_is_the_plain_product(dtype, out_dtype):
    x, w, b = _rand(2, 9, 16), _rand(16, 8, seed=1), _rand(8, seed=2)

    def old(x, w, b):
        y = torch.matmul(x.to(dtype).float(), w.to(dtype).float()) + b
        return y if out_dtype is None else y.to(out_dtype)
    got = _grads(lambda x, w, b: layers.dot(x, {"w": w, "b": b}, dtype, out_dtype), x, w, b)
    ref = _grads(old, x, w, b)
    _same(got[0], ref[0])
    for a, c in zip(got[1], ref[1]):
        _same(a, c)


@pytest.mark.parametrize("gates", [False, True])
def test_blstm_projection_on_the_cpu_is_the_plain_product(gates):
    """The BLSTM's bf16 projection (models/blstm.py) against its old
    expression: the stacked input and weights cast to float32, one
    broadcast matmul, then the rounding."""
    out_c = _rand(3, 5, 9, dtype=BF16)
    wf, wb = _rand(24, 9, seed=1), _rand(24, 9, seed=2)

    def new(x, wf, wb):
        x_pair = torch.stack([x, torch.flip(x, dims=(1,))])
        if gates:
            x_pair = copy_to_model(x_pair.float())
        w_pair = torch.stack([wf.t(), wb.t()]).to(BF16)
        return mxu.held_dot(x_pair, w_pair[:, None], BF16, BF16)

    def old(x, wf, wb):
        x_pair = torch.stack([x, torch.flip(x, dims=(1,))]).float()
        if gates:
            x_pair = copy_to_model(x_pair)
        w_pair = torch.stack([wf.t(), wb.t()]).to(BF16).float()
        return torch.matmul(x_pair, w_pair[:, None]).to(BF16)
    got, ref = _grads(new, out_c, wf, wb), _grads(old, out_c, wf, wb)
    _same(got[0], ref[0])
    for a, b in zip(got[1], ref[1]):
        _same(a, b)


def _old_h_prev(ys, h0, lengths, suffix_dirs):
    """lstm_kernel._h_prev as it was: assembled in float32."""
    T = ys.shape[0]
    ys = ys.float()
    shift = torch.cat([torch.zeros_like(ys[:1]), ys[:-1]])
    dirs = []
    for d, suffix in enumerate(suffix_dirs):
        if suffix:
            zone = torch.arange(T)[:, None] <= (T - lengths)[None, :]
            dirs.append(torch.where(zone[:, :, None], h0[d][None], shift[:, d]))
        else:
            dirs.append(torch.cat([h0[d][None], ys[:-1, d]]))
    return torch.stack(dirs, dim=1)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_dw_hh_on_the_cpu_is_the_plain_product(dtype):
    T, D, B, H = 6, 2, 4, 5
    ys = _rand(T, D, B, H, dtype=dtype, requires_grad=False)
    dxw = _rand(T, D, B, 4 * H, seed=1, dtype=dtype, requires_grad=False)
    h0 = _rand(D, B, H, seed=2, requires_grad=False)
    lengths = torch.tensor([6, 3, 1, 0])
    got = lstm_kernel._dw_hh(ys, h0, lengths, (False, True), dxw, dtype)
    h_prev = _old_h_prev(ys, h0, lengths, (False, True)).to(dtype).float()
    _same(got, torch.einsum("tdbh,tdbg->dhg", h_prev, dxw.float()).to(dtype))


# ----------------------------------------------------------- the case rule

@pytest.mark.parametrize("device,dtype,want", [
    ("cuda", BF16, True), ("cuda", F32, False), ("cpu", BF16, False), ("cpu", F32, False)])
def test_tensor_cores_only_on_a_card_in_bf16(device, dtype, want):
    assert mxu.tensor_cores(torch.device(device), dtype) is want


@pytest.mark.parametrize("k,pieces", [(264, 1), (1200, 1), (2400, 2), (38400, 32),
                                      (259200, 216), (8 * 10007, 67)])
def test_long_sums_go_in_pieces_of_at_most_sum_terms(as_card, monkeypatch, k, pieces):
    """A contraction longer than SUM_TERMS (1,200) in the fewest equal pieces
    of at most that many terms, each a multiple of 8, K padded with zeros to
    a whole number of them; the pieces' float32 sums added, then rounded
    once. Operands of small integers, so every sum is exact."""
    shapes, bmm = [], torch.bmm
    monkeypatch.setattr(torch, "bmm", lambda a, b, out_dtype=None: (
        shapes.append((tuple(a.shape), tuple(b.shape))), bmm(a, b, out_dtype=out_dtype))[1])
    g = torch.Generator().manual_seed(k)
    a = torch.randint(-3, 4, (2, k), generator=g).to(BF16)
    b = torch.randint(-3, 4, (k, 3), generator=g).to(BF16)
    for out in (F32, BF16):
        shapes.clear()
        got = mxu.mxu_dot(a, b, out)
        assert got.dtype == out and torch.equal(got, (a.double() @ b.double()).to(out))
        if pieces == 1:
            assert shapes == []
        else:
            ((s, m, c), (s_, c_, n)), = shapes
            assert (s, s_, m, n, c_) == (pieces, pieces, 2, 3, c)
            assert c % 8 == 0 and c <= mxu.SUM_TERMS and s * c >= k > (s - 1) * c


def test_mxu_dot_takes_two_bf16_or_two_f32_operands():
    with pytest.raises(ValueError, match="two bf16 or two float32"):
        mxu.mxu_dot(torch.ones(2, 2, dtype=BF16), torch.ones(2, 2), F32)
    with pytest.raises(ValueError, match="two bf16 or two float32"):
        mxu.mxu_dot(torch.ones(2, 2, dtype=torch.float16), torch.ones(2, 2, dtype=torch.float16),
                    F32)


@pytest.mark.parametrize("card", [False, True])
@pytest.mark.parametrize("x_dtype,w_dtype", [(F32, F32), (BF16, F32), (BF16, BF16)])
def test_each_gradient_keeps_its_operands_dtype(request, card, x_dtype, w_dtype):
    if card:
        request.getfixturevalue("as_card")
    x, w, b = _rand(2, 3, 16, dtype=x_dtype), _rand(16, 8, seed=1, dtype=w_dtype), _rand(8)
    for out in (F32, BF16):
        _, (gx, gw, gb) = _grads(lambda x, w, b: mxu.rounded_dot(x, w, BF16, out, b), x, w, b)
        assert (gx.dtype, gw.dtype, gb.dtype) == (x_dtype, w_dtype, F32)


# ------------------------------------------- the card's path, on the CPU

def _close(got, ref, dtype):
    if dtype == BF16:
        step = ref.float().abs() * 2.0 ** -7
        assert bool(((got.float() - ref.float()).abs() <= step).all())
    else:
        assert float((got - ref).norm() / ref.norm().clamp_min(1e-30)) <= 1e-5


@pytest.mark.parametrize("case", ["f32_out", "bf16_out_bias", "batched_bf16_out", "k257",
                                  "any_order", "any_order_bias", "batched_any_order"])
def test_rounded_dot_function_matches_the_plain_product(as_card, case):
    """_RoundedDot (forward, both gradients, the bias's) against the plain
    product of the same rounded operands; the case's counts. rounded_dot's
    forward rounded to bf16 is the float32 product; any_order_dot's runs on
    the tensor cores, with the same backward."""
    B, K, N, out, bias, batched = 40, 16, 24, F32, False, False
    any_order = "any_order" in case
    if case in ("bf16_out_bias", "any_order_bias"):
        out, bias = BF16, True
    elif case in ("batched_bf16_out", "batched_any_order"):
        out, batched = BF16, True
    elif case == "k257":
        K, N, out = 257, 16, BF16
    elif case == "any_order":
        out = BF16
    dot = mxu.any_order_dot if any_order else mxu.rounded_dot
    x = _rand(2, 4, B // 4, K, dtype=BF16)
    w = _rand(*((2, 1, K, N) if batched else (K, N)), seed=1)
    b = _rand(N, seed=2) if bias else None
    leaves = (x, w) + ((b,) if bias else ())

    def run(*leaves):
        return dot(leaves[0], leaves[1], BF16, out, leaves[2] if bias else None)
    got = _grads(run, *leaves)
    want = (1, 2) if out == F32 else (3, 0) if any_order else (2, 1)
    assert (mxu.mxu_dot.tensor_core, mxu.mxu_dot.f32, mxu.mxu_dot.any_order) == \
        (*want, int(any_order))
    with pytest.MonkeyPatch.context() as m:
        m.setattr(mxu, "tensor_cores", lambda device, dtype: False)
        ref = _grads(run, *leaves)
    _close(got[0], ref[0], out)
    for a, c, leaf in zip(got[1], ref[1], leaves):
        _close(a, c, leaf.dtype)


def test_a_float32_holder_gets_the_unrounded_sum(as_card):
    """held_dot of a float32 tensor of bf16 values (the tensor-parallel
    paths, before their reduce over the model group): its gradient is the
    float32 sum, not rounded; rounded_dot of the same tensor rounds it."""
    x = _rand(30, 16, requires_grad=False).to(BF16).float().requires_grad_(True)
    w = _rand(16, 24, seed=1)
    _, (held, _) = _grads(lambda x, w: mxu.held_dot(x, w.to(BF16), BF16, BF16), x, w)
    _, (rounded, _) = _grads(lambda x, w: mxu.rounded_dot(x, w, BF16, BF16), x, w)
    assert held.dtype == rounded.dtype == F32
    g = torch.randn((30, 24), generator=torch.Generator().manual_seed(7)).to(BF16)
    _close(held, g.float() @ w.detach().to(BF16).float().t(), F32)
    assert not torch.equal(held, held.to(BF16).float())
    _close(rounded, held, BF16)
    assert torch.equal(rounded, rounded.to(BF16).float())


def _upit_step(cfg, seed=0):
    torch.manual_seed(seed)
    model = upit.Model(cfg)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    B, T, F = 3, 10, cfg.feat_dim
    mix = torch.rand((B, T, F), generator=g)
    src = torch.rand((B, cfg.num_spk, T, F), generator=g)
    batch = {"mix": mix, "sources": src, "lengths": torch.tensor([10, 7, 4], dtype=torch.int32),
             "row_mask": torch.ones(B)}
    loss, _ = upit.loss_fn(model, batch, torch.Generator().manual_seed(0), True)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters() if p.grad is not None}


def _step_close(got, ref):
    assert abs(float(got[0]) - float(ref[0])) <= 1e-4 * abs(float(ref[0]))
    assert got[1].keys() == ref[1].keys()
    for n in ref[1]:
        r = ref[1][n]
        assert float((got[1][n] - r).norm()) <= 2e-2 * max(float(r.norm()), 1e-30), n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_upit_step_counts_its_products_by_case(as_card, dtype):
    """A uPIT training step (2 layers) with the CPU standing in for the
    card: a float32 configuration never takes the tensor-core case (both
    counters stay at 0: its products are the plain ones); a bf16 one runs 6
    products on the tensor cores (the head, layer 2's projection dx and dW,
    layer 1's dW, two dW_hh) and 4 in float32 (the two projections, rounded
    to bf16 in the forward, and the head's gradients under the sigmoid's
    float32 cotangent), and gives the plain step's loss and gradients."""
    cfg = upit.Config(feat_dim=9, hidden=6, num_layers=2, zero_init_hidden=True,
                      compute_dtype=dtype)
    got = _upit_step(cfg)
    counts = (mxu.mxu_dot.tensor_core, mxu.mxu_dot.f32)
    assert counts == ((6, 4) if dtype == "bfloat16" else (0, 0))
    with pytest.MonkeyPatch.context() as m:
        m.setattr(mxu, "tensor_cores", lambda device, dtype: False)
        ref = _upit_step(cfg)
    _step_close(got, ref)


def test_dprnn_step_through_the_card_path_is_the_plain_step(as_card):
    """A bf16 DPRNN step (one block) with the CPU standing in for the card
    against the plain step: the same loss and gradients; its products'
    counts by case."""
    cfg = dprnn.Config(n_filters=8, filter_len=4, stride=2, channels=8, rnn_hidden=6,
                       chunk=8, blocks=1, compute_dtype="bfloat16")

    def step():
        model = dprnn.Model(cfg, torch.Generator().manual_seed(3))
        g = torch.Generator().manual_seed(4)
        L = 64
        src = 0.1 * torch.randn((2, 2, L), generator=g)
        lens = torch.tensor([64, 40], dtype=torch.int32)
        src = src * (torch.arange(L)[None, :] < lens[:, None])[:, None, :]
        batch = {"mix_wav": src.sum(1), "source_wavs": src, "sample_lengths": lens,
                 "row_mask": torch.ones(2)}
        loss, _ = dprnn.loss_fn(model, batch, None, True)
        loss.backward()
        return loss.detach(), {n: p.grad for n, p in model.named_parameters()
                               if p.grad is not None}
    got = step()
    # on the tensor cores: the forward's float32 results (encoder, head,
    # decoder), and in the backward the bottleneck's, the block's 4
    # products' dx and dW and its 2 dW_hh; in float32: the forward's results
    # rounded to bf16 (bottleneck, the block's 2 projections and 2 linear
    # layers), the encoder's dW, the head's and the decoder's dx and dW
    assert (mxu.mxu_dot.tensor_core, mxu.mxu_dot.f32) == (3 + 12, 5 + 5)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(mxu, "tensor_cores", lambda device, dtype: False)
        ref = step()
    _step_close(got, ref)


def test_sepformer_step_through_the_card_path_is_the_plain_step(as_card):
    """A bf16 published SepFormer step (one block of 2 intra and 2 inter
    layers, K5's plain versions) with the CPU standing in for the card
    against the plain step: the same loss and gradients; its products'
    counts by case."""
    layers_, blocks = 2, 1
    cfg = sepformer.Config(n_filters=8, filter_len=4, stride=2, channels=8, heads=2, d_ff=16,
                           chunk=8, blocks=blocks, published=True, layers=layers_,
                           compute_dtype="bfloat16", fused_attention=True)

    def step():
        model = sepformer.Model(cfg, torch.Generator().manual_seed(3))
        g = torch.Generator().manual_seed(4)
        L = 64
        src = 0.1 * torch.randn((2, 2, L), generator=g)
        lens = torch.tensor([64, 40], dtype=torch.int32)
        src = src * (torch.arange(L)[None, :] < lens[:, None])[:, None, :]
        batch = {"mix_wav": src.sum(1), "source_wavs": src, "sample_lengths": lens,
                 "row_mask": torch.ones(2)}
        loss, _ = sepformer.loss_fn(model, batch, None, True)
        loss.backward()
        return loss.detach(), {n: p.grad for n, p in model.named_parameters()
                               if p.grad is not None}
    got = step()
    # the transformer layers' 4 products a layer, each path's stack, each
    # block: any_order_dot's forward on the tensor cores, its dx and dW too;
    # on the tensor cores besides: the forward's float32 results (encoder,
    # head, the gate's three, decoder) and the bottleneck's dx and dW; in
    # float32: the bottleneck's forward (rounded to bf16, by rule), the
    # encoder's dW, and the head's, the gate's and the decoder's dx and dW
    n = 4 * layers_ * 2 * blocks
    assert (mxu.mxu_dot.tensor_core, mxu.mxu_dot.f32, mxu.mxu_dot.any_order) == \
        (6 + 2 + 3 * n, 1 + 11, n)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(mxu, "tensor_cores", lambda device, dtype: False)
        ref = step()
    _step_close(got, ref)


def test_blstm_uses_the_held_product():
    """models/blstm.py imports the product it projects with from ops/mxu."""
    assert blstm.held_dot is mxu.held_dot
