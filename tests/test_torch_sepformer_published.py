"""The port's SepFormer in its published structure (``published``,
``layers``: models/sepformer.py) against the benchmark's plain reference
(port_bench/reference/sepformer.py) on the CPU at a small size, with the
reference's weights loaded into the port; the defaults' compact structure;
the reference's operation and launch counts and the K5 readers' bounds; the
cell ``sepformer-train-b16`` run through the benchmark's runner at a tiny
size; the path spans; and the ``train`` CLI on the published keys.

Tolerances, float32: the two sides do the same float32 arithmetic summed in
another order, so outputs, loss and every leaf's gradient agree within 1e-5
relative (read: 2e-7, 7e-8 and 2e-6). bf16: the port stores the trunk's
activations in bf16 where the reference keeps float32 between its
bf16-rounded products, which moves the worst row's output 0.8-1.6e-2 at
this size; the limit 4e-2 leaves room above that, and the reference with
fp8 products in the port's place reads 0.12-0.15, so it fails the limit.
"""

import math
import os
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from port_bench.harness import core
from port_bench.harness.runner import run_cell
from port_bench.reference import sepformer as ref
from port_bench.reference.common import rounding
from speech_separation_tpu_torch.cli.main import main
from speech_separation_tpu_torch.datadir.prepare import prepare_data_dir
from speech_separation_tpu_torch.datadir.registry import DatasetRegistry
from speech_separation_tpu_torch.models import sepformer as tsf
from speech_separation_tpu_torch.models.registry import get_arch
from speech_separation_tpu_torch.train.loop import Optimizer, TrainLoopConfig, update_step
from speech_separation_tpu_torch.utils import spans
from speech_separation_tpu_torch.utils.audio import load_wav
from speech_separation_tpu_torch.utils.synthetic import make_synthetic_corpus, write_id_list

torch.set_num_threads(1)  # six xdist workers share the cores: one thread each, for life

SMALL = dict(num_spk=2, n_filters=16, filter_len=16, stride=8, channels=16, heads=2, d_ff=32,
             chunk=8, blocks=2, published=True, layers=2, mask_act="relu")
LENGTHS = (480, 333, 200, 17)
BF16_OUT_LIMIT = 4e-2
PUBLISHED = core.config_spec("sepformer-subakan2021")["model"]


def model_spec(dtype: str = "float32", fused: bool = True) -> dict:
    return {**SMALL, "compute_dtype": dtype, "fused_attention": fused}


def port_and_params(spec: dict, seed: int = 3):
    """The port's model holding the reference's leaves drawn from ``seed``."""
    params = ref.init_params(spec, torch.Generator().manual_seed(seed), "cpu")
    model = tsf.SepFormer(tsf.Config.from_kwargs(**{k: str(v) for k, v in spec.items()}))
    model.load_state_dict(params)
    return model, params


def wave_batch(seed: int = 2, lengths=LENGTHS, L: int = 480) -> dict:
    g = torch.Generator().manual_seed(seed)
    src = 0.1 * torch.randn((len(lengths), 2, L), generator=g)
    n = torch.tensor(lengths, dtype=torch.int32)
    src = src * (torch.arange(L)[None, :] < n[:, None]).float()[:, None, :]
    return {"mix_wav": src.sum(dim=1), "source_wavs": src, "sample_lengths": n,
            "row_mask": torch.ones(len(lengths))}


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def worst_row(got: torch.Tensor, want: torch.Tensor) -> float:
    d = (got - want).flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1).clamp_min(1e-30)
    return float(d.max())


@pytest.mark.parametrize("fused", [False, True])
def test_float32_outputs_loss_and_every_gradient_match_the_reference(fused):
    spec = model_spec("float32", fused)
    model, params = port_and_params(spec)
    batch = wave_batch()
    q = rounding("float32")
    est = tsf.separate(model, batch["mix_wav"], batch["sample_lengths"])
    assert rel(est, ref.outputs(params, spec, batch, q)) < 1e-5

    live = {n: p.clone().requires_grad_(True) for n, p in params.items()}
    want = sum(ref.loss(live, spec, batch, q))
    want_grads = torch.autograd.grad(want, list(live.values()))
    loss, _ = tsf.loss_fn(model, batch, None, True)
    loss.backward()
    assert abs(loss.item() - want.item()) <= 1e-5 * abs(want.item())
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(live)
    for (name, _), g in zip(live.items(), want_grads):
        assert rel(got[name].grad, g) < 1e-5, name


def test_reference_loss_fills_per_perm_out_without_being_iterated(monkeypatch):
    """With ``per_perm_out`` (readings.py's diagnosis) the reference computes
    every block at once; without it the blocks come one at a time."""
    monkeypatch.setattr(ref, "ROW_BLOCK", 3)
    spec = model_spec()
    _, params = port_and_params(spec)
    batch = wave_batch()
    q = rounding("float32")
    per = []
    with torch.no_grad():
        parts = ref.loss(params, spec, batch, q, per)
    per = torch.cat(per)
    assert len(parts) == 2 and per.shape == (len(LENGTHS), 2)
    lazy = ref.loss(params, spec, batch, q)
    assert not isinstance(lazy, list)
    with torch.no_grad():
        want = sum(lazy)
    assert math.isclose(float(sum(parts)), float(want), rel_tol=1e-6)
    assert math.isclose(float(per.min(dim=1).values.sum() / 2 / len(LENGTHS)), float(want),
                        rel_tol=1e-6)


@pytest.mark.parametrize("fused", [False, True])
def test_bf16_outputs_match_the_reference_and_fp8_products_do_not(fused):
    spec = model_spec("bfloat16", fused)
    model, params = port_and_params(spec)
    batch = wave_batch()
    est = tsf.separate(model, batch["mix_wav"], batch["sample_lengths"])
    assert worst_row(est, ref.outputs(params, spec, batch, rounding("bfloat16"))) < BF16_OUT_LIMIT
    assert worst_row(est, ref.outputs(params, spec, batch, rounding("fp8"))) > BF16_OUT_LIMIT


def test_padding_invariance():
    """An utterance's separated samples do not depend on the batch and time
    padding it shares a batch with."""
    model, _ = port_and_params(model_spec())
    sig = 0.1 * torch.randn(300, generator=torch.Generator().manual_seed(1))
    one = tsf.separate(model, torch.nn.functional.pad(sig, (0, 84))[None],
                       torch.tensor([300], dtype=torch.int32))
    big = torch.zeros((3, 768))
    big[1, :300] = sig
    three = tsf.separate(model, big, torch.tensor([17, 300, 1], dtype=torch.int32))
    torch.testing.assert_close(three[1, :, :300], one[0, :, :300], atol=2e-5, rtol=1e-4)


def test_separate_is_the_training_forward():
    model, _ = port_and_params(model_spec())
    batch = wave_batch()
    served = tsf.separate(model, batch["mix_wav"], batch["sample_lengths"])
    trained = model(batch["mix_wav"], batch["sample_lengths"])
    assert trained.requires_grad and torch.equal(served, trained.detach())


def test_defaults_keep_the_compact_structure():
    """With the new keys at their defaults a path is its one layer's leaves
    (the JAX package's names) and nothing is added; spelling the defaults
    out computes the same bits; ``published`` nests the layers and adds the
    path norms and the gate; more than one layer a path needs it."""
    tiny = {k: v for k, v in SMALL.items() if k not in ("layers", "published")}
    torch.manual_seed(0)
    plain = tsf.SepFormer(tsf.Config(**tiny))
    keys = {f"blocks.{b}.{p}.{leaf}.{x}" for b in range(2) for p in ("intra", "inter")
            for leaf, xs in (("ln1", "gb"), ("qkv", "wb"), ("out", "wb"), ("ln2", "gb"),
                             ("ff1", "wb"), ("ff2", "wb")) for x in xs}
    keys |= {"enc", "dec", "head_prelu", "in_ln.g", "in_ln.b", "bottleneck.w", "bottleneck.b",
             "head.w", "head.b"}
    assert set(plain.state_dict()) == keys
    spelled = tsf.SepFormer(tsf.Config(**tiny, published=False, layers=1))
    spelled.load_state_dict(plain.state_dict())
    batch = wave_batch()
    assert torch.equal(plain(batch["mix_wav"], batch["sample_lengths"]),
                       spelled(batch["mix_wav"], batch["sample_lengths"]))
    sd = tsf.SepFormer(tsf.Config(**tiny, published=True)).state_dict()
    assert {"blocks.0.intra.layers.0.qkv.w", "blocks.1.inter.ln.g", "blocks.1.inter.gln.g",
            "gate_tanh.w", "gate_sigmoid.b", "gate_end"} <= set(sd)
    assert not set(sd) & keys - {"enc", "dec", "head_prelu", "in_ln.g", "in_ln.b",
                                 "bottleneck.w", "bottleneck.b", "head.w", "head.b"}
    for bad in (dict(layers=0), dict(layers=2), dict(published=True, layers=0)):
        with pytest.raises(ValueError):
            tsf.Config(**bad)


def test_published_config_parses_and_holds_the_papers_parameter_count():
    cfg = get_arch("SepFormer").Config.from_kwargs(**{k: str(v) for k, v in PUBLISHED.items()})
    assert (cfg.published, cfg.layers, cfg.fused_attention) == (True, 8, True)
    assert (cfg.channels, cfg.heads, cfg.d_ff, cfg.chunk, cfg.blocks) == (256, 8, 1024, 250, 2)
    with torch.device("meta"):
        model = tsf.SepFormer(cfg)
    # 32 layers of 789,760 and 2 x 4 path norms of 512, the encoder side,
    # head and gate 403,456: "about 26 M" in the paper
    layer = 256 * 768 + 768 + 256 * 256 + 256 + 256 * 1024 + 1024 + 1024 * 256 + 256 + 4 * 256
    assert layer == 789_760
    assert sum(p.numel() for p in model.parameters()) == 32 * layer + 8 * 512 + 403_456


def test_operation_and_attention_counts_by_hand():
    B, n = 16, 32000
    # 3,999 latent frames, 33 chunks of 250 at hop 125
    launches = ref.attention_launches(PUBLISHED, n, [n] * B)
    assert launches == ([(B * 33 * 8, 250, 32)] * 8 + [(B * 250 * 8, 33, 32)] * 8) * 2
    assert ref.attention_launches({**PUBLISHED, "fused_attention": False}, n, [n] * B) == []
    assert ref.lstm_launches(PUBLISHED, n, [n] * B) == []
    dense = 2 * 256 * 768 + 2 * 256 * 256 + 2 * 2 * 256 * 1024         # qkv, out, ff1, ff2
    attn = 4 * 250 * 256 + 4 * 33 * 256                                 # QK^T and AV, both paths
    trunk = 33 * 250 * (2 * 8 * (2 * dense + attn) + 2 * 256 * 512)    # blocks, layers, head
    frames = 3999 * (2 * 16 * 256 + 2 * 256 * 256 + 2 * (3 * 2 * 256 * 256 + 2 * 256 * 16))
    assert ref.forward_flops(PUBLISHED, n) == trunk + frames
    assert ref.train_flops(PUBLISHED, [n] * B) == 3 * B * (trunk + frames)
    assert 7.2e12 < B * (trunk + frames) < 7.4e12


@pytest.mark.parametrize("name,N,T,want_ms", [
    ("k5_fwd_roofline", 10624, 100, 0.0419),
    ("k5_bwd_roofline", 10624, 100, 0.0723),
    ("k5_fwd_roofline", 400, 1230, 0.1447),
    ("k5_bwd_roofline", 400, 1230, 0.1447),
])
def test_k5_bounds_match_the_kernel_table(name, N, T, want_ms):
    """The readers' bounds at the shapes of the port's kernel table (dh=16,
    bf16): bytes at T=100, the exp a pair at T=1230."""
    reader = core.metric_reader(name)
    fwd = core.metric_reader("k5_fwd_roofline")
    nbytes, flops = reader.bytes_and_flops(N, T, 16, 2)
    assert round(1e3 * fwd.bound_s(nbytes, flops, N * T * T, "bfloat16"), 4) == want_ms


def fake_run(lengths: list, n_kernels: int, name: str = "sepattn::attn_fwd_rows<32, 16, false>"):
    """A traced run's records and trace, as the K5 readers read them."""
    kernels = [(name, "kernel", 1.0 + i, 1.0 + i + 1e-4, i) for i in range(n_kernels)]
    trace = types.SimpleNamespace(kernels=lambda match: [(n, s, e, c) for n, _, s, e, c in kernels
                                                         if match(n)])
    return types.SimpleNamespace(
        records={"train": {"steps": len(lengths), "T": 32000, "lengths": lengths}},
        trace_data=trace, reference=ref, config={"model": PUBLISHED, "precision": "bfloat16"})


def test_k5_reader_reads_only_the_configurations_count_of_launches():
    reader = core.metric_reader("k5_fwd_roofline")
    steps = [[32000] * 16] * 3
    per_step = len(ref.attention_launches(PUBLISHED, 32000, steps[0]))
    share = reader.read(fake_run(steps, 3 * per_step))
    bound = sum(reader.bound_s(*reader.bytes_and_flops(N, T, dh, 2), N * T * T, "bfloat16")
                for N, T, dh in ref.attention_launches(PUBLISHED, 32000, steps[0])) * 3
    assert math.isclose(share, 100 * bound / (3 * per_step * 1e-4), rel_tol=1e-6)
    assert reader.read(fake_run(steps, 3 * per_step - 1)) is None
    assert core.metric_reader("k5_bwd_roofline").read(fake_run(steps, 3 * per_step)) is None


def test_cell_runs_correct_through_the_benchmarks_runner(monkeypatch):
    """``sepformer-train-b16`` at a tiny size and in float32 on the CPU, as
    run.py runs it (its look for a card aside): every compared number under
    1e-5. This test process holds JAX (tests/conftest.py), which the
    runner refuses for a benchmark run."""
    monkeypatch.setattr(core, "forbidden_modules", lambda: [])
    small = {k: v for k, v in SMALL.items() if k in ("n_filters", "channels", "heads", "d_ff",
                                                      "chunk", "layers")}
    res, run = run_cell("sepformer-train-b16", 2 ** 31 + 12345, 0.2, False, "cpu", 0.0,
                        overrides={"model": {**small, "compute_dtype": "float32"},
                                   "traffic": {"batch": 3, "seconds": 0.05},
                                   "precision": "float32"})
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert set(run.checks) == set(run.cell["checks"])
    assert all(v < 1e-5 for v, _ in run.checks.values()), run.checks
    assert res["metrics"]["train_audio_s_per_s"]["value"] > 0


def test_a_step_records_the_path_spans_inside_the_forward():
    arch = get_arch("SepFormer")
    model, _ = port_and_params(model_spec())
    opt = Optimizer(model.parameters(), TrainLoopConfig(arch="SepFormer", batch_size=4))
    spans.clear()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        update_step(arch, model, opt, wave_batch(), torch.Generator().manual_seed(0))
    finally:
        prof.stop()
    recs = spans.recorded()
    spans.clear()
    forward = [s for s in recs if s.name == "train.forward"]
    assert len(forward) == 1
    for name in ("sepformer.intra", "sepformer.inter"):
        mine = [s for s in recs if s.name == name]
        assert len(mine) == SMALL["blocks"], name
        assert all(s.parent == "train.forward" and forward[0].start_ns <= s.start_ns
                   and s.end_ns <= forward[0].end_ns for s in mine), name


def test_train_cli_with_the_published_keys_then_separate(tmp_path):
    ids = make_synthetic_corpus(str(tmp_path / "corpus"), 4, min_sec=0.3, max_sec=0.5, seed=0,
                                prefix="tr")
    write_id_list(str(tmp_path / "id_lists"), "toy", ids)
    data_dir = prepare_data_dir("toy", DatasetRegistry({"toy": str(tmp_path / "corpus")}),
                                data_root=str(tmp_path / "data"),
                                id_lists_dir=str(tmp_path / "id_lists"))
    conf = tmp_path / "model.conf"
    keys = {**SMALL, "chunk": 32, "blocks": 1, "published": 1, "fused_attention": 1}
    conf.write_text("".join(f"{k}={v}\n" for k, v in keys.items()))
    exp = str(tmp_path / "exp")
    main(["train", "SepFormer", data_dir, exp, "--on-device-features", "--model-config",
          str(conf), "--num-epochs", "2", "--batch-size", "4", "--device", "cpu", "--seed", "2"])
    with open(os.path.join(exp, "train_stats", "train_loss.txt")) as f:
        assert len([float(ln.split()[1]) for ln in f]) == 2
    state = torch.load(os.path.join(exp, "final.mdl"), map_location="cpu")
    assert "blocks.0.inter.layers.1.ff2.w" in state and "gate_end" in state
    wav = os.path.join(tmp_path, "corpus", "mix", f"{ids[0]}.wav")
    main(["separate", os.path.join(exp, "final.mdl"), str(tmp_path / "out"), wav,
          "--device", "cpu"])
    x, _ = load_wav(wav)
    y, _ = load_wav(os.path.join(tmp_path, "out", f"{ids[0]}_s1.wav"))
    assert len(y) == len(x) and np.all(np.isfinite(y))
