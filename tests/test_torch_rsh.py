"""The port's RSH (speech_separation_tpu_torch/models/rsh.py and the paths
that run it: the differentiable recurrence with a carried state, speaker-
count batching and the reference's mixed batches in train/, eval-masks, the
pipeline, the CLI recipe) against the JAX package on the CPU, with the same
weights (utils/weights.state_dict_from_jax) and the same numpy inputs.

Tolerances, as tests/test_torch_upit.py and tests/test_torch_train.py hold
uPIT: f32 losses rtol 1e-5 (the same f32 sums in another order); masks and
BN statistics atol 2e-5; gradients atol 1e-5 of the largest reference
gradient; the recurrence with bf16 saves 2e-2 of max(1, max |reference|) (a
value on the other side of a bf16 rounding boundary moves by one bf16 step,
~4e-3 relative, and the step carries it on), f32 2e-5; the mixed-batch
trajectory's first loss rtol 1e-5, later losses 2e-3 and the weights after
three Adam updates atol 5e-5 (a small part of one lr=1e-3 step), as
tests/test_torch_sepformer_train.py holds SepFormer's; eval-masks' masks
atol 1e-5 and separated waveforms atol 2e-4, as
tests/test_torch_eval_chain.py and tests/test_torch_pipeline.py hold uPIT's.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_separation_tpu.eval.infer import generate_masks as jax_generate_masks
from speech_separation_tpu.eval.pipeline import SeparationPipeline as JaxPipeline
from speech_separation_tpu.models import rsh as jrsh
from speech_separation_tpu.ops import lstm_pallas
from speech_separation_tpu.train import data as jdata
from speech_separation_tpu.train.checkpoint import save_checkpoint
from speech_separation_tpu.train.loop import TrainLoopConfig as JaxLoopConfig
from speech_separation_tpu.train.loop import train as jax_train
from speech_separation_tpu.utils.import_torch import state_dict_from_params
from speech_separation_tpu_torch.cli.main import build_parser, main
from speech_separation_tpu_torch.dsp.extract import extract_features
from speech_separation_tpu_torch.eval.infer import generate_masks, load_model
from speech_separation_tpu_torch.eval.pipeline import SeparationPipeline
from speech_separation_tpu_torch.models import rsh as trsh
from speech_separation_tpu_torch.models.registry import get_arch
from speech_separation_tpu_torch.ops.lstm_kernel import lstm_seq
from speech_separation_tpu_torch.train import data as tdata
from speech_separation_tpu_torch.train import loop
from speech_separation_tpu_torch.utils.synthetic import (make_synthetic_corpus_var,
                                                         write_id_list)
from speech_separation_tpu_torch.utils.weights import (fold_lstm_biases, infer_model_info,
                                                       state_dict_from_jax)

torch.set_num_threads(1)  # six xdist workers share the cores: one thread each, for life

F, H, L = 9, 6, 2
KW = {"hidden": "16", "num_layers": "1", "zero_init_hidden": "1"}


def quiet(*_):
    pass


def _jax_model(seed=0, head_bias=0.0):
    cfg = jrsh.Config(feat_dim=F, hidden=H, num_layers=L, zero_init_hidden=True)
    params, state = jrsh.init(jax.random.PRNGKey(seed), cfg)
    params = jax.tree_util.tree_map(np.asarray, params)
    params["lin"]["b"] = params["lin"]["b"] + np.float32(head_bias)
    state = jax.tree_util.tree_map(np.asarray, state)
    # non-trivial BN statistics, so eval mode and the update are really tested
    rng = np.random.default_rng(seed)
    state["bn"]["mean"] = (0.1 * rng.standard_normal(2 * H)).astype(np.float32)
    state["bn"]["var"] = (0.5 + rng.random(2 * H)).astype(np.float32)
    return cfg, params, state


def _port_model(params, state):
    model = trsh.RSH(trsh.Config(feat_dim=F, hidden=H, num_layers=L, zero_init_hidden=True))
    model.load_state_dict(state_dict_from_jax(params, state))
    fold_lstm_biases(model.blstm)
    return model


def _batch(S, seed=0, B=4, T=12, lengths=(12, 9, 3, 0)):
    """A ragged batch; the last row a dummy (row_mask 0, length 0)."""
    rng = np.random.default_rng(seed)
    mix = np.abs(rng.standard_normal((B, T, F))).astype(np.float32)
    sources = np.abs(rng.standard_normal((B, S, T, F))).astype(np.float32)
    for b, n in enumerate(lengths):
        mix[b, n:] = 0.0
        sources[b, :, n:] = 0.0
    lengths = np.asarray(lengths, np.int32)
    return {"mix": mix, "sources": sources, "lengths": lengths,
            "row_mask": (lengths > 0).astype(np.float32)}


def _grads_by_jax_name(model):
    g = {n: p.grad for n, p in model.named_parameters()}
    blstm = [{direction: {"w_ih": g[f"blstm.weight_ih_l{li}{sfx}"].t(),
                          "w_hh": g[f"blstm.weight_hh_l{li}{sfx}"].t(),
                          "b": g[f"blstm.bias_ih_l{li}{sfx}"]}
              for direction, sfx in (("fwd", ""), ("bwd", "_reverse"))} for li in range(L)]
    return {"blstm": blstm, "bn": {"gamma": g["bn.weight"], "beta": g["bn.bias"]},
            "lin": {"w": g["lin.weight"].t(), "b": g["lin.bias"]}}


@pytest.mark.parametrize("S", [2, 3])
def test_loss_assignments_masks_gradients_and_bn_match_jax(S):
    """S passes with the state carried (and differentiated) from pass to
    pass; a pad row whose sources all tie at 0."""
    cfg, params, state = _jax_model()
    batch = _batch(S, seed=S)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jrsh.loss_fn(cfg, p, jax.tree_util.tree_map(jnp.asarray, state), jb,
                               jax.random.PRNGKey(0), True), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    model = _port_model(params, state)
    loss, aux = get_arch("RSH").loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()},
                                        torch.Generator().manual_seed(0), True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in ("norm", "total"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(aux["assignments"].numpy(), np.asarray(jaux["assignments"]))
    assert sorted(aux["assignments"][0].tolist()) == list(range(S))
    assert aux["assignments"][3].tolist() == list(range(S))     # the pad row's ties
    np.testing.assert_allclose(aux["masks"].detach().numpy(), np.asarray(jaux["masks"]),
                               atol=2e-5)
    # BN ran once per pass in train mode
    np.testing.assert_allclose(model.bn.running_mean.numpy(),
                               np.asarray(jaux["new_state"]["bn"]["mean"]), atol=2e-5)
    np.testing.assert_allclose(model.bn.running_var.numpy(),
                               np.asarray(jaux["new_state"]["bn"]["var"]), atol=2e-5)
    assert int(model.bn.num_batches_tracked) == 1 + S
    got = jax.tree_util.tree_leaves_with_path(_grads_by_jax_name(model))
    ref = dict(jax.tree_util.tree_leaves_with_path(jgrads))
    scale = max(float(np.abs(np.asarray(r)).max()) for r in ref.values())
    assert len(got) == len(ref) == 6 * L + 4
    for path, g in got:
        np.testing.assert_allclose(g.numpy(), np.asarray(ref[path]), atol=1e-5 * scale,
                                   err_msg=jax.tree_util.keystr(path))


def test_cv_loss_relus_and_keeps_bn_statistics():
    """The loss path relus the residual in eval mode too; BN is left as it
    was."""
    cfg, params, state = _jax_model(head_bias=1.0)
    batch = _batch(3, seed=7)
    jloss, _ = jrsh.loss_fn(cfg, params, state, jax.tree_util.tree_map(jnp.asarray, batch),
                            jax.random.PRNGKey(0), False)
    model = _port_model(params, state).eval()
    with torch.no_grad():
        loss, _ = trsh.loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()},
                               torch.Generator().manual_seed(0), False)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_array_equal(model.bn.running_mean.numpy(), state["bn"]["mean"])


def test_infer_masks_subtract_without_relu():
    """With the head biased up, the first two masks sum past 1, so the
    third pass sees a negative residual: no relu there, as in the JAX
    package (the loss path's relu would give other masks)."""
    cfg, params, state = _jax_model(head_bias=1.0)
    batch = _batch(3, seed=5)
    inputs = {k: batch[k] for k in ("mix", "lengths", "row_mask")}
    ref = jrsh.infer_masks(cfg, params, state, jax.tree_util.tree_map(jnp.asarray, inputs),
                           jax.random.PRNGKey(0), 3)
    model = _port_model(params, state).eval()
    got = trsh.infer_masks(model, {k: torch.from_numpy(v) for k, v in inputs.items()},
                           torch.Generator().manual_seed(0), 3)
    assert got.shape == (4, 3, 12, F)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)
    residual = 1.0 - got[:, 0] - got[:, 1]
    assert float(residual[0].min()) < -0.1
    with torch.no_grad():
        _, aux = trsh.loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()},
                              torch.Generator().manual_seed(0), False)
    assert float((aux["masks"][:, 2] - got[:, 2]).abs().max()) > 1e-3


# ------------------------------------------------------------ recurrence

SFX = (False, True)
CASES = [("float32", 2e-5), ("bfloat16", 2e-2)]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _close(got, ref, tol, name):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got / scale, ref / scale, atol=tol, err_msg=name)


@pytest.mark.parametrize("dtype,tol", CASES)
def test_chained_lstm_seq_with_length_zero_matches_pallas_vjp(dtype, tol):
    """Two chained calls, the first's h_last/c_last the second's h0/c0 (so
    the first gets non-zero dh_last/dc_last), lengths 0 and 1 among the
    rows: the port's lstm_seq (plain forward and backward on the CPU)
    against jax.value_and_grad of the Pallas lstm_seq in interpret mode."""
    T, B, Hh = 9, 6, 8
    rng = np.random.default_rng(11)
    xw = [(0.5 * rng.standard_normal((T, 2, B, 4 * Hh))).astype(np.float32) for _ in range(2)]
    w = (0.3 * rng.standard_normal((2, Hh, 4 * Hh))).astype(np.float32)
    h0 = rng.standard_normal((2, B, Hh)).astype(np.float32)
    c0 = rng.standard_normal((2, B, Hh)).astype(np.float32)
    lengths = np.asarray([T, 0, 1, 5, 0, T - 1], np.int32)
    cot = rng.standard_normal((T, 2, B, Hh)).astype(np.float32)

    def jloss(xa, xb, w, h0, c0):
        ys1, h1, c1 = lstm_pallas.lstm_seq(xa, w, h0, c0, jnp.asarray(lengths), JDT[dtype], SFX)
        ys2, h2, c2 = lstm_pallas.lstm_seq(xb, w, h1, c1, jnp.asarray(lengths), JDT[dtype], SFX)
        return (jnp.sum(ys1.astype(jnp.float32) * cot) + jnp.sum(ys2.astype(jnp.float32) ** 2)
                + jnp.sum(jnp.sin(h2)) + 0.1 * jnp.sum(c2 ** 2))

    jargs = [jnp.asarray(xw[0]).astype(JDT[dtype]), jnp.asarray(xw[1]).astype(JDT[dtype]),
             jnp.asarray(w).astype(JDT[dtype]), jnp.asarray(h0), jnp.asarray(c0)]
    ref_loss, ref = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4))(*jargs)
    ts = [torch.from_numpy(xw[0]).to(TDT[dtype]), torch.from_numpy(xw[1]).to(TDT[dtype]),
          torch.from_numpy(w).to(TDT[dtype]), torch.from_numpy(h0), torch.from_numpy(c0)]
    for t in ts:
        t.requires_grad_(True)
    lens = torch.from_numpy(lengths)
    ys1, h1, c1 = lstm_seq(ts[0], ts[2], ts[3], ts[4], lens, TDT[dtype], SFX)
    ys2, h2, c2 = lstm_seq(ts[1], ts[2], h1, c1, lens, TDT[dtype], SFX)
    loss = (torch.sum(ys1.float() * torch.from_numpy(cot)) + torch.sum(ys2.float() ** 2)
            + torch.sum(torch.sin(h2)) + 0.1 * torch.sum(c2 ** 2))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss),
                               rtol=1e-5 if dtype == "float32" else 2e-3)
    for name, t, r in zip(("dxw1", "dxw2", "dw_hh", "dh0", "dc0"), ts, ref):
        _close(t.grad, r.astype(jnp.float32), tol, name)
    # a length-0 row: no step is valid, so its state passes through both
    # calls and its gate gradients are exactly zero
    for b in (1, 4):
        assert torch.equal(h2[:, b], ts[3][:, b].detach())
        assert float(ts[0].grad[:, :, b].abs().max()) == 0.0


# ------------------------------------------------------------------ data

def _npz_corpus(root, counts, T_choices=(8, 12), seed=0):
    """npz features (mix, s1..sN; (F, T) float32) with utt2num_spk; lengths
    multiples of 4 so a time_pad_multiple of 4 adds no frames."""
    rng = np.random.default_rng(seed)
    os.makedirs(root)
    scp, u2s = [], []
    for i, s in enumerate(counts):
        t = int(rng.choice(T_choices))
        arrs = {"mix": np.abs(rng.standard_normal((F, t))).astype(np.float32)}
        for k in range(s):
            arrs[f"s{k + 1}"] = np.abs(rng.standard_normal((F, t))).astype(np.float32)
        path = os.path.join(root, f"u{i:02d}.npz")
        np.savez(path, **arrs)
        scp.append(f"u{i:02d} {path}\n")
        u2s.append(f"u{i:02d} {s}\n")
    with open(os.path.join(root, "feats_train.scp"), "w") as f:
        f.writelines(scp)
    with open(os.path.join(root, "utt2num_spk"), "w") as f:
        f.writelines(u2s)
    return root


def test_speaker_count_batches_and_mixed_batches_match_jax(tmp_path):
    d = _npz_corpus(str(tmp_path / "feats"), [1, 2, 3, 2, 3, 3, 1, 2, 2])
    jds, tds = jdata.FeatureDataset(d, "train"), tdata.FeatureDataset(d)
    np.testing.assert_array_equal(tds.num_spks, jds.num_spks)
    kw = dict(batch_size=2, time_pad_multiple=4, group_by_num_spk=True, seed=3)
    for epoch in range(3):
        got = tdata.plan_batches(tds, tdata.BatchPlan(**kw), epoch, num_spks=tds.num_spks)
        assert got == jdata.plan_batches(jds, jdata.BatchPlan(**kw), epoch,
                                         num_spks=jds.num_spks)
        assert all(len({int(tds.num_spks[i]) for i in b}) == 1 for b in got)
    plan_kw = dict(batch_size=8, time_pad_multiple=4)
    idxs = list(range(8))
    ref = jdata.collate_mixed_batch(jds, idxs, jdata.BatchPlan(**plan_kw), jds.num_spks)
    got = tdata.collate_mixed_batch(tds, idxs, tdata.BatchPlan(**plan_kw), tds.num_spks)
    assert [g["sources"].shape[:2] for g in got] == [(2, 1), (4, 2), (4, 3)]
    for g, r in zip(got, ref):
        assert g["names"] == r["names"]
        for k in ("mix", "sources", "lengths", "row_mask"):
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


def test_three_mixed_batch_steps_match_jax_train(tmp_path, monkeypatch):
    """train() with reference_batching on a 1/2/3-speaker corpus, one batch
    of 6 a step, three epochs: the epoch losses and the final weights (BN's
    running statistics included) against the JAX package's train(), both
    from the JAX init and a zero initial state."""
    d = _npz_corpus(str(tmp_path / "feats"), [1, 2, 3, 1, 2, 3])
    kwargs = {"feat_dim": str(F), "hidden": str(H), "num_layers": str(L),
              "zero_init_hidden": "1"}
    jres = jax_train(d, str(tmp_path / "jax"),
                     JaxLoopConfig(arch="RSH", batch_size=6, num_epochs=3, time_pad_multiple=4,
                                   reference_batching=True, make_plots=False),
                     model_kwargs=kwargs, use_mesh=False, log=quiet)
    # the JAX trainer's init: the second half of PRNGKey(seed)'s split
    _, init_key = jax.random.split(jax.random.PRNGKey(0))
    params, state = jrsh.init(init_key, jrsh.Config.from_kwargs(**kwargs))
    init_sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                  jax.tree_util.tree_map(np.asarray, state))

    class FromJax(trsh.RSH):
        def reset_parameters(self, generator=None):
            self.load_state_dict(init_sd)

    monkeypatch.setattr(trsh, "Model", FromJax)
    res = loop.train(d, str(tmp_path / "port"),
                     loop.TrainLoopConfig(arch="RSH", batch_size=6, num_epochs=3,
                                          time_pad_multiple=4, reference_batching=True),
                     model_kwargs=kwargs, device="cpu", log=quiet)

    def losses(exp):
        with open(os.path.join(exp, "train_stats", "train_loss.txt")) as f:
            return [float(line.split()[1]) for line in f]

    jl, tl = losses(str(tmp_path / "jax")), losses(str(tmp_path / "port"))
    assert len(tl) == len(jl) == 3 and len(res["steps"]) == 3
    assert [n for _, n in res["steps"]] == [6, 6, 6]
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-5)
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jres["params"]),
                              jax.tree_util.tree_map(np.asarray, jres["state"]))
    for name, p in res["model"].state_dict().items():
        if name != "bn.num_batches_tracked":
            np.testing.assert_allclose(p.numpy(), ref[name].numpy(), atol=5e-5, err_msg=name)


def test_mixed_batches_need_feature_files(tmp_path):
    with pytest.raises(ValueError, match="feature-file input"):
        loop.train(str(tmp_path), str(tmp_path / "exp"),
                   loop.TrainLoopConfig(arch="RSH", reference_batching=True,
                                        on_device_features=True), device="cpu")


# ------------------------------------------------------------- eval paths

@pytest.fixture(scope="module")
def rsh_model(tmp_path_factory):
    """A small JAX RSH saved both ways: the JAX checkpoint and the bare
    reference .mdl that `sepsep export-model` writes; a 2/3-speaker test
    set with the port's features."""
    root = tmp_path_factory.mktemp("torch_rsh_eval")
    cfg = jrsh.Config(feat_dim=257, hidden=16, num_layers=1, zero_init_hidden=True)
    params, state = jrsh.init(jax.random.PRNGKey(3), cfg)
    ckpt = str(root / "model.ckpt")
    save_checkpoint(ckpt, params=params, state=state, epoch=0,
                    meta={"arch": "RSH", "model_kwargs": KW})
    mdl = str(root / "model.mdl")
    sd = state_dict_from_params(jax.device_get(params), jax.device_get(state))
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, mdl)
    corpus = str(root / "corpus")
    ids = make_synthetic_corpus_var(corpus, 5, seed=2, prefix="tt", counts=(2, 3))
    test_dir = str(root / "test")
    os.makedirs(test_dir)
    with open(os.path.join(test_dir, "wav.scp"), "w") as f:
        f.writelines(f"{u} {corpus}/mix/{u}.wav\n" for u in ids)
    extract_features(test_dir, "test", str(root / "feats"), log=quiet, device="cpu")
    return {"root": root, "ckpt": ckpt, "mdl": mdl, "test_dir": test_dir, "ids": ids,
            "corpus": corpus}


def test_reference_mdl_loads_as_rsh(rsh_model):
    sd = torch.load(rsh_model["mdl"], weights_only=True)
    assert infer_model_info(sd) == {"arch": "RSH", "feat_dim": 257, "num_spk": None,
                                    "hidden": 16, "num_layers": 1}
    arch, cfg, model = load_model(rsh_model["mdl"], device="cpu")
    assert arch is trsh and cfg.input_dim == 514 and cfg.hidden == 16
    assert model.lin.weight.shape == (257, 32)


def test_generate_masks_match_jax(rsh_model, tmp_path):
    """Batches of one speaker count; each utterance gets s1..sS."""
    jax_generate_masks(rsh_model["ckpt"], rsh_model["test_dir"], str(tmp_path / "j"),
                       batch_size=2, log=quiet)
    generate_masks(rsh_model["mdl"], rsh_model["test_dir"], str(tmp_path / "t"),
                   model_kwargs=KW, batch_size=2, log=quiet, device="cpu")
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names and len(names) == 5
    for name in names:
        with np.load(tmp_path / "j" / name) as ref, np.load(tmp_path / "t" / name) as got:
            assert sorted(got.files) == sorted(ref.files)
            assert len(got.files) == (2 if int(name[2:6]) % 2 == 0 else 3)
            for k in ref.files:
                assert got[k].dtype == np.float32 and got[k].shape == ref[k].shape
                np.testing.assert_allclose(got[k], ref[k], atol=1e-5, err_msg=f"{name} {k}")


@pytest.mark.parametrize("num_spk", [2, 3])
def test_separate_matches_jax_pipeline(rsh_model, num_spk):
    rng = np.random.default_rng(num_spk)
    sigs = [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in (7000, 3210)]
    ref = JaxPipeline(rsh_model["ckpt"], batch_size=4, length_quantum=4096).separate(
        sigs, num_spk)
    pipe = SeparationPipeline(rsh_model["mdl"], model_kwargs=KW, batch_size=4,
                              length_quantum=4096, device="cpu")
    got = pipe.separate(sigs, num_spk)
    for r, g in zip(ref, got):
        assert len(g) == len(r) == num_spk
        for a, b in zip(r, g):
            assert a.shape == b.shape
            np.testing.assert_allclose(b, a, atol=2e-4)
    assert pipe.buckets == {(4096 // 128 * 2 + 1, num_spk)}


def test_run_train_and_run_eval_end_to_end(tmp_path, monkeypatch):
    """run-train --arch RSH on a 2/3-speaker corpus with the reference's
    mixed batches (CV over sub-batches at epoch 5), then run-eval staged
    (masks of S passes per utterance) and fused (one stream per speaker
    count); then `train RSH --on-device-features` (batches of one count)."""
    monkeypatch.chdir(tmp_path)
    roots = {}
    for k, (name, n) in enumerate((("rtr", 6), ("rtt", 4))):
        roots[name] = str(tmp_path / "corpus" / name)
        write_id_list("id_lists", name, make_synthetic_corpus_var(
            roots[name], n, seed=k, prefix=name, counts=(2, 3)))
    with open("id_lists/path.json", "w") as f:
        json.dump(roots, f)
    with open("model.conf", "w") as f:
        f.write("hidden=8\nnum_layers=1\n")
    main(["run-train", "--arch", "RSH", "--train-set", "rtr", "--cv-set", "rtr",
          "--batch-size", "4", "--num-epochs", "5", "--model-config", "model.conf",
          "--reference-batching", "--device", "cpu"])
    exp = "exp/RSH_rtr"
    with open(os.path.join(exp, "train_stats", "cv_loss.txt")) as f:
        assert [line.split()[0] for line in f] == ["005"]
    with open(os.path.join(exp, "train_stats", "train_loss.txt")) as f:
        assert len([float(line.split()[1]) for line in f]) == 5
    main(["run-eval", "--model-dir", exp, "--test-sets", "rtt", "--batch-size", "4",
          "--device", "cpu"])
    out = os.path.join(exp, "output_final", "rtt")
    for utt, s in (("rtt0000", 2), ("rtt0001", 3)):
        with np.load(os.path.join(out, "masks", utt + ".npz")) as m:
            assert sorted(m.files) == [f"s{k + 1}" for k in range(s)]
    with open(os.path.join(out, "results", "summary.json")) as f:
        assert json.load(f)["n_utts"] == 4
    main(["run-eval", "--model-dir", exp, "--test-sets", "rtt", "--batch-size", "4",
          "--stage", "1", "--on-device-features", "--intermediate-model-num", "5",
          "--device", "cpu"])
    fused = os.path.join(exp, "output_5", "rtt")
    assert sorted(os.listdir(os.path.join(fused, "wav"))) == ["s1", "s2", "s3"]
    assert len(os.listdir(os.path.join(fused, "wav", "s3"))) == 2
    with open(os.path.join(fused, "results", "summary.json")) as f:
        assert np.isfinite(json.load(f)["mean"]["SDR"])

    # separate with a count of the call's own; serve takes the same flags
    main(["separate", os.path.join(exp, "final.mdl"), "sep", "corpus/rtt/mix/rtt0000.wav",
          "--arch", "RSH", "--num-spk", "3", "--device", "cpu"])
    assert sorted(os.listdir("sep")) == [f"rtt0000_s{k}.wav" for k in (1, 2, 3)]
    args = build_parser().parse_args(["serve", "m.mdl", "s.sock", "--arch", "RSH",
                                      "--num-spk", "3"])
    assert (args.arch, args.num_spk) == ("RSH", 3)

    res = loop.train("data/rtr", "exp/wav", loop.TrainLoopConfig(
        arch="RSH", batch_size=4, num_epochs=2, on_device_features=True),
        model_kwargs={"hidden": "8", "num_layers": "1"}, device="cpu", log=quiet)
    # 3 of each count, batches of 4: two batches of one count an epoch
    assert [n for _, n in res["steps"]] == [3, 3, 3, 3]
