"""Data-parallel training of the port (parallel/ranks.py, parallel/checks.py's
``steps_over_ranks`` and ``train(mesh=...)``) on the CPU: two gloo ranks,
each its rows of every batch, against the port's single-process step on the
same (row-padded) batch and against the JAX package's step on its 8-device
virtual mesh.

Three spawns of two ranks in all: one runs every step job (uPIT with
divisible and indivisible ragged batches, the three fault controls, remat,
RSH grouped and mixed, Conv-TasNet), one a whole ``train()``, one the
failing-rank control.

Tolerances:
- against the port's own single-process step: the loss within 1e-6
  relative (the same sums, split in two and added); each gradient, as
  reduced over the ranks, within 1e-5 of its largest magnitude; the
  updated parameters and BN's running statistics within 1e-6 absolute
  (a few float32 roundings of Adam's ~1e-3 update);
- against the JAX package's mesh step (tests/test_multichip.py's own
  bounds): the loss rtol 1e-5, the updated parameters and BN's statistics
  atol 1e-5;
- a fault control must miss the gradient bound by 100x;
- a whole ``train()`` (10 epochs, CV at 5 and 10) against the
  single-process run's loss files: rtol 1e-5 (float32 noise carried
  through Adam).
"""

import os
import time

import numpy as np
import pytest
import torch

import jax

from speech_separation_tpu.models import upit as jupit
from speech_separation_tpu.parallel.mesh import make_mesh as jax_mesh
from speech_separation_tpu.parallel.mesh import shard_batch as jax_shard
from speech_separation_tpu.train.loop import (TrainLoopConfig as JaxLoopConfig,
                                              make_optimizer, make_update_step)
from speech_separation_tpu_torch.cli.main import main, read_model_config
from speech_separation_tpu_torch.models import convtasnet as tct
from speech_separation_tpu_torch.models import rsh as trsh
from speech_separation_tpu_torch.models import upit as tupit
from speech_separation_tpu_torch.ops._build import launch_counters
from speech_separation_tpu_torch.parallel import ranks
from speech_separation_tpu_torch.parallel.checks import steps_over_ranks
from speech_separation_tpu_torch.parallel.mesh import make_mesh, pad_rows
from speech_separation_tpu_torch.parallel.ranks import RankFailed
from speech_separation_tpu_torch.train.loop import TrainLoopConfig, train
from speech_separation_tpu_torch.utils.weights import fold_lstm_biases, state_dict_from_jax

from test_torch_train_cli import TRAIN, _build_corpus
from torch_session import built_once

torch.set_num_threads(1)  # six xdist workers share the cores: one thread each, for life

F, H, T = 16, 8, 32
STEP_LOSS, STEP_GRAD, STEP_PARAM = 1e-6, 1e-5, 1e-6
JAX_LOSS, JAX_PARAM = 1e-5, 1e-5
TRAIN_RTOL = 1e-5
CPU2 = ["cpu", "cpu"]


def _features(B, S=2, ragged=True, seed=0):
    rng = np.random.default_rng(seed)
    lengths = (rng.integers(T // 4, T + 1, size=B) if ragged else np.full(B, T)).astype(np.int32)
    mix = np.abs(rng.standard_normal((B, T, F))).astype(np.float32)
    sources = np.abs(rng.standard_normal((B, S, T, F))).astype(np.float32)
    for b, n in enumerate(lengths):
        mix[b, n:] = 0.0
        sources[b, :, n:] = 0.0
    return {"mix": mix, "sources": sources, "lengths": lengths,
            "row_mask": np.ones((B,), np.float32)}


def _audio(B, L=400, S=2, seed=0):
    """A shipped waveform batch (train/wav_data.collate_wav_batch's keys)."""
    rng = np.random.default_rng(seed)
    n = rng.integers(L // 8, L + 1, size=B).astype(np.int32)
    audio = np.zeros((B, 1 + S, L + 512), np.int16)
    for b in range(B):
        srcs = rng.integers(-3000, 3000, size=(S, n[b]))
        audio[b, 1:, 256:256 + n[b]] = srcs
        audio[b, 0, 256:256 + n[b]] = srcs.sum(axis=0)
    return {"audio": audio, "sample_lengths": n, "lengths": (n // 128 + 1).astype(np.int32),
            "row_mask": np.ones((B,), np.float32)}


def _weights(model):
    model.reset_parameters(torch.Generator().manual_seed(0))
    fold_lstm_biases(model)
    return model.state_dict()


def _jax_upit():
    """The JAX model and the port's weights from it (zero initial state)."""
    cfg = jupit.Config(feat_dim=F, num_spk=2, hidden=H, num_layers=1, zero_init_hidden=True)
    params, state = jupit.init(jax.random.PRNGKey(0), cfg)
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params),
                             jax.tree_util.tree_map(np.asarray, state))
    model = tupit.UPIT(tupit.Config(feat_dim=F, hidden=H, num_layers=1, zero_init_hidden=True))
    model.load_state_dict(sd)
    fold_lstm_biases(model)
    return cfg, model.state_dict()


UPIT_KW = {"feat_dim": str(F), "hidden": str(H), "num_layers": "1"}
RSH_KW = dict(UPIT_KW)
CT_KW = {k: str(v) for k, v in dict(n_filters=32, filter_len=16, stride=8, channels=16,
                                    hidden=24, kernel=3, blocks=3, repeats=2).items()}


def _jobs():
    upit_w = _weights(tupit.UPIT(tupit.Config.from_kwargs(**UPIT_KW)))
    ragged = _features(5, seed=1)
    # rank 0's rows of the ragged batch reach 26 frames: padded on their own
    # (time_per_rank) to 28, where the batch's T is 32
    base = {"arch": "uPIT", "model_kwargs": UPIT_KW, "weights": upit_w, "seed": 1,
            "time_pad_multiple": 4}
    jobs = {
        "upit_divisible": dict(base, batch=_features(4, ragged=False, seed=2)),
        "upit_ragged": dict(base, batch=ragged),
        "upit_zero_init": dict(base, model_kwargs={**UPIT_KW, "zero_init_hidden": "1"},
                               weights=_jax_upit()[1], batch=ragged),
        "upit_zero_init_divisible": dict(base, model_kwargs={**UPIT_KW, "zero_init_hidden": "1"},
                                         weights=_jax_upit()[1],
                                         batch=_features(4, ragged=False, seed=2)),
        "upit_remat": dict(base, model_kwargs={**UPIT_KW, "remat": "1"}, batch=ragged),
        "rsh_grouped": dict(base, arch="RSH", model_kwargs=RSH_KW,
                            weights=_weights(trsh.RSH(trsh.Config.from_kwargs(**RSH_KW))),
                            batch=_features(5, S=2, seed=3)),
        "convtasnet": {"arch": "ConvTasNet", "model_kwargs": CT_KW, "seed": 1,
                       "weights": _weights(tct.ConvTasNet(tct.Config.from_kwargs(**CT_KW))),
                       "batch": _audio(5)},
    }
    # the reference's mixed batch: speaker-count sub-batches of 3, 1 and 2
    # rows, none of which divides over two ranks as it comes
    jobs["rsh_mixed"] = dict(jobs["rsh_grouped"], batch=[
        _features(3, S=1, seed=4), _features(1, S=2, seed=5), _features(2, S=3, seed=6)])
    for fault in ("bn_per_rank", "time_per_rank", "mean_grads"):
        jobs[fault] = dict(base, batch=ragged, faults=(fault,))
    return jobs


def _padded(batch):
    """The batch as the ranks see it together: rows padded to a multiple of
    two (the single-process step draws the same initial states then)."""
    if isinstance(batch, list):
        return [pad_rows(sb, 2) for sb in batch]
    return pad_rows(batch, 2)


def _errs(got, want):
    """(loss rel, worst gradient by max |diff| / max |ref|, params abs,
    buffers abs)."""
    grad = max(float((got["grads"][n] - g).abs().max() / g.abs().max().clamp_min(1e-30))
               for n, g in want["grads"].items())
    assert sorted(got["grads"]) == sorted(want["grads"])
    param = max(float((got["params"][n] - p).abs().max()) for n, p in want["params"].items())
    buf = max([float((got["buffers"][n].double() - b.double()).abs().max())
               for n, b in want["buffers"].items()], default=0.0)
    return abs(got["loss"] - want["loss"]) / abs(want["loss"]), grad, param, buf


def _run_steps(root):
    jobs = _jobs()
    names = list(jobs)
    over = steps_over_ranks([jobs[n] for n in names], mesh=make_mesh(devices=CPU2))
    launches = dict(ranks.launch.kernel_launches)
    single = steps_over_ranks([dict(jobs[n], batch=_padded(jobs[n]["batch"]), faults=())
                               for n in names], device="cpu")
    torch.save((dict(zip(names, over)), dict(zip(names, single))), root / "steps.pt")
    torch.save(launches, root / "launches.pt")


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """Every job over two ranks (one spawn) and in this process, once per
    session: (jobs, over the ranks, in one process)."""
    root = built_once(tmp_path_factory, "torch_parallel_steps", _run_steps)
    over, single = torch.load(root / "steps.pt", weights_only=False)
    return _jobs(), over, single


SOUND = ["upit_divisible", "upit_ragged", "upit_zero_init", "upit_zero_init_divisible",
         "upit_remat", "rsh_grouped", "rsh_mixed", "convtasnet"]


def test_the_ranks_report_every_kernel_s_launches(steps, tmp_path_factory):
    """The launches summed over the ranks name every wrapper of the kernel
    table, K6's too (none launches on the CPU: the plain versions run)."""
    root = built_once(tmp_path_factory, "torch_parallel_steps", _run_steps)
    launches = torch.load(root / "launches.pt")
    assert launches == {f.__name__: 0 for f in launch_counters()}
    assert {"channel_norm_fwd", "channel_norm_bwd"} <= set(launches)


@pytest.mark.parametrize("name", SOUND)
def test_two_ranks_step_equals_one_process(steps, name):
    _, over, single = steps
    loss, grad, param, buf = _errs(over[name], single[name])
    assert loss <= STEP_LOSS, loss
    assert grad <= STEP_GRAD, grad
    assert param <= STEP_PARAM, param
    assert buf <= STEP_PARAM, buf
    assert np.isfinite(over[name]["loss"])


def test_norm_and_bn_statistics_are_the_whole_batchs(steps):
    """The reported norm is the global one, and every rank's running
    statistics moved from the global batch (rank 0's are returned)."""
    _, over, single = steps
    for name in ("upit_ragged", "rsh_grouped"):
        assert over[name]["norm"] == pytest.approx(single[name]["norm"], rel=1e-7)
        for k in ("bn.running_mean", "bn.running_var"):
            assert float((over[name]["buffers"][k] - single[name]["buffers"][k]).abs().max()) \
                <= STEP_PARAM
        # one BN call a pass: uPIT one, RSH one for each of its S=2 passes
        assert int(over[name]["buffers"]["bn.num_batches_tracked"]) == \
            int(single[name]["buffers"]["bn.num_batches_tracked"]) == (name == "rsh_grouped") + 1


@pytest.mark.parametrize("fault", ["bn_per_rank", "time_per_rank", "mean_grads"])
def test_fault_controls_fail_the_comparison(steps, fault):
    """Each way data parallelism goes wrong moves the step far past the
    bounds the sound step meets."""
    _, over, single = steps
    _, grad, _, _ = _errs(over[fault], single["upit_ragged"])
    assert grad > 100 * STEP_GRAD, grad


@pytest.mark.parametrize("name", ["upit_zero_init_divisible", "upit_zero_init"])
def test_two_ranks_match_the_jax_mesh_step(steps, name):
    """B=4 of equal lengths, then B=5 with ragged lengths: the JAX package's
    step on its 8-device mesh (rows padded to 8) against the port's two
    ranks (B=5: 5 -> 6)."""
    jobs, over, _ = steps
    cfg, _ = _jax_upit()
    params, state = jupit.init(jax.random.PRNGKey(0), cfg)
    optimizer = make_optimizer(JaxLoopConfig())
    step = make_update_step(jupit, cfg, optimizer)
    batch = jax_shard(jobs[name]["batch"], jax_mesh())
    with jax_mesh():
        p8, s8, _, loss8, norm8 = step(params, state, optimizer.init(params), batch,
                                       jax.random.PRNGKey(1))
    got = over[name]
    np.testing.assert_allclose(got["loss"], float(loss8), rtol=JAX_LOSS)
    np.testing.assert_allclose(got["norm"], float(norm8), rtol=1e-6)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, p8),
                              jax.tree_util.tree_map(np.asarray, s8))
    both = {**got["params"], **got["buffers"]}
    for name, want in ref.items():
        if name != "bn.num_batches_tracked":
            np.testing.assert_allclose(both[name].numpy(), want.numpy(), atol=JAX_PARAM,
                                       err_msg=name)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = built_once(tmp_path_factory, "torch_train", _build_corpus)
    return root, str(root / "data" / "toy"), str(root / "model.conf")


def test_train_over_two_ranks_equals_the_single_process_run(corpus, tmp_path):
    """The 10-epoch CLI run of tests/test_torch_train_cli.py (B=4 of 6
    utterances: a full batch, then 2 real rows and 2 dummies), trained again
    over two ranks, both staging the features into one directory at once:
    the same loss files, a final.mdl with the single run's keys (no
    ``module.`` prefix) that ``separate`` reads."""
    root, data_dir, conf = corpus
    exp = str(tmp_path / "exp")
    stage = tmp_path / "stage"
    cfg = TrainLoopConfig(batch_size=4, num_epochs=10, time_pad_multiple=32, seed=3,
                          make_plots=False, train_copy_location=str(stage))
    assert TRAIN[TRAIN.index("--seed") + 1] == "3"
    out = train(data_dir, exp, cfg, cv_data_dir=data_dir,
                model_kwargs=read_model_config(conf), mesh=make_mesh(devices=CPU2))
    full = str(root / "exp_full")
    for name in ("train_loss.txt", "cv_loss.txt"):
        got = np.loadtxt(os.path.join(exp, "train_stats", name))
        want = np.loadtxt(os.path.join(full, "train_stats", name))
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=TRAIN_RTOL, err_msg=name)
    assert [e for e, _ in out["epoch_losses"]] == list(range(1, 11))
    staged = [p.name for p in stage.rglob("*") if p.is_file()]
    assert len(staged) == 6 and not any(n.endswith(".tmp") for n in staged)
    assert sum(n for _, n in out["steps"]) == 60        # 6 real rows an epoch
    sd = torch.load(os.path.join(exp, "final.mdl"))
    assert sorted(sd) == sorted(torch.load(os.path.join(full, "final.mdl")))
    assert not any(k.startswith("module.") for k in sd)
    assert sorted(out["model"].state_dict()) == sorted(sd)
    for name in ("init", "005", "010"):
        assert os.path.isfile(os.path.join(exp, "intermediate_models", f"{name}.mdl"))
    wav = os.path.join(root, "corpus", "mix", "tr0000.wav")
    main(["separate", os.path.join(exp, "final.mdl"), str(tmp_path / "sep"), wav,
          "--device", "cpu"])
    assert len(os.listdir(tmp_path / "sep")) == 2


def test_a_failing_rank_ends_the_run():
    """Rank 1 raises at the second step while rank 0 waits in that step's
    collectives: the caller gets RankFailed at once, not a hang."""
    ok = _jobs()["upit_ragged"]
    t0 = time.monotonic()
    with pytest.raises(RankFailed, match="rank 1 of 2 exited with code 1"):
        steps_over_ranks([ok, dict(ok, raise_on_rank=1)], mesh=make_mesh(devices=CPU2))
    assert time.monotonic() - t0 < 60
