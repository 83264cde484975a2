"""The port's recipe commands (``run-eval``, ``run-train``) end to end on the
CPU, in a workspace holding the JAX package's synthetic corpus (6 training
and 4 test utterances of 0.6-1.4 s) and its registry.

- ``run-eval`` stages 0-4, staged and with ``--on-device-features``, on a
  uPIT (hidden 16, 1 layer, zero initial state) made by the JAX package and
  exported to a reference .mdl, against ``sepsep run-eval`` on the JAX
  checkpoint: each source's SDR within 0.05 dB, the same result files.
- ``run-train`` stages 0-2 (2 epochs; extraction in 2 shards), then
  ``run-eval`` and ``run-eval --sweep-intermediates``, all ``--device cpu``
  (port only): the exp dir's snapshot and models, the scores' summary and
  the sweep's table are written.
- the flags of modules not ported yet are refused by the parser, and those
  of the training extras parse.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from speech_separation_tpu.cli.main import main as sepsep
from speech_separation_tpu.models import upit as jupit
from speech_separation_tpu.train.checkpoint import save_checkpoint
from speech_separation_tpu.utils.import_torch import state_dict_from_params
from speech_separation_tpu.utils.synthetic import make_synthetic_corpus, write_id_list
from speech_separation_tpu_torch.cli.main import main

torch.set_num_threads(1)  # six xdist workers share the cores: one thread each, for life

SDR_TOL_DB = 0.05
CONF = "hidden=16\nnum_layers=1\nzero_init_hidden=1\n"


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_recipe")
    cwd = os.getcwd()
    os.chdir(root)
    ids_tr = make_synthetic_corpus(str(root / "corpus" / "tr"), 6, seed=0, prefix="tr")
    ids_tt = make_synthetic_corpus(str(root / "corpus" / "tt"), 4, seed=1, prefix="tt")
    write_id_list("id_lists", "toy_tr", ids_tr)
    write_id_list("id_lists", "toy_tt", ids_tt)
    with open("id_lists/path.json", "w") as f:
        json.dump({"toy_tr": str(root / "corpus" / "tr"),
                   "toy_tt": str(root / "corpus" / "tt")}, f)
    with open("model.conf", "w") as f:
        f.write(CONF)
    # one model, as a JAX checkpoint and as the reference .mdl exported from it
    cfg = jupit.Config(feat_dim=257, num_spk=2, hidden=16, num_layers=1,
                       zero_init_hidden=True)
    params, state = jupit.init(jax.random.PRNGKey(5), cfg)
    for d in ("exp_jax", "exp_port"):
        os.makedirs(d)
        with open(os.path.join(d, "conf"), "w") as f:
            f.write(CONF)
    save_checkpoint("exp_jax/final.mdl", params=params, state=state, epoch=0,
                    meta={"arch": "uPIT"})
    sd = state_dict_from_params(jax.device_get(params), jax.device_get(state))
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               "exp_port/final.mdl")
    yield root
    os.chdir(cwd)


def _source_sdrs(out_dir):
    with open(os.path.join(out_dir, "results", "source_SDRs.txt")) as f:
        return {ln.split()[0]: [float(v) for v in ln.split()[1:]] for ln in f}


@pytest.mark.parametrize("fused", [False, True], ids=["staged", "fused"])
def test_run_eval_matches_the_jax_recipe(workspace, fused):
    flags = ["--test-sets", "toy_tt", "--batch-size", "3"] + (
        ["--on-device-features"] if fused else [])
    for d in ("exp_jax", "exp_port"):
        shutil.rmtree(os.path.join(d, "output_final"), ignore_errors=True)
    sepsep(["run-eval", "--model-dir", "exp_jax", "--data-root", "data_j",
            "--featdir", "feats_j", *flags])
    main(["run-eval", "--model-dir", "exp_port", "--data-root", "data_t",
          "--featdir", "feats_t", "--device", "cpu", *flags])
    want = _source_sdrs("exp_jax/output_final/toy_tt")
    got = _source_sdrs("exp_port/output_final/toy_tt")
    assert list(got) == list(want) and len(got) == 4
    for utt in want:
        assert len(got[utt]) == 2
        np.testing.assert_allclose(got[utt], want[utt], atol=SDR_TOL_DB, rtol=0, err_msg=utt)
    res_j = sorted(os.listdir("exp_jax/output_final/toy_tt/results"))
    assert sorted(os.listdir("exp_port/output_final/toy_tt/results")) == res_j
    out = "exp_port/output_final/toy_tt"
    assert os.path.isdir(os.path.join(out, "masks")) != fused
    with open(os.path.join(out, "results", "summary.json")) as f:
        summary = json.load(f)
    assert summary["n_utts"] == 4 and summary["scorer"] == "host-f64"


def test_run_train_then_run_eval_on_the_cpu(workspace):
    main(["run-train", "--train-set", "toy_tr", "--cv-set", "toy_tt", "--batch-size", "3",
          "--num-epochs", "2", "--time-pad-multiple", "64", "--model-config", "model.conf",
          "--nj", "2", "--device", "cpu"])
    exp = "exp/uPIT_toy_tr"
    for name in ("final.mdl", "final.state", "conf", "arch.json", "arch.py",
                 "intermediate_models/init.mdl"):
        assert os.path.isfile(os.path.join(exp, name)), name
    with open(os.path.join(exp, "arch.json")) as f:
        assert json.load(f) == {"arch": "uPIT",
                                "module": "speech_separation_tpu_torch.models.upit"}
    with open(os.path.join(exp, "conf")) as f:
        assert f.read() == CONF
    with open(os.path.join(exp, "train_stats", "train_loss.txt")) as f:
        assert len(f.read().splitlines()) == 2
    # the two shards' outputs merged in wav.scp order
    with open("data/toy_tr/feats_train.scp") as f:
        assert [ln.split()[0] for ln in f] == [f"tr{i:04d}" for i in range(6)]

    main(["run-eval", "--model-dir", exp, "--test-sets", "toy_tt", "--batch-size", "3",
          "--stage", "1", "--device", "cpu"])
    out = os.path.join(exp, "output_final", "toy_tt")
    with open(os.path.join(out, "results", "summary.json")) as f:
        summary = json.load(f)
    assert summary["n_utts"] == 4 and np.isfinite(summary["mean"]["SDR"])
    assert sorted(os.listdir(os.path.join(out, "wav"))) == ["s1", "s2"]

    # every saved model (init and final) from the extracted features: one
    # table, the best model by SDR flagged
    main(["run-eval", "--model-dir", exp, "--test-sets", "toy_tt", "--batch-size", "3",
          "--stage", "2", "--sweep-intermediates", "--device", "cpu"])
    with open(os.path.join(exp, "sweep_results", "toy_tt.txt")) as f:
        lines = f.read().splitlines()
    assert lines[0] == "model SDR SIR SAR SI-SDR SI-SDRi best"
    assert [r.split()[0] for r in lines[1:]] == ["init", "final"]
    assert sum(r.endswith(" *") for r in lines[1:]) == 1
    assert os.path.isfile(os.path.join(exp, "output_init", "toy_tt", "results",
                                       "summary.json"))


# --data-parallel was the flag of the one module not ported, refused on every
# command that has it in the JAX package; parallel/mesh.py ports it, and the
# same seven command lines now parse it into args.data_parallel (what it does
# is held in tests/test_torch_parallel*.py)
@pytest.mark.parametrize("argv", [
    ["run-eval", "--model-dir", "x", "--test-sets", "y", "--data-parallel", "--device-scoring"],
    ["run-eval", "--model-dir", "x", "--test-sets", "y", "--data-parallel"],
    ["score", "d", "e", "--data-parallel", "--device-scoring"],
    ["score", "d", "e", "--data-parallel"],
    ["separate", "m", "o", "a.wav", "--data-parallel"],
    ["serve", "m", "s.sock", "--data-parallel"],
    ["oracle", "d", "--data-parallel"],
], ids=lambda a: a[-1] if a[-1].startswith("--") else a[-2])
def test_flags_of_unported_modules_are_refused(argv):
    from speech_separation_tpu_torch.cli.main import build_parser
    args = build_parser().parse_args(argv)
    assert args.data_parallel is True
    if "device_scoring" in vars(args):
        assert args.device_scoring == ("--device-scoring" in argv)


# the training extras (train/feature_cache.py, train/watchdog.py, the
# profiler, staging) are ported: their flags parse into the command's args
@pytest.mark.parametrize("argv,want", [
    (["extract", "d", "train", "f", "--pack-cache", "--cache-dtype", "float16"],
     {"pack_cache": True, "cache_dtype": "float16"}),
    (["run-train", "--train-set", "t", "--pack-cache"],
     {"pack_cache": True, "cache_dtype": "float32"}),
    (["pack-features", "d", "train", "--dtype", "float16", "--cache-path", "c.bin"],
     {"dtype": "float16", "cache_path": "c.bin"}),
    (["run-train", "--train-set", "t", "--hang-watchdog-sec", "60",
      "--hang-first-timeout-sec", "30"],
     {"hang_watchdog_sec": 60.0, "hang_first_timeout_sec": 30.0}),
    (["run-train", "--train-set", "t", "--profile-dir", "p"], {"profile_dir": "p"}),
    (["train", "uPIT", "d", "e", "--train-copy-location", "c", "--no-plots"],
     {"train_copy_location": "c", "no_plots": True}),
], ids=["extract", "run-train", "pack-features", "hang-watchdog", "profile-dir",
        "train-copy-location"])
def test_flags_of_the_training_extras_parse(argv, want):
    from speech_separation_tpu_torch.cli.main import build_parser
    args = vars(build_parser().parse_args(argv))
    assert {k: args[k] for k in want} == want


@pytest.mark.parametrize("argv", [
    ["run-eval", "--model-dir", "x", "--test-sets", "y", "--device-scoring"],
    ["score", "d", "e", "--device-scoring"],
    ["oracle", "d", "--device-scoring", "--hard-mask", "--nj", "2", "--mj", "2"],
], ids=lambda a: a[0])
def test_device_scoring_flags_parse(argv):
    from speech_separation_tpu_torch.cli.main import build_parser
    args = build_parser().parse_args(argv)
    assert args.device_scoring and args.device == "cuda"
