"""The port's ``train`` CLI end to end on the CPU: a tiny corpus built with
the JAX package's synthetic corpus and feature extractor, trained through
``python -m speech_separation_tpu_torch.cli.main train ... --device cpu``;
its loss files and checkpoints; ``final.mdl`` separating a wav through the
port's ``separate``; and a resume that continues bit for bit. The corpus and
the 10-epoch run that the others are held to are built once per session
(tests/torch_session.py)."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from speech_separation_tpu.datadir import DatasetRegistry, prepare_data_dir
from speech_separation_tpu.dsp import STFTConfig
from speech_separation_tpu.dsp.extract import extract_features
from speech_separation_tpu.utils.synthetic import make_synthetic_corpus, write_id_list
from speech_separation_tpu_torch.cli.main import main
from speech_separation_tpu_torch.eval.infer import load_model
from speech_separation_tpu_torch.train.checkpoint import load_checkpoint
from speech_separation_tpu_torch.utils.audio import load_wav

from torch_session import built_once

torch.set_num_threads(1)  # six xdist workers share the cores: one thread each, for life

TRAIN = ["--device", "cpu", "--batch-size", "4", "--time-pad-multiple", "32",
         "--seed", "3", "--no-plots"]


def _build_corpus(root):
    ids = make_synthetic_corpus(str(root / "corpus"), 6, min_sec=0.3, max_sec=0.6,
                                seed=0, prefix="tr")
    write_id_list(str(root / "id_lists"), "toy", ids)
    data_dir = prepare_data_dir("toy", DatasetRegistry({"toy": str(root / "corpus")}),
                                data_root=str(root / "data"),
                                id_lists_dir=str(root / "id_lists"))
    extract_features(data_dir, "train", str(root / "feats"), STFTConfig(), log=lambda *a: 0)
    (root / "model.conf").write_text("hidden=8\nnum_layers=1\n")
    # 10 epochs in one run, CV at 5 and 10: what the resumed runs must equal
    main(["train", "uPIT", data_dir, str(root / "exp_full"), "--cv-data-dir", data_dir,
          "--num-epochs", "10", "--model-config", str(root / "model.conf"), *TRAIN])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(root, data dir, model config): the corpus, its features and
    ``exp_full``, a 10-epoch run, built once per session (tests only read
    them and train into their own tmp_path)."""
    root = built_once(tmp_path_factory, "torch_train", _build_corpus)
    return root, str(root / "data" / "toy"), str(root / "model.conf")


def _losses(exp, name):
    with open(os.path.join(exp, "train_stats", name)) as f:
        return f.read().splitlines()


def test_train_cli_writes_reference_outputs_and_separates(corpus, tmp_path):
    root, data_dir, conf = corpus
    exp = str(root / "exp_full")
    train_lines = _losses(exp, "train_loss.txt")
    assert [ln.split()[0] for ln in train_lines] == [f"{e:03d}" for e in range(1, 11)]
    losses = [float(ln.split()[1]) for ln in train_lines]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert [ln.split()[0] for ln in _losses(exp, "cv_loss.txt")] == ["005", "010"]
    for name in ("init", "005", "010"):
        assert os.path.isfile(os.path.join(exp, "intermediate_models", f"{name}.mdl"))
    ckpt = load_checkpoint(os.path.join(exp, "final.mdl"))
    assert ckpt["epoch"] == 10 and ckpt["meta"]["arch"] == "uPIT"
    # one trainable bias per direction: bias_hh stays zero
    assert float(ckpt["model"]["blstm.bias_hh_l0"].abs().max()) == 0.0

    # final.mdl is a reference state dict the serving path loads as it is
    _, cfg, _ = load_model(os.path.join(exp, "final.mdl"), device="cpu")
    assert (cfg.hidden, cfg.num_layers, cfg.feat_dim) == (8, 1, 257)
    wav = os.path.join(root, "corpus", "mix", "tr0000.wav")
    out = str(tmp_path / "sep")
    main(["separate", os.path.join(exp, "final.mdl"), out, wav, "--device", "cpu",
          "--model-config", conf])
    tracks = sorted(os.listdir(out))
    assert len(tracks) == 2
    n = len(load_wav(wav)[0])
    for t in tracks:
        y, sr = load_wav(os.path.join(out, t))
        assert sr == 8000 and abs(len(y) - n) < 128 and np.all(np.isfinite(y))


def test_resume_is_bit_continuous(corpus, tmp_path):
    """5 epochs, then 5 more resumed from intermediate_models/005.mdl,
    write the same loss lines as 10 epochs in one run."""
    root, data_dir, conf = corpus
    exp = str(tmp_path / "exp_resumed")
    common = ["--cv-data-dir", data_dir, "--model-config", conf, *TRAIN]
    main(["train", "uPIT", data_dir, exp, "--num-epochs", "5", *common])
    # a crash after epoch 5 leaves later checkpoints behind; resume cuts the
    # logs back to epoch 5
    with open(os.path.join(exp, "train_stats", "train_loss.txt"), "a") as f:
        f.write("006 123.0\n")
    main(["train", "uPIT", data_dir, exp, "--num-epochs", "10", "--start-epoch", "5",
          *common])
    full = str(root / "exp_full")
    assert _losses(exp, "train_loss.txt") == _losses(full, "train_loss.txt")
    assert _losses(exp, "cv_loss.txt") == _losses(full, "cv_loss.txt")
    a = torch.load(os.path.join(exp, "final.mdl"), weights_only=True)
    b = torch.load(os.path.join(full, "final.mdl"), weights_only=True)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_reference_resume_drops_the_optimizer_state(corpus, tmp_path):
    """From the same epoch-5 checkpoint, a reference resume (fresh Adam
    moments and generator) and a full resume train epoch 6 differently."""
    _, data_dir, conf = corpus
    exp, exp_ref = str(tmp_path / "exp_5"), str(tmp_path / "exp_ref")
    common = ["--model-config", conf, *TRAIN]
    main(["train", "uPIT", data_dir, exp, "--num-epochs", "5", *common])
    shutil.copytree(exp, exp_ref)
    main(["train", "uPIT", data_dir, exp, "--num-epochs", "6", "--start-epoch", "5",
          *common])
    main(["train", "uPIT", data_dir, exp_ref, "--num-epochs", "6", "--start-epoch", "5",
          "--reference-resume", *common])
    full, ref = _losses(exp, "train_loss.txt"), _losses(exp_ref, "train_loss.txt")
    assert len(full) == len(ref) == 6
    assert full[:5] == ref[:5] and full[5] != ref[5]
    assert load_checkpoint(os.path.join(exp, "intermediate_models", "005.mdl"),
                           reference_resume=True)["optimizer"] is None


def test_reference_resume_from_a_bare_mdl(corpus, tmp_path):
    """A reference exp dir holds only NNN.mdl: a reference resume from it
    trains as one from the port's own checkpoint, and a full resume names
    the missing training state."""
    _, data_dir, conf = corpus
    exp, bare = str(tmp_path / "exp_with_state"), str(tmp_path / "exp_bare")
    common = ["--model-config", conf, *TRAIN]
    main(["train", "uPIT", data_dir, exp, "--num-epochs", "5", *common])
    shutil.copytree(exp, bare)
    int_dir = os.path.join(bare, "intermediate_models")
    for name in os.listdir(int_dir):
        if name.endswith(".state"):
            os.remove(os.path.join(int_dir, name))
    resume = ["--num-epochs", "6", "--start-epoch", "5", *common]
    with pytest.raises(FileNotFoundError, match="reference-resume"):
        main(["train", "uPIT", data_dir, bare, *resume])
    for d in (exp, bare):
        main(["train", "uPIT", data_dir, d, "--reference-resume", *resume])
    assert _losses(bare, "train_loss.txt") == _losses(exp, "train_loss.txt")
    a = torch.load(os.path.join(bare, "final.mdl"), weights_only=True)
    b = torch.load(os.path.join(exp, "final.mdl"), weights_only=True)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_profile_dir_and_train_copy_location(corpus, tmp_path):
    """--train-copy-location stages the features and trains on the copies
    (the same loss lines as exp_full's first epochs); --profile-dir writes
    a Chrome trace and the op table of the steps after the first, the trace
    holding the steps' program spans (utils/spans.py) on the main thread."""
    from speech_separation_tpu_torch.datadir.stage import staged_path
    from speech_separation_tpu_torch.train.data import FeatureDataset

    root, data_dir, conf = corpus
    exp, stage, prof = (str(tmp_path / n) for n in ("exp", "stage", "prof"))
    main(["train", "uPIT", data_dir, exp, "--num-epochs", "2", "--model-config", conf,
          "--profile-dir", prof, "--train-copy-location", stage, *TRAIN])
    entries = FeatureDataset(data_dir, log=lambda *_: None).entries
    assert all(os.path.isfile(staged_path(p, stage)) for _, p in entries)
    assert _losses(exp, "train_loss.txt") == _losses(str(root / "exp_full"),
                                                     "train_loss.txt")[:2]
    with open(os.path.join(prof, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "_LstmSeq" for e in events)
    names = {e.get("name") for e in events if e.get("cat") == "user_annotation"}
    assert {"train.step", "train.forward", "train.loss", "train.backward",
            "train.optimizer"} <= names
    ops = [e for e in events if e.get("name") == "_LstmSeq"]
    steps = [e for e in events if e.get("name") == "train.step"]
    assert steps and all(
        any(s["ts"] <= o["ts"] <= s["ts"] + s["dur"] for s in steps) for o in ops)
    with open(os.path.join(prof, "kernels.txt")) as f:
        assert "_LstmSeqBackward" in f.read()


PLOTS = {"uPIT": ["Chosen_Permutation.png", "Loss_001-005.png", "Masked_Mixture.png",
                  "Mixture.png"],
         "RSH": sorted(["2-Spk_Mix.png", "Loss_001-005.png"]
                       + [f"2-Spk_Pass-{p}_{n}.png" for p in (1, 2)
                          for n in ("Input", "Attenmask", "Mask_Out", "Masked_Mix",
                                    "Chosen_Source")])}


@pytest.mark.parametrize("arch", ["uPIT", "RSH"])
def test_plots_at_each_checkpoint_after_cv_and_at_the_end(corpus, tmp_path, arch):
    pytest.importorskip("matplotlib")
    _, data_dir, conf = corpus
    exp = str(tmp_path / "exp")
    main(["train", arch, data_dir, exp, "--cv-data-dir", data_dir, "--num-epochs", "5",
          "--model-config", conf, *[a for a in TRAIN if a != "--no-plots"]])
    plots = os.path.join(exp, "train_stats", "plots")
    assert sorted(os.listdir(os.path.join(plots, "epoch005"))) == PLOTS[arch]
    assert sorted(os.listdir(plots)) == ["Loss_001-005.png", "epoch005"]


def test_without_matplotlib_training_says_so_and_goes_on(corpus, tmp_path, monkeypatch,
                                                        capsys):
    from speech_separation_tpu_torch.utils import plot
    monkeypatch.setattr(plot, "available", lambda: False)
    _, data_dir, conf = corpus
    exp = str(tmp_path / "exp")
    main(["train", "uPIT", data_dir, exp, "--num-epochs", "1", "--model-config", conf,
          *[a for a in TRAIN if a != "--no-plots"]])
    assert capsys.readouterr().out.count("plots skipped: matplotlib is not installed") == 1
    assert os.path.isfile(os.path.join(exp, "final.mdl"))
    assert not os.path.exists(os.path.join(exp, "train_stats", "plots"))
