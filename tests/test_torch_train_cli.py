"""The port's ``train`` CLI end to end on the CPU: a tiny corpus built with
the JAX package's synthetic corpus and feature extractor, trained through
``python -m speech_separation_tpu_torch.cli.main train ... --device cpu``;
its loss files and checkpoints; ``final.mdl`` separating a wav through the
port's ``separate``; and a resume that continues bit for bit."""

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

TRAIN = ["--device", "cpu", "--batch-size", "4", "--time-pad-multiple", "32",
         "--seed", "3"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_train")
    ids = make_synthetic_corpus(str(root / "corpus"), 6, min_sec=0.3, max_sec=0.6,
                                seed=0, prefix="tr")
    write_id_list(str(root / "id_lists"), "toy", ids)
    data_dir = prepare_data_dir("toy", DatasetRegistry({"toy": str(root / "corpus")}),
                                data_root=str(root / "data"),
                                id_lists_dir=str(root / "id_lists"))
    extract_features(data_dir, "train", str(root / "feats"), STFTConfig(), log=lambda *a: 0)
    conf = root / "model.conf"
    conf.write_text("hidden=8\nnum_layers=1\n")
    return root, data_dir, str(conf)


def _losses(exp, name):
    with open(os.path.join(exp, "train_stats", name)) as f:
        return f.read().splitlines()


def test_train_cli_writes_reference_outputs_and_separates(corpus):
    root, data_dir, conf = corpus
    exp = str(root / "exp_full")
    main(["train", "uPIT", data_dir, exp, "--cv-data-dir", data_dir, "--num-epochs", "10",
          "--model-config", conf, "--no-plots", *TRAIN])
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
    out = str(root / "sep")
    main(["separate", os.path.join(exp, "final.mdl"), out, wav, "--device", "cpu",
          "--model-config", conf])
    tracks = sorted(os.listdir(out))
    assert len(tracks) == 2
    n = len(load_wav(wav)[0])
    for t in tracks:
        y, sr = load_wav(os.path.join(out, t))
        assert sr == 8000 and abs(len(y) - n) < 128 and np.all(np.isfinite(y))


def test_resume_is_bit_continuous(corpus):
    """5 epochs, then 5 more resumed from intermediate_models/005.mdl,
    write the same loss lines as 10 epochs in one run."""
    root, data_dir, conf = corpus
    exp = str(root / "exp_resumed")
    common = ["--cv-data-dir", data_dir, "--model-config", conf, *TRAIN]
    main(["train", "uPIT", data_dir, exp, "--num-epochs", "5", *common])
    # a crash after epoch 5 leaves later checkpoints behind; resume cuts the
    # logs back to epoch 5
    with open(os.path.join(exp, "train_stats", "train_loss.txt"), "a") as f:
        f.write("006 123.0\n")
    main(["train", "uPIT", data_dir, exp, "--num-epochs", "10", "--start-epoch", "5",
          *common])
    full = str(root / "exp_full")
    if not os.path.isdir(full):
        main(["train", "uPIT", data_dir, full, "--num-epochs", "10", *common])
    assert _losses(exp, "train_loss.txt") == _losses(full, "train_loss.txt")
    assert _losses(exp, "cv_loss.txt") == _losses(full, "cv_loss.txt")
    a = torch.load(os.path.join(exp, "final.mdl"), weights_only=True)
    b = torch.load(os.path.join(full, "final.mdl"), weights_only=True)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_reference_resume_drops_the_optimizer_state(corpus):
    """From the same epoch-5 checkpoint, a reference resume (fresh Adam
    moments and generator) and a full resume train epoch 6 differently."""
    root, data_dir, conf = corpus
    exp, exp_ref = str(root / "exp_5"), str(root / "exp_ref")
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


def test_reference_resume_from_a_bare_mdl(corpus):
    """A reference exp dir holds only NNN.mdl: a reference resume from it
    trains as one from the port's own checkpoint, and a full resume names
    the missing training state."""
    root, data_dir, conf = corpus
    exp, bare = str(root / "exp_with_state"), str(root / "exp_bare")
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
