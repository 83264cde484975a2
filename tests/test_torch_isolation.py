"""The PyTorch port stands alone: none of its modules, and not
chip_smoke.py, imports JAX or the JAX package, every top-level import of
theirs is on an allowlist of what the card's machine has (the standard
library, torch, numpy, scipy and the port itself: no msgpack, no flax; and
matplotlib in utils/plot.py alone, imported only when a plot is drawn), and
its entry points run on CUDA unless the caller asks for the CPU."""

import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import speech_separation_tpu_torch

torch.set_num_threads(1)  # six xdist workers share the cores: one thread each, for life

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(speech_separation_tpu_torch.__file__)


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages([PKG], "speech_separation_tpu_torch."))


def test_importing_the_port_loads_no_jax():
    # every source file of the package is one of the modules imported below
    sources = {"speech_separation_tpu_torch." + os.path.relpath(os.path.join(root, n), PKG)
               [:-3].replace(os.sep, ".").removesuffix(".__init__")
               for root, _, names in os.walk(PKG) for n in names if n.endswith(".py")}
    assert sources - {"speech_separation_tpu_torch.__init__"} <= set(_port_modules())
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax'):\n"
        "    sys.modules[name] = None\n"
        # the scorer's spawned workers import only this module: no torch,
        # so they never touch the card
        "import speech_separation_tpu_torch.eval.score\n"
        "assert 'torch' not in sys.modules, 'eval.score loads torch'\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [n for n in sys.modules if n == 'speech_separation_tpu'\n"
        "       or n.startswith('speech_separation_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_names_jax_or_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        for name in _imported_roots(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax",
                               "speech_separation_tpu"), (path, name)


# the top-level packages the port and chip_smoke.py may import besides the
# standard library: the card's machine has these and not msgpack or flax
ALLOWED_IMPORTS = {"torch", "numpy", "scipy", "speech_separation_tpu_torch"}
# matplotlib, which the card's machine lacks, in the plotting module alone
PLOT_MODULE = os.path.join(PKG, "utils", "plot.py")


def test_every_import_is_on_the_allowlist():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        allowed = ALLOWED_IMPORTS | ({"matplotlib"} if path == PLOT_MODULE else set())
        for name in _imported_roots(path):
            top = name.split(".")[0]
            assert top in sys.stdlib_module_names or top in allowed, (path, name)


def test_the_trainer_and_the_cli_do_not_import_matplotlib():
    """The card's machine has no matplotlib: importing the trainer, the CLI
    and the plotting module itself loads none of it (a plot imports it when
    it is drawn)."""
    code = ("import sys\n"
            "import speech_separation_tpu_torch.train.loop, speech_separation_tpu_torch.cli.main\n"
            "import speech_separation_tpu_torch.train.watchdog\n"
            "import speech_separation_tpu_torch.utils.plot as plot\n"
            "plot.available()\n"
            "assert 'matplotlib' not in sys.modules\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    from speech_separation_tpu_torch.cli.main import main
    from speech_separation_tpu_torch.dsp.extract import extract_features
    from speech_separation_tpu_torch.eval.infer import generate_masks
    from speech_separation_tpu_torch.eval.pipeline import SeparationPipeline
    from speech_separation_tpu_torch.eval.reconstruct import reconstruct_sources
    from speech_separation_tpu_torch.train.loop import TrainLoopConfig, train
    from speech_separation_tpu_torch.utils.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        SeparationPipeline(str(tmp_path / "missing.mdl"))
    with pytest.raises(RuntimeError, match="CUDA"):
        train(str(tmp_path / "data"), str(tmp_path / "exp"), TrainLoopConfig())
    assert not (tmp_path / "exp").exists()
    assert resolve_device("cpu").type == "cpu"

    # the recipe's entry points: each raises and writes nothing
    data = tmp_path / "data" / "tt"
    data.mkdir(parents=True)
    (data / "wav.scp").write_text("u1 /nowhere/mix/u1.wav\n")
    (data / "utt2num_spk").write_text("u1 2\n")
    before = sorted(str(p) for p in tmp_path.rglob("*"))
    with pytest.raises(RuntimeError, match="CUDA"):
        extract_features(str(data), "test", str(tmp_path / "feats"))
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_masks(str(tmp_path / "missing.mdl"), str(data), str(tmp_path / "masks"))
    with pytest.raises(RuntimeError, match="CUDA"):
        reconstruct_sources(str(data), str(tmp_path / "out"))
    from speech_separation_tpu_torch.eval.bss_eval_device import bss_eval_sources_batch
    from speech_separation_tpu_torch.eval.oracle import evaluate_oracle
    from speech_separation_tpu_torch.eval.score import evaluate_sources
    with pytest.raises(RuntimeError, match="CUDA"):
        bss_eval_sources_batch(np.zeros((1, 2, 8)), np.zeros((1, 2, 8)))
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_oracle(str(data))
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_sources(str(data), str(tmp_path / "exp_score"), device_scoring=True)
    monkeypatch.chdir(tmp_path)
    for argv in (["run-eval", "--model-dir", "exp", "--test-sets", "tt"],
                 ["run-eval", "--model-dir", "exp", "--test-sets", "tt", "--device-scoring"],
                 ["extract", "data/tt", "test", "feats", "--nj", "2"],
                 ["eval-masks", "missing.mdl", "data/tt", "masks"],
                 ["score", "data/tt", "exp_score", "--device-scoring"],
                 ["oracle", "data/tt"], ["oracle", "data/tt", "--nj", "2", "--mj", "2"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)
    assert sorted(str(p) for p in tmp_path.rglob("*")) == before
