"""The port's hang watchdog (speech_separation_tpu_torch/train/watchdog.py),
as tests/test_watchdog.py holds the JAX package's: the supervisor with stub
children in spawned processes (a clean child, a hung one, one slow to its
first beat, one that never beats, a crash; one that dies of another
trainer's lock and one of a configuration error, which end the run with no
restart; one that deletes its heartbeat and wedges), then a supervised CPU training
of a tiny uPIT through the CLI, whose final.mdl equals the in-process run's,
and the heartbeat the loop touches."""

import os
import time

import pytest
import torch

import torch_watchdog_stubs as stubs
from speech_separation_tpu_torch.cli.main import main
from speech_separation_tpu_torch.dsp.extract import extract_features
from speech_separation_tpu_torch.datadir.prepare import prepare_data_dir
from speech_separation_tpu_torch.datadir.registry import DatasetRegistry
from speech_separation_tpu_torch.train.loop import ExpDirLocked, TrainLoopConfig, train
from speech_separation_tpu_torch.train.watchdog import HangRecoveryExhausted, _supervise
from speech_separation_tpu_torch.utils.synthetic import make_synthetic_corpus, write_id_list

from torch_session import built_once

torch.set_num_threads(1)  # six xdist workers share the cores: one thread each, for life


def quiet(*_):
    pass


def _args(tmp_path):
    hb, flag = str(tmp_path / "hb"), str(tmp_path / "flag")
    return hb, (lambda attempt: (hb, flag))


@pytest.mark.parametrize("stub,restarts", [(stubs.ok, 0), (stubs.crash_once, 1),
                                           (stubs.slow_first_beat, 0)],
                         ids=["clean", "crash", "slow-first-beat"])
def test_supervise_runs_the_child_to_a_clean_exit(tmp_path, stub, restarts):
    """A clean child needs no restart; a crash is restarted once; a child
    slower to its first beat than the steady-state allowance (0.5 s) but
    inside the first-beat one (30 s) is left alone."""
    hb, args_fn = _args(tmp_path)
    assert _supervise(stub, args_fn, hb, hang_timeout_s=0.5, first_timeout_s=30,
                      max_restarts=1, poll_s=0.1, log=quiet) == restarts


def test_supervise_kills_a_hung_child_and_restarts(tmp_path):
    hb, args_fn = _args(tmp_path)
    msgs = []
    assert _supervise(stubs.hang_once, args_fn, hb, hang_timeout_s=1.0, first_timeout_s=30,
                      max_restarts=1, poll_s=0.1, log=msgs.append) == 1
    assert any("killing wedged child" in m for m in msgs)
    assert any("restart 1/1" in m for m in msgs)


def test_supervise_gives_up_after_max_restarts(tmp_path):
    """A child that never beats is killed on the first-beat allowance, not
    the steady-state one, and with no restart left the supervisor raises."""
    hb, args_fn = _args(tmp_path)
    t0 = time.time()
    with pytest.raises(HangRecoveryExhausted, match="hang-killed"):
        _supervise(stubs.never_beats, args_fn, hb, hang_timeout_s=3600, first_timeout_s=1.0,
                   max_restarts=0, poll_s=0.1, log=quiet)
    assert time.time() - t0 < 30


@pytest.mark.parametrize("stub,error", [(stubs.locked, ExpDirLocked),
                                         (stubs.bad_config, ValueError)],
                         ids=["exp-dir-locked", "config-error"])
def test_an_error_no_restart_cures_ends_the_run_at_once(tmp_path, stub, error):
    """The child's own error surfaces in the supervisor after 0 restarts,
    though restarts are left (not HangRecoveryExhausted)."""
    hb, args_fn = _args(tmp_path)
    msgs = []
    with pytest.raises(error) as caught:
        _supervise(stub, args_fn, hb, hang_timeout_s=30, first_timeout_s=60, max_restarts=3,
                   poll_s=0.1, log=msgs.append)
    assert type(caught.value) is error
    assert not any("restart" in m and "/3" in m for m in msgs), msgs
    assert any("a restart cannot cure it" in m for m in msgs)
    assert not os.path.exists(hb + ".error")


def test_a_deleted_heartbeat_keeps_the_steady_state_allowance(tmp_path):
    """A child that beat once and then lost its heartbeat file is caught at
    hang_timeout_s (1 s), not first_timeout_s (30 s); the file is made
    again."""
    hb, args_fn = _args(tmp_path)
    t0 = time.time()
    with pytest.raises(HangRecoveryExhausted, match="hang-killed"):
        _supervise(stubs.beat_then_delete, args_fn, hb, hang_timeout_s=1.0,
                   first_timeout_s=30, max_restarts=0, poll_s=0.1, log=quiet)
    assert time.time() - t0 < 15
    assert os.path.exists(hb)


def _build_data(root):
    ids = make_synthetic_corpus(str(root / "corpus"), 4, min_sec=0.3, max_sec=0.5, seed=2,
                                prefix="wd")
    write_id_list(str(root / "id_lists"), "wd", ids)
    d = prepare_data_dir("wd", DatasetRegistry({"wd": str(root / "corpus")}),
                         data_root=str(root / "data"), id_lists_dir=str(root / "id_lists"))
    extract_features(d, "train", str(root / "feats"), log=quiet, device="cpu")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return str(built_once(tmp_path_factory, "torch_watchdog", _build_data) / "data" / "wd")


TRAIN = ["--model-config", "", "--batch-size", "4", "--num-epochs", "2",
         "--time-pad-multiple", "32", "--seed", "1", "--no-plots", "--device", "cpu"]


def test_supervised_cli_training_equals_the_in_process_run(data_dir, tmp_path, capsys,
                                                           monkeypatch):
    # the spawned child starts torch on one thread too, so both runs sum alike
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    conf = tmp_path / "m.conf"
    conf.write_text("hidden=8\nnum_layers=1\n")
    argv = [a if a else str(conf) for a in TRAIN]
    main(["train", "uPIT", data_dir, str(tmp_path / "plain"), *argv])
    main(["train", "uPIT", data_dir, str(tmp_path / "supervised"), *argv,
          "--hang-watchdog-sec", "120", "--hang-first-timeout-sec", "300"])
    assert "training finished after 0 restart(s)" in capsys.readouterr().out
    a = torch.load(tmp_path / "plain" / "final.mdl", weights_only=True)
    b = torch.load(tmp_path / "supervised" / "final.mdl", weights_only=True)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert ((tmp_path / "plain" / "train_stats" / "train_loss.txt").read_text()
            == (tmp_path / "supervised" / "train_stats" / "train_loss.txt").read_text())
    assert not (tmp_path / "supervised" / ".train_result.json").exists()


def test_the_loop_beats_the_heartbeat(data_dir, tmp_path):
    """The loop touches heartbeat_file after its steps and checkpoints."""
    hb = tmp_path / "hb"
    hb.touch()
    os.utime(hb, (0, 0))
    train(data_dir, str(tmp_path / "exp"),
          TrainLoopConfig(batch_size=4, num_epochs=1, time_pad_multiple=32,
                          make_plots=False, heartbeat_file=str(hb)),
          model_kwargs={"hidden": "8", "num_layers": "1"}, device="cpu", log=quiet)
    assert os.path.getmtime(hb) > time.time() - 60
