"""Hang watchdog: supervise training in a child process by its heartbeat.

The port's counterpart of speech_separation_tpu/train/watchdog.py.
``train_with_restarts`` (train/loop.py) recovers crashes: the exception
surfaces in the process and training resumes from the newest checkpoint. A
hang does not surface: a process wedged in a CUDA call or a collective
cannot be interrupted from inside. So the training loop runs in a spawned
child (``spawn``: the only start method under which a child may use CUDA)
that touches a heartbeat file after every optimizer step, CV batch and
checkpoint; the supervisor kills the child when the heartbeat goes stale and
starts a new one from the newest intermediate checkpoint, as after a crash.

Under data parallelism (train/loop.py over more than one card) the child is
the launcher of the ranks: rank 0 beats, and a kill of the child ends every
rank (a rank exits when its parent is gone, parallel/ranks.py).

Two allowances: before an attempt's first beat the child builds its kernels
and reads its first batch, which may take minutes (``first_timeout_s``);
after it, a silence longer than ``hang_timeout_s`` is a hang. A heartbeat
file deleted under a running child is made again with the last beat's
mtime, so the allowance stays the one after the first beat. Enable with
``train``/``run-train --hang-watchdog-sec N``.

An error that a restart cannot cure ends the supervised run at once, with
that error and no restart: another trainer's lock on the exp dir
(``ExpDirLocked``) or a configuration ``ValueError`` (``_fatal_types``). The child
writes the exception it died of beside the heartbeat (``.error``), and the
supervisor raises it again; any other failure is restarted.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing
import os
import pickle
import time


class HangRecoveryExhausted(RuntimeError):
    """Supervised training kept hanging or crashing past max_restarts."""


def _fatal_types() -> tuple:
    """The errors a restart cannot cure: another trainer's lock, and a
    configuration ValueError."""
    from .loop import ExpDirLocked
    return (ExpDirLocked, ValueError)


def _child(target, error_path: str, *args) -> None:
    """A supervised child: ``target(*args)``; the exception it dies of is
    written to ``error_path`` (pickled) for the supervisor, then raised."""
    try:
        target(*args)
    except Exception as e:
        try:
            with open(error_path, "wb") as f:
                pickle.dump(e, f)
        except (OSError, pickle.PicklingError, TypeError, AttributeError):
            pass
        raise


def _child_error(error_path: str):
    """The exception a child wrote before it died, or None."""
    try:
        with open(error_path, "rb") as f:
            return pickle.load(f)
    except (OSError, EOFError, pickle.UnpicklingError, AttributeError, ImportError, TypeError):
        return None


def _last_beat(heartbeat_file: str, last: float) -> float:
    """The heartbeat's mtime, or ``last`` (the newest seen) when the file
    is gone: it is made again with that mtime, so the child can beat on and
    a deleted file neither reads as a beat nor as "not yet started"."""
    try:
        return max(last, os.path.getmtime(heartbeat_file))
    except OSError:
        try:
            open(heartbeat_file, "a").close()
            os.utime(heartbeat_file, (last, last))
        except OSError:
            pass
        return last


def _supervise(target, args_for_attempt, heartbeat_file: str, hang_timeout_s: float,
               first_timeout_s: float, max_restarts: int, poll_s: float = 2.0,
               log=print) -> int:
    """Run ``target(*args_for_attempt(attempt))`` in spawned children until
    one exits cleanly; returns the number of restarts used. A child whose
    heartbeat file is stale, by ``first_timeout_s`` before its first beat
    and ``hang_timeout_s`` after, is killed. Kills and crashes both count
    against ``max_restarts``; a child that dies of a ``_fatal_types`` error ends
    the run with that error at once."""
    ctx = multiprocessing.get_context("spawn")
    error_path = heartbeat_file + ".error"
    attempt = 0
    while True:
        open(heartbeat_file, "w").close()
        t_start = last = os.path.getmtime(heartbeat_file)
        try:
            os.remove(error_path)
        except FileNotFoundError:
            pass
        proc = ctx.Process(target=_child, args=(target, error_path, *args_for_attempt(attempt)))
        proc.start()
        killed = False
        while True:
            proc.join(timeout=poll_s)
            if proc.exitcode is not None:
                break
            last = _last_beat(heartbeat_file, last)
            allowed = hang_timeout_s if last > t_start else first_timeout_s
            stale = time.time() - last
            if stale > allowed:
                log(f"watchdog: heartbeat stale {stale:.0f}s (> {allowed:.0f}s "
                    f"allowed); killing wedged child pid {proc.pid}")
                proc.kill()
                proc.join(30)
                killed = True
                break
        error = None if killed else _child_error(error_path)
        if os.path.exists(error_path):
            os.remove(error_path)
        if proc.exitcode == 0:
            return attempt
        if isinstance(error, _fatal_types()):
            log(f"watchdog: child failed with {type(error).__name__}: {error}; a restart "
                "cannot cure it, so the run ends here")
            raise error
        reason = "hang-killed" if killed else f"died rc={proc.exitcode}"
        if attempt >= max_restarts:
            raise HangRecoveryExhausted(
                f"supervised child {reason}; max_restarts={max_restarts} exhausted")
        attempt += 1
        log(f"watchdog: child {reason}; restart {attempt}/{max_restarts}")


def _train_child(data_dir, exp_dir, loop_cfg, cv_data_dir, model_kwargs, device,
                 result_path) -> None:
    """The spawned child: the real training loop, then a small JSON summary
    for the supervisor (the model lands on disk as always)."""
    from .loop import train
    out = train(data_dir, exp_dir, loop_cfg, cv_data_dir=cv_data_dir,
                model_kwargs=model_kwargs, device=device)
    with open(result_path, "w") as f:
        json.dump({"utts_per_sec": out["utts_per_sec"]}, f)


def train_supervised(data_dir: str, exp_dir: str, loop_cfg, hang_timeout_s: float = 900.0,
                     first_timeout_s: float = 2400.0, max_restarts: int = 2,
                     cv_data_dir: str = "", model_kwargs: dict | None = None, device=None,
                     poll_s: float = 2.0, log=print) -> dict:
    """Train in supervised children, recovering hangs and crashes (module
    docstring). Returns {'restarts', 'utts_per_sec'} of the attempt that
    finished; the model is on disk in exp_dir (final.mdl). Each restart
    resumes from the newest intermediate checkpoint (a hang before any
    checkpoint restarts from start_epoch)."""
    from .loop import latest_intermediate_epoch

    os.makedirs(exp_dir, exist_ok=True)
    hb = os.path.join(exp_dir, ".heartbeat")
    result_path = os.path.join(exp_dir, ".train_result.json")
    try:
        os.remove(result_path)
    except FileNotFoundError:
        pass

    def args_for_attempt(attempt: int):
        resume = loop_cfg.start_epoch
        if attempt:
            resume = max(latest_intermediate_epoch(exp_dir), resume)
            log(f"watchdog: resuming from epoch {resume}")
        cfg = dataclasses.replace(loop_cfg, start_epoch=resume, heartbeat_file=hb)
        return (data_dir, exp_dir, cfg, cv_data_dir, model_kwargs, device, result_path)

    restarts = _supervise(_train_child, args_for_attempt, hb, hang_timeout_s,
                          first_timeout_s, max_restarts, poll_s=poll_s, log=log)
    res: dict = {"restarts": restarts}
    if os.path.isfile(result_path):
        with open(result_path) as f:
            res.update(json.load(f))
        os.remove(result_path)
    return res
