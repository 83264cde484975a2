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
after it, a silence longer than ``hang_timeout_s`` is a hang. Enable with
``train``/``run-train --hang-watchdog-sec N``.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing
import os
import time


class HangRecoveryExhausted(RuntimeError):
    """Supervised training kept hanging or crashing past max_restarts."""


def _supervise(target, args_for_attempt, heartbeat_file: str, hang_timeout_s: float,
               first_timeout_s: float, max_restarts: int, poll_s: float = 2.0,
               log=print) -> int:
    """Run ``target(*args_for_attempt(attempt))`` in spawned children until
    one exits cleanly; returns the number of restarts used. A child whose
    heartbeat file is stale, by ``first_timeout_s`` before its first beat
    and ``hang_timeout_s`` after, is killed. Kills and crashes both count
    against ``max_restarts``."""
    ctx = multiprocessing.get_context("spawn")
    attempt = 0
    while True:
        open(heartbeat_file, "w").close()
        t_start = os.path.getmtime(heartbeat_file)
        proc = ctx.Process(target=target, args=args_for_attempt(attempt))
        proc.start()
        killed = False
        while True:
            proc.join(timeout=poll_s)
            if proc.exitcode is not None:
                break
            try:
                mtime = os.path.getmtime(heartbeat_file)
            except OSError:      # deleted under the supervisor: stale
                mtime = t_start
            allowed = hang_timeout_s if mtime > t_start else first_timeout_s
            stale = time.time() - mtime
            if stale > allowed:
                log(f"watchdog: heartbeat stale {stale:.0f}s (> {allowed:.0f}s "
                    f"allowed); killing wedged child pid {proc.pid}")
                proc.kill()
                proc.join(30)
                killed = True
                break
        if proc.exitcode == 0:
            return attempt
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
