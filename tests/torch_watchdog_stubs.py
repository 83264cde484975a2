"""Stub children for tests/test_torch_watchdog.py's supervisor tests.

A spawned child imports the module of its target by name, so the stubs
live in a module of their own that imports only the standard library: each
child starts in a fraction of a second, where the test module (which
imports torch) would cost seconds a child."""

import os
import time


def ok(hb_path, flag_path):
    for _ in range(3):
        os.utime(hb_path, None)
        time.sleep(0.05)


def hang_once(hb_path, flag_path):
    """First attempt: beat once, then wedge; the second finishes."""
    if os.path.exists(flag_path):
        os.utime(hb_path, None)
        return
    open(flag_path, "w").close()
    os.utime(hb_path, None)
    time.sleep(3600)


def crash_once(hb_path, flag_path):
    if os.path.exists(flag_path):
        os.utime(hb_path, None)
        return
    open(flag_path, "w").close()
    raise SystemExit(3)


def never_beats(hb_path, flag_path):
    time.sleep(3600)


def slow_first_beat(hb_path, flag_path):
    """A start slower than the steady-state allowance but inside the
    first-beat one, then steps within it."""
    time.sleep(1.5)
    for _ in range(3):
        os.utime(hb_path, None)
        time.sleep(0.1)


def locked(hb_path, flag_path):
    """Dies of another trainer's lock (this child imports the port, and so
    torch: seconds, once)."""
    from speech_separation_tpu_torch.train.loop import ExpDirLocked
    os.utime(hb_path, None)
    raise ExpDirLocked("exp dir is locked by another trainer (pid 1)")


def bad_config(hb_path, flag_path):
    """Dies of a configuration error before its first beat."""
    raise ValueError("mask_act must be relu|sigmoid, got 'tanh'")


def beat_then_delete(hb_path, flag_path):
    """Beats once, lets the supervisor see it, deletes the heartbeat file,
    then wedges."""
    os.utime(hb_path, None)
    time.sleep(0.6)
    os.remove(hb_path)
    time.sleep(3600)
