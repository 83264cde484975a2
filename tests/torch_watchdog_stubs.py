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
