"""Test inputs built once per pytest session and shared by every worker.

Under pytest-xdist's ``--dist load`` the cases of one file are dealt out to
all the workers, so a ``scope="module"`` fixture is built again on each
worker that gets a case. An input that costs more than a few seconds to
build is built here instead: by the first worker that asks, into a
directory of the session's base temp dir (shared by all the workers of one
session, fresh for each session), behind an ``fcntl.flock`` lock; the
others wait for it and read the finished directory. Tests only read it.
"""

from __future__ import annotations

import fcntl
import os
import shutil
from pathlib import Path


def built_once(tmp_path_factory, name: str, build) -> Path:
    """The directory ``name``, made by ``build(path)`` once per session."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent          # the session's dir, above each worker's own
    root = base / name
    with open(base / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (root / ".built").exists():
            shutil.rmtree(root, ignore_errors=True)
            root.mkdir()
            build(root)
            (root / ".built").touch()
    return root
