"""Data staging: copy the files an scp names to fast local storage.

The port's own copy of speech_separation_tpu/datadir/stage.py. Each file
lands under the target dir at its own absolute path
(``<target>/<original-absolute-path>``); a file already staged at the same
size is skipped. Each copy is written to a name of its own and renamed into
place, so processes staging one scp at once (the ranks of a data-parallel
run) never read a partly written file. ``bwlimit_kbps`` (KiB/s, None =
unlimited) paces the copies.
"""

from __future__ import annotations

import os
import shutil
import time

from .scp import read_scp


def staged_path(original: str, target_dir: str) -> str:
    return os.path.join(target_dir, original.lstrip("/"))


def stage_scp_data(scp_path: str, target_dir: str,
                   bwlimit_kbps: float | None = None,
                   log=print) -> dict[str, str]:
    """Copy every file of the scp's value column into target_dir; returns
    {original_path: staged_path}."""
    mapping: dict[str, str] = {}
    copied = 0
    budget_start = time.time()
    bytes_copied = 0
    for _, src in read_scp(scp_path):
        dst = staged_path(src, target_dir)
        mapping[src] = dst
        if os.path.isfile(dst) and os.path.getsize(dst) == os.path.getsize(src):
            continue
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        tmp = f"{dst}.{os.getpid()}.tmp"
        shutil.copyfile(src, tmp)
        os.replace(tmp, dst)
        copied += 1
        bytes_copied += os.path.getsize(src)
        if bwlimit_kbps:
            sleep = bytes_copied / (bwlimit_kbps * 1024.0) - (time.time() - budget_start)
            if sleep > 0:
                time.sleep(sleep)
    log(f"staged {copied} files ({bytes_copied >> 20} MiB) -> {target_dir}")
    return mapping
