"""Data-dir splitting for sharded jobs.

The port's own copy of speech_separation_tpu/datadir/split.py: ``wav.scp``
(and ``segments``, grouped by recording so that a recording's segments
never straddle shards) go into ``<data-dir>/split<N>/wav.scp.<i>`` for i in
1..N, row r (0-based) of n going to shard ``r * N // n + 1``.
"""

from __future__ import annotations

import os
import shutil

from .scp import read_scp, write_scp


def _shard_index(row: int, n_rows: int, n_shards: int) -> int:
    """The 1-based shard of 0-based row ``row`` of ``n_rows``."""
    return (row * n_shards) // n_rows + 1


def split_data_dir(data_dir: str, num_shards: int) -> str:
    split_dir = os.path.join(data_dir, f"split{num_shards}")
    shutil.rmtree(split_dir, ignore_errors=True)
    os.makedirs(split_dir)

    entries = read_scp(os.path.join(data_dir, "wav.scp"))
    n = len(entries)
    shards: dict[int, list] = {}
    for i, kv in enumerate(entries):
        shards.setdefault(_shard_index(i, n, num_shards), []).append(kv)
    for idx, shard_entries in shards.items():
        write_scp(os.path.join(split_dir, f"wav.scp.{idx}"), shard_entries)

    seg_path = os.path.join(data_dir, "segments")
    if os.path.isfile(seg_path):
        with open(seg_path) as f:
            lines = [line.rstrip("\n") for line in f if line.strip()]
        # shard on the recording count, advanced where column 2 changes
        seg_shards: dict[int, list[str]] = {}
        prev_reco, n_recos = None, 0
        for line in lines:
            reco = line.split()[1]
            if reco != prev_reco:
                prev_reco = reco
                n_recos += 1
            seg_shards.setdefault(_shard_index(n_recos - 1, n, num_shards), []).append(line)
        for idx, seg_lines in seg_shards.items():
            with open(os.path.join(split_dir, f"segments.{idx}"), "w") as f:
                f.write("\n".join(seg_lines) + "\n")

    return split_dir
