"""Kaldi-style scp files: one ``<key> <value>`` record per line.

The port's own copy of what it needs from speech_separation_tpu/datadir/
scp.py (``read_scp``, ``write_scp``, ``source_wavs_for_mix``). A data dir
names its utterances' feature files in ``feats_train.scp`` /
``feats_test.scp``, or their mixture wavs in ``wav.scp``; order matters, the
readers keep the file's order.
"""

from __future__ import annotations

import glob
import os


def read_scp(path: str) -> list[tuple[str, str]]:
    """The records of an scp file as an ordered list of (key, value)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            key, _, rest = line.partition(" ")
            out.append((key, rest))
    return out


def write_scp(path: str, entries) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for key, value in entries:
            f.write(f"{key} {value}\n")


def source_wavs_for_mix(mix_path: str) -> list[str]:
    """The mixture and source wavs of a mixture path: the corpus layout is
    ``.../mix/<utt>.wav`` with sibling directories ``s1/``, ``s2/``, ...
    holding the sources, so globbing ``/mix/`` -> ``/*/`` and sorting gives
    ``[mix, s1, s2, ...]`` ("mix" sorts before "s*")."""
    return sorted(glob.glob(mix_path.replace("/mix/", "/*/")))
