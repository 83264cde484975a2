"""Kaldi-style scp files: one ``<key> <value>`` record per line.

The port's own copy of speech_separation_tpu/datadir/scp.py. A data dir
``data/<set>/`` holds

- ``wav.scp``          ``<utt-id> <path-to-mix-wav>``
- ``segments``         optional: ``<seg-id> <reco-id> <t-start> <t-end>``
- ``feats_train.scp`` / ``feats_test.scp``  ``<utt-id> <path-to-npz>``
- ``utt2num_spk``      ``<utt-id> <num-speakers>``

Order matters: the readers keep the file's order.
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
    """Write ``key value`` lines to a name of this process's own, then
    rename it into place: a reader (another rank of a data-parallel run
    caching ``utt2num_samples``) finds the whole file or none."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        for key, value in entries:
            f.write(f"{key} {value}\n")
    os.replace(tmp, path)


def read_utt2num_spk(path: str) -> dict[str, int]:
    """utt2num_spk as a dict."""
    return {k: int(v) for k, v in read_scp(path)}


def write_utt2num_spk(path: str, mapping) -> None:
    items = mapping.items() if isinstance(mapping, dict) else mapping
    write_scp(path, ((k, str(v)) for k, v in items))


def read_segments(path: str) -> dict[str, list[tuple[str, float, float]]]:
    """A segments file grouped by recording: {reco_id: [(seg_id, t_start,
    t_end), ...]}, in file order within each recording."""
    segs: dict[str, list[tuple[str, float, float]]] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            seg_id, reco_id, t0, t1 = parts[0], parts[1], float(parts[2]), float(parts[3])
            segs.setdefault(reco_id, []).append((seg_id, t0, t1))
    return segs


def source_wavs_for_mix(mix_path: str) -> list[str]:
    """The mixture and source wavs of a mixture path: the corpus layout is
    ``.../mix/<utt>.wav`` with sibling directories ``s1/``, ``s2/``, ...
    holding the sources, so globbing ``/mix/`` -> ``/*/`` and sorting gives
    ``[mix, s1, s2, ...]`` ("mix" sorts before "s*")."""
    return sorted(glob.glob(mix_path.replace("/mix/", "/*/")))
