"""Data-dir preparation: ``data/<set>/wav.scp`` from an id list.

The port's own copy of speech_separation_tpu/datadir/prepare.py. Each id
of ``id_lists/<set>.txt`` maps to ``<wav_root>/mix/<id>.wav``; a ``combo*``
set instead selects its ids, by exact utterance id, out of the prepared
``wav.scp`` of each set in ``COMBO_SOURCE_SETS``.
"""

from __future__ import annotations

import os

from .registry import COMBO_SOURCE_SETS, DatasetRegistry
from .scp import read_scp, write_scp


def read_id_list(id_lists_dir: str, dataset: str) -> list[str]:
    with open(os.path.join(id_lists_dir, dataset + ".txt")) as f:
        return [line.strip() for line in f if line.strip()]


def prepare_data_dir(dataset: str, registry: DatasetRegistry,
                     data_root: str = "data",
                     id_lists_dir: str = "id_lists") -> str:
    """Write data/<dataset>/wav.scp; returns the data dir."""
    out_dir = os.path.join(data_root, dataset)
    os.makedirs(out_dir, exist_ok=True)
    ids = read_id_list(id_lists_dir, dataset)

    if dataset.startswith("combo"):
        wanted = set(ids)
        entries: list[tuple[str, str]] = []
        for source_set in COMBO_SOURCE_SETS:
            src_scp = os.path.join(data_root, source_set, "wav.scp")
            if not os.path.isfile(src_scp):
                raise FileNotFoundError(
                    f"combo dataset {dataset!r} selects from {COMBO_SOURCE_SETS}; "
                    f"prepare {source_set!r} first (missing {src_scp})")
            entries.extend((k, v) for k, v in read_scp(src_scp) if k in wanted)
    else:
        mix_dir = registry.mix_dir(dataset)
        entries = [(utt, os.path.join(mix_dir, utt + ".wav")) for utt in ids]

    write_scp(os.path.join(out_dir, "wav.scp"), entries)
    return out_dir
