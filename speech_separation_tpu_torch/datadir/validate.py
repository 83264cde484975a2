"""Data-dir validation.

The port's own copy of speech_separation_tpu/datadir/validate.py. A data
dir needs ``wav.scp`` or ``segments`` (which then defines the utterances,
and whose recording column must match ``wav.scp``'s keys); every
``feats*.scp``, ``utt2num_spk`` and ``utt2spk`` present must hold the same
utterance keys, in any order. A fault raises ``DataDirError``.
"""

from __future__ import annotations

import glob
import os


class DataDirError(ValueError):
    pass


def _keys(path: str, column: int = 0) -> list[str]:
    with open(path) as f:
        return [line.split()[column] for line in f if line.strip()]


def validate_data_dir(data_dir: str) -> None:
    wav_scp = os.path.join(data_dir, "wav.scp")
    segments = os.path.join(data_dir, "segments")

    if os.path.isfile(segments):
        utt_list = _keys(segments, 0)
        if os.path.isfile(wav_scp):
            if sorted(set(_keys(wav_scp, 0))) != sorted(set(_keys(segments, 1))):
                raise DataDirError(f"{data_dir}: segments does not match wav.scp")
    elif os.path.isfile(wav_scp):
        utt_list = _keys(wav_scp, 0)
    else:
        raise DataDirError(f"{data_dir}: no wav.scp file")

    check_files = sorted(
        os.path.basename(p) for p in glob.glob(os.path.join(data_dir, "feats*.scp"))
    ) + ["utt2num_spk", "utt2spk"]
    for name in check_files:
        path = os.path.join(data_dir, name)
        if os.path.isfile(path):
            keys = _keys(path, 0)
            # the same key set is the invariant; an order that differs
            # (user-assembled dirs, shard merges) is accepted
            if sorted(keys) != sorted(utt_list):
                missing = set(utt_list) - set(keys)
                extra = set(keys) - set(utt_list)
                raise DataDirError(
                    f"{data_dir}: {name} does not match wav.scp "
                    f"({len(missing)} missing, {len(extra)} extra keys)")


def is_valid_data_dir(data_dir: str) -> bool:
    try:
        validate_data_dir(data_dir)
        return True
    except DataDirError:
        return False
