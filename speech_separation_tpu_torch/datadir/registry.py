"""Dataset registry: dataset names to corpus wav roots.

The port's own copy of speech_separation_tpu/datadir/registry.py. A corpus
root holds the ``mix/ s1/ s2/ ...`` subdirectories. The registry is filled
from

1. a JSON file (``id_lists/path.json`` by default) of
   ``{"<dataset>": "<corpus-root>"}``;
2. the ``SEPSEP_WAV_DIR_<DATASET>`` environment variables, which win;
3. ``register``.

A dataset whose name starts with ``combo`` is assembled from the
utterances of the constituent sets in ``COMBO_SOURCE_SETS`` (datadir/
prepare.py).
"""

from __future__ import annotations

import json
import os

# the constituent sets a combo* dataset draws from
COMBO_SOURCE_SETS = (
    "wsj_tr", "chime5_ct_train", "chime5_U01_train",
    "mixer6_CH02_tr", "mixer6_CH09_tr",
)

# dataset names of the reference recipe
KNOWN_DATASETS = (
    "wsj_cv", "wsj_tr", "wsj_tt",
    "chime5_ct_dev", "chime5_ct_train",
    "chime5_U01_dev", "chime5_U01_train",
    "mixer6_CH02_cv", "mixer6_CH02_tr", "mixer6_CH02_tr_100k", "mixer6_CH02_tt",
    "mixer6_CH09_cv", "mixer6_CH09_tr", "mixer6_CH09_tr_100k", "mixer6_CH09_tt",
)

ENV_PREFIX = "SEPSEP_WAV_DIR_"


class DatasetRegistry:
    def __init__(self, mapping: dict[str, str] | None = None):
        self._map: dict[str, str] = dict(mapping or {})

    @classmethod
    def load(cls, json_path: str | None = None) -> "DatasetRegistry":
        """A registry from the JSON file (if present) plus the environment."""
        mapping: dict[str, str] = {}
        if json_path and os.path.isfile(json_path):
            with open(json_path) as f:
                mapping.update(json.load(f))
        for key, value in os.environ.items():
            if key.startswith(ENV_PREFIX):
                mapping[key[len(ENV_PREFIX):].lower()] = value
        return cls(mapping)

    def register(self, dataset: str, wav_root: str) -> None:
        self._map[dataset] = wav_root

    def wav_root(self, dataset: str) -> str:
        try:
            return self._map[dataset]
        except KeyError:
            raise KeyError(
                f"Dataset {dataset!r} is not registered. Add it to the "
                f"registry JSON or set {ENV_PREFIX}{dataset.upper()}. "
                f"Known reference datasets: {', '.join(KNOWN_DATASETS)}"
            ) from None

    def mix_dir(self, dataset: str) -> str:
        """The directory of the mixture wavs (<root>/mix/)."""
        return os.path.join(self.wav_root(dataset), "mix")

    def __contains__(self, dataset: str) -> bool:
        return dataset in self._map

    def datasets(self) -> list[str]:
        return sorted(self._map)
