"""Host-side input pipeline: npz features -> padded batches on the device.

The counterpart of speech_separation_tpu/train/data.py:

- utterances are shuffled per epoch from ``seed * 100003 + epoch`` and
  grouped into fixed-size batches, optionally sorted by length first, in
  the same order as the JAX package, so both see the same batches; for RSH
  the batches are also grouped by speaker count (one S per batch), or, in
  the reference's mixed batching, each batch is split into speaker-count
  sub-batches (``collate_mixed_batch``);
- every batch is padded: time up to a multiple of ``time_pad_multiple`` and
  rows up to the batch size with dummy rows (``row_mask`` 0);
- a collate thread loads and pads batches ahead of the consumer, and a
  second thread hands them to the caller's transfer function (the trainer's
  copies pinned buffers to the card on a side stream), so host work and the
  host-to-device copy overlap the device's compute; for training one such
  loader spans all the epochs (``iter_epochs``), so the next epoch's first
  batches are ready before the current epoch ends;
- a training dataset collates in the first of three ways open to it, and
  logs which once (``FeatureDataset.collation``): ``cache``, preadv copies
  out of a packed feature cache (train/feature_cache.py) in the cache's
  dtype; ``native``, each npz member inflated by the C++ runtime straight
  into the padded batch (utils/native.py; needs ``utt2num_frames`` and
  ``utt2num_spk``); ``numpy``, np.load and a copy. The three give the same
  float32 batches bit for bit; a float16 cache gives float16 batches;
- the collation is the caller's to choose: npz features here, or waveforms
  (train/wav_data.collate_wav_batch).

Feature files are the reference's npz format: for training, key ``mix``
plus ``s1``..``sN``, magnitudes of shape (freq, time), a file without
sources mapping source 1 to the mixture; for test, key ``mix``, the complex
spectrum (eval/infer.generate_masks reads it).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import queue
import threading

import numpy as np

from ..datadir.scp import read_scp

# batches each producer thread keeps ready ahead of its consumer
PREFETCH = 2

def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class FeatureDataset:
    """Indexable view over a data dir's ``feats_train.scp`` (``kind``
    "train") or ``feats_test.scp`` ("test"). ``num_frames`` and
    ``num_spks`` hold each utterance's frame and speaker count when the dir
    has ``utt2num_frames`` / ``utt2num_spk`` for all of them (length
    bucketing reads the first), else None.

    With ``copy_location`` the feature files are first staged there
    (datadir/stage.stage_scp_data, the reference's --train-copy-location)
    and read from there. A training dataset's ``collation`` is "cache",
    "native" or "numpy" (module docstring), logged once through ``log``."""

    def __init__(self, data_dir: str, kind: str = "train", copy_location: str = "",
                 log=print):
        if kind not in ("train", "test"):
            raise ValueError(f"kind must be 'train' or 'test', got {kind!r}")
        self.kind = kind
        self.entries = read_scp(os.path.join(data_dir, f"feats_{kind}.scp"))
        if not self.entries:
            raise ValueError(f"empty feats_{kind}.scp in {data_dir}")
        if copy_location:
            from ..datadir.stage import stage_scp_data
            staged = stage_scp_data(os.path.join(data_dir, f"feats_{kind}.scp"),
                                    copy_location, log=log)
            self.entries = [(utt, staged.get(path, path)) for utt, path in self.entries]
        self.cache = None
        if kind == "train" and not copy_location:
            from .feature_cache import open_cache
            self.cache = open_cache(data_dir, kind)
        if self.cache is not None:
            self.num_frames = self.cache.num_frames
            self.num_spks = self.cache.num_spk
        else:
            self.num_frames = self._per_utt(data_dir, "utt2num_frames")
            self.num_spks = self._per_utt(data_dir, "utt2num_spk")
        self.collation = "numpy"
        if kind == "train":
            self.collation, how = self._fastest_collation()
            log(f"feature collation for {data_dir}: {self.collation}, {how}")

    def _fastest_collation(self) -> tuple[str, str]:
        """(collation, how it reads): the cache, else the native loader where
        the per-utterance counts are known, else numpy."""
        from ..utils import native
        if self.cache is not None:
            return "cache", f"packed cache {self.cache.bin_path} ({self.cache.dtype.name})"
        if self.num_frames is None or self.num_spks is None:
            return "numpy", "np.load (no utt2num_frames/utt2num_spk)"
        if native.available():
            return "native", "npz members inflated into the batch by csrc/sepio.cpp"
        return "numpy", f"np.load (native loader {native.status()})"

    def _per_utt(self, data_dir: str, name: str) -> np.ndarray | None:
        path = os.path.join(data_dir, name)
        if not os.path.isfile(path):
            return None
        values = {k: int(v) for k, v in read_scp(path)}
        if not all(utt in values for utt, _ in self.entries):
            return None
        return np.asarray([values[utt] for utt, _ in self.entries], np.int32)

    def __len__(self):
        return len(self.entries)

    def utt_id(self, idx: int) -> str:
        return self.entries[idx][0]

    @functools.cached_property
    def feat_dim(self) -> int:
        if self.cache is not None:
            return self.cache.feat_dim
        with np.load(self.entries[0][1]) as feat:
            return int(feat["mix"].shape[0])

    def load(self, idx: int) -> dict:
        """Train: {'mix': (T, F) float32, 'sources': (S, T, F) float32,
        'name'}; test: {'mix': (T, F) float32 magnitude, 'spec': (F, T)
        complex64, 'name'}."""
        if self.cache is not None:
            return self.cache.load(idx)
        utt, path = self.entries[idx]
        with np.load(path) as feat:
            if self.kind == "test":
                spec = feat["mix"]
                return {"mix": np.abs(spec).T.astype(np.float32), "spec": spec, "name": utt}
            mix = feat["mix"].T.astype(np.float32)
            src_keys = sorted(k for k in feat.files if k != "mix")
            sources = (np.stack([feat[k].T.astype(np.float32) for k in src_keys])
                       if src_keys else mix[None])
        return {"mix": mix, "sources": sources, "name": utt}


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    batch_size: int = 100
    time_pad_multiple: int = 128
    bucket_by_length: bool = False
    group_by_num_spk: bool = False  # RSH: one speaker count per batch
    seed: int = 0


def plan_batches(dataset, plan: BatchPlan, epoch: int,
                 lengths: np.ndarray | None = None,
                 num_spks: np.ndarray | None = None,
                 shuffle: bool = True) -> list[list[int]]:
    """The epoch's batches as lists of dataset indices; with
    ``plan.group_by_num_spk`` and ``num_spks``, each batch holds utterances
    of one speaker count, the groups in order of first appearance."""
    n = len(dataset)
    rng = np.random.default_rng(plan.seed * 100003 + epoch)
    order = rng.permutation(n) if shuffle else np.arange(n)
    groups: dict[int, list[int]] = {}
    for i in order:
        key = int(num_spks[i]) if plan.group_by_num_spk and num_spks is not None else 0
        groups.setdefault(key, []).append(int(i))
    batches = []
    for idxs in groups.values():
        if plan.bucket_by_length and lengths is not None:
            idxs = sorted(idxs, key=lambda i: int(lengths[i]))
        batches += [idxs[s: s + plan.batch_size] for s in range(0, len(idxs), plan.batch_size)]
    if shuffle and plan.bucket_by_length:
        rng.shuffle(batches)
    return batches


def _pow2_ceil(n: int, cap: int) -> int:
    return min(1 << max(n - 1, 0).bit_length(), cap)


def collate_mixed_batch(dataset: FeatureDataset, idxs: list[int], plan: BatchPlan,
                        num_spks: np.ndarray | None) -> list[dict]:
    """The reference's mixed batch: one shuffled batch split into
    speaker-count sub-batches, in ascending count. Each sub-batch is padded
    on its own: rows to the next power of two (at most the batch size), time
    to time_pad_multiple. The trainer accumulates the sub-batches' gradients
    and takes one optimizer step."""
    samples = {i: dataset.load(i) for i in idxs}
    groups: dict[int, list[int]] = {}
    for i in idxs:
        s = int(num_spks[i]) if num_spks is not None else samples[i]["sources"].shape[0]
        groups.setdefault(s, []).append(i)
    return [make_device_batch([samples[i] for i in groups[s]], plan,
                              pad_rows_to=_pow2_ceil(len(groups[s]), plan.batch_size))
            for s in sorted(groups)]


def padded_batch(n: int, rows: int, frames: int, feat_dim: int, n_src: int,
                 time_pad_multiple: int, dtype=np.float32) -> dict:
    """The zeroed buffers of a padded batch of ``n`` utterances that every
    collation fills: {'mix': (rows, T, F), 'lengths': (rows,) int32,
    'row_mask': (rows,) float32, 1 on the first ``n`` rows, 'names': ``n``
    empty strings}, plus 'sources' (rows, n_src, T, F) when ``n_src``; T is
    ``frames`` rounded up to ``time_pad_multiple``."""
    if n > rows:
        raise ValueError(f"{n} samples for a batch of {rows}")
    T = _round_up(frames, time_pad_multiple)
    out = {"mix": np.zeros((rows, T, feat_dim), dtype), "lengths": np.zeros((rows,), np.int32),
           "row_mask": np.zeros((rows,), np.float32), "names": [""] * n}
    out["row_mask"][:n] = 1.0
    if n_src:
        out["sources"] = np.zeros((rows, n_src, T, feat_dim), dtype)
    return out


def make_device_batch(samples: list[dict], plan: BatchPlan,
                      pad_rows_to: int | None = None) -> dict:
    """Collate loaded samples into padded numpy arrays (padded_batch's, in
    float32), 'sources' when the samples have sources (training features);
    the rows are ``pad_rows_to`` (default the plan's batch size)."""
    S = max(s["sources"].shape[0] for s in samples) if "sources" in samples[0] else 0
    out = padded_batch(len(samples), pad_rows_to or plan.batch_size,
                       max(s["mix"].shape[0] for s in samples), samples[0]["mix"].shape[1],
                       S, plan.time_pad_multiple)
    for i, s in enumerate(samples):
        t = s["mix"].shape[0]
        out["mix"][i, :t] = s["mix"]
        if S:
            out["sources"][i, :s["sources"].shape[0], :t] = s["sources"]
        out["lengths"][i] = t
        out["names"][i] = s.get("name", str(i))
    return out


def collate_native(dataset: FeatureDataset, idxs: list[int], plan: BatchPlan) -> dict:
    """make_device_batch's batch of a training dataset's ``idxs``, each npz
    member inflated by the native runtime straight into its padded row (the
    batch is bit-equal to the numpy path's). Needs the dataset's
    ``num_frames`` and ``num_spks``."""
    from ..utils import native
    n_spk = [max(1, int(dataset.num_spks[i])) for i in idxs]
    out = padded_batch(len(idxs), plan.batch_size,
                       max(int(dataset.num_frames[i]) for i in idxs), dataset.feat_dim,
                       max(n_spk), plan.time_pad_multiple)
    mix, sources = out["mix"], out["sources"]
    for row, i in enumerate(idxs):
        utt, path = dataset.entries[i]
        out["lengths"][row], _ = native.load_npz_2d_transposed(path, "mix", mix[row])
        out["names"][row] = utt
        for s in range(n_spk[row]):
            try:
                native.load_npz_2d_transposed(path, f"s{s + 1}", sources[row, s])
            except IOError:
                if s:
                    raise
                sources[row, 0] = mix[row]      # no sources: source 1 is the mixture
    return out


def collate(dataset: FeatureDataset, idxs: list[int], plan: BatchPlan) -> dict:
    """The padded batch of ``idxs`` by the dataset's ``collation``."""
    if dataset.collation == "cache":
        return dataset.cache.collate(idxs, plan.time_pad_multiple, pad_rows_to=plan.batch_size)
    if dataset.collation == "native":
        return collate_native(dataset, idxs, plan)
    return make_device_batch([dataset.load(i) for i in idxs], plan)


class _EpochEnd:
    """The marker between two epochs' batches in a loader that spans epochs."""


_EPOCH_END = _EpochEnd()


def _pipeline(items, collate_fn, transfer_fn=None):
    """An iterator of ``transfer_fn(collate_fn(item))`` for each item, in
    order, the collation in one background thread and the transfer in a
    second one, each ``PREFETCH`` items ahead of its consumer. The threads
    start at once, not at the first ``next``. Epoch-end markers pass through
    untouched; a loader error is raised on the consumer's side."""
    done = object()

    def produce(source, out, fn):
        try:
            for item in source:
                out.put(item if item is _EPOCH_END else fn(item))
        except Exception as e:  # surface loader errors on the consumer side
            out.put(e)
            return
        out.put(done)

    def drain(q):
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, Exception):
                raise item
            yield item

    collated: queue.Queue = queue.Queue(maxsize=PREFETCH)
    threading.Thread(target=produce, daemon=True,
                     args=(items, collated, collate_fn)).start()
    out = collated
    if transfer_fn is not None:
        out = queue.Queue(maxsize=PREFETCH)
        threading.Thread(target=produce, daemon=True,
                         args=(drain(collated), out, transfer_fn)).start()
    return drain(out)


def _default_collate(dataset: FeatureDataset, plan: BatchPlan):
    return lambda idxs: collate(dataset, idxs, plan)


def iter_batches(dataset, plan: BatchPlan, epoch: int, shuffle: bool = True,
                 collate_fn=None, transfer_fn=None, num_spks=None):
    """Yield one epoch's collated batches (``collate_fn(idxs)``, by default
    the dataset's own ``collate``), loaded and handed to
    ``transfer_fn`` in background threads."""
    batches = plan_batches(dataset, plan, epoch, lengths=dataset.num_frames,
                           num_spks=num_spks, shuffle=shuffle)
    yield from _pipeline(batches, collate_fn or _default_collate(dataset, plan), transfer_fn)


def iter_epochs(dataset, plan: BatchPlan, epochs, collate_fn=None, transfer_fn=None,
                num_spks=None):
    """An iterator of ``(epoch, batches)`` for each of ``epochs``,
    ``batches`` iterating over that epoch's shuffled batches in
    ``plan_batches`` order. One loader spans all the epochs (each epoch's
    plan is fixed by its seed, so it can be made ahead), and its threads
    start when this is called: they collate and transfer the first epoch's
    first batches while the caller is still setting up (the trainer builds
    its model meanwhile), and the next epoch's first batches while the
    caller runs the current epoch's last steps, its CV pass and its
    checkpoint, so no epoch starts with the card waiting for its input.
    Each epoch's iterator must be consumed to its end before the next one is
    taken."""
    epochs = list(epochs)

    def items():
        for e in epochs:
            yield from plan_batches(dataset, plan, e, lengths=dataset.num_frames,
                                    num_spks=num_spks)
            yield _EPOCH_END

    stream = _pipeline(items(), collate_fn or _default_collate(dataset, plan), transfer_fn)

    def one_epoch():
        for item in stream:
            if item is _EPOCH_END:
                return
            yield item

    return ((e, one_epoch()) for e in epochs)
