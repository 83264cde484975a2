"""Host-side input pipeline: npz features -> padded batches on the device.

The counterpart of speech_separation_tpu/train/data.py, for npz feature
files (the packed cache and the native loader of the JAX package are not
ported; they give the same arrays):

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
- the collation is the caller's to choose: npz features here, or waveforms
  (train/wav_data.collate_wav_batch).

Feature files are the reference's npz format: for training, key ``mix``
plus ``s1``..``sN``, magnitudes of shape (freq, time), a file without
sources mapping source 1 to the mixture; for test, key ``mix``, the complex
spectrum (eval/infer.generate_masks reads it).
"""

from __future__ import annotations

import dataclasses
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
    bucketing reads the first), else None."""

    def __init__(self, data_dir: str, kind: str = "train"):
        if kind not in ("train", "test"):
            raise ValueError(f"kind must be 'train' or 'test', got {kind!r}")
        self.kind = kind
        self.entries = read_scp(os.path.join(data_dir, f"feats_{kind}.scp"))
        if not self.entries:
            raise ValueError(f"empty feats_{kind}.scp in {data_dir}")
        self.num_frames = self._per_utt(data_dir, "utt2num_frames")
        self.num_spks = self._per_utt(data_dir, "utt2num_spk")

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

    def load(self, idx: int) -> dict:
        """Train: {'mix': (T, F) float32, 'sources': (S, T, F) float32,
        'name'}; test: {'mix': (T, F) float32 magnitude, 'spec': (F, T)
        complex64, 'name'}."""
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


def make_device_batch(samples: list[dict], plan: BatchPlan,
                      pad_rows_to: int | None = None) -> dict:
    """Collate loaded samples into padded numpy arrays: {'mix': (B, T, F),
    'lengths': (B,) int32, 'row_mask': (B,) float32, 'names'}, plus
    'sources' (B, S, T, F) when the samples have sources (training
    features); B is ``pad_rows_to`` (default the plan's batch size) and T
    the longest length rounded up to time_pad_multiple."""
    B = pad_rows_to or plan.batch_size
    if len(samples) > B:
        raise ValueError(f"{len(samples)} samples for a batch of {B}")
    F = samples[0]["mix"].shape[1]
    S = max(s["sources"].shape[0] for s in samples) if "sources" in samples[0] else 0
    T = _round_up(max(s["mix"].shape[0] for s in samples), plan.time_pad_multiple)
    mix = np.zeros((B, T, F), np.float32)
    sources = np.zeros((B, S, T, F), np.float32) if S else None
    lengths = np.zeros((B,), np.int32)
    row_mask = np.zeros((B,), np.float32)
    names = []
    for i, s in enumerate(samples):
        t = s["mix"].shape[0]
        mix[i, :t] = s["mix"]
        if S:
            sources[i, :s["sources"].shape[0], :t] = s["sources"]
        lengths[i] = t
        row_mask[i] = 1.0
        names.append(s.get("name", str(i)))
    out = {"mix": mix, "lengths": lengths, "row_mask": row_mask, "names": names}
    if S:
        out["sources"] = sources
    return out


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
    return lambda idxs: make_device_batch([dataset.load(i) for i in idxs], plan)


def iter_batches(dataset, plan: BatchPlan, epoch: int, shuffle: bool = True,
                 collate_fn=None, transfer_fn=None, num_spks=None):
    """Yield one epoch's collated batches (``collate_fn(idxs)``, by default
    npz features padded by ``make_device_batch``), loaded and handed to
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
