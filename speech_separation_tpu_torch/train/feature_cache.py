"""The packed feature cache: repeated-epoch training input at memcpy speed.

The port's counterpart of speech_separation_tpu/train/feature_cache.py, in
the same on-disk format (``SEPSEP_FEATURE_CACHE_V1``), so a cache that
either package packed is read by the other. ``pack_features`` packs a data
dir's ``feats_train.scp`` (one compressed npz per utterance, inflated every
epoch otherwise) into one flat file; training then reads each batch with one
``preadv`` per utterance straight into the padded batch buffers.

Layout:

- ``<cache>.bin``: per utterance, the arrays ``mix, s1..sS`` one after the
  other, each stored (time, freq) C-contiguous, the layout of a padded
  batch row, so collation is ``buf[i, :T] = record[k]``;
- ``<cache>.idx.npz``: the magic, utterance ids, byte offsets, frame and
  speaker counts, feat_dim and the storage dtype;
- ``<data_dir>/feats_<kind>.cache``: a one-line pointer naming the bin, so
  the data dir stays metadata only.

The storage dtype is float32 by default; float16 halves the bytes on disk,
in the page cache and across the bus (the batches keep the cache's dtype
and the training step upcasts them on the card), at about 1e-3 relative
error on the magnitudes. Train kind only: test features are complex spectra
read once per evaluation.
"""

from __future__ import annotations

import os
import warnings

import numpy as np

from ..datadir.scp import read_scp
from .data import padded_batch

_MAGIC = "SEPSEP_FEATURE_CACHE_V1"


def pointer_path(data_dir: str, kind: str) -> str:
    return os.path.join(data_dir, f"feats_{kind}.cache")


def pack_features(data_dir: str, kind: str = "train", cache_path: str | None = None,
                  dtype: str = "float32", log=print) -> str:
    """Pack every utterance of ``feats_<kind>.scp`` into one flat cache and
    write the pointer file into the data dir; returns the bin's path.
    ``cache_path`` defaults to ``<feat_dir>/feats_<kind>.cache.bin``, the
    feat_dir being the directory of the first feature file."""
    if kind != "train":
        raise ValueError("feature cache supports kind='train' only "
                         "(test features are read once per eval)")
    dt = np.dtype(dtype)
    if dt not in (np.dtype(np.float32), np.dtype(np.float16)):
        raise ValueError(f"unsupported cache dtype {dtype}")
    entries = read_scp(os.path.join(data_dir, f"feats_{kind}.scp"))
    if not entries:
        raise ValueError(f"empty feats_{kind}.scp in {data_dir}")
    if cache_path is None:
        cache_path = os.path.join(os.path.dirname(entries[0][1]), f"feats_{kind}.cache.bin")

    ids, offsets, n_frames, n_spk = [], [], [], []
    feat_dim = None
    off = 0
    tmp = cache_path + ".partial"
    with open(tmp, "wb") as out:
        for utt, path in entries:
            with np.load(path) as feat:
                mix = np.ascontiguousarray(feat["mix"].T, dtype=dt)      # (T, F)
                src_keys = sorted(k for k in feat.files if k != "mix")
                # a file without sources maps source 1 to the mixture
                srcs = ([np.ascontiguousarray(feat[k].T, dtype=dt) for k in src_keys]
                        if src_keys else [mix])
            if feat_dim is None:
                feat_dim = mix.shape[1]
            elif mix.shape[1] != feat_dim:
                raise ValueError(f"{utt}: feat_dim {mix.shape[1]} != {feat_dim}")
            ids.append(utt)
            offsets.append(off)
            n_frames.append(mix.shape[0])
            n_spk.append(len(srcs))
            for a in (mix, *srcs):
                if a.shape != mix.shape:
                    raise ValueError(f"{utt}: source shape {a.shape} != mix {mix.shape}")
                out.write(a.tobytes())
                off += a.nbytes
    os.replace(tmp, cache_path)

    np.savez(cache_path + ".idx", magic=_MAGIC, ids=np.asarray(ids),
             offsets=np.asarray(offsets, np.int64),
             num_frames=np.asarray(n_frames, np.int32),
             num_spk=np.asarray(n_spk, np.int32),
             feat_dim=np.int32(feat_dim), dtype=str(dt.name))
    ptr = pointer_path(data_dir, kind)
    with open(ptr + ".partial", "w") as f:
        f.write(cache_path + "\n")
    os.replace(ptr + ".partial", ptr)
    log(f"packed {len(ids)} utterances ({off / 1e9:.2f} GB, {dt.name}) -> {cache_path}")
    return cache_path


class FeatureCache:
    """A packed cache, read with ``pread``/``preadv`` (one bulk read a
    record, not a memory map, whose page faults cost more); the file stays
    open until ``close``."""

    def __init__(self, data_dir: str, kind: str = "train"):
        with open(pointer_path(data_dir, kind)) as f:
            self.bin_path = f.read().strip()
        with np.load(self.bin_path + ".idx.npz") as idx:
            if str(idx["magic"]) != _MAGIC:
                raise ValueError(f"bad cache magic in {self.bin_path}.idx.npz")
            self.ids = [str(u) for u in idx["ids"]]
            self.offsets = idx["offsets"]
            self.num_frames = idx["num_frames"]
            self.num_spk = idx["num_spk"]
            self.feat_dim = int(idx["feat_dim"])
            self.dtype = np.dtype(str(idx["dtype"]))
        self._fd = os.open(self.bin_path, os.O_RDONLY)
        size = os.fstat(self._fd).st_size
        expect = int(self.offsets[-1]) + self._record_bytes(len(self.ids) - 1)
        if size != expect:
            self.close()
            raise ValueError(f"cache {self.bin_path} is {size} bytes, index expects "
                             f"{expect} (stale or truncated cache)")

    def _record_bytes(self, i: int) -> int:
        return ((1 + int(self.num_spk[i])) * int(self.num_frames[i]) * self.feat_dim
                * self.dtype.itemsize)

    def close(self) -> None:
        if getattr(self, "_fd", None) is not None:
            os.close(self._fd)
            self._fd = None

    def __del__(self):
        try:
            self.close()
        except Exception:    # at interpreter exit the os module may be gone
            pass

    def __len__(self):
        return len(self.ids)

    def record(self, i: int) -> np.ndarray:
        """(1+S, T, F) array of one utterance, the mixture first, in the
        cache's dtype."""
        nbytes = self._record_bytes(i)
        buf = os.pread(self._fd, nbytes, int(self.offsets[i]))
        if len(buf) != nbytes:
            raise IOError(f"short read at record {i} of {self.bin_path}")
        return np.frombuffer(buf, dtype=self.dtype).reshape(
            1 + int(self.num_spk[i]), int(self.num_frames[i]), self.feat_dim)

    def load(self, i: int) -> dict:
        """FeatureDataset.load's contract (train kind), in float32."""
        rec = np.asarray(self.record(i), dtype=np.float32)
        return {"mix": rec[0], "sources": rec[1:], "name": self.ids[i]}

    def collate(self, idxs: list[int], time_pad_multiple: int, pad_rows_to: int) -> dict:
        """The padded batch of ``idxs`` (data.padded_batch's, ``pad_rows_to``
        rows) read straight into its buffers, in the cache's dtype."""
        out = padded_batch(len(idxs), pad_rows_to, max(int(self.num_frames[i]) for i in idxs),
                           self.feat_dim, max(int(self.num_spk[i]) for i in idxs),
                           time_pad_multiple, self.dtype)
        mix, sources = out["mix"], out["sources"]
        # one preadv a record scatters its bytes into the mixture's row and
        # each source's row; records in file order, for the readahead
        for row in sorted(range(len(idxs)), key=lambda r: int(self.offsets[idxs[r]])):
            i = idxs[row]
            t = int(self.num_frames[i])
            bufs = [mix[row, :t]] + [sources[row, s, :t] for s in range(int(self.num_spk[i]))]
            if os.preadv(self._fd, bufs, int(self.offsets[i])) != self._record_bytes(i):
                raise IOError(f"short read at record {i} of {self.bin_path}")
            out["lengths"][row] = t
            out["names"][row] = self.ids[i]
        return out


def open_cache(data_dir: str, kind: str) -> FeatureCache | None:
    """The data dir's FeatureCache if its pointer exists and the cache
    matches ``feats_<kind>.scp``, else None. A cache that does not open (a
    moved bin, a stale or truncated index) or lists other utterances is
    skipped with a warning, and the npz files are read."""
    if not os.path.isfile(pointer_path(data_dir, kind)):
        return None
    try:
        cache = FeatureCache(data_dir, kind)
    except (OSError, ValueError, KeyError) as e:
        warnings.warn(f"ignoring unusable feature cache for {data_dir}: {e}")
        return None
    scp_ids = [u for u, _ in read_scp(os.path.join(data_dir, f"feats_{kind}.scp"))]
    if cache.ids != scp_ids:
        cache.close()
        warnings.warn(f"feature cache for {data_dir} is stale "
                      "(utterance list changed); re-run pack-features")
        return None
    return cache
