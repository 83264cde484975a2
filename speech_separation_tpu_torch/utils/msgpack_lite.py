"""A msgpack decoder for the subset that flax.serialization writes, on
``struct`` and numpy alone (the port needs neither msgpack nor flax).

Decoded: nil, bool, every int and float width, str, bin, array and map of
every length class, and two ext types: 1, an ndarray, whose data is itself
msgpack ``[shape, dtype name, C-order bytes]``, and 3, a numpy scalar in the
same form. Maps decode to dicts, arrays to lists, str to str (utf-8), bin to
bytes. Any other ext type (flax's 2, a Python complex, among them) raises
with its type code. ``unchunk`` reassembles the ``__msgpack_chunked_array__``
dicts into which flax splits arrays over its MAX_CHUNK_SIZE (2**30 bytes).

Array leaves are read-only, as flax's are. A ``bfloat16`` leaf (numpy has
no such dtype) is read as its 16-bit patterns and widened to float32,
which is exact; the JAX package's checkpoints hold float32 parameters and
optimizer moments, so it does not occur in them.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


def _dtype_array(buf, name: str) -> np.ndarray:
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.uint16)
        return (bits.astype(np.uint32) << 16).view(np.float32)
    return np.frombuffer(buf, dtype=np.dtype(name))


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"msgpack: truncated at byte {self.pos} (wanted {n} more)")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        scalar = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                  0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in scalar:
            return self.unpack(scalar[b])
        sized = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
                 0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
                 0xDC: (">H", "array"), 0xDD: (">I", "array"),
                 0xDE: (">H", "map"), 0xDF: (">I", "map"),
                 0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.str(n)
            if kind == "array":
                return [self.value() for _ in range(n)]
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise ValueError(f"msgpack: byte 0x{b:02x} at {self.pos - 1} starts no value")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack: ext type {code} is not one flax writes for arrays "
                             f"(ndarray {EXT_NDARRAY}, numpy scalar {EXT_NPSCALAR})")
        inner = _Reader(data)
        shape, name, buf = inner.value()
        if isinstance(name, bytes):
            name = name.decode()
        arr = _dtype_array(buf if isinstance(buf, (bytes, memoryview)) else bytes(buf), name)
        arr = arr.reshape(shape)
        return arr[()] if code == EXT_NPSCALAR else arr


def unpackb(data) -> object:
    """Decode one msgpack value that fills ``data`` (bytes-like)."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} bytes after the value")
    return out


def unchunk(tree):
    """Reassemble flax's chunked arrays ({'__msgpack_chunked_array__': True,
    'shape': {'0': ...}, 'chunks': {'0': ...}}) anywhere in a decoded tree."""
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: unchunk(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [unchunk(v) for v in tree]
    return tree
