"""The benchmark's reader of the committed flax weight files
(``*.msgpack.gz``): a small msgpack decoder, so that neither ``msgpack``
nor ``flax`` nor any package of the repository is imported to read them.

Flax packs every ndarray as msgpack ExtType 1 whose payload is a msgpack
``(shape, dtype_name, raw_bytes)`` triple (3: a numpy scalar, same payload).
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path

import numpy as np

__all__ = ["load_tree"]

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    """Sequential msgpack decoder over one bytes buffer."""

    def __init__(self, data, raw=False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n):
        out = self.data[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack stream")
        self.pos += n
        return out

    def unpack(self, fmt):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self, n):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, code, n):
        payload = bytes(self.take(n))
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, dtype, buf = _Reader(payload, raw=True).value()
            if isinstance(dtype, bytes):
                dtype = dtype.decode()
            arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
            return arr[()] if code == _EXT_NPSCALAR else arr
        raise ValueError(f"unsupported msgpack ext type {code}")

    def value(self):
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.mapping(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        fixed = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
                 0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in fixed:
            return self.unpack(fixed[b])
        lengths = {0xD9: "B", 0xDA: "H", 0xDB: "I"}
        if b in lengths:
            return self.string(self.unpack(lengths[b]))
        bins = {0xC4: "B", 0xC5: "H", 0xC6: "I"}
        if b in bins:
            return bytes(self.take(self.unpack(bins[b])))
        if b in (0xDC, 0xDD):
            n = self.unpack("H" if b == 0xDC else "I")
            return [self.value() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.mapping(self.unpack("H" if b == 0xDE else "I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            code = self.unpack("b")
            return self.ext(code, fixext[b])
        exts = {0xC7: "B", 0xC8: "H", 0xC9: "I"}
        if b in exts:
            n = self.unpack(exts[b])
            return self.ext(self.unpack("b"), n)
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def mapping(self, n):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def load_tree(path):
    """A gzipped flax weight file → nested dict of numpy arrays (the
    ``params`` level removed when present)."""
    r = _Reader(gzip.decompress(Path(path).read_bytes()))
    tree = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"{path}: {len(r.data) - r.pos} trailing bytes")
    return tree.get("params", tree)
