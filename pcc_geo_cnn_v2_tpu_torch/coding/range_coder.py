"""Python interface to the host rANS range coder, with a pure-Python twin.

Port of ``pcc_geo_cnn_v2_tpu/coding/range_coder.py`` over the port's own
copy of the C++ coder (``native/range_coder.cpp``, built with g++ at first
use; a failed build raises, there is no fallback). Each element carries an
index selecting a CDF row; symbols outside a row's regular buckets are
escape-coded with ``overflow_width``-bit units. Streams are byte-identical
to the JAX package's for identical symbols and tables.

The codec codes whole clouds with the batch calls (:func:`encode_batch`,
:func:`decode_batch`); :func:`encode` / :func:`decode` code one block.
:func:`encode_py` / :func:`decode_py` are the executable specification the
tests hold the library against; nothing else calls them.
"""

from __future__ import annotations

import ctypes

import numpy as np

from pcc_geo_cnn_v2_tpu_torch.models.entropy import CdfTable
from pcc_geo_cnn_v2_tpu_torch.native import load_host_lib

__all__ = ["encode", "decode", "encode_batch", "decode_batch",
           "encode_py", "decode_py"]

_OVERFLOW_WIDTH = 4
_RANS_L = 1 << 31


def _lib():
    lib = load_host_lib("range_coder")
    if not getattr(lib, "_pcc_typed", False):
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
        c32, c64 = ctypes.c_int32, ctypes.c_int64
        lib.pcc_rc_encode_batch.restype = c64
        lib.pcc_rc_encode_batch.argtypes = [
            i32p, i32p, c32, c64, c64, i32p, c64, i32p, i32p, c32, c32, u8p,
            c64, i64p]
        lib.pcc_rc_encode.restype = c64
        lib.pcc_rc_encode.argtypes = [
            i32p, i32p, c64, i32p, c64, i32p, i32p, c32, c32, u8p, c64]
        lib.pcc_rc_decode_lut.restype = c64
        lib.pcc_rc_decode_lut.argtypes = [
            u8p, c64, i32p, c64, i32p, c64, i32p, i32p, c32, c32, u16p, i32p]
        lib.pcc_rc_decode_lut_batch.restype = c64
        lib.pcc_rc_decode_lut_batch.argtypes = [
            u8p, i64p, i32p, c32, c64, c64, i32p, c64, i32p, i32p, c32, c32,
            u16p, i32p]
        lib._pcc_typed = True
    return lib


def _as_c(table: CdfTable):
    cached = getattr(table, "_c_arrays", None)
    if cached is None:
        cached = (np.ascontiguousarray(table.cdf, np.int32),
                  np.ascontiguousarray(table.cdf_length, np.int32),
                  np.ascontiguousarray(table.offset, np.int32))
        object.__setattr__(table, "_c_arrays", cached)
    return cached


def _get_lut(table: CdfTable):
    """slot → bucket lookup rows (uint16 [rows, 2^precision]), cached."""
    lut = getattr(table, "_slot_lut", None)
    if lut is None:
        cdf, cdf_len, _ = _as_c(table)
        lut = np.empty((cdf.shape[0], 1 << table.precision), np.uint16)
        for r in range(cdf.shape[0]):
            row = cdf[r, :int(cdf_len[r])]
            lut[r] = np.repeat(np.arange(len(row) - 1, dtype=np.uint16),
                               np.diff(row))
        object.__setattr__(table, "_slot_lut", lut)
    return lut


def encode(symbols, indexes, table: CdfTable,
           overflow_width=_OVERFLOW_WIDTH) -> bytes:
    """Range-encode one block's int32 ``symbols`` (any shape) against the
    CDF rows ``indexes`` (same size)."""
    symbols = np.ascontiguousarray(np.asarray(symbols, np.int32).ravel())
    indexes = np.ascontiguousarray(np.asarray(indexes, np.int32).ravel())
    if symbols.shape != indexes.shape:
        raise ValueError(f"{symbols.size} symbols, {indexes.size} indexes")
    cdf, cdf_len, offset = _as_c(table)
    capacity = 16 + symbols.size * 16  # worst case: deep escapes
    out = np.empty(capacity, np.uint8)
    n = _lib().pcc_rc_encode(symbols, indexes, symbols.size, cdf,
                             cdf.shape[1], cdf_len, offset, table.precision,
                             overflow_width, out, capacity)
    if n < 0:
        raise RuntimeError("range encoder overflow")
    return out[:n].tobytes()


def decode(data: bytes, indexes, table: CdfTable,
           overflow_width=_OVERFLOW_WIDTH) -> np.ndarray:
    """Inverse of :func:`encode`: int32 symbols shaped like ``indexes``."""
    indexes = np.asarray(indexes, np.int32)
    flat = np.ascontiguousarray(indexes.ravel())
    cdf, cdf_len, offset = _as_c(table)
    buf = np.frombuffer(data, np.uint8)
    if buf.size == 0:
        buf = np.empty(1, np.uint8)  # valid pointer for ctypes
    out = np.empty(flat.size, np.int32)
    rc = _lib().pcc_rc_decode_lut(buf, len(data), flat, flat.size, cdf,
                                  cdf.shape[1], cdf_len, offset,
                                  table.precision, overflow_width,
                                  _get_lut(table), out)
    if rc != 0:
        raise ValueError("malformed range-coded stream")
    return out.reshape(indexes.shape)


def encode_batch(symbols, indexes, table: CdfTable,
                 overflow_width=_OVERFLOW_WIDTH):
    """Range-encode ``n`` same-shape symbol blocks in one native call.

    :param symbols: [n, ...] array — one stream per leading row.
    :param indexes: one shared row shaped like ``symbols[0]`` or per-stream
        rows shaped like ``symbols``.
    :return: list of n ``bytes``.
    """
    symbols = np.ascontiguousarray(np.asarray(symbols, np.int32))
    n = symbols.shape[0]
    if n == 0:
        return []
    stream_len = int(np.prod(symbols.shape[1:], dtype=np.int64))
    indexes = np.ascontiguousarray(np.asarray(indexes, np.int32))
    shared = indexes.size == stream_len
    assert shared or indexes.size == symbols.size, \
        (indexes.shape, symbols.shape)
    cdf, cdf_len, offset = _as_c(table)
    capacity = 16 * n + symbols.size * 16  # worst case: deep escapes
    out = np.empty(capacity, np.uint8)
    offs = np.empty(n + 1, np.int64)
    total = _lib().pcc_rc_encode_batch(
        symbols.reshape(-1), indexes.reshape(-1), int(shared), n,
        stream_len, cdf, cdf.shape[1], cdf_len, offset, table.precision,
        overflow_width, out, capacity, offs)
    if total < 0:
        raise RuntimeError("range encoder overflow")
    return [out[offs[i]:offs[i + 1]].tobytes() for i in range(n)]


def decode_batch(datas, indexes, table: CdfTable, per_stream,
                 overflow_width=_OVERFLOW_WIDTH) -> np.ndarray:
    """Inverse of :func:`encode_batch`.

    :param per_stream: True when ``indexes`` is [n, *row], False for one
        shared row.
    :return: int32 ``[n, *row_shape]`` symbols.
    """
    n = len(datas)
    indexes = np.asarray(indexes, np.int32)
    row_shape = indexes.shape[1:] if per_stream else indexes.shape
    stream_len = int(np.prod(row_shape, dtype=np.int64))
    if n == 0:
        return np.empty((0,) + tuple(row_shape), np.int32)
    cdf, cdf_len, offset = _as_c(table)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum([len(d) for d in datas], out=offs[1:])
    buf = np.frombuffer(b"".join(datas), np.uint8)
    if buf.size == 0:
        buf = np.empty(1, np.uint8)  # valid pointer for ctypes
    out = np.empty(n * stream_len, np.int32)
    rc = _lib().pcc_rc_decode_lut_batch(
        buf, offs, np.ascontiguousarray(indexes.reshape(-1)),
        int(not per_stream), n, stream_len, cdf, cdf.shape[1], cdf_len,
        offset, table.precision, overflow_width, _get_lut(table), out)
    if rc != 0:
        raise ValueError("malformed range-coded stream")
    return out.reshape((n,) + tuple(row_shape))


# -- pure-Python twin (the specification; tests only) ----------------------


def _events(symbols, indexes, table: CdfTable, w):
    """(start, freq, bits) coding events of every symbol in order: its
    bucket, or the escape bucket followed by ``w``-bit units of the
    zig-zagged overflow with a continuation bit."""
    cont = 1 << w
    for s, r in zip(symbols.tolist(), indexes.tolist()):
        row = table.cdf[r]
        num_regular = int(table.cdf_length[r]) - 2
        b = s - int(table.offset[r])
        if 0 <= b < num_regular:
            yield int(row[b]), int(row[b + 1] - row[b]), table.precision
            continue
        esc = num_regular
        yield int(row[esc]), int(row[esc + 1] - row[esc]), table.precision
        v = ((-b - 1) << 1) if b < 0 else (((b - num_regular) << 1) | 1)
        while True:
            unit = v & (cont - 1)
            v >>= w
            if v:
                unit |= cont
            yield unit, 1, w + 1
            if not v:
                break


def encode_py(symbols, indexes, table: CdfTable,
              overflow_width=_OVERFLOW_WIDTH) -> bytes:
    """:func:`encode` in Python: rANS with a 64-bit state and 32-bit
    renormalization words, events coded in reverse."""
    symbols = np.asarray(symbols, np.int32).ravel()
    indexes = np.asarray(indexes, np.int32).ravel()
    x = _RANS_L
    words = []
    for start, freq, bits in reversed(list(_events(symbols, indexes, table,
                                                   overflow_width))):
        x_max = ((_RANS_L >> bits) << 32) * freq
        while x >= x_max:
            words.append(x & 0xFFFFFFFF)
            x >>= 32
        x = ((x // freq) << bits) + (x % freq) + start
    out = x.to_bytes(8, "little")
    for word in reversed(words):
        out += int(word).to_bytes(4, "little")
    return out


def decode_py(data, indexes, table: CdfTable,
              overflow_width=_OVERFLOW_WIDTH) -> np.ndarray:
    """:func:`decode` in Python."""
    indexes = np.asarray(indexes, np.int32)
    flat = indexes.ravel()
    w = overflow_width
    cont = 1 << w
    x = int.from_bytes(data[:8], "little")
    words = [int.from_bytes(data[8 + 4 * i:12 + 4 * i], "little")
             for i in range((len(data) - 8) // 4)]
    pos = 0

    def advance(start, freq, bits):
        nonlocal x, pos
        x = freq * (x >> bits) + (x & ((1 << bits) - 1)) - start
        while x < _RANS_L:
            x = (x << 32) | words[pos]
            pos += 1

    out = np.empty(flat.size, np.int32)
    for i, r in enumerate(flat.tolist()):
        row = table.cdf[r]
        length = int(table.cdf_length[r])
        num_regular = length - 2
        slot = x & ((1 << table.precision) - 1)
        b = int(np.searchsorted(row[:length], slot, side="right")) - 1
        advance(int(row[b]), int(row[b + 1] - row[b]), table.precision)
        if b == num_regular:
            v = shift = 0
            while True:
                unit = x & (2 * cont - 1)
                advance(unit, 1, w + 1)
                v |= (unit & (cont - 1)) << shift
                shift += w
                if not unit & cont:
                    break
            b = (num_regular + (v >> 1)) if v & 1 else (-(v >> 1) - 1)
        out[i] = b + int(table.offset[r])
    return out.reshape(indexes.shape)
