"""Python interface to the host rANS range coder (batch entry points).

Port of ``pcc_geo_cnn_v2_tpu/coding/range_coder.py`` over the port's own
copy of the C++ coder (``native/range_coder.cpp``, built with g++ at first
use). Each element carries an index selecting a CDF row; symbols outside a
row's regular buckets are escape-coded with ``overflow_width``-bit units.
Streams are byte-identical to the JAX package's for identical symbols and
tables.
"""

from __future__ import annotations

import ctypes

import numpy as np

from pcc_geo_cnn_v2_tpu_torch.models.entropy import CdfTable
from pcc_geo_cnn_v2_tpu_torch.native import load_host_lib

__all__ = ["encode_batch", "decode_batch"]

_OVERFLOW_WIDTH = 4


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
