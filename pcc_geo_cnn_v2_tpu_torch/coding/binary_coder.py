"""Context-adaptive binary range coder: the native coder and its Python
twin.

The port's own copy of ``pcc_geo_cnn_v2_tpu/coding/binary_coder.py``. The
built-in octree anchor codes child-occupancy bits with the coder family of
G-PCC's tmc3 (which the reference runs as an external binary, its
``src/mp_run.py:33-41``): an LZMA-style adaptive binary range coder. The
native coder is in ``native/range_coder.cpp`` (the library of the rANS
coder, built with g++ at first use; a failed build raises); the Python
functions below are the executable specification, and the streams of both
are byte-equal to the JAX package's.

Encoding is one call (every (bit, context) pair is known up front);
decoding is stateful, because octree contexts depend on the planes and
levels decoded before, so the decoder is a handle consumed plane by plane.
"""

from __future__ import annotations

import ctypes

import numpy as np

from pcc_geo_cnn_v2_tpu_torch.native import load_host_lib

__all__ = ["abc_encode", "AbcDecoder", "abc_encode_py", "AbcDecoderPy"]

_PROB_BITS = 12
_PROB_INIT = 1 << (_PROB_BITS - 1)
_MOVE_BITS = 5
_TOP = 1 << 24


def _lib():
    lib = load_host_lib("range_coder")
    if not getattr(lib, "_pcc_abc_typed", False):
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.pcc_abc_encode.restype = ctypes.c_int64
        lib.pcc_abc_encode.argtypes = [u8p, i32p, ctypes.c_int64,
                                       ctypes.c_int64, u8p, ctypes.c_int64]
        lib.pcc_abc_dec_new.restype = ctypes.c_void_p
        lib.pcc_abc_dec_new.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64]
        lib.pcc_abc_dec_bits.restype = ctypes.c_int64
        lib.pcc_abc_dec_bits.argtypes = [ctypes.c_void_p, i32p,
                                         ctypes.c_int64, u8p]
        lib.pcc_abc_dec_free.restype = None
        lib.pcc_abc_dec_free.argtypes = [ctypes.c_void_p]
        lib._pcc_abc_typed = True
    return lib


def abc_encode(bits, ctxs, n_ctx: int) -> bytes:
    """Encode ``bits`` (0/1) against adaptive per-context probabilities."""
    bits = np.ascontiguousarray(np.asarray(bits, np.uint8).ravel())
    ctxs = np.ascontiguousarray(np.asarray(ctxs, np.int32).ravel())
    assert bits.shape == ctxs.shape
    cap = bits.size * 2 + 64
    out = np.empty(cap, np.uint8)
    n = _lib().pcc_abc_encode(bits, ctxs, bits.size, n_ctx, out, cap)
    if n < 0:
        raise RuntimeError("binary encoder failed (capacity/context range)")
    return out[:n].tobytes()


class AbcDecoder:
    """Stateful contextual decoder over one encoded stream."""

    def __init__(self, data: bytes, n_ctx: int):
        self._lib = _lib()
        self._buf = np.frombuffer(data, np.uint8).copy()  # kept alive
        self._h = self._lib.pcc_abc_dec_new(self._buf, len(self._buf), n_ctx)

    def decode(self, ctxs) -> np.ndarray:
        ctxs = np.ascontiguousarray(np.asarray(ctxs, np.int32).ravel())
        out = np.empty(ctxs.size, np.uint8)
        rc = self._lib.pcc_abc_dec_bits(self._h, ctxs, ctxs.size, out)
        if rc != 0:
            raise ValueError("malformed binary-coded stream")
        return out

    def close(self):
        if self._h is not None:
            self._lib.pcc_abc_dec_free(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # best effort; close() is the contract
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# Pure-Python twin (the specification)
# ---------------------------------------------------------------------------


class _EncPy:
    def __init__(self, n_ctx):
        self.low = 0
        self.range = 0xFFFFFFFF
        self.cache = 0
        self.cache_size = 1
        self.out = bytearray()
        self.probs = [_PROB_INIT] * n_ctx

    def _shift_low(self):
        if (self.low & 0xFFFFFFFF) < 0xFF000000 or (self.low >> 32):
            carry = self.low >> 32
            self.out.append((self.cache + carry) & 0xFF)
            for _ in range(self.cache_size - 1):
                self.out.append((0xFF + carry) & 0xFF)
            self.cache_size = 0
            self.cache = (self.low >> 24) & 0xFF
        self.cache_size += 1
        self.low = (self.low << 8) & 0xFFFFFFFF

    def encode(self, ctx, bit):
        p = self.probs[ctx]
        bound = (self.range >> _PROB_BITS) * p
        if not bit:
            self.range = bound
            self.probs[ctx] = p + (((1 << _PROB_BITS) - p) >> _MOVE_BITS)
        else:
            self.low += bound
            self.range -= bound
            self.probs[ctx] = p - (p >> _MOVE_BITS)
        while self.range < _TOP:
            self._shift_low()
            self.range = (self.range << 8) & 0xFFFFFFFF

    def finish(self):
        for _ in range(5):
            self._shift_low()
        return bytes(self.out)


def abc_encode_py(bits, ctxs, n_ctx: int) -> bytes:
    enc = _EncPy(n_ctx)
    for b, c in zip(np.asarray(bits, np.uint8).ravel().tolist(),
                    np.asarray(ctxs, np.int64).ravel().tolist()):
        enc.encode(c, b)
    return enc.finish()


class AbcDecoderPy:
    def __init__(self, data: bytes, n_ctx: int):
        self.data = data
        self.pos = 1  # the first byte is always 0 (the encoder's cache)
        self.range = 0xFFFFFFFF
        self.code = 0
        for _ in range(4):
            self.code = ((self.code << 8) | self._byte()) & 0xFFFFFFFF
        self.probs = [_PROB_INIT] * n_ctx

    def _byte(self):
        b = self.data[self.pos] if self.pos < len(self.data) else 0
        self.pos += 1
        return b

    def decode(self, ctxs) -> np.ndarray:
        out = np.empty(np.asarray(ctxs).size, np.uint8)
        for i, c in enumerate(np.asarray(ctxs, np.int64).ravel().tolist()):
            p = self.probs[c]
            bound = (self.range >> _PROB_BITS) * p
            if self.code < bound:
                self.range = bound
                self.probs[c] = p + (((1 << _PROB_BITS) - p) >> _MOVE_BITS)
                bit = 0
            else:
                self.code -= bound
                self.range -= bound
                self.probs[c] = p - (p >> _MOVE_BITS)
                bit = 1
            while self.range < _TOP:
                self.range = (self.range << 8) & 0xFFFFFFFF
                self.code = ((self.code << 8) | self._byte()) & 0xFFFFFFFF
            out[i] = bit
        return out
