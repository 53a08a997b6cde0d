"""Host-side packed-mask → coordinate-list unpack (native C++ pass).

Port of ``pcc_geo_cnn_v2_tpu/ops/bitunpack.py`` over the port's own copy of
``native/voxel_bits.cpp``.
"""

from __future__ import annotations

import ctypes

import numpy as np

from pcc_geo_cnn_v2_tpu_torch.native import load_host_lib

__all__ = ["unpack_mask_coords"]


def _lib():
    lib = load_host_lib("voxel_bits")
    if not getattr(lib, "_pcc_typed", False):
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.pcc_popcount.restype = ctypes.c_int64
        lib.pcc_popcount.argtypes = [u8p, ctypes.c_int64]
        lib.pcc_unpack_mask_coords.restype = ctypes.c_int64
        lib.pcc_unpack_mask_coords.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, f32p,
            ctypes.c_int64, i64p]
        lib._pcc_typed = True
    return lib


def unpack_mask_coords(rows: np.ndarray, bsz: int) -> list[np.ndarray]:
    """[n, bsz³/8] packed-bit rows → n arrays of [n_i, 3] f32 coords, in
    ``np.argwhere`` order of the unpacked volume (bitorder "big")."""
    rows = np.ascontiguousarray(rows, np.uint8)
    n, fbytes = rows.shape
    lib = _lib()
    total = lib.pcc_popcount(rows.reshape(-1), rows.size)
    out = np.empty((total, 3), np.float32)
    counts = np.empty(n, np.int64)
    wrote = lib.pcc_unpack_mask_coords(
        rows.reshape(-1), n, fbytes, bsz, out, total, counts)
    assert wrote == total, (wrote, total)
    return np.split(out, np.cumsum(counts[:-1]))
