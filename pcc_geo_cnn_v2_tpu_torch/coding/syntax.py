"""Bitstream container: header + binstr + per-block threshold/strings.

Byte-compatible with the reference's ``src/model_syntax.py`` framing:

    [u16 resolution][u8 level][u16 n_blocks][u8 n_strings][u16 n_binstr]
    [binstr bytes]
    then per block: [u8 threshold_idx] + per string: [u16 len][bytes]

The whole container is gzipped by the caller (as in
``compress_octree.py:112-114``). Overflow of any field raises, mirroring
the asserts at ``model_syntax.py:4-9``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["save_compressed_file", "load_compressed_file"]


def _scalar(x, dtype):
    info = np.iinfo(dtype)
    assert info.min <= x <= info.max, f"{x} out of range for {np.dtype(dtype)}"
    return np.array([x], dtype).tobytes()


def _read(f, n, dtype):
    return np.frombuffer(f.read(int(np.dtype(dtype).itemsize * n)), dtype=dtype)


def save_compressed_file(binstr, blocks, resolution, octree_level) -> bytes:
    """Serialize one point cloud's compressed representation.

    :param binstr: iterable of uint8 octree child masks.
    :param blocks: list of (strings, threshold_idx) per block, where
        ``strings`` is a tuple of byte strings (same count for all blocks).
    :param resolution: original cloud resolution (fits u16).
    :param octree_level: partition depth (fits u8).
    """
    binstr = np.asarray(list(binstr))
    n_strings = len(blocks[0][0]) if blocks else 0
    out = b"".join(
        [
            _scalar(resolution, np.uint16),
            _scalar(octree_level, np.uint8),
            _scalar(len(blocks), np.uint16),
            _scalar(n_strings, np.uint8),
            _scalar(len(binstr), np.uint16),
        ]
    )
    info = np.iinfo(np.uint8)
    assert np.all(binstr >= info.min) and np.all(binstr <= info.max)
    out += binstr.astype(np.uint8).tobytes()
    for strings, threshold_idx in blocks:
        assert len(strings) == n_strings
        out += _scalar(threshold_idx, np.uint8)
        for s in strings:
            out += _scalar(len(s), np.uint16) + s
    return out


def load_compressed_file(f):
    """Inverse of :func:`save_compressed_file` from a binary file object.

    :return: (resolution, level, binstr ndarray, blocks list of
        (strings list, threshold_idx)).
    """
    resolution = int(_read(f, 1, np.uint16)[0])
    level = int(_read(f, 1, np.uint8)[0])
    n_blocks = int(_read(f, 1, np.uint16)[0])
    n_strings = int(_read(f, 1, np.uint8)[0])
    n_binstr = int(_read(f, 1, np.uint16)[0])
    binstr = _read(f, n_binstr, np.uint8)
    blocks = []
    for _ in range(n_blocks):
        threshold_idx = int(_read(f, 1, np.uint8)[0])
        strings = []
        for _ in range(n_strings):
            n_bytes = int(_read(f, 1, np.uint16)[0])
            strings.append(f.read(n_bytes))
        blocks.append((strings, threshold_idx))
    rest = f.read()
    assert rest == b"", f"trailing {len(rest)} bytes in compressed file"
    return resolution, level, binstr, blocks
