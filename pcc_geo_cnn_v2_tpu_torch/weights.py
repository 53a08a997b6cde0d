"""Committed flax ``.msgpack.gz`` weight assets → torch state dicts.

The JAX package stores its flagship and RD weights as flax
``serialization.to_bytes`` output, gzipped (``pcc_geo_cnn_v2_tpu/assets``).
The port reads them without ``msgpack`` or ``flax``:

- :func:`msgpack_restore` is a small pure-Python msgpack decoder. Flax
  packs every ndarray as msgpack ExtType code 1 whose payload is itself a
  msgpack ``(shape, dtype_name, raw_bytes)`` triple (code 3 = numpy scalar,
  same payload).
- :func:`params_from_jax` is the ONE function that carries JAX parameters
  across: every flax conv kernel (DHWIO) becomes an OIDHW weight. That
  holds for ``nn.ConvTranspose`` too: with ``transpose_kernel=False`` it
  is an lhs-dilated correlation with the kernel NOT flipped, and the port
  computes it as such (``models/transforms.ConvTranspose``), so no flip
  and no I/O swap is needed — the ones ``F.conv_transpose3d`` would want.
- :func:`tail_weights_from_jax` packs the residual-tail kernels of a flax
  transform subtree for the fused-conv kernels (``ops/fused_conv.py``), the
  same packing the port's modules get from their own parameters.
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path

import numpy as np
import torch

from pcc_geo_cnn_v2_tpu_torch.ops.fused_conv import pack_tail_weights

__all__ = ["msgpack_restore", "load_asset_tree", "params_from_jax",
           "tail_weights_from_jax"]

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


def msgpack_restore(data: bytes):
    """Decode flax ``msgpack_serialize`` bytes → nested dict of ndarrays."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes")
    return out


def load_asset_tree(path):
    """Read a gzipped flax asset into a nested dict of numpy arrays (the
    counterpart of the JAX package's ``cli/common.load_params_asset``)."""
    return msgpack_restore(gzip.decompress(Path(path).read_bytes()))


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_jax(tree) -> dict:
    """flax param tree (``{"params": {...}}`` or the inner dict, numpy
    leaves) → state dict of the port's modules.

    Module paths keep the flax names (``analysis_t.AnalysisBlock_0.Conv_0``)
    so the mapping is one rule per leaf kind.
    """
    tree = tree.get("params", tree)
    state = {}
    for path, leaf in _flatten(tree):
        a = np.asarray(leaf, np.float32)
        *mods, name = path
        if name == "kernel":
            name = "weight"
            a = a.transpose(4, 3, 0, 1, 2)  # DHWIO → OIDHW
        state[".".join(mods + [name])] = torch.from_numpy(
            np.array(a, copy=True, order="C"))
    return state



def tail_weights_from_jax(stack_tree, dtype=torch.float32) -> list:
    """flax subtree of a V2-family transform (``params["analysis_t"]`` or
    ``params["synthesis_t"]``) → per block ``(w1, b1, w2, b2)`` as kernels
    K4a / K4b take them: tap-major ``[27, cin, cout]`` weights in ``dtype``,
    f32 biases. Equal to ``ops.fused_conv.packed_tails`` of the module that
    ``params_from_jax`` loaded from the same tree.
    """
    out = []
    blocks = sorted((k for k in stack_tree if "Block_" in k),
                    key=lambda k: int(k.rsplit("_", 1)[1]))
    for name in blocks:
        convs = stack_tree[name]
        layer = "ConvTranspose" if "ConvTranspose_1" in convs else "Conv"
        out.append(tuple(
            t for i in (1, 2) for t in (
                pack_tail_weights(convs[f"{layer}_{i}"]["kernel"], dtype),
                torch.from_numpy(np.array(convs[f"{layer}_{i}"]["bias"],
                                          np.float32)))))
    return out
