"""flax ``.msgpack.gz`` weight assets ↔ torch state dicts.

The JAX package stores its flagship and RD weights as flax
``serialization.to_bytes`` output, gzipped (``pcc_geo_cnn_v2_tpu/assets``).
The port reads and writes them without ``msgpack`` or ``flax``:

- :func:`msgpack_restore` is a small pure-Python msgpack decoder and
  :func:`msgpack_serialize` its encoder. Flax packs every ndarray as
  msgpack ExtType code 1 whose payload is itself a msgpack ``(shape,
  dtype_name, raw_bytes)`` triple (code 3 = numpy scalar, same payload),
  and every other value in msgpack's shortest form.
- :func:`params_from_jax` is the ONE function that carries JAX parameters
  across: every flax conv kernel (DHWIO) becomes an OIDHW weight. That
  holds for ``nn.ConvTranspose`` too: with ``transpose_kernel=False`` it
  is an lhs-dilated correlation with the kernel NOT flipped, and the port
  computes it as such (``models/transforms.ConvTranspose``), so no flip
  and no I/O swap is needed — the ones ``F.conv_transpose3d`` would want.
  :func:`params_to_jax` is its inverse, and :func:`save_asset` writes a
  tree in the layout the JAX package's export tools write
  (``tools/export_rd_assets.py``), so the port's trained weights go back.
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

__all__ = ["msgpack_restore", "msgpack_serialize", "load_asset_tree",
           "save_asset", "params_from_jax", "params_to_jax",
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


def _head(small, codes, n):
    """msgpack's shortest header for a length (or value) ``n``: ``small``
    (a fix-form base, or None) while n fits its bits, else the first of
    ``codes`` = ((code, struct format), ...) whose format holds n."""
    if small is not None and n < small[1]:
        return bytes([small[0] | n])
    for code, fmt in codes:
        if n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([code]) + struct.pack(">" + fmt, n)
    raise ValueError(f"{n} too large for msgpack")


def _pack(v, out):
    if v is None or isinstance(v, bool):
        out.append({None: b"\xc0", False: b"\xc2", True: b"\xc3"}[v])
    elif isinstance(v, int):
        if 0 <= v < 128 or -32 <= v < 0:
            out.append(struct.pack(">b" if v < 0 else ">B", v))
        elif v >= 0:
            out.append(_head(None, ((0xCC, "B"), (0xCD, "H"), (0xCE, "I"),
                                    (0xCF, "Q")), v))
        else:
            for code, fmt in ((0xD0, "b"), (0xD1, "h"), (0xD2, "i"),
                              (0xD3, "q")):
                if v >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                    out.append(bytes([code]) + struct.pack(">" + fmt, v))
                    break
    elif isinstance(v, float):
        out.append(b"\xcb" + struct.pack(">d", v))
    elif isinstance(v, str):
        b = v.encode("utf-8")
        out.append(_head((0xA0, 32), ((0xD9, "B"), (0xDA, "H"),
                                      (0xDB, "I")), len(b)) + b)
    elif isinstance(v, bytes):
        out.append(_head(None, ((0xC4, "B"), (0xC5, "H"), (0xC6, "I")),
                         len(v)) + v)
    elif isinstance(v, (list, tuple)):
        out.append(_head((0x90, 16), ((0xDC, "H"), (0xDD, "I")), len(v)))
        for item in v:
            _pack(item, out)
    elif isinstance(v, dict):
        out.append(_head((0x80, 16), ((0xDE, "H"), (0xDF, "I")), len(v)))
        for k, item in v.items():
            _pack(k, out)
            _pack(item, out)
    elif isinstance(v, (np.ndarray, np.generic)):
        a = np.asarray(v)
        payload = msgpack_serialize((a.shape, a.dtype.name, a.tobytes("C")))
        code = _EXT_NDARRAY if isinstance(v, np.ndarray) else _EXT_NPSCALAR
        fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        head = (bytes([fix[len(payload)]]) if len(payload) in fix else
                _head(None, ((0xC7, "B"), (0xC8, "H"), (0xC9, "I")),
                      len(payload)))
        out.append(head + struct.pack(">b", code) + payload)
    else:
        raise TypeError(f"cannot msgpack {type(v).__name__}")


def msgpack_serialize(tree) -> bytes:
    """Encode a nested dict of ndarrays as flax ``msgpack_serialize`` does
    (byte for byte: shortest forms, str and bin types, ndarrays as ExtType
    1). Arrays above flax's 2³⁰-byte chunk size are not split."""
    out = []
    _pack(tree, out)
    return b"".join(out)


def load_asset_tree(path):
    """Read a gzipped flax asset into a nested dict of numpy arrays (the
    counterpart of the JAX package's ``cli/common.load_params_asset``)."""
    return msgpack_restore(gzip.decompress(Path(path).read_bytes()))


def save_asset(tree, path):
    """Write ``tree`` (numpy leaves) as a gzipped flax asset, the layout
    :func:`load_asset_tree` and the JAX package's loaders read (gzip
    header time 0, so equal trees give equal files)."""
    Path(path).write_bytes(gzip.compress(msgpack_serialize(tree),
                                         compresslevel=9, mtime=0))


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


def params_to_jax(state_dict) -> dict:
    """Inverse of :func:`params_from_jax`: a state dict of the port's
    modules → ``{"params": {...}}`` with numpy f32 leaves, OIDHW weights
    back to DHWIO kernels, keys sorted at every level as JAX's tree
    utilities leave a flax tree."""
    tree = {}
    for name, t in state_dict.items():
        *mods, leaf = name.split(".")
        a = t.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight":
            leaf, a = "kernel", a.transpose(2, 3, 4, 1, 0)  # OIDHW → DHWIO
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(a)

    def ordered(node):
        return {k: ordered(v) if isinstance(v, dict) else v
                for k, v in sorted(node.items())}

    return {"params": ordered(tree)}


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
