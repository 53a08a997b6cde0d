"""Port host coding vs the JAX package: byte-exact.

CDF tables, range-coder streams, the bitstream container, the octree
partition / binstr and the packed-mask unpack must all be identical for
identical inputs — any difference would make the two packages' bitstreams
incompatible.
"""

import io
from pathlib import Path

import numpy as np
import pytest

from pcc_geo_cnn_v2_tpu.coding import range_coder as jrc
from pcc_geo_cnn_v2_tpu.coding import syntax as jsyntax
from pcc_geo_cnn_v2_tpu.models import entropy as jent
from pcc_geo_cnn_v2_tpu.ops.bitunpack import unpack_mask_coords as j_unpack
from pcc_geo_cnn_v2_tpu.utils import octree as joct
from pcc_geo_cnn_v2_tpu.utils import pc_io as jpc_io
from pcc_geo_cnn_v2_tpu.utils import scansim as jscan
from pcc_geo_cnn_v2_tpu_torch.coding import range_coder as trc
from pcc_geo_cnn_v2_tpu_torch.coding import syntax as tsyntax
from pcc_geo_cnn_v2_tpu_torch.models import entropy as tent
from pcc_geo_cnn_v2_tpu_torch.ops.bitunpack import unpack_mask_coords
from pcc_geo_cnn_v2_tpu_torch.utils import octree as toct
from pcc_geo_cnn_v2_tpu_torch.utils import pc_io as tpc_io
from pcc_geo_cnn_v2_tpu_torch.utils import scansim as tscan
from pcc_geo_cnn_v2_tpu_torch.weights import load_asset_tree

ASSETS = Path(__file__).resolve().parent.parent / "pcc_geo_cnn_v2_tpu/assets"


def _eb(asset):
    return load_asset_tree(ASSETS / asset)["params"]["entropy_bottleneck"]


def _tables_equal(a, b):
    for f in ("cdf", "cdf_length", "offset"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
    assert a.precision == b.precision


@pytest.mark.parametrize("asset", ["bench_c3p.msgpack.gz",
                                   "rd/c3p/1.00e-05.msgpack.gz"])
def test_factorized_tables_byte_equal(asset):
    eb = _eb(asset)
    jq = jent.refine_factorized_quantiles(eb)
    tq = tent.refine_factorized_quantiles(eb)
    assert jq["quantiles"].tobytes() == tq["quantiles"].tobytes()
    _tables_equal(tent.build_factorized_cdf(tq),
                  jent.build_factorized_cdf(jq))


def test_gaussian_table_byte_equal():
    _tables_equal(tent.build_gaussian_cdf(), jent.build_gaussian_cdf())
    assert np.array_equal(tent.default_scale_table(),
                          jent.default_scale_table())


@pytest.mark.parametrize("kind", ["factorized", "gaussian"])
def test_range_coder_bytes_identical(kind):
    rng = np.random.default_rng(3)
    n = 6
    if kind == "factorized":
        eb = tent.refine_factorized_quantiles(_eb("bench_c3p.msgpack.gz"))
        ttab, jtab = tent.build_factorized_cdf(eb), jent.build_factorized_cdf(eb)
        shape = (4, 4, 4, 64)
        idx = np.broadcast_to(np.arange(64, dtype=np.int32), shape)
        per_stream = False
    else:
        ttab, jtab = tent.build_gaussian_cdf(), jent.build_gaussian_cdf()
        shape = (8, 8, 8, 64)
        idx = rng.integers(0, 64, (n,) + shape).astype(np.int32)
        per_stream = True
    # mostly small symbols, a few far outside the table (escape coding)
    sym = rng.laplace(0, 2, (n,) + shape).round().astype(np.int32)
    sym.reshape(-1)[rng.integers(0, sym.size, 20)] = rng.integers(
        -5000, 5000, 20)
    got = trc.encode_batch(sym, idx, ttab)
    want = jrc.encode_batch(sym, idx, jtab)
    assert got == want
    back = trc.decode_batch(got, idx, ttab, per_stream=per_stream)
    np.testing.assert_array_equal(back, sym)


def test_container_and_octree_bytes_identical():
    pts = tscan.figure_cloud(7, 256, with_normals=False)
    np.testing.assert_array_equal(
        pts, jscan.figure_cloud(7, 256, with_normals=False))
    tb, tbin = toct.partition_octree(pts, [0, 0, 0], [256] * 3, 3)
    jb, jbin = joct.partition_octree(pts, [0, 0, 0], [256] * 3, 3)
    assert tbin == jbin and len(tb) == len(jb)
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        np.stack(toct.block_origins(tbin, [0, 0, 0], [256] * 3, 3)),
        np.stack(joct.block_origins(jbin, [0, 0, 0], [256] * 3, 3)))
    rng = np.random.default_rng(0)
    payload = [((rng.bytes(int(rng.integers(0, 50))), rng.bytes(3)),
                int(rng.integers(0, 256))) for _ in tb]
    blob = tsyntax.save_compressed_file(tbin, payload, 256, 3)
    assert blob == jsyntax.save_compressed_file(jbin, payload, 256, 3)
    res, lvl, binstr, back = tsyntax.load_compressed_file(io.BytesIO(blob))
    assert (res, lvl) == (256, 3) and list(binstr) == tbin
    assert [(tuple(s), t) for s, t in back] == payload


def test_ply_and_mask_unpack_identical(tmp_path):
    rng = np.random.default_rng(1)
    pts = np.unique(rng.integers(0, 100, (500, 3)), axis=0).astype(np.float32)
    tpc_io.write_ply(tmp_path / "t.ply", pts)
    jpc_io.write_ply(tmp_path / "j.ply", pts)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    np.testing.assert_array_equal(tpc_io.load_points([tmp_path / "t.ply"])[0],
                                  pts)
    rows = rng.integers(0, 256, (5, 16 ** 3 // 8)).astype(np.uint8)
    rows[2] = 0
    for a, b in zip(unpack_mask_coords(rows, 16), j_unpack(rows, 16)):
        np.testing.assert_array_equal(a, b)
