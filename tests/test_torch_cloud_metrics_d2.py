"""Port full-cloud D2 metrics vs the JAX package and the host oracle.

Same clouds as ``tests/test_d2_metrics.py`` (a voxelized sphere with
radial normals, jittered candidates, 16³ blocks). Both packages take NN
identities from a banded argmin EDT with the same scan order, so offsets
and flags are equal and the f64 host finishing agrees to 1e-9 relative.
Against the host KD-tree oracle, distance ties may pick other neighbours:
the tolerances are those of ``tests/test_d2_metrics.py`` (d1 sums 1e-9,
d2 sums 5%, d2 PSNR 0.25 dB).
"""

import numpy as np
import pytest
import torch

from pcc_geo_cnn_v2_tpu.ops import cloud_metrics as jcm
from pcc_geo_cnn_v2_tpu.utils.metrics import compute_metrics as jax_metrics
from pcc_geo_cnn_v2_tpu_torch.ops import cloud_metrics as tcm
from pcc_geo_cnn_v2_tpu_torch.ops.voxel import pack_attrs
from pcc_geo_cnn_v2_tpu_torch.utils.metrics import (
    avail_opt_metrics,
    compute_metrics,
    metrics_from_nn,
    nn_maps_from_identities,
    validate_opt_metrics,
)
from pcc_geo_cnn_v2_tpu_torch.utils.octree import (
    block_origins,
    partition_octree,
)

RESOLUTION, LEVEL = 64, 2
SIZE = RESOLUTION // (2 ** LEVEL)


def _cloud_with_normals(seed, n=900):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts = np.round(v * 24 + 32)
    pts = np.unique(pts[np.all((pts >= 0) & (pts < RESOLUTION), axis=1)],
                    axis=0)
    nrm = pts - 32.0
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-9)
    return np.hstack([pts, nrm])


def _surface_with_normals():
    """A height field over the whole 64² grid: every voxel has in-plane
    neighbours at distance 1, so candidates one voxel off are tied between
    several originals."""
    x, y = np.meshgrid(np.arange(RESOLUTION), np.arange(RESOLUTION),
                       indexing="ij")
    h = 32 + 10 * np.sin(x / 9.0) * np.cos(y / 11.0)
    pts = np.stack([x, y, np.round(h)], -1).reshape(-1, 3).astype(np.float64)
    nrm = np.stack([-10 / 9.0 * np.cos(x / 9.0) * np.cos(y / 11.0),
                    10 / 11.0 * np.sin(x / 9.0) * np.sin(y / 11.0),
                    np.ones_like(h)], -1).reshape(-1, 3)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return np.hstack([pts, nrm])


def _case(seed, jitter=2, points=None):
    if points is None:
        points = _cloud_with_normals(seed)
    blocks, binstr = partition_octree(points, [0, 0, 0], [RESOLUTION] * 3,
                                      LEVEL)
    origins = np.stack(block_origins(binstr, [0, 0, 0], [RESOLUTION] * 3,
                                     LEVEL))
    rng = np.random.default_rng(seed + 10)
    b_blocks = []
    for b in blocks:
        p = np.asarray(b)[:, :3]
        jit = np.clip(p + rng.integers(-jitter, jitter + 1, size=p.shape), 0,
                      SIZE - 1)
        keep = rng.random(len(jit)) < 0.85
        cand = np.unique(jit[keep], axis=0) if keep.any() else jit[:1]
        b_blocks.append(cand.astype(np.float32))
    budget = int(2 ** np.ceil(np.log2(max(len(b) for b in blocks))))
    a_pts = np.full((len(blocks), budget, 3), -1, np.int32)
    for i, b in enumerate(blocks):
        a_pts[i, :len(b)] = np.asarray(b)[:, :3]
    occ = np.zeros((len(b_blocks), SIZE ** 3), np.uint8)
    for i, b in enumerate(b_blocks):
        c = np.asarray(b, np.int64)
        occ[i, (c[:, 0] * SIZE + c[:, 1]) * SIZE + c[:, 2]] = 1
    packed = np.packbits(occ, axis=-1, bitorder="big")
    return dict(points=points, blocks=blocks, origins=origins,
                b_blocks=b_blocks, a_pts=a_pts, packed=packed,
                a_nrm=pack_attrs(blocks, [3, 4, 5], budget))


@pytest.mark.parametrize("halo", [6, 2])
def test_nn_offsets_match_jax(halo):
    c = _case(1)
    want = jcm.blockwise_nn_offsets(c["a_pts"], c["packed"], c["origins"],
                                    SIZE, halo=halo, aot=False)
    got = tcm.blockwise_nn_offsets(c["a_pts"], torch.from_numpy(c["packed"]),
                                   c["origins"], SIZE, halo=halo, batch=5)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["ok"], want["ok"])
    ok = want["ok"]
    np.testing.assert_array_equal(got["off"][ok], want["off"][ok])
    assert ok.any() and (halo == 6 or (want["valid"] & ~ok).any())


@pytest.mark.parametrize("seed,halo", [(0, 6), (3, 6), (0, 2)])
def test_d2_metrics_match_jax_and_host_oracle(seed, halo):
    """halo = 2 sends many queries through the out-of-halo host branch."""
    c = _case(seed)
    args = (c["b_blocks"], c["origins"], SIZE, RESOLUTION, c["points"])
    want = jcm.blockwise_d2_metrics(c["a_pts"], c["a_nrm"], c["packed"],
                                    *args, halo=halo, with_d1=True, aot=False)
    got = tcm.blockwise_d2_metrics(
        torch.from_numpy(c["a_pts"]), c["a_nrm"],
        torch.from_numpy(c["packed"]), *args, halo=halo, batch=7,
        with_d1=True)
    assert set(got) == set(want)
    if halo == 6:  # equal identities: only f64 summation order can differ
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-9, err_msg=k)
    b_full = np.vstack([np.asarray(b)[:, :3] + o
                        for b, o in zip(c["b_blocks"], c["origins"])])
    host = compute_metrics(c["points"][:, :3], b_full, RESOLUTION - 1,
                           p1_n=c["points"][:, 3:6])
    for k in ("d1_sum_AB", "d1_sum_BA"):
        np.testing.assert_allclose(got[k], host[k], rtol=1e-9)
    for k in ("d2_sum_AB", "d2_sum_BA"):
        np.testing.assert_allclose(got[k], host[k], rtol=0.05)
    assert abs(got["d2_psnr"] - host["d2_psnr"]) < 0.25


def test_host_oracle_copy_matches_the_jax_package():
    c = _case(2)
    b_full = np.vstack([np.asarray(b)[:, :3] + o
                        for b, o in zip(c["b_blocks"], c["origins"])])
    args = (c["points"][:, :3], b_full, RESOLUTION - 1)
    for nrm in (None, c["points"][:, 3:6]):
        got, want = compute_metrics(*args, p1_n=nrm), \
            jax_metrics(*args, p1_n=nrm)
        assert got == want
    empty = compute_metrics(c["points"][:, :3], np.zeros((0, 3)), 63,
                            p1_n=c["points"][:, 3:6])
    assert empty == jax_metrics(c["points"][:, :3], np.zeros((0, 3)), 63,
                                p1_n=c["points"][:, 3:6])
    from pcc_geo_cnn_v2_tpu.utils import metrics as jm

    assert avail_opt_metrics == jm.avail_opt_metrics
    validate_opt_metrics(["d1_mse", "d2_mse"], with_normals=True)
    with pytest.raises(AssertionError, match="needs normals"):
        validate_opt_metrics(["d2_mse"])


def test_d2_from_identities_with_kdtree_identities_is_the_oracle():
    from scipy.spatial import cKDTree

    c = _case(3)
    a_glob = np.vstack([np.asarray(b)[:, :3] + o
                        for b, o in zip(c["blocks"], c["origins"])])
    a_n = np.vstack([np.asarray(b)[:, 3:6] for b in c["blocks"]])
    b_full = np.vstack([np.asarray(b)[:, :3] + o
                        for b, o in zip(c["b_blocks"], c["origins"])])
    t1 = cKDTree(a_glob, balanced_tree=False)
    idx2 = cKDTree(b_full, balanced_tree=False).query(a_glob, workers=-1)[1]
    idx1 = t1.query(b_full, workers=-1)[1]
    got = tcm.d2_from_identities(a_glob, a_n, b_full[idx2], b_full,
                                 a_glob[idx1], c["points"], RESOLUTION,
                                 with_d1=True)
    want = compute_metrics(a_glob, b_full, RESOLUTION - 1, p1_n=a_n, t1=t1)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-12, err_msg=k)


def test_tied_neighbours_are_true_nearest_and_explain_the_oracle_gap():
    """On a tie-heavy cloud (a dense surface, candidates one voxel off) the
    port's D2 equals the JAX package's, every neighbour it took lies at the
    KD-tree's nearest distance, and the host oracle's own formulas over the
    port's neighbours give the port's value: what is left against the
    KD-tree oracle is tie-breaking alone."""
    from scipy.spatial import cKDTree

    c = _case(5, jitter=1, points=_surface_with_normals())
    pts, nrm = c["points"][:, :3], c["points"][:, 3:6]
    b_full = np.vstack([np.asarray(b)[:, :3] + o
                        for b, o in zip(c["b_blocks"], c["origins"])])
    d, _ = cKDTree(pts).query(b_full, k=2)
    far = d[:, 0] > 0
    assert (d[far, 0] == d[far, 1]).mean() > 0.5  # most neighbours tied

    args = (c["b_blocks"], c["origins"], SIZE)
    got = tcm.blockwise_d2_metrics(
        torch.from_numpy(c["a_pts"]), c["a_nrm"],
        torch.from_numpy(c["packed"]), *args, RESOLUTION, c["points"],
        halo=6, batch=7, with_d1=True)
    want = jcm.blockwise_d2_metrics(c["a_pts"], c["a_nrm"], c["packed"],
                                    *args, RESOLUTION, c["points"], halo=6,
                                    with_d1=True, aot=False)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-9, err_msg=k)

    a_glob, _, a_tgt, b_glob, b_tgt = tcm.blockwise_nn_identities(
        torch.from_numpy(c["a_pts"]), c["a_nrm"],
        torch.from_numpy(c["packed"]), *args, c["points"], halo=6, batch=7)
    idx1, idx2 = nn_maps_from_identities(pts, b_full, a_glob, a_tgt, b_glob,
                                         b_tgt)
    d_ab = cKDTree(b_full).query(pts)[0]
    np.testing.assert_array_equal(((pts - b_full[idx2]) ** 2).sum(1),
                                  np.rint(d_ab ** 2))
    np.testing.assert_array_equal(((b_full - pts[idx1]) ** 2).sum(1),
                                  np.rint(d[:, 0] ** 2))
    # the encoder's AB normals are f32
    same = metrics_from_nn(pts, b_full, RESOLUTION - 1, idx1, idx2,
                           p1_n=nrm.astype(np.float32))
    for k, v in same.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)
    host = compute_metrics(pts, b_full, RESOLUTION - 1, p1_n=nrm)
    assert got["d1_sum_AB"] == host["d1_sum_AB"]
    assert got["d1_sum_BA"] == host["d1_sum_BA"]
    print(f"D2 PSNR {got['d2_psnr']:.4f} dB, KD-tree oracle "
          f"{host['d2_psnr']:.4f} dB")


def test_nn_maps_reject_a_neighbour_outside_the_cloud():
    p1 = np.array([[0, 0, 0], [1, 0, 0]])
    p2 = np.array([[0, 1, 0]])
    idx1, idx2 = nn_maps_from_identities(p1, p2, p1[::-1], p2[[0, 0]], p2,
                                         p1[[0]])
    assert idx1.tolist() == [0] and idx2.tolist() == [0, 0]
    with pytest.raises(ValueError, match="not a point"):
        nn_maps_from_identities(p1, p2, p1, p2[[0, 0]] + 1, p2, p1[[0]])
    with pytest.raises(ValueError, match="cover"):
        nn_maps_from_identities(p1, p2, p1[[0, 0]], p2[[0, 0]], p2, p1[[0]])
