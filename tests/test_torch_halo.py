"""Port halo EDT (K2's plain version on the CPU) and full-cloud D1 metrics
vs the JAX package: exact sums, counts and outlier masks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcc_geo_cnn_v2_tpu.ops import cloud_metrics as jcm
from pcc_geo_cnn_v2_tpu_torch.ops import cloud_metrics as tcm
from pcc_geo_cnn_v2_tpu_torch.ops.halo import halo_d1_dir, halo_kmax

SIZE, HALO, BS = 16, 5, 4


def _packed(rng, p_occ):
    g = rng.random((BS, 27, SIZE ** 3)) < p_occ
    return np.packbits(g.reshape(BS, -1), bitorder="big").reshape(BS, 27, -1)


@pytest.mark.parametrize("p", [0.02, 0.0005, 0.0])  # dense, sparse, empty
def test_halo_dir_matches_pallas_and_xla(p):
    rng = np.random.default_rng(7)
    a, b = _packed(rng, 0.02), _packed(rng, p)
    a_t, b_t = torch.from_numpy(a), torch.from_numpy(b)
    got = halo_d1_dir(tcm.query_core(a_t, SIZE),
                      tcm.assemble_halo(b_t, SIZE, HALO),
                      size=SIZE, halo=HALO)
    got = {k: v.numpy() for k, v in got.items()}
    for ref in (jcm._halo_dir_chunk_pallas(jnp.asarray(a), jnp.asarray(b),
                                           size=SIZE, halo=HALO,
                                           interpret=True),
                jcm._halo_dir_chunk(jnp.asarray(a), jnp.asarray(b),
                                    size=SIZE, halo=HALO)):
        ref = jax.device_get(ref)
        np.testing.assert_array_equal(got["sum"], ref["sum"].astype(np.int64))
        for k in ("n", "unres_cnt", "unres"):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_assemble_halo_matches_jax():
    rng = np.random.default_rng(2)
    b = _packed(rng, 0.3)
    got = tcm.assemble_halo(torch.from_numpy(b), SIZE, HALO).numpy()
    want = np.asarray(jcm._assemble_halo(jnp.asarray(b), SIZE, HALO))
    np.testing.assert_array_equal(got, want)


def test_kmax_bounds_the_true_distance():
    """The coarse bound dominates every core query's in-halo NN distance
    (clipped to halo) — the property that makes the bounded passes exact."""
    from scipy.ndimage import distance_transform_edt

    rng = np.random.default_rng(4)
    a, b = _packed(rng, 0.01), _packed(rng, 0.002)
    qry = tcm.query_core(torch.from_numpy(a), SIZE)
    tgt = tcm.assemble_halo(torch.from_numpy(b), SIZE, HALO)
    kmax = halo_kmax(qry, tgt, HALO).numpy()
    for i in range(BS):
        if not tgt[i].any():
            assert kmax[i] == HALO
            continue
        core = slice(HALO, HALO + SIZE)
        d = distance_transform_edt(tgt[i].numpy() == 0)[core, core, core]
        q = qry[i].numpy() > 0
        assert np.all(np.minimum(d[q], HALO) <= kmax[i])


def _cloud(seed, n_blocks=10, size=SIZE):
    rng = np.random.default_rng(seed)
    origins = np.unique(rng.integers(0, 4, (n_blocks, 3)), axis=0) * size
    # sparse enough that some nearest neighbours lie beyond the halo
    occ = rng.random((len(origins), size ** 3)) < 0.004
    cand = rng.random(occ.shape) < 0.004
    pack = lambda g: np.packbits(g, axis=-1, bitorder="big")  # noqa: E731
    return origins, pack(occ), pack(cand)


def test_blockwise_d1_sums_and_metrics_match_jax():
    origins, a, b = _cloud(3)
    got = tcm.blockwise_d1_sums(torch.from_numpy(a), torch.from_numpy(b),
                                origins, SIZE, halo=HALO, batch=4)
    want = jcm.blockwise_d1_sums(a, b, origins, SIZE, halo=HALO, batch=4,
                                 backend="xla", aot=False)
    for k in ("ab_sum", "ba_sum", "n_a", "n_b"):
        assert got[k] == want[k], k
    for k in ("outliers_a", "outliers_b"):
        np.testing.assert_array_equal(got[k], want[k])
    assert len(got["outliers_a"]) and len(got["outliers_b"])

    def points(packed):
        bits = np.unpackbits(packed, axis=-1, bitorder="big")
        c = np.argwhere(bits.reshape(-1, SIZE, SIZE, SIZE))
        return (c[:, 1:] + origins[c[:, 0]]).astype(np.float64)

    pa, pb = points(a), points(b)
    mt = tcm.d1_metrics_from_sums(got, 63, points_a=pa, points_b=pb)
    mj = jcm.d1_metrics_from_sums(want, 63, points_a=pa, points_b=pb)
    assert mt == mj


@pytest.mark.parametrize("full_tree_limit", [2_000_000, 0])
def test_resolve_outliers_matches_kd(full_tree_limit):
    """One KD-tree over the cloud, or the ring search over block unions
    (clouds above the limit): both exact."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(1)
    origins = np.array([[x, y, z] for x in range(4) for y in range(4)
                        for z in range(4)]) * 64
    blocks = [rng.integers(0, 64, (int(rng.integers(0, 8)), 3))
              .astype(np.float64) for _ in origins]
    cloud = np.vstack([b + o for b, o in zip(blocks, origins) if len(b)])
    queries = rng.uniform(0, 256, (500, 3)).round()
    got = tcm.resolve_outliers(queries, blocks, origins, 64,
                               full_tree_limit=full_tree_limit)
    np.testing.assert_allclose(got, cKDTree(cloud).query(queries)[0] ** 2)
