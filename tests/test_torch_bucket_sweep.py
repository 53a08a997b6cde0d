"""Port bucket sweep (K1's plain version on the CPU) vs the JAX package.

The JAX side runs its Pallas kernel in interpret mode, as its own tests
do. Distances are integer-valued and every sum here stays below 2^24, so
colsum / candmin / ab / ba / counts must be equal, and so must the picks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcc_geo_cnn_v2_tpu.ops import bucket_sweep as jbs
from pcc_geo_cnn_v2_tpu.ops.threshold_sweep import select_thresholds_d1_batch
from pcc_geo_cnn_v2_tpu_torch.ops import bucket_sweep as tbs

B, T, P = 16, 64, 512
K, KC, PC = 1024, 256, 64
THR = np.linspace(0, 1.0, T)


def _batch(seeds, lift=0.0):
    occs, xhats = [], []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        pts = np.unique(rng.integers(0, B, (rng.integers(30, 300), 3)),
                        axis=0)
        occ = np.zeros((B, B, B), np.float32)
        occ[pts[:, 0], pts[:, 1], pts[:, 2]] = 1.0
        noise = rng.random((B, B, B)).astype(np.float32)
        # sparse high-probability voxels near the surface, zeros elsewhere
        x_hat = np.where(noise < 0.15, 0.5 * occ + 0.5 * noise, 0.0)
        xhats.append(np.clip(x_hat + lift * noise, 0.0, 1.0)
                     .astype(np.float32))
        occs.append(occ)
    pts = np.full((len(seeds), P, 3), -1, np.int32)
    for i, o in enumerate(occs):
        c = np.argwhere(o > 0)
        pts[i, :len(c)] = c
    return np.stack(occs), np.stack(xhats), pts


def _jax_colsums(x_hat, pts):
    """JAX's K1 prep + ``_bucket_colsums_pallas`` in interpret mode."""
    n = len(x_hat)
    flat = jnp.asarray(x_hat.reshape(n, -1))
    cnt0 = jnp.sum(flat > THR[0], axis=-1).astype(jnp.int32)
    _, pos = jax.lax.top_k(flat, K)
    valid_k = jnp.arange(K)[None, :] < cnt0[:, None]
    coords = jnp.stack([pos // (B * B), (pos // B) % B, pos % B],
                       axis=1).astype(jnp.float32)
    cand = jnp.where(valid_k[:, None, :], coords, jbs.SENTINEL)
    pts_f = jnp.asarray(pts, jnp.float32)
    n_pts = jnp.sum(pts_f[:, :, 0] >= 0, axis=-1).astype(jnp.int32)
    kt = jnp.clip((cnt0 + KC - 1) // KC, 0, K // KC)
    pt = jnp.clip((n_pts + PC - 1) // PC, 1, P // PC)
    colsum, candmin = jbs._bucket_colsums_pallas(
        pts_f, cand, kt, pt, kc=KC, pc=PC, interpret=True)
    return (np.asarray(colsum), np.asarray(candmin), np.asarray(pos),
            np.asarray(cnt0))


def test_colsums_match_pallas_kernel():
    _, x_hat, pts = _batch(range(3))
    j_colsum, j_candmin, j_pos, j_cnt0 = _jax_colsums(x_hat, pts)
    _, pos, cnt0, k = tbs.sorted_candidates(
        torch.from_numpy(x_hat), torch.tensor(THR, dtype=torch.float32), K)
    assert k == K
    np.testing.assert_array_equal(cnt0.numpy(), j_cnt0)
    # same candidate order as lax.top_k (descending, ties by position)
    np.testing.assert_array_equal(pos.numpy(), j_pos)
    pts_t = torch.from_numpy(pts)
    npts = (pts_t[:, :, 0] >= 0).sum(-1).to(torch.int32)
    colsum, candmin = tbs.bucket_colsums(pts_t, pos, cnt0, npts, B)
    for i, c in enumerate(j_cnt0):
        np.testing.assert_array_equal(colsum[i, :c].numpy(), j_colsum[i, :c])
        np.testing.assert_array_equal(candmin[i, :c].numpy(),
                                      j_candmin[i, :c])


@pytest.mark.parametrize("opt_metrics,max_deltas", [
    (("d1_mse",), (np.inf,)),
    (("d1_mse", "d1_mse_BA", "d1_sum_max"), (np.inf, 2.0)),
])
def test_sums_and_picks_match_jax(opt_metrics, max_deltas):
    _, x_hat, pts = _batch(range(3, 7))
    thr_j = jnp.asarray(THR, jnp.float32)
    j_sums = [np.asarray(a) for a in jbs.bucket_sweep_sums(
        jnp.asarray(x_hat), jnp.asarray(pts), thr_j, K=K, kc=KC, pc=PC,
        interpret=True)]
    thr_t = torch.tensor(THR, dtype=torch.float32)
    t_sums = [a.numpy() for a in tbs.bucket_sweep_sums(
        torch.from_numpy(x_hat), torch.from_numpy(pts), thr_t, K=K)]
    for got, want, name in zip(t_sums, j_sums, ("ab", "ba", "cnt", "ovf")):
        np.testing.assert_array_equal(got, want, err_msg=name)
    j_picks, j_ovf = jbs.select_thresholds_d1_bucket(
        jnp.asarray(x_hat), jnp.asarray(pts), thr_j,
        opt_metrics=opt_metrics, max_deltas=max_deltas, K=K,
        interpret=True)
    t_picks, t_ovf = tbs.select_thresholds_d1_bucket(
        torch.from_numpy(x_hat), torch.from_numpy(pts), thr_t,
        opt_metrics=opt_metrics, max_deltas=max_deltas, K=K)
    np.testing.assert_array_equal(t_picks.numpy(), np.asarray(j_picks))
    np.testing.assert_array_equal(t_ovf.numpy(), np.asarray(j_ovf))


def test_overflow_rerun_at_full_volume_matches_exact_sweep():
    """A block over the candidate budget is flagged; the port's rerun at
    K = B³ gives the JAX exact EDT sweep's picks."""
    occ, x_hat, pts = _batch([11, 12], lift=0.6)
    thr_t = torch.tensor(THR, dtype=torch.float32)
    _, ovf = tbs.select_thresholds_d1_bucket(
        torch.from_numpy(x_hat), torch.from_numpy(pts), thr_t, K=K)
    assert ovf.all()
    picks, ovf_full = tbs.select_thresholds_d1_bucket(
        torch.from_numpy(x_hat), torch.from_numpy(pts), thr_t, K=B ** 3)
    assert not ovf_full.any()
    want = select_thresholds_d1_batch(
        jnp.asarray(occ), jnp.asarray(x_hat), jnp.asarray(THR, jnp.float32))
    np.testing.assert_array_equal(picks.numpy(), np.asarray(want))
