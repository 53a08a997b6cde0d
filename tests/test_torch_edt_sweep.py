"""Port exact-EDT sweep (K5's plain version on the CPU) vs the JAX package.

The JAX side runs ``_sweep_kernel`` in interpret mode
(``d1_sweep_sums_pallas(interpret=True)``), with and without the point
lists. Squared distances and their sums are integer-valued and stay below
2^24 at these sizes, so everything here compares equal: EDTs, argmins
(where the distance is within the band), sums, counts and picks — and the
port's three sweep backends agree with each other.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcc_geo_cnn_v2_tpu.ops import edt as jedt
from pcc_geo_cnn_v2_tpu.ops.pallas_sweep import d1_sweep_sums_pallas
from pcc_geo_cnn_v2_tpu.ops import threshold_sweep as jts
from pcc_geo_cnn_v2_tpu_torch.ops import edt as tedt
from pcc_geo_cnn_v2_tpu_torch.ops import edt_sweep as tes
from pcc_geo_cnn_v2_tpu_torch.ops import threshold_sweep as tts
from pcc_geo_cnn_v2_tpu_torch.ops.bucket_sweep import (
    select_thresholds_d1_bucket,
)

B, T, P = 16, 256, 512
THR = np.linspace(0, 1.0, T)
THR_T = torch.tensor(THR, dtype=torch.float32)
THR_J = jnp.asarray(THR, jnp.float32)


def _batch(seeds, lift=0.0):
    occs, xhats = [], []
    pts = np.full((len(seeds), P, 3), -1, np.int32)
    for i, seed in enumerate(seeds):
        rng = np.random.default_rng(seed)
        c = np.unique(rng.integers(0, B, (rng.integers(30, 300), 3)), axis=0)
        occ = np.zeros((B, B, B), np.float32)
        occ[c[:, 0], c[:, 1], c[:, 2]] = 1.0
        noise = rng.random((B, B, B)).astype(np.float32)
        x_hat = np.where(noise < 0.15, 0.5 * occ + 0.5 * noise, 0.0)
        xhats.append(np.clip(x_hat + lift * noise, 0.0, 1.0)
                     .astype(np.float32))
        occs.append(occ)
        c = np.argwhere(occ > 0)
        pts[i, :len(c)] = c
    return np.stack(occs), np.stack(xhats), pts


def test_squared_edt_matches_jax():
    rng = np.random.default_rng(0)
    occ = rng.random((3, B, B, B)) < 0.01
    occ[2] = False  # an empty grid: INF everywhere
    got = tedt.squared_edt(torch.from_numpy(occ)).numpy()
    want = np.asarray(jedt.squared_edt(jnp.asarray(occ)))
    np.testing.assert_array_equal(got, want)
    assert (got[2] >= tedt.INF).all()
    one = tedt.minplus_1d(torch.tensor(want[0]), axis=1).numpy()
    np.testing.assert_array_equal(
        one, np.asarray(jedt.minplus_1d(jnp.asarray(want[0]), axis=1)))


@pytest.mark.parametrize("band", [3, 6])
def test_banded_edt_argmin_matches_jax(band):
    rng = np.random.default_rng(1)
    occ = rng.random((2, 20, 20, 20)) < 0.001
    d_t, nn_t = tedt.banded_squared_edt_argmin(torch.from_numpy(occ), band)
    d_j, nn_j = jedt.banded_squared_edt_argmin(jnp.asarray(occ), band)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    ok = np.asarray(d_j) <= band * band
    assert ok.any() and (~ok).any()
    np.testing.assert_array_equal(nn_t.numpy()[ok], np.asarray(nn_j)[ok])
    # and the distance is the true one wherever it is within the band
    full = np.asarray(jedt.squared_edt(jnp.asarray(occ)))
    np.testing.assert_array_equal(d_t.numpy()[ok], full[ok])


@pytest.mark.parametrize("with_pts", [True, False])
def test_sweep_sums_match_pallas_kernel(with_pts):
    occ, x_hat, pts = _batch(range(3))
    j_ab, j_ba, j_cnt, j_dt = [np.asarray(a) for a in d1_sweep_sums_pallas(
        jnp.asarray(x_hat), jnp.asarray(occ), THR_J, interpret=True,
        pts=jnp.asarray(pts) if with_pts else None)]
    ab, ba, cnt, dt = [a.numpy() for a in tes.d1_sweep_sums(
        torch.from_numpy(x_hat), torch.from_numpy(occ), THR_T,
        pts=torch.from_numpy(pts) if with_pts else None)]
    np.testing.assert_array_equal(dt, j_dt)
    np.testing.assert_array_equal(cnt, j_cnt)
    np.testing.assert_array_equal(ba, j_ba)
    np.testing.assert_array_equal(ab, j_ab)
    # the sparse split moves no value: both ways are exact
    assert (cnt[:, 0] > 256).all() and (cnt > 0).sum() > (cnt > 256).sum()


def test_plain_sums_independent_of_sparse_split():
    occ, x_hat, pts = _batch([4, 5])
    args = (torch.from_numpy(x_hat), torch.from_numpy(occ), THR_T)
    a = tes.d1_sweep_sums(*args)
    b = tes.d1_sweep_sums(*args, pts=torch.from_numpy(pts), sparse_k=40)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("opt_metrics,max_deltas", [
    (("d1_mse",), (np.inf,)),
    (("d1_mse", "d1_mse_BA", "d1_sum_max"), (np.inf, 2.0)),
])
def test_picks_match_jax_and_the_bucket_backend(opt_metrics, max_deltas):
    occ, x_hat, pts = _batch(range(6, 10))
    kw = dict(opt_metrics=opt_metrics, max_deltas=max_deltas)
    want = np.asarray(jts.select_thresholds_d1_pallas(
        jnp.asarray(occ), jnp.asarray(x_hat), THR_J, interpret=True,
        pts=jnp.asarray(pts), **kw))
    np.testing.assert_array_equal(want, np.asarray(
        jts.select_thresholds_d1_batch(jnp.asarray(occ), jnp.asarray(x_hat),
                                       THR_J, **kw)))
    occ_t, xh_t, pts_t = (torch.from_numpy(a) for a in (occ, x_hat, pts))
    pallas = tts.select_thresholds_d1_pallas(occ_t, xh_t, THR_T, pts=pts_t,
                                             **kw)
    batch = tts.select_thresholds_d1_batch(occ_t, xh_t, THR_T, **kw)
    bucket, ovf = select_thresholds_d1_bucket(xh_t, pts_t, THR_T, K=B ** 3,
                                              **kw)
    assert not ovf.any()
    for got in (pallas, batch, bucket):
        np.testing.assert_array_equal(got.numpy(), want)
    one = tts.select_thresholds_d1(occ_t[0], xh_t[0], THR_T, **kw)
    np.testing.assert_array_equal(one.numpy(), want[0])


def test_degenerate_blocks():
    """An empty candidate set at t = 0 (x_hat = 0) and the full volume at
    every threshold below 1 (x_hat = 1)."""
    occ, x_hat, pts = _batch([11, 12])
    x_hat[0] = 0.0
    x_hat[1] = 1.0
    j = [np.asarray(a) for a in d1_sweep_sums_pallas(
        jnp.asarray(x_hat), jnp.asarray(occ), THR_J, interpret=True,
        pts=jnp.asarray(pts))]
    occ_t, xh_t, pts_t = (torch.from_numpy(a) for a in (occ, x_hat, pts))
    t = [a.numpy() for a in tes.d1_sweep_sums(xh_t, occ_t, THR_T, pts=pts_t)]
    for got, want in zip(t, j):
        np.testing.assert_array_equal(got, want)
    ab, ba, cnt = t[:3]
    assert (cnt[0] == 0).all() and (ab[0] >= tedt.INF).all()
    assert (cnt[1, :-1] == B ** 3).all() and cnt[1, -1] == 0
    assert (ab[1, :-1] == 0).all()
    want = np.asarray(jts.select_thresholds_d1_pallas(
        jnp.asarray(occ), jnp.asarray(x_hat), THR_J, interpret=True,
        pts=jnp.asarray(pts)))
    for fn in (tts.select_thresholds_d1_pallas, tts.select_thresholds_d1_batch):
        np.testing.assert_array_equal(fn(occ_t, xh_t, THR_T).numpy(), want)
    assert want[0, 0] == T - 1  # no eligible threshold: the last index
