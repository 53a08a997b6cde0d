"""Port D2 bucket sweep (K3's plain version on the CPU) vs the JAX package.

The JAX side runs ``_bucket_kernel_d2`` in interpret mode, single-tile and
multi-tile (``kc=128, pc=64``), as its own tests do. Tolerances:

- ``colsum`` / ``candmin`` are integer-valued below 2^24: equal.
- With integer-valued normals every plane² is an integer too:
  ``candplane`` / ``colplane`` equal.
- With random unit normals the f32 dot products may round differently
  (XLA may contract a multiply-add) and a near-perpendicular offset cancels
  to a tiny plane²: rtol 1e-5, atol 1e-5 per column; sums rtol 1e-5.
- Picks equal, except that a |Δidx| ≤ 1 is allowed where the two best
  metric values differ by < 1e-5 relative; the test counts such cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcc_geo_cnn_v2_tpu.ops import bucket_sweep as jbs
from pcc_geo_cnn_v2_tpu_torch.ops import bucket_sweep as tbs

B, T, P = 16, 256, 512
K = 1024
THR = np.linspace(0, 1.0, T)
TILES = {"single": dict(kc=1024, pc=512), "multi": dict(kc=128, pc=64)}


def _batch(seeds, normals):
    """Blocks of the kind ``tests/test_torch_bucket_sweep.py`` uses, plus
    per-point normals (``"int"``: axis-aligned ±1, ``"unit"``: random)."""
    xhats = []
    pts = np.full((len(seeds), P, 3), -1, np.int32)
    nrm = np.zeros((len(seeds), P, 3), np.float32)
    for i, seed in enumerate(seeds):
        rng = np.random.default_rng(seed)
        c = np.unique(rng.integers(0, B, (rng.integers(30, 300), 3)), axis=0)
        occ = np.zeros((B, B, B), np.float32)
        occ[c[:, 0], c[:, 1], c[:, 2]] = 1.0
        noise = rng.random((B, B, B)).astype(np.float32)
        xhats.append(np.where(noise < 0.15, 0.5 * occ + 0.5 * noise, 0.0)
                     .astype(np.float32))
        pts[i, :len(c)] = c
        if normals == "int":
            v = np.zeros((len(c), 3))
            v[np.arange(len(c)), rng.integers(0, 3, len(c))] = \
                rng.choice([-1.0, 1.0], len(c))
        else:
            v = rng.normal(size=(len(c), 3))
            v /= np.linalg.norm(v, axis=1, keepdims=True)
        nrm[i, :len(c)] = v
    return np.stack(xhats), pts, nrm


def _jax_colsums_d2(x_hat, pts, nrm, kc, pc, k=K):
    """JAX's prep + ``_bucket_colsums_pallas(nrm=)`` in interpret mode."""
    n = len(x_hat)
    flat = jnp.asarray(x_hat.reshape(n, -1))
    cnt0 = jnp.sum(flat > THR[0], axis=-1).astype(jnp.int32)
    _, pos = jax.lax.top_k(flat, k)
    valid_k = jnp.arange(k)[None, :] < cnt0[:, None]
    coords = jnp.stack([pos // (B * B), (pos // B) % B, pos % B],
                       axis=1).astype(jnp.float32)
    cand = jnp.where(valid_k[:, None, :], coords, jbs.SENTINEL)
    pts_f = jnp.asarray(pts, jnp.float32)
    n_pts = jnp.sum(pts_f[:, :, 0] >= 0, axis=-1).astype(jnp.int32)
    kt = jnp.clip((cnt0 + kc - 1) // kc, 0, k // kc)
    pt = jnp.clip((n_pts + pc - 1) // pc, 1, P // pc)
    outs = jbs._bucket_colsums_pallas(pts_f, cand, kt, pt, kc=kc, pc=pc,
                                      interpret=True, nrm=jnp.asarray(nrm))
    return [np.asarray(o) for o in outs], np.asarray(cnt0)


def _port_colsums_d2(x_hat, pts, nrm, k=K):
    _, pos, cnt0, _ = tbs.sorted_candidates(
        torch.from_numpy(x_hat), torch.tensor(THR, dtype=torch.float32), k)
    pts_t = torch.from_numpy(pts)
    npts = (pts_t[:, :, 0] >= 0).sum(-1).to(torch.int32)
    return [o.numpy() for o in tbs.bucket_colsums_d2(
        pts_t, torch.from_numpy(nrm), pos, cnt0, npts, B)]


@pytest.mark.parametrize("normals", ["int", "unit"])
@pytest.mark.parametrize("tiles", ["single", "multi"])
def test_colsums_d2_match_pallas_kernel(tiles, normals):
    x_hat, pts, nrm = _batch(range(2), normals)
    (j_colsum, j_candmin, j_colplane, j_candplane), cnt0 = _jax_colsums_d2(
        x_hat, pts, nrm, **TILES[tiles])
    colsum, candmin, colplane, candplane = _port_colsums_d2(x_hat, pts, nrm)
    tol = dict(rtol=0, atol=0) if normals == "int" else \
        dict(rtol=1e-5, atol=1e-5)
    for i, c in enumerate(cnt0):
        np.testing.assert_array_equal(colsum[i, :c], j_colsum[i, :c])
        np.testing.assert_array_equal(candmin[i, :c], j_candmin[i, :c])
        np.testing.assert_allclose(candplane[i, :c], j_candplane[i, :c],
                                   **tol)
        np.testing.assert_allclose(colplane[i, :c], j_colplane[i, :c],
                                   rtol=tol["rtol"], atol=0)


def test_d1_outputs_of_k3_plain_equal_k1_plain():
    """The d1 group's picks in a normals run are those of a run without."""
    x_hat, pts, nrm = _batch(range(2), "unit")
    _, pos, cnt0, _ = tbs.sorted_candidates(
        torch.from_numpy(x_hat), torch.tensor(THR, dtype=torch.float32), K)
    pts_t = torch.from_numpy(pts)
    npts = (pts_t[:, :, 0] >= 0).sum(-1).to(torch.int32)
    s1, m1 = tbs.bucket_colsums(pts_t, pos, cnt0, npts, B)
    s3, m3, _, _ = tbs.bucket_colsums_d2(pts_t, torch.from_numpy(nrm), pos,
                                         cnt0, npts, B)
    assert torch.equal(s1, s3) and torch.equal(m1, m3)


def _constructed(points, cands):
    """One block from explicit point rows, normals and candidates in
    sorted order (descending probabilities assigned here)."""
    pts = np.full((1, P, 3), -1, np.int32)
    nrm = np.zeros((1, P, 3), np.float32)
    for row, (p, v) in points.items():
        pts[0, row], nrm[0, row] = p, v
    # valid rows must come first: fill the gaps with far-away points
    # whose distance never ties (corner voxels, zero normals)
    top = max(points)
    filler = [(0, 0, z) for z in range(B)] + [(0, 1, z) for z in range(B)] \
        + [(1, 0, z) for z in range(B)] + [(1, 1, z) for z in range(B)] \
        + [(0, 2, z) for z in range(B)]
    it = iter(filler)
    for row in range(top):
        if row not in points:
            pts[0, row] = next(it)
    x_hat = np.zeros((1, B, B, B), np.float32)
    for k, c in enumerate(cands):
        x_hat[0][tuple(c)] = 0.99 - 1e-4 * k
    return x_hat, pts, nrm


def _both(x_hat, pts, nrm, tiles):
    (_, _, j_colplane, j_candplane), cnt0 = _jax_colsums_d2(
        x_hat, pts, nrm, **TILES[tiles])
    _, _, colplane, candplane = _port_colsums_d2(x_hat, pts, nrm)
    c = int(cnt0[0])
    np.testing.assert_array_equal(colplane[0, :c], j_colplane[0, :c])
    np.testing.assert_array_equal(candplane[0, :c], j_candplane[0, :c])
    return colplane[0, :c], candplane[0, :c]


@pytest.mark.parametrize("first", [0, 1])
def test_tie_rule_prefix_argmin_keeps_earlier_candidate(first):
    """colplane: point (8,8,8) with normal +x; candidates (9,8,8) [plane²
    1] and (8,9,8) [plane² 0] are both at d² = 1. The one sorted first
    keeps the prefix argmin."""
    cands = [(9, 8, 8), (8, 9, 8)]
    if first:
        cands.reverse()
    x_hat, pts, nrm = _constructed({0: ((8, 8, 8), (1, 0, 0))}, cands)
    colplane, _ = _both(x_hat, pts, nrm, "single")
    want = [1.0, 1.0] if first == 0 else [0.0, 0.0]
    np.testing.assert_array_equal(colplane, want)


@pytest.mark.parametrize("tiles,rows", [("single", (0, 1)),
                                        ("multi", (3, 70))])
@pytest.mark.parametrize("swap", [False, True])
def test_tie_rule_column_argmin_keeps_lowest_row(tiles, rows, swap):
    """candplane: candidate (8,8,8); originals (9,8,8) and (8,9,8), both
    with normal +x, are at d² = 1 with plane² 1 and 0. The lower point
    row wins — within a tile, and across point tiles (rows 3 and 70 sit
    in different 64-row tiles of the JAX kernel)."""
    a, b = ((9, 8, 8), (1, 0, 0)), ((8, 9, 8), (1, 0, 0))
    if swap:
        a, b = b, a
    x_hat, pts, nrm = _constructed({rows[0]: a, rows[1]: b}, [(8, 8, 8)])
    _, candplane = _both(x_hat, pts, nrm, tiles)
    np.testing.assert_array_equal(candplane, [0.0 if swap else 1.0])


def test_tie_rule_prefix_argmin_across_candidate_tiles():
    """The earlier candidate keeps a distance tie even when the tied one
    arrives 150 columns later, in another 128-wide candidate tile."""
    far = [(15, y, z) for y in range(10) for z in range(15)]  # d² ≥ 49
    cands = [(9, 8, 8)] + far + [(8, 9, 8)]
    x_hat, pts, nrm = _constructed({0: ((8, 8, 8), (1, 0, 0))}, cands)
    colplane, _ = _both(x_hat, pts, nrm, "multi")
    assert colplane[0] == 1.0 and colplane[-1] == 1.0


@pytest.mark.parametrize("normals", ["int", "unit"])
def test_sweep_sums_d2_match_jax(normals):
    x_hat, pts, nrm = _batch(range(3, 6), normals)
    j = [np.asarray(a) for a in jbs.bucket_sweep_sums(
        jnp.asarray(x_hat), jnp.asarray(pts), jnp.asarray(THR, jnp.float32),
        K=K, kc=256, pc=64, interpret=True, nrm=jnp.asarray(nrm))]
    t = [a.numpy() for a in tbs.bucket_sweep_sums(
        torch.from_numpy(x_hat), torch.from_numpy(pts),
        torch.tensor(THR, dtype=torch.float32), K=K,
        nrm=torch.from_numpy(nrm))]
    for got, want, name in zip(t[:4], j[:4], ("ab", "ba", "cnt", "ovf")):
        np.testing.assert_array_equal(got, want, err_msg=name)
    for got, want, name in zip(t[4:], j[4:], ("ab2", "ba2")):
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)


def _near_tie(sweep_vals, a, b):
    va, vb = sweep_vals[a], sweep_vals[b]
    return abs(va - vb) <= 1e-5 * max(abs(va), abs(vb))


@pytest.mark.parametrize("k", [K, B ** 3])
def test_picks_d1_d2_match_jax(k):
    """d1 + d2 opt metrics × max_deltas, at the sweep's budget and at the
    overflow rerun's K = B³."""
    opt_metrics = ("d1_mse", "d2_mse", "d2_sum_max", "d2_mse_AB")
    max_deltas = (np.inf, 2.0)
    x_hat, pts, nrm = _batch(range(6, 10), "unit")
    kw = dict(opt_metrics=opt_metrics, max_deltas=max_deltas, K=k)
    j_picks, j_ovf = jbs.select_thresholds_d1_bucket(
        jnp.asarray(x_hat), jnp.asarray(pts), jnp.asarray(THR, jnp.float32),
        interpret=True, nrm=jnp.asarray(nrm), **kw)
    thr_t = torch.tensor(THR, dtype=torch.float32)
    t_picks, t_ovf = tbs.select_thresholds_d1_bucket(
        torch.from_numpy(x_hat), torch.from_numpy(pts), thr_t,
        nrm=torch.from_numpy(nrm), **kw)
    np.testing.assert_array_equal(t_ovf.numpy(), np.asarray(j_ovf))
    got, want = t_picks.numpy(), np.asarray(j_picks)
    # the d1 columns are integer sums: always equal
    d1_cols = [i for i, m in enumerate(opt_metrics * len(max_deltas))
               if m.startswith("d1")]
    np.testing.assert_array_equal(got[:, d1_cols], want[:, d1_cols])
    near_ties = 0
    if not np.array_equal(got, want):
        res = tbs.bucket_sweep_sums(
            torch.from_numpy(x_hat), torch.from_numpy(pts), thr_t, K=k,
            nrm=torch.from_numpy(nrm))
        n_orig = (pts[:, :, 0] >= 0).sum(-1)
        sweep = tbs.metrics_from_sums(
            res[4], res[5], torch.tensor(n_orig, dtype=torch.float32)[:, None],
            res[2], prefix="d2")
        names = opt_metrics * len(max_deltas)
        for b, m in zip(*np.nonzero(got != want)):
            assert abs(int(got[b, m]) - int(want[b, m])) <= 1, (b, m)
            assert _near_tie(sweep[names[m]][b].numpy(), got[b, m],
                             want[b, m]), (b, m, got[b, m], want[b, m])
            near_ties += 1
    print(f"near-tie pick differences: {near_ties} of {got.size}")
    assert near_ties <= 2
