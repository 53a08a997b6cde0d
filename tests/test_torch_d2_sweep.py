"""The port's argmin / carry EDTs and d2 threshold sweeps against the JAX
functions on the CPU, at B = 16 with 64 thresholds, and the point sweep at
full size (the flagship model's x_hat on a 64³ block, band 12).

- ``squared_edt_argmin`` / ``squared_edt_carry``: distances and carried
  values equal, on tie-heavy volumes (sources in equidistant pairs along
  every axis) — the smallest source index of each pass wins a tie;
- ``d2_sweep``, ``d2_sweep_pts`` (``band=None`` and ``band=3``): metric
  arrays within rtol 1e-5 wherever the candidate set is not empty (the
  JAX package sums normal votes in f32, the port in fixed point);
- ``select_thresholds_device`` / ``_pts``: picks equal wherever the best
  two candidates differ by more than rtol 1e-5;
- the JAX cases of ``tests/test_threshold_sweep.py`` (the d2 sweep near
  the host KD-tree metric, d1 picks exact beside d2, the point sweep equal
  to the grid sweep) on the port;
- the vote sums do not depend on the order of the votes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcc_geo_cnn_v2_tpu.ops import edt as jedt
from pcc_geo_cnn_v2_tpu.ops import threshold_sweep as jts
from pcc_geo_cnn_v2_tpu.ops.voxel import voxelize_attrs as jax_voxelize_attrs
from pcc_geo_cnn_v2_tpu_torch.ops import edt as tedt
from pcc_geo_cnn_v2_tpu_torch.ops import threshold_sweep as tts
from pcc_geo_cnn_v2_tpu_torch.ops.voxel import voxelize_attrs
from pcc_geo_cnn_v2_tpu_torch.utils.metrics import compute_metrics
from pcc_geo_cnn_v2_tpu_torch.utils.threshold import (
    compute_optimal_thresholds,
)

B, T, P = 16, 64, 512
RTOL = 1e-5
THR = np.linspace(0, 1.0, T)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread for this file: test files run in parallel
    worker processes, and torch's default of a thread a core oversubscribes
    the CPU many times over on these small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tie_volume(seed, shape=(3, 12, 11, 9)):
    """Sources in pairs at ±d along every axis of random centres: most
    voxels have two or more equidistant nearest sources."""
    rng = np.random.default_rng(seed)
    occ = np.zeros(shape, bool)
    hi = np.array(shape[1:]) - 1
    for b in range(shape[0] - 1):  # the last volume stays empty
        for _ in range(4):
            c = rng.integers(2, hi - 1)
            d = int(rng.integers(1, 3))
            for ax in range(3):
                for s in (-d, d):
                    q = c.copy()
                    q[ax] += s
                    occ[(b, *np.clip(q, 0, hi))] = True
    return occ


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_argmin_edt_ties_equal_jax(seed):
    occ = _tie_volume(seed)
    dj, nj = jedt.squared_edt_argmin(jnp.asarray(occ))
    dt, nt = tedt.squared_edt_argmin(torch.from_numpy(occ))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert nt.dtype == torch.int32 and nt.shape == occ.shape + (3,)
    # the tie rule matters here: some voxel has two nearest sources
    pts = np.argwhere(occ[0])
    grid = np.argwhere(np.ones(occ.shape[1:], bool))
    d = ((grid[:, None] - pts[None]) ** 2).sum(-1)
    assert ((d == d.min(1, keepdims=True)).sum(1) > 1).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_carry_edt_equal_jax(seed):
    occ = _tie_volume(seed + 10)
    rng = np.random.default_rng(seed)
    vals = [rng.normal(size=occ.shape).astype(np.float32) for _ in range(2)]
    dj, cj = jedt.squared_edt_carry(jnp.asarray(occ),
                                    [jnp.asarray(v) for v in vals])
    dt, ct = tedt.squared_edt_carry(torch.from_numpy(occ),
                                    [torch.from_numpy(v) for v in vals])
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    for a, b in zip(ct, cj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _case(seed, lift=0.0):
    """``tests/test_threshold_sweep.py``'s block: random points and a
    probability field correlated with them, plus unit normals."""
    rng = np.random.default_rng(seed)
    pts = np.unique(rng.integers(0, B, (rng.integers(30, 300), 3)), axis=0)
    occ = np.zeros((B, B, B), np.float32)
    occ[pts[:, 0], pts[:, 1], pts[:, 2]] = 1.0
    noise = rng.random((B, B, B)).astype(np.float32)
    x_hat = np.clip(0.65 * occ + 0.35 * noise + lift, 0.0, 1.0)
    rng = np.random.default_rng(seed + 100)
    n = rng.normal(size=(len(pts), 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    grid_n = np.zeros((B, B, B, 3), np.float32)
    grid_n[pts[:, 0], pts[:, 1], pts[:, 2]] = n
    pad = np.full((P, 3), -1, np.int32)
    pad[:len(pts)] = pts
    npad = np.zeros((P, 3), np.float32)
    npad[:len(pts)] = n
    return dict(pts=pts.astype(np.float64), n=n, occ=occ, x_hat=x_hat,
                grid_n=grid_n, pad=pad, npad=npad)


def _batch(seeds):
    cases = [_case(s) for s in seeds]
    return cases, {k: torch.from_numpy(np.stack([c[k] for c in cases]))
                   for k in ("occ", "x_hat", "grid_n", "pad", "npad")}


def _thr_t():
    return torch.tensor(THR, dtype=torch.float32)


def _thr_j():
    return jnp.asarray(THR, jnp.float32)


def _close(got, want, count):
    nz = np.asarray(count) > 0
    for k in tts.D2_METRICS:
        np.testing.assert_allclose(got[k][nz], np.asarray(want[k])[nz],
                                   rtol=RTOL, err_msg=k)


def test_voxelize_attrs_equals_jax():
    _, t = _batch([0, 1])
    want = jax_voxelize_attrs(jnp.asarray(t["pad"].numpy()),
                              jnp.asarray(t["npad"].numpy()), B)
    got = voxelize_attrs(t["pad"], t["npad"], B)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), t["grid_n"].numpy())


def test_d2_sweep_equals_jax():
    cases, t = _batch([0, 1, 2])
    got = tts.d2_sweep(t["occ"], t["grid_n"], t["x_hat"], _thr_t())
    for i, c in enumerate(cases):
        want = jts.d2_sweep(jnp.asarray(c["occ"]), jnp.asarray(c["grid_n"]),
                            jnp.asarray(c["x_hat"]), _thr_j())
        np.testing.assert_array_equal(got["count"][i], want["count"])
        _close({k: v[i].numpy() for k, v in got.items()}, want,
               want["count"])


@pytest.mark.parametrize("band", [None, 3])
def test_d2_sweep_pts_equals_jax(band):
    cases, t = _batch([3, 4, 5])
    got = tts.d2_sweep_pts(t["occ"], t["pad"], t["npad"], t["x_hat"],
                           _thr_t(), band=band)
    for i, c in enumerate(cases):
        want = jts.d2_sweep_pts(jnp.asarray(c["occ"]), jnp.asarray(c["pad"]),
                                jnp.asarray(c["npad"]),
                                jnp.asarray(c["x_hat"]), _thr_j(), band=band)
        np.testing.assert_array_equal(got["count"][i], want["count"])
        _close({k: v[i].numpy() for k, v in got.items()}, want,
               want["count"])


def _picks_agree(got, want, sweep, opt_metrics, max_deltas):
    """Picks equal, or both candidates within rtol of each other in the
    JAX sweep's metric (a near-tie the two summation orders may split)."""
    names = [m for _ in max_deltas for m in opt_metrics]
    for g, w, m in zip(got, want, names):
        if g == w:
            continue
        a, b = float(sweep[m][g]), float(sweep[m][w])
        assert abs(a - b) <= RTOL * max(abs(a), abs(b)), (m, g, w, a, b)


OMS = ("d1_mse", "d2_mse", "d2_mse_BA", "d2_sum_max")
MDS = (np.inf, 1.5)


def test_select_thresholds_device_equals_jax():
    cases, t = _batch([40, 41, 42, 43])
    got = tts.select_thresholds_device(t["occ"], t["x_hat"], _thr_t(),
                                       normals=t["grid_n"], opt_metrics=OMS,
                                       max_deltas=MDS).numpy()
    for i, c in enumerate(cases):
        want = np.asarray(jts.select_thresholds_device(
            jnp.asarray(c["occ"]), jnp.asarray(c["x_hat"]), _thr_j(),
            normals=jnp.asarray(c["grid_n"]), opt_metrics=OMS,
            max_deltas=MDS))
        sweep = jts.d2_sweep(jnp.asarray(c["occ"]), jnp.asarray(c["grid_n"]),
                             jnp.asarray(c["x_hat"]), _thr_j())
        sweep.update(jts.d1_sweep(jnp.asarray(c["occ"]),
                                  jnp.asarray(c["x_hat"]), _thr_j()))
        _picks_agree(got[i], want, sweep, OMS, MDS)


@pytest.mark.parametrize("band", [None, 3])
def test_select_thresholds_device_pts_equals_jax(band):
    cases, t = _batch([44, 45, 46])
    got = tts.select_thresholds_device_pts(
        t["occ"], t["x_hat"], _thr_t(), t["pad"], t["npad"],
        opt_metrics=OMS, max_deltas=MDS, band=band).numpy()
    for i, c in enumerate(cases):
        args = [jnp.asarray(c[k]) for k in ("occ", "x_hat")]
        want = np.asarray(jts.select_thresholds_device_pts(
            *args, _thr_j(), jnp.asarray(c["pad"]), jnp.asarray(c["npad"]),
            opt_metrics=OMS, max_deltas=MDS, band=band))
        sweep = jts.d2_sweep_pts(args[0], jnp.asarray(c["pad"]),
                                 jnp.asarray(c["npad"]), args[1], _thr_j(),
                                 band=band)
        sweep.update(jts.d1_sweep(*args, _thr_j()))
        _picks_agree(got[i], want, sweep, OMS, MDS)


def test_select_d1_only_and_all_below():
    """d1 metrics alone through the point sweep equal the d1 grid
    selection; a block whose x_hat never exceeds threshold 0 picks T-1."""
    cases, t = _batch([7, 8])
    t["x_hat"][1] = 0.0
    oms = ("d1_mse", "d1_mse_BA", "d1_sum_max")
    got = tts.select_thresholds_device_pts(
        t["occ"], t["x_hat"], _thr_t(), t["pad"], t["npad"],
        opt_metrics=oms, max_deltas=MDS, band=12)
    want = tts.select_thresholds_d1_batch(t["occ"], t["x_hat"], _thr_t(),
                                          opt_metrics=oms, max_deltas=MDS)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert (got[1] == T - 1).all()
    with pytest.raises(ValueError, match="normals"):
        tts.select_thresholds_device(t["occ"], t["x_hat"], _thr_t(),
                                     opt_metrics=("d2_mse",))


# -- the JAX package's cases (tests/test_threshold_sweep.py) on the port --


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_d2_sweep_values_close_to_host(seed):
    c = _case(seed)
    occ, xh = (torch.from_numpy(c[k])[None] for k in ("occ", "x_hat"))
    sweep = tts.d2_sweep(occ, torch.from_numpy(c["grid_n"])[None], xh,
                         _thr_t())
    checked = 0
    for t_idx in (0, 8, 24):
        cand = np.argwhere(c["x_hat"] > THR[t_idx]).astype(np.float64)
        if len(cand) == 0:
            continue
        ref = compute_metrics(c["pts"], cand, B - 1, p1_n=c["n"])
        np.testing.assert_allclose(float(sweep["d2_sum_BA"][0, t_idx]),
                                   ref["d2_sum_BA"], rtol=0.1)
        np.testing.assert_allclose(float(sweep["d2_sum_AB"][0, t_idx]),
                                   ref["d2_sum_AB"], rtol=0.15)
        checked += 1
    assert checked >= 2


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_mixed_d1_d2_selection_close_to_host(seed):
    c = _case(seed + 40)
    _, host_pick = compute_optimal_thresholds(
        c["pts"], c["x_hat"], THR, B, normals=c["n"],
        opt_metrics=("d1_mse", "d2_mse"))
    dev_pick = tts.select_thresholds_device(
        torch.from_numpy(c["occ"])[None], torch.from_numpy(c["x_hat"])[None],
        _thr_t(), normals=torch.from_numpy(c["grid_n"])[None],
        opt_metrics=("d1_mse", "d2_mse"))[0].tolist()
    assert dev_pick[0] == host_pick[0], "d1 pick must be exact"

    def host_d2(t_idx):
        cand = np.argwhere(c["x_hat"] > THR[t_idx]).astype(np.float64)
        if len(cand) == 0:
            return np.inf
        return compute_metrics(c["pts"], cand, B - 1, p1_n=c["n"])["d2_mse"]

    v_dev, v_host = host_d2(dev_pick[1]), host_d2(host_pick[1])
    assert v_dev <= v_host * 1.02 + 1e-9, (dev_pick, host_pick)


def test_carry_gathers_at_argmin():
    rng = np.random.default_rng(9)
    occ = torch.from_numpy(rng.random((8, 8, 8)) < 0.06)
    occ[1, 6, 2] = True
    val = torch.from_numpy(rng.normal(size=(8, 8, 8)).astype(np.float32))
    dist_a, nn = tedt.squared_edt_argmin(occ)
    dist_c, (carried,) = tedt.squared_edt_carry(occ, [val])
    assert torch.equal(dist_c, dist_a)
    nn = nn.long()
    assert torch.equal(carried, val[nn[..., 0], nn[..., 1], nn[..., 2]])
    assert occ[nn[..., 0], nn[..., 1], nn[..., 2]].all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_d2_sweep_pts_matches_grid(seed):
    cases, t = _batch([seed])
    ref = tts.d2_sweep(t["occ"], t["grid_n"], t["x_hat"], _thr_t())
    got = tts.d2_sweep_pts(t["occ"], t["pad"], t["npad"], t["x_hat"],
                           _thr_t(), band=None)
    assert torch.equal(got["count"], ref["count"])
    nz = ref["count"] > 0
    for k in ("d2_sum_AB", "d2_sum_BA", "d2_mse"):
        np.testing.assert_allclose(got[k][nz], ref[k][nz], rtol=2e-5)


def test_select_pts_matches_select_grid():
    _, t = _batch([40, 41, 42, 43])
    oms = ("d1_mse", "d2_mse", "d2_mse_BA")
    grid = tts.select_thresholds_device(t["occ"], t["x_hat"], _thr_t(),
                                        normals=t["grid_n"], opt_metrics=oms,
                                        max_deltas=MDS)
    pts = tts.select_thresholds_device_pts(
        t["occ"], t["x_hat"], _thr_t(), t["pad"], t["npad"],
        opt_metrics=oms, max_deltas=MDS, band=None)
    assert torch.equal(pts, grid)


def test_vote_sums_do_not_depend_on_vote_order():
    """Two runs, and a run on the same points in another row order, give
    bit-equal d2 arrays: the votes are summed in fixed point."""
    _, t = _batch([5, 6])
    args = (t["occ"], t["pad"], t["npad"], t["x_hat"], _thr_t())
    a = tts.d2_sweep_pts(*args, band=3)
    b = tts.d2_sweep_pts(*args, band=3)
    perm = torch.from_numpy(np.random.default_rng(0).permutation(P))
    c = tts.d2_sweep_pts(t["occ"], t["pad"][:, perm], t["npad"][:, perm],
                         t["x_hat"], _thr_t(), band=3)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # the AB sum adds the points in row order, so a permutation moves it by
    # rounding; the votes themselves are checked order-free below
    assert torch.equal(a["d2_sum_BA"], c["d2_sum_BA"])
    np.testing.assert_allclose(c["d2_sum_AB"], a["d2_sum_AB"], rtol=RTOL)
    tgt = torch.tensor([[3, 3, 3, 1, 0, 3]])
    w = torch.ones(1, 6)
    vals = torch.randn(1, 6, 3, generator=torch.Generator().manual_seed(0))
    cnt, sums = tts._vote_sums(tgt, w, vals, 4)
    order = torch.tensor([5, 2, 0, 4, 3, 1])
    cnt2, sums2 = tts._vote_sums(tgt[:, order], w, vals[:, order], 4)
    assert torch.equal(cnt, cnt2) and torch.equal(sums, sums2)
    assert cnt.tolist() == [[1, 1, 0, 4]]


def test_d2_sweep_pts_equals_jax_on_a_flagship_block():
    """Full size: the flagship model's x_hat on one 64³ block of the
    flagship cloud (c3p, committed weights, the port's canonical decode on
    the CPU), the codec's band 12, every 8th threshold of its grid."""
    from pathlib import Path

    from pcc_geo_cnn_v2_tpu_torch.codec import BlockCodec
    from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
    from pcc_geo_cnn_v2_tpu_torch.ops.voxel import flatten_blocks, pack_coords
    from pcc_geo_cnn_v2_tpu_torch.utils.octree import partition_octree
    from pcc_geo_cnn_v2_tpu_torch.utils.scansim import figure_cloud
    from pcc_geo_cnn_v2_tpu_torch.weights import load_asset_tree

    asset = (Path(__file__).resolve().parent.parent
             / "pcc_geo_cnn_v2_tpu/assets/bench_c3p.msgpack.gz")
    pts, nrm = figure_cloud(300, 1024, with_normals=True)
    blocks, _ = partition_octree(np.hstack([pts, nrm]), [0, 0, 0],
                                 [1024] * 3, 4)
    blocks = blocks[:1]
    codec = BlockCodec(build_model("c3p"), load_asset_tree(asset),
                       block_size=64, batch_blocks=1, device="cpu")
    flat, off = flatten_blocks(blocks)
    budget = int(2 ** np.ceil(np.log2(len(blocks[0]))))
    p = codec.chunk_points(torch.from_numpy(pack_coords(flat, 64)), off, 0,
                           1, budget)
    n = codec.chunk_normals(torch.from_numpy(flatten_blocks(
        blocks, cols=(3, 4, 5), dtype=np.float32)[0]), off, 0, 1, budget)
    res = codec.canonical_chunk(p, 1)
    occ, xh = res["x"][..., 0], res["x_hat"][..., 0]
    thr = codec.thr_dev[::8].contiguous()
    got = tts.d2_sweep_pts(occ, p, n, xh, thr, band=codec.d2_band)
    want = jts.d2_sweep_pts(*(jnp.asarray(a[0].numpy())
                              for a in (occ, p, n, xh)),
                            jnp.asarray(thr.numpy()), band=codec.d2_band)
    np.testing.assert_array_equal(got["count"][0], want["count"])
    assert (np.asarray(want["count"]) > 0).sum() > 16
    _close({k: v[0].numpy() for k, v in got.items()}, want, want["count"])
