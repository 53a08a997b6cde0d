"""K3's host side and the arithmetic of its design
(``pcc_geo_cnn_v2_tpu_torch.ops.bucket_sweep``, ``csrc/bucket_colsums_d2.cu``).

The kernel runs only on the card (``chip_smoke.py`` holds it against its
plain version there). Checked here: the launch plan covers every (block,
point) once and matches the source's indexing; the biased candidate
records give the (d², row) key exactly over the whole d² range at B = 64;
a numpy mirror of the kernel's arithmetic (strict-improvement deltas, the
32-bit wrapping d² sums, the fixed-point plane² deltas in two 32-bit
shared columns per CTA, the minimum of keys) equals the plain version and
the JAX kernel in interpret mode on seeded tie-heavy inputs; the
wrapper's limits, the constants shared with the source, the kernel names
the profile tool counts.

Tolerances: colsum, candmin and candplane equal (0). colplane: the mirror
sums each plane² rounded to 2^-20, at most ``npts · 2^-21`` from the exact
sum; against the plain version's f32 (its f64 sum rounded once) that is
``npts · 2^-21`` plus one f32 step of the value (each side rounds to f32
once), and 0 against the JAX kernel with integer normals (every plane²
an integer).
"""

import importlib.util
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcc_geo_cnn_v2_tpu.ops import bucket_sweep as jbs
from pcc_geo_cnn_v2_tpu_torch.ops import bucket_sweep as bsw
from pcc_geo_cnn_v2_tpu_torch.ops import kernels

SOURCE = "bucket_colsums_d2.cu"
H100_SMS = 132


def _text():
    return (kernels.CSRC / SOURCE).read_text()


def _constant(pattern):
    """An integer constant of the kernel source."""
    found = re.findall(pattern, _text())
    assert len(found) == 1, (pattern, found)
    return int(found[0])


def _const(name):
    return _constant(rf"constexpr \w+ {name} = (\d+)")


NT, TK, G = _const("NT"), _const("TK"), _const("G")
ROW_BITS, LO_BITS = _const("ROW_BITS"), _const("LO_BITS")
BIAS = float(1 << 23)
FIX = float(1 << 20)
NOKEY = 0xFFFFFFFF


# --- the launch plan ------------------------------------------------------

def test_plan_matches_the_kernel():
    """K3 runs under K1's plan (``bucket_plan``, whose cover of every
    (block, point) once ``tests/test_torch_bucket_k1_plan.py`` checks): its
    threads are K3's sweep CTA, its grid the one the C entry launches, and
    the kernel takes point row blockIdx.x · NT + threadIdx.x of block
    ``order[blockIdx.y]``."""
    src = _text()
    assert NT == bsw.K1_THREADS
    assert re.search(r"bucket_d2_kernel<<<dim3\(tiles, N\), NT, SMEM, st>>>",
                     src)
    assert re.search(r"const int p = blockIdx\.x \* NT \+ threadIdx\.x;", src)
    assert re.search(r"const int n = order\[blockIdx\.y\];", src)
    assert re.search(r"threads != NT \|\| \(int64_t\)tiles \* NT < P", src)


def test_shared_memory_and_occupancy_at_the_main_path_shapes():
    """The sweep's dynamic shared memory (two record tiles, the high / low
    plane columns, the d² delta and key columns, four 32 × 33 key buffers)
    fits an SM 4 times, the launch bound the source derives; the flagship's
    32-block chunks and its 7-block rerun (2^15 point rows) give at least
    two waves of CTAs."""
    tp = _const("TP")
    smem = 2 * TK * (16 + 8 + 4 + 4) + (NT // 32) * 32 * tp * 4
    assert smem == 49664 and smem <= 232448
    ctas = min(233472 // (smem + 1024), 8)
    assert ctas == 4
    assert re.search(r"__launch_bounds__\(NT, CTAS_SM\)\s+bucket_d2_kernel\(",
                     _text())
    for n_blocks in (32, 7):
        grid = bsw.bucket_plan(n_blocks, 1 << 15)["grid"]
        assert grid[0] * grid[1] >= 2 * ctas * H100_SMS


# --- the key scheme -------------------------------------------------------

def _records(c):
    """The prep kernel's f32 records (-2x, -2y, -2z, |c|² + 2^23)."""
    c = np.asarray(c, np.int64)
    return np.concatenate([-2 * c, (c * c).sum(-1, keepdims=True) + (1 << 23)],
                          -1).astype(np.float32)


def _biased_d(p, rec):
    """fmaf(px, -2cx, fmaf(py, -2cy, fmaf(pz, -2cz, |p|² + w))) of points
    [..., 3] and records [..., 4] that broadcast; every step is exact
    (asserted), so the FMA's single rounding and numpy's two agree."""
    p = np.asarray(p, np.int64)
    pf = p.astype(np.float32)
    d = (p * p).sum(-1).astype(np.float32) + rec[..., 3]
    for axis in (2, 1, 0):
        d = d + pf[..., axis] * rec[..., axis]
        assert (d >= BIAS).all() and (d < 2 * BIAS).all()
    return d


def test_key_is_exact_over_the_whole_d2_range_at_b64():
    """Every offset (dx, dy, dz) in [-63, 63]³, at the points and
    candidates furthest from the origin that realise it and at random
    ones: d = 2^23 + d², its bits are 0x4B000000 | d², and (bits << 18) |
    row is the (d² << 18) | row key; every d² up to 3 · 63² is reached."""
    size = 64
    r = np.arange(-(size - 1), size)
    off = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    rng = np.random.default_rng(0)
    for p in (np.maximum(off, 0), np.maximum(off, 0) + rng.integers(
            0, size - np.abs(off))):
        c = p - off
        assert (c >= 0).all() and (c < size).all() and (p < size).all()
        d = _biased_d(p, _records(c))
        d2 = (off ** 2).sum(-1)
        bits = d.view(np.uint32).astype(np.int64)
        np.testing.assert_array_equal(bits, 0x4B000000 | d2)
        row = rng.integers(0, 1 << ROW_BITS, len(d2))
        key = ((bits << ROW_BITS) | row) & 0xFFFFFFFF
        np.testing.assert_array_equal(key, (d2 << ROW_BITS) | row)
    assert d2.max() == 3 * 63 ** 2 < 1 << (32 - ROW_BITS)
    assert len(np.unique(d2)) == len(np.unique(
        (np.arange(64)[:, None, None] ** 2 + np.arange(64)[None, :, None] ** 2
         + np.arange(64)[None, None, :] ** 2)))


# --- a numpy mirror of the kernel -----------------------------------------

def _plane2(dx, dy, dz, nx, ny, nz):
    """K3's plane2: f32 products and sums, each rounded, left to right."""
    dot = np.float32(dx) * np.float32(nx)
    dot = dot + np.float32(dy) * np.float32(ny)
    dot = dot + np.float32(dz) * np.float32(nz)
    return (dot * dot).astype(np.float32)


def mirror_k3(pts, nrm, pos, cnt0, npts, size):
    """The kernel's arithmetic, point by point and candidate by candidate:
    (colsum int64, candmin int64, colplane f32, candplane f32) of [N, K]
    arrays and dict(split=per block, the per-CTA plane column sums (high,
    low); fixed=[N, K] f64, the fixed-point plane sums before their
    rounding to f32)."""
    N, P, _ = pts.shape
    K = pos.shape[1]
    colsum = np.zeros((N, K), np.int64)
    candmin = np.full((N, K), bsw.BIG, np.int64)
    colplane = np.zeros((N, K), np.float32)
    candplane = np.zeros((N, K), np.float32)
    split, fixed = [], np.zeros((N, K))
    for n in range(N):
        c0, m = int(cnt0[n]), int(npts[n])
        if c0 == 0:
            continue
        kr = (c0 + 31) // 32 * 32  # the sweep's whole groups of 32
        q = pos[n, :min(kr, K)].astype(np.int64)
        cc = np.stack([q // (size * size), q // size % size, q % size], -1)
        rec = np.concatenate([_records(cc), np.tile(
            np.float32([0, 0, 0, BIAS]), (kr - len(q), 1))])
        p = pts[n].astype(np.int64)
        v = (np.arange(P) < m) & (p[:, 0] >= 0)
        pz = np.where(v[:, None], p, 0)
        d = _biased_d(pz[:, None], rec[None])  # [P, kr]
        key = ((d.view(np.uint32).astype(np.int64) << ROW_BITS)
               | np.arange(P)[:, None]) & 0xFFFFFFFF
        key[~v] = NOKEY
        kmin = key[:, :c0].min(0) if P else np.full(c0, NOKEY)
        # running minima: strict improvement, deltas into the columns
        run = np.where(v, np.float32(3e38), np.float32(-1))
        runf = np.zeros(P, np.int64)
        ddelta = np.zeros(kr, np.uint64)
        ctas = -(-P // NT)
        hi = np.zeros((ctas, kr), np.int64)
        lo = np.zeros((ctas, kr), np.int64)
        pf = pz.astype(np.float32)
        half = np.float32(0.5)
        for k in range(kr):
            dk = d[:, k]
            imp = dk < run
            if not imp.any():
                continue
            first = run == np.float32(3e38)
            acc = (dk - np.where(first, np.float32(BIAS), run)).astype(
                np.int64) & 0xFFFFFFFF
            pl = _plane2(pf[:, 0] + half * rec[k, 0],
                         pf[:, 1] + half * rec[k, 1],
                         pf[:, 2] + half * rec[k, 2],
                         nrm[n, :, 0], nrm[n, :, 1], nrm[n, :, 2])
            f = np.rint(pl.astype(np.float64) * FIX).astype(np.int64)
            pd = f - runf
            ddelta[k] = (int(ddelta[k]) + int(acc[imp].sum())) % (1 << 32)
            for t in range(ctas):  # shared high / low columns of a CTA
                sel = imp & (np.arange(P) // NT == t) & (pd != 0)
                hi[t, k] += int((pd[sel] >> LO_BITS).sum())
                lo[t, k] += int((pd[sel] & ((1 << LO_BITS) - 1)).sum())
            run = np.where(imp, dk, run)
            runf = np.where(imp, f, runf)
        split.append((hi[:, :c0], lo[:, :c0]))
        # the flush joins a CTA's two columns; the scan sums in u64
        dplane = [sum((int(h) << LO_BITS) + int(l)
                      for h, l in zip(hi[:, k], lo[:, k])) % (1 << 64)
                  for k in range(c0)]
        csum, psum = 0, 0
        for k in range(c0):
            csum = (csum + int(ddelta[k])) % (1 << 32)
            psum = (psum + dplane[k]) % (1 << 64)
            colsum[n, k] = csum
            fixed[n, k] = float(psum) * 2.0 ** -20
            colplane[n, k] = np.float32(fixed[n, k])
        for k in range(c0):
            kk = int(kmin[k])
            if kk == NOKEY:
                candmin[n, k], candplane[n, k] = bsw.BIG, np.float32(bsw.BIG)
                continue
            r = kk & ((1 << ROW_BITS) - 1)
            candmin[n, k] = kk >> ROW_BITS
            dx, dy, dz = (p[r] - cc[k]).astype(np.float32)
            candplane[n, k] = _plane2(dx, dy, dz, *nrm[n, r])
    return colsum, candmin, colplane, candplane, dict(split=split,
                                                      fixed=fixed)


def _tie_batch(seed, normals, size=16, P=384, K=768):
    """Three blocks. Block 0: random points plus one point on rows 5, 40,
    130 and 300 (other warps, other CTAs) with four different normals, and
    for it candidates at d² = 1 in both candidate tiles (k = 3 and k = TK +
    3, then k = TK + 40). Block 1: every coordinate on four rows (all
    distances tied across rows, warps and CTAs), cnt0 K. Block 2: cnt0 37,
    a padding row inside the point count. ``normals``: "int" (components
    in {-2..2}, every plane² an integer) or "unit"."""
    rng = np.random.default_rng(seed)
    pts = np.full((3, P, 3), -1, np.int32)
    npts = np.array([P - 1, P, 300])
    for i, m in enumerate(npts):
        pts[i, :m] = rng.integers(0, size, (m, 3))
    base = rng.integers(0, size, (P // 4, 3))
    pts[1] = np.repeat(base, 4, axis=0)[rng.permutation(P)]
    p0 = np.array([8, 8, 8])
    near = np.abs(pts[0] - p0).max(-1) <= 1
    pts[0, near, 0] = 0
    pts[0, [5, 40, 130, 300]] = p0
    pts[2, 17] = -1
    if normals == "int":
        nrm = rng.integers(-2, 3, (3, P, 3)).astype(np.float32)
    else:
        nrm = rng.normal(size=(3, P, 3))
        nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True))
    nrm = nrm.astype(np.float32)
    nrm[0, [5, 40, 130, 300]] = ((1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0))
    pos = np.stack([rng.permutation(size ** 3)[:K] for _ in range(3)])
    flat = lambda c: (c[0] * size + c[1]) * size + c[2]
    for k, off in ((3, (1, 0, 0)), (TK + 3, (-1, 0, 0)),
                   (TK + 40, (0, 1, 0))):
        q = flat(p0 + off)
        j = np.nonzero(pos[0] == q)[0]
        if len(j):
            pos[0, j[0]] = pos[0, k]
        pos[0, k] = q
    cnt0 = np.array([K - 5, K, 37])
    return pts, nrm, pos.astype(np.int32), cnt0.astype(np.int32), \
        npts.astype(np.int32)


def _plain(pts, nrm, pos, cnt0, npts, size):
    return [a.numpy() for a in bsw.bucket_colsums_d2_plain(
        *(torch.from_numpy(a) for a in (pts, nrm, pos, cnt0, npts)), size)]


@pytest.mark.parametrize("size", [16, 64])
@pytest.mark.parametrize("normals", ["int", "unit"])
@pytest.mark.parametrize("seed", [0, 1])
def test_mirror_equals_the_plain_version(seed, normals, size):
    args = _tie_batch(seed, normals, size)
    got = mirror_k3(*args, size)
    want = _plain(*args, size)
    for i in (0, 1, 3):
        np.testing.assert_array_equal(got[i], want[i])
    npts = args[4][:, None].astype(np.float64)
    tol = npts * 2.0 ** -21 + np.spacing(np.abs(want[2]))
    err = np.abs(got[2].astype(np.float64) - want[2].astype(np.float64))
    assert (err <= tol).all(), float(err.max())
    # the tie rules: the lowest of the four tied rows (normal +x) names
    # candplane at k = 3; the candidate of tile 0 keeps row 5's prefix
    # argmin against the tied one of tile 1 (the plain version's rule)
    assert got[1][0, 3] == 1 and got[3][0, 3] == 1.0


def _exact_colplane(pts, nrm, pos, cnt0, npts, size):
    """Σ_p plane²(p, its earliest prefix-argmin candidate) of every column,
    each plane² an f32 as K3 evaluates it, summed in f64: the reference of
    the fixed-point bound."""
    out = np.zeros(pos.shape)
    for n, (c0, m) in enumerate(zip(cnt0, npts)):
        p = pts[n, :m].astype(np.int64)
        keep = p[:, 0] >= 0
        p, nr = p[keep], nrm[n, :m][keep]
        if c0 == 0 or len(p) == 0:
            continue
        q = pos[n, :c0].astype(np.int64)
        cc = np.stack([q // (size * size), q // size % size, q % size], -1)
        diff = (p[:, None] - cc[None]).astype(np.float32)
        d2 = ((p[:, None] - cc[None]) ** 2).sum(-1)
        arg = np.minimum.accumulate(d2 * c0 + np.arange(c0), axis=1) % c0
        plane = _plane2(diff[..., 0], diff[..., 1], diff[..., 2],
                        nr[:, None, 0], nr[:, None, 1], nr[:, None, 2])
        out[n, :c0] = np.take_along_axis(plane, arg, 1).astype(
            np.float64).sum(0)
    return out


@pytest.mark.parametrize("normals", ["int", "unit"])
def test_fixed_point_plane_sums_within_npts_2_21(normals):
    """Each plane² rounded once to the nearest 2^-20: the kernel's colplane
    before its rounding to f32 is within npts · 2^-21 of the f64 sum."""
    args = _tie_batch(5, normals, 64)
    args[1][0] *= np.float32(bsw.MAX_NORMAL)
    *_, extra = mirror_k3(*args, 64)
    want = _exact_colplane(*args, 64)
    err = np.abs(extra["fixed"] - want)
    assert (err <= args[4][:, None] * 2.0 ** -21).all(), float(err.max())
    if normals == "int":  # every plane² an integer: exact
        assert (err == 0).all()


def _jax(pts, nrm, pos, cnt0, size, kc=256, pc=128):
    """JAX's ``_bucket_colsums_pallas(nrm=)`` in interpret mode, on the
    same candidates (SENTINEL past cnt0)."""
    K = pos.shape[1]
    valid_k = np.arange(K)[None, :] < cnt0[:, None]
    coords = np.stack([pos // (size * size), pos // size % size,
                       pos % size], 1).astype(np.float32)
    cand = np.where(valid_k[:, None, :], coords, jbs.SENTINEL)
    n_pts = (pts[:, :, 0] >= 0).sum(-1)
    kt = np.clip(-(-cnt0 // kc), 0, K // kc).astype(np.int32)
    pt = np.clip(-(-n_pts // pc), 1, pts.shape[1] // pc).astype(np.int32)
    outs = jbs._bucket_colsums_pallas(
        jnp.asarray(pts, jnp.float32), jnp.asarray(cand), jnp.asarray(kt),
        jnp.asarray(pt), kc=kc, pc=pc, interpret=True, nrm=jnp.asarray(nrm))
    return [np.asarray(o)[:, 0] if np.asarray(o).ndim == 3 else
            np.asarray(o) for o in outs]


@pytest.mark.parametrize("seed", [0, 2])
def test_mirror_equals_the_jax_kernel(seed):
    """Integer normals: every plane² is an integer, so all four columns are
    exact on both sides. The JAX kernel takes the point rows as they are:
    the padding row inside block 2's count is the last valid row's copy
    there (the JAX kernel counts rows with x ≥ 0)."""
    pts, nrm, pos, cnt0, npts = _tie_batch(seed, "int")
    pts[2, 17] = pts[2, 16]
    got = mirror_k3(pts, nrm, pos, cnt0, npts, 16)
    want = _jax(pts, nrm, pos, cnt0, 16)
    for n, c in enumerate(cnt0):
        for i in range(4):
            np.testing.assert_array_equal(
                got[i][n, :c].astype(np.float64),
                want[i][n, :c].astype(np.float64), err_msg=f"{n} {i}")


def test_split_plane_columns_stay_exact():
    """On the tie batch at |n| components up to MAX_NORMAL: a CTA's high
    column stays inside int32 and its low column inside uint32, and the
    bounds hold in general — |plane delta| < 2^46 at B = 64, so NT · 2^22
    and NT · 2^24 fit."""
    pts, nrm, pos, cnt0, npts = _tie_batch(3, "unit")
    nrm = np.sign(nrm) * np.float32(bsw.MAX_NORMAL)
    *_, extra = mirror_k3(pts, nrm, pos, cnt0, npts, 16)
    for hi, lo in extra["split"]:
        assert np.abs(hi).max() < 1 << 31 and lo.max() < 1 << 32
    plane_max = 3 * 63 ** 2 * 3 * bsw.MAX_NORMAL ** 2 * FIX
    assert plane_max < 1 << 46
    assert NT * (1 << (46 - LO_BITS)) <= 1 << 31
    assert NT * (1 << LO_BITS) <= 1 << 31
    # the column sums of 2^18 points stay below 2^64
    assert plane_max * (1 << ROW_BITS) < 2.0 ** 64


def test_block_without_points_and_without_candidates():
    pts, nrm, pos, cnt0, npts = _tie_batch(4, "unit")
    pts[1] = -1
    npts[1] = 0
    cnt0[2] = 0
    got = mirror_k3(pts, nrm, pos, cnt0, npts, 16)
    want = _plain(pts, nrm, pos, cnt0, npts, 16)
    for i in range(4):
        np.testing.assert_array_equal(got[i][1:], want[i][1:])
    assert (got[1][1] == bsw.BIG).all()
    assert (got[3][1] == np.float32(bsw.BIG)).all()
    assert (got[0][2] == 0).all() and (got[1][2] == bsw.BIG).all()


# --- the wrapper's limits -------------------------------------------------

def test_wrapper_refuses_keys_beyond_32_bits():
    bsw.check_k3_limits(1 << ROW_BITS, 64)
    bsw.check_k3_limits(1, 74)  # 3 · 73² < 2^14
    for n_points, size in (((1 << ROW_BITS) + 1, 64), (1, 75)):
        with pytest.raises(ValueError, match="not exact"):
            bsw.check_k3_limits(n_points, size)


@pytest.mark.parametrize("n_points,size", [(1 << 17, 128), (1, 1674),
                                           (400_000, 64)])
def test_wrapper_refuses_what_k1_refuses(n_points, size):
    """K3's d² column sums are K1's 32-bit sums: every shape K1's check
    refuses K3's refuses too."""
    with pytest.raises(ValueError, match="not exact"):
        bsw.check_k1_limits(n_points, size)
    with pytest.raises(ValueError, match="not exact"):
        bsw.check_k3_limits(n_points, size)


def test_cpu_wrapper_is_exact_beyond_the_kernels_limits():
    """On the CPU the wrapper takes the plain version, exact in int64 at any
    size: at B = 128 a 2^17 point budget gives column sums above 2^32 and
    distances beyond the key's 14 bits."""
    size, n_points = 128, 1 << 17
    with pytest.raises(ValueError, match="not exact"):
        bsw.check_k3_limits(n_points, size)
    pts = torch.full((1, n_points, 3), size - 1, dtype=torch.int32)
    pts[0, -5:] = -1
    nrm = torch.zeros(1, n_points, 3)
    nrm[..., 0] = 1.0
    far, near = 3 * (size - 1) ** 2, 3 * (size - 2) ** 2
    pos = torch.tensor([[0, (size + 1) * size + 1, 5]], dtype=torch.int32)
    colsum, candmin, colplane, candplane = bsw.bucket_colsums_d2(
        pts, nrm, pos, torch.tensor([2], dtype=torch.int32),
        torch.tensor([n_points], dtype=torch.int32), size)
    valid = n_points - 5
    assert colsum.tolist() == [[valid * far, valid * near, 0]]
    assert candmin.tolist() == [[far, near, bsw.BIG]]
    assert candplane.tolist() == [[(size - 1) ** 2, (size - 2) ** 2, 0.0]]
    assert colplane[0, 1] == np.float32(valid * (size - 2) ** 2)
    assert int(colsum.max()) >= 1 << 32 and far >= 1 << 14


# --- the source -----------------------------------------------------------

def test_constants_shared_with_the_wrapper():
    assert ROW_BITS == bsw._ROW_BITS
    assert _const("BIG") == bsw.BIG
    assert _constant(r"constexpr float BIAS = (\d+)\.0f;") == 1 << 23
    assert _constant(r"constexpr float FIX = (\d+)\.0f;") == 1 << 20
    assert 32 % G == 0 and TK % 32 == 0 and TK % _const("SCAN_NT") == 0
    # the biased records stay inside [2^23, 2^24) under the key's limit
    assert 2 * 3 * 73 ** 2 < 1 << 23


def _kernel_names(source):
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                      r"(\w+)", (kernels.CSRC / source).read_text())


def test_kernel_names_form_the_profile_family():
    """``tools/torch_profile_main_path.py`` counts K3's device time by the
    substring ``bucket_d2`` and K1's by ``bucket_colsums``: K3's three
    kernels (prep, sweep, scan) hold the first and not the second, and no
    other source's kernel holds ``bucket_d2``."""
    names = _kernel_names(SOURCE)
    assert names == ["bucket_d2_prep_kernel", "bucket_d2_kernel",
                     "bucket_d2_scan_kernel"], names
    assert not any("bucket_colsums" in n for n in names)
    for name, (src, _) in kernels.KERNELS.items():
        if src != SOURCE:
            assert not any("bucket_d2" in n for n in _kernel_names(src))
    path = kernels.CSRC.parent.parent / "tools" / "torch_profile_main_path.py"
    spec = importlib.util.spec_from_file_location("profile_tool", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    fams = dict(tool.FAMILIES)
    assert fams["K3 bucket_colsums_d2"] == ("bucket_d2",)
    assert all(tool.family(n) == "K3 bucket_colsums_d2" for n in names)
