"""K5's host side and the arithmetic of its design
(``pcc_geo_cnn_v2_tpu_torch.ops.edt_sweep``, ``csrc/edt_sweep.cu``).

The kernel runs only on the card (``chip_smoke.py`` holds it against its
plain version there). Checked here on seeded inputs, in Python mirrors of
the kernel's steps: the threshold bins and the cnt / BA that their suffix
sums give, against the plain version and the JAX kernel in interpret
mode, and the first-empty rule of the bins; the work list pass 2 writes
for pass 3; the row search of the bit rows (one and two 64-bit words),
the spiral table and the projection-bounded search, against brute force
and the plain EDT. And the wrapper's limit checks, the constants it
shares with the source, the kernel names the profile tool counts.
"""

import importlib.util
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcc_geo_cnn_v2_tpu.ops.pallas_sweep import d1_sweep_sums_pallas
from pcc_geo_cnn_v2_tpu_torch.ops import edt_sweep as es
from pcc_geo_cnn_v2_tpu_torch.ops import kernels
from pcc_geo_cnn_v2_tpu_torch.ops.edt import INF, squared_edt

T = 32  # a multiple of the JAX kernel's threshold chunk (8)
THR = np.linspace(0, 1.0, T).astype(np.float32)


def _inputs(size, n, seed):
    """Seeded blocks: a sparse occupancy, x_hat high near it, and the
    edges — a threshold value in x_hat, a NaN block, a block without
    candidates (x_hat 0: first_empty 0), a block without points."""
    rng = np.random.default_rng(seed)
    occ = (rng.random((n, size, size, size)) < 0.03).astype(np.float32)
    x_hat = np.where(rng.random(occ.shape) < 0.2,
                     0.6 * occ + 0.4 * rng.random(occ.shape), 0.0)
    x_hat = x_hat.astype(np.float32)
    x_hat[0, 0, 0, :4] = THR[[0, 5, 17, T - 1]]  # equal to a threshold
    if n > 1:
        x_hat[1] = 0.0
    if n > 2:
        x_hat[2, 1, 2, 3] = np.nan
    if n > 3:
        occ[3] = 0.0
    return occ, x_hat


def _bins(x_hat, thresholds):
    """Mirror of pass 1's bins: ``#{t : x_hat > thresholds[t]}`` with the
    f32 ``>`` (a NaN gets 0), so that S_t = {bin > t}."""
    x = x_hat.to(torch.float32)
    b = torch.searchsorted(thresholds.to(torch.float32).contiguous(),
                           x.reshape(-1).contiguous(), right=False)
    return torch.where(torch.isnan(x.reshape(-1)), 0, b).reshape(x.shape)


def _suffix_sums(bins, dt_orig):
    """Mirror of passes 1 and 2: per-block histograms of 1 and of dt_orig
    (capped at 2^24) over the bins, and their suffix sums, cnt[t] =
    #{bin > t}; before the first-empty rule."""
    n = bins.shape[0]
    b = bins.reshape(n, -1).to(torch.int64)
    dt = torch.clamp_max(dt_orig, float(es.DT_CAP)).to(torch.int64) \
        .reshape(n, -1)
    hist_c = torch.zeros(n, T + 1, dtype=torch.int64)
    hist_b = torch.zeros_like(hist_c)
    hist_c.scatter_add_(1, b, torch.ones_like(b))
    hist_b.scatter_add_(1, b, dt)
    suffix = lambda h: torch.flip(torch.cumsum(torch.flip(h, [1]), 1), [1])
    return suffix(hist_c)[:, 1:], suffix(hist_b)[:, 1:]


def _plain(occ, x_hat, t_end=None):
    return [a.numpy() for a in es.d1_sweep_sums_plain(
        torch.from_numpy(x_hat), torch.from_numpy(occ),
        squared_edt(torch.from_numpy(occ) > 0), torch.from_numpy(THR),
        t_end)]


def _from_bins(occ, x_hat):
    """cnt and BA as passes 1 and 2 form them: bins, histograms, suffix
    sums, zero from the block's first empty set on (max bin; 0 with a
    NaN)."""
    xh = torch.from_numpy(x_hat)
    bins = _bins(xh, torch.from_numpy(THR))
    cnt, ba = _suffix_sums(bins, squared_edt(torch.from_numpy(occ) > 0))
    fe = torch.where(torch.isnan(xh).flatten(1).any(1), 0,
                     bins.flatten(1).max(1).values)
    live = torch.arange(T)[None, :] < fe[:, None]
    return (torch.where(live, cnt, 0).numpy(), torch.where(live, ba, 0)
            .numpy(), fe)


def test_bins_count_thresholds_below_with_f32_greater():
    x = torch.tensor([THR[0], THR[0] + 1e-7, THR[7], THR[7] + 1e-6,
                      THR[-1], 2.0, -1.0, float("nan"), float("inf")])
    want = [int((v > THR).sum()) for v in x.numpy()]
    assert _bins(x, torch.from_numpy(THR)).tolist() == want
    assert want[0] == 0 and want[2] == 7 and want[5] == T and want[7] == 0


def test_suffix_sums_match_plain_and_jax():
    occ, x_hat = _inputs(16, 5, 0)
    cnt, ba, fe = _from_bins(occ, x_hat)
    _, p_ba, p_cnt = _plain(occ, x_hat, t_end=torch.zeros(5, dtype=torch.int32))
    np.testing.assert_array_equal(cnt, p_cnt)
    np.testing.assert_array_equal(ba, p_ba)
    np.testing.assert_array_equal(fe.numpy(), es.sweep_bounds(
        torch.from_numpy(x_hat), torch.from_numpy(THR), 0)[0].numpy())
    _, j_ba, j_cnt, _ = d1_sweep_sums_pallas(
        jnp.asarray(x_hat), jnp.asarray(occ), jnp.asarray(THR),
        interpret=True)
    np.testing.assert_array_equal(cnt, np.asarray(j_cnt))
    # the port caps dt_orig of a block without points at 2^24, the JAX
    # package sums its EDT's 1e12 (module docstring of edt_sweep)
    pts = occ.reshape(5, -1).any(1)
    np.testing.assert_array_equal(ba[pts], np.asarray(j_ba)[pts])
    assert not pts[3] and (ba[3] > 0).any()
    # the edges are present: NaN and no candidates give first_empty 0,
    # a threshold value in x_hat is not above that threshold
    assert fe[1] == 0 and fe[2] == 0 and (cnt[1:3] == 0).all()
    assert fe[0] > 17 and fe[3] > 0 and (cnt[0] > 0).any()


def test_suffix_sums_above_64():
    """One block size past a single 64-bit word (the plain version on
    cnt / BA only: t_end = 0 skips its EDTs)."""
    occ, x_hat = _inputs(72, 2, 1)
    cnt, ba, _ = _from_bins(occ, x_hat)
    _, p_ba, p_cnt = _plain(occ, x_hat, t_end=torch.zeros(2, dtype=torch.int32))
    np.testing.assert_array_equal(cnt, p_cnt)
    np.testing.assert_array_equal(ba, p_ba)
    assert cnt.max() > 0


def _kernel_items(te, T):
    """Mirror of pass 2's CTA 0, the work list of pass 3 (CTA i takes item
    i): a histogram of te, #blocks with te > k as its suffix sums, their
    exclusive prefix over k, and for each k the blocks with te > k in block
    order, packed n | t << 16 with t = te - 1 - k (k-major, so that every
    block's sparsest sets, the longest searches, start first)."""
    hist = np.bincount(te, minlength=T + 1)
    above = hist[::-1].cumsum()[::-1] - hist  # #blocks with te > k
    start = np.concatenate([[0], np.cumsum(above)])
    items = [None] * int(start[-1])
    for k in range(T):
        at = int(start[k])
        for b, tb in enumerate(te):
            if tb > k:
                items[at] = b | ((int(tb) - 1 - k) << 16)
                at += 1
    return [(it & 0xffff, it >> 16) for it in items]


@pytest.mark.parametrize("seed", range(3))
def test_work_items_cover_every_edt_pair_once(seed):
    rng = np.random.default_rng(seed)
    n = 32
    te = rng.integers(0, 256, n)
    te[:3] = (0, 1, 256)  # none, one, all
    items = _kernel_items(te, 256)
    assert len(items) == len(set(items))
    assert set(items) == {(b, t) for b in range(n) for t in range(te[b])}
    assert len(items) <= n * 256  # pass 3's grid of N·T CTAs
    # every block's sparsest set comes in the first wave of items
    assert {b for b, t in items[:n]} == {b for b in range(n) if te[b]}
    assert all(t == te[b] - 1 for b, t in items[:int((te > 0).sum())])
    # then k-major: a block's thresholds descend
    for b in range(n):
        ts = [t for bb, t in items if bb == b]
        assert ts == list(range(te[b] - 1, -1, -1))


def _constant(pattern):
    """An integer constant of the kernel source."""
    found = re.findall(pattern, (kernels.CSRC / "edt_sweep.cu").read_text())
    assert len(found) == 1, (pattern, found)
    return int(found[0])


def test_kernel_source_follows_the_plan():
    """The wrapper's limits and the mirrors' constants are the source's."""
    const = lambda name: _constant(rf"constexpr \w+ {name} = (\d+)")
    assert const("T_MAX") == es.K5_T_MAX
    assert const("AB_THREADS") == es.K5_AB_THREADS
    assert const("BRUTE_MAX") == es.K5_BRUTE_MAX
    assert const("DT_CAP") == es.DT_CAP
    assert const("LANE_ENTRIES") == LANE_ENTRIES
    assert _constant(r"size > (\d+) \|\| seg <= 0") == es.K5_SIZE_MAX
    # INF_I = 1 << 24 stands above every squared distance
    assert _constant(r"constexpr int INF_I = 1 << (\d+);") == 24
    assert 3 * (es.K5_SIZE_MAX - 1) ** 2 < 1 << 24


def _ffs(v):
    return (v & -v).bit_length()


def _clz(v):
    return 64 - v.bit_length()


def _nearest_x(row, x, words):
    """Mirror of the kernel's ``nearest_x<W>``: the set bit nearest to x
    in a row of ``words`` 64-bit words (ties take x + d), or -1."""
    wi, xb = x >> 6, x & 63
    cur = row[wi]
    best, cx = 1 << 24, -1
    r = cur >> xb
    if r:
        best = _ffs(r) - 1
        cx = x + best
    elif words > 1 and wi == 0 and row[1]:
        best = 64 - xb + _ffs(row[1]) - 1
        cx = x + best
    left = (cur << (63 - xb)) & (2 ** 64 - 1)
    if left:
        d = _clz(left)
        if d < best:
            cx = x - d
    elif words > 1 and wi == 1 and row[0]:
        d = xb + 1 + _clz(row[0])
        if d < best:
            cx = x - d
    return cx


def _pack(bits, words):
    """A row of booleans as the kernel's 64-bit words."""
    out = [0] * words
    for x in (int(v) for v in np.flatnonzero(bits)):
        out[x >> 6] |= 1 << (x & 63)
    return out


@pytest.mark.parametrize("size", [16, 64, 65, 90, 120, 128])
def test_row_search_is_the_nearest_set_bit(size):
    words = 1 if size <= 64 else 2
    rng = np.random.default_rng(size)
    for density in (0.0, 0.01, 0.05, 0.5):
        for _ in range(20):
            bits = rng.random(size) < density
            if density == 0.01:
                bits[:] = False
                bits[rng.integers(0, size)] = True  # one far candidate
            row = _pack(bits, words)
            for x in range(size):
                cx = _nearest_x(row, x, words)
                if not bits.any():
                    assert cx == -1
                    continue
                assert bits[cx]
                assert abs(cx - x) == np.abs(np.flatnonzero(bits) - x).min()


def _entry(rows, size, z, y, x, p):
    """Mirror of ``entry_best``: the rows (z ± dz, y ± dy) of entry p."""
    r2, dz, dy = p >> 14, (p >> 7) & 127, p & 127
    best, pos = 1 << 24, None
    for zz in sorted({z + dz, z - dz}):
        for yy in sorted({y + dy, y - dy}):
            if 0 <= zz < size and 0 <= yy < size:
                c = _nearest_x(rows[zz][yy], x, len(rows[zz][yy]))
                if c >= 0 and r2 + (c - x) ** 2 < best:
                    best, pos = r2 + (c - x) ** 2, (zz, yy, c)
    return best, pos


def _proj_bounds(mask, z, y, x):
    """The kernel's three lower bounds: squared 2-D distances from the
    voxel to the set's projections along x (rows), y and z."""
    def dist(proj, a, b):
        pa, pb = np.nonzero(proj)
        return int(((pa - a) ** 2 + (pb - b) ** 2).min())
    return (dist(mask.any(2), z, y), dist(mask.any(1), z, x),
            dist(mask.any(0), y, x))


LANE_ENTRIES = 8  # the kernel's (test_kernel_source_follows_the_plan)


def _kernel_search(rows, mask, size, z, y, x, lower, table):
    """Mirror of pass 3's search of one voxel: a lane's LANE_ENTRIES
    entries of the spiral; then the projection bounds (done if the best
    value meets them) and the rest of the spiral from the first entry the
    row projection allows (the warp's part), stopping at the first entry
    with dz² + dy² ≥ best or when best meets the lower bound."""
    n_entries = size * size
    spiral, start = table[:n_entries], table[n_entries:]
    best, pos, e = 1 << 24, None, 0
    while e < min(LANE_ENTRIES, n_entries):
        if int(spiral[e]) >> 14 >= best:
            return best, pos
        b, ps = _entry(rows, size, z, y, x, int(spiral[e]))
        if b < best:
            best, pos = b, ps
            if best <= lower:
                return best, pos
        e += 1
    if e >= n_entries:
        return best, pos
    ex, ey, ez = _proj_bounds(mask, z, y, x)
    lower = max(lower, ex, ey, ez)
    if best <= lower:
        return best, pos
    e = max(e, int(start[ex]))
    while e < n_entries and int(spiral[e]) >> 14 < best:
        b, ps = _entry(rows, size, z, y, x, int(spiral[e]))
        if b < best:
            best, pos = b, ps
            if best <= lower:
                break
        e += 1
    return best, pos


def test_spiral_table_orders_rows_by_distance():
    for size in (1, 12, 64, 90):
        table = es.spiral_table(size)
        spiral, start = table[:size * size], table[size * size:]
        r2, dz, dy = spiral >> 14, (spiral >> 7) & 127, spiral & 127
        assert (np.diff(r2) >= 0).all()
        assert set(zip(dz.tolist(), dy.tolist())) == {
            (a, b) for a in range(size) for b in range(size)}
        np.testing.assert_array_equal(r2, dz * dz + dy * dy)
        # start[r]: the first entry at r² ≥ r, for every r a bound can take
        assert len(start) == 2 * (size - 1) ** 2 + 2
        for r in range(len(start)):
            assert (r2[:start[r]] < r).all() and (r2[start[r]:] >= r).all()


@pytest.mark.parametrize("size", [12, 66])
def test_bounded_spiral_search_gives_the_plain_ab(size):
    """Pass 3's search of every occupied voxel at every threshold — a
    lane's spiral entries, then the projection bounds and the rest of the
    spiral from the entry they allow — gives each voxel's squared EDT, and
    the bounds never exceed it; the sum is the plain AB."""
    rng = np.random.default_rng(size)
    occ = np.zeros((1, size, size, size), np.float32)
    pts = rng.integers(0, size, (40, 3))
    occ[0, pts[:, 0], pts[:, 1], pts[:, 2]] = 1
    x_hat = np.where(rng.random(occ.shape) < 0.02, rng.random(occ.shape),
                     0.0).astype(np.float32)
    x_hat[0, 0, 0, 0] = 1.0  # every set below 1 non-empty
    ab, _, _ = _plain(occ, x_hat)
    bins = _bins(torch.from_numpy(x_hat), torch.from_numpy(THR)).numpy()[0]
    te = int(bins.max())
    words = 1 if size <= 64 else 2
    table = es.spiral_table(size)
    occupied = [tuple(int(c) for c in v) for v in np.argwhere(occ[0] > 0)]
    for t in range(0, te, 3):
        mask = bins > t
        dt = squared_edt(torch.from_numpy(mask)).numpy()
        rows = [[_pack(mask[z, y], words) for y in range(size)]
                for z in range(size)]
        total = 0
        for z, y, x in occupied:
            best, _ = _kernel_search(rows, mask, size, z, y, x, 0, table)
            assert best == int(dt[z, y, x])
            assert max(_proj_bounds(mask, z, y, x)) <= best
            total += best
        assert total == ab[0, t]
    assert (ab[0, te:] == INF).all()


def test_plan_limits():
    es.edt_sweep_plan(1, 114, es.K5_T_MAX)
    with pytest.raises(ValueError, match="shared memory"):
        es.edt_sweep_plan(1, 115, 256)
    with pytest.raises(ValueError, match="two 64-bit words"):
        es.edt_sweep_plan(1, es.K5_SIZE_MAX + 1, 256)
    with pytest.raises(ValueError, match="T ≤ 2048"):
        es.edt_sweep_plan(1, 64, es.K5_T_MAX + 1)
    with pytest.raises(ValueError, match="blocks"):
        es.edt_sweep_plan(0, 64, 256)
    assert es.edt_sweep_plan(32, 64, 256) == (es.K5_SEG, 16)
    assert es.edt_sweep_plan(2, 16, 256) == (16 ** 3, 1)
    assert es.edt_sweep_plan(2, 90, 256) == (es.K5_SEG, 45)
    # the 64-bit sums: AB and BA of the largest block stay far below 2^63
    vol = es.K5_SIZE_MAX ** 3
    assert vol * 3 * (es.K5_SIZE_MAX - 1) ** 2 < 1 << 40
    assert vol * es.DT_CAP < 1 << 46


def _kernel_names(source):
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                      r"(\w+)", (kernels.CSRC / source).read_text())


def test_kernel_names_form_the_profile_family():
    """``tools/torch_profile_main_path.py`` counts K5's device time by the
    substring ``edt_sweep``: each of its three kernels holds it, no other
    kernel source's does."""
    names = _kernel_names("edt_sweep.cu")
    assert len(names) == 3 and all("edt_sweep" in n for n in names), names
    for name, (src, _) in kernels.KERNELS.items():
        if name != "edt_sweep":
            assert not any("edt_sweep" in n for n in _kernel_names(src))
    path = kernels.CSRC.parent.parent / "tools" / "torch_profile_main_path.py"
    spec = importlib.util.spec_from_file_location("profile_tool", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert dict(tool.FAMILIES)["K5 edt_sweep"] == ("edt_sweep",)
