"""K2's host side and the arithmetic of its design
(``pcc_geo_cnn_v2_tpu_torch.ops.halo``, ``csrc/halo_edt.cu``).

The kernel runs only on the card (``chip_smoke.py`` holds it against its
plain version there). Checked here: a numpy mirror of the kernel's
arithmetic — the bit rows put together from packed big-endian neighbour
rows across the three z-neighbours (``__brevll`` and ``__byte_perm`` as
PTX defines them), the spiral row search with its early stop, the cap at
halo², the outlier words in the packed byte order, the partials per slab
and the numbering of a round's query voxels — against the JAX
``_halo_dir_chunk`` and ``_halo_dir_chunk_pallas``
(interpret mode); the spiral table; the slab, shared-memory budget and
CTAs an SM read from the source; the CPU wrapper against the JAX chain.
Every output is an integer: all comparisons are exact.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcc_geo_cnn_v2_tpu.ops import cloud_metrics as jcm
from pcc_geo_cnn_v2_tpu_torch.ops import cloud_metrics as tcm
from pcc_geo_cnn_v2_tpu_torch.ops import halo as hl
from pcc_geo_cnn_v2_tpu_torch.ops import kernels

SOURCE = "halo_edt.cu"
H100_SMS = 132
SM_SHARED = 233472      # shared memory of an SM, 1 KB a CTA reserved
SM_THREADS = 2048
SIZE, HALO = 16, 5


def _text():
    return (kernels.CSRC / SOURCE).read_text()


def _const(name):
    found = re.findall(rf"constexpr \w+ {name} = ([^;]+);", _text())
    assert len(found) == 1, (name, found)
    return int(eval(found[0].split("//")[0]))  # "256", "1 << 10", ...


THREADS, SLAB = _const("THREADS"), _const("SLAB")
MAX_SIZE, ROW_BITS, FAR = _const("MAX_SIZE"), _const("ROW_BITS"), _const("FAR")
M64, M128 = (1 << 64) - 1, (1 << 128) - 1


# --- a numpy mirror of the kernel -----------------------------------------

def _brev64(w):
    return int(f"{w:064b}"[::-1], 2)


def _byte_perm(x, y, s):
    """PTX ``prmt`` (default mode) with selectors below 8."""
    v = (y << 32) | x
    return sum(((v >> (8 * ((s >> (4 * k)) & 7))) & 0xFF) << (8 * k)
               for k in range(4))


def _zorder(w):
    r = _brev64(w)
    lo, hi = r & 0xFFFFFFFF, r >> 32
    return (_byte_perm(lo, 0, 0x0123) << 32) | _byte_perm(hi, 0, 0x0123)


def _load_row(buf, off, rb):
    return int.from_bytes(buf[off:off + rb].tobytes(), "little")


def _ffs(w):
    return (w & -w).bit_length()


def _clz64(w):
    return 64 - w.bit_length()


def _nearest_dz(row, pz):
    up = row >> pz
    ul, uh = up & M64, up >> 64
    du = _ffs(ul) - 1 if ul else (63 + _ffs(uh) if uh else FAR)
    dn = (row << (127 - pz)) & M128
    dl, dh = dn & M64, dn >> 64
    dd = _clz64(dh) if dh else (64 + _clz64(dl) if dl else FAR)
    return min(du, dd)


def _fns(w, n):
    """``__fns(w, 0, n)``: the position of the n-th set bit of a 32-bit
    word, counted from bit 0."""
    for z in range(32):
        if (w >> z) & 1:
            n -= 1
            if n == 0:
                return z
    return 0xFFFFFFFF


def _search(tgt, c0, H, pz, spiral, cap):
    """The spiral row search from row c0 with its early stop."""
    best = cap + 1
    for pe in spiral:
        r2, ex, ey = pe >> 14, (pe >> 7) & 127, pe & 127
        if r2 >= best:
            break
        for sx in ((ex, -ex) if ex else (0,)):
            for sy in ((ey, -ey) if ey else (0,)):
                row = tgt[c0 + sx * H + sy]
                if row:
                    dz = _nearest_dz(row, pz)
                    best = min(best, r2 + dz * dz)
    return best


def mirror(a_ext, b_ext, idx, size, halo):
    """The kernel's arithmetic, CTA by CTA and round by round (a block scan
    numbers the round's query voxels; voxel j is found by a binary search
    over the rows' first numbers and ``__fns``): (stats [2, 3, n] int64,
    unres [2, n, size³/8] uint8), as ``halo_d1_packed``."""
    rows_ext, n, rb = len(a_ext), len(idx), size // 8
    slabs, H, cap = -(-size // SLAB), size + 2 * halo, halo * halo
    spiral = hl.halo_spiral_table(halo).tolist()
    part = np.zeros((2, n, slabs, 3), np.int64)
    unres = np.zeros((2, n, size ** 3 // 8), np.uint8)
    for d in (0, 1):
        qsrc, tsrc = (a_ext, b_ext) if d == 0 else (b_ext, a_ext)
        for i in range(n):
            nb = [int(k) if 0 <= k < rows_ext else -1 for k in idx[i]]
            q = qsrc[max(nb[13], 0)]
            for s in range(slabs):
                x0 = s * SLAB
                xs = min(SLAB, size - x0)
                q0 = x0 * size * rb
                qrows = [_load_row(q, q0 + r * rb, rb) if nb[13] >= 0 else 0
                         for r in range(xs * size)]
                if not any(qrows):
                    continue  # zero mask rows and partials
                X, low = xs + 2 * halo, (1 << halo) - 1
                tgt = []
                for t in range(X * H):
                    xx, yy = divmod(t, H)
                    x, y = x0 - halo + xx, yy - halo
                    cx = 0 if x < 0 else (1 if x < size else 2)
                    cy = 0 if y < 0 else (1 if y < size else 2)
                    off = ((x - (cx - 1) * size) * size
                           + (y - (cy - 1) * size)) * rb
                    col = nb[cx * 9 + cy * 3:cx * 9 + cy * 3 + 3]
                    w = [_zorder(_load_row(tsrc[k], off, rb)) if k >= 0 else 0
                         for k in col]
                    tgt.append(((w[1] << halo) | (w[0] >> (size - halo))
                                | ((w[2] & low) << (size + halo))) & M128)
                t_live = any(tgt)
                acc = [0, 0, 0]
                for r0 in range(0, len(qrows), THREADS):  # a round
                    words = [_zorder(w) for w in qrows[r0:r0 + THREADS]]
                    words += [0] * (THREADS - len(words))
                    cnt = [bin(w).count("1") for w in words]
                    qoff = np.concatenate([[0], np.cumsum(cnt)[:-1]])
                    acc[1] += sum(cnt)
                    flags = [0] * THREADS
                    for j in range(sum(cnt)):  # thread j % THREADS
                        lo, hi = 0, THREADS - 1
                        while lo < hi:
                            mid = (lo + hi + 1) >> 1
                            lo, hi = (mid, hi) if qoff[mid] <= j else \
                                (lo, mid - 1)
                        w, m = words[lo], j - int(qoff[lo])
                        pl = bin(w & 0xFFFFFFFF).count("1")
                        z = _fns(w & 0xFFFFFFFF, m + 1) if m < pl else \
                            32 + _fns(w >> 32, m - pl + 1)
                        xr, y = divmod(r0 + lo, size)
                        best = _search(tgt, (xr + halo) * H + (y + halo), H,
                                       z + halo, spiral, cap) \
                            if t_live else cap + 1
                        if best <= cap:
                            acc[0] += best
                        else:
                            acc[2] += 1
                            flags[lo] |= 1 << z
                    for k, f in enumerate(flags[:len(qrows) - r0]):
                        at = q0 + (r0 + k) * rb
                        unres[d, i, at:at + rb] = list(
                            _zorder(f).to_bytes(8, "little")[:rb])
                part[d, i, s] = acc
    return part.sum(axis=2).transpose(0, 2, 1), unres


# --- inputs ---------------------------------------------------------------

def _nb_batch(rng, bs, p_occ, size=SIZE):
    """[bs, 27, size³/8] packed neighbourhoods, the JAX functions' input."""
    g = rng.random((bs, 27, size ** 3)) < p_occ
    return np.packbits(g, axis=-1, bitorder="big")


def _as_ext(q_nb, t_nb, absent=()):
    """The kernel's inputs for neighbourhood batches: every slot a row of
    its own, a zero row last; slots in ``absent`` (block, j) point at it
    (and are zeroed in the batches)."""
    bs = len(q_nb)
    q_nb, t_nb = q_nb.copy(), t_nb.copy()
    idx = np.arange(bs * 27, dtype=np.int32).reshape(bs, 27)
    for i, j in absent:
        q_nb[i, j] = t_nb[i, j] = 0
        idx[i, j] = bs * 27
    zero = np.zeros((1, q_nb.shape[-1]), np.uint8)
    return (np.concatenate([q_nb.reshape(bs * 27, -1), zero]),
            np.concatenate([t_nb.reshape(bs * 27, -1), zero]), idx,
            q_nb, t_nb)


def _jax_dir(q_nb, t_nb, size, halo, pallas):
    if pallas:
        r = jcm._halo_dir_chunk_pallas(jnp.asarray(q_nb), jnp.asarray(t_nb),
                                       size=size, halo=halo, interpret=True)
    else:
        r = jcm._halo_dir_chunk(jnp.asarray(q_nb), jnp.asarray(t_nb),
                                size=size, halo=halo)
    r = jax.device_get(r)
    return np.stack([r["sum"].astype(np.int64), r["n"], r["unres_cnt"]]), \
        r["unres"]


def _assert_matches_jax(q_nb, t_nb, size, halo, absent=(), pallas=(0, 1)):
    a_ext, b_ext, idx, q_nb, t_nb = _as_ext(q_nb, t_nb, absent)
    stats, unres = mirror(a_ext, b_ext, idx, size, halo)
    for d, (q, t) in enumerate(((q_nb, t_nb), (t_nb, q_nb))):
        for p in pallas:
            s, u = _jax_dir(q, t, size, halo, p)
            np.testing.assert_array_equal(stats[d], s, err_msg=f"dir {d}")
            np.testing.assert_array_equal(unres[d], u, err_msg=f"dir {d}")
    return stats, unres


CASES = {  # (query density, target density, absent (block, slot))
    "dense": (0.03, 0.05, ()),
    "sparse": (0.01, 0.0008, ()),
    "empty_target": (0.02, 0.0, ()),
    "empty_query": (0.0, 0.02, ()),
    "absent_neighbours": (0.02, 0.004,
                          tuple((i, j) for i in range(4) for j in range(27)
                                if j != 13 and (i + j) % 3)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mirror_matches_jax(case):
    p_q, p_t, absent = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    q_nb, t_nb = _nb_batch(rng, 4, p_q), _nb_batch(rng, 4, p_t)
    stats, _ = _assert_matches_jax(q_nb, t_nb, SIZE, HALO, absent)
    if case == "empty_target":  # every query flagged, nothing summed
        assert (stats[0, 0] == 0).all() and (stats[0, 2] == stats[0, 1]).all()
        assert stats[0, 1].sum() > 0
    if case == "empty_query":
        assert (stats[0] == 0).all()


@pytest.mark.parametrize("bs, p_q, p_t", [(3, 0.002, 0.0003),
                                          (1, 0.02, 0.02)])
def test_mirror_matches_jax_at_b64_halo12(bs, p_q, p_t):
    """Blocks at the flagship's size: a row a 64-bit word (voxels in both
    32-bit halves, several a row in the denser case), 88-bit halo rows
    across both 64-bit halves, two query rounds a slab."""
    rng = np.random.default_rng(11)
    q_nb, t_nb = _nb_batch(rng, bs, p_q, 64), _nb_batch(rng, bs, p_t, 64)
    stats, _ = _assert_matches_jax(q_nb, t_nb, 64, 12)
    assert stats[:, 0].sum() > 0
    assert stats[:, 2].sum() > 0 or p_t > 0.01


def _cloud(origins, a_pts, b_pts, size):
    """Packed grids of two clouds given as global voxel lists."""
    origins = np.asarray(origins)
    grids = []
    for pts in (a_pts, b_pts):
        g = np.zeros((len(origins), size, size, size), bool)
        for p in pts:
            i = int(np.nonzero((origins == np.asarray(p) // size * size)
                               .all(1))[0][0])
            g[(i, *(np.asarray(p) % size))] = True
        grids.append(np.packbits(g.reshape(len(origins), -1), axis=-1,
                                 bitorder="big"))
    return grids


def _ext_idx(origins, a, b, size):
    n = len(origins)
    nb = tcm.neighbor_table(origins, size)
    zero = np.zeros((1, a.shape[1]), np.uint8)
    return (np.concatenate([a, zero]), np.concatenate([b, zero]),
            np.where(nb < 0, n, nb).astype(np.int32))


@pytest.mark.parametrize("offset, counted", [((12, 0, 0), True),
                                             ((12, 1, 0), False),
                                             ((0, 0, -12), True),
                                             ((-8, 8, 5), False)])
def test_the_halo_squared_boundary(offset, counted):
    """A target at d² = halo² is counted (144 at halo 12), one just beyond
    it (145, 153) flagged — across the block edge along x, and along the
    packed z axis."""
    size, halo = 64, 12
    origins = [(0, 0, 0), (64, 0, 64), (0, 0, 64)]
    q = (60, 30, 70)
    t = tuple(np.add(q, offset))
    a, b = _cloud(origins, [q], [t], size)
    a_ext, b_ext, idx = _ext_idx(origins, a, b, size)
    stats, unres = mirror(a_ext, b_ext, idx, size, halo)
    want = (sum(np.square(offset)), 1, 0) if counted else (0, 1, 1)
    assert tuple(stats[0, :, 2]) == want  # the query's block is (0, 0, 64)
    assert unres[0, 2].any() == (not counted)
    got = hl.halo_d1_packed(*(torch.from_numpy(x) for x in (a_ext, b_ext,
                                                            idx)),
                            size=size, halo=halo)
    np.testing.assert_array_equal(got[0].numpy(), stats)
    np.testing.assert_array_equal(got[1].numpy(), unres)


def test_nearest_target_in_a_corner_neighbour():
    """The nearest target of (63, 63, 63) lies in the (+1, +1, +1) corner
    block at d² 27, nearer ones elsewhere are absent; both directions."""
    size, halo = 64, 12
    origins = [(0, 0, 0), (64, 64, 64), (64, 0, 0)]
    a, b = _cloud(origins, [(63, 63, 63), (70, 20, 20)],
                  [(66, 66, 66), (64 + 20, 20, 20)], size)
    a_ext, b_ext, idx = _ext_idx(origins, a, b, size)
    stats, _ = mirror(a_ext, b_ext, idx, size, halo)
    assert tuple(stats[0, :, 0]) == (27, 1, 0)
    assert tuple(stats[1, :, 1]) == (27, 1, 0)
    nb = jnp.asarray(a_ext[idx]), jnp.asarray(b_ext[idx])
    for d, (qn, tn) in enumerate((nb, nb[::-1])):
        s, _ = _jax_dir(np.asarray(qn), np.asarray(tn), size, halo, False)
        np.testing.assert_array_equal(stats[d], s)


# --- the kernel's tricks and tables ---------------------------------------

def test_zorder_reverses_the_bits_of_each_byte():
    """``__brevll`` then a byte swap by ``__byte_perm(·, 0, 0x0123)`` puts
    voxel z (bit 7 - z % 8 of byte z / 8) at bit z of a little-endian
    word, and is its own inverse (the mask rows are written with it)."""
    rng = np.random.default_rng(3)
    for w in [0, M64, 1, 1 << 63] + [int(v) for v in
                                     rng.integers(0, 1 << 63, 200)]:
        raw = w.to_bytes(8, "little")
        bits = np.unpackbits(np.frombuffer(raw, np.uint8), bitorder="big")
        want = sum(1 << int(z) for z in np.flatnonzero(bits))
        assert _zorder(w) == want and _zorder(_zorder(w)) == w


@pytest.mark.parametrize("halo", [1, 5, 12, 32])
def test_spiral_table_is_sorted_and_covers_the_disc(halo):
    t = hl.halo_spiral_table(halo).astype(np.int64)
    r2, ex, ey = t >> 14, (t >> 7) & 127, t & 127
    assert (np.diff(r2) >= 0).all()
    np.testing.assert_array_equal(r2, ex * ex + ey * ey)
    want = {(x, y) for x in range(halo + 1) for y in range(halo + 1)
            if x * x + y * y <= halo * halo}
    assert set(zip(ex.tolist(), ey.tolist())) == want and len(t) == len(want)


def test_slab_budget_and_occupancy_from_the_source():
    """The constants the wrapper shares with the source; at size 64, halo
    12 a CTA's rows take 40 × 88 × 16 B = 55 KB of shared memory and its
    query rounds 20 B a thread: 2 CTAs of 512 threads an SM (shared memory
    would take 3; 64 registers a thread, as ptxas reports, allow 2), and
    the flagship's 205 blocks give 1,640 CTAs (more than six waves of
    264)."""
    src = _text()
    assert (SLAB, MAX_SIZE, ROW_BITS, THREADS) == (
        hl.K2_SLAB, hl.K2_SIZE_MAX, hl.K2_ROW_BITS, hl.K2_THREADS)
    assert FAR * FAR > 3 * 64 ** 2 and FAR > ROW_BITS
    slabs, smem = hl.check_k2_limits(64, 12)
    assert (slabs, smem) == (4, 56320 + 512 * 20)
    assert re.search(r"\(min\(SLAB, size\) \+ 2 \* halo\) \*\s+"
                     r"\(size \+ 2 \* halo\) \* sizeof\(u128\)", src)
    for decl in (r"u64 qbits\[THREADS\]", r"int qoff\[THREADS\]",
                 r"unsigned qflag\[THREADS\]\[2\]"):
        assert re.search(rf"__shared__ {decl};", src)
    by_smem = SM_SHARED // (smem + 1024)
    by_regs = 65536 // (THREADS * 64)
    ctas = min(by_smem, by_regs, SM_THREADS // THREADS)
    assert (by_smem, ctas) == (3, 2)
    assert re.search(r"halo_edt_kernel<<<dim3\(n \* slabs, 2\), THREADS, "
                     r"smem, st>>>", src)
    assert "s = blockIdx.x % slabs, i = blockIdx.x / slabs, d = blockIdx.y" \
        in src
    grid = 205 * slabs * 2
    assert grid == 1640 and grid > 6 * ctas * H100_SMS
    # the widest halo the rows take still fits a CTA
    assert hl.check_k2_limits(64, 32)[1] <= hl.SMEM_MAX


@pytest.mark.parametrize("size, halo", [(72, 4), (60, 4), (64, 0), (16, 17),
                                        (64, 33)])
def test_limits_raise(size, halo):
    with pytest.raises(ValueError):
        hl.check_k2_limits(size, halo)


def test_kernel_names_and_profile_family():
    """Both kernels of the C entry hold ``halo_edt`` — the launch counter's
    key and the profile tool's K2 family, which no other kernel matches."""
    import importlib.util

    src = _text()
    assert re.search(r"__global__ void __launch_bounds__\(THREADS\)\s+"
                     r"halo_edt_kernel\(", src)
    assert re.search(r"__global__ void __launch_bounds__\(FINISH_THREADS\)"
                     r"\s+halo_edt_finish_kernel\(", src)
    assert "halo_edt" in kernels.launches
    spec = importlib.util.spec_from_file_location(
        "prof", kernels.CSRC.parent.parent / "tools/torch_profile_main_path.py")
    prof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof)
    for name in ("halo_edt_kernel", "halo_edt_finish_kernel"):
        assert prof.family(f"(anonymous namespace)::{name}(...)") == \
            "K2 halo_edt"
    for other in ("bucket_colsums_kernel", "bucket_d2_kernel",
                  "edt_sweep_ab_kernel", "tail_kernel"):
        assert prof.family(other) != "K2 halo_edt"


# --- the wrapper on the CPU -----------------------------------------------

def _random_cloud(seed, size=SIZE):
    rng = np.random.default_rng(seed)
    origins = np.unique(rng.integers(0, 4, (10, 3)), axis=0) * size
    # sparse enough that some nearest neighbours lie beyond the halo
    a = rng.random((len(origins), size ** 3)) < 0.004
    b = rng.random(a.shape) < 0.004
    pack = lambda g: np.packbits(g, axis=-1, bitorder="big")  # noqa: E731
    return origins, pack(a), pack(b)


@pytest.mark.parametrize("batch", [1, 4, 100])
def test_wrapper_on_cpu_equals_the_jax_chain_and_the_mirror(batch):
    """``halo_d1_packed`` on CPU tensors (the plain chain, ``batch`` blocks
    a step; 100 > n) equals the mirror, and ``blockwise_d1_sums`` on it
    equals the JAX package's."""
    origins, a, b = _random_cloud(5)
    a_ext, b_ext, idx = _ext_idx(origins, a, b, SIZE)
    stats, unres = hl.halo_d1_packed(
        torch.from_numpy(a_ext), torch.from_numpy(b_ext),
        torch.from_numpy(idx), size=SIZE, halo=HALO, batch=batch)
    want = mirror(a_ext, b_ext, idx, SIZE, HALO)
    np.testing.assert_array_equal(stats.numpy(), want[0])
    np.testing.assert_array_equal(unres.numpy(), want[1])
    got = tcm.blockwise_d1_sums(torch.from_numpy(a), torch.from_numpy(b),
                                origins, SIZE, halo=HALO, batch=batch)
    ref = jcm.blockwise_d1_sums(a, b, origins, SIZE, halo=HALO, batch=4,
                                backend="xla", aot=False)
    for k in ("ab_sum", "ba_sum", "n_a", "n_b"):
        assert got[k] == ref[k], k
    for k in ("outliers_a", "outliers_b"):
        np.testing.assert_array_equal(got[k], ref[k])
    assert len(got["outliers_a"]) and len(got["outliers_b"])


def test_wrapper_raises_off_cpu_without_launching():
    """A non-CPU tensor goes to the kernel or raises — never the plain
    chain; the assembled-volume entry has no kernel and raises."""
    before = dict(kernels.launches)
    ext = torch.zeros(3, SIZE ** 3 // 8, dtype=torch.uint8, device="meta")
    idx = torch.zeros(2, 27, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        hl.halo_d1_packed(ext, ext, idx, size=SIZE, halo=HALO)
    vol = torch.zeros(2, 26, 26, 26, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        hl.halo_d1_dir(vol[:, :16, :16, :16], vol, size=SIZE, halo=HALO)
    assert kernels.launches == before
