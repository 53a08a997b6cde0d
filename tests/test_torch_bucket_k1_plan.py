"""K1's host side: the launch plan, the candidate records and the wrapper's
limits (``pcc_geo_cnn_v2_tpu_torch.ops.bucket_sweep``).

The kernel itself runs only on the card (``chip_smoke.py`` holds it against
its plain version there); what it takes from Python is checked here: the
plan covers every (block, point) exactly once and matches the kernel's
indexing; the candidate records give exact integer distances in f32; the
limits refuse shapes whose 32-bit column sums or f32 distances would not be
exact, while the plain version stays exact past them; every kernel of K1's
source carries the name the profile tool counts it by.
"""

import re

import numpy as np
import pytest
import torch

from pcc_geo_cnn_v2_tpu_torch.ops import bucket_sweep as bsw

SHAPES = [(n, p) for n in (1, 7, 32) for p in (1, 127, 4096, 1 << 18)]
H100_SMS = 132


def _rows(plan):
    """Every point row the plan's grid touches in one block, by (CTA,
    thread): thread t of CTA i takes row i · threads + t."""
    cta, thread = np.meshgrid(np.arange(plan["grid"][0]),
                              np.arange(plan["threads"]), indexing="ij")
    return (cta * plan["threads"] + thread).ravel()


@pytest.mark.parametrize("n_blocks,n_points", SHAPES)
def test_plan_covers_each_point_once(n_blocks, n_points):
    plan = bsw.bucket_plan(n_blocks, n_points)
    assert plan["threads"] == bsw.K1_THREADS
    assert plan["grid"][1] == n_blocks
    rows = _rows(plan)
    np.testing.assert_array_equal(np.sort(rows[rows < n_points]),
                                  np.arange(n_points))
    # no CTA is left without a point of the block's budget
    assert (plan["grid"][0] - 1) * plan["threads"] < n_points


def test_plan_at_the_main_path_shapes():
    """The flagship's 32-block chunks and its rerun of all 7 overflowing
    blocks (2^15 point rows) give at least two waves of CTAs: five an SM,
    the sweep kernel's launch bound."""
    assert "__launch_bounds__(NT, 5)\nbucket_colsums_kernel(" in _k1_source()
    for n_blocks in (32, 7):
        grid = bsw.bucket_plan(n_blocks, 1 << 15)["grid"]
        assert grid[0] * grid[1] >= 2 * 5 * H100_SMS


def _k1_source():
    from pcc_geo_cnn_v2_tpu_torch.ops import kernels

    return (kernels.CSRC / "bucket_colsums.cu").read_text()


def test_plan_matches_the_kernel():
    """The plan's threads are the kernel's CTA size, its grid the one the C
    entry launches, and the kernel takes point row blockIdx.x · NT +
    threadIdx.x (:func:`_rows`)."""
    src = _k1_source()
    assert f"constexpr int NT = {bsw.K1_THREADS};" in src
    assert "bucket_colsums_kernel<<<dim3(tiles, N), NT, 0, st>>>" in src
    assert "const int p = blockIdx.x * NT + threadIdx.x;" in src


@pytest.mark.parametrize("size", [8, 64, 1673])
def test_f32_distances_are_exact_up_to_the_wrappers_limit(size):
    """The candidate records (-2x, -2y, -2z, |c|²), made from flat positions
    as the prep kernel makes them (round-tripped through ``_cand_coords``),
    and a point's |p|², each step of d² rounded to f32, give the exact
    integer d² for every block size the limits admit (6 (size-1)² < 2^24),
    corners included."""
    rng = np.random.default_rng(size)
    c = np.concatenate([rng.integers(0, size, (300, 3)),
                        [[0, 0, 0], [size - 1] * 3, [0, size - 1, 0]]])
    pos = torch.from_numpy((c[:, 0] * size + c[:, 1]) * size + c[:, 2])
    cc = bsw._cand_coords(pos, size)
    np.testing.assert_array_equal(cc.numpy(), c)
    p = np.concatenate([rng.integers(0, size, (200, 3)),
                        [[size - 1] * 3, [0, 0, 0], [size - 1, 0, size - 1]]])
    rec = torch.cat([-2 * cc, (cc * cc).sum(-1, keepdim=True)],
                    -1).to(torch.float32)
    pt = torch.from_numpy(p).to(torch.float32)
    pp = (torch.from_numpy(p) ** 2).sum(-1).to(torch.float32)
    # the kernel's order: ((pp + |c|²) - 2 z c_z) - 2 y c_y - 2 x c_x
    d2 = pp[:, None] + rec[None, :, 3]
    for axis in (2, 1, 0):
        d2 = d2 + pt[:, None, axis] * rec[None, :, axis]
    want = ((p[:, None, :] - c[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(d2.to(torch.int64).numpy(), want)
    assert int(want.max()) == 3 * (size - 1) ** 2


def _kernel_names(source):
    from pcc_geo_cnn_v2_tpu_torch.ops import kernels

    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                      r"(\w+)", (kernels.CSRC / source).read_text())


def test_k1_kernel_names_form_the_profile_family():
    """``tools/torch_profile_main_path.py`` finds K1's device time by the
    substring ``bucket_colsums``: each of K1's kernels (prep, sweep, scan)
    holds it and none of K3's does."""
    k1 = _kernel_names("bucket_colsums.cu")
    assert len(k1) == 3 and all("bucket_colsums" in n for n in k1), k1
    k3 = _kernel_names("bucket_colsums_d2.cu")
    assert k3 and not any("bucket_colsums" in n for n in k3), k3


def test_wrapper_refuses_column_sums_beyond_32_bits():
    most = (1 << 32) // (3 * 63 ** 2)  # P · 3 (B-1)² < 2^32 at B = 64
    if most * 3 * 63 ** 2 == 1 << 32:
        most -= 1
    bsw.check_k1_limits(most, 64)
    with pytest.raises(ValueError, match="not exact"):
        bsw.check_k1_limits(most + 1, 64)


def test_wrapper_refuses_distances_beyond_f32():
    bsw.check_k1_limits(1, 1673)  # 6 (B-1)² < 2^24
    with pytest.raises(ValueError, match="not exact"):
        bsw.check_k1_limits(1, 1674)


def test_cpu_wrapper_is_exact_beyond_the_kernels_limits():
    """On the CPU the wrapper takes the plain version, exact in int64 at any
    size: at B = 128 a 2^17 point budget (past the kernel's 32-bit limit)
    gives column sums above 2^32."""
    size, n_points = 128, 1 << 17
    with pytest.raises(ValueError, match="not exact"):
        bsw.check_k1_limits(n_points, size)
    pts = torch.full((1, n_points, 3), size - 1, dtype=torch.int32)
    pts[0, -5:] = -1  # padding rows contribute nothing
    far, near = 3 * (size - 1) ** 2, 3 * (size - 2) ** 2
    pos = torch.tensor([[0, (size + 1) * size + 1, 5]], dtype=torch.int32)
    colsum, candmin = bsw.bucket_colsums(
        pts, pos, torch.tensor([2], dtype=torch.int32),
        torch.tensor([n_points], dtype=torch.int32), size)
    valid = n_points - 5
    assert colsum.tolist() == [[valid * far, valid * near, 0]]
    assert candmin.tolist() == [[far, near, bsw.BIG]]
    assert int(colsum.max()) >= 1 << 32
