"""The Python side of the fused-tail kernels' launch geometry (K4a / K4b).

The CUDA kernels run only on a GPU; what decides WHICH voxels each block
computes lives in ``ops/fused_conv.py`` (``TILES``, ``tail_plan``) and is
checked here on the CPU: every plan covers every voxel of the volume
exactly once, ragged edges included; the depth-range
choice fills the card at small batch; the table of tiles mirrors the
constants of ``csrc/fused_tail.cuh``; the shared-memory budget those
constants imply fits an SM; and the wrappers' argument checks hold. The
weight layout the kernels read is ``pack_tail_weights``' ``[27, cin,
cout]`` as it stands (the ``mma`` B operand is read from it with
``ldmatrix.trans``: no second packing), checked against the JAX package's
``pack_tail_weights`` tap order.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcc_geo_cnn_v2_tpu.ops import pallas_conv as jpc
from pcc_geo_cnn_v2_tpu_torch.ops import fused_conv as fc
from pcc_geo_cnn_v2_tpu_torch.ops import kernels

DTYPES = (torch.float32, torch.bfloat16)
SMEM_LIMIT = 232448


def plan_boxes(spatial, plan):
    """The output box ``(d_lo, d_hi, h_lo, h_hi, w_lo, w_hi)`` (half-open,
    clipped to the volume) of every block of one batch element, in
    ``blockIdx.x`` order, as ``window_block`` of ``csrc/fused_tail.cuh``
    derives it from the plan's grid."""
    tiles = plan["tiles_h"] * plan["tiles_w"]
    boxes = []
    for b in range(plan["grid"][0]):
        tile, k = b % tiles, b // tiles
        h0 = (tile // plan["tiles_w"]) * plan["tile_h"]
        w0 = (tile % plan["tiles_w"]) * plan["tile_w"]
        d0 = k * plan["depth_chunk"]
        boxes.append((d0, min(d0 + plan["depth_chunk"], spatial),
                      h0, min(h0 + plan["tile_h"], spatial),
                      w0, min(w0 + plan["tile_w"], spatial)))
    return boxes


@pytest.mark.parametrize("n", [1, 2, 32])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("channels", fc.KERNEL_CHANNELS)
@pytest.mark.parametrize("spatial", [8, 12, 16, 32, 64])
def test_plan_covers_every_voxel_exactly_once(spatial, channels, dtype, n):
    plan = fc.tail_plan(spatial, channels, n, dtype)
    count = np.zeros((spatial,) * 3, np.int32)
    boxes = plan_boxes(spatial, plan)
    assert len(boxes) == plan["grid"][0] and plan["grid"][1] == n
    for d0, d1, h0, h1, w0, w1 in boxes:
        assert d0 < d1 and h0 < h1 and w0 < w1  # no empty block
        assert h1 - h0 <= plan["tile_h"] and w1 - w0 <= plan["tile_w"]
        assert d1 - d0 <= plan["depth_chunk"]
        count[d0:d1, h0:h1, w0:w1] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("slab", [4, 8, 16])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("spatial,channels", [(12, 16), (32, 64), (64, 16),
                                              (64, 32)])
def test_slab_plan_covers_every_voxel_exactly_once(spatial, channels, dtype,
                                                   slab):
    if spatial % slab:
        with pytest.raises(ValueError, match="multiple of slab"):
            fc.fused_residual_tail_slab(
                torch.zeros(1, spatial, spatial, spatial, channels,
                            device="meta"),
                *[torch.zeros(1, device="meta")] * 4, spatial=spatial,
                channels=channels, slab=slab, dtype=dtype)
        return
    plan = fc.tail_plan(spatial, channels, 2, dtype, depth_chunk=slab)
    assert plan["depth_chunk"] == slab
    assert plan["depth_ranges"] == spatial // slab
    count = np.zeros((spatial,) * 3, np.int32)
    for d0, d1, h0, h1, w0, w1 in plan_boxes(spatial, plan):
        assert d0 % slab == 0 and d1 - d0 == slab
        count[d0:d1, h0:h1, w0:w1] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("spatial,channels", [(32, 16), (16, 32), (8, 64),
                                              (16, 64), (32, 32)])
def test_depth_ranges_fill_the_card_at_small_batch(spatial, channels, dtype):
    """At N = 1 a whole-depth walk would leave most SMs idle: the plan cuts
    the depth into ranges until the grid has a block per SM or the ranges
    are single planes; at N = 32 it keeps long ranges (little seam
    recompute) once the grid is full."""
    one = fc.tail_plan(spatial, channels, 1, dtype)
    full = fc.tail_plan(spatial, channels, 32, dtype)
    assert one["depth_chunk"] <= full["depth_chunk"]
    assert one["grid"][0] >= min(fc.H100_SMS // 2,
                                 one["tiles_h"] * one["tiles_w"] * spatial)
    assert full["grid"][0] * 32 >= 64
    # rounds of work never beat the single-round plan by splitting further
    tiles = full["tiles_h"] * full["tiles_w"]
    if tiles * 32 >= fc.H100_SMS:
        assert full["depth_chunk"] >= spatial // 4


def test_plan_adapts_to_the_sm_count_and_refuses_bad_arguments():
    few = fc.tail_plan(16, 64, 1, torch.bfloat16, sms=4)
    many = fc.tail_plan(16, 64, 1, torch.bfloat16, sms=132)
    assert few["depth_chunk"] > many["depth_chunk"]
    with pytest.raises(ValueError, match="no kernel"):
        fc.tail_plan(16, 8, 1, torch.float32)
    with pytest.raises(ValueError, match="no kernel"):
        fc.tail_plan(16, 16, 1, torch.float16)
    with pytest.raises(ValueError, match="depth_chunk"):
        fc.tail_plan(16, 16, 1, torch.float32, depth_chunk=0)
    with pytest.raises(ValueError, match="depth_chunk"):
        fc.tail_plan(16, 16, 1, torch.float32, depth_chunk=17)


def _geoms():
    """{(dtype, C): dict of the Geom constants} parsed from the header."""
    text = (kernels.CSRC / "fused_tail.cuh").read_text()
    pat = re.compile(
        r"template <> struct Geom<(float|__nv_bfloat16), (\d+)> \{\s*"
        r"static constexpr int ([^;]+);")
    out = {}
    for ctype, c, body in pat.findall(text):
        vals = {k.strip(): int(v) for k, v in
                (item.split("=") for item in body.split(","))}
        dtype = torch.float32 if ctype == "float" else torch.bfloat16
        out[(dtype, int(c))] = vals
    return out


def _smem_bytes(dtype, c, g):
    """Shared memory of a block as ``Tile`` of the header reckons it: three
    input planes (2-voxel halo), three intermediate planes (1-voxel halo),
    NBUF weight stages; padded pitches."""
    es = 4 if dtype == torch.float32 else 2
    ap, wp = c + (4 if dtype == torch.float32 else 8), c + 8
    iv, mv = (g["TH"] + 4) * (g["TW"] + 4), (g["TH"] + 2) * (g["TW"] + 2)
    return (3 * iv * ap + 3 * mv * ap + g["NBUF"] * g["R"] * wp) * es


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("channels", fc.KERNEL_CHANNELS)
def test_tiles_table_mirrors_the_header_and_fits_an_sm(channels, dtype):
    geoms = _geoms()
    assert set(geoms) == set(fc.TILES)
    g = geoms[(dtype, channels)]
    th, tw, per_sm = fc.TILES[(dtype, channels)]
    assert (g["TH"], g["TW"]) == (th, tw)
    nbytes = _smem_bytes(dtype, channels, g)
    assert nbytes <= SMEM_LIMIT
    # the SM's 228 KB less 1 KB the system keeps per block
    assert per_sm == (SMEM_LIMIT + 1024) // (nbytes + 1024)
    # a stage is whole k-steps inside one tap; n8-tiles divide over warps
    kk = 8 if dtype == torch.float32 else 16
    assert (27 * channels) % g["R"] == 0 and g["R"] % kk == 0
    assert channels % (8 * g["WN"]) == 0
    if dtype == torch.bfloat16:  # ldmatrix.x4 loads two n8-tiles
        assert (channels // 8 // g["WN"]) % 2 == 0
    # 16-byte rows for cp.async / ldmatrix
    es = 4 if dtype == torch.float32 else 2
    assert (channels * es) % 16 == 0


@pytest.mark.parametrize("channels", fc.KERNEL_CHANNELS)
def test_kernel_weight_layout_is_the_packed_one(channels):
    """The kernels stage rows ``tap * C + cin`` of ``[27 * C, C]``: row r of
    the flattened packed weights is tap ``r // C`` (dz, dy, dx row-major),
    input channel ``r % C``, and the JAX ``pack_tail_weights`` taps are the
    same 27 matrices in the same order (its block-diagonal lane fold
    aside)."""
    rng = np.random.default_rng(channels)
    k = rng.normal(size=(3, 3, 3, channels, channels)).astype(np.float32)
    packed = fc.pack_tail_weights(k, torch.float32)
    rows = packed.reshape(27 * channels, channels).numpy()
    for r in (0, channels - 1, channels, 13 * channels + 5,
              27 * channels - 1):
        tap, ci = divmod(r, channels)
        dz, dy, dx = tap // 9, (tap // 3) % 3, tap % 3
        np.testing.assert_array_equal(rows[r], k[dz, dy, dx, ci])
    # round trip through the module layout [cout, cin, 3, 3, 3]
    oidhw = torch.from_numpy(k).permute(4, 3, 0, 1, 2).contiguous()
    assert torch.equal(fc.pack_tail_weights(oidhw, torch.float32,
                                            oidhw=True), packed)
    # the JAX package's packing: tap t is kron(I_G, W_t), G = 128 / C; its
    # leading [C, C] block is the same tap matrix, in f32 and in bf16
    g = 128 // channels
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        jw = np.asarray(jpc.pack_tail_weights(k, g, dtype=jdt)
                        .astype(jnp.float32))
        assert jw.shape == (27, 128, 128)
        ours = fc.pack_tail_weights(k, tdt).float().numpy()
        np.testing.assert_array_equal(jw[:, :channels, :channels], ours)
        np.testing.assert_array_equal(jw[:, -channels:, -channels:], ours)


def test_c_entries_carry_the_plan_and_report_the_geometry():
    """K4a's C entry takes the depth range the plan chose; the geometry
    entry lets the wrapper hold ``TILES`` against the built library."""
    src, fns = kernels.KERNELS["fused_tail"]
    text = (kernels.CSRC / src).read_text()
    assert "int dchunk" in text and len(fns["pcc_fused_tail"]) == 13
    assert "pcc_fused_tail_geometry" in fns
    slab = (kernels.CSRC / kernels.KERNELS["fused_tail_slab"][0]).read_text()
    assert f"slab % {fc.TILE_DEPTH}" in slab  # the wrapper's promise
    assert "launch_any" in text and "launch_any" in slab  # one body
