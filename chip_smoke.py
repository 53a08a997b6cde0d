#!/usr/bin/env python3
"""Drive the PyTorch port's encode / decode paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Everything runs on one 10-bit ``figure_cloud`` with normals, partitioned
at octree level 4, model c3p at full width (64 filters; f32, and bf16 on
path C) with the committed ``bench_c3p.msgpack.gz`` weights,
``batch_blocks=32``. Phases (each passes or ends the run with a non-zero
exit):

1. Print the card (``nvidia-smi`` name and power limit) and the torch/CUDA
   versions; build every kernel of ``pcc_geo_cnn_v2_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together) and the host C++ libraries,
   so that no build lands inside a timed phase.
2. K1 (bucket prefix-min column sums) against its plain PyTorch version on
   the card, at main-path shapes (K = 32768, real x_hat of the flagship
   model on the cloud below): colsum / candmin equal for every k < cnt0,
   equal picks and overflow flags; then again at the overflow rerun's
   shape (K = B³) on every block of the cloud that overflows K = 32768.
   The edges on seeded random inputs (``check_k1_edges``): blocks without
   points or candidates, ragged cnt0 / K / P, two launches
   bit-identical, N = 1 equal to its row of the batch.
3. K2 (full-cloud D1 sums from packed neighbour grids) against its plain
   version (the gather, halo-volume and coarse-bound chain, 64 blocks a
   step) on the whole cloud, both directions: sum, n, unres_cnt and the
   packed outlier bytes equal, two launches bit-identical, the CUDA
   launches of one call counted under ``torch.profiler`` (2); timed a
   cloud and on 64 blocks, its bound from the function's work, the count of
   the separable passes beside it, and the device work of the
   ``blockwise_d1_sums`` call around it. The edges on seeded clouds (``check_k2_edges``): d² = halo² counted
   and 145 flagged across a block edge, a target in a corner neighbour,
   blocks without target or query at the cloud's edge, a one-block cloud
   and a one-row neighbour table equal to their rows.
4. K3 (bucket sweep with point-to-plane terms) against its plain version
   on the first chunk at K = 32768 and on the overflowing blocks at
   K = B³: colsum / candmin equal K1's and the plain version's, candplane
   equal, colplane within ``npts · 2^-20 + 1e-6 · |value|`` (the kernel
   sums plane² in 2^-20 fixed point), the columns past cnt0 equal, two
   launches bit-identical, equal picks for ``("d1_mse", "d2_mse")``, the
   CUDA launches of one call counted under ``torch.profiler`` (3). The
   edges on seeded random inputs (``check_k3_edges``): blocks without
   points or candidates, cnt0 of 512, 37 and K, ragged K / P, a padding
   row inside a point count, normals at ``MAX_NORMAL``, one point on four
   rows across warps and CTAs with tied candidates across tiles; two
   launches bit-identical, N = 1 equal to its row of the batch.
5. K5 (exact-EDT sweep sums) against its plain version on the first
   chunk: ab, ba, cnt equal for every threshold — with the point lists
   (sparse tail outside the kernel, the main path's call) and without
   (the kernel computes every threshold) — and picks equal to the bucket
   backend's; the CUDA launches of one call counted under
   ``torch.profiler`` (at most 3). The edges on seeded random inputs at
   B = 64 and B = 90 (``check_k5_edges``): blocks without candidates or
   points, t_end = 0, one candidate far from every point, an all-occupied
   block, a NaN, threshold values in x_hat; two launches bit-identical,
   N = 1 equal to its row of the batch, the same launches a call at two
   T.
6. d1 path: ``compress_blocks_device_opt`` → container →
   ``decompress_blocks``. The decoded blocks must equal the encoder's
   embedded reconstruction bit for bit, the encoder's device D1 PSNR must
   equal a host KD-tree D1 PSNR of the decoded cloud, K1 and K2 must have
   launched.
7. Path A, D2 encode with normals: ``opt_metrics=("d1_mse", "d2_mse"),
   with_normals=True`` → two containers, each decoded bit-exactly; the d1
   stream's bytes equal phase 6's; point by point, every neighbour the
   encoder's D2 metric took (both directions) is a point of the other
   cloud at the host KD-tree's nearest distance, and the host oracle's
   own formulas over those neighbours give the encoder's D2 sums and PSNR
   (1e-6 relative); against the oracle's KD-tree neighbours, which differ
   at distance ties only, the D2 PSNR is within 1 dB (see
   ``D2_PSNR_TOL_DB``); K3 and K2 launched, K1 not.
8. Path B, ``sweep_backend="pallas"``: d1 encode → decode, bit-exact,
   stream bytes equal phase 6's; K5 and K2 launched, K1 and K3 not.
9. K4a / K4b (fused residual tails) against their plain versions, in f32
   and in bf16, at the six stage shapes of c3p at N = 32 on the real
   activations of the first chunk (K4a: 32³×16, 16³×32, 8³×64, 16³×64,
   32³×32; K4b: 64³×16 with ``slab=8``): f32 within 1e-4 of the tensor's
   largest value, bf16 within 2 bf16 steps (``bf16_steps``), two launches
   bit-identical, N = 1 equal to row 0 of N = 32, and K4b equal to K4a bit
   for bit at 32³×16 (slab seams). Each is timed beside the cuDNN chain
   conv → relu → conv → relu → add on the same tensors (``library_ms``),
   both as bursts of four calls between two events (a pipelined caller's
   time per call: the wrapper's host time overlaps the device's); the
   share of the bound reached and ``ms / library_ms`` go into each row.
   The stage shapes of c3 that c3p lacks, a volume no tile divides, and
   one N = 1 case per kernel (the small grid the depth ranges are for) are
   checked on random inputs.
10. Path C, ``conv_backend="pallas"``, f32: d1 encode → container →
   decode on the whole cloud, bit-exact; encoder D1 PSNR equals the host
   KD-tree's; y symbols ≥ 99.9% equal to the cuDNN backend's, bpp within
   1% and PSNR within 0.05 dB of phase 6's; K4a and K4b launched 5 + 1
   times per encode chunk and 2 + 1 per decode chunk, K1 and K2 as on the
   d1 path.
11. Path C in bf16 (``dtype=torch.bfloat16``): bit-exact decode, bpp
   within 5% and PSNR within 0.5 dB of path C in f32; the cuDNN backend in
   bf16 is run beside it for comparison.
12. c2, then c1 (V1 transforms, 32 filters, the committed
   ``assets/rd/{c2,c1}/2.00e-04.msgpack.gz``): the d1 path on the whole
   cloud, bit-exact, encoder D1 PSNR equal to the host KD-tree's, K1 and
   K2 launched, K4 not; bpp, PSNR and walls printed, and the device
   milliseconds of the two k9 layers (analysis 1 → 32 at 64³ → 32³,
   synthesis 32 → 1 at 32³ → 64³) on the first chunk beside its whole
   decode.
13. The host-threshold encoder (``compress_blocks``), c3p: with
   ``fixed_threshold`` on the whole cloud (every index 128, bit-exact, no
   kernel launched: its selection is host KD-trees); then the adaptive
   host sweep on a cut, the first 16 blocks of the partition as their own
   cloud (``cut_cloud``; the host sweep is CPU KD-tree work of seconds a
   block), bit-exact, its picks beside the bucket backend's (K1) on the
   same blocks: the share equal and, for every block that differs, the
   two candidates' host d1_mse.
14. d2 on the point sweep: ``sweep_backend="xla"`` with normals and
   ``opt_metrics=("d1_mse", "d2_mse")`` on the cut (banded argmin EDTs,
   band ``d2_band``): bit-exact, d1 picks equal K1's, d2 picks printed
   beside K3's with the share equal (K3's AB takes each original's own
   normal, the point sweep the vote mean); no sweep kernel launched, K2
   for the d1 group; and the point sweep's d2 arrays bit-equal over two
   runs on the cut's chunk (the normal votes are summed in fixed point).
   Then ``n_thresholds=64`` on the cut through K1, K5 and K3 (with
   normals): each launched, bit-exact, the d1 streams byte-equal.

The launch counts are set to 0 just before each path and read just after.
Phases 12-14 print their seconds.
Prints a ``kernels`` JSON line (per kernel: launches on its path, max
error against the plain version, its median time (K1, K2, K3, K4 and K5 per
call in bursts of four calls, so that the wrapper's host time overlaps
the kernels), the plain time, the least time the card could take for the
same work and the share of it reached (K1 and K3 at the chunk and the
rerun, K2, K4, K5), the CUDA launches of one call (K2, K3, K5) and, for K4, the
cuDNN chain's time and ms / library), the card line, and last
``{"ok": true, "device": {...}}``.
Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import gzip
import io
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
ASSET = REPO / "pcc_geo_cnn_v2_tpu/assets/bench_c3p.msgpack.gz"
RESOLUTION, LEVEL, BLOCK, BATCH = 1024, 4, 64, 32
CLOUD_SEED = 300
HALO, HALO_BATCH = 12, 64
# H100 SXM published peaks: HBM3 bytes/s, and int32 operations/s on the
# CUDA cores. The data sheet's 67 TFLOP/s f32 counts an FMA as two
# operations on 128 f32 lanes per SM; an SM has 64 int32 lanes, so the
# int32 instruction rate is 67e12 / 2 / 2. The kernels do integer work;
# K3's few plane² evaluations count against the f32 rate.
PEAK_BYTES_S = 3.35e12
PEAK_INT32_OPS_S = 67e12 / 4
PEAK_F32_OPS_S = 67e12
PEAK_BF16_OPS_S = 989e12  # dense bf16 on the tensor cores
# f32 operations per (point, candidate) pair that K1's function needs. d²
# of integer coordinates below 64 is exact in f32 as |p|² + |c|² - 2 p·c
# with -2c and |c|² computed once per candidate: 3 multiply-adds (6
# operations, as the data sheet counts them) and 1 add; then the compare
# with the running minimum and the column minimum. The column sum is paid
# where a running minimum changes (a few times per point), not per pair,
# and is not counted. The earlier count, printed beside it: 9 int32
# operations per pair at the int32 rate (d² as 3 subtractions and 3
# multiply(-add)s, and a column-sum add per pair). K3 needs the same per
# pair, plus one plane² (3 multiplies, 2 adds, 1 square: 6 f32 operations)
# per candidate (candplane) and at least one per point (colplane)
K1_F32_OPS_PER_PAIR = 9
K1_INT32_OPS_PER_PAIR = 9
K3_F32_OPS_PER_PLANE = 6
# K3: prep, sweep and scan kernels, one C entry
K3_CUDA_LAUNCHES = 3
K3_OUTPUTS = ("colsum", "candmin", "colplane", "candplane")
# K5, int32 operations the function needs. cnt and ba of every threshold
# come from one pass over the voxels (find the voxel's threshold bin, add 1
# and dt_orig into it: 3 operations per voxel) and a cumulative sum over
# the thresholds. The sets are nested (S_t = S_{t+1} ∪ {bin = t + 1}), so
# a design that adds the voxels whose bin it reaches touches each voxel
# once, as counted above. The EDT is needed only at the thresholds t <
# t_end = min(first_empty, t_small): there, per occupied voxel, one add of
# its distance; plus, per occupied voxel with result D, the ~pi D rows of
# its disc search at 2 operations (add, min) each — summed over voxels
# that is 2 pi ab. Printed beside it: the bound of designs that build
# each set (a membership compare per voxel and EDT threshold, as the
# kernel does) and the earlier count (5 per voxel and EDT threshold: the
# compare and two 2-operation column scans)
K5_OPS_PER_VOXEL_ONCE = 3
K5_OPS_PER_OCCUPIED_EDT = 1
K5_OPS_PER_VOXEL_EDT_SETS = 1
K5_OPS_PER_VOXEL_EDT_COLUMNS = 5
# K2: two kernels behind one C entry (the searches, the partials' sums);
# int32 operations the function needs: one a query voxel, and the disc
# search (~pi D rows for a voxel whose result is D, capped at halo^2, 2
# operations each), as K5's 2 pi AB
K2_CUDA_LAUNCHES = 2
K2_OPS_PER_QUERY = 1
# Encoder-side D2 PSNR against the host KD-tree oracle. Both take true
# nearest neighbours, but on an integer grid most neighbours at distance
# > 0 are tied, the plane distance depends on which tied neighbour is
# taken, and the EDT's scan order breaks ties another way than a KD-tree.
# tests/test_d2_metrics.py allows 0.25 dB on jittered spheres; on a model
# output (most points at distance 0, most of the others tied) the two
# rules sit further apart, so the sharp check is made point by point
# (check_d2_identities) and this bound only frames the tie effect
D2_PSNR_TOL_DB = 1.0
# phase 12: the committed V1-family weights; phases 13-14: the cut
RD_ASSETS = REPO / "pcc_geo_cnn_v2_tpu/assets/rd"
V1_LAMBDA = "2.00e-04"
CUT_BLOCKS = 16


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps, warm=True, burst=1):
    """Median milliseconds of ``fn()`` over ``reps`` runs (CUDA events);
    with ``burst`` > 1 each run is that many calls back to back and the
    time is per call."""
    import torch

    if warm:
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(burst):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / burst)
    return float(np.median(times))


def bound(nbytes, ops, f32_ops=0):
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = ops / PEAK_INT32_OPS_S + f32_ops / PEAK_F32_OPS_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def sweep_args(codec, pts, x_hat, K):
    """K1 / K3 inputs for the blocks of ``x_hat`` at candidate budget
    ``K``: (pts, pos, cnt0, cnt0 clamped to K, npts, K capped at B³)."""
    import torch

    from pcc_geo_cnn_v2_tpu_torch.ops import bucket_sweep as bsw

    _, pos, cnt0, K = bsw.sorted_candidates(x_hat[..., 0], codec.thr_dev, K)
    pts = pts.contiguous()
    npts = (pts[:, :, 0] >= 0).sum(-1).to(torch.int32)
    return pts, pos, cnt0, torch.clamp_max(cnt0, K), npts, K


def check_k1(codec, pts, x_hat, K, reps=10, plain_reps=2):
    """Phase 2: K1 vs its plain version on the blocks of ``x_hat`` at
    candidate budget ``K`` (a canonical chunk at the sweep's budget, or
    the overflowed blocks at the rerun's K = B³)."""
    import torch

    from pcc_geo_cnn_v2_tpu_torch.ops import bucket_sweep as bsw

    xh = x_hat[..., 0]
    pts, pos, cnt0, cnt0c, npts, K = sweep_args(codec, pts, x_hat, K)
    args = (pts, pos, cnt0c, npts, BLOCK)
    ks, km = bsw.bucket_colsums(*args)
    ps, pm = bsw.bucket_colsums_plain(*args)
    torch.cuda.synchronize()
    valid = torch.arange(K, device=pos.device)[None, :] < cnt0c[:, None]
    err = max(int((ks - ps)[valid].abs().max()),
              int((km - pm)[valid].abs().max()))
    assert err == 0, f"K1 disagrees with its plain version (max err {err})"
    sel = dict(thresholds=codec.thr_dev, K=K)
    pk, ok = bsw.select_thresholds_d1_bucket(xh, pts, **sel)
    pp, op = bsw.select_thresholds_d1_bucket(
        xh, pts, colsums_fn=bsw.bucket_colsums_plain, **sel)
    assert torch.equal(pk, pp) and torch.equal(ok, op), "K1 picks differ"
    ms = time_ms(lambda: bsw.bucket_colsums(*args), reps=reps, burst=4)
    plain_ms = time_ms(lambda: bsw.bucket_colsums_plain(*args),
                       reps=plain_reps)
    pairs = int((npts.to(torch.int64) * cnt0c.to(torch.int64)).sum())
    nbytes = (pts.numel() + pos.numel() + 2 * len(npts)) * 4 \
        + 2 * pos.numel() * 4
    bound_ms, by = bound(nbytes, 0, K1_F32_OPS_PER_PAIR * pairs)
    bound_int32_ms = bound(nbytes, K1_INT32_OPS_PER_PAIR * pairs)[0]
    plan = bsw.bucket_plan(len(npts), pts.shape[1])
    log(f"K1 ok at K = {K}: {len(npts)} blocks, cnt0 {int(cnt0.min())}.."
        f"{int(cnt0.max())}, {pairs} point-candidate pairs, "
        f"overflow {int(ok.sum())}, plan {plan['threads']} threads, grid "
        f"{plan['grid']}; {ms:.3f} ms (plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.3f} ms by {by}: {100 * bound_ms / ms:.1f}% "
        f"reached; the int32 count's bound {bound_int32_ms:.3f} ms)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, bound_share=bound_ms / ms)


def check_k1_edges():
    """Phase 2, the edges on seeded random inputs at B = 64: a block
    without points and one without candidates, cnt0 values that are not
    multiples of the kernel's 512-candidate tile, K and P that are not
    multiples of 32 or of a CTA's points, padding rows inside the point
    budget. K1 must equal its plain version, two launches must give the
    same bits, and N = 1 must equal that block's row of the batch of 32."""
    import torch

    from pcc_geo_cnn_v2_tpu_torch.ops import bucket_sweep as bsw

    rng = np.random.default_rng(6)
    n, P, K = 32, 1000, 4003
    npts = rng.integers(1, P + 1, n)
    cnt0 = rng.integers(1, K + 1, n)
    npts[3], cnt0[5] = 0, 0
    cnt0[:3] = (K, 512, 37)
    pts = np.full((n, P, 3), -1, np.int32)
    for i, m in enumerate(npts):
        pts[i, :m] = rng.integers(0, BLOCK, (m, 3))
    pos = np.stack([rng.permutation(BLOCK ** 3)[:K] for _ in range(n)])
    dev = "cuda"
    args = [torch.as_tensor(a.astype(np.int32), device=dev)
            for a in (pts, pos, cnt0, npts)]
    got = bsw.bucket_colsums(*args, BLOCK)
    again = bsw.bucket_colsums(*args, BLOCK)
    ref = bsw.bucket_colsums_plain(*args, BLOCK)
    ones = [bsw.bucket_colsums(*(a[i:i + 1] for a in args), BLOCK)
            for i in (0, 3, 7)]
    torch.cuda.synchronize()
    for name, g, r in zip(("colsum", "candmin"), got, ref):
        err = int((g - r).abs().max())
        assert err == 0, f"K1 edges: {name} differs from plain ({err})"
    assert all(torch.equal(a, b) for a, b in zip(got, again)), \
        "K1: two launches differ"
    for i, res in zip((0, 3, 7), ones):
        assert all(torch.equal(a[0], b[i]) for a, b in zip(res, got)), \
            f"K1: N = 1 differs from row {i} of the batch"
    log(f"K1 edges ok (B = {BLOCK}, N = {n}, P = {P}, K = {K}; npts 0 and "
        f"cnt0 0, 512, 37 present): equal to plain, two launches "
        f"bit-identical, N = 1 equal to its row")


def k2_inputs(occ, mask, origins):
    """K2's inputs for a cloud: both packed grids with a zero row last, and
    the neighbour table (absent → that row), as ``blockwise_d1_sums``
    makes them."""
    import torch

    from pcc_geo_cnn_v2_tpu_torch.ops import cloud_metrics as cm

    n, dev = len(origins), occ.device
    nb = cm.neighbor_table(origins, BLOCK)
    zero = torch.zeros(1, occ.shape[1], dtype=torch.uint8, device=dev)
    return (torch.cat([occ[:n], zero]), torch.cat([mask[:n], zero]),
            torch.as_tensor(np.where(nb < 0, n, nb), dtype=torch.int32,
                            device=dev))


def device_work(call):
    """(device operations, device ms) of one call under torch.profiler:
    every kernel, copy and fill that took device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    us = lambda e: float(getattr(e, "self_device_time_total", 0.0)  # noqa
                         or getattr(e, "self_cuda_time_total", 0.0))
    evts = [e for e in prof.key_averages() if us(e) > 0]
    return sum(e.count for e in evts), sum(us(e) for e in evts) / 1e3


def passes_k2_ops(a_ext, b_ext, idx):
    """The separable passes' count of K2's work, printed beside the bound,
    as the earlier kernel over assembled volumes did it: per 64-block
    batch and direction, 4 operations a halo voxel for the z scans and
    4 kmax + 1 a core row voxel and a query voxel for the bounded y and x
    passes, kmax from the coarse grid (``halo_kmax``)."""
    import torch

    from pcc_geo_cnn_v2_tpu_torch.ops import halo as hl

    H, ops = BLOCK + 2 * HALO, 0
    for lo in range(0, len(idx), HALO_BATCH):
        ix = idx[lo:lo + HALO_BATCH].long()
        for q_ext, t_ext in ((a_ext, b_ext), (b_ext, a_ext)):
            qry = hl.query_core(q_ext[ix], BLOCK)
            km = hl.halo_kmax(qry, hl.assemble_halo(t_ext[ix], BLOCK, HALO),
                              HALO).to(torch.int64)
            nq = (qry > 0).sum(dim=(1, 2, 3))
            ops += 4 * len(ix) * H ** 3 + int(
                ((BLOCK * BLOCK * H + nq) * (4 * km + 1)).sum())
    return ops


def check_k2(occ, mask, origins):
    """Phase 3: K2 vs its plain version on the whole cloud, both
    directions."""
    import torch

    from pcc_geo_cnn_v2_tpu_torch.ops import cloud_metrics as cm
    from pcc_geo_cnn_v2_tpu_torch.ops import halo as hl

    n = len(origins)
    a_ext, b_ext, idx = k2_inputs(occ, mask, origins)
    kw = dict(size=BLOCK, halo=HALO)
    call = lambda: hl.halo_d1_packed(a_ext, b_ext, idx, **kw)  # noqa: E731
    got, again = call(), call()
    ref = hl.halo_d1_packed_plain(a_ext, b_ext, idx, batch=HALO_BATCH, **kw)
    torch.cuda.synchronize()
    err = max(int((g.to(torch.int64) - r.to(torch.int64)).abs().max())
              for g, r in zip(got, ref))
    assert err == 0, f"K2 disagrees with its plain version (max err {err})"
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert all(torch.equal(g, a) for g, a in zip(got, again)), \
        "K2: two launches differ"
    n_launches = cuda_launches(call, "halo_edt")
    assert n_launches == K2_CUDA_LAUNCHES, n_launches
    ms = time_ms(call, reps=10, burst=4)
    sub = idx[:HALO_BATCH].contiguous()
    ms_64 = time_ms(lambda: hl.halo_d1_packed(a_ext, b_ext, sub, **kw),
                    reps=10, burst=4)
    plain_ms = time_ms(lambda: hl.halo_d1_packed_plain(
        a_ext, b_ext, idx, batch=HALO_BATCH, **kw), reps=2)
    st = got[0].cpu().numpy().astype(np.float64)  # [2, (sum, n, cnt), n]
    queries, flagged = st[:, 1].sum(), st[:, 2].sum()
    ops = K2_OPS_PER_QUERY * queries + 2 * np.pi * (
        st[:, 0].sum() + HALO * HALO * flagged)
    # both packed grids read once, both directions' masks written, the
    # per-block scalars, the neighbour table
    nbytes = 4 * n * BLOCK ** 3 // 8 + 2 * 3 * n * 8 + idx.numel() * 4
    bound_ms, by = bound(nbytes, ops)
    passes_bound_ms = bound(nbytes, passes_k2_ops(a_ext, b_ext, idx))[0]
    d1_ops, d1_ms = device_work(lambda: cm.blockwise_d1_sums(
        occ, mask, origins, BLOCK, halo=HALO, batch=HALO_BATCH))
    log(f"K2 ok: {n} blocks, both directions, {int(queries)} queries, "
        f"{int(flagged)} outliers: stats and masks equal the plain "
        f"version's, two launches bit-identical, {n_launches} CUDA launches "
        f"a call; {ms:.3f} ms a cloud, {ms_64:.3f} ms for {len(sub)} blocks "
        f"(plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {by}: "
        f"{100 * bound_ms / ms:.1f}% reached; the separable passes' bound "
        f"{passes_bound_ms:.3f} ms); the D1-sums call: {d1_ops} device "
        f"operations, {d1_ms:.3f} ms of device time")
    return dict(max_abs_err=err, ms=ms, ms_per_64_blocks=ms_64,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                bound_share=bound_ms / ms, cuda_launches_a_call=n_launches,
                passes_bound_ms=passes_bound_ms, d1_sums_device_ops=d1_ops,
                d1_sums_device_ms=d1_ms)


def k2_edge_cloud():
    """Seeded clouds A and B at B = 64 with K2's edges: (origins, packed A,
    packed B) as numpy arrays. Blocks 0-3 touch: A's (60, 30, 70) and
    (60, 50, 70) in block 2 have B's (72, 30, 70) at d² 144 = halo² and
    (72, 51, 70) at 145 across the edge to block 1; A's (63, 63, 63) in
    block 0 has B's (66, 66, 66) at 27 in its corner neighbour, block 3.
    Blocks 4 and 5 stand alone (no neighbours): block 4 holds A voxels and
    no target, block 5 B voxels and no query. Blocks 6 and 7 touch each
    other and hold random voxels of both clouds."""
    rng = np.random.default_rng(9)
    origins = np.array([(0, 0, 0), (64, 0, 64), (0, 0, 64), (64, 64, 64),
                        (512, 0, 0), (0, 512, 0), (512, 512, 512),
                        (512, 512, 576)])
    grids = np.zeros((2, len(origins), BLOCK, BLOCK, BLOCK), bool)
    for c, pts in enumerate((((60, 30, 70), (60, 50, 70), (63, 63, 63)),
                             ((72, 30, 70), (72, 51, 70), (66, 66, 66)))):
        for p in pts:
            i = int(np.nonzero((origins == np.asarray(p) // BLOCK * BLOCK)
                               .all(1))[0][0])
            grids[(c, i, *(np.asarray(p) % BLOCK))] = True
    grids[0, 4] = rng.random((BLOCK,) * 3) < 0.002
    grids[1, 5] = rng.random((BLOCK,) * 3) < 0.002
    grids[:, 6:] = rng.random((2, 2) + (BLOCK,) * 3) < [[[[[0.003]]]],
                                                        [[[[0.0005]]]]]
    packed = np.packbits(grids.reshape(2, len(origins), -1), axis=-1,
                         bitorder="big")
    return origins, packed[0], packed[1]


def check_k2_edges():
    """Phase 3, the edges (``k2_edge_cloud``): K2 equal to its plain
    version, the d² = halo² boundary counted and 145 flagged, the corner
    neighbour's target found, a block without target all flagged, a block
    without query empty, two launches bit-identical, a one-block cloud (n
    = 1) and a one-row neighbour table equal to their rows of the whole
    call, and K2's CUDA launches a call."""
    import torch

    from pcc_geo_cnn_v2_tpu_torch.ops import halo as hl

    origins, a, b = k2_edge_cloud()
    kw = dict(size=BLOCK, halo=HALO)
    dev = torch.device("cuda")
    a_ext, b_ext, idx = k2_inputs(torch.as_tensor(a, device=dev),
                                  torch.as_tensor(b, device=dev), origins)
    got = hl.halo_d1_packed(a_ext, b_ext, idx, **kw)
    again = hl.halo_d1_packed(a_ext, b_ext, idx, **kw)
    ref = hl.halo_d1_packed_plain(a_ext, b_ext, idx, **kw)
    row6 = hl.halo_d1_packed(a_ext, b_ext, idx[6:7].contiguous(), **kw)
    one = k2_inputs(torch.as_tensor(a[4:5], device=dev),
                    torch.as_tensor(b[4:5], device=dev), origins[4:5])
    got1 = hl.halo_d1_packed(*one, **kw)
    ref1 = hl.halo_d1_packed_plain(*one, **kw)
    torch.cuda.synchronize()
    for g, r in ((got, ref), (again, got), (got1, ref1)):
        assert all(torch.equal(x, y) for x, y in zip(g, r)), \
            "K2 edges: differs from plain or between launches"
    assert torch.equal(row6[0][..., 0], got[0][..., 6]) and \
        torch.equal(row6[1][:, 0], got[1][:, 6]), "K2: one row differs"
    assert torch.equal(got1[0][..., 0], got[0][..., 4]) and \
        torch.equal(got1[1][:, 0], got[1][:, 4]), "K2: n = 1 differs"
    st = got[0].cpu().numpy()  # [direction, (sum, n, unres_cnt), block]
    assert tuple(st[0, :, 2]) == (144, 2, 1), st[0, :, 2]
    assert tuple(st[1, :, 1]) == (144, 2, 1), st[1, :, 1]
    assert tuple(st[0, :, 0]) == (27, 1, 0) and tuple(st[1, :, 3]) == \
        (27, 1, 0), (st[0, :, 0], st[1, :, 3])
    assert st[0, 1, 4] > 0 and st[0, 2, 4] == st[0, 1, 4] and st[0, 0, 4] == 0
    assert st[1, 1, 5] > 0 and st[1, 2, 5] == st[1, 1, 5]
    assert (st[0, :, 5] == 0).all() and (st[1, :, 4] == 0).all()
    n_launches = cuda_launches(lambda: hl.halo_d1_packed(a_ext, b_ext, idx,
                                                         **kw), "halo_edt")
    assert n_launches == K2_CUDA_LAUNCHES, n_launches
    log(f"K2 edges ok (B = {BLOCK}, halo {HALO}, {len(origins)} blocks: d² "
        f"144 counted and 145 flagged across a block edge, the corner "
        f"neighbour's target at 27, no target (all {int(st[0, 1, 4])} "
        f"flagged), no query, cloud edges; random blocks with "
        f"{int(st[:, 2, 6:].sum())} outliers): equal to plain, two launches "
        f"bit-identical, n = 1 and a one-row table equal to their rows, "
        f"{n_launches} CUDA launches a call")


def cuda_launches(call, family):
    """CUDA kernels one call launches whose names hold ``family``, counted
    by torch.profiler (K3's names hold ``bucket_d2``, K5's ``edt_sweep``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if family in e.key and "cudaLaunch" not in e.key)


def check_k3(codec, pts, nrm, x_hat, K, reps=10, plain_reps=2):
    """Phase 4: K3 vs its plain version and vs K1 on the blocks of
    ``x_hat`` at candidate budget ``K``."""
    import torch

    from pcc_geo_cnn_v2_tpu_torch.ops import bucket_sweep as bsw

    xh, nrm = x_hat[..., 0], nrm.contiguous()
    pts, pos, _, cnt0c, npts, K = sweep_args(codec, pts, x_hat, K)
    args = (pts, nrm, pos, cnt0c, npts, BLOCK)
    got = bsw.bucket_colsums_d2(*args)
    again = bsw.bucket_colsums_d2(*args)
    ref = bsw.bucket_colsums_d2_plain(*args)
    k1 = bsw.bucket_colsums(pts, pos, cnt0c, npts, BLOCK)
    torch.cuda.synchronize()
    valid = torch.arange(K, device=pos.device)[None, :] < cnt0c[:, None]
    assert all(torch.equal(a, b) for a, b in zip(got, again)), \
        "K3: two launches differ"
    for name, a, b, c in (("colsum", got[0], ref[0], k1[0]),
                          ("candmin", got[1], ref[1], k1[1])):
        assert torch.equal(a[valid], b[valid]), f"K3 {name} != plain"
        assert torch.equal(a[valid], c[valid]), f"K3 {name} != K1"
    err_cand = float((got[3] - ref[3])[valid].abs().max())
    assert err_cand == 0, f"K3 candplane differs from plain ({err_cand})"
    for name, a, b in zip(K3_OUTPUTS, got, ref):  # 0 / BIG / 0 / 0
        assert torch.equal(a[~valid], b[~valid]), \
            f"K3 {name} past cnt0 differs from plain"
    diff = (got[2].double() - ref[2].double()).abs()
    tol = npts[:, None].double() * 2.0 ** -20 + 1e-6 * ref[2].double().abs()
    err_col = float(diff[valid].max())
    assert bool((diff <= tol)[valid].all()), \
        f"K3 colplane beyond its tolerance (max err {err_col})"
    sel = dict(thresholds=codec.thr_dev, K=K,
               opt_metrics=("d1_mse", "d2_mse"), nrm=nrm)
    pk, ok = bsw.select_thresholds_d1_bucket(xh, pts, **sel)
    pp, op = bsw.select_thresholds_d1_bucket(
        xh, pts, colsums_d2_fn=bsw.bucket_colsums_d2_plain, **sel)
    assert torch.equal(pk, pp) and torch.equal(ok, op), "K3 picks differ"
    call = lambda: bsw.bucket_colsums_d2(*args)
    n_launches = cuda_launches(call, "bucket_d2")
    assert n_launches == K3_CUDA_LAUNCHES, n_launches
    ms = time_ms(call, reps=reps, burst=4)
    plain_ms = time_ms(lambda: bsw.bucket_colsums_d2_plain(*args),
                       reps=plain_reps)
    pairs = int((npts.to(torch.int64) * cnt0c.to(torch.int64)).sum())
    planes = int(cnt0c.sum()) + int(npts.sum())
    # points, normals, candidates and counts in; four [N, K] columns out
    # (colsum and candmin 8 bytes, colplane and candplane 4)
    nbytes = (pts.numel() + nrm.numel() + pos.numel() + 2 * len(npts)) * 4 \
        + pos.numel() * 24
    bound_ms, by = bound(nbytes, 0, K1_F32_OPS_PER_PAIR * pairs
                         + K3_F32_OPS_PER_PLANE * planes)
    log(f"K3 ok at K = {K}: {len(npts)} blocks, {pairs} point-candidate "
        f"pairs, d1 outputs equal K1's, candplane err 0, colplane max err "
        f"{err_col:.3g} (values up to {float(ref[2][valid].max()):.4g}), "
        f"columns past cnt0 equal, two launches bit-identical, "
        f"{n_launches} CUDA launches a call; {ms:.3f} ms (plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms by {by}: "
        f"{100 * bound_ms / ms:.1f}% reached)")
    return dict(max_abs_err=err_col, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, bound_share=bound_ms / ms,
                cuda_launches_a_call=n_launches)


def k3_edge_batch(n, P, K, seed):
    """Seeded K3 inputs at B = 64 with the edges in the first rows: (pts,
    nrm, pos, cnt0, npts) as CUDA tensors. cnt0 of rows 0-3 is K, 512, 37
    and K, row 4 has no points, row 5 no candidates; row 0 holds one point
    four times (rows 3, 35, 131, 700: other warps and CTAs, other
    normals) and, for it, candidates at d² 1 in three candidate tiles
    (k = 100, 700, 1300; plane² 1, 1, 0 with normal +x); row 1 has normal
    components ±MAX_NORMAL, row 2 normals of length MAX_NORMAL, row 6 a
    padding row inside its point count; the rest are unit normals."""
    import torch

    from pcc_geo_cnn_v2_tpu_torch.ops import bucket_sweep as bsw

    rng = np.random.default_rng(seed)
    npts = rng.integers(1, P + 1, n)
    cnt0 = rng.integers(1, K + 1, n)
    cnt0[:4] = (K, 512, 37, K)
    npts[0], npts[4], cnt0[5] = P, 0, 0
    pts = np.full((n, P, 3), -1, np.int32)
    nrm = rng.normal(size=(n, P, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    for i, m in enumerate(npts):
        pts[i, :m] = rng.integers(0, BLOCK, (m, 3))
    nrm[1] = rng.choice([-1.0, 1.0], (P, 3)) * bsw.MAX_NORMAL
    nrm[2] *= bsw.MAX_NORMAL
    pts[6, min(10, npts[6] - 1)] = -1
    pos = np.stack([rng.permutation(BLOCK ** 3)[:K] for _ in range(n)])
    p0 = np.array([30, 30, 30])
    near = np.abs(pts[0] - p0).max(-1) <= 2  # no other point near p0
    pts[0, near, 0] = rng.integers(40, BLOCK, int(near.sum()))
    pts[0, [3, 35, 131, 700]] = p0
    nrm[0, [3, 35, 131, 700]] = ((1, 0, 0), (0, 1, 0), (0, 0, 1),
                                 (0.6, 0.8, 0))
    flat = lambda c: (c[0] * BLOCK + c[1]) * BLOCK + c[2]
    for k, off in ((100, (1, 0, 0)), (700, (-1, 0, 0)), (1300, (0, 1, 0))):
        q = flat(p0 + off)
        j = np.nonzero(pos[0] == q)[0]  # keep the positions distinct
        if len(j):
            pos[0, j[0]] = pos[0, k]
        pos[0, k] = q
    return [torch.as_tensor(a, device="cuda") for a in (
        pts, nrm.astype(np.float32), pos.astype(np.int32),
        cnt0.astype(np.int32), npts.astype(np.int32))]


def check_k3_edges():
    """Phase 4, the edges on seeded random inputs (``k3_edge_batch``): K3
    equal to its plain version in every column (colsum, candmin, candplane
    bit for bit, colplane within ``npts · 2^-20 + 1e-6 · |value|``, as
    ``check_k3``), two launches bit-identical, N = 1 equal to its row of
    the batch, K and P not multiples of 32 or of a CTA's points."""
    import torch

    from pcc_geo_cnn_v2_tpu_torch.ops import bucket_sweep as bsw

    n, P, K = 32, 1000, 4003
    args = k3_edge_batch(n, P, K, 8)
    got = bsw.bucket_colsums_d2(*args, BLOCK)
    again = bsw.bucket_colsums_d2(*args, BLOCK)
    ref = bsw.bucket_colsums_d2_plain(*args, BLOCK)
    ones = {i: bsw.bucket_colsums_d2(*(a[i:i + 1] for a in args), BLOCK)
            for i in (0, 4, 5, 7)}
    torch.cuda.synchronize()
    for i in (0, 1, 3):
        err = float((got[i].double() - ref[i].double()).abs().max())
        assert err == 0, f"K3 edges: {K3_OUTPUTS[i]} differs ({err})"
    npts = args[4]
    err = (got[2].double() - ref[2].double()).abs()
    tol = npts[:, None].double() * 2.0 ** -20 + 1e-6 * ref[2].double().abs()
    assert bool((err <= tol).all()), \
        f"K3 edges: colplane beyond its tolerance ({float(err.max())})"
    assert all(torch.equal(a, b) for a, b in zip(got, again)), \
        "K3: two launches differ"
    for i, res in ones.items():
        assert all(torch.equal(a[0], b[i]) for a, b in zip(res, got)), \
            f"K3: N = 1 differs from row {i} of the batch"
    # the lowest of the four tied rows (normal +x) names candplane at
    # k = 100 (the earliest tied candidate's rule is held by colplane's
    # equality with the plain version); blocks without points
    assert float(got[3][0, 100]) == 1.0 and int(got[1][0, 100]) == 1
    assert (got[1][4, :int(args[3][4])] == bsw.BIG).all()
    assert (got[3][4, :int(args[3][4])] == float(bsw.BIG)).all()
    log(f"K3 edges ok (B = {BLOCK}, N = {n}, P = {P}, K = {K}; npts 0, "
        f"cnt0 0, 512, 37 and K, |n| components up to {bsw.MAX_NORMAL}, "
        f"one point on four rows across warps and CTAs, tied candidates "
        f"across tiles): equal to plain (colplane max err "
        f"{float(err.max()):.3g}), two launches bit-identical, N = 1 equal "
        f"to its row")


def sweep_kernel_ms(codec, pts, nrm, x_hat, K):
    """(K1 ms, K3 ms) of one launch each on these blocks at budget ``K``:
    the per-launch times that add up to a cloud's sweep."""
    from pcc_geo_cnn_v2_tpu_torch.ops import bucket_sweep as bsw

    pts, pos, _, cnt0c, npts, _ = sweep_args(codec, pts, x_hat, K)
    nrm = nrm.contiguous()
    return (time_ms(lambda: bsw.bucket_colsums(pts, pos, cnt0c, npts, BLOCK),
                    reps=3, burst=4),
            time_ms(lambda: bsw.bucket_colsums_d2(pts, nrm, pos, cnt0c, npts,
                                                  BLOCK), reps=3, burst=4))


def check_k5(codec, pts, x_hat):
    """Phase 5: K5 vs its plain version on one canonical chunk, and its
    picks vs the bucket backend's."""
    import torch

    from pcc_geo_cnn_v2_tpu_torch.ops import edt_sweep as es
    from pcc_geo_cnn_v2_tpu_torch.ops.edt import squared_edt
    from pcc_geo_cnn_v2_tpu_torch.ops.threshold_sweep import (
        select_thresholds_d1_pallas,
    )
    from pcc_geo_cnn_v2_tpu_torch.ops.voxel import voxelize

    xh = x_hat[..., 0].contiguous()
    thr = codec.thr_dev
    occ = voxelize(pts, BLOCK)[..., 0]
    dt = squared_edt(occ > 0)
    first_empty, t_small, _ = es.sweep_bounds(xh, thr, 256)
    t_end = torch.minimum(first_empty, t_small)
    t0 = time.time()
    ref = es.d1_sweep_sums_plain(xh, occ, dt, thr)  # an EDT per threshold
    torch.cuda.synchronize()
    plain_full_s = time.time() - t0
    main = es.d1_sweep_sums(xh, occ, thr, pts=pts)[:3]  # the path's call
    alone = es.edt_sweep_sums(xh, occ, dt, thr)  # every t in the kernel
    torch.cuda.synchronize()
    err = max(float((g - r).abs().max())
              for res in (main, alone) for g, r in zip(res, ref))
    assert err == 0, f"K5 disagrees with its plain version (max err {err})"
    # picks: the exact sweep against the bucket backend (K1, with its
    # rerun at K = B³ for overflowed rows)
    picks = select_thresholds_d1_pallas(occ, xh, thr, pts=pts)
    bucket = codec._sweep(x_hat, pts, occ, ("d1_mse",), (np.inf,))
    assert torch.equal(picks, bucket), "K5 picks differ from the bucket's"
    call = lambda: es.edt_sweep_sums(xh, occ, dt, thr, t_end)
    n_launches = cuda_launches(call, "edt_sweep")
    assert 0 < n_launches <= 3, n_launches
    ms = time_ms(call, reps=5, burst=4)
    plain_ms = time_ms(lambda: es.d1_sweep_sums_plain(xh, occ, dt, thr,
                                                      t_end), reps=1,
                       warm=False)
    n, T = xh.shape[0], thr.shape[0]
    tidx = torch.arange(T, device=xh.device)[None, :]
    ab_edt = torch.where(tidx < t_end[:, None], main[0], 0.0).double().sum()
    edts = int(t_end.sum())
    occ_edts = int(((occ > 0).flatten(1).sum(1) * t_end).sum())
    ops = lambda per_voxel_edt: BLOCK ** 3 * (
        K5_OPS_PER_VOXEL_ONCE * n + per_voxel_edt * edts) \
        + K5_OPS_PER_OCCUPIED_EDT * occ_edts + 2 * np.pi * float(ab_edt)
    # x_hat (f32), dt_orig (f32) and occ (uint8) in; three [N, T] out
    nbytes = n * BLOCK ** 3 * 9 + T * 4 + n * 4 + 3 * n * T * 4
    bound_ms, by = bound(nbytes, ops(0))
    bound_sets_ms = bound(nbytes, ops(K5_OPS_PER_VOXEL_EDT_SETS))[0]
    bound_cols_ms = bound(nbytes, ops(K5_OPS_PER_VOXEL_EDT_COLUMNS))[0]
    log(f"K5 ok: {n} blocks x {T} thresholds, first_empty "
        f"{int(first_empty.min())}..{int(first_empty.max())}, EDT on t < "
        f"{int(t_end.min())}..{int(t_end.max())} ({edts} (block, threshold) "
        f"EDTs, {int((occ > 0).sum())} occupied voxels), ab/ba/cnt equal "
        f"the plain version's for every t (with and without the sparse "
        f"split), picks equal the bucket backend's; {n_launches} CUDA "
        f"launches a call (the wrapper counts 1); {ms:.3f} ms (plain "
        f"{plain_ms:.3f} ms; plain with an EDT for every t "
        f"{plain_full_s * 1e3:.0f} ms; bound {bound_ms:.3f} ms by {by}: "
        f"{100 * bound_ms / ms:.1f}% reached; the bound of designs that "
        f"build each set {bound_sets_ms:.3f} ms, "
        f"{100 * bound_sets_ms / ms:.1f}%; the earlier count's "
        f"{bound_cols_ms:.3f} ms)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, bound_share=bound_ms / ms,
                cuda_launches_a_call=n_launches)


def k5_edge_batch(size, n, T, seed):
    """Seeded K5 inputs with the edges in the first rows: (x_hat, occ,
    thresholds, t_end). Row 0 has no candidates, row 1 no occupied voxel,
    row 2 t_end = 0, row 3 one candidate far from every point, row 4 is
    all occupied, row 5 holds a NaN, row 6 threshold values; the rest are
    random surfaces."""
    import torch

    rng = np.random.default_rng(seed)
    thr = np.linspace(0, 1.0, T).astype(np.float32)
    occ = (rng.random((n, size, size, size)) < 0.02).astype(np.float32)
    x_hat = np.where(rng.random(occ.shape) < 0.1, 0.5 * occ + 0.5 *
                     rng.random(occ.shape), 0.0).astype(np.float32)
    t_end = np.full(n, T, np.int32)
    x_hat[0] = 0.0
    occ[1] = 0.0
    t_end[2] = 0
    x_hat[3] = 0.0
    x_hat[3, 0, 0, 0] = 1.0
    occ[3] = 0.0
    occ[3, size // 2:, size // 2:, size // 2:] = \
        rng.random((size - size // 2,) * 3) < 0.05
    if n > 4:
        occ[4] = 1.0
    if n > 5:
        x_hat[5, 1, 2, 3] = np.nan
    if n > 6:
        x_hat[6].reshape(-1)[::97] = thr[rng.integers(0, T, x_hat[6].size
                                                      // 97 + 1)]
    return [torch.as_tensor(a, device="cuda")
            for a in (x_hat, occ, thr, t_end)]


def check_k5_edges():
    """Phase 5, the edges on seeded random inputs (``k5_edge_batch``) at B =
    64 and at B = 90 (two 64-bit words a bit row): K5 equal to its plain
    version, two launches bit-identical, N = 1 equal to its row of the
    batch, and a constant number of CUDA launches a call whatever T."""
    import torch

    from pcc_geo_cnn_v2_tpu_torch.ops import edt_sweep as es
    from pcc_geo_cnn_v2_tpu_torch.ops.edt import squared_edt

    launches = {}
    for size, n, T in ((BLOCK, 8, 32), (90, 4, 16)):
        x_hat, occ, thr, t_end = k5_edge_batch(size, n, T, size)
        dt = squared_edt(occ > 0)
        got = es.edt_sweep_sums(x_hat, occ, dt, thr, t_end)
        again = es.edt_sweep_sums(x_hat, occ, dt, thr, t_end)
        ones = {i: es.edt_sweep_sums(x_hat[i:i + 1], occ[i:i + 1],
                                     dt[i:i + 1], thr, t_end[i:i + 1])
                for i in (3, n - 1)}
        ref = es.d1_sweep_sums_plain(x_hat, occ, dt, thr, t_end)
        torch.cuda.synchronize()
        for name, g, r in zip(("ab", "ba", "cnt"), got, ref):
            err = float((g - r).abs().max())
            assert err == 0, f"K5 edges B = {size}: {name} differs ({err})"
        assert all(torch.equal(a, b) for a, b in zip(got, again)), \
            "K5: two launches differ"
        for i, res in ones.items():
            assert all(torch.equal(a[0], b[i]) for a, b in zip(res, got)), \
                f"K5: N = 1 differs from row {i} of the batch"
        ab, ba, cnt = got
        assert (cnt[0] == 0).all() and (n < 6 or (cnt[5] == 0).all())
        assert (ab[1][cnt[1] > 0] == 0).all() and (ba[1] > 0).any()
        assert (ab[2] >= 1e12).all() and (cnt[3, :-1] == 1).all()
        assert (ab[3, :-1] > 3 * (size // 2 - 1) ** 2).all()
        launches[T] = cuda_launches(
            lambda: es.edt_sweep_sums(x_hat, occ, dt, thr, t_end),
            "edt_sweep")
    assert len(set(launches.values())) == 1 and launches[32] <= 3, launches
    log(f"K5 edges ok (B = 64, N = 8, T = 32; B = 90, N = 4, T = 16: no "
        f"candidates, no points, t_end = 0, one far candidate, all "
        f"occupied, a NaN, threshold values): equal to plain, two launches "
        f"bit-identical, N = 1 equal to its row; CUDA launches a call by T: "
        f"{launches}")


def bf16_steps(got, want):
    """Elementwise distance in bf16 steps: the spacing of bf16 numbers at
    the larger of the two values, or at 1/16 of the tensor's largest value
    for smaller elements (sums that cancel: their error is set by the size
    of the terms)."""
    import torch

    got, want = got.double(), want.double()
    mag = torch.maximum(torch.maximum(got.abs(), want.abs()),
                        want.abs().max() / 16)
    return (got - want).abs() / 2.0 ** (torch.floor(torch.log2(mag)) - 7)


def record_tail_inputs(codec, pts, n_valid):
    """One canonical chunk through ``codec`` (fused-conv backend): the
    arguments of every residual tail on the way, in order (three analysis
    stages, three synthesis stages)."""
    from pcc_geo_cnn_v2_tpu_torch.ops import fused_conv as fc

    calls, tail = [], fc._tail
    fc._tail = lambda *a: (calls.append(a), tail(*a))[1]
    try:
        res = codec.encode_chunk(pts, n_valid)
    finally:
        fc._tail = tail
    return calls, res


def check_k4(args, against=None):
    """Phase 9, one stage: K4a or K4b (by the codec's dispatch rule) vs
    its plain version on the tail's real inputs ``args`` (those of
    ``fused_conv._tail``); ``against`` names the other kernel's wrapper to
    be equalled bit for bit."""
    import torch
    import torch.nn.functional as F

    from pcc_geo_cnn_v2_tpu_torch.codec import deterministic_convs
    from pcc_geo_cnn_v2_tpu_torch.ops import fused_conv as fc

    x, w1, b1, w2, b2, S, C, dtype = args
    x = x.contiguous()
    n = x.shape[0]
    slab = S ** 3 * C // fc.LANES > fc.MAX_FUSED_ROWS
    name = "fused_tail_slab" if slab else "fused_tail"
    kw = dict(spatial=S, channels=C, dtype=dtype)
    fn, plain = ((fc.fused_residual_tail_slab,
                  fc.fused_residual_tail_slab_plain) if slab else
                 (fc.fused_residual_tail, fc.fused_residual_tail_plain))
    got = fn(x, w1, b1, w2, b2, **kw)
    again = fn(x, w1, b1, w2, b2, **kw)
    one = fn(x[:1], w1, b1, w2, b2, **kw)
    ref = plain(x, w1, b1, w2, b2, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, again), f"{name}: two launches differ"
    assert torch.equal(one, got[:1]), f"{name}: N = 1 differs from row 0"
    if against is not None:
        assert torch.equal(against(x, w1, b1, w2, b2, **kw), got), \
            f"{name} differs from the other kernel (slab seams)"
    err = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    equal = float((got == ref).float().mean())
    if dtype == torch.float32:
        assert err <= 1e-4 * scale, \
            f"{name} {S}^3x{C} f32: max err {err} of {scale}"
        steps = None
    else:
        steps = float(bf16_steps(got, ref).max())
        assert steps <= 2.0 and equal >= 0.99, \
            f"{name} {S}^3x{C} bf16: {steps} steps, {equal} equal"
    ms = time_ms(lambda: fn(x, w1, b1, w2, b2, **kw), reps=5, burst=4)
    plain_ms = time_ms(lambda: plain(x, w1, b1, w2, b2, **kw), reps=2)

    # the cuDNN chain on the same tensors, in the layout given
    # (channels-last) and in the modules' own (NCDHW)
    deterministic_convs()
    wk = [w.reshape(3, 3, 3, C, C).permute(4, 3, 0, 1, 2).contiguous()
          for w in (w1, w2)]
    bk = [b.to(dtype) for b in (b1, b2)]

    def chain(v):
        t = F.relu(F.conv3d(v, wk[0], bk[0], padding=1))
        return v + F.relu(F.conv3d(t, wk[1], bk[1], padding=1))

    x_last = x.permute(0, 4, 1, 2, 3)
    x_first = x_last.contiguous()
    lib = chain(x_last).permute(0, 2, 3, 4, 1)
    torch.cuda.synchronize()
    lib_err = float((lib.float() - ref.float()).abs().max())
    lib_last = time_ms(lambda: chain(x_last), reps=3, burst=4)
    lib_first = time_ms(lambda: chain(x_first), reps=3, burst=4)

    flop = 2 * 2 * 27 * C * C * S ** 3 * n
    nbytes = (2 * x.numel() + w1.numel() + w2.numel()) * x.element_size()
    t_ops = flop / (PEAK_F32_OPS_S if dtype == torch.float32
                    else PEAK_BF16_OPS_S)
    t_bytes = nbytes / PEAK_BYTES_S
    tag = "f32" if dtype == torch.float32 else "bf16"
    bound_ms, library_ms = max(t_ops, t_bytes) * 1e3, min(lib_last, lib_first)
    row = dict(shape=f"{n}x{S}^3x{C}", dtype=tag, max_abs_err=err,
               ref_max=scale, equal_share=equal, bf16_steps=steps, ms=ms,
               plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               bound_share=bound_ms / ms, library_ms=library_ms,
               ms_over_library=ms / library_ms,
               library_channels_last_ms=lib_last,
               library_ncdhw_ms=lib_first, gflop=flop / 1e9)
    log(f"{'K4b' if slab else 'K4a'} ok at {row['shape']} {tag}: max err "
        f"{err:.3g} of {scale:.4g}"
        + (f" ({steps:.2f} bf16 steps)" if steps is not None else "")
        + f", {100 * equal:.3f}% equal, launches bit-identical, N = 1 "
        f"equal; {ms:.3f} ms = {flop / ms / 1e9:.2f} TFLOP/s (plain "
        f"{plain_ms:.3f} ms, bound {row['bound_ms']:.3f} ms by "
        f"{row['bound_by']}: {100 * row['bound_share']:.1f}% reached; "
        f"{row['ms_over_library']:.2f}x the cuDNN chain {lib_last:.3f} ms "
        f"channels-last / "
        f"{lib_first:.3f} ms NCDHW, its max err {lib_err:.3g})")
    return name, row


def check_k4_other_shapes():
    """Phase 9, the stage shapes c3p does not reach: c3's 8³×32 tail (K4a),
    the 32³×64 and 64³×32 volumes the dispatch rule sends to K4b, and a
    12³ volume that no tile divides (ragged H and W tiles; K4b with
    ``slab=4``), on seeded random inputs at N = 2, and one N = 1 case per
    kernel (K4a 16³×64: the plan cuts the depth into ranges to fill the
    card; K4b 64³×16), f32 and bf16, against the plain versions."""
    import torch

    from pcc_geo_cnn_v2_tpu_torch.ops import fused_conv as fc

    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, scale=1.0):
        return scale * torch.randn(*shape, device="cuda", generator=gen)

    done = []
    for S, C, slab, n in ((8, 32, None, 2), (12, 16, None, 2),
                          (12, 16, 4, 2), (32, 64, 8, 2), (64, 32, 8, 2),
                          (16, 64, None, 1), (64, 16, 8, 1)):
        x = rand(n, S, S, S, C, scale=0.5)
        w1, w2 = (rand(27, C, C, scale=0.5 / (27 * C) ** 0.5)
                  for _ in range(2))
        b1, b2 = rand(C, scale=0.3), rand(C, scale=0.3)
        for dtype in (torch.float32, torch.bfloat16):
            kw = dict(spatial=S, channels=C, dtype=dtype)
            if slab is None:
                got = fc.fused_residual_tail(x, w1, b1, w2, b2, **kw)
            else:
                got = fc.fused_residual_tail_slab(x, w1, b1, w2, b2,
                                                  slab=slab, **kw)
            ref = fc.fused_residual_tail_plain(x, w1, b1, w2, b2, **kw)
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            scale = float(ref.float().abs().max())
            if dtype == torch.float32:
                assert err <= 1e-4 * scale, (S, C, slab, err, scale)
            else:
                assert float(bf16_steps(got, ref).max()) <= 2.0, (S, C, slab)
        done.append(f"{n}x{S}^3x{C}" + (f" slab {slab}" if slab else ""))
    log("K4 ok at the other stage shapes and at N = 1 (f32 and bf16, "
        "against the whole-volume plain version): " + ", ".join(done))


def host_d1_psnr(points, decoded, r):
    """Reference D1 PSNR with host KD-trees (both directions)."""
    from scipy.spatial import cKDTree

    a, b = points[:, :3].astype(np.float64), decoded.astype(np.float64)
    d_ab = cKDTree(b).query(a, workers=-1)[0] ** 2
    d_ba = cKDTree(a).query(b, workers=-1)[0] ** 2
    mse = max(d_ab.mean(), d_ba.mean())
    return 10 * np.log10(3.0 * r * r / mse)


def check_d2_identities(codec, blocks, binstr, points6, dec_blocks, decoded,
                        enc):
    """Path A's D2 metric, point by point: recompute the neighbour
    identities the encoder's metric takes (same function, same inputs),
    require each to be a point of the other cloud at the KD-tree's nearest
    distance, and require the host oracle's formulas over exactly those
    neighbours to give the encoder's metric dict ``enc``. Returns the
    share of decoded points at distance > 0 whose nearest original is
    tied."""
    import torch
    from scipy.spatial import cKDTree

    from pcc_geo_cnn_v2_tpu_torch.ops import cloud_metrics as cm
    from pcc_geo_cnn_v2_tpu_torch.ops.voxel import (
        pack_attrs,
        packbits,
        voxelize,
    )
    from pcc_geo_cnn_v2_tpu_torch.utils.metrics import (
        metrics_from_nn,
        nn_maps_from_identities,
    )
    from pcc_geo_cnn_v2_tpu_torch.utils.octree import block_origins

    def budget(bl):
        return max(int(2 ** np.ceil(np.log2(max(len(b) for b in bl)))), 64)

    n, dev = len(blocks), codec.device
    origins = np.stack(block_origins(binstr, [0, 0, 0], [RESOLUTION] * 3,
                                     LEVEL))
    a_pts = torch.as_tensor(cm.pack_point_lists(blocks, budget(blocks)),
                            device=dev)
    b_pts = torch.as_tensor(
        cm.pack_point_lists(dec_blocks, budget(dec_blocks)), device=dev)
    b_packed = packbits((voxelize(b_pts, BLOCK)[..., 0] > 0).reshape(n, -1))
    ident = cm.blockwise_nn_identities(
        a_pts, pack_attrs(blocks, [3, 4, 5], budget(blocks)), b_packed,
        dec_blocks, origins, BLOCK, points6, halo=codec.halo_width,
        batch=codec.halo_batch)
    a_glob, _, a_tgt, b_glob, b_tgt = ident
    pts = points6[:, :3]
    idx1, idx2 = nn_maps_from_identities(pts, decoded, a_glob, a_tgt, b_glob,
                                         b_tgt)
    d_ab = cKDTree(decoded).query(pts, workers=-1)[0]
    d_ba = cKDTree(pts).query(decoded, k=2, workers=-1)[0]
    assert np.array_equal(((pts - decoded[idx2]) ** 2).sum(1),
                          np.rint(d_ab ** 2)), \
        "an original's neighbour is not a nearest decoded point"
    assert np.array_equal(((decoded - pts[idx1]) ** 2).sum(1),
                          np.rint(d_ba[:, 0] ** 2)), \
        "a decoded point's neighbour is not a nearest original"
    # the encoder's AB normals ride as f32
    same = metrics_from_nn(pts, decoded, RESOLUTION - 1, idx1, idx2,
                           p1_n=points6[:, 3:6].astype(np.float32))
    for key, want in same.items():
        assert np.isclose(enc[key], want, rtol=1e-6, atol=0), \
            (key, enc[key], want)
    far = d_ba[:, 0] > 0
    return float((far & (d_ba[:, 0] == d_ba[:, 1])).sum() / max(far.sum(), 1))


def cut_cloud(blocks, binstr, n):
    """The first ``n`` blocks of a partition as a cloud of their own (global
    coordinates, attribute columns kept), partitioned again: (points,
    blocks, binstr); the blocks equal the first ``n``."""
    from pcc_geo_cnn_v2_tpu_torch.utils.octree import (
        block_origins,
        partition_octree,
    )

    origins = block_origins(binstr, [0, 0, 0], [RESOLUTION] * 3, LEVEL)[:n]
    pts = np.vstack([np.hstack([b[:, :3] + o, b[:, 3:]])
                     for b, o in zip(blocks[:n], origins)])
    cut_blocks, cut_binstr = partition_octree(pts, [0, 0, 0],
                                              [RESOLUTION] * 3, LEVEL)
    assert len(cut_blocks) == n and all(
        np.array_equal(a, b) for a, b in zip(cut_blocks, blocks[:n]))
    return pts, cut_blocks, cut_binstr


def k9_layer_ms(codec, pts):
    """Device ms of a V1-transform model's two k9 layers on one canonical
    chunk, CUDA events under ``deterministic_convs``: (analysis Conv_0,
    1 → F at 64³ → 32³; synthesis ConvTranspose_2, F → 1 at 32³ → 64³;
    the chunk's whole decode)."""
    import torch
    import torch.nn.functional as F

    from pcc_geo_cnn_v2_tpu_torch.codec import deterministic_convs
    from pcc_geo_cnn_v2_tpu_torch.ops.voxel import voxelize

    m = codec.model
    deterministic_convs()
    with torch.no_grad():
        x = voxelize(pts, BLOCK)
        y_sym = m.encode_syms(x)["y_sym"]
        prior = m.conditional if codec.is_v2 else m.entropy_bottleneck
        syn = m.synthesis_t
        h = prior.dequantize_symbols(y_sym).permute(0, 4, 1, 2, 3)
        h = F.relu(syn.ConvTranspose_1(F.relu(syn.ConvTranspose_0(
            h.contiguous()))))
        xc = x.permute(0, 4, 1, 2, 3).contiguous()
        return (time_ms(lambda: m.analysis_t.Conv_0(xc), 5),
                time_ms(lambda: syn.ConvTranspose_2(h), 5),
                time_ms(lambda: codec._decode_y(y_sym), 3))


def host_d1_mse(block, x_hat, t):
    """Host KD-tree d1_mse of one block's candidate ``x_hat > t`` (the
    host sweep's own comparison)."""
    from pcc_geo_cnn_v2_tpu_torch.utils.metrics import compute_metrics

    cand = np.argwhere(x_hat > t).astype(np.float64)
    return compute_metrics(block[:, :3], cand, RESOLUTION - 1)["d1_mse"]


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    return run("cuda")


def run(device):
    import torch

    from pcc_geo_cnn_v2_tpu_torch.codec import BlockCodec
    from pcc_geo_cnn_v2_tpu_torch.coding.syntax import (
        load_compressed_file,
        save_compressed_file,
    )
    from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
    from pcc_geo_cnn_v2_tpu_torch.native import load_host_lib
    from pcc_geo_cnn_v2_tpu_torch.ops import kernels
    from pcc_geo_cnn_v2_tpu_torch.ops.voxel import flatten_blocks, pack_coords
    from pcc_geo_cnn_v2_tpu_torch.utils.metrics import compute_metrics
    from pcc_geo_cnn_v2_tpu_torch.utils.octree import (
        block_origins,
        departition_octree,
        partition_octree,
    )
    from pcc_geo_cnn_v2_tpu_torch.utils.scansim import figure_cloud
    from pcc_geo_cnn_v2_tpu_torch.weights import load_asset_tree

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    secs, logs = kernels.build_all(force=True)
    log(f"kernels built in {secs:.1f} s")
    t0 = time.time()
    for name in ("range_coder", "voxel_bits"):  # host C++, built by g++
        load_host_lib(name)
    log(f"host libraries built in {time.time() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    t0 = time.time()
    points, normals = figure_cloud(CLOUD_SEED, RESOLUTION, with_normals=True)
    points6 = np.hstack([points, normals])
    blocks, binstr = partition_octree(points6, [0, 0, 0], [RESOLUTION] * 3,
                                      LEVEL)
    log(f"cloud: {len(points)} points with normals -> {len(blocks)} blocks "
        f"of {BLOCK}^3 ({time.time() - t0:.1f} s)")
    params = load_asset_tree(ASSET)
    codec = BlockCodec(build_model("c3p"), params, block_size=BLOCK,
                       batch_blocks=BATCH, device=device)

    fused = dict(block_size=BLOCK, batch_blocks=BATCH, device=device)
    codec_c = BlockCodec(build_model("c3p", conv_backend="pallas"), params,
                         **fused)
    codec_cb = BlockCodec(build_model("c3p", dtype=torch.bfloat16,
                                      conv_backend="pallas"), params, **fused)

    # phases 2-5 inputs: the canonical chunks of the paths below
    budget = max(int(2 ** np.ceil(np.log2(max(len(b) for b in blocks)))),
                 64)
    flat, offsets = flatten_blocks(blocks)
    flat_dev = torch.as_tensor(pack_coords(flat, BLOCK), device=device)
    nrm_dev = torch.as_tensor(flatten_blocks(
        blocks, cols=(3, 4, 5), dtype=np.float32)[0], device=device)
    occ, mask, over_pts, over_nrm, over_xh = [], [], [], [], []
    share = {"chunks": np.zeros(2), "reruns": np.zeros(2), "n_reruns": 0}
    sym_equal = {"y_sym": [0, 0], "z_sym": [0, 0]}
    for lo in range(0, len(blocks), BATCH):
        hi = min(lo + BATCH, len(blocks))
        pts = codec.chunk_points(flat_dev, offsets, lo, hi, budget)
        nrm = codec.chunk_normals(nrm_dev, offsets, lo, hi, budget)
        res = codec.encode_chunk(pts, hi - lo)
        occ.append(res["occ"][:hi - lo])
        mask.append(res["masks"][0][:hi - lo])
        # the fused-conv backend's symbols on the same chunk
        if lo == 0:
            tails, res_c = record_tail_inputs(codec_c, pts, hi - lo)
            tails_bf16 = record_tail_inputs(codec_cb, pts, hi - lo)[0]
        else:
            res_c = codec_c.encode_chunk(pts, hi - lo)
        for key, cnt in sym_equal.items():
            cnt[0] += int((res[key][:hi - lo] == res_c[key][:hi - lo]).sum())
            cnt[1] += res[key][:hi - lo].numel()
        if lo == 0:
            k1 = check_k1(codec, pts, res["x_hat"], codec.bucket_k)
            check_k1_edges()
            k3 = check_k3(codec, pts, nrm, res["x_hat"], codec.bucket_k)
            check_k3_edges()
            k5 = check_k5(codec, pts, res["x_hat"])
            check_k5_edges()
        # the rows the codec re-sweeps at K = B³
        cnt0 = (res["x_hat"][:hi - lo].reshape(hi - lo, -1)
                > codec.thr_dev[0]).sum(-1)
        rows = torch.nonzero(cnt0 > codec.bucket_k).flatten()
        # this chunk's launch and its rerun's, as the codec batches them
        share["chunks"] += np.array(sweep_kernel_ms(
            codec, pts, nrm, res["x_hat"], codec.bucket_k))
        if len(rows):
            share["reruns"] += np.array(sweep_kernel_ms(
                codec, pts[rows], nrm[rows], res["x_hat"][rows], BLOCK ** 3))
            share["n_reruns"] += 1
        over_pts.append(pts[rows])
        over_nrm.append(nrm[rows])
        over_xh.append(res["x_hat"][rows])
    over_pts, over_nrm, over_xh = (torch.cat(a).contiguous() for a in
                                   (over_pts, over_nrm, over_xh))
    assert len(over_pts), "no block overflows: the rerun is not exercised"
    k1["rerun"] = check_k1(codec, over_pts, over_xh, BLOCK ** 3, reps=3,
                           plain_reps=1)
    k3["rerun"] = check_k3(codec, over_pts, over_nrm, over_xh, BLOCK ** 3,
                           reps=3, plain_reps=1)
    for k in (k1, k3):
        k["max_abs_err"] = max(k["max_abs_err"], k["rerun"]["max_abs_err"])
    for i, (name, k) in enumerate((("K1", k1), ("K3", k3))):
        chunks, reruns = share["chunks"][i], share["reruns"][i]
        k["cloud_ms"] = {"chunks": float(chunks), "reruns": float(reruns)}
        log(f"{name} over the whole cloud: {-(-len(blocks) // BATCH)} "
            f"chunk launches {chunks:.3f} ms + {share['n_reruns']} rerun "
            f"launches at K = B³ {reruns:.3f} ms: the reruns are "
            f"{100 * reruns / (chunks + reruns):.1f}% of the kernel's time")
    origins = np.stack(block_origins(binstr, [0, 0, 0], [RESOLUTION] * 3,
                                     LEVEL))
    k2 = check_k2(torch.cat(occ), torch.cat(mask), origins)
    check_k2_edges()

    def container(payload, binstr_=binstr):
        # mtime fixed: equal payloads must give equal bytes
        return gzip.compress(save_compressed_file(binstr_, payload,
                                                  RESOLUTION, LEVEL), mtime=0)

    def decode(dec_codec, blob):
        res_, lvl_, binstr2, payload = load_compressed_file(
            io.BytesIO(gzip.decompress(blob)))
        dec = dec_codec.decompress_blocks(payload)
        return np.vstack(departition_octree(dec, binstr2, [0, 0, 0],
                                            [res_] * 3, lvl_))

    def drive(enc_codec, method="compress_blocks_device_opt", cloud=None,
              **kw):
        """One counted path: encode (``method``, of the flagship cloud or of
        ``cloud`` = (blocks, binstr, points)) → containers → decode of
        each; every decode must equal the encoder's embedded
        reconstruction. The counts after the encode half stay in
        ``drive.encode_counts``, the picks in ``drive.picks`` (per group,
        per block)."""
        blocks_, binstr_, points_ = cloud or (blocks, binstr, points6)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.time()
        data_list, metadata = getattr(enc_codec, method)(
            blocks_, binstr_, points_, RESOLUTION, LEVEL, **kw)
        blobs = [container(payload, binstr_) for payload in data_list]
        torch.cuda.synchronize()
        t_enc = time.time() - t0
        drive.encode_counts = dict(kernels.launches)
        t0 = time.time()
        decoded = [decode(enc_codec, blob) for blob in blobs]
        torch.cuda.synchronize()
        t_dec = time.time() - t0
        counts = dict(kernels.launches)
        drive.picks = [[t for _, t in payload] for payload in data_list]
        for dec_full, meta in zip(decoded, metadata):
            enc_full = meta["blocks_full"]
            assert dec_full.shape == enc_full.shape and np.array_equal(
                dec_full, enc_full), "decoded blocks differ from the encoder's"
        return blobs, metadata, decoded, counts, t_enc, t_dec

    def expect_launches(path, counts, ran, idle):
        for name in ran:
            assert counts[name] > 0, f"{name} did not launch on {path}"
        for name in idle:
            assert counts[name] == 0, f"{name} launched on {path}"

    # phase 6: the d1 path, counted
    blobs, metadata, decoded, counts_d1, t_enc, t_dec = drive(codec)
    blob_d1 = blobs[0]
    bpp = len(blob_d1) * 8 / len(points)
    psnr = metadata[0]["metrics"]["d1_psnr"]
    psnr_host = host_d1_psnr(points, decoded[0], RESOLUTION - 1)
    assert np.isfinite(psnr) and 0 < bpp < 8, (psnr, bpp)
    assert abs(psnr - psnr_host) < 1e-6, (psnr, psnr_host)
    log(f"d1 path: {len(blocks)} blocks, {len(decoded[0])} decoded points, "
        f"bit-exact; {bpp:.4f} bpp, D1 PSNR {psnr:.4f} dB (host KD-tree "
        f"{psnr_host:.4f}); encode {len(blocks) / t_enc:.2f} blocks/s "
        f"({t_enc:.2f} s), decode {len(blocks) / t_dec:.2f} blocks/s "
        f"({t_dec:.2f} s); launches {counts_d1}")
    expect_launches("the d1 path", counts_d1,
                    ("bucket_colsums", "halo_edt"),
                    ("bucket_colsums_d2", "edt_sweep"))

    # phase 7: path A, D2 encode with normals on K3
    blobs, metadata, decoded, counts_a, t_enc, t_dec = drive(
        codec, opt_metrics=("d1_mse", "d2_mse"), with_normals=True)
    assert len(blobs) == 2 and [m["idx"] for m in metadata] == [0, 1]
    assert blobs[0] == blob_d1, "path A's d1 stream differs from the d1 path's"
    d2 = metadata[1]["metrics"]
    t0 = time.time()
    host = compute_metrics(points, decoded[1], RESOLUTION - 1, p1_n=normals)
    t_host = time.time() - t0
    assert np.isfinite(d2["d2_psnr"]), d2
    tied_share = check_d2_identities(codec, blocks, binstr, points6,
                                     metadata[1]["x_hat_list"], decoded[1],
                                     d2)
    # equal d1 sums, and the tie effect framed
    for key in ("d1_sum_AB", "d1_sum_BA"):
        assert d2[key] == host[key], (key, d2[key], host[key])
    assert abs(d2["d2_psnr"] - host["d2_psnr"]) < D2_PSNR_TOL_DB, \
        (d2["d2_psnr"], host["d2_psnr"])
    log(f"path A (d1_mse + d2_mse with normals): two streams, both "
        f"bit-exact, d1 stream equals the d1 path's; d2 stream "
        f"{len(blobs[1]) * 8 / len(points):.4f} bpp, {len(decoded[1])} "
        f"decoded points, D2 PSNR {d2['d2_psnr']:.4f} dB: every neighbour "
        f"of the {len(points)} + {len(decoded[1])} points is a true "
        f"nearest one and the host oracle's formulas over them give the "
        f"encoder's sums (AB {d2['d2_sum_AB']:.1f}, BA "
        f"{d2['d2_sum_BA']:.1f}); the oracle over its KD-tree neighbours "
        f"{host['d2_psnr']:.4f} dB (BA {host['d2_sum_BA']:.1f}, "
        f"{t_host:.1f} s; {100 * tied_share:.1f}% of decoded points at "
        f"distance > 0 tied); "
        f"D1 PSNR {d2['d1_psnr']:.4f} dB; encode "
        f"{len(blocks) / t_enc:.2f} blocks/s ({t_enc:.2f} s), decode of "
        f"both {t_dec:.2f} s; launches "
        f"{counts_a}")
    expect_launches("path A", counts_a, ("bucket_colsums_d2", "halo_edt"),
                    ("bucket_colsums", "edt_sweep"))

    # phase 8: path B, the exact-EDT sweep backend on K5
    codec_b = BlockCodec(build_model("c3p"), params, block_size=BLOCK,
                         batch_blocks=BATCH, device=device,
                         sweep_backend="pallas")
    blobs, metadata, decoded, counts_b, t_enc, t_dec = drive(codec_b)
    assert blobs[0] == blob_d1, "path B's stream differs from the d1 path's"
    log(f"path B (sweep_backend='pallas', all {len(blocks)} blocks): "
        f"bit-exact, stream bytes equal the bucket backend's; encode "
        f"{len(blocks) / t_enc:.2f} blocks/s ({t_enc:.2f} s), decode "
        f"{len(blocks) / t_dec:.2f} blocks/s ({t_dec:.2f} s); launches "
        f"{counts_b}")
    expect_launches("path B", counts_b, ("edt_sweep", "halo_edt"),
                    ("bucket_colsums", "bucket_colsums_d2"))

    # phase 9: K4a / K4b against their plain versions, stage by stage
    from pcc_geo_cnn_v2_tpu_torch.ops import fused_conv as fc

    k4 = {"fused_tail": [], "fused_tail_slab": []}
    for stage_args in tails + tails_bf16:
        name, row = check_k4(stage_args)
        k4[name].append(row)
    assert [len(v) for v in k4.values()] == [10, 2], k4.keys()
    # slab seams: K4b at a size K4a takes too (32^3 x 16, four slabs)
    seam = next(a for a in tails if (a[5], a[6]) == (32, 16))
    check_k4(seam, against=fc.fused_residual_tail_slab)
    log("K4b equals K4a bit for bit at 32x32^3x16 (slab = 8: three seams)")
    check_k4_other_shapes()
    del tails, tails_bf16, seam

    # phase 10: path C, the fused-conv backend, f32
    n_chunks = -(-len(blocks) // BATCH)
    # per chunk: (encode, decode) launches — three analysis and two
    # synthesis tails on K4a, the 64^3 x 16 synthesis tail on K4b
    k4_launches = {"fused_tail": (5, 2), "fused_tail_slab": (1, 1)}

    def expect_k4_launches(path, counts):
        for name, (enc, dec) in k4_launches.items():
            got = (drive.encode_counts[name],
                   counts[name] - drive.encode_counts[name])
            assert got == (enc * n_chunks, dec * n_chunks), (path, name, got)

    def drive_c(enc_codec, label):
        blobs, metadata, decoded, counts, t_enc, t_dec = drive(enc_codec)
        bpp_c = len(blobs[0]) * 8 / len(points)
        psnr_c = metadata[0]["metrics"]["d1_psnr"]
        host_c = host_d1_psnr(points, decoded[0], RESOLUTION - 1)
        assert np.isfinite(psnr_c) and 0 < bpp_c < 8, (psnr_c, bpp_c)
        assert abs(psnr_c - host_c) < 1e-6, (psnr_c, host_c)
        log(f"{label}: {len(blocks)} blocks, {len(decoded[0])} decoded "
            f"points, bit-exact; {bpp_c:.4f} bpp, D1 PSNR {psnr_c:.4f} dB "
            f"(host KD-tree {host_c:.4f}); encode "
            f"{len(blocks) / t_enc:.2f} blocks/s ({t_enc:.2f} s), decode "
            f"{len(blocks) / t_dec:.2f} blocks/s ({t_dec:.2f} s); launches "
            f"{counts}")
        return bpp_c, psnr_c, counts

    shares = {k: a / b for k, (a, b) in sym_equal.items()}
    bpp_c, psnr_c, counts_c = drive_c(
        codec_c, "path C (conv_backend='pallas', f32)")
    log(f"path C symbols equal to the cuDNN backend's: y "
        f"{100 * shares['y_sym']:.4f}%, z {100 * shares['z_sym']:.4f}%; "
        f"bpp {bpp_c / bpp - 1:+.4%}, PSNR {psnr_c - psnr:+.4f} dB against "
        f"the d1 path")
    assert min(shares.values()) >= 0.999, shares
    assert abs(bpp_c - bpp) <= 0.01 * bpp and abs(psnr_c - psnr) <= 0.05
    expect_launches("path C", counts_c,
                    ("fused_tail", "fused_tail_slab", "bucket_colsums",
                     "halo_edt"), ("bucket_colsums_d2", "edt_sweep"))
    expect_k4_launches("path C", counts_c)
    assert all(counts_c[k] == counts_d1[k]
               for k in ("bucket_colsums", "halo_edt")), (counts_c, counts_d1)

    # phase 11: path C in bf16, and the cuDNN backend in bf16 beside it
    bpp_cb, psnr_cb, counts_cb = drive_c(
        codec_cb, "path C (conv_backend='pallas', bf16)")
    expect_k4_launches("path C in bf16", counts_cb)
    assert abs(bpp_cb - bpp_c) <= 0.05 * bpp_c and \
        abs(psnr_cb - psnr_c) <= 0.5, (bpp_cb, psnr_cb)
    bpp_xb, psnr_xb, counts_xb = drive_c(
        BlockCodec(build_model("c3p", dtype=torch.bfloat16), params, **fused),
        "cuDNN backend in bf16 (conv_backend='xla')")
    assert counts_xb["fused_tail"] == counts_xb["fused_tail_slab"] == 0
    log(f"bf16: path C {bpp_cb:.4f} bpp / {psnr_cb:.4f} dB; cuDNN backend "
        f"{bpp_xb:.4f} bpp / {psnr_xb:.4f} dB; f32 path C {bpp_c:.4f} bpp / "
        f"{psnr_c:.4f} dB")

    # phase 12: c2, then c1 — V1 transforms at full width, the d1 path
    sweep_names = ("bucket_colsums", "halo_edt", "bucket_colsums_d2",
                   "edt_sweep")
    k4_names = tuple(k4_launches)
    pts0 = codec.chunk_points(flat_dev, offsets, 0, BATCH, budget)
    counts_v1 = {}
    for cfg in ("c2", "c1"):
        t_phase = time.time()
        codec_v = BlockCodec(build_model(cfg), load_asset_tree(
            RD_ASSETS / cfg / f"{V1_LAMBDA}.msgpack.gz"), block_size=BLOCK,
            batch_blocks=BATCH, device=device)
        assert codec_v.is_v2 == (cfg == "c2")
        blobs, metadata, decoded, counts_v1[cfg], t_enc, t_dec = drive(
            codec_v)
        bpp_v = len(blobs[0]) * 8 / len(points)
        psnr_v = metadata[0]["metrics"]["d1_psnr"]
        host_v = host_d1_psnr(points, decoded[0], RESOLUTION - 1)
        assert np.isfinite(psnr_v) and 0 < bpp_v < 8, (psnr_v, bpp_v)
        assert abs(psnr_v - host_v) < 1e-6, (psnr_v, host_v)
        expect_launches(cfg, counts_v1[cfg], ("bucket_colsums", "halo_edt"),
                        ("bucket_colsums_d2", "edt_sweep") + k4_names)
        ms_a, ms_s, ms_dec = k9_layer_ms(codec_v, pts0)
        log(f"{cfg} ({'v2' if codec_v.is_v2 else 'v1'}, V1 transforms, "
            f"{codec_v.model.num_filters} filters, rd/{cfg}/{V1_LAMBDA}): "
            f"{len(blocks)} blocks, {len(decoded[0])} decoded points, "
            f"bit-exact; {bpp_v:.4f} bpp, D1 PSNR {psnr_v:.4f} dB (host "
            f"KD-tree {host_v:.4f}); encode {len(blocks) / t_enc:.2f} "
            f"blocks/s ({t_enc:.2f} s), decode {len(blocks) / t_dec:.2f} "
            f"blocks/s ({t_dec:.2f} s); launches {counts_v1[cfg]}")
        log(f"{cfg} k9 layers on a {BATCH}-block chunk: analysis Conv_0 "
            f"(1 -> 32, 64^3 -> 32^3) {ms_a:.3f} ms, synthesis "
            f"ConvTranspose_2 (32 -> 1, 32^3 -> 64^3) {ms_s:.3f} ms; the "
            f"chunk's whole decode {ms_dec:.3f} ms")
        log(f"phase 12 ({cfg}): {time.time() - t_phase:.1f} s")
        del codec_v

    # phase 13: the host-threshold encoder, c3p
    t_phase = time.time()
    blobs, metadata, decoded, counts_hf, t_enc, t_dec = drive(
        codec, method="compress_blocks", fixed_threshold=True)
    mid = len(codec.thresholds) // 2
    assert drive.picks == [[mid] * len(blocks)], "a fixed pick is not 128"
    expect_launches("the fixed-threshold host path", counts_hf, (),
                    sweep_names + k4_names)
    log(f"host path, fixed_threshold (index {mid} everywhere): "
        f"{len(blocks)} blocks, {len(decoded[0])} decoded points, "
        f"bit-exact; {len(blobs[0]) * 8 / len(points):.4f} bpp, D1 PSNR "
        f"{metadata[0]['metrics']['d1_psnr']:.4f} dB (host KD-tree); encode "
        f"{len(blocks) / t_enc:.2f} blocks/s ({t_enc:.2f} s), decode "
        f"{t_dec:.2f} s; launches {counts_hf}")
    cut_pts, cut_blocks, cut_binstr = cut_cloud(blocks, binstr, CUT_BLOCKS)
    cut = (cut_blocks, cut_binstr, cut_pts)
    _, _, _, counts_hc, t_enc, t_dec = drive(codec, method="compress_blocks",
                                             cloud=cut)
    host_picks = drive.picks[0]
    expect_launches("the adaptive host path", counts_hc, (),
                    sweep_names + k4_names)
    t_host = t_enc
    drive(codec, cloud=cut)
    k1_picks = drive.picks[0]
    differ = [i for i in range(CUT_BLOCKS) if host_picks[i] != k1_picks[i]]
    log(f"host path, adaptive sweep on the cut (the first {CUT_BLOCKS} "
        f"blocks as their own cloud, {len(cut_pts)} points): bit-exact; "
        f"encode {t_host:.2f} s ({t_host / CUT_BLOCKS:.2f} s a block), "
        f"decode {t_dec:.2f} s; host picks equal to the bucket backend's "
        f"(K1) on {CUT_BLOCKS - len(differ)} of {CUT_BLOCKS} blocks")
    if differ:
        flat_c, offsets_c = flatten_blocks(cut_blocks)
        pts_c = codec.chunk_points(
            torch.as_tensor(pack_coords(flat_c, BLOCK), device=device),
            offsets_c, 0, CUT_BLOCKS, budget)
        x_hat_c = codec.canonical_chunk(pts_c, CUT_BLOCKS)["x_hat"][
            ..., 0].cpu().numpy()
        for i in differ:
            mse = [host_d1_mse(cut_blocks[i], x_hat_c[i],
                               codec.thresholds[t])
                   for t in (host_picks[i], k1_picks[i])]
            log(f"  block {i}: host pick {host_picks[i]} (d1_mse "
                f"{mse[0]!r}), K1 pick {k1_picks[i]} (d1_mse {mse[1]!r}): "
                f"gap {mse[1] - mse[0]!r}")
    log(f"phase 13: {time.time() - t_phase:.1f} s")

    # phase 14: d2 on the point sweep (sweep_backend="xla"), on the cut
    from pcc_geo_cnn_v2_tpu_torch.ops.threshold_sweep import d2_sweep_pts

    t_phase = time.time()
    d2_kw = dict(opt_metrics=("d1_mse", "d2_mse"), with_normals=True)
    codec_x = BlockCodec(build_model("c3p"), params, block_size=BLOCK,
                         batch_blocks=BATCH, device=device,
                         sweep_backend="xla")
    _, _, _, counts_pd, t_enc, t_dec = drive(codec_x, cloud=cut, **d2_kw)
    pt_picks = drive.picks
    expect_launches("the point sweep", counts_pd, ("halo_edt",),
                    ("bucket_colsums", "bucket_colsums_d2", "edt_sweep"))
    assert pt_picks[0] == k1_picks, (pt_picks[0], k1_picks)
    drive(codec, cloud=cut, **d2_kw)
    k3_picks = drive.picks
    assert k3_picks[0] == k1_picks
    same_d2 = sum(a == b for a, b in zip(pt_picks[1], k3_picks[1]))
    # the point sweep twice on the cut's chunk: bit-equal arrays
    flat_c, offsets_c = flatten_blocks(cut_blocks)
    pts_c = codec.chunk_points(
        torch.as_tensor(pack_coords(flat_c, BLOCK), device=device),
        offsets_c, 0, CUT_BLOCKS, budget)
    nrm_c = codec.chunk_normals(torch.as_tensor(flatten_blocks(
        cut_blocks, cols=(3, 4, 5), dtype=np.float32)[0], device=device),
        offsets_c, 0, CUT_BLOCKS, budget)
    res_c = codec_x.canonical_chunk(pts_c, CUT_BLOCKS)
    runs = [d2_sweep_pts(res_c["x"][..., 0], pts_c, nrm_c,
                         res_c["x_hat"][..., 0], codec_x.thr_dev,
                         band=codec_x.d2_band) for _ in range(2)]
    for key in runs[0]:
        assert torch.equal(runs[0][key], runs[1][key]), key
    log(f"point sweep (sweep_backend='xla', normals, d1_mse + d2_mse, band "
        f"{codec_x.d2_band}) on the cut: both streams bit-exact; encode "
        f"{t_enc:.2f} s, decode of both {t_dec:.2f} s; d1 picks equal K1's "
        f"on {CUT_BLOCKS} of {CUT_BLOCKS}; d2 picks equal K3's on "
        f"{same_d2} of {CUT_BLOCKS} (K3's AB takes each original's own "
        f"normal, the point sweep the vote mean); d2 arrays bit-equal over "
        f"two runs; launches {counts_pd}")
    log(f"  d2 picks, point sweep: {pt_picks[1]}")
    log(f"  d2 picks, K3:          {k3_picks[1]}")
    # another threshold grid (n_thresholds = 64) through K1, K5 and K3
    t64 = {}
    for name, kernel, backend, kw in (
            ("K1", "bucket_colsums", "bucket", {}),
            ("K5", "edt_sweep", "pallas", {}),
            ("K3", "bucket_colsums_d2", "bucket", d2_kw)):
        c64 = BlockCodec(build_model("c3p"), params, block_size=BLOCK,
                         batch_blocks=BATCH, device=device, n_thresholds=64,
                         sweep_backend=backend)
        blobs, _, _, counts, _, _ = drive(c64, cloud=cut, **kw)
        expect_launches(f"{name} at T = 64", counts,
                        (kernel, "halo_edt"), ())
        t64[name] = (blobs[0], drive.picks[0])
    assert t64["K1"] == t64["K5"] == t64["K3"], "d1 streams differ at T = 64"
    assert max(t64["K1"][1]) < 64
    log(f"n_thresholds = 64 on the cut: K1, K5 and K3 launched, d1 streams "
        f"byte-equal, bit-exact; picks {t64['K1'][1]}")
    log(f"phase 14: {time.time() - t_phase:.1f} s")

    by_path = {"d1": counts_d1, "A": counts_a, "B": counts_b, "C": counts_c,
               "C_bf16": counts_cb, "c2": counts_v1["c2"],
               "c1": counts_v1["c1"], "host_fixed": counts_hf,
               "host_cut": counts_hc, "point_d2_cut": counts_pd}
    for name, shapes in k4.items():
        # headline numbers: f32 at the stage with the most work
        top = max((r for r in shapes if r["dtype"] == "f32"),
                  key=lambda r: r["gflop"])
        k4[name] = {**{k: top[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "bound_share", "ms_over_library")},
            "max_abs_err": max(r["max_abs_err"] for r in shapes),
            "shapes": shapes}
    rows = []
    for name, meta, path, src, tpu in (
            ("bucket_colsums", k1, "d1", "csrc/bucket_colsums.cu",
             "pcc_geo_cnn_v2_tpu/ops/bucket_sweep.py:65"),
            ("halo_edt", k2, "d1", "csrc/halo_edt.cu",
             "pcc_geo_cnn_v2_tpu/ops/pallas_halo.py:43"),
            ("bucket_colsums_d2", k3, "A", "csrc/bucket_colsums_d2.cu",
             "pcc_geo_cnn_v2_tpu/ops/bucket_sweep.py:121"),
            ("edt_sweep", k5, "B", "csrc/edt_sweep.cu",
             "pcc_geo_cnn_v2_tpu/ops/pallas_sweep.py:156"),
            ("fused_tail", k4["fused_tail"], "C", "csrc/fused_tail.cu",
             "pcc_geo_cnn_v2_tpu/ops/pallas_conv.py:171"),
            ("fused_tail_slab", k4["fused_tail_slab"], "C",
             "csrc/fused_tail_slab.cu",
             "pcc_geo_cnn_v2_tpu/ops/pallas_conv.py:345")):
        rows.append({"name": name, "route": "cuda",
                     "source": f"pcc_geo_cnn_v2_tpu_torch/{src}",
                     "replaces": tpu, "launches": by_path[path][name],
                     "path": path, "library_ms": None, **meta,
                     "launches_by_path": {k: v[name]
                                          for k, v in by_path.items()}})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
