#!/usr/bin/env python3
"""Drive the PyTorch port's flagship path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each passes or ends the run with a non-zero exit):

1. Print the card (``nvidia-smi`` name and power limit) and the torch/CUDA
   versions; build every kernel of ``pcc_geo_cnn_v2_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together) and the host C++ libraries,
   so that no build lands inside a timed phase.
2. K1 (bucket prefix-min column sums) against its plain PyTorch version on
   the card, at main-path shapes (K = 32768, real x_hat of the flagship
   model on the cloud below): colsum / candmin equal for every k < cnt0,
   equal picks and overflow flags; then again at the overflow rerun's
   shape (K = B³) on every block of the cloud that overflows K = 32768.
3. K2 (bounded halo EDT + D1 sums) against its plain version: B = 64,
   halo = 12, 64 blocks of halo volumes assembled from that cloud: sum, n,
   unres_cnt and the packed outlier bytes equal.
4. Main path: a 10-bit ``figure_cloud`` partitioned at octree level 4,
   model c3p at full width (64 filters, f32) with the committed
   ``bench_c3p.msgpack.gz`` weights; ``compress_blocks_device_opt`` →
   container → ``decompress_blocks`` at ``batch_blocks=32``. The decoded
   blocks must equal the encoder's embedded reconstruction bit for bit,
   the encoder's device D1 PSNR must equal a host KD-tree D1 PSNR of the
   decoded cloud, and every kernel must have launched in this phase.

Prints a ``kernels`` JSON line (per kernel: launches on the main path,
max error against the plain version, its median time, the plain time and
the least time the card could take for the same work), the card line, and
last ``{"ok": true, "device": {...}}``. Without a CUDA device it exits
non-zero and prints no result.
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
# int32 instruction rate is 67e12 / 2 / 2. Both kernels do integer work.
PEAK_BYTES_S = 3.35e12
PEAK_INT32_OPS_S = 67e12 / 4
# int32 operations per (point, candidate) pair that K1's function needs:
# 3 subtractions and 3 multiply(-add)s for d², the running min, the
# column-sum add and the column min
K1_OPS_PER_PAIR = 9


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps):
    """Median milliseconds of ``fn()`` over ``reps`` runs (CUDA events)."""
    import torch

    fn()  # warm-up
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(nbytes, ops):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_INT32_OPS_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_k1(codec, pts, x_hat, K, reps=10, plain_reps=2):
    """Phase 2: K1 vs its plain version on the blocks of ``x_hat`` at
    candidate budget ``K`` (a canonical chunk at the sweep's budget, or
    the overflowed blocks at the rerun's K = B³)."""
    import torch

    from pcc_geo_cnn_v2_tpu_torch.ops import bucket_sweep as bsw

    xh = x_hat[..., 0]
    _, pos, cnt0, K = bsw.sorted_candidates(xh, codec.thr_dev, K)
    cnt0c = torch.clamp_max(cnt0, K)
    pts = pts.contiguous()
    npts = (pts[:, :, 0] >= 0).sum(-1).to(torch.int32)
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
    ms = time_ms(lambda: bsw.bucket_colsums(*args), reps=reps)
    plain_ms = time_ms(lambda: bsw.bucket_colsums_plain(*args),
                       reps=plain_reps)
    pairs = int((npts.to(torch.int64) * cnt0c.to(torch.int64)).sum())
    nbytes = (pts.numel() + pos.numel() + 2 * len(npts)) * 4 \
        + 2 * pos.numel() * 4
    bound_ms, by = bound(nbytes, K1_OPS_PER_PAIR * pairs)
    log(f"K1 ok at K = {K}: {len(npts)} blocks, cnt0 {int(cnt0.min())}.."
        f"{int(cnt0.max())}, {pairs} point-candidate pairs, "
        f"overflow {int(ok.sum())}, {ms:.3f} ms (plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.3f} ms by {by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by)


def check_k2(occ, mask, origins):
    """Phase 3: K2 vs its plain version on one halo batch."""
    import torch

    from pcc_geo_cnn_v2_tpu_torch.ops import cloud_metrics as cm
    from pcc_geo_cnn_v2_tpu_torch.ops import halo as hl

    n = len(origins)
    nb = cm.neighbor_table(origins, BLOCK)
    zero = torch.zeros(1, occ.shape[1], dtype=torch.uint8, device=occ.device)
    idx = torch.as_tensor(np.where(nb < 0, n, nb), device=occ.device)
    q_nb = torch.cat([occ[:n], zero])[idx]
    t_nb = torch.cat([mask[:n], zero])[idx]
    qry = cm.query_core(q_nb, BLOCK)
    tgt = cm.assemble_halo(t_nb, BLOCK, HALO)
    kmax = hl.halo_kmax(qry, tgt, HALO)
    got = hl.halo_edt(qry, tgt, kmax, BLOCK, HALO)
    ref = hl.halo_edt_plain(qry, tgt, kmax, BLOCK, HALO)
    torch.cuda.synchronize()
    err = max(int((g.to(torch.int64) - r.to(torch.int64)).abs().max())
              for g, r in zip(got, ref))
    assert err == 0, f"K2 disagrees with its plain version (max err {err})"
    ms = time_ms(lambda: hl.halo_edt(qry, tgt, kmax, BLOCK, HALO), reps=10)
    plain_ms = time_ms(lambda: hl.halo_edt_plain(qry, tgt, kmax, BLOCK,
                                                 HALO), reps=2)
    H = BLOCK + 2 * HALO
    km = kmax.to(torch.int64)
    # z scans (2 passes of compare+select per voxel), y pass over core
    # planes/rows (one min+add pair per shift), x pass at query voxels
    ops = 4 * n * H ** 3 \
        + int((BLOCK * BLOCK * H * (4 * km + 1)).sum()) \
        + int((got[1].to(torch.int64) * (4 * km + 1)).sum())
    # target halo volumes and query cores in; outlier bits and the
    # per-block kmax, sum, n and unres_cnt
    nbytes = tgt.numel() + qry.numel() + got[3].numel() + n * (4 + 8 + 4 + 4)
    bound_ms, by = bound(nbytes, ops)
    log(f"K2 ok: {n} blocks, kmax {int(kmax.min())}..{int(kmax.max())}, "
        f"{int(got[1].sum())} queries, {int(got[2].sum())} outliers, "
        f"{ms:.3f} ms (plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms by "
        f"{by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by)


def host_d1_psnr(points, decoded, r):
    """Reference D1 PSNR with host KD-trees (both directions)."""
    from scipy.spatial import cKDTree

    a, b = points[:, :3].astype(np.float64), decoded.astype(np.float64)
    d_ab = cKDTree(b).query(a, workers=-1)[0] ** 2
    d_ba = cKDTree(a).query(b, workers=-1)[0] ** 2
    mse = max(d_ab.mean(), d_ba.mean())
    return 10 * np.log10(3.0 * r * r / mse)


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
    points = figure_cloud(CLOUD_SEED, RESOLUTION, with_normals=False)
    blocks, binstr = partition_octree(points, [0, 0, 0], [RESOLUTION] * 3,
                                      LEVEL)
    log(f"cloud: {len(points)} points -> {len(blocks)} blocks of "
        f"{BLOCK}^3 ({time.time() - t0:.1f} s)")
    model = build_model("c3p")
    codec = BlockCodec(model, load_asset_tree(ASSET), block_size=BLOCK,
                       batch_blocks=BATCH, device=device)

    # phases 2-3 inputs: the canonical chunks of the main path
    budget = max(int(2 ** np.ceil(np.log2(max(len(b) for b in blocks)))),
                 64)
    flat, offsets = flatten_blocks(blocks)
    flat_dev = torch.as_tensor(pack_coords(flat, BLOCK), device=device)
    occ, mask, over_pts, over_xh = [], [], [], []
    for lo in range(0, len(blocks), BATCH):
        hi = min(lo + BATCH, len(blocks))
        pts = codec.chunk_points(flat_dev, offsets, lo, hi, budget)
        res = codec.encode_chunk(pts, hi - lo)
        if lo < HALO_BATCH:
            occ.append(res["occ"])
            mask.append(res["masks"][0])
        if lo == 0:
            k1 = check_k1(codec, pts, res["x_hat"], codec.bucket_k)
        # the rows the codec re-sweeps at K = B³
        cnt0 = (res["x_hat"][:hi - lo].reshape(hi - lo, -1)
                > codec.thr_dev[0]).sum(-1)
        rows = torch.nonzero(cnt0 > codec.bucket_k).flatten()
        over_pts.append(pts[rows])
        over_xh.append(res["x_hat"][rows])
    over_pts, over_xh = torch.cat(over_pts), torch.cat(over_xh)
    assert len(over_pts), "no block overflows: the rerun is not exercised"
    k1["rerun"] = check_k1(codec, over_pts.contiguous(), over_xh,
                           BLOCK ** 3, reps=3, plain_reps=1)
    k1["max_abs_err"] = max(k1["max_abs_err"], k1["rerun"]["max_abs_err"])
    origins = np.stack(block_origins(binstr, [0, 0, 0], [RESOLUTION] * 3,
                                     LEVEL))[:HALO_BATCH]
    k2 = check_k2(torch.cat(occ), torch.cat(mask), origins)

    # phase 4: the main path, counted
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.time()
    data_list, metadata = codec.compress_blocks_device_opt(
        blocks, binstr, points, RESOLUTION, LEVEL)
    blob = gzip.compress(save_compressed_file(binstr, data_list[0],
                                              RESOLUTION, LEVEL))
    t_enc = time.time() - t0
    t0 = time.time()
    res_, lvl_, binstr2, payload = load_compressed_file(
        io.BytesIO(gzip.decompress(blob)))
    dec = codec.decompress_blocks(payload)
    torch.cuda.synchronize()
    t_dec = time.time() - t0
    counts = dict(kernels.launches)
    dec_full = np.vstack(departition_octree(dec, binstr2, [0, 0, 0],
                                            [res_] * 3, lvl_))
    enc_full = metadata[0]["blocks_full"]
    assert dec_full.shape == enc_full.shape and np.array_equal(
        dec_full, enc_full), "decoded blocks differ from the encoder's"
    bpp = len(blob) * 8 / len(points)
    psnr = metadata[0]["metrics"]["d1_psnr"]
    psnr_host = host_d1_psnr(points, dec_full, RESOLUTION - 1)
    assert np.isfinite(psnr) and 0 < bpp < 8, (psnr, bpp)
    assert abs(psnr - psnr_host) < 1e-6, (psnr, psnr_host)
    log(f"main path: {len(blocks)} blocks, {len(dec_full)} decoded points, "
        f"bit-exact; {bpp:.4f} bpp, D1 PSNR {psnr:.4f} dB (host KD-tree "
        f"{psnr_host:.4f}); encode {len(blocks) / t_enc:.2f} blocks/s "
        f"({t_enc:.2f} s), decode {len(blocks) / t_dec:.2f} blocks/s "
        f"({t_dec:.2f} s); launches {counts}")
    for name, n in counts.items():
        assert n > 0, f"kernel {name} did not launch on the main path"

    rows = []
    for name, meta, src, tpu in (
            ("bucket_colsums", k1, "csrc/bucket_colsums.cu",
             "pcc_geo_cnn_v2_tpu/ops/bucket_sweep.py:65"),
            ("halo_edt", k2, "csrc/halo_edt.cu",
             "pcc_geo_cnn_v2_tpu/ops/pallas_halo.py:43")):
        rows.append({"name": name, "route": "cuda",
                     "source": f"pcc_geo_cnn_v2_tpu_torch/{src}",
                     "replaces": tpu, "launches": counts[name], **meta,
                     "library_ms": None})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
