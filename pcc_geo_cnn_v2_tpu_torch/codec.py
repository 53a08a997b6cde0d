"""Batched block codec: whole point clouds through the GPU in fixed batches.

Port of ``pcc_geo_cnn_v2_tpu/codec.py`` for the device-sweep encoder
(:meth:`BlockCodec.compress_blocks_device_opt`: the d1 metric group, and
with input normals the d2 group) and the decoder
(:meth:`BlockCodec.decompress_blocks`).

Encode, per chunk of ``batch_blocks`` blocks: voxelize → analysis pass
(symbols only) → the decoder-canonical ``decode_z`` / ``decode_y`` →
threshold sweep → packed per-metric masks. Then the host range coder, the
encoder-side full-cloud metrics (D1 on kernel K2; D2 through argmin halo
EDTs) and the best-variant selection per metric group.

The sweep has three backends (``sweep_backend``), all giving the same d1
picks because every sum in the port is an exact integer:

- ``"bucket"`` (default): the bucket-ordered sweep on kernel K1, or on
  kernel K3 when an opt metric is a d2 metric (normals ride per chunk);
- ``"pallas"``: the exact-EDT sweep on kernel K5 (the name is the JAX
  package's for this backend);
- ``"xla"``: the same sweep in plain torch, one EDT per threshold — the
  reference for K5's path, far slower.

The JAX codec demotes ``bucket`` to ``pallas`` when a warm-up gate finds
its compiled bucket kernel disagreeing with the exact sweep. That gate
guards against a TPU miscompile; the port has none and never changes
backend by itself: ``chip_smoke.py`` holds each kernel against its plain
version on the card instead. d2 opt metrics need the ``bucket`` backend
(the grid-based d2 sweeps are not ported) and raise on the others.

Decoder-canonical contract (``pcc_geo_cnn_v2_tpu/codec.py:225-236,
282-300``): x_hat is made by ONE decode function at ONE batch width
(``batch_blocks``); the last chunk is padded with zero symbols to that
width on both sides, and encoder and decoder threshold the same f32
values. On the GPU this needs deterministic convolutions: every conv pass
runs with ``torch.backends.cudnn.deterministic = True``,
``cudnn.benchmark = False`` and TF32 off for both cuDNN and matmuls
(:func:`deterministic_convs`), so one shape always takes one algorithm.
The model's conv backend and compute type (``build_model(config, dtype,
conv_backend)``) are part of that contract, as in the JAX package: a
stream must be decoded with the backend and the dtype it was encoded with.
With ``conv_backend="pallas"`` the residual tails run on the hand-written
kernels K4a / K4b, which sum every voxel in one fixed order whatever the
batch; the strided convs around them stay cuDNN under the same flags.

Blocks whose candidate count overflows the sweep's budget
(``bucket_k``) are re-swept through the same kernel at ``K = B³``, where
overflow cannot happen, on the kept canonical x_hat rows — never
re-decoded.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from pcc_geo_cnn_v2_tpu_torch.coding import range_coder as rc
from pcc_geo_cnn_v2_tpu_torch.models.entropy import (
    build_factorized_cdf,
    build_gaussian_cdf,
    refine_factorized_quantiles,
)
from pcc_geo_cnn_v2_tpu_torch.ops.bitunpack import unpack_mask_coords
from pcc_geo_cnn_v2_tpu_torch.ops.bucket_sweep import (
    check_normals,
    select_thresholds_d1_bucket,
)
from pcc_geo_cnn_v2_tpu_torch.ops.cloud_metrics import (
    blockwise_d1_sums,
    blockwise_d2_metrics,
    d1_metrics_from_sums,
    resolve_outliers,
)
from pcc_geo_cnn_v2_tpu_torch.ops.threshold_sweep import (
    D1_METRICS,
    D2_METRICS,
    select_thresholds_d1_batch,
    select_thresholds_d1_pallas,
)
from pcc_geo_cnn_v2_tpu_torch.ops.voxel import (
    flatten_blocks,
    pack_attrs,
    pack_coords,
    packbits,
    unflatten_points,
    unpack_coords,
    voxelize,
)
from pcc_geo_cnn_v2_tpu_torch.utils.octree import (
    block_origins,
    departition_octree,
)
from pcc_geo_cnn_v2_tpu_torch.weights import params_from_jax

logger = logging.getLogger(__name__)

__all__ = ["BlockCodec", "SWEEP_BACKENDS", "resolve_device",
           "deterministic_convs"]

SWEEP_BACKENDS = ("bucket", "pallas", "xla")


def resolve_device(device=None):
    """The card unless the caller asks for the CPU; never a silent CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                               "plain CPU versions explicitly")
        device = "cuda"
    return torch.device(device)


def deterministic_convs():
    """One algorithm per conv shape, no TF32: encoder and decoder x_hat
    are bit-identical (see module docstring)."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


class BlockCodec:
    """Drives a compression model over lists of octree blocks."""

    def __init__(self, model, params, block_size=64, batch_blocks=32,
                 device=None, sweep_backend="bucket"):
        """:param params: flax-layout numpy param tree (as read by
        ``weights.load_asset_tree``).
        :param sweep_backend: one of :data:`SWEEP_BACKENDS` (see the
            module docstring)."""
        if sweep_backend not in SWEEP_BACKENDS:
            raise ValueError(f"sweep_backend {sweep_backend!r} is not one "
                             f"of {SWEEP_BACKENDS}")
        self.sweep_backend = sweep_backend
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.block_size = int(block_size)
        self.thresholds = np.linspace(0, 1.0, 256)
        self.thr_dev = torch.tensor(self.thresholds, dtype=torch.float32,
                                    device=self.device)
        self.batch_blocks = int(batch_blocks)
        # candidate budget of the bucket sweep; blocks with more voxels
        # above thresholds[0] re-run at K = B³
        self.bucket_k = 32768
        # chunk size / halo width of the full-cloud halo-metric pass
        self.halo_batch = 64
        self.halo_width = 12
        self.set_params(params)
        self.gc_table = build_gaussian_cdf(model.conditional.scale_table,
                                           model.conditional.tail_mass)

    def set_params(self, params):
        """Load weights; re-solve the factorized-prior quantiles first
        (float64 host bisection, so a separate decode process derives
        identical medians and CDF tables)."""
        tree = dict(params.get("params", params))
        eb = dict(tree["entropy_bottleneck"])
        eb["quantiles"] = refine_factorized_quantiles(eb)["quantiles"]
        tree["entropy_bottleneck"] = eb
        self.model.load_state_dict(params_from_jax(tree))
        # the fused-conv backend's packed tail weights follow the load
        self.model.pack_fused_weights()
        self.eb_table = build_factorized_cdf(eb)

    # -- shape helpers ----------------------------------------------------

    @property
    def y_shape(self):
        b = self.block_size // 8
        return (b, b, b, self.model.num_filters)

    @property
    def z_shape(self):
        b = self.block_size // 16
        return (b, b, b, self.model.num_filters)

    def _channel_indexes(self, shape):
        return np.broadcast_to(np.arange(shape[-1], dtype=np.int32), shape)

    def _chunks(self, n):
        bs = self.batch_blocks
        return [(lo, min(lo + bs, n)) for lo in range(0, n, bs)]

    def _pad_rows(self, a, rows):
        """Zero-pad a host array's rows to the canonical batch width and
        move it to the device."""
        t = torch.as_tensor(np.ascontiguousarray(a), device=self.device)
        if len(t) < rows:
            t = torch.cat([t, t.new_zeros((rows - len(t),) + t.shape[1:])])
        return t

    # -- canonical device passes ------------------------------------------

    def _decode_z(self, z_sym):
        deterministic_convs()
        return self.model.decode_z(z_sym)[1].to(torch.uint8)

    def _decode_y(self, y_sym):
        deterministic_convs()
        return self.model.decode_y(y_sym)

    def _masks(self, x_hat, thr):
        """Packed 1-bit masks ``x_hat > thr`` per block: [N, B³/8]."""
        mask = x_hat[..., 0] > thr[:, None, None, None]
        return packbits(mask.reshape(mask.shape[0], -1))

    def entropy_encode_all(self, out):
        """Range-code every block's symbols → list of (y, z) strings."""
        y = rc.encode_batch(out["y_sym"], out["y_idx"], self.gc_table)
        z = rc.encode_batch(out["z_sym"],
                            self._channel_indexes(self.z_shape),
                            self.eb_table)
        return list(zip(y, z))

    # -- encode ------------------------------------------------------------

    def _sweep(self, x_hat, pts, occ, opt_metrics, max_deltas, nrm=None):
        """Threshold sweep of one chunk on the codec's backend: picks
        [N, M] int32. Bucket-overflowed rows re-run at K = B³."""
        sel = dict(opt_metrics=opt_metrics, max_deltas=max_deltas)
        if any(m in D2_METRICS for m in opt_metrics):
            if self.sweep_backend != "bucket":
                raise NotImplementedError(
                    "d2 opt metrics need sweep_backend='bucket' (kernel "
                    f"K3), not {self.sweep_backend!r}")
            sel["nrm"] = nrm  # K3; d1 metrics alone stay on K1
        elif self.sweep_backend == "pallas":
            return select_thresholds_d1_pallas(occ, x_hat[..., 0],
                                               self.thr_dev, pts=pts, **sel)
        elif self.sweep_backend == "xla":
            return select_thresholds_d1_batch(occ, x_hat[..., 0],
                                              self.thr_dev, **sel)
        picks, overflow = select_thresholds_d1_bucket(
            x_hat[..., 0], pts, self.thr_dev, K=self.bucket_k, **sel)
        rows = torch.nonzero(overflow).flatten()
        if len(rows):
            logger.info("bucket sweep overflow: re-sweeping %d block(s) at "
                        "K = B³", len(rows))
            if nrm is not None:
                sel["nrm"] = nrm[rows]
            picks[rows] = select_thresholds_d1_bucket(
                x_hat[rows, ..., 0], pts[rows], self.thr_dev,
                K=self.block_size ** 3, **sel)[0]
        return picks

    def _chunk_offsets(self, offsets, lo, hi):
        """(f0, f1, [batch_blocks + 1] device offsets) of blocks lo..hi-1
        inside the flat stream; trailing padding blocks are empty."""
        f0, f1 = int(offsets[lo]), int(offsets[hi])
        offs = np.full(self.batch_blocks + 1, f1 - f0, np.int32)
        offs[:hi - lo + 1] = offsets[lo:hi + 1] - f0
        return f0, f1, torch.as_tensor(offs, device=self.device)

    def chunk_points(self, flat_dev, offsets, lo, hi, budget):
        """[batch_blocks, budget, 3] int32 point lists of blocks lo..hi-1
        (padding rows and blocks -1) from the packed flat device stream."""
        f0, f1, offs = self._chunk_offsets(offsets, lo, hi)
        return unflatten_points(
            unpack_coords(flat_dev[f0:f1], self.block_size), offs,
            self.batch_blocks, budget)

    def chunk_normals(self, nrm_dev, offsets, lo, hi, budget):
        """[batch_blocks, budget, 3] f32 normals matching
        :meth:`chunk_points` (zero padding rows) from the flat [F, 3]
        device stream."""
        f0, f1, offs = self._chunk_offsets(offsets, lo, hi)
        return unflatten_points(nrm_dev[f0:f1], offs, self.batch_blocks,
                                budget, fill=0)

    def encode_chunk(self, pts, n_valid, opt_metrics=("d1_mse",),
                     max_deltas=(np.inf,), nrm=None):
        """One canonical chunk: voxelize → symbols → decode_z / decode_y →
        sweep → masks. Rows past ``n_valid`` are padding.

        :param nrm: [N, P, 3] f32 per-point normals (d2 opt metrics).
        :return: dict(z_sym, y_sym, y_idx, x_hat, picks, occ, masks) on
            the device; ``occ`` and ``masks[m]`` are packed [N, B³/8].
        """
        x = voxelize(pts, self.block_size)
        occ = x[..., 0] > 0
        dup = (pts[..., 0] >= 0).sum(-1) - occ.sum(dim=(1, 2, 3))
        if bool(dup.any()):
            raise ValueError("block(s) contain duplicate voxel coordinates; "
                             "dedup inputs (see cli/compress.py)")
        deterministic_convs()
        res = self.model.encode_syms(x)
        # canonical decoder feed: padding rows are zero symbols, as the
        # decoder pads them
        for key in ("z_sym", "y_sym"):
            res[key][n_valid:] = 0
        res["y_idx"] = self._decode_z(res["z_sym"])
        res["x_hat"] = x_hat = self._decode_y(res["y_sym"])
        res["picks"] = self._sweep(x_hat, pts, x[..., 0], opt_metrics,
                                   max_deltas, nrm)
        thr = self.thr_dev[res["picks"].long()]
        res["masks"] = [self._masks(x_hat, thr[:, m])
                        for m in range(thr.shape[1])]
        res["occ"] = packbits(occ.reshape(len(occ), -1))
        return res

    def compress_blocks_device_opt(self, blocks, binstr, points, resolution,
                                   level, opt_metrics=("d1_mse",),
                                   max_deltas=(np.inf,), with_normals=False):
        """Encoder with the on-device threshold sweep. With normals (blocks
        and ``points`` carry nx, ny, nz in columns 3:6) d2_* opt metrics
        are supported and form a second metric group.

        :return: (data_list, metadata), one entry per metric group (d1,
            d2) present in ``opt_metrics``: data_list[g] = [(strings,
            thr_idx)] per block; metadata[g] has idx, metrics, x_hat_list,
            blocks_depart, blocks_full.
        """
        assert all(m in D1_METRICS + D2_METRICS for m in opt_metrics), \
            opt_metrics
        if not with_normals:
            assert all(m in D1_METRICS for m in opt_metrics), opt_metrics
        elif np.shape(blocks[0])[1] < 6 or np.shape(points)[1] < 6:
            raise ValueError("with_normals needs blocks and points with "
                             "normal columns (x y z nx ny nz)")
        n = len(blocks)
        size = self.block_size
        budget = max(int(2 ** np.ceil(np.log2(max(len(b) for b in blocks)))),
                     64)
        flat, offsets = flatten_blocks(blocks)
        flat_dev = torch.as_tensor(pack_coords(flat, size), device=self.device)
        nrm_dev = None
        if with_normals:
            nrm_flat = flatten_blocks(blocks, cols=(3, 4, 5),
                                      dtype=np.float32)[0]
            check_normals(nrm_flat)  # once per cloud, on the host
            nrm_dev = torch.as_tensor(nrm_flat, device=self.device)
        opt_names = [f"{m}_{d}" for d in max_deltas for m in opt_metrics]
        n_metrics = len(opt_names)

        t0 = time.time()
        host = {"z_sym": [], "y_sym": [], "y_idx": [], "picks": []}
        occ_chunks, mask_chunks = [], [[] for _ in range(n_metrics)]
        pts_chunks = []
        for lo, hi in self._chunks(n):
            pts = self.chunk_points(flat_dev, offsets, lo, hi, budget)
            nrm = None
            if with_normals:
                nrm = self.chunk_normals(nrm_dev, offsets, lo, hi, budget)
                pts_chunks.append(pts[:hi - lo])
            res = self.encode_chunk(pts, hi - lo, opt_metrics, max_deltas,
                                    nrm)
            for m in range(n_metrics):
                mask_chunks[m].append(res["masks"][m][:hi - lo])
            occ_chunks.append(res["occ"][:hi - lo])
            for key in host:
                host[key].append(res[key][:hi - lo].cpu().numpy())
        out = {k: np.concatenate(v) for k, v in host.items()}
        occ_cat = torch.cat(occ_chunks)
        masks = [torch.cat(c) for c in mask_chunks]
        t_device = time.time() - t0

        t0 = time.time()
        strings_list = self.entropy_encode_all(out)
        t_entropy = time.time() - t0
        t0 = time.time()
        x_hat_points = [unpack_mask_coords(m.cpu().numpy(), size)
                        for m in masks]
        metadata = self._select_best_device(
            binstr, x_hat_points, occ_cat, masks, opt_names, points,
            resolution, level,
            pts_dev=torch.cat(pts_chunks) if with_normals else None,
            nrm_host=(pack_attrs(blocks, [3, 4, 5], budget)
                      if with_normals else None))
        logger.info("compress_blocks_device_opt(%d blocks): device %.2fs, "
                    "entropy %.2fs, select %.2fs", n, t_device, t_entropy,
                    time.time() - t0)
        by_metric = out["picks"].T.tolist()
        data_list = [list(zip(strings_list, by_metric[m["idx"]]))
                     for m in metadata]
        return data_list, metadata

    def _d1_full_cloud_metrics(self, occ_packed, mask_packed, origins,
                               x_hat_blocks, points, resolution):
        """Exact full-cloud D1 metrics of one candidate: halo-EDT sums on
        the device, the rare > halo outliers resolved on the host."""
        sums = blockwise_d1_sums(occ_packed, mask_packed, origins,
                                 self.block_size, halo=self.halo_width,
                                 batch=self.halo_batch)
        if sums["n_b"] == 0:  # all blocks hit the failure guard
            return {"d1_psnr": -np.inf}
        return d1_metrics_from_sums(
            sums, resolution - 1, points_a=points[:, :3],
            resolve_a=lambda q: resolve_outliers(
                q, x_hat_blocks, origins, self.block_size,
                full_tree_limit=2_000_000))

    def _d2_full_cloud_metrics(self, pts_dev, nrm_host, mask_packed,
                               x_hat_blocks, origins, points, resolution):
        """Exact full-cloud D2 (+D1) metrics of one candidate: NN
        identities via banded argmin halo EDTs on the device, vote-based
        normal transfer and f64 projections on the host."""
        return blockwise_d2_metrics(
            pts_dev, nrm_host, mask_packed, x_hat_blocks, origins,
            self.block_size, resolution, points, halo=self.halo_width,
            batch=self.halo_batch, with_d1=True)

    def _select_best_device(self, binstr, x_hat_points, occ_packed,
                            masks_packed, opt_names, points, resolution,
                            level, pts_dev=None, nrm_host=None):
        """Best candidate variant (one per opt metric × max delta) of each
        metric group — ``d1`` by full-cloud D1 PSNR, ``d2`` by full-cloud
        D2 PSNR; its metrics feed the sidecar. A group with a single
        candidate skips the comparison but still gets its metrics."""
        bbox_min, bbox_max = [0, 0, 0], [resolution] * 3
        origins = np.stack(block_origins(binstr, bbox_min, bbox_max, level))
        metadata = []
        for group in ("d1", "d2"):
            entries = [i for i, nm in enumerate(opt_names)
                       if nm.startswith(group)]
            if not entries:
                continue
            if group == "d2":
                assert nrm_host is not None and pts_dev is not None, \
                    "d2 selection needs input normals"

                def metric_fn(i):
                    return self._d2_full_cloud_metrics(
                        pts_dev, nrm_host, masks_packed[i], x_hat_points[i],
                        origins, points, resolution)
            else:
                def metric_fn(i):
                    return self._d1_full_cloud_metrics(
                        occ_packed, masks_packed[i], origins,
                        x_hat_points[i], points, resolution)
            metrics = [metric_fn(i) for i in entries]
            local = 0 if len(entries) == 1 else int(np.argmax(
                [m[f"{group}_psnr"] for m in metrics]))
            best_idx = entries[local]
            logger.info("group %s: best %s of %d candidate(s)", group,
                        opt_names[best_idx], len(entries))
            blocks_depart = departition_octree(
                x_hat_points[best_idx], binstr, bbox_min, bbox_max, level)
            metadata.append({
                "idx": best_idx,
                "metrics": metrics[local],
                "x_hat_list": x_hat_points[best_idx],
                "blocks_depart": blocks_depart,
                "blocks_full": np.vstack(blocks_depart),
            })
        return metadata

    # -- decode ------------------------------------------------------------

    def decompress_blocks(self, payload):
        """payload: [(strings, threshold_idx), ...] → decoded point blocks.

        Thresholding and bit-packing run on the device; only 1-bit masks
        come back to the host.
        """
        n = len(payload)
        bs = self.batch_blocks
        marks = [time.time()]
        thr = np.array([self.thresholds[t] for _, t in payload], np.float32)
        z_syms = rc.decode_batch([p[0][1] for p in payload],
                                 self._channel_indexes(self.z_shape),
                                 self.eb_table, per_stream=False)
        marks.append(time.time())
        y_idx = np.concatenate([
            self._decode_z(self._pad_rows(z_syms[lo:hi], bs))[:hi - lo]
            .cpu().numpy() for lo, hi in self._chunks(n)])
        marks.append(time.time())
        y_syms = rc.decode_batch([p[0][0] for p in payload], y_idx,
                                 self.gc_table, per_stream=True)
        marks.append(time.time())
        masks = []
        for lo, hi in self._chunks(n):
            x_hat = self._decode_y(self._pad_rows(y_syms[lo:hi], bs))
            masks.append(self._masks(
                x_hat, self._pad_rows(thr[lo:hi], bs))[:hi - lo].cpu())
        marks.append(time.time())
        blocks = unpack_mask_coords(torch.cat(masks).numpy(),
                                    self.block_size)
        marks.append(time.time())
        logger.info("decompress_blocks(%d blocks): z rANS %.3fs, decode_z "
                    "%.3fs, y rANS %.3fs, decode_y+masks %.3fs, unpack "
                    "%.3fs", n, *np.diff(marks))
        return blocks
