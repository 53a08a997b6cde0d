"""Batched block codec: whole point clouds through the GPU in fixed batches.

Port of ``pcc_geo_cnn_v2_tpu/codec.py`` for the flagship path: the d1
metric group without normals, encode (:meth:`BlockCodec.compress_blocks_device_opt`)
and decode (:meth:`BlockCodec.decompress_blocks`).

Encode, per chunk of ``batch_blocks`` blocks: voxelize → analysis pass
(symbols only) → the decoder-canonical ``decode_z`` / ``decode_y`` → bucket
threshold sweep (kernel K1) → packed per-metric masks. Then the host range
coder, the encoder-side full-cloud D1 metric (kernel K2) and the best-
variant selection.

Decoder-canonical contract (``pcc_geo_cnn_v2_tpu/codec.py:225-236,
282-300``): x_hat is made by ONE decode function at ONE batch width
(``batch_blocks``); the last chunk is padded with zero symbols to that
width on both sides, and encoder and decoder threshold the same f32
values. On the GPU this needs deterministic convolutions: every conv pass
runs with ``torch.backends.cudnn.deterministic = True``,
``cudnn.benchmark = False`` and TF32 off for both cuDNN and matmuls
(:func:`deterministic_convs`), so one shape always takes one algorithm.

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
    select_thresholds_d1_bucket,
)
from pcc_geo_cnn_v2_tpu_torch.ops.cloud_metrics import (
    blockwise_d1_sums,
    d1_metrics_from_sums,
    resolve_outliers,
)
from pcc_geo_cnn_v2_tpu_torch.ops.threshold_sweep import D1_METRICS
from pcc_geo_cnn_v2_tpu_torch.ops.voxel import (
    flatten_blocks,
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

__all__ = ["BlockCodec", "resolve_device", "deterministic_convs"]


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
                 device=None):
        """:param params: flax-layout numpy param tree (as read by
        ``weights.load_asset_tree``)."""
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

    def _sweep(self, x_hat, pts, opt_metrics, max_deltas):
        """Bucket sweep of one chunk; overflowed rows re-run at K = B³."""
        picks, overflow = select_thresholds_d1_bucket(
            x_hat[..., 0], pts, self.thr_dev, opt_metrics=opt_metrics,
            max_deltas=max_deltas, K=self.bucket_k)
        rows = torch.nonzero(overflow).flatten()
        if len(rows):
            logger.info("bucket sweep overflow: re-sweeping %d block(s) at "
                        "K = B³", len(rows))
            picks[rows] = select_thresholds_d1_bucket(
                x_hat[rows, ..., 0], pts[rows], self.thr_dev,
                opt_metrics=opt_metrics, max_deltas=max_deltas,
                K=self.block_size ** 3)[0]
        return picks

    def chunk_points(self, flat_dev, offsets, lo, hi, budget):
        """[batch_blocks, budget, 3] int32 point lists of blocks lo..hi-1
        (padding rows and blocks -1) from the packed flat device stream."""
        bs = self.batch_blocks
        f0, f1 = int(offsets[lo]), int(offsets[hi])
        offs = np.full(bs + 1, f1 - f0, np.int32)
        offs[:hi - lo + 1] = offsets[lo:hi + 1] - f0
        return unflatten_points(
            unpack_coords(flat_dev[f0:f1], self.block_size),
            torch.as_tensor(offs, device=self.device), bs, budget)

    def encode_chunk(self, pts, n_valid, opt_metrics=("d1_mse",),
                     max_deltas=(np.inf,)):
        """One canonical chunk: voxelize → symbols → decode_z / decode_y →
        sweep → masks. Rows past ``n_valid`` are padding.

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
        res["picks"] = self._sweep(x_hat, pts, opt_metrics, max_deltas)
        thr = self.thr_dev[res["picks"].long()]
        res["masks"] = [self._masks(x_hat, thr[:, m])
                        for m in range(thr.shape[1])]
        res["occ"] = packbits(occ.reshape(len(occ), -1))
        return res

    def compress_blocks_device_opt(self, blocks, binstr, points, resolution,
                                   level, opt_metrics=("d1_mse",),
                                   max_deltas=(np.inf,)):
        """Encoder with the on-device threshold sweep (d1 metric group).

        :return: (data_list, metadata): data_list[g] = [(strings, thr_idx)]
            per block; metadata[g] has idx, metrics, x_hat_list,
            blocks_depart, blocks_full.
        """
        assert all(m in D1_METRICS for m in opt_metrics), opt_metrics
        n = len(blocks)
        size = self.block_size
        budget = max(int(2 ** np.ceil(np.log2(max(len(b) for b in blocks)))),
                     64)
        flat, offsets = flatten_blocks(blocks)
        flat_dev = torch.as_tensor(pack_coords(flat, size), device=self.device)
        n_metrics = len(opt_metrics) * len(max_deltas)

        t0 = time.time()
        host = {"z_sym": [], "y_sym": [], "y_idx": [], "picks": []}
        occ_chunks, mask_chunks = [], [[] for _ in range(n_metrics)]
        for lo, hi in self._chunks(n):
            pts = self.chunk_points(flat_dev, offsets, lo, hi, budget)
            res = self.encode_chunk(pts, hi - lo, opt_metrics, max_deltas)
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
            binstr, x_hat_points, occ_cat, masks, points, resolution, level)
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

    def _select_best_device(self, binstr, x_hat_points, occ_packed,
                            masks_packed, points, resolution, level):
        """Best candidate variant (one per opt metric × max delta, all in
        the d1 group) by full-cloud D1 PSNR; its metrics feed the sidecar."""
        bbox_min, bbox_max = [0, 0, 0], [resolution] * 3
        origins = np.stack(block_origins(binstr, bbox_min, bbox_max, level))
        metrics = [self._d1_full_cloud_metrics(occ_packed, m, origins, pts,
                                               points, resolution)
                   for m, pts in zip(masks_packed, x_hat_points)]
        best_idx = int(np.argmax([m["d1_psnr"] for m in metrics]))
        blocks_depart = departition_octree(
            x_hat_points[best_idx], binstr, bbox_min, bbox_max, level)
        return [{
            "idx": best_idx,
            "metrics": metrics[best_idx],
            "x_hat_list": x_hat_points[best_idx],
            "blocks_depart": blocks_depart,
            "blocks_full": np.vstack(blocks_depart),
        }]

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
