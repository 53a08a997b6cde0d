"""Batched block codec: whole point clouds through the GPU in fixed batches.

Port of ``pcc_geo_cnn_v2_tpu/codec.py``: the device-sweep encoder
(:meth:`BlockCodec.compress_blocks_device_opt`: the d1 metric group, and
with input normals the d2 group), the host-threshold encoder
(:meth:`BlockCodec.compress_blocks`: KD-tree metrics per block on a thread
pool, or ``fixed_threshold``) and the decoder
(:meth:`BlockCodec.decompress_blocks`), for v2 (hyperprior: c2, c3, c3p)
and v1 (factorized prior: c1) models, and for c3p_cw (c3p with the
channel-wise context model, ``CompressionModelCW``). The ``--debug``
harness of the CLIs adds :meth:`BlockCodec.encode_blocks` (the models'
fused ``encode``), :meth:`BlockCodec.entropy_encode` (one block's
strings) and ``decompress_blocks(return_debug=True)`` (the decoder's
symbols and packed masks).

Encode, per chunk of ``batch_blocks`` blocks: voxelize → analysis pass
(symbols only) → the decoder-canonical ``decode_z`` / ``decode_y`` (v1:
``decode``) → threshold sweep → packed per-metric masks. Then the host
range coder, the encoder-side full-cloud metrics (D1 on kernel K2; D2
through argmin halo EDTs) and the best-variant selection per metric group.

The sweep has three backends (``sweep_backend``), all giving the same d1
picks because every sum in the port is an exact integer:

- ``"bucket"`` (default): the bucket-ordered sweep on kernel K1, or on
  kernel K3 when an opt metric is a d2 metric (normals ride per chunk);
- ``"pallas"``: the exact-EDT sweep on kernel K5 (the name is the JAX
  package's for this backend);
- ``"xla"``: the same sweep in plain torch, one EDT per threshold — the
  reference for K5's path, far slower.

With input normals the two non-bucket backends take every metric set, d1
alone included, through the point-based plain-torch sweep
(``select_thresholds_device_pts``, banded argmin EDTs of band
``d2_band``), as the JAX codec does (``_sweep_mask_fn``).

The JAX codec demotes ``bucket`` to ``pallas`` when a warm-up gate finds
its compiled bucket kernel disagreeing with the exact sweep. That gate
guards against a TPU miscompile; the port has none and never changes
backend by itself: ``chip_smoke.py`` holds each kernel against its plain
version on the card instead.

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

The channel-wise model codes y in slices, each under a mean and a scale
that depend on the slices decoded before it. The encoder's canonical pass
runs that chain on the device (``CompressionModelCW.encode_syms``, the
decoder's own per-slice functions at the same batch width), and its y
string holds the slices in turn (y in NCDHW order, one string a block).
The decoder then alternates, per slice: μ and the σ rows on the device,
the rows to the host, the range decode of that slice of every block of
the chunk (``range_coder.BatchDecoder``, which keeps each string's coder
state between slices), the symbols back to the device for ŷ. One ulp of
μ apart, encoder and decoder would code different symbols, so the chain
obeys the contract below as x_hat does.

Blocks whose candidate count overflows the sweep's budget
(``bucket_k``) are re-swept through the same kernel at ``K = B³``, where
overflow cannot happen, on the kept canonical x_hat rows — never
re-decoded.

With ``devices=[...]`` (JAX ``codec.py:199-209``) the chunks of a cloud
round-robin over one model replica a device, all loaded from the same host
params: chunk k runs on ``devices[k % n]``. A lane holds only what
differs by device (the device, its model replica, its threshold grid);
every setting is read from the one codec. A round of chunks, one a
device, is dispatched before any of it is fetched, so that the devices
work at once; the parts are gathered to ``devices[0]``, which runs the
overflow rerun, the full-cloud metrics and the selection. The decoder
round-robins its chunks the same way. Octree blocks are independent, so
no collective is needed, and the streams equal the single-device codec's
(every chunk is decoded at the same batch width by the same arithmetic).

The codec keeps no per-call state: several threads may encode and decode
through one instance at once, each under its own CUDA stream
(``bench.py``); the constant tensors it makes at construction are complete
before the constructor returns.
"""

from __future__ import annotations

import copy
import logging
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from pcc_geo_cnn_v2_tpu_torch.coding import range_coder as rc
from pcc_geo_cnn_v2_tpu_torch.models.codec_models import (
    CompressionModelCW,
    CompressionModelV2,
)
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
    select_thresholds_device_pts,
)
from pcc_geo_cnn_v2_tpu_torch.ops.voxel import (
    flatten_blocks,
    pack_attrs,
    pack_coords,
    pack_points,
    packbits,
    unflatten_points,
    unpack_coords,
    voxelize,
)
from pcc_geo_cnn_v2_tpu_torch.utils import trace
from pcc_geo_cnn_v2_tpu_torch.utils.metrics import compute_metrics
from pcc_geo_cnn_v2_tpu_torch.utils.octree import (
    block_origins,
    departition_octree,
)
from pcc_geo_cnn_v2_tpu_torch.utils.threshold import (
    compute_optimal_thresholds,
)
from pcc_geo_cnn_v2_tpu_torch.weights import params_from_jax

logger = logging.getLogger(__name__)

__all__ = ["BlockCodec", "SWEEP_BACKENDS", "resolve_device",
           "deterministic_convs", "select_best_per_opt_metric"]

SWEEP_BACKENDS = ("bucket", "pallas", "xla")


def resolve_device(device=None):
    """The card unless the caller asks for the CPU; never a silent CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                               "plain CPU versions explicitly")
        device = "cuda"
    return torch.device(device)


def _get_normals(arr, with_normals):
    """The last three columns (nx, ny, nz) of a point array, or None."""
    if not with_normals:
        return None
    if arr.shape[1] < 6:
        raise ValueError("d2 metrics need normal columns (x y z nx ny nz); "
                         f"got {arr.shape[1]}-column points")
    return arr[:, arr.shape[1] - 3:]


def select_best_per_opt_metric(binstr, x_hat_list, level, opt_metrics,
                               points, resolution, with_normals,
                               opt_groups=("d1", "d2")):
    """Pick, per metric group, the candidate variant with the best
    full-cloud PSNR on host KD-trees (the reference's
    ``model_types.py:128-176``): departition every candidate, compute the
    whole-cloud metrics against the original points, argmax the group's
    PSNR.

    :param x_hat_list: list over opt_metrics of per-block point lists.
    :return: list of dicts (idx, metrics, x_hat_list, blocks_depart,
        blocks_full), one per group present.
    """
    from scipy.spatial import cKDTree

    assert len(opt_metrics) == len(x_hat_list)
    bbox_min, bbox_max = [0, 0, 0], [resolution] * 3
    t1 = cKDTree(points[:, :3], balanced_tree=False)
    metadata = []
    for group in opt_groups:
        entries = [i for i, name in enumerate(opt_metrics)
                   if name.startswith(group)]
        if not entries:
            continue
        departed = [departition_octree(x_hat_list[i], binstr, bbox_min,
                                       bbox_max, level) for i in entries]
        full = [np.vstack(blocks) for blocks in departed]
        key = f"{group}_psnr"
        # empty candidates (all blocks hit the failure guard) score -inf
        metrics = [compute_metrics(points[:, :3], cloud, resolution - 1,
                                   p1_n=_get_normals(points, with_normals),
                                   t1=t1)
                   if len(cloud) else {key: -np.inf} for cloud in full]
        local = int(np.argmax([m[key] for m in metrics]))
        logger.info("group %s: best %s (%s=%.2f) [host KD-tree]", group,
                    opt_metrics[entries[local]], key, metrics[local][key])
        metadata.append({
            "idx": entries[local],
            "metrics": metrics[local],
            "x_hat_list": x_hat_list[entries[local]],
            "blocks_depart": departed[local],
            "blocks_full": full[local],
        })
    return metadata


def deterministic_convs():
    """One algorithm per conv shape, no TF32: encoder and decoder x_hat
    are bit-identical (see module docstring)."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


class _Lane:
    """What differs between the devices of a round-robin codec: the
    device, its model replica and its threshold grid on that device."""

    __slots__ = ("device", "model", "thr_dev")

    def __init__(self, device, model, thr_dev):
        self.device, self.model, self.thr_dev = device, model, thr_dev


class BlockCodec:
    """Drives a compression model over lists of octree blocks."""

    def __init__(self, model, params, block_size=64, n_thresholds=2 ** 8,
                 batch_blocks=32, threads=8, device=None,
                 sweep_backend="bucket", devices=None):
        """:param model: a ``CompressionModelV2`` or ``CompressionModelV1``
            (``models.configs.build_model``).
        :param params: flax-layout numpy param tree (as read by
            ``weights.load_asset_tree``).
        :param n_thresholds: size of the threshold grid
            ``linspace(0, 1, n_thresholds)``; encoder and decoder must
            agree on it (the stream holds indices into it).
        :param threads: workers of the host threshold sweep
            (:meth:`compress_blocks`).
        :param sweep_backend: one of :data:`SWEEP_BACKENDS` (see the
            module docstring), or ``"auto"``: ``"bucket"`` on a card and
            ``"xla"`` on the CPU (JAX ``codec.py:216-218``).
        :param device: the one device of the codec (the card unless
            ``"cpu"`` is asked for).
        :param devices: several devices instead of ``device``: chunks
            round-robin over one model replica each (module docstring)."""
        if device is not None and devices is not None:
            raise ValueError("pass device= or devices=, not both")
        self.devices = [resolve_device(d) for d in (devices or [device])]
        self.device = self.devices[0]
        if sweep_backend == "auto":
            sweep_backend = "bucket" if self.device.type == "cuda" else "xla"
        if sweep_backend not in SWEEP_BACKENDS:
            raise ValueError(f"sweep_backend {sweep_backend!r} is not one "
                             f"of {SWEEP_BACKENDS + ('auto',)}")
        self.sweep_backend = sweep_backend
        self.model = model.to(self.device).eval()
        self.is_v2 = isinstance(model, CompressionModelV2)
        self.is_cw = isinstance(model, CompressionModelCW)
        self.block_size = int(block_size)
        self.thresholds = np.linspace(0, 1.0, n_thresholds)
        self.thr_dev = torch.tensor(self.thresholds, dtype=torch.float32,
                                    device=self.device)
        self.batch_blocks = int(batch_blocks)
        self.threads = threads
        # candidate budget of the bucket sweep; blocks with more voxels
        # above thresholds[0] re-run at K = B³
        self.bucket_k = 32768
        # chunk size / halo width of the full-cloud halo-metric pass
        self.halo_batch = 64
        self.halo_width = 12
        # EDT band of the point-based d2 sweep (``select_thresholds_device_
        # pts``): exact whenever every original point is within this many
        # voxels of the candidate set; PCC_D2_BAND overrides it, 'none' for
        # the exact full-grid argmin EDT (the JAX codec's knob and default)
        band = os.environ.get("PCC_D2_BAND", "12")
        self.d2_band = None if band.lower() == "none" else int(band)
        # chunk k runs on self._lanes[k % len(self._lanes)]: this codec's
        # model, then one replica a further device
        self._lanes = [_Lane(self.device, self.model, self.thr_dev)] + [
            _Lane(dev, copy.deepcopy(self.model).to(dev),
                  self.thr_dev.to(dev)) for dev in self.devices[1:]]
        self.set_params(params)
        if self.is_v2:
            self.gc_table = build_gaussian_cdf(
                model.conditional.scale_table, model.conditional.tail_mass)

    def set_params(self, params):
        """Load weights into every replica; re-solve the factorized-prior
        quantiles first (float64 host bisection, so a separate decode
        process derives identical medians and CDF tables)."""
        tree = dict(params.get("params", params))
        eb = dict(tree["entropy_bottleneck"])
        eb["quantiles"] = refine_factorized_quantiles(eb)["quantiles"]
        tree["entropy_bottleneck"] = eb
        state = params_from_jax(tree)
        for lane in self._lanes:
            lane.model.load_state_dict(state)
            if self.is_v2:
                # the fused-conv backend's packed tail weights follow the load
                lane.model.pack_fused_weights()
            if lane.device.type == "cuda":
                # weights and thresholds complete before any stream reads
                # them (the copies ran on this thread's current stream)
                torch.cuda.synchronize(lane.device)
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

    def _pad_rows(self, a, rows, lane):
        """Zero-pad a host array's rows to the canonical batch width and
        move it to the lane's device."""
        t = torch.as_tensor(np.ascontiguousarray(a), device=lane.device)
        if len(t) < rows:
            t = torch.cat([t, t.new_zeros((rows - len(t),) + t.shape[1:])])
        return t

    # -- canonical device passes ------------------------------------------

    def _decode_z(self, z_sym, lane=None):
        """``lane`` (:class:`_Lane`) is the replica to run on: the first
        device's when None, here and in the methods below."""
        deterministic_convs()
        model = (lane or self._lanes[0]).model
        return model.decode_z(z_sym)[1].to(torch.uint8)

    def _decode_y(self, y_sym, lane=None):
        """The decoder-canonical x_hat (v1: ``decode``)."""
        deterministic_convs()
        model = (lane or self._lanes[0]).model
        if self.is_v2:
            return model.decode_y(y_sym)
        return model.decode(y_sym)

    def _masks(self, x_hat, thr):
        """Packed 1-bit masks ``x_hat > thr`` per block: [N, B³/8]."""
        mask = x_hat[..., 0] > thr[:, None, None, None]
        return packbits(mask.reshape(mask.shape[0], -1))

    def _y_order(self, a):
        """y arrays ([..., b, b, b, C]) in the order the y string holds
        them: NDHWC, and for the channel-wise model NCDHW, so that each
        slice is one run of the string."""
        return np.moveaxis(a, -1, -4) if self.is_cw else a

    def entropy_encode_all(self, out):
        """Range-code every block's symbols → list of (y, z) strings (v1:
        (y,), coded with the factorized prior per channel)."""
        if not self.is_v2:
            y = rc.encode_batch(out["y_sym"],
                                self._channel_indexes(self.y_shape),
                                self.eb_table)
            return [(s,) for s in y]
        y = rc.encode_batch(self._y_order(out["y_sym"]),
                            self._y_order(out["y_idx"]), self.gc_table)
        z = rc.encode_batch(out["z_sym"],
                            self._channel_indexes(self.z_shape),
                            self.eb_table)
        return list(zip(y, z))

    def entropy_encode(self, out, i):
        """Range-code block ``i`` of ``out`` (:meth:`encode_blocks`' dict)
        → its tuple of strings, equal to entry ``i`` of
        :meth:`entropy_encode_all`."""
        if not self.is_v2:
            return (rc.encode(out["y_sym"][i],
                              self._channel_indexes(self.y_shape),
                              self.eb_table),)
        return (rc.encode(self._y_order(out["y_sym"][i]),
                          self._y_order(out["y_idx"][i]), self.gc_table),
                rc.encode(out["z_sym"][i],
                          self._channel_indexes(self.z_shape),
                          self.eb_table))

    @property
    def _sym_keys(self):
        """Per-block host outputs of the canonical passes."""
        return ("z_sym", "y_sym", "y_idx") if self.is_v2 else ("y_sym",)

    # -- encode ------------------------------------------------------------

    def _sweep(self, x_hat, pts, occ, opt_metrics, max_deltas, nrm=None,
               lane=None):
        """Threshold sweep of one chunk on the codec's backend: (picks
        [N, M] int32, overflow [N] bool — the bucket backend's rows to
        re-sweep, :meth:`_rerun` — or None). With normals (``nrm``) a
        non-bucket backend takes the point-based plain sweep for every
        metric set, as the JAX codec does."""
        sel = dict(opt_metrics=opt_metrics, max_deltas=max_deltas)
        if nrm is None and any(m in D2_METRICS for m in opt_metrics):
            raise ValueError("d2 opt metrics need per-point normals")
        thr = (lane or self._lanes[0]).thr_dev
        if nrm is not None and self.sweep_backend != "bucket":
            return select_thresholds_device_pts(
                occ, x_hat[..., 0], thr, pts, nrm,
                band=self.d2_band, **sel), None
        if any(m in D2_METRICS for m in opt_metrics):
            sel["nrm"] = nrm  # K3; d1 metrics alone stay on K1
        elif self.sweep_backend == "pallas":
            return select_thresholds_d1_pallas(
                occ, x_hat[..., 0], thr, pts=pts, **sel), None
        elif self.sweep_backend == "xla":
            return select_thresholds_d1_batch(
                occ, x_hat[..., 0], thr, **sel), None
        return select_thresholds_d1_bucket(
            x_hat[..., 0], pts, thr, K=self.bucket_k, **sel)

    def _rerun(self, res, pts, nrm, opt_metrics, max_deltas):
        """Re-sweep a chunk's bucket-overflowed rows (``res["overflow"]``,
        popped) at K = B³ on the kept canonical x_hat rows, on this
        codec's device, and cut their masks anew; ``res`` may lie on
        another device (the caller gathers it). Returns ``res``."""
        overflow = res.pop("overflow")
        rows = None if overflow is None else torch.nonzero(overflow).flatten()
        if rows is None or not len(rows):
            return res
        logger.info("bucket sweep overflow: re-sweeping %d block(s) at "
                    "K = B³", len(rows))
        with trace.span("codec.sweep_rerun"):
            dev = self.device
            sel = dict(opt_metrics=opt_metrics, max_deltas=max_deltas)
            if any(m in D2_METRICS for m in opt_metrics):
                sel["nrm"] = nrm[rows].to(dev)
            x_hat = res["x_hat"][rows].to(dev)
            picks = select_thresholds_d1_bucket(
                x_hat[..., 0], pts[rows].to(dev), self.thr_dev,
                K=self.block_size ** 3, **sel)[0]
            thr = self.thr_dev[picks.long()]
            rows = rows.to(res["picks"].device)
            res["picks"][rows] = picks.to(rows.device)
            for m, mask in enumerate(res["masks"]):
                mask[rows] = self._masks(x_hat, thr[:, m]).to(rows.device)
        return res

    def _chunk_offsets(self, offsets, lo, hi, device):
        """(f0, f1, [batch_blocks + 1] device offsets) of blocks lo..hi-1
        inside the flat stream; trailing padding blocks are empty."""
        f0, f1 = int(offsets[lo]), int(offsets[hi])
        offs = np.full(self.batch_blocks + 1, f1 - f0, np.int32)
        offs[:hi - lo + 1] = offsets[lo:hi + 1] - f0
        return f0, f1, torch.as_tensor(offs, device=device)

    def chunk_points(self, flat_dev, offsets, lo, hi, budget):
        """[batch_blocks, budget, 3] int32 point lists of blocks lo..hi-1
        (padding rows and blocks -1) from the packed flat device stream,
        on that stream's device."""
        f0, f1, offs = self._chunk_offsets(offsets, lo, hi, flat_dev.device)
        return unflatten_points(
            unpack_coords(flat_dev[f0:f1], self.block_size), offs,
            self.batch_blocks, budget)

    def chunk_normals(self, nrm_dev, offsets, lo, hi, budget):
        """[batch_blocks, budget, 3] f32 normals matching
        :meth:`chunk_points` (zero padding rows) from the flat [F, 3]
        device stream, on its device."""
        f0, f1, offs = self._chunk_offsets(offsets, lo, hi, nrm_dev.device)
        return unflatten_points(nrm_dev[f0:f1], offs, self.batch_blocks,
                                budget, fill=0)

    def canonical_chunk(self, pts, n_valid, lane=None):
        """One chunk's symbols and its decoder-canonical x_hat: voxelize →
        symbols → decode_z / decode_y (v1: decode). Rows past ``n_valid``
        are padding.

        :return: dict(x [N, B, B, B, 1] occupancy, y_sym, x_hat and, v2,
            z_sym, y_idx) on the device.
        """
        x = voxelize(pts, self.block_size)
        dup = (pts[..., 0] >= 0).sum(-1) - (x[..., 0] > 0).sum(dim=(1, 2, 3))
        if bool(dup.any()):
            raise ValueError("block(s) contain duplicate voxel coordinates; "
                             "dedup inputs (see cli/compress.py)")
        deterministic_convs()
        model = (lane or self._lanes[0]).model
        if self.is_cw:
            # the slice chain, padding rows' symbols zero as the decoder's
            res = model.encode_syms(x, n_valid)
            res["x_hat"] = model.decode_y(res.pop("y_hat"))
        else:
            res = model.encode_syms(x)
            # canonical decoder feed: padding rows are zero symbols, as
            # the decoder pads them
            for key in res:
                res[key][n_valid:] = 0
            if self.is_v2:
                res["y_idx"] = self._decode_z(res["z_sym"], lane)
            res["x_hat"] = self._decode_y(res["y_sym"], lane)
        res["x"] = x
        return res

    def encode_chunk(self, pts, n_valid, opt_metrics=("d1_mse",),
                     max_deltas=(np.inf,), nrm=None):
        """One canonical chunk (:meth:`canonical_chunk`) → sweep → masks.

        :param nrm: [N, P, 3] f32 per-point normals (d2 opt metrics).
        :return: dict(y_sym, x_hat, picks, occ, masks and, v2, z_sym,
            y_idx) on the device; ``occ`` and ``masks[m]`` are packed
            [N, B³/8].
        """
        res = self._dispatch_chunk(pts, n_valid, opt_metrics, max_deltas,
                                   nrm)
        return self._rerun(res, pts, nrm, opt_metrics, max_deltas)

    def _dispatch_chunk(self, pts, n_valid, opt_metrics, max_deltas, nrm,
                        lane=None):
        """:meth:`encode_chunk` up to the overflow rerun: ``res`` also
        holds ``overflow`` (see :meth:`_sweep`)."""
        res = self.canonical_chunk(pts, n_valid, lane)
        x, x_hat = res.pop("x"), res["x_hat"]
        res["picks"], res["overflow"] = self._sweep(
            x_hat, pts, x[..., 0], opt_metrics, max_deltas, nrm, lane)
        thr = (lane or self._lanes[0]).thr_dev[res["picks"].long()]
        res["masks"] = [self._masks(x_hat, thr[:, m])
                        for m in range(thr.shape[1])]
        res["occ"] = packbits((x[..., 0] > 0).reshape(len(x), -1))
        return res

    def encode_blocks(self, blocks):
        """The models' fused ``encode`` of every block, chunked at
        ``batch_blocks`` (the last chunk's points zero-padded, as JAX pads
        them) under :func:`deterministic_convs`, chunk k on lane k mod
        lanes: host arrays of the n real rows — ``y_sym``, ``x_hat`` and,
        v2, ``z_sym``, ``y_idx`` (int32). Its x_hat is the canonical one
        bit for bit: the same decode functions at the same batch width,
        and no row's convolutions read another row."""
        n = len(blocks)
        budget = max(int(2 ** np.ceil(np.log2(max(len(b) for b in blocks)))),
                     64)
        points, _ = pack_points(blocks, max_points=budget)
        sent = []
        for k, (lo, hi) in enumerate(self._chunks(n)):
            lane = self._lanes[k % len(self._lanes)]
            x = voxelize(self._pad_rows(points[lo:hi], self.batch_blocks,
                                        lane), self.block_size)
            deterministic_convs()
            sent.append((hi - lo, lane.model.encode(x)))
        return {key: np.concatenate([res[key][:m].cpu().numpy()
                                     for m, res in sent])
                for key in sent[0][1]}

    def compress_blocks_device_opt(self, blocks, binstr, points, resolution,
                                   level, opt_metrics=("d1_mse",),
                                   max_deltas=(np.inf,), with_normals=False,
                                   need_metrics=True):
        """Encoder with the on-device threshold sweep. With normals (blocks
        and ``points`` carry nx, ny, nz in columns 3:6) d2_* opt metrics
        are supported and form a second metric group.

        :param need_metrics: compute the full-cloud metrics of a group with
            a single candidate too (its selection needs none); ``False``
            leaves ``metadata[g]["metrics"]`` None there and runs no
            metric pass for it (no K2 launch for a lone d1 candidate).
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
        opt_names = [f"{m}_{d}" for d in max_deltas for m in opt_metrics]
        n_metrics = len(opt_names)
        host = {k: [] for k in self._sym_keys + ("picks",)}
        occ_chunks, mask_chunks = [], [[] for _ in range(n_metrics)]
        pts_chunks = []
        chunks = self._chunks(n)
        lanes = self._lanes
        t_device = 0.0  # the rounds: dispatch and fetch
        with trace.span("codec.encode"):
            flat, offsets = flatten_blocks(blocks)
            devices = {lane.device for lane in lanes}
            flat_dev = {d: torch.as_tensor(pack_coords(flat, size), device=d)
                        for d in devices}
            nrm_dev = None
            if with_normals:
                nrm_flat = flatten_blocks(blocks, cols=(3, 4, 5),
                                          dtype=np.float32)[0]
                check_normals(nrm_flat)  # once per cloud, on the host
                nrm_dev = {d: torch.as_tensor(nrm_flat, device=d)
                           for d in devices}
            for first in range(0, len(chunks), len(lanes)):
                # a round: one chunk a device, all dispatched before any
                # fetch
                sent = []
                with trace.span("codec.dispatch") as dispatch:
                    for lane, (lo, hi) in zip(
                            lanes, chunks[first:first + len(lanes)]):
                        pts = self.chunk_points(flat_dev[lane.device],
                                                offsets, lo, hi, budget)
                        nrm = None if nrm_dev is None else self.chunk_normals(
                            nrm_dev[lane.device], offsets, lo, hi, budget)
                        sent.append((lo, hi, pts, nrm, self._dispatch_chunk(
                            pts, hi - lo, opt_metrics, max_deltas, nrm,
                            lane)))
                with trace.span("codec.fetch") as fetch:
                    for lo, hi, pts, nrm, res in sent:
                        res = self._rerun(res, pts, nrm, opt_metrics,
                                          max_deltas)
                        for m in range(n_metrics):
                            mask_chunks[m].append(
                                res["masks"][m][:hi - lo].to(self.device))
                        occ_chunks.append(
                            res["occ"][:hi - lo].to(self.device))
                        if with_normals:
                            pts_chunks.append(pts[:hi - lo].to(self.device))
                        for key in host:
                            host[key].append(
                                res[key][:hi - lo].cpu().numpy())
                t_device += dispatch.seconds + fetch.seconds
            out = {k: np.concatenate(v) for k, v in host.items()}
            occ_cat = torch.cat(occ_chunks)
            masks = [torch.cat(c) for c in mask_chunks]

            with trace.span("codec.entropy_encode") as entropy:
                strings_list = self.entropy_encode_all(out)
            with trace.span("codec.select") as select:
                x_hat_points = [unpack_mask_coords(m.cpu().numpy(), size)
                                for m in masks]
                metadata = self._select_best_device(
                    binstr, x_hat_points, occ_cat, masks, opt_names, points,
                    resolution, level, need_metrics=need_metrics,
                    pts_dev=torch.cat(pts_chunks) if with_normals else None,
                    nrm_host=(pack_attrs(blocks, [3, 4, 5], budget)
                              if with_normals else None))
        logger.info("compress_blocks_device_opt(%d blocks): device %.2fs, "
                    "entropy %.2fs, select %.2fs", n, t_device,
                    entropy.seconds, select.seconds)
        by_metric = out["picks"].T.tolist()
        data_list = [list(zip(strings_list, by_metric[m["idx"]]))
                     for m in metadata]
        return data_list, metadata

    def _d1_full_cloud_metrics(self, occ_packed, mask_packed, origins,
                               x_hat_blocks, points, resolution):
        """Exact full-cloud D1 metrics of one candidate: halo-EDT sums on
        the device, the rare > halo outliers resolved on the host."""
        with trace.span("codec.d1_metrics"):
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
                            level, need_metrics=True, pts_dev=None,
                            nrm_host=None):
        """Best candidate variant (one per opt metric × max delta) of each
        metric group — ``d1`` by full-cloud D1 PSNR, ``d2`` by full-cloud
        D2 PSNR; its metrics feed the sidecar. A group with a single
        candidate skips the comparison; it gets its metrics only when
        ``need_metrics`` asks for them."""
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
            if len(entries) == 1:
                metrics = [metric_fn(entries[0]) if need_metrics else None]
                local = 0
            else:
                metrics = [metric_fn(i) for i in entries]
                local = int(np.argmax([m[f"{group}_psnr"] for m in metrics]))
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

    def compress_blocks(self, blocks, binstr, points, resolution, level,
                        with_normals=False, opt_metrics=("d1_mse",),
                        max_deltas=(np.inf,), fixed_threshold=False):
        """Encoder with the host threshold selection: per block, the
        KD-tree metrics of every candidate set
        (``utils/threshold.compute_optimal_thresholds``, on ``threads``
        workers), or the middle threshold everywhere with
        ``fixed_threshold``; then the best variant per metric group on host
        KD-trees (:func:`select_best_per_opt_metric`). Any opt metric
        ``validate_opt_metrics`` allows.

        The embedded masks are cut from the decoder-canonical x_hat (one
        decode at ``batch_blocks`` width, as :meth:`decompress_blocks`
        runs it), so decode is bit-exact. The host sweep reads that same
        x_hat; the JAX codec's sweep reads its fused ``encode`` x_hat,
        which can differ from its canonical one by ulps, so a pick at a
        near-tie can differ between the two packages.

        :return: (data_list, metadata) as
            :meth:`compress_blocks_device_opt` returns them.
        """
        n = len(blocks)
        size = self.block_size
        budget = max(int(2 ** np.ceil(np.log2(max(len(b) for b in blocks)))),
                     64)
        flat, offsets = flatten_blocks(blocks)
        flat_dev = torch.as_tensor(pack_coords(flat, size), device=self.device)
        host = {k: [] for k in self._sym_keys}
        mask_chunks, picks = [], []
        with (trace.span("codec.host_sweep") as sweep,
              ThreadPoolExecutor(self.threads) as pool):
            for lo, hi in self._chunks(n):
                res = self.canonical_chunk(
                    self.chunk_points(flat_dev, offsets, lo, hi, budget),
                    hi - lo)
                for key in host:
                    host[key].append(res[key][:hi - lo].cpu().numpy())
                x_hat = res["x_hat"][:hi - lo]
                xh = None if fixed_threshold else \
                    x_hat[..., 0].cpu().numpy()

                def opt_one(i, lo=lo, xh=xh):
                    block = np.asarray(blocks[lo + i])
                    return compute_optimal_thresholds(
                        block, None if xh is None else xh[i],
                        self.thresholds, resolution,
                        normals=_get_normals(block, with_normals),
                        opt_metrics=opt_metrics, max_deltas=max_deltas,
                        fixed_threshold=fixed_threshold)

                results = list(pool.map(opt_one, range(hi - lo)))
                opt_names = results[0][0]
                chunk_picks = np.array([r[1] for r in results], np.int64)
                picks.append(chunk_picks)
                thr = self.thr_dev[torch.as_tensor(chunk_picks,
                                                   device=self.device)]
                mask_chunks.append(torch.stack(
                    [self._masks(x_hat, thr[:, m])
                     for m in range(thr.shape[1])], dim=1).cpu())
            out = {k: np.concatenate(v) for k, v in host.items()}
        with trace.span("codec.entropy_encode") as entropy:
            strings_list = self.entropy_encode_all(out)
        with trace.span("codec.select") as select:
            packed = torch.cat(mask_chunks).numpy()  # [n, metrics, B³/8]
            x_hat_points = [unpack_mask_coords(np.ascontiguousarray(
                packed[:, m]), size) for m in range(packed.shape[1])]
            metadata = select_best_per_opt_metric(
                binstr, x_hat_points, level, opt_names, points, resolution,
                with_normals)
        logger.info("compress_blocks(%d blocks, fixed_threshold=%s): device "
                    "+ host sweep %.2fs, entropy %.2fs, select %.2fs", n,
                    fixed_threshold, sweep.seconds, entropy.seconds,
                    select.seconds)
        by_metric = np.concatenate(picks).T.tolist()
        data_list = [list(zip(strings_list, by_metric[m["idx"]]))
                     for m in metadata]
        return data_list, metadata

    # -- decode ------------------------------------------------------------

    def _round_robin(self, n, fn):
        """``fn(lane, lo, hi)`` on every chunk of ``n`` blocks, chunk k on
        lane k mod lanes, all dispatched before the first is fetched:
        host (numpy) results in chunk order."""
        lanes = self._lanes
        outs = [fn(lanes[k % len(lanes)], lo, hi)
                for k, (lo, hi) in enumerate(self._chunks(n))]
        return [o.cpu().numpy() for o in outs]

    def decompress_blocks(self, payload, return_debug=False):
        """payload: [(strings, threshold_idx), ...] → decoded point blocks.

        Thresholding and bit-packing run on the device; only 1-bit masks
        come back to the host. ``return_debug`` also returns the decoder's
        half of the ``--debug`` harness: dict(y_sym, packed_masks [n,
        B³/8] and, v2, z_sym, y_idx).
        """
        n = len(payload)
        bs = self.batch_blocks
        thr = np.array([self.thresholds[t] for _, t in payload], np.float32)
        if self.is_cw:
            return self._decompress_cw(payload, thr, return_debug)
        t_z = t_dz = 0.0  # v1: no z string, no decode_z
        with trace.span("codec.decode"):
            if self.is_v2:
                with trace.span("codec.z_rans") as z_rans:
                    z_syms = rc.decode_batch(
                        [p[0][1] for p in payload],
                        self._channel_indexes(self.z_shape), self.eb_table,
                        per_stream=False)
                with trace.span("codec.decode_z") as decode_z:
                    y_idx = np.concatenate(self._round_robin(
                        n, lambda lane, lo, hi: self._decode_z(
                            self._pad_rows(z_syms[lo:hi], bs, lane),
                            lane)[:hi - lo]))
                t_z, t_dz = z_rans.seconds, decode_z.seconds
                with trace.span("codec.y_rans") as y_rans:
                    y_syms = rc.decode_batch([p[0][0] for p in payload],
                                             y_idx, self.gc_table,
                                             per_stream=True)
            else:
                with trace.span("codec.y_rans") as y_rans:
                    y_syms = rc.decode_batch(
                        [p[0][0] for p in payload],
                        self._channel_indexes(self.y_shape), self.eb_table,
                        per_stream=False)
            with trace.span("codec.decode_y") as decode_y:
                masks = self._round_robin(n, lambda lane, lo, hi: self._masks(
                    self._decode_y(self._pad_rows(y_syms[lo:hi], bs, lane),
                                   lane),
                    self._pad_rows(thr[lo:hi], bs, lane))[:hi - lo])
            with trace.span("codec.unpack") as unpack:
                masks = np.concatenate(masks)
                blocks = unpack_mask_coords(masks, self.block_size)
        logger.info("decompress_blocks(%d blocks): z rANS %.3fs, decode_z "
                    "%.3fs, y rANS %.3fs, decode_y+masks %.3fs, unpack "
                    "%.3fs", n, t_z, t_dz, y_rans.seconds, decode_y.seconds,
                    unpack.seconds)
        if not return_debug:
            return blocks
        debug = {"y_sym": y_syms, "packed_masks": masks}
        if self.is_v2:
            debug.update(z_sym=z_syms, y_idx=y_idx)
        return blocks, debug

    def _decompress_cw(self, payload, thr, return_debug):
        """:meth:`decompress_blocks` of the channel-wise model: z, then
        per slice and chunk (chunk k on lane k mod lanes) μ and the σ rows
        on the device, the rows to the host, the range decode of the
        chunk's blocks' slice (one resumable decoder over the cloud's y
        strings), ŷ on the device; last the synthesis of every chunk."""
        n, bs = len(payload), self.batch_blocks
        chunks = self._chunks(n)
        lanes = [self._lanes[k % len(self._lanes)]
                 for k in range(len(chunks))]
        slices = self.model.num_slices
        with trace.span("codec.decode"):
            with trace.span("codec.z_rans") as z_rans:
                z_syms = rc.decode_batch(
                    [p[0][1] for p in payload],
                    self._channel_indexes(self.z_shape), self.eb_table,
                    per_stream=False)
            with trace.span("codec.decode_z") as decode_z:
                deterministic_convs()
                hypers = [lane.model.decode_hyper(
                    self._pad_rows(z_syms[lo:hi], bs, lane))
                    for lane, (lo, hi) in zip(lanes, chunks)]
            dec = rc.BatchDecoder([p[0][0] for p in payload], self.gc_table)
            y_hats = [[] for _ in chunks]
            syms = [[] for _ in chunks]
            idxs = [[] for _ in chunks]
            t_params = t_rans = t_lrp = 0.0
            for k in range(slices):
                with trace.span("codec.slice_params") as params:
                    # every chunk's μ and rows dispatched before any fetch
                    sent = [lane.model.slice_params(hyper, y_hat, k)
                            for lane, hyper, y_hat in zip(lanes, hypers,
                                                          y_hats)]
                t_params += params.seconds
                for c, (lane, (lo, hi)) in enumerate(zip(lanes, chunks)):
                    mu, idx = sent[c]
                    with trace.span("codec.slice_params") as params:
                        idx = idx[:hi - lo].cpu().numpy()
                    with trace.span("codec.slice_rans") as rans:
                        sym = dec.decode(idx.reshape(hi - lo, -1), lo,
                                         hi).reshape(idx.shape)
                    with trace.span("codec.slice_lrp") as lrp:
                        y_hats[c].append(lane.model.slice_lrp(
                            hypers[c], y_hats[c], k, mu,
                            self._pad_rows(sym, bs, lane)))
                    t_params += params.seconds
                    t_rans += rans.seconds
                    t_lrp += lrp.seconds
                    syms[c].append(sym)
                    idxs[c].append(idx)
                trace.count("slices.decoded", len(chunks))
            with trace.span("codec.decode_y") as decode_y:
                masks = [self._masks(
                    lane.model.decode_y(torch.cat(y_hat, 1)),
                    self._pad_rows(thr[lo:hi], bs, lane))[:hi - lo]
                    for lane, y_hat, (lo, hi) in zip(lanes, y_hats, chunks)]
                masks = [m.cpu().numpy() for m in masks]
            with trace.span("codec.unpack") as unpack:
                masks = np.concatenate(masks)
                blocks = unpack_mask_coords(masks, self.block_size)
        logger.info("decompress_blocks_cw(%d blocks): z rANS %.3fs, "
                    "decode_z %.3fs, slice params %.3fs, slice rANS %.3fs, "
                    "slice lrp %.3fs, decode_y+masks %.3fs, unpack %.3fs",
                    n, z_rans.seconds, decode_z.seconds, t_params, t_rans,
                    t_lrp, decode_y.seconds, unpack.seconds)
        if not return_debug:
            return blocks

        def ndhwc(parts):
            return np.moveaxis(np.concatenate(
                [np.concatenate(p, 1) for p in parts]), 1, -1)

        return blocks, {"y_sym": ndhwc(syms), "packed_masks": masks,
                        "z_sym": z_syms, "y_idx": ndhwc(idxs)}
