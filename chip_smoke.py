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
   launched, ``conv_one_out`` once a chunk in the encoder's canonical
   decode and once in the decoder's, and ``conv_fwd`` ``FWD_A_CHUNK``
   times a chunk in each.
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
15. Training (``training.Trainer``), c3p at full width (64 filters, 64³
   blocks, f32 without TF32), warm-started from ``bench_c3p.msgpack.gz``,
   on the cloud's blocks as a ``BlockDataset`` (the last 10% of blocks the
   validation set): one step's loss and every parameter's gradient on the
   card against the CPU on the same 4 blocks and noise (loss within 1e-5
   relative, each gradient leaf within 1e-3 of its largest |g|, the CPU
   replaying the card's ReLU gates: ``ReluGates``);
   ``fit_blocks`` for 20 steps at batch 32, every loss finite, the log
   written, ``conv_wgrad`` launched once a routed layer a step and no
   other kernel, s a step and blocks/s over the warm steps, the peak
   memory; a new trainer on the directory resumes with
   params and Adam state equal bit for bit, and 5 steps of it equal 5
   steps of the first, bit for bit, under
   ``torch.use_deterministic_algorithms(True)``; 3 steps under
   ``torch.profiler`` (device busy share, convolutions against everything
   else); ``conv_one_out`` launches only in the val pass, which records no
   graph; then ``save_asset`` of the trained weights, read back by
   ``cli.common.load_params``, through the d1 path on the whole cloud:
   bit-exact, encoder D1 PSNR equal to the host KD-tree's, K1 and K2
   launched.
16. The benchmark driver. K1 first against its plain version at the
   bench's first 128-block chunk (bf16 c3p on the same cloud: K1 ran at 32
   blocks a chunk before). Then ``python -m pcc_geo_cnn_v2_tpu_torch.bench``
   as a subprocess at its defaults (8 held-out clouds, c3p in bf16, batch
   128, the bucket sweep, d1) with ``BENCH_PIPELINE=3`` and ``=1``: each
   run's JSON line, encode / decode seconds, bpp, peak memory and launches
   (K1 and K2 only) printed; the two runs' streams equal byte for byte (the
   bench's SHA-256 of every stream). Then 2 clouds with
   ``BENCH_OPT_METRICS=d1_mse,d2_mse`` (K3 and K2, not K1) and with
   ``BENCH_CONV_BACKEND=pallas`` (K4a, K4b, K1, K2). Every bench run
   decodes every group bit-exactly or fails.
17. Blocks round-robin over devices: ``BlockCodec(devices=...)`` over two
   c3p replicas on the card (or over the cards, where there are several) on
   the cloud of phase 6: stream bytes, decoded points and launches equal
   phase 6's.
18. Data-parallel training (``Trainer(group=...)``, ``parallel/mesh.py``),
   c3p at full width and batch 32: at world 1 on ``nccl``, one step under
   ``torch.use_deterministic_algorithms(True)`` bit-equal (parameters and
   logs) to the trainer without a group, ``conv_wgrad`` once a routed
   layer a step and no other kernel; then 2 processes on the one card
   over ``gloo`` with CUDA tensors (NCCL takes one rank a card), 3 steps at
   the global batch 32: the ranks' parameters bit-identical after every step,
   each loss within 1e-4 relative of the single process's.
19. Spatial (sp) sharding (``parallel/spatial.py``), c3p at full width in
   f32 on the most populated 256³ cell of the cloud (octree level 2, 64
   blocks of 64³ in one block): the unsharded ``encode_syms`` /
   ``decode_y`` on the card; at world 1 on ``nccl`` the sharded encode and
   decode bit-equal to them (zero halos: the same convs), no kernel
   launched but ``conv_one_out`` (the synthesis' last layer, as
   unsharded); then 2 processes on the one card over ``gloo`` (halos staged
   through the host): under 5e-4 of the symbols differ from the unsharded
   ones, and the rANS round trip — the symbols coded to bytes, decoded
   from the bytes alone with ``decode_z`` unsharded, y decoded sharded —
   gives the decoder an x_hat bit-equal to the encoder's and an equal mask
   at 0.51. Each rank's peak memory, wall and device ms of the encode and
   the decode are printed beside the unsharded ones. Then
   ``dryrun.dryrun_multichip(4)``: one data-parallel c3p step and the
   sp-sharded encode of a 64³ block, over four gloo ranks on the card.
20. The RD experiment pipeline (``cli/tr_train_all``, ``cli/ev_experiment``,
   ``cli/ev_run_experiment``, ``cli/decompress``, ``cli/mp_run``,
   ``cli/ev_compare.load_curves``, ``utils/bd``) on the 10-bit
   ``figure_cloud(200)`` (tools/rd_eval.py's first evaluation cloud) at
   octree level 4, the d1 group, c3p at 64 filters. The train sweep: model
   config ``c3p-train``, λ 1e-4 and 3e-4 in warm_seq (the first run resumed
   from a ``ckpt_0`` of the committed 1e-4 weights), a few steps each at
   64³ blocks of the cloud, two ``cli.train`` children: both ``done``, the
   second started with ``--warm_start`` of the first, a second call starts
   no child. The experiments over the committed ``c3p-a0.75`` ladder (five
   λ, symlinked assets) and ``c3p-train``: the first ladder λ in this
   process, counted (K1 launched, K2 one call, K3 / K4a / K4b / K5 not),
   the other six as ``ev_experiment`` children two at a time on the card;
   seven ``report_d1.json`` with the JAX package's keys (each child holds
   its encoder-side D1 PSNR within 0.01 dB of the host KD-tree's), a
   second call starts no child. Every stream decoded in this process by
   ``cli/decompress`` equals its ``.dec.ply``. The built-in octree anchor
   (``mp_run --tmc3 builtin``) at rd_eval's eight scales, each stream
   decoded by ``anchor_decode`` equal to mp_run's PLY. The ladder's bpp and
   D1 PSNR fall as λ falls; its BD-rate against the anchor is finite and
   negative. The points are printed beside the JAX package's committed
   rows for the cloud (``results/rd_c3p_a075.json``), with each stage's
   wall seconds and the card.
21. The RD evaluation tools (``pcc_geo_cnn_v2_tpu_torch/tools``), c3p at 64
   filters: ``rd_eval --from-assets --d2_group`` on the committed
   c3p-a0.75 ladder (five λ, 1024, level 4) on ``figure_cloud(200)``,
   counted (K3 and K2; K1, K4a, K4b, K5 not); every row held
   against the same (λ, cloud, group) row of JAX's
   ``results/rd_c3p_a075.json`` (d1 group: bpp within 0.5%, D1 PSNR of
   the encoder and of the host within 0.05 dB; d2 group: bpp within 1%,
   host D2 PSNR no more than 0.1 dB below JAX's, see ``RD21_BOUNDS``), the
   anchor rows equal, BD against the anchor within 1 point and 0.1 dB of
   the BD of JAX's rows of the same clouds (the d2 one one-sided); the d1
   group on λ 1e-4, cloud 200, from an asset root holding that λ alone
   (K1 and K2); the c1 rung ``--config c1 --fixed_threshold`` on cloud 200
   against ``results/rd_c1_fixedthr.json`` (bpp within 0.5%, D1 PSNR
   within 0.1 dB, ``RD21_FIXED_BOUNDS``; no kernel); ``rd_ladder`` over
   the two reports, its BD-PSNR of both rungs within 0.1 dB of the same
   ladder over JAX's rows; then ``train_sweep`` cut in depth (two λ
   warm-seq, one 50-step ``K_INNER`` call each at batch 8, blocks of two
   clouds; ``conv_wgrad`` alone in a step), ``export_rd_assets`` of it
   (the assets reload equal to the trained params) and
   ``assets_to_ckpt`` of one committed λ (the checkpoint's params equal
   the asset's). Stage walls and the rows
   beside JAX's are printed.
22. The CLIs' ``--debug`` harness, counted, on the cloud of phase 6
   written as a PLY without normals: ``cli.compress.main([..., "--debug"])``
   (c3p, the committed weights, ``batch_blocks`` 32; K1 and K2 launched as
   on phase 6, the other kernels not), then ``cli.decompress.main([...,
   "--debug"])``, whose check of the decoded ``y_sym`` / ``z_sym`` against
   the encoder's dump passes. The stream's payload bytes equal phase 6's,
   the decoded PLY equals phase 6's decoded cloud, and the dump's x_hat
   (the fused ``encode``) equals the canonical x_hat of every chunk bit for
   bit; the launches are phase 6's, and ``conv_one_out`` once more a chunk
   and ``conv_fwd`` ``FWD_A_CHUNK`` times more a chunk (the dump's
   encode).
23. ``conv_one_out`` (``csrc/conv_one_out.cu``: the synthesis transforms'
   last layer, one output channel) at c2's k9 stride-2 32 -> 1
   (``ConvTranspose_2``, the committed ``rd/c2/2.00e-04`` weights) and
   c3p's k3 stride-1 16 -> 1 (``ConvTranspose_0``), on the activations
   entering each layer in the canonical decode of the cloud's first 128
   blocks: the kernel against the layer's cuDNN form (within
   ``ONE_OUT_TOL`` of the largest |value|) and against its plain version
   on 7 blocks; the module's no-graph call equal to the kernel's; every
   block's output bit-equal alone, in 7-block calls, moved 37 places in
   the batch and over two calls; the median ms of a 128-block call (bursts
   of four) beside the cuDNN form's (``library_ms``) and the bound.
24. ``conv_wgrad`` (``csrc/conv_wgrad.cu``: the weight gradient of the
   stride-1 k3 convolutions in training) at c3p's routed layers
   (``WGRAD_LAYERS``: 16 -> 16 at 64^3 and 32^3, 32 -> 32 at 32^3 and
   16^3, 16 -> 1 at 64^3) at batch 32 on seeded random inputs: the
   kernel against its plain version in f32 and in f64 (within
   ``WGRAD_TOL`` of the largest |value|) and ``torch.nn.grad.
   conv3d_weight`` (``WGRAD_LIB_TOL``), two calls bit-equal; its
   median ms (bursts of four) beside the bound, ``conv3d_weight``'s time
   (``library_ms``) and cuDNN's deterministic weight gradient in NCDHW and
   channels-last; every shape on ragged volumes (``WGRAD_RAGGED``: odd W
   and W % 4 == 2 take the narrower copies) against the f64 sum. Then a
   ``Trainer.step_blocks`` from one state twice (c3p, batch 32, under
   ``torch.use_deterministic_algorithms(True)``):
   parameters bit-equal, ``conv_wgrad`` launched once a routed layer a
   step and no other kernel (``conv_fwd`` and ``conv_one_out`` 0); and 0
   times in an encode and decode of the cut.
25. ``conv_fwd`` (``csrc/conv_fwd.cu``: the codec's stride-1 k3 synthesis
   tails, 16 -> 16 at 64^3 and 32 -> 32 at 32^3) on the activations
   entering each routed layer in a ``decode_y`` of the cloud's first 128
   blocks (the benchmark's chunk; the committed c3p weights): launched
   ``FWD_A_CHUNK`` times in that ``decode_y``; each layer's kernel against
   ``F.conv3d`` of the padded input (cuDNN under ``deterministic_convs``:
   bit-equal, or within ``FWD_TOL`` of the largest |value|), its fused ReLU
   exact, the module's no-graph call equal to the kernel's, the plain
   version on 2 blocks; every block's output bit-equal alone, in 7-block
   calls, moved 37 places in the batch and over two calls; the median ms
   of a 128-block call (bursts of four) beside cuDNN's path (pad, conv +
   bias, ReLU: ``library_ms``) and the bound. Then the encoder's
   ``canonical_chunk`` x_hat equal to the decoder's ``decode_y`` of its
   symbols bit for bit with the route on, and whether both equal x_hat
   with the layers on cuDNN (the route off).

The launch counts are set to 0 just before each path and read just after
(for the bench, inside its process, around its timed window; for phase 20,
around its in-process experiment; for phase 21, around each rd_eval
run). Phases 12-25 print their seconds.
Prints a ``kernels`` JSON line (per kernel: launches on its path and on
every path, max error against the plain version, its median time (K1,
K2, K3, K4 and K5 per call in bursts of four calls, so that the wrapper's
host time overlaps the kernels), the plain time, the least time the card could take for the
same work and the share of it reached (K1 and K3 at the chunk and the
rerun, K2, K4, K5), the CUDA launches of one call (K2, K3, K5) and, for K4, the
cuDNN chain's time and ms / library; for ``conv_one_out`` its rows of
phase 23, for ``conv_wgrad`` those of phase 24, for ``conv_fwd`` those of
phase 25), the card line, and last
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

from pcc_geo_cnn_v2_tpu_torch.utils.trace import PREFIX as SPAN_PREFIX

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
# phase 23: conv_one_out on the activations of the cloud's first
# ONE_OUT_BLOCKS blocks (the benchmark's chunk), held against the layer's
# cuDNN form within ONE_OUT_TOL of the output's largest |value| (both sum
# ~3,000 f32 products a voxel at k9, in other orders)
ONE_OUT_BLOCKS, ONE_OUT_TOL = 128, 1e-5
# phase 25: conv_fwd on the activations entering the stride-1 k3 synthesis
# layers it routes in a decode_y of the cloud's first FWD_BLOCKS blocks
# (the benchmark's chunk), FWD_A_CHUNK of them (16 -> 16 at 64^3 and 32 ->
# 32 at 32^3, twice each); held against the layer's cuDNN form within
# FWD_TOL of the output's largest |value| (equal bit for bit where cuDNN
# sums in the kernel's order)
FWD_BLOCKS, FWD_A_CHUNK, FWD_TOL = 128, 4, 1e-5
# kernels that run only in passes that record no autograd graph: a
# training step launches none of them, its validation passes may
NO_GRAD_KERNELS = ("conv_one_out", "conv_fwd")
# kernels that run only in training steps (weight gradients): a codec pass
# launches none of them
TRAIN_KERNELS = ("conv_wgrad",)
# phase 24: conv_wgrad at c3p's routed layers at batch BATCH on seeded
# random inputs — (label, cin, cout, edge) — held against its plain version
# in f32 (the same split) and in f64 (the exact sum) within WGRAD_TOL of
# the largest |value|, and against torch.nn.grad.conv3d_weight within
# WGRAD_LIB_TOL: cuDNN sums the 0.26-8.4 M products an entry in its own
# order, and at 32 -> 32 at 16^3 read 1.1e-5 of the largest value from the
# kernel while the kernel was 5.2e-7 from the plain version
WGRAD_LAYERS = (("synthesis block 2", 16, 16, 64),
                ("analysis block 0", 16, 16, 32),
                ("synthesis block 1", 32, 32, 32),
                ("analysis block 1", 32, 32, 16),
                ("synthesis last layer", 16, 1, 64))
WGRAD_TOL, WGRAD_LIB_TOL = 1e-5, 1e-4
WGRAD_RAGGED = ((13, 10, 23), (12, 9, 30))  # odd W; W % 4 == 2
# phase 15: training c3p at batch BATCH (the JAX default of 32); the card's
# step against the CPU's on PARITY_BLOCKS blocks, loss within 1e-5
# relative, every gradient leaf within 1e-3 of its largest |g| (cuDNN and
# oneDNN sum the conv products in other orders; the CPU replays the card's
# ReLU gates, see ReluGates)
TRAIN_STEPS, RESUME_STEPS, PROFILE_STEPS, PARITY_BLOCKS = 20, 5, 3, 4
TRAIN_LOSS_REL, TRAIN_GRAD_TOL = 1e-5, 1e-3
# device kernels of the convolutions and their gradients (cuDNN, CUTLASS-
# style xmma, implicit gemm), as the profile tool's family
CONV_KEYS = ("conv", "cudnn", "sm90_xmma", "implicit", "gemm", "wgrad",
             "dgrad", "fprop")


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


def profiled(call, tries=3):
    """``key_averages()`` of one ``call()`` under torch.profiler (CUDA
    activity). A window in which the profiler recorded no device time at
    all is a dropped reading, not a result (on the H100 machines CUPTI has
    lost a short window's records): it is taken again, up to ``tries``
    times, and then raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        evts = prof.key_averages()
        if any(device_us(e) > 0 for e in evts):
            return evts
    raise RuntimeError(f"the profiler recorded no device time in {tries} "
                       f"windows")


def device_work(call):
    """(device operations, device ms) of one call under torch.profiler:
    every kernel, copy and fill that took device time."""
    evts = [e for e in profiled(call) if device_us(e) > 0]
    return sum(e.count for e in evts), sum(device_us(e) for e in evts) / 1e3


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
    return sum(e.count for e in profiled(call)
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


def check_k5(codec, pts, x_hat, bucket):
    """Phase 5: K5 vs its plain version on one canonical chunk, and its
    picks vs the bucket backend's (``bucket``: the codec's picks of the
    chunk, with its rerun at K = B³ for overflowed rows)."""
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
    # picks: the exact sweep against the bucket backend
    picks = select_thresholds_d1_pallas(occ, xh, thr, pts=pts)
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
        prior = getattr(m, "conditional", m.entropy_bottleneck)
        syn = m.synthesis_t
        h = prior.dequantize_symbols(y_sym).permute(0, 4, 1, 2, 3)
        h = F.relu(syn.ConvTranspose_1(F.relu(syn.ConvTranspose_0(
            h.contiguous()))))
        xc = x.permute(0, 4, 1, 2, 3).contiguous()
        return (time_ms(lambda: m.analysis_t.Conv_0(xc), 5),
                time_ms(lambda: syn.ConvTranspose_2(h), 5),
                time_ms(lambda: m.decode_y(y_sym), 3))


def host_d1_mse(block, x_hat, t):
    """Host KD-tree d1_mse of one block's candidate ``x_hat > t`` (the
    host sweep's own comparison)."""
    from pcc_geo_cnn_v2_tpu_torch.utils.metrics import compute_metrics

    cand = np.argwhere(x_hat > t).astype(np.float64)
    return compute_metrics(block[:, :3], cand, RESOLUTION - 1)["d1_mse"]


def device_us(evt):
    """Device µs of a profiler event; 0 for the port's span annotations
    (``utils/trace``: a ``pcc.`` range also appears on the device's
    timeline), which are not device work."""
    if evt.key.startswith(SPAN_PREFIX):
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile_steps(fn, n):
    """``fn(i)`` for i < n under ``torch.profiler``: (wall s, device-busy
    ms, convolution ms) — kernels run on one stream, so busy = the sum of
    the kernels' device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
        wall = time.time() - t0
    kern = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA
            and device_us(e) > 0]
    assert kern, "the profiler recorded no device kernels"
    busy = sum(device_us(e) for e in kern) / 1e3
    conv = sum(device_us(e) for e in kern
               if any(k in e.key.lower() for k in CONV_KEYS)) / 1e3
    return wall, busy, conv


class ReluGates:
    """``F.relu`` of the port's transforms, recording each call's gate
    (x > 0) in call order, or replaying recorded gates as ``x * gate``.

    A ReLU is discontinuous in its gradient at 0: where f32 rounding puts a
    pre-activation on the other side of 0 on one device, the whole upstream
    gradient of that element passes on one side and not on the other. At c3p
    on 4 blocks of 64³ that happens a few times a step; on the card it
    moved one leaf's gradient by 4.2e-3 of its largest |g| against an f64
    run, with every other leaf within 8.3e-4 (PERF.md §6, training). The
    parity step replays the card's gates on the CPU, so that the two
    gradients compare arithmetic, and counts the gates the CPU's own
    forward would have set otherwise."""

    def __init__(self):
        self.gates, self.replay, self.flips = [], None, 0

    def __call__(self, x):
        import torch

        if self.replay is None:
            self.gates.append((x > 0).cpu())
            return torch.relu(x)
        gate = self.gates[self.replay].to(x.device)
        self.replay += 1
        self.flips += int(((x > 0) != gate).sum())
        return x * gate.to(x.dtype)

    def patch(self):
        """Context manager: the transforms' ``F`` with this ``relu``."""
        import contextlib

        import torch.nn.functional as F

        from pcc_geo_cnn_v2_tpu_torch.models import transforms

        class Functional:
            relu = self

            def __getattr__(_, name):
                return getattr(F, name)

        @contextlib.contextmanager
        def patched():
            transforms.F = Functional()
            try:
                yield self
            finally:
                transforms.F = F

        return patched()


def train_parity(state, pts, noise, cfg, device):
    """c3p's loss and every parameter's gradient for one batch, on
    ``device`` and on the CPU, from the same weights and noise; the CPU
    step replays the card's ReLU gates (:class:`ReluGates`). Returns the
    two losses, the worst leaf's error over its largest |g|, the gates the
    CPU would have set otherwise, and the worst leaf without the replay."""
    from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
    from pcc_geo_cnn_v2_tpu_torch.training import make_loss_fn

    def step(dev):
        model = build_model("c3p").to(dev)
        model.load_state_dict(state)
        total, _ = make_loss_fn(model, cfg)(
            pts.to(dev), {k: v.to(dev) for k, v in noise.items()})
        total.backward()
        return (float(total.detach()),
                {n: p.grad.cpu() for n, p in model.named_parameters()})

    def worst(a, b):
        return max(float((a[n] - g).abs().max())
                   / max(float(g.abs().max()), 1e-30) for n, g in b.items())

    gates = ReluGates()
    with gates.patch():
        loss, grads = step(device)
        gates.replay = 0
        loss_cpu, grads_cpu = step("cpu")
    free = worst(grads, step("cpu")[1])
    assert abs(loss - loss_cpu) <= TRAIN_LOSS_REL * abs(loss_cpu), \
        (loss, loss_cpu)
    for name, g in grads_cpu.items():
        err = float((grads[name] - g).abs().max())
        scale = float(g.abs().max())
        assert err <= TRAIN_GRAD_TOL * scale, (name, err, scale)
    return loss, loss_cpu, worst(grads, grads_cpu), gates.flips, free


def check_training(device, blocks, params, drive, expect_launches, points,
                   psnr_d1):
    """Phase 15: c3p trained at full width from the committed weights; the
    card's step against the CPU's, ``fit_blocks``, a bit-equal resume, and
    the export encoded through K1 and K2. Returns the export path's
    launch counts."""
    import tempfile

    import torch

    from pcc_geo_cnn_v2_tpu_torch.cli.common import load_params
    from pcc_geo_cnn_v2_tpu_torch.codec import BlockCodec, deterministic_convs
    from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
    from pcc_geo_cnn_v2_tpu_torch.ops import kernels
    from pcc_geo_cnn_v2_tpu_torch.training import (
        TrainConfig,
        Trainer,
        draw_noise,
    )
    from pcc_geo_cnn_v2_tpu_torch.utils.data import BlockDataset
    from pcc_geo_cnn_v2_tpu_torch.weights import (
        params_from_jax,
        params_to_jax,
        save_asset,
    )

    t_phase = time.time()
    n_val = max(int(len(blocks) * 0.1), 1)
    train_ds = BlockDataset(blocks[:-n_val])
    val_ds = BlockDataset(blocks[-n_val:], max_points=train_ds.max_points)
    cfg = TrainConfig(batch_size=BATCH, block_size=BLOCK,
                      max_steps=TRAIN_STEPS, val_every=TRAIN_STEPS,
                      val_batches=1, log_every=1)

    # 1. one step on the card against the port on the CPU, in f32 without
    # TF32, as the trainer sets it
    deterministic_convs()
    t0 = time.time()
    pts = torch.as_tensor(train_ds._pack(np.arange(PARITY_BLOCKS)))
    probe = build_model("c3p")
    noise = draw_noise(probe, PARITY_BLOCKS, BLOCK,
                       torch.Generator().manual_seed(1))
    loss, loss_cpu, worst, flips, free = train_parity(
        params_from_jax(params), pts, noise, cfg, device)
    log(f"training step parity, c3p on {PARITY_BLOCKS} blocks of {BLOCK}^3: "
        f"loss {loss!r} on the card, {loss_cpu!r} on the CPU "
        f"({abs(loss - loss_cpu) / abs(loss_cpu):.2e} relative); worst "
        f"gradient leaf {worst:.2e} of its largest |g| with the card's ReLU "
        f"gates replayed on the CPU ({flips} gates of the CPU's own forward "
        f"differ; without the replay the worst leaf is {free:.2e}) "
        f"({time.time() - t0:.1f} s)")

    with tempfile.TemporaryDirectory() as tmp:
        run_dir, asset = Path(tmp) / "run", Path(tmp) / "trained.msgpack.gz"
        # 2. fit_blocks, full width, batch 32, warm-started from the asset
        trainer = Trainer(build_model("c3p"), cfg, run_dir, seed=0,
                          warm_start=ASSET, device=device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.time()
        best = trainer.fit_blocks(train_ds, val_ds)
        torch.cuda.synchronize()
        t_fit = time.time() - t0
        peak = torch.cuda.max_memory_allocated()
        counts_fit = dict(kernels.launches)
        assert not any(v for k, v in counts_fit.items()
                       if k not in NO_GRAD_KERNELS + TRAIN_KERNELS), \
            counts_fit
        routed = routed_wgrad_layers(trainer.model)
        assert counts_fit["conv_wgrad"] == TRAIN_STEPS * len(routed), \
            (counts_fit, routed)
        records = [json.loads(line) for line in
                   (run_dir / "train_log.jsonl").read_text().splitlines()]
        train = [r for r in records if r["split"] == "train"]
        assert [r["step"] for r in train] == list(range(1, TRAIN_STEPS + 1))
        assert all(np.isfinite(r["loss"]) and np.isfinite(r["aux_loss"])
                   for r in train) and np.isfinite(best), records
        warm = [1.0 / r["steps_per_sec"] for r in train[2:]]
        s_step = float(np.median(warm))

        # 3. resume: a new trainer on the directory restores the saved step
        # bit for bit; then RESUME_STEPS steps of it equal the same steps of
        # the trainer that went straight on, bit for bit
        t0 = time.time()
        resumed = Trainer(build_model("c3p"), cfg, run_dir, seed=0,
                          device=device)
        assert resumed.start_step == TRAIN_STEPS, resumed.start_step

        def assert_equal_states():
            for k, v in trainer.model.state_dict().items():
                assert torch.equal(v, resumed.model.state_dict()[k]), k
            sa, sb = (t.opt.state_dict()["state"] for t in (trainer, resumed))
            for i in sa:
                for key in sa[i]:
                    assert torch.equal(sa[i][key], sb[i][key]), (i, key)

        assert_equal_states()
        data = trainer.device_data(train_ds)
        torch.use_deterministic_algorithms(True)
        try:
            for t in (trainer, resumed):
                for step in range(TRAIN_STEPS + 1,
                                  TRAIN_STEPS + 1 + RESUME_STEPS):
                    t.step_blocks(data, step)
            assert_equal_states()
        finally:
            torch.use_deterministic_algorithms(False)
        log(f"resume: a new trainer on the directory restores step "
            f"{TRAIN_STEPS} with params and Adam state equal bit for bit; "
            f"{RESUME_STEPS} more steps equal the straight run's bit for bit "
            f"under torch.use_deterministic_algorithms(True) "
            f"({time.time() - t0:.1f} s)")
        del resumed

        step0 = TRAIN_STEPS + RESUME_STEPS + 1
        wall, busy, conv = profile_steps(
            lambda i: trainer.step_blocks(data, step0 + i), PROFILE_STEPS)
        log(f"training c3p (64 filters, {BLOCK}^3, f32, batch {BATCH}, "
            f"{len(train_ds)} train / {len(val_ds)} val blocks): "
            f"{TRAIN_STEPS} steps in {t_fit:.2f} s with the val pass, every "
            f"loss finite (first {train[0]['loss']:.5f}, last "
            f"{train[-1]['loss']:.5f}, val {best:.5f}); warm steps "
            f"{s_step:.4f} s a step (min {min(warm):.4f}, max "
            f"{max(warm):.4f}), {BATCH / s_step:.2f} blocks/s; peak memory "
            f"{peak / 2**30:.3f} GiB; {PROFILE_STEPS} steps under the "
            f"profiler: {wall:.3f} s wall, device busy {busy:.1f} ms "
            f"({100 * busy / 1e3 / wall:.1f}%, idle "
            f"{100 - 100 * busy / 1e3 / wall:.1f}%), convolutions "
            f"{conv:.1f} ms ({100 * conv / busy:.1f}% of device time), "
            f"everything else {busy - conv:.1f} ms; conv_wgrad "
            f"{counts_fit['conv_wgrad']} times ({len(routed)} a step, once a "
            f"routed layer), no other kernel in a step, conv_one_out "
            f"{counts_fit['conv_one_out']} and conv_fwd "
            f"{counts_fit['conv_fwd']} times in the val pass")

        # 4. export, read back, encode the whole cloud through K1 and K2
        tree = params_to_jax(trainer.model.state_dict())
        save_asset(tree, asset)
        back = load_params(asset)
        for k, v in params_from_jax(tree).items():
            assert torch.equal(v, params_from_jax(back)[k]), k
        codec_t = BlockCodec(build_model("c3p"), back, block_size=BLOCK,
                             batch_blocks=BATCH, device=device)
        blobs, metadata, decoded, counts, t_enc, t_dec = drive(codec_t)
    bpp_t = len(blobs[0]) * 8 / len(points)
    psnr_t = metadata[0]["metrics"]["d1_psnr"]
    host_t = host_d1_psnr(points, decoded[0], RESOLUTION - 1)
    assert np.isfinite(psnr_t) and 0 < bpp_t < 8, (psnr_t, bpp_t)
    assert abs(psnr_t - host_t) < 1e-6, (psnr_t, host_t)
    expect_launches("the trained weights' d1 path", counts,
                    ("bucket_colsums", "halo_edt"),
                    ("bucket_colsums_d2", "edt_sweep"))
    log(f"trained weights exported ({asset.name}, read back equal), d1 path: "
        f"{len(decoded[0])} decoded points, bit-exact; {bpp_t:.4f} bpp, D1 "
        f"PSNR {psnr_t:.4f} dB (host KD-tree {host_t:.4f}; committed weights "
        f"{psnr_d1:.4f}); encode {t_enc:.2f} s, decode {t_dec:.2f} s; "
        f"launches {counts}")
    log(f"phase 15: {time.time() - t_phase:.1f} s")
    return counts


# phase 16: the benchmark driver (pcc_geo_cnn_v2_tpu_torch/bench.py) as a
# subprocess, at its defaults (8 clouds, bf16, batch 128, the bucket sweep,
# d1) with BENCH_PIPELINE 3 and 1, then on 2 clouds with the d2 group (K3)
# and with the fused-conv backend (K4a / K4b)
BENCH_TIMEOUT_S = 600
BENCH_RUNS = (
    ("bench", {"BENCH_PIPELINE": "3"}),
    ("bench_pipeline1", {"BENCH_PIPELINE": "1"}),
    ("bench_d2", {"BENCH_NUM_CLOUDS": "2",
                  "BENCH_OPT_METRICS": "d1_mse,d2_mse"}),
    ("bench_pallas", {"BENCH_NUM_CLOUDS": "2",
                      "BENCH_CONV_BACKEND": "pallas"}),
)
# phase 18: data-parallel training, c3p at batch BATCH: nccl at world 1
# against the trainer without a group (bit-equal), then DP_WORLD ranks on
# the one card over gloo for DP_STEPS steps (parameters bit-identical across
# the ranks, the loss within DP_LOSS_REL of the single-process step: the
# ranks add their shares of it in another order)
DP_WORLD, DP_STEPS, DP_LOSS_REL, DP_TIMEOUT_S = 2, 3, 1e-4, 300
# a summed gradient leaf against the single process's, as a share of that
# leaf's largest |g| (tests/test_torch_data_parallel.py's bound)
DP_GRAD_TOL = 1e-3


def run_bench(name, env_extra):
    """One ``python -m pcc_geo_cnn_v2_tpu_torch.bench`` run: (its JSON line,
    its summary dict). Fails the phase on a non-zero exit."""
    import os

    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(env_extra)
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "pcc_geo_cnn_v2_tpu_torch.bench"], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    if proc.returncode != 0:
        log(proc.stderr[-6000:])
        raise RuntimeError(f"{name}: the bench exited with {proc.returncode}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    summary = json.loads(next(
        ln for ln in proc.stderr.splitlines()
        if ln.startswith("bench summary: ")).split(": ", 1)[1])
    keep = [ln for ln in proc.stderr.splitlines()
            if ln.startswith(("warmup done", "encode ", "decode ", "enc-side",
                              "c3p ", "8 clouds", "2 clouds"))]
    log(f"{name} ({' '.join(f'{k}={v}' for k, v in env_extra.items())}), "
        f"{time.time() - t0:.1f} s: {json.dumps(line)}")
    for ln in keep:
        log(f"  {ln}")
    log(f"  encode {summary['t_enc']:.3f} s, decode {summary['t_dec']:.3f} "
        f"s, {summary['blocks']} blocks, {summary['value']:.2f} blocks/s, "
        f"{summary['bpp']:.4f} bpp, {summary['decoded_points']} decoded "
        f"points, peak memory {summary['peak_bytes'] / 2**30:.3f} GiB; "
        f"launches {summary['launches']}")
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}, line
    assert line["metric"] == "blocks64_enc_dec_per_sec_per_chip", line
    assert line["value"] > 0 and summary["decoded_points"] > 0, summary
    return line, summary


def check_bench(codec128, flat_dev, offsets, budget, expect_launches):
    """Phase 16: K1 at the bench's first 128-block chunk against its plain
    version, then the bench runs of ``BENCH_RUNS``. Returns (the K1 check,
    {run: launches}, {run: summary})."""
    import torch

    t_phase = time.time()
    pts = codec128.chunk_points(flat_dev, offsets, 0, codec128.batch_blocks,
                                budget)
    x_hat = codec128.encode_chunk(pts, codec128.batch_blocks)["x_hat"]
    k1_128 = check_k1(codec128, pts, x_hat, codec128.bucket_k, reps=5,
                      plain_reps=1)
    del pts, x_hat
    torch.cuda.empty_cache()
    counts, summaries = {}, {}
    for name, env_extra in BENCH_RUNS:
        _, summaries[name] = run_bench(name, env_extra)
        counts[name] = summaries[name]["launches"]
    k4 = ("fused_tail", "fused_tail_slab")
    for name in ("bench", "bench_pipeline1"):
        expect_launches(name, counts[name], ("bucket_colsums", "halo_edt"),
                        ("bucket_colsums_d2", "edt_sweep") + k4)
    expect_launches("bench_d2", counts["bench_d2"],
                    ("bucket_colsums_d2", "halo_edt"),
                    ("bucket_colsums", "edt_sweep") + k4)
    expect_launches("bench_pallas", counts["bench_pallas"],
                    ("bucket_colsums", "halo_edt") + k4,
                    ("bucket_colsums_d2", "edt_sweep"))
    p3, p1 = summaries["bench"], summaries["bench_pipeline1"]
    assert p3["digest"] == p1["digest"], "BENCH_PIPELINE changed the streams"
    assert counts["bench"] == counts["bench_pipeline1"], counts
    log(f"bench: BENCH_PIPELINE 3 and 1 give equal streams (sha256 "
        f"{p3['digest'][:16]}...), {p3['value'] / p1['value']:.3f}x the "
        f"blocks/s with 3 clouds in flight (encode "
        f"{p1['t_enc'] / p3['t_enc']:.3f}x, decode "
        f"{p1['t_dec'] / p3['t_dec']:.3f}x), peak memory "
        f"{p3['peak_bytes'] / 2**30:.3f} GiB against "
        f"{p1['peak_bytes'] / 2**30:.3f} GiB")
    log(f"phase 16: {time.time() - t_phase:.1f} s")
    return k1_128, counts, summaries


def _dp_batches(blocks, n_batches):
    from pcc_geo_cnn_v2_tpu_torch.utils.data import BlockDataset

    ds = BlockDataset(blocks[:BATCH * n_batches])
    return [ds._pack(np.arange(i * BATCH, (i + 1) * BATCH))
            for i in range(n_batches)]


def _param_digest(model):
    import hashlib

    h = hashlib.sha256()
    for v in model.state_dict().values():
        h.update(v.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _grads(model):
    """Every parameter's gradient on the host, by name."""
    return {n: p.grad.detach().cpu().clone()
            for n, p in model.named_parameters() if p.grad is not None}


def _dp_rank(rank, init_method, cfg, batches, out_dir, device):
    """A phase-18 rank (spawned): a step of c3p a global batch of
    ``batches`` in a DP_WORLD-rank group on the one card; writes (loss, the
    parameters' digest, the step's seconds) a step to ``rank<r>.json`` in
    ``out_dir``, and rank 0 the summed gradients of step 1 (that path +
    ``.grads``)."""
    import os
    import tempfile

    import torch

    from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
    from pcc_geo_cnn_v2_tpu_torch.parallel.mesh import process_group
    from pcc_geo_cnn_v2_tpu_torch.training import Trainer

    out_path = str(Path(out_dir) / f"rank{rank}.json")

    # the ranks share the host's cores (oversubscribed, a CPU rank's step
    # took 70x the single process's)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // DP_WORLD))
    records = []
    with process_group(rank, DP_WORLD, init_method, device) as (group, dev):
        backend = torch.distributed.get_backend(group)
        with tempfile.TemporaryDirectory() as tmp:
            t = Trainer(build_model("c3p"), cfg, tmp, seed=0,
                        warm_start=ASSET, device=dev, group=group)
            for step, batch in enumerate(batches, 1):
                t0 = time.time()
                loss = float(t.step_batch(batch, step)["loss"])  # waits
                records.append((loss, _param_digest(t.model),
                                time.time() - t0))
                if step == 1 and rank == 0:
                    torch.save(_grads(t.model), out_path + ".grads")
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
    with open(out_path, "w") as f:
        json.dump({"backend": backend, "device": str(dev), "records": records,
                   "peak": peak}, f)


def check_data_parallel(device, blocks):
    """Phase 18: ``Trainer(group=...)`` on the card. Returns the launch
    counts of the world-1 steps (``conv_wgrad`` alone)."""
    import tempfile

    import torch

    from pcc_geo_cnn_v2_tpu_torch.dryrun import spawn_ranks
    from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
    from pcc_geo_cnn_v2_tpu_torch.ops import kernels
    from pcc_geo_cnn_v2_tpu_torch.parallel.mesh import (
        backend_for,
        process_group,
    )
    from pcc_geo_cnn_v2_tpu_torch.training import TrainConfig, Trainer

    t_phase = time.time()
    batches = _dp_batches(blocks, DP_STEPS)
    cfg = TrainConfig(batch_size=BATCH, block_size=BLOCK)
    with tempfile.TemporaryDirectory() as tmp:
        # the ranks meet at a file of the run's own directory: a tcp port
        # could be taken by another process between its choice and its use
        def rendezvous(name):
            return (Path(tmp) / name).resolve().as_uri()

        # 1. nccl at world 1: bit-equal to the step without a group
        single = Trainer(build_model("c3p"), cfg, Path(tmp) / "single",
                         seed=0, warm_start=ASSET, device=device)
        kernels.reset_launches()
        torch.use_deterministic_algorithms(True)
        try:
            want = single.step_batch(batches[0], 1)
            grads_single = _grads(single.model)
            with process_group(0, 1, rendezvous("rdv_world1"), device) as (
                    group, dev):
                backend = torch.distributed.get_backend(group)
                grouped = Trainer(build_model("c3p"), cfg,
                                  Path(tmp) / "nccl1", seed=0,
                                  warm_start=ASSET, device=dev, group=group)
                got = grouped.step_batch(batches[0], 1)
                counts = dict(kernels.launches)
                for k, v in single.model.state_dict().items():
                    assert torch.equal(v, grouped.model.state_dict()[k]), k
                for k, v in want.items():
                    assert torch.equal(v, got[k]), (k, v, got[k])
        finally:
            torch.use_deterministic_algorithms(False)
        assert backend == backend_for(device, 1), backend  # nccl on a card
        routed = routed_wgrad_layers(single.model)
        assert counts["conv_wgrad"] == 2 * len(routed), (counts, routed)
        assert not any(v for k, v in counts.items()
                       if k not in TRAIN_KERNELS), counts
        log(f"data-parallel step, {backend} at world 1, c3p at batch "
            f"{BATCH} of {BLOCK}^3: parameters and logs bit-equal to the "
            f"trainer without a group (loss {float(got['loss'])!r}); "
            f"conv_wgrad once a routed layer a step, no other kernel")

        # 2. DP_WORLD ranks on one card over gloo with CUDA tensors,
        # against the single process's steps 1..DP_STEPS
        losses, single_s = [float(want["loss"])], []
        for step, b in enumerate(batches[1:], 2):
            t0 = time.time()
            losses.append(float(single.step_batch(b, step)["loss"]))
            single_s.append(time.time() - t0)
        del single, grouped
        t0 = time.time()
        outs = [Path(tmp) / f"rank{r}.json" for r in range(DP_WORLD)]
        spawn_ranks(_dp_rank, DP_WORLD, (rendezvous("rdv_ranks"), cfg,
                                         batches, tmp, device), DP_TIMEOUT_S)
        ranks = [json.loads(o.read_text()) for o in outs]
        grads_ranks = torch.load(str(outs[0]) + ".grads")
    assert {r["backend"] for r in ranks} == {"gloo"}, ranks  # ranks share
    # the global-denominator rule: the ranks' summed gradient is the whole
    # batch's (averaged per-rank losses would give another)
    assert sorted(grads_ranks) == sorted(grads_single)
    grad_worst = 0.0
    for name, w in grads_single.items():
        scale = max(float(w.abs().max()), 1e-30)
        err = float((grads_ranks[name] - w).abs().max()) / scale
        assert err <= DP_GRAD_TOL, (name, err)
        grad_worst = max(grad_worst, err)
    worst = 0.0
    for step in range(DP_STEPS):
        digests = {r["records"][step][1] for r in ranks}
        assert len(digests) == 1, (step, digests)
        for r in ranks:
            rel = abs(r["records"][step][0] - losses[step]) / abs(
                losses[step])
            assert rel <= DP_LOSS_REL, (step, r["records"][step][0],
                                        losses[step])
            worst = max(worst, rel)
    log(f"data-parallel training, {DP_WORLD} ranks on one card over gloo "
        f"with CUDA tensors ({ranks[0]['device']}), c3p at the global batch "
        f"{BATCH} ({BATCH // DP_WORLD} a rank), {DP_STEPS} steps in "
        f"{time.time() - t0:.1f} s with the processes' start: parameters "
        f"bit-identical across the ranks after every step; losses "
        f"{[r[0] for r in ranks[0]['records']]} against the single process's "
        f"{losses} (worst {worst:.2e} relative); step 1's summed gradients "
        f"against the single process's: worst leaf {grad_worst:.2e} of its "
        f"largest |g| (bound {DP_GRAD_TOL}); peak memory a rank "
        f"{max(r['peak'] for r in ranks) / 2**30:.3f} GiB")
    # steps after the first (cuDNN's set-up), the slowest rank's
    rank_s = [max(r["records"][step][2] for r in ranks)
              for step in range(1, DP_STEPS)]
    log(f"data-parallel step s, steps 2-{DP_STEPS}: {DP_WORLD} ranks "
        f"{[round(x, 4) for x in rank_s]}, the single process "
        f"{[round(x, 4) for x in single_s]}")
    log(f"phase 18: {time.time() - t_phase:.1f} s")
    return counts


# phase 19: the sp path on the most populated cell at octree level
# SP_LEVEL (256³), c3p in f32: nccl at world 1 (bit-equal to the unsharded
# executable), then SP_WORLD gloo ranks on the card (symbols within
# SP_MISMATCH of the unsharded ones, JAX's bound; the round trip's x_hat
# bit-equal, masks at SP_THR equal); then the dry run over DRYRUN_WORLD
# ranks
SP_LEVEL, SP_WORLD, SP_THR, SP_MISMATCH, SP_TIMEOUT_S = 2, 2, 0.51, 5e-4, 600
DRYRUN_WORLD = 4


def sp_cell(points):
    """The cloud's most populated cell at octree level ``SP_LEVEL``: its
    [1, S, S, S, 1] f32 occupancy (S = RESOLUTION >> SP_LEVEL) and point
    count."""
    from pcc_geo_cnn_v2_tpu_torch.utils.octree import partition_octree

    blocks, _ = partition_octree(points[:, :3], [0, 0, 0], [RESOLUTION] * 3,
                                 SP_LEVEL)
    cell = max(blocks, key=len).astype(np.int64)
    size = RESOLUTION >> SP_LEVEL
    x = np.zeros((1, size, size, size, 1), np.float32)
    x[0, cell[:, 0], cell[:, 1], cell[:, 2], 0] = 1.0
    return x, len(cell)


def sp_model(device):
    """c3p at full width with the committed weights, f32, on ``device``."""
    from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
    from pcc_geo_cnn_v2_tpu_torch.weights import (
        load_asset_tree,
        params_from_jax,
    )

    model = build_model("c3p")
    model.load_state_dict(params_from_jax(load_asset_tree(ASSET)))
    return model.to(device).eval()


def _measured(dev, encode, decode):
    """A warm-up, then one timed encode and decode: (symbols, x_hat, a
    record of their walls, device ms and the peak memory) on ``dev``."""
    import torch

    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    decode(encode()["y_sym"])  # cuDNN's set-up, the allocator's growth
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    syms = encode()
    sync()
    t_enc = time.time() - t0
    t0 = time.time()
    x_hat = decode(syms["y_sym"])
    sync()
    rec = {"enc_s": t_enc, "dec_s": time.time() - t0,
           "peak": torch.cuda.max_memory_allocated(dev) if cuda else 0}
    if cuda:
        rec["enc_ms"] = device_work(encode)[1]
        rec["dec_ms"] = device_work(lambda: decode(syms["y_sym"]))[1]
    return syms, x_hat, rec


def sp_coding(model, x, group, dev):
    """The sp path as an encoder and as a decoder from the bytes alone, at
    ``group``'s world size, on the rank's slab of the whole ``x`` (moved
    to ``dev``): (the whole symbols, the rank's encoder and decoder x_hat,
    the record of :func:`_measured` with the stream's bytes)."""
    import torch

    from pcc_geo_cnn_v2_tpu_torch.parallel import spatial

    slab = spatial.depth_slab(x, group).to(dev)
    syms, x_hat, rec = _measured(
        dev, lambda: spatial.encode_syms_spatial(model, slab, group),
        lambda y: spatial.decode_y_spatial(model, y, group))
    whole = {k: spatial.gather_depth(v, group) for k, v in syms.items()}
    strings = spatial.symbols_to_bytes(model, whole)
    rec["bytes"] = sum(len(b) for row in strings for b in row)
    decoded = spatial.bytes_to_symbols(model, strings,
                                       tuple(whole["y_sym"].shape[1:]))
    for k, v in whole.items():
        assert torch.equal(decoded[k], v), f"{k} differs after the bytes"
    x_hat_dec = spatial.decode_y_spatial(
        model, spatial.depth_slab(decoded["y_sym"], group), group)
    return whole, x_hat, x_hat_dec, rec


def _half_slab_ms(model, x, y_sym, group):
    """Device ms of the sharded encode and decode of the first of
    ``SP_WORLD`` depth slabs at world 1."""
    from pcc_geo_cnn_v2_tpu_torch.parallel import spatial

    xs, ys = (t[:, :t.shape[1] // SP_WORLD].contiguous() for t in (x, y_sym))
    return (device_work(lambda: spatial.encode_syms_spatial(model, xs,
                                                            group))[1],
            device_work(lambda: spatial.decode_y_spatial(model, ys,
                                                         group))[1])


def _sp_rank(rank, world, init_method, device, x_path, out_dir):
    """A phase-19 rank (spawned): the sp coding of the cell at ``world``
    on the one card; writes its record (``rank<r>.json``) and rank 0 the
    whole symbols (``syms.npz``)."""
    import os

    import torch

    from pcc_geo_cnn_v2_tpu_torch.parallel.mesh import process_group

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    with process_group(rank, world, init_method, device) as (group, dev):
        model = sp_model(dev)
        x = torch.from_numpy(np.load(x_path))  # a slab of it to the card
        whole, x_hat, x_hat_dec, rec = sp_coding(model, x, group, dev)
        rec.update(backend=torch.distributed.get_backend(group),
                   device=str(dev),
                   x_hat_equal=torch.equal(x_hat_dec, x_hat),
                   masks_equal=torch.equal(x_hat_dec > SP_THR,
                                           x_hat > SP_THR),
                   occupied=int((x_hat > SP_THR).sum()))
        if rank == 0:
            np.savez(Path(out_dir) / "syms.npz",
                     **{k: v.cpu().numpy() for k, v in whole.items()})
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(rec))


def check_spatial(device, points, card):
    """Phase 19 (module docstring). Returns the launch counts of the
    world-1 run (none: the sp path runs cuDNN convs)."""
    import tempfile

    import torch

    from pcc_geo_cnn_v2_tpu_torch.codec import deterministic_convs
    from pcc_geo_cnn_v2_tpu_torch.dryrun import dryrun_multichip, spawn_ranks
    from pcc_geo_cnn_v2_tpu_torch.ops import kernels
    from pcc_geo_cnn_v2_tpu_torch.parallel.mesh import (
        backend_for,
        process_group,
    )

    t_phase = time.time()
    device = torch.device(device)
    x_np, n_pts = sp_cell(points)
    size = x_np.shape[1]
    model = sp_model(device)
    x = torch.from_numpy(x_np).to(device)
    deterministic_convs()
    with torch.no_grad():
        want, x_hat_want, rec_u = _measured(
            device, lambda: model.encode_syms(x), model.decode_y)
    log(f"sp cell: {n_pts} points in the most populated {size}^3 cell "
        f"(octree level {SP_LEVEL}); c3p f32 unsharded on {card}: encode "
        f"{rec_u['enc_s']:.4f} s, decode {rec_u['dec_s']:.4f} s wall, "
        f"device {rec_u.get('enc_ms', float('nan')):.3f} / "
        f"{rec_u.get('dec_ms', float('nan')):.3f} ms, peak memory "
        f"{rec_u['peak'] / 2**30:.3f} GiB; {int((x_hat_want > SP_THR).sum())}"
        f" voxels over {SP_THR}")
    with tempfile.TemporaryDirectory() as tmp:
        def rendezvous(name):
            return (Path(tmp) / name).resolve().as_uri()

        # 1. world 1 on nccl: zero halos, the unsharded executable's convs
        kernels.reset_launches()
        with process_group(0, 1, rendezvous("rdv_sp1"), device) as (
                group, dev):
            backend = torch.distributed.get_backend(group)
            whole, x_hat, x_hat_dec, rec_1 = sp_coding(model, x, group, dev)
            counts = dict(kernels.launches)
            if device.type == "cuda":
                # one rank's slab alone: the convs of a world-2 rank, with
                # zero planes for halos, and no other process on the card
                half = _half_slab_ms(model, x, whole["y_sym"], group)
        assert backend == backend_for(device, 1), backend
        # the synthesis' last layer (16 -> 1) through conv_one_out, as
        # unsharded
        assert counts["conv_one_out"] > 0 and not any(
            v for k, v in counts.items() if k not in NO_GRAD_KERNELS), counts
        for k, v in want.items():
            assert torch.equal(whole[k], v), f"world 1: {k} differs"
        assert torch.equal(x_hat, x_hat_want), "world 1: x_hat differs"
        assert torch.equal(x_hat_dec, x_hat), "world 1: decoder x_hat"
        log(f"sp at world 1 on {backend}: symbols and x_hat bit-equal to the "
            f"unsharded encode and decode, the round trip's "
            f"{rec_1['bytes']} bytes decoded bit-exactly; encode "
            f"{rec_1['enc_s']:.4f} s, decode {rec_1['dec_s']:.4f} s on "
            f"{card}; launches {counts}")
        del whole, x_hat, x_hat_dec
        if device.type == "cuda":
            log(f"sp one world-{SP_WORLD} slab alone at world 1: device ms "
                f"encode {half[0]:.3f}, decode {half[1]:.3f} [{card}]")
            torch.cuda.empty_cache()

        # 2. SP_WORLD ranks sharing the card over gloo
        x_path = Path(tmp) / "cell.npy"
        np.save(x_path, x_np)
        t0 = time.time()
        spawn_ranks(_sp_rank, SP_WORLD, (SP_WORLD, rendezvous("rdv_sp"),
                                         device.type, str(x_path), tmp),
                    SP_TIMEOUT_S)
        t_ranks = time.time() - t0
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(SP_WORLD)]
        with np.load(Path(tmp) / "syms.npz") as z:
            got = {k: z[k] for k in z.files}
    assert {r["backend"] for r in ranks} == {backend_for(device, SP_WORLD)}
    assert all(r["x_hat_equal"] and r["masks_equal"] for r in ranks), ranks
    assert len({r["bytes"] for r in ranks}) == 1, ranks
    mismatch = {}
    for k, v in want.items():
        v = v.cpu().numpy()
        assert got[k].shape == v.shape, (k, got[k].shape, v.shape)
        mismatch[k] = float(np.mean(got[k] != v))
        assert mismatch[k] < SP_MISMATCH, (k, mismatch[k])
    occupied = sum(r["occupied"] for r in ranks)

    def per_rank(key, fmt, scale=1):
        return ", ".join(format(r.get(key, float("nan")) / scale, fmt)
                         for r in ranks)

    log(f"sp at world {SP_WORLD} on {card}, {ranks[0]['backend']} ranks "
        f"sharing {ranks[0]['device']} ({t_ranks:.1f} s with the processes' "
        f"start): symbols differing from the unsharded ones {mismatch} "
        f"(bound {SP_MISMATCH}); round trip of {ranks[0]['bytes']} bytes: "
        f"each rank's decoder x_hat bit-equal to its encoder's, masks at "
        f"{SP_THR} equal ({occupied} voxels, unsharded "
        f"{int((x_hat_want > SP_THR).sum())})")
    log(f"sp walls s, encode: ranks {per_rank('enc_s', '.4f')} against "
        f"{rec_u['enc_s']:.4f} unsharded; decode: ranks "
        f"{per_rank('dec_s', '.4f')} against {rec_u['dec_s']:.4f} [{card}]")
    log(f"sp device ms (two processes time-slicing the card), encode: ranks "
        f"{per_rank('enc_ms', '.3f')} against "
        f"{rec_u.get('enc_ms', float('nan')):.3f}; decode: ranks "
        f"{per_rank('dec_ms', '.3f')} against "
        f"{rec_u.get('dec_ms', float('nan')):.3f} [{card}]")
    log(f"sp peak memory GiB: ranks {per_rank('peak', '.3f', 2**30)} "
        f"against {rec_u['peak'] / 2**30:.3f} unsharded "
        f"({max(r['peak'] for r in ranks) / max(rec_u['peak'], 1):.3f}x) "
        f"[{card}]")
    del model, x, want, x_hat_want
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # 3. the dry run
    t0 = time.time()
    log(f"dryrun_multichip({DRYRUN_WORLD}) on {card}:")
    dry = dryrun_multichip(DRYRUN_WORLD, device=device.type)
    log(f"  {time.time() - t0:.1f} s with the processes' start [{card}]; "
        f"{dry[0]['backend']} on {sorted({r['device'] for r in dry})}; sp "
        f"symbols differing {dry[0]['sp']['mismatch']}, nonzero "
        f"{dry[0]['sp']['nonzero']}")
    log(f"phase 19: {time.time() - t_phase:.1f} s [{card}]")
    return counts


# phase 20: the RD experiment pipeline on the committed c3p-a0.75 λ ladder
# and on a c3p-train sweep, on figure_cloud(RD_SEED) (tools/rd_eval.py's
# first evaluation cloud, whose JAX rows are in RD_RESULTS), the d1 group
RD_SEED = 200
RD_LADDER = REPO / "pcc_geo_cnn_v2_tpu/assets/rd/c3p-a0.75"
RD_RESULTS = REPO / "results/rd_c3p_a075.json"
RD_LAMBDAS = (1e-5, 2e-5, 5e-5, 1e-4, 3e-4)
# the sweep: two λ in warm_seq, the first resumed from the ladder's weights
# at its λ (a ckpt_0 written into its run directory, as the JAX package's
# tools/assets_to_ckpt.py rehydrates one), RD_TRAIN_STEPS steps each at
# batch RD_TRAIN_BATCH on RD_TRAIN_BLOCKS blocks of the cloud
RD_TRAIN_LAMBDAS = (1e-4, 3e-4)
RD_TRAIN_BLOCKS, RD_TRAIN_BATCH, RD_TRAIN_STEPS = 24, 8, 3
RD_NUM_PARALLEL = 2
# tools/rd_eval.py's anchor scales
RD_ANCHOR_SCALES = (0.96875, 0.9375, 0.875, 0.75, 0.5, 0.25, 0.125, 0.0625)
RD_TRAIN_TIMEOUT_S, RD_RUN_TIMEOUT_S = 300, 600
RD_REPORT_KEYS = {"pc_name", "model_config", "opt_group",
                  "pos_total_size_in_bytes", "input_point_count", "bpp",
                  "d1_mse", "d1_psnr"}


class deadline:
    """Raise TimeoutError in the main thread after ``seconds`` (SIGALRM):
    ``subprocess.run`` kills its child on the way out, ``parallel_process``
    terminates its children."""

    def __init__(self, seconds, what):
        self.seconds, self.what = seconds, what

    def _fire(self, *_):
        raise TimeoutError(f"{self.what}: over {self.seconds} s")

    def __enter__(self):
        import signal

        self.old = signal.signal(signal.SIGALRM, self._fire)
        signal.alarm(self.seconds)

    def __exit__(self, *exc):
        import signal

        signal.alarm(0)
        signal.signal(signal.SIGALRM, self.old)


class recorded:
    """Record the child commands started through ``module.attr`` (a
    ``subprocess.run`` or a ``Popen`` class) while the block runs."""

    def __init__(self, module, attr):
        self.module, self.attr, self.cmds = module, attr, []

    def __enter__(self):
        self.real = getattr(self.module, self.attr)

        def call(cmd, *a, **k):
            self.cmds.append([str(c) for c in cmd])
            return self.real(cmd, *a, **k)

        setattr(self.module, self.attr, call)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.real)


def rd_train_blocks(points, out_dir):
    """RD_TRAIN_BLOCKS blocks of the cloud, evenly spread, as training
    PLYs (block-local coordinates)."""
    from pcc_geo_cnn_v2_tpu_torch.utils import pc_io
    from pcc_geo_cnn_v2_tpu_torch.utils.octree import partition_octree

    blocks, _ = partition_octree(points, [0, 0, 0], [RESOLUTION] * 3, LEVEL)
    pick = np.linspace(0, len(blocks) - 1, RD_TRAIN_BLOCKS).astype(int)
    for i, b in enumerate(pick):
        pc_io.write_ply(out_dir / f"b{i:03d}.ply", blocks[b])
    return len(blocks)


def check_rd_pipeline(device, card, expect_launches):
    """Phase 20 (module docstring). Returns the launch counts of the
    in-process experiment."""
    import importlib.util
    import os
    import tempfile

    import torch

    from pcc_geo_cnn_v2_tpu_torch.cli import decompress as cli_decompress
    from pcc_geo_cnn_v2_tpu_torch.cli import ev_experiment, mp_run
    from pcc_geo_cnn_v2_tpu_torch.cli.ev_compare import load_curves
    from pcc_geo_cnn_v2_tpu_torch.cli.ev_run_experiment import (
        run_experiments,
    )
    from pcc_geo_cnn_v2_tpu_torch.cli.tr_train_all import lmbda_tag, train_all
    from pcc_geo_cnn_v2_tpu_torch.coding.octree_anchor import anchor_decode
    from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
    from pcc_geo_cnn_v2_tpu_torch.ops import kernels
    from pcc_geo_cnn_v2_tpu_torch.training import TrainConfig, Trainer
    from pcc_geo_cnn_v2_tpu_torch.utils import parallel_process, pc_io
    from pcc_geo_cnn_v2_tpu_torch.utils.bd import bdrate, bdsnr
    from pcc_geo_cnn_v2_tpu_torch.utils.scansim import figure_cloud

    t_phase = time.time()
    have = {m: importlib.util.find_spec(m) is not None
            for m in ("yaml", "pandas", "matplotlib")}
    log(f"phase 20 on {card}: optional packages present {have} (the phase "
        f"needs none of them)")
    # the children resolve ``-m pcc_geo_cnn_v2_tpu_torch...`` from here
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.time()
        points = figure_cloud(RD_SEED, RESOLUTION, with_normals=False)
        cloud = tmp / f"figure_{RD_SEED}.ply"
        pc_io.write_ply(cloud, points)
        (tmp / "blocks").mkdir()
        n_blocks = rd_train_blocks(points, tmp / "blocks")
        model_dir, exp_dir = tmp / "models", tmp / "experiments"
        for lam in RD_LAMBDAS:  # the committed ladder, evaluated in place
            link = model_dir / "c3p-a0.75" / lmbda_tag(lam)
            link.parent.mkdir(parents=True, exist_ok=True)
            link.symlink_to(RD_LADDER / f"{lmbda_tag(lam)}.msgpack.gz")
        walls["set-up"] = time.time() - t0
        log(f"figure_{RD_SEED}: {len(points)} points, {n_blocks} blocks of "
            f"{BLOCK}^3; {RD_TRAIN_BLOCKS} of them written as training "
            f"blocks ({walls['set-up']:.1f} s)")

        # 1. the train sweep
        first = model_dir / "c3p-train" / lmbda_tag(RD_TRAIN_LAMBDAS[0])
        Trainer(build_model("c3p"), TrainConfig(block_size=BLOCK), first,
                warm_start=model_dir / "c3p-a0.75" / lmbda_tag(
                    RD_TRAIN_LAMBDAS[0]), device=device).save(0)
        spec = {
            "train_glob": str(tmp / "blocks" / "*.ply"),
            "experiment_dir": str(exp_dir), "model_dir": str(model_dir),
            "resolution": RESOLUTION, "octree_level": LEVEL,
            "opt_metrics": ["d1_mse"],
            "data": [{"pc_name": cloud.stem, "input_pc": str(cloud)}],
            "model_configs": [
                {"id": "c3p-a0.75", "config": "c3p",
                 "lambdas": list(RD_LAMBDAS)},
                {"id": "c3p-train", "config": "c3p", "num_filters": 64,
                 "resolution": BLOCK, "batch_size": RD_TRAIN_BATCH,
                 "max_steps": RD_TRAIN_STEPS, "train_mode": "warm_seq",
                 "lambdas": list(RD_TRAIN_LAMBDAS)}],
        }
        # the ladder is committed, not trained: the sweep's spec has only
        # c3p-train
        sweep = {"model_configs": spec["model_configs"][1:],
                 "train_glob": spec["train_glob"]}
        extra = ["--val_every", str(RD_TRAIN_STEPS), "--val_batches", "1"]
        t0 = time.time()
        with deadline(RD_TRAIN_TIMEOUT_S, "the train sweep"), \
                recorded(subprocess, "run") as rec:
            train_all(sweep, model_dir, extra, device)
        walls["training children"] = time.time() - t0
        runs = [model_dir / "c3p-train" / lmbda_tag(lam)
                for lam in RD_TRAIN_LAMBDAS]
        assert all((r / "done").exists() for r in runs), "a done is missing"
        assert len(rec.cmds) == 2, rec.cmds
        second = rec.cmds[1]
        assert second[second.index("--warm_start") + 1] == str(runs[0]), \
            second
        assert "--warm_start" not in rec.cmds[0], rec.cmds[0]
        with recorded(subprocess, "run") as again:
            train_all(sweep, model_dir, extra, device)
        assert not again.cmds, "a second train sweep started a child"
        steps = [json.loads(ln)["step"] for r in runs for ln in
                 (r / "train_log.jsonl").read_text().splitlines()]
        log(f"train sweep: c3p-train at λ {RD_TRAIN_LAMBDAS} in warm_seq, "
            f"{RD_TRAIN_STEPS} steps each at batch {RD_TRAIN_BATCH} of "
            f"{BLOCK}^3, two children in {walls['training children']:.1f} "
            f"s; both done, the second warm-started from the first, a "
            f"second call started no child; logged steps {steps}")

        # 2. the experiments: the first ladder λ in this process, counted
        first_dir = exp_dir / cloud.stem / "c3p-a0.75" / lmbda_tag(
            RD_LAMBDAS[0])
        argv = ["--output_dir", str(first_dir), "--model_dir",
                str(model_dir / "c3p-a0.75" / lmbda_tag(RD_LAMBDAS[0])),
                "--model_config", "c3p", "--input_pc", str(cloud),
                "--resolution", str(RESOLUTION), "--octree_level",
                str(LEVEL), "--device", device]
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.time()
        ev_experiment.main(argv)
        torch.cuda.synchronize()
        walls["in-process experiment"] = time.time() - t0
        counts = dict(kernels.launches)
        log(f"in-process experiment (λ {RD_LAMBDAS[0]:g}): "
            f"{walls['in-process experiment']:.1f} s; launches {counts}")
        expect_launches("the rd path", counts, ("bucket_colsums",),
                        ("bucket_colsums_d2", "edt_sweep", "fused_tail",
                         "fused_tail_slab"))
        assert counts["halo_edt"] == 1, counts  # one call a cloud

        # the other six through the job runner, two children at a time
        t0 = time.time()
        with deadline(RD_RUN_TIMEOUT_S, "the experiments"), \
                recorded(parallel_process, "Popen") as rec:
            run_experiments(spec, RD_NUM_PARALLEL, device)
        walls["experiment children"] = time.time() - t0
        n_jobs = len(RD_LAMBDAS) + len(RD_TRAIN_LAMBDAS) - 1
        assert len(rec.cmds) == n_jobs, rec.cmds
        with recorded(parallel_process, "Popen") as again:
            run_experiments(spec, RD_NUM_PARALLEL, device)
        assert not again.cmds, "a second run started a child"
        exps = {(mc["id"], lam): exp_dir / cloud.stem / mc["id"] /
                lmbda_tag(lam)
                for mc in spec["model_configs"] for lam in mc["lambdas"]}
        reports = {k: json.loads((d / "report_d1.json").read_text())
                   for k, d in exps.items()}
        for key, rep in reports.items():
            assert set(rep) == RD_REPORT_KEYS, (key, sorted(rep))
            assert rep["input_point_count"] == len(points), rep
        log(f"experiments: {n_jobs} children, {RD_NUM_PARALLEL} at a time "
            f"on the card, in {walls['experiment children']:.1f} s; "
            f"{len(reports)} report_d1.json with JAX's keys; a second call "
            f"started no child")

        # 3. each stream decoded in this process equals its .dec.ply
        t0 = time.time()
        for (mode, lam), d in exps.items():
            stream = d / f"{cloud.stem}.d1.bin"
            out = d / "decoded_again.ply"
            cli_decompress.main([
                "--input_files", str(stream), "--output_files", str(out),
                "--checkpoint_dir", str(model_dir / mode / lmbda_tag(lam)),
                "--model_config", "c3p", "--device", device])
            got = pc_io.read_ply(out)[0]
            want = pc_io.read_ply(d / f"{cloud.stem}.d1.dec.ply")[0]
            assert got.shape == want.shape and np.array_equal(got, want), \
                f"{mode} {lam}: the decode differs from the encoder's"
        walls["decode"] = time.time() - t0
        log(f"bit-exact: the {len(exps)} streams decoded in this process "
            f"equal their .dec.ply point for point "
            f"({walls['decode']:.1f} s)")

        # 4. the built-in anchor at rd_eval's scales
        t0 = time.time()
        anchor_dir = tmp / "anchor"
        mp_run.main([str(cloud), str(anchor_dir), "--tmc3", "builtin",
                     "--rates", *map(str, RD_ANCHOR_SCALES),
                     "--resolution", str(RESOLUTION)])
        anchor = []
        for scale in RD_ANCHOR_SCALES:
            run_dir = anchor_dir / "octree" / f"r{scale:g}"
            rep = json.loads((run_dir / "report.json").read_text())
            dec, _ = anchor_decode((run_dir / "compressed.bin").read_bytes())
            written = pc_io.read_ply(run_dir / "decoded.ply")[0]
            assert np.array_equal(dec, written), f"anchor {scale} decode"
            anchor.append((scale, rep))
        walls["anchor"] = time.time() - t0
        log(f"anchor: {len(anchor)} report.json, each stream decoded by "
            f"anchor_decode equal to mp_run's decoded.ply "
            f"({walls['anchor']:.1f} s)")

        # 5. RD and BD against the anchor
        t0 = time.time()
        curves = load_curves(exp_dir, cloud.stem, "d1_psnr", "d1")
        ladder = curves["c3p-a0.75"]
        by_lam = [reports[("c3p-a0.75", lam)] for lam in RD_LAMBDAS]
        for lo, hi in zip(by_lam, by_lam[1:]):  # λ ascending
            assert lo["bpp"] < hi["bpp"] and lo["d1_psnr"] < hi["d1_psnr"], \
                "the ladder is not monotone in λ"
        anchor_curve = sorted((r["bpp"], r["d1_psnr"]) for _, r in anchor)
        rate, snr = bdrate(anchor_curve, ladder), bdsnr(anchor_curve, ladder)
        assert np.isfinite(rate) and rate < 0, (rate, snr)
        try:
            trained = curves["c3p-train"]
            trained = (f"{bdrate(anchor_curve, trained):.3f}%, "
                       f"{bdsnr(anchor_curve, trained):.3f} dB")
        except ValueError as e:  # two points need overlapping ranges
            trained = f"not defined ({e})"
        walls["BD"] = time.time() - t0

        # 6. beside the JAX package's committed rows for this cloud
        jax = json.loads(RD_RESULTS.read_text())
        name = f"figure_{RD_SEED}"
        jrows = {r["lmbda"]: r for r in jax["points"]
                 if r["pc_name"] == name and "opt_group" not in r}
        log(f"RD on {card}, {name}, d1 group (JAX: {RD_RESULTS.name}; its "
            f"bpp counts gzip without a file name, the CLI's stream holds "
            f"{len(cloud.stem) + 8} bytes of it):")
        for lam, rep in zip(RD_LAMBDAS, by_lam):
            j = jrows[lam]
            log(f"  c3p-a0.75 λ {lam:g}: {rep['bpp']:.6f} bpp "
                f"(JAX {j['bpp']:.6f}, {rep['bpp'] - j['bpp']:+.6f}), D1 "
                f"{rep['d1_psnr']:.4f} dB (JAX {j['d1_psnr']:.4f}, "
                f"{rep['d1_psnr'] - j['d1_psnr']:+.4f})")
        for lam in RD_TRAIN_LAMBDAS:
            rep = reports[("c3p-train", lam)]
            log(f"  c3p-train λ {lam:g} ({RD_TRAIN_STEPS} steps): "
                f"{rep['bpp']:.6f} bpp, D1 {rep['d1_psnr']:.4f} dB")
        jan = {r["scale"]: r for r in jax["anchor_points"]
               if r["pc_name"] == name}
        log(f"anchor beside JAX's rows (mp_run writes the resolution "
            f"{int(points.max()) + 1} into the stream's header, rd_eval "
            f"{RESOLUTION}: a header field, the octree and its payload do "
            f"not depend on it):")
        for scale, rep in anchor:
            j = jan[scale]
            log(f"  scale {scale:g}: {rep['bpp']:.6f} bpp (JAX "
                f"{j['bpp']:.6f}, {rep['bpp'] - j['bpp']:+.2e}), D1 "
                f"{rep['d1_psnr']:.4f} dB (JAX {j['d1_psnr']:.4f}, "
                f"{rep['d1_psnr'] - j['d1_psnr']:+.2e})")
        jl = [(jrows[lam]["bpp"], jrows[lam]["d1_psnr"]) for lam in
              RD_LAMBDAS]
        ja = sorted((r["bpp"], r["d1_psnr"]) for r in jan.values())
        log(f"BD against the anchor on {name}: c3p-a0.75 BD-rate "
            f"{rate:.3f}%, BD-PSNR {snr:.3f} dB (JAX's committed rows of "
            f"this cloud: {bdrate(ja, jl):.3f}%, {bdsnr(ja, jl):.3f} dB); "
            f"c3p-train {trained}")
        log(f"ladder points {[(round(b, 6), round(p, 4)) for b, p in ladder]}")
    walls["phase"] = time.time() - t_phase
    log("phase 20 walls: " + ", ".join(f"{k} {v:.1f} s"
                                        for k, v in walls.items())
        + f" [{card}]")
    return counts


# phase 21: the RD evaluation tools (pcc_geo_cnn_v2_tpu_torch/tools) on the
# committed ladders: rd_eval --d2_group over RD_LADDER on RD21_SEEDS, its d1
# group on one λ, --fixed_threshold on the c1 rung, rd_ladder over the two
# reports, then a cut train sweep, its export and assets_to_ckpt
# rd_eval evaluates figure clouds 200-203; the phase takes 200 alone, so
# that the whole script stays well inside its time (with 203 beside it the
# script took 1,115.7 s of command time on an H100, phase 21 329.9 s)
RD21_SEEDS = (200,)
RD21_C1_RESULTS = REPO / "results/rd_c1_fixedthr.json"
# bounds against JAX's committed rows: bpp relative, PSNR in dB, by group.
# The committed d2-group rows were encoded before the JAX d2 sweep took the
# first distance-tied row (git log of results/rd_c3p_a075.json: they came
# in with that fix, from the evaluation that prompted it; the later schema
# change kept their picks), a rule that picked thresholds where its
# optimistic D2 peaked. The current rule, which K3 follows, scores no worse
# by host D2: on the d2 group the host D2 PSNR (and the d2 BD against the
# anchor) is held one-sided, no more than the bound below JAX's
RD21_BOUNDS = {"d1": (0.005, 0.05, ("d1_psnr", "d1_psnr_host")),
               "d2": (0.01, 0.1, ("d2_psnr",))}
RD21_ONE_SIDED = ("d2",)
# the fixed-threshold rows (the c1 rung): D1 PSNR within 0.1 dB. Their
# picks are all the middle threshold, so the rows move with x_hat alone,
# and c1's x_hat crowds it: at λ 1e-5 on figure_cloud(200), 29,151 voxels
# lie within 1e-3 of it, and the port's own f32 and bf16 convolutions
# give D1 PSNRs 0.044 dB apart on an H100
# (tools/torch_probe_fixed_threshold.py)
RD21_FIXED_BOUNDS = {"d1": (0.005, 0.1, ("d1_psnr",))}
RD21_BD_RATE_PTS, RD21_BD_PSNR_DB = 1.0, 0.1
RD21_ONE_LAMBDA = "1.00e-04"
# the sweep: two λ warm-seq at batch RD21_TRAIN_BATCH, RD21_TRAIN_STEPS
# asked (one K_INNER call each), blocks of two training clouds
RD21_TRAIN_LAMBDAS = (3e-4, 1e-4)
RD21_TRAIN_STEPS, RD21_TRAIN_BATCH = 3, 8
RD21_TRAIN_SEEDS, RD21_VAL_SEEDS = (0, 1), (100,)
RD21_FLAGSHIP = "c3p-a0.75 (adaptive, flagship protocol)"
RD21_C1 = "c1 (fixed thr)"


def rd21_rows(label, got, want, bounds=RD21_BOUNDS):
    """Hold each of ``got``'s rows against the JAX row of the same (λ,
    cloud, group) in ``want`` to ``bounds`` (one-sided for the groups
    of ``RD21_ONE_SIDED``); print both. Returns the extreme deviations by
    group: largest |bpp relative|, then the least and the largest PSNR
    difference in dB."""
    def key(r):
        return r["lmbda"], r["pc_name"], r.get("opt_group", "d1")

    want = {key(r): r for r in want}
    worst = {}
    for row in got:
        k = key(row)
        j = want[k]
        rel_max, db_max, cols = bounds[k[2]]
        rel = (row["bpp"] - j["bpp"]) / j["bpp"]
        cols_all = [c for c in ("d1_psnr", "d1_psnr_host", "d2_psnr",
                                "d2_psnr_enc", "d1_psnr_on_d2_group")
                    if c in row]
        log(f"  {label} λ {k[0]:g} {k[1]} {k[2]}: {row['bpp']:.6f} bpp "
            f"(JAX {j['bpp']:.6f}, {rel:+.3e}); " + ", ".join(
                f"{c} {row[c]:.4f} (JAX {j[c]:.4f}, {row[c] - j[c]:+.4f})"
                for c in cols_all))
        assert abs(rel) <= rel_max, (label, k, row["bpp"], j["bpp"])
        dev = [row[c] - j[c] for c in cols]
        if k[2] in RD21_ONE_SIDED:
            assert min(dev) >= -db_max, (label, k, cols, dev)
        else:
            assert max(map(abs, dev)) <= db_max, (label, k, cols, dev)
        w = worst.setdefault(k[2], [0.0, np.inf, -np.inf])
        w[:] = max(w[0], abs(rel)), min(w[1], *dev), max(w[2], *dev)
    return worst


def rd21_same_anchor(label, got, want, names):
    """The anchor rows of ``names``: equal to JAX's, value for value."""
    want = [r for r in want if r["pc_name"] in names]
    assert len(got) == len(want) and got == want, (label, got, want)
    log(f"  {label} anchor: {len(got)} rows ({sorted(names)}) equal to "
        f"JAX's, value for value")


def check_rd_tools(device, card, expect_launches):
    """Phase 21: the port's RD tools on the committed ladders. Returns the
    launch counts of its two rd_eval runs on the device path, summed."""
    import shutil
    import tempfile

    import torch

    from pcc_geo_cnn_v2_tpu_torch.ops import kernels
    from pcc_geo_cnn_v2_tpu_torch.tools import (
        assets_to_ckpt,
        export_rd_assets,
        rd_eval,
        rd_ladder,
        rd_train_all,
    )
    from pcc_geo_cnn_v2_tpu_torch.training import Trainer, read_checkpoint
    from pcc_geo_cnn_v2_tpu_torch.weights import (
        load_asset_tree,
        msgpack_serialize,
        params_to_jax,
    )

    t_phase = time.time()
    walls, worst = {}, {}
    names = {f"figure_{s}" for s in RD21_SEEDS}
    jax_flag = json.loads(RD_RESULTS.read_text())
    jax_c1 = json.loads(RD21_C1_RESULTS.read_text())
    sweep_kernels = ("bucket_colsums", "bucket_colsums_d2", "halo_edt",
                     "edt_sweep", "fused_tail", "fused_tail_slab")

    def counted(label, argv, **kw):
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.time()
        rep = rd_eval.main(argv + ["--device", device], **kw)
        torch.cuda.synchronize()
        walls[label] = time.time() - t0
        counts = dict(kernels.launches)
        log(f"{label}: {walls[label]:.1f} s; launches {counts}")
        return rep, counts

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        seeds = [str(s) for s in RD21_SEEDS]
        # 1. the d2 group on the committed c3p-a0.75 ladder
        rep, counts_a = counted("rd_eval --d2_group", [
            "--from-assets", "--d2_group", "--seeds", *seeds, "--out",
            str(tmp / "rd_c3p_a075.json")])
        expect_launches("rd_eval --d2_group", counts_a,
                        ("bucket_colsums_d2", "halo_edt"),
                        ("bucket_colsums", "edt_sweep", "fused_tail",
                         "fused_tail_slab"))
        jrows = [r for r in jax_flag["points"] if r["pc_name"] in names]
        janchor = [r for r in jax_flag["anchor_points"]
                   if r["pc_name"] in names]
        assert len(rep["points"]) == len(jrows) == 10 * len(RD21_SEEDS), \
            len(rep["points"])
        log(f"rd_eval --d2_group on {card}, against "
            f"{RD_RESULTS.name} (JAX's rows, made on a TPU):")
        worst["d2_group"] = rd21_rows("c3p-a0.75", rep["points"], jrows)
        rd21_same_anchor("c3p-a0.75", rep["anchor_points"], janchor, names)
        again = rd_eval.summarize(jrows, janchor, jax_flag["train_steps"])
        bd = {}
        for sec in ("bd_vs_builtin_octree_anchor",
                    "bd_vs_builtin_octree_anchor_d2"):
            got, want = rep[sec], again[sec]
            bd[sec] = (got["bd_rate_pct"], got["bd_psnr_db"],
                       want["bd_rate_pct"], want["bd_psnr_db"])
            log(f"  {sec}: BD-rate {got['bd_rate_pct']:.3f}% (JAX's rows "
                f"{want['bd_rate_pct']:.3f}%), BD-PSNR "
                f"{got['bd_psnr_db']:.4f} dB (JAX's rows "
                f"{want['bd_psnr_db']:.4f} dB)")
            d_rate = got["bd_rate_pct"] - want["bd_rate_pct"]
            d_psnr = got["bd_psnr_db"] - want["bd_psnr_db"]
            if sec.endswith("_d2"):  # the d2 group's rows: one-sided
                assert d_rate <= RD21_BD_RATE_PTS and \
                    d_psnr >= -RD21_BD_PSNR_DB, (sec, got, want)
            else:
                assert abs(d_rate) <= RD21_BD_RATE_PTS and \
                    abs(d_psnr) <= RD21_BD_PSNR_DB, (sec, got, want)
        assert rep["train_steps"] == jax_flag["train_steps"]

        # 1b. the d1 group (K1) on one λ, from an asset root holding it
        one = tmp / "one" / RD_LADDER.name
        one.mkdir(parents=True)
        (one / f"{RD21_ONE_LAMBDA}.msgpack.gz").symlink_to(
            RD_LADDER / f"{RD21_ONE_LAMBDA}.msgpack.gz")
        shutil.copy(RD_LADDER / "manifest.json", one)
        rep1, counts_d1 = counted("rd_eval (d1 group, one λ)", [
            "--from-assets", "--seeds", str(RD21_SEEDS[0]), "--out",
            str(tmp / "d1_one.json")], asset_root=one.parent)
        expect_launches("rd_eval's d1 group", counts_d1,
                        ("bucket_colsums", "halo_edt"),
                        ("bucket_colsums_d2", "edt_sweep", "fused_tail",
                         "fused_tail_slab"))
        assert len(rep1["points"]) == 1, rep1["points"]
        worst["d1_group"] = rd21_rows("c3p-a0.75", rep1["points"], jrows)

        # 2. the c1 rung: V1 transforms, the host path, 3 λ
        rep_c1, counts_c1 = counted("rd_eval --config c1 --fixed_threshold",
                                    ["--config", "c1", "--from-assets",
                                     "--fixed_threshold", "--seeds",
                                     str(RD21_SEEDS[0]), "--out",
                                     str(tmp / "rd_c1_fixedthr.json")])
        expect_launches("the c1 rung (host path)", counts_c1, (),
                        sweep_kernels)
        c1_names = {f"figure_{RD21_SEEDS[0]}"}
        jrows_c1 = [r for r in jax_c1["points"] if r["pc_name"] in c1_names]
        janchor_c1 = [r for r in jax_c1["anchor_points"]
                      if r["pc_name"] in c1_names]
        assert len(rep_c1["points"]) == len(jrows_c1) == 3
        log(f"rd_eval --config c1 --fixed_threshold on {card}, against "
            f"{RD21_C1_RESULTS.name}:")
        worst["c1_fixed"] = rd21_rows("c1", rep_c1["points"], jrows_c1,
                                      RD21_FIXED_BOUNDS)
        rd21_same_anchor("c1", rep_c1["anchor_points"], janchor_c1, c1_names)

        # 3. rd_ladder over the two reports, and over JAX's rows of the
        # same clouds
        t0 = time.time()
        ladder = {r["run_id"]: r for r in rd_ladder.main(
            ["--results_dir", str(tmp)])}
        ref_dir = tmp / "jax_rows"
        ref_dir.mkdir()
        (ref_dir / RD_RESULTS.name).write_text(json.dumps(again))
        (ref_dir / RD21_C1_RESULTS.name).write_text(json.dumps(
            rd_eval.summarize(jrows_c1, janchor_c1, jax_c1["train_steps"])))
        ladder_j = {r["run_id"]: r for r in rd_ladder.main(
            ["--results_dir", str(ref_dir)])}
        walls["rd_ladder"] = time.time() - t0
        ladder_bd = {}
        for rung in (RD21_C1, RD21_FLAGSHIP):
            got = ladder[rung]["bd_psnr_vs_builtin_anchor"]
            want = ladder_j[rung]["bd_psnr_vs_builtin_anchor"]
            got_d2 = ladder[rung].get("bd_psnr_d2_vs_builtin_anchor")
            want_d2 = ladder_j[rung].get("bd_psnr_d2_vs_builtin_anchor")
            ladder_bd[rung] = (got, want, got_d2, want_d2)
            log(f"  rd_ladder {rung}: BD-PSNR {got:.4f} dB (JAX's rows "
                f"{want:.4f}); d2 {got_d2} (JAX's rows {want_d2})")
            assert abs(got - want) <= RD21_BD_PSNR_DB, (rung, got, want)
        assert {"config_ladder.json", "data.csv"} <= {
            p.name for p in tmp.iterdir()}

        # 4. the λ-sweep trainer cut in depth, its export, assets_to_ckpt
        t0 = time.time()
        train = rd_train_all.load_blocks(RD21_TRAIN_SEEDS, "phase21_train",
                                         cache_dir=tmp)
        val = rd_train_all.load_blocks(RD21_VAL_SEEDS, "phase21_val",
                                       cache_dir=tmp)
        walls["training blocks"] = time.time() - t0
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.time()
        dirs = rd_train_all.train_sweep(
            tmp / "models", "c3p", 0.75, RD21_TRAIN_LAMBDAS, train, val,
            base_steps=RD21_TRAIN_STEPS, ft_steps=RD21_TRAIN_STEPS,
            batch_size=RD21_TRAIN_BATCH, device=device)
        torch.cuda.synchronize()
        walls["train_sweep"] = time.time() - t0
        counts_tr = dict(kernels.launches)
        assert not any(v for k, v in counts_tr.items()
                       if k not in NO_GRAD_KERNELS + TRAIN_KERNELS), counts_tr
        assert counts_tr["conv_wgrad"] > 0, counts_tr
        # steps advance K_INNER at a time, as the JAX tool's scan calls
        k = -(-RD21_TRAIN_STEPS // rd_train_all.K_INNER) * rd_train_all.K_INNER
        for d in dirs:
            assert (d / "done").exists(), d
            assert Trainer.latest_checkpoint(d).name == f"ckpt_{k}", d
        log(f"train_sweep: c3p at 64 filters, λ {RD21_TRAIN_LAMBDAS} "
            f"warm-seq, {RD21_TRAIN_STEPS} steps asked = {k} taken each at "
            f"batch {RD21_TRAIN_BATCH} on {len(train)} blocks of clouds "
            f"{RD21_TRAIN_SEEDS} ({walls['training blocks']:.1f} s to make "
            f"them), {walls['train_sweep']:.1f} s "
            f"({2 * k / walls['train_sweep']:.2f} steps/s with the set-up); "
            f"conv_wgrad {counts_tr['conv_wgrad']} times, no other kernel "
            f"in a step, conv_one_out {counts_tr['conv_one_out']} times in "
            f"its no-graph passes")
        t0 = time.time()
        export_rd_assets.export(tmp / "models", [dirs[0].parent.name],
                                tmp / "export")
        for d in dirs:  # equal trees serialise to equal bytes
            asset = tmp / "export" / d.parent.name / f"{d.name}.msgpack.gz"
            assert msgpack_serialize(load_asset_tree(asset)) == \
                msgpack_serialize(params_to_jax(read_checkpoint(
                    Trainer.latest_checkpoint(d))["params"])), d
        manifest = json.loads((tmp / "export" / dirs[0].parent.name
                               / "manifest.json").read_text())
        assert [m["ckpt_step"] for m in manifest.values()] == [k, k]
        (run,) = assets_to_ckpt.rehydrate(tmp / "rehydrated",
                                          [RD_LADDER.name],
                                          asset_root=one.parent)
        state = read_checkpoint(Trainer.latest_checkpoint(run))
        steps = json.loads((RD_LADDER / "manifest.json").read_text())
        assert state["step"] == steps[RD21_ONE_LAMBDA]["ckpt_step"]
        assert msgpack_serialize(params_to_jax(state["params"])) == \
            msgpack_serialize(load_asset_tree(
                RD_LADDER / f"{RD21_ONE_LAMBDA}.msgpack.gz")), run
        walls["export and assets_to_ckpt"] = time.time() - t0
        log(f"export_rd_assets: {len(dirs)} assets reload equal to the "
            f"trained params, manifest steps {k}; assets_to_ckpt of "
            f"{RD_LADDER.name}/{RD21_ONE_LAMBDA}: params equal to the "
            f"asset's, step {state['step']}, a fresh Adam state "
            f"({walls['export and assets_to_ckpt']:.1f} s)")
    walls["phase"] = time.time() - t_phase
    log("phase 21 worst deviations from JAX's rows (bpp relative, PSNR dB): "
        + json.dumps(worst))
    log("phase 21 BD (port, JAX's rows): " + json.dumps(bd)
        + "; ladder BD-PSNR (port, JAX's rows, d2 port, d2 JAX's rows): "
        + json.dumps(ladder_bd))
    log("phase 21 walls: " + ", ".join(f"{k} {v:.1f} s"
                                        for k, v in walls.items())
        + f" [{card}]")
    return {k: counts_a[k] + counts_d1[k] for k in counts_a}


# phase 22: the encoder / decoder --debug harness through the CLIs


def check_debug_cli(device, card, codec, points, chunk_points, blob_d1,
                    decoded_d1, counts_d1, expect_launches):
    """``compress --debug`` → ``decompress --debug`` of ``points`` (the
    phase 6 cloud without normals), counted; the stream, the decoded cloud
    and the launches against phase 6's, and the dump's x_hat against the
    canonical x_hat of ``codec`` on every chunk (``chunk_points(lo, hi)``
    gives a chunk's point lists). Returns the launch counts."""
    import tempfile

    import torch

    from pcc_geo_cnn_v2_tpu_torch.cli import compress, decompress
    from pcc_geo_cnn_v2_tpu_torch.ops import kernels
    from pcc_geo_cnn_v2_tpu_torch.utils import pc_io

    t_phase = time.time()
    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        ply, stream = Path(tmp) / "in.ply", Path(tmp) / "c.bin"
        dec_ply = Path(tmp) / "dec.ply"
        pc_io.write_ply(ply, points)
        args = ["--checkpoint_dir", str(ASSET), "--model_config", "c3p",
                "--batch_blocks", str(BATCH), "--device", device]
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.time()
        compress.main(["--input_files", str(ply), "--output_files",
                       str(stream), "--resolution", str(RESOLUTION),
                       "--octree_level", str(LEVEL), "--debug"] + args)
        torch.cuda.synchronize()
        walls["compress --debug"] = time.time() - t0
        t0 = time.time()
        # raises AssertionError naming the key if a decoded symbol differs
        decompress.main(["--input_files", str(stream), "--output_files",
                         str(dec_ply), "--debug"] + args)
        torch.cuda.synchronize()
        walls["decompress --debug"] = time.time() - t0
        counts = dict(kernels.launches)
        assert gzip.decompress(stream.read_bytes()) == gzip.decompress(
            blob_d1), "the --debug stream's payload differs from phase 6's"
        decoded = pc_io.load_points([dec_ply])[0]
        assert decoded.shape == decoded_d1.shape and np.array_equal(
            decoded, decoded_d1), "the decoded PLY differs from phase 6's"
        t0 = time.time()
        dump = np.load(str(stream) + ".enc.debug.npz")
        x_hat = dump["x_hat"]
        keys = sorted(dump.files)
        walls["load dump"] = time.time() - t0
    expect_launches("the --debug CLIs", counts,
                    ("bucket_colsums", "halo_edt"),
                    ("bucket_colsums_d2", "edt_sweep", "fused_tail",
                     "fused_tail_slab"))
    n = len(x_hat)
    # the dump's fused encode decodes every chunk once more
    chunks = len(codec._chunks(n))
    assert counts == {**counts_d1,
                      "conv_one_out": counts_d1["conv_one_out"] + chunks,
                      "conv_fwd": counts_d1["conv_fwd"]
                      + FWD_A_CHUNK * chunks}, (counts, counts_d1)
    assert keys == ["x_hat", "y_idx", "y_sym", "z_sym"], keys
    assert x_hat.shape == (n, BLOCK, BLOCK, BLOCK, 1), x_hat.shape
    t0 = time.time()
    for lo, hi in codec._chunks(n):
        canon = codec.canonical_chunk(chunk_points(lo, hi), hi - lo)
        canon = canon["x_hat"][:hi - lo].cpu().numpy()
        assert np.array_equal(canon.view(np.int32),
                              x_hat[lo:hi].view(np.int32)), \
            f"the dump's x_hat differs from the canonical one in [{lo}, {hi})"
    walls["canonical x_hat"] = time.time() - t0
    log(f"--debug CLIs: {n} blocks, decoded symbols equal the dump's, stream "
        f"payload and {len(decoded)} decoded points equal phase 6's, the "
        f"dump's x_hat ({x_hat.nbytes / 2 ** 20:.0f} MiB) equals the "
        f"canonical x_hat bit for bit; launches {counts}; walls "
        + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()))
    log(f"phase 22: {time.time() - t_phase:.1f} s [{card}]")
    return counts


# phase 23: conv_one_out, the synthesis transforms' last layer (one output
# channel), on real activations of a ONE_OUT_BLOCKS-block chunk


def one_out_inputs(codec, layer, pts):
    """The activations entering ``layer`` (a model's one-output-channel
    transposed conv) in ``codec``'s canonical decode of the blocks of
    ``pts``: [N, cin, S, S, S] f32."""
    import torch

    from pcc_geo_cnn_v2_tpu_torch.codec import deterministic_convs
    from pcc_geo_cnn_v2_tpu_torch.ops.voxel import voxelize

    seen = []
    hook = layer.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0]))
    try:
        with torch.no_grad():
            model = codec.model
            y_sym = model.encode_syms(voxelize(pts, BLOCK))["y_sym"]
            deterministic_convs()
            model.decode_y(y_sym)
    finally:
        hook.remove()
    assert len(seen) == 1, len(seen)
    return seen[0].contiguous()


def one_out_layers(device, codec, chunk_points):
    """(label, layer, activations) of c2's k9 32 -> 1 and c3p's k3 16 -> 1
    synthesis layers (the committed weights: ``rd/c2/V1_LAMBDA``, and
    ``codec``'s c3p) on the cloud's first ``ONE_OUT_BLOCKS`` blocks
    (``chunk_points(lo, hi)`` gives a chunk's point lists)."""
    import torch

    from pcc_geo_cnn_v2_tpu_torch.codec import BlockCodec
    from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
    from pcc_geo_cnn_v2_tpu_torch.weights import load_asset_tree

    pts = torch.cat([chunk_points(lo, lo + BATCH)
                     for lo in range(0, ONE_OUT_BLOCKS, BATCH)])
    codec_c2 = BlockCodec(build_model("c2"), load_asset_tree(
        RD_ASSETS / "c2" / f"{V1_LAMBDA}.msgpack.gz"), block_size=BLOCK,
        batch_blocks=BATCH, device=device)
    return [(label, layer, one_out_inputs(c, layer, pts)) for label, c, layer
            in (("c2 ConvTranspose_2", codec_c2,
                 codec_c2.model.synthesis_t.ConvTranspose_2),
                ("c3p ConvTranspose_0", codec,
                 codec.model.synthesis_t.ConvTranspose_0))]


def one_out_library(x, weight, bias, s):
    """The layer's cuDNN form, as ``ConvTranspose.forward`` computes it where
    the kernel does not route: s³ forward convs at stride 2, one padded
    ``conv3d`` at stride 1."""
    import torch.nn.functional as F

    from pcc_geo_cnn_v2_tpu_torch.models.transforms import (
        subpixel_conv_transpose,
        transpose_pads,
    )

    k = weight.shape[2]
    if s == 1:
        return F.conv3d(F.pad(x, transpose_pads(k, 1) * 3), weight, bias)
    outs = [s * n for n in x.shape[2:]]
    return subpixel_conv_transpose(x, weight, s, outs) + bias.view(
        1, -1, 1, 1, 1)


def check_conv_one_out(card, layers):
    """Phase 23 (module docstring). ``layers``: (label, layer, x) with x
    the real activations entering ``layer``. Returns one row a shape."""
    import torch

    from pcc_geo_cnn_v2_tpu_torch.codec import deterministic_convs
    from pcc_geo_cnn_v2_tpu_torch.ops import conv_one_out as coo
    from pcc_geo_cnn_v2_tpu_torch.ops import kernels

    t_phase = time.time()
    deterministic_convs()
    rows = []
    for label, layer, x in layers:
        k, s, (n, cin) = layer.k, layer.s, x.shape[:2]
        w, b = layer.weight.detach(), layer.bias.detach()
        assert n == ONE_OUT_BLOCKS, (label, x.shape)
        table = coo.pack_weights(w, s)

        def kernel(xs=x):
            return coo.conv_transpose_one_out(xs, table, b, k, s)

        kernels.reset_launches()
        with torch.no_grad():
            assert coo.routes(x, w, s), label
            got = kernel()
            assert kernels.launches["conv_one_out"] == 1
            # the module routes its no-graph calls through the kernel
            assert torch.equal(layer(x), got), f"{label}: module differs"
            want = one_out_library(x, w, b, s)
            err = float((got - want).abs().max() / want.abs().max())
            assert err <= ONE_OUT_TOL, (label, err)
            plain = coo.conv_transpose_one_out_plain(x[:7], table, b, k, s)
            err_plain = float((got[:7] - plain).abs().max()
                              / plain.abs().max())
            assert err_plain <= ONE_OUT_TOL, (label, err_plain)
            # every block's output alone, in 7-block calls and moved to
            # another place in the batch: bit for bit the 128-block call's
            for i in range(n):
                assert torch.equal(kernel(x[i:i + 1]), got[i:i + 1]), \
                    f"{label}: block {i} alone differs"
            for lo in range(0, n, 7):
                assert torch.equal(kernel(x[lo:lo + 7]), got[lo:lo + 7]), \
                    f"{label}: blocks {lo}.. in a 7-block call differ"
            rolled = kernel(torch.roll(x, 37, 0).contiguous())
            assert torch.equal(rolled, torch.roll(got, 37, 0)), \
                f"{label}: blocks moved in the batch differ"
            assert torch.equal(kernel(), got), f"{label}: two calls differ"
            ms = time_ms(kernel, 10, burst=4)
            library_ms = time_ms(lambda: one_out_library(x, w, b, s), 5)
        vox_in = x[0, 0].numel()
        flops = 2 * vox_in * k ** 3 * cin * n
        nbytes = 4 * (x.numel() + got.numel() + w.numel())
        bound_ms, bound_by = bound(nbytes, 0, flops)
        row = {"shape": label, "k": k, "s": s, "cin": cin, "blocks": n,
               "ms": ms, "us_a_block": 1e3 * ms / n, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_share": bound_ms / ms, "tflops": flops / ms / 1e9,
               "max_err_of_max": err, "plain_err_of_max": err_plain}
        rows.append(row)
        log(f"conv_one_out {label} (k{k} s{s} {cin} -> 1, {n} blocks of "
            f"{tuple(x.shape[2:])} -> {tuple(got.shape[2:])}): {ms:.4f} ms "
            f"({row['us_a_block']:.2f} us a block, {row['tflops']:.2f} "
            f"TFLOP/s), cuDNN form {library_ms:.4f} ms "
            f"({library_ms / ms:.1f}x), bound {bound_ms:.4f} ms by "
            f"{bound_by} ({100 * row['bound_share']:.1f}% reached); max "
            f"|err| / max |value| {err:.3g} against the cuDNN form, "
            f"{err_plain:.3g} against the plain version; batch widths 1, 7 "
            f"and {n}, moved blocks and two calls bit-equal [{card}]")
    log(f"phase 23: {time.time() - t_phase:.1f} s")
    return rows


# phase 24: conv_wgrad, training's stride-1 k3 weight gradients


def wgrad_library(xp, dy, weight, layout=None):
    """The weight gradient as cuDNN's deterministic algorithm computes it
    (``aten.convolution_backward``, the weight's part alone), in NCDHW or,
    with ``layout=torch.channels_last_3d``, channels-last."""
    import torch

    if layout is not None:
        xp, dy, weight = (t.contiguous(memory_format=layout)
                          for t in (xp, dy, weight))
    return torch.ops.aten.convolution_backward(
        dy, xp, weight, None, [1] * 3, [0] * 3, [1] * 3, False, [0] * 3, 1,
        (False, True, False))[1]


def routed_wgrad_layers(model):
    """Names of ``model``'s convolutions whose training weight gradient
    ``conv_wgrad`` computes (k3, stride 1, channels in its shapes)."""
    from pcc_geo_cnn_v2_tpu_torch.models.transforms import Conv, ConvTranspose
    from pcc_geo_cnn_v2_tpu_torch.ops import conv_wgrad

    return [name for name, m in model.named_modules()
            if isinstance(m, (Conv, ConvTranspose)) and m.k == 3
            and m.s == 1 and tuple(m.weight.shape[1::-1]) in conv_wgrad.SHAPES]


def check_conv_wgrad(card, device, blocks, codec_pass):
    """Phase 24 (module docstring). ``codec_pass()`` runs an encode and a
    decode. Returns (one row a shape, the launches of a training step)."""
    import copy
    import tempfile

    import torch
    import torch.nn.functional as F

    from pcc_geo_cnn_v2_tpu_torch.codec import deterministic_convs
    from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
    from pcc_geo_cnn_v2_tpu_torch.ops import conv_wgrad, kernels
    from pcc_geo_cnn_v2_tpu_torch.training import TrainConfig, Trainer
    from pcc_geo_cnn_v2_tpu_torch.utils.data import BlockDataset

    t_phase = time.time()
    deterministic_convs()
    gen = torch.Generator(device=device).manual_seed(24)

    def rel(a, b):
        return float((a.double() - b.double()).abs().max()
                     / b.double().abs().max())

    rows = []
    for label, cin, cout, size in WGRAD_LAYERS:
        x = torch.randn((BATCH, cin, size, size, size), generator=gen,
                        device=device)
        xp = F.pad(x, (1, 1) * 3)
        dy = torch.randn((BATCH, cout, size, size, size), generator=gen,
                         device=device)
        w = torch.zeros((cout, cin, 3, 3, 3), device=device,
                        requires_grad=True)
        assert conv_wgrad.routes(x, w, 3, 1), label
        with torch.no_grad():
            assert not conv_wgrad.routes(x, w, 3, 1), label

        def kernel():
            return conv_wgrad.conv3d_wgrad(xp, dy)

        kernels.reset_launches()
        got = kernel()
        assert kernels.launches["conv_wgrad"] == 1
        assert torch.equal(kernel(), got), f"{label}: two calls differ"
        t0 = time.time()
        plain = conv_wgrad.conv3d_wgrad_plain(xp, dy)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.time() - t0)
        exact = conv_wgrad.conv3d_wgrad_plain(xp.double(), dy.double())
        lib = torch.nn.grad.conv3d_weight(xp, w.shape, dy)
        err_plain, err_exact = rel(got, plain), rel(got, exact)
        err_lib, lib_exact = rel(got, lib), rel(lib, exact)
        assert err_plain <= WGRAD_TOL and err_exact <= WGRAD_TOL, \
            (label, err_plain, err_exact)
        assert err_lib <= WGRAD_LIB_TOL, (label, err_lib)
        ms = time_ms(kernel, 10, burst=4)
        library_ms = time_ms(
            lambda: torch.nn.grad.conv3d_weight(xp, w.shape, dy), 3)
        cudnn_ms = time_ms(lambda: wgrad_library(xp, dy, w.detach()), 3)
        cl_ms = time_ms(lambda: wgrad_library(
            xp, dy, w.detach(), torch.channels_last_3d), 3)
        flops = 2 * 27 * cin * cout * dy[:, 0].numel()
        nbytes = 4 * (xp.numel() + dy.numel() + w.numel())
        bound_ms, bound_by = bound(nbytes, 0, flops)
        row = {"shape": label, "cin": cin, "cout": cout, "size": size,
               "batch": BATCH, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "cudnn_det_ms": cudnn_ms,
               "cudnn_det_channels_last_ms": cl_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "bound_share": bound_ms / ms,
               "tflops": flops / ms / 1e9, "max_err_of_max": err_exact,
               "plain_err_of_max": err_plain, "library_err_of_max": err_lib,
               "library_exact_err_of_max": lib_exact}
        rows.append(row)
        log(f"conv_wgrad {label} ({cin} -> {cout} at {size}^3, batch "
            f"{BATCH}, {flops / 1e9:.2f} GFLOP): {ms:.4f} ms "
            f"({row['tflops']:.2f} TFLOP/s), bound {bound_ms:.4f} ms by "
            f"{bound_by} ({100 * row['bound_share']:.1f}% reached); "
            f"conv3d_weight {library_ms:.4f} ms ({library_ms / ms:.1f}x), "
            f"cuDNN's deterministic wgrad {cudnn_ms:.4f} ms NCDHW, "
            f"{cl_ms:.4f} ms channels-last; plain {plain_ms:.1f} ms; max "
            f"|err| / max |value| {err_exact:.3g} against the f64 sum, "
            f"{err_plain:.3g} against the plain version, {err_lib:.3g} "
            f"against conv3d_weight (itself {lib_exact:.3g} from the f64 "
            f"sum); two calls bit-equal [{card}]")
        del x, xp, dy, got, plain, exact, lib
    # ragged volumes: masked tile edges, and the 4- and 8-byte copies that
    # rows not a multiple of 16 bytes take
    for cin, cout in sorted(conv_wgrad.SHAPES):
        for size in WGRAD_RAGGED:
            xp = F.pad(torch.randn((3, cin, *size), generator=gen,
                                   device=device), (1, 1) * 3)
            dy = torch.randn((3, cout, *size), generator=gen, device=device)
            err = rel(conv_wgrad.conv3d_wgrad(xp, dy),
                      conv_wgrad.conv3d_wgrad_plain(xp.double(),
                                                    dy.double()))
            assert err <= WGRAD_TOL, (cin, cout, size, err)
    log(f"conv_wgrad on ragged volumes {WGRAD_RAGGED} at batch 3, every "
        f"shape: within {WGRAD_TOL} of the f64 sum")

    # a training step from one state twice: bit-equal parameters, one
    # launch a routed layer
    cfg = TrainConfig(batch_size=BATCH, block_size=BLOCK)
    with tempfile.TemporaryDirectory() as tmp:
        tr = Trainer(build_model("c3p"), cfg, tmp, seed=0, warm_start=ASSET,
                     device=device)
        data = tr.device_data(BlockDataset(blocks))
        routed = routed_wgrad_layers(tr.model)
        params = {k: v.clone() for k, v in tr.model.state_dict().items()}
        opt = copy.deepcopy(tr.opt.state_dict())
        after, counts = [], []
        torch.use_deterministic_algorithms(True)
        try:
            for _ in range(2):
                tr.model.load_state_dict(params)
                tr.opt.load_state_dict(copy.deepcopy(opt))
                kernels.reset_launches()
                tr.step_blocks(data, 1)
                torch.cuda.synchronize()
                counts.append(dict(kernels.launches))
                after.append({k: v.clone() for k, v in
                              tr.model.state_dict().items()})
        finally:
            torch.use_deterministic_algorithms(False)
        for k, v in after[0].items():
            assert torch.equal(v, after[1][k]), f"step from one state: {k}"
        assert not torch.equal(after[0][routed[0] + ".weight"],
                               params[routed[0] + ".weight"])
        for c in counts:
            assert c["conv_wgrad"] == len(routed), (c, routed)
            assert not any(v for k, v in c.items() if k != "conv_wgrad"), c
        del tr, data
    kernels.reset_launches()
    codec_pass()
    codec_counts = dict(kernels.launches)
    assert codec_counts["conv_wgrad"] == 0, codec_counts
    assert codec_counts["conv_fwd"] > 0, codec_counts
    log(f"a training step from one state twice: parameters bit-equal; "
        f"conv_wgrad launched {len(routed)} times a step, once a routed "
        f"layer ({', '.join(routed)}), no other kernel (conv_one_out and "
        f"conv_fwd 0); conv_wgrad 0 times in a codec encode and decode "
        f"(launches {codec_counts}) [{card}]")
    log(f"phase 24: {time.time() - t_phase:.1f} s")
    return rows, len(routed)


# phase 25: conv_fwd, the codec's stride-1 k3 synthesis tails, on real
# activations of a FWD_BLOCKS-block chunk


def check_conv_fwd(card, device, params, chunk_points):
    """Phase 25 (module docstring). ``chunk_points(lo, hi)`` gives a
    chunk's point lists. Returns (one row a routed layer, the launches of
    the chunk's ``decode_y``, whether its x_hat equals the one with the
    layers on cuDNN)."""
    import torch
    import torch.nn.functional as F

    from pcc_geo_cnn_v2_tpu_torch.codec import BlockCodec, deterministic_convs
    from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
    from pcc_geo_cnn_v2_tpu_torch.models.transforms import Conv, ConvTranspose
    from pcc_geo_cnn_v2_tpu_torch.ops import conv_fwd, kernels
    from pcc_geo_cnn_v2_tpu_torch.ops.voxel import voxelize

    t_phase = time.time()
    deterministic_convs()
    codec = BlockCodec(build_model("c3p"), params, block_size=BLOCK,
                       batch_blocks=FWD_BLOCKS, device=device)
    model = codec.model
    pts = torch.cat([chunk_points(lo, lo + BATCH)
                     for lo in range(0, FWD_BLOCKS, BATCH)])
    # the activations entering each stride-1 k3 layer of the synthesis in
    # one decode_y of the chunk, and the launches of that decode_y
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, name=name: seen.append((name, mod, args[0])))
        for name, m in model.synthesis_t.named_modules()
        if isinstance(m, (Conv, ConvTranspose)) and m.k == 3 and m.s == 1]
    try:
        with torch.no_grad():
            y_sym = model.encode_syms(voxelize(pts, BLOCK))["y_sym"]
            kernels.reset_launches()
            model.decode_y(y_sym)
            torch.cuda.synchronize()
            launches = kernels.launches["conv_fwd"]
            routed = [(name, m, x) for name, m, x in seen
                      if conv_fwd.routes(x, m.weight, m.k, m.s)]
    finally:
        for h in hooks:
            h.remove()
    assert launches == len(routed) == FWD_A_CHUNK, (launches, routed)
    rows = []
    for name, layer, x in routed:
        n, cin, size = x.shape[0], x.shape[1], tuple(x.shape[2:])
        w, b = layer.weight.detach(), layer.bias.detach()
        cout = w.shape[0]
        table = conv_fwd.pack_weights(w)

        def kernel(xs=x):
            return conv_fwd.conv3d(xs, table, b, relu=True)

        def library():
            return F.relu(F.conv3d(F.pad(x, (1, 1) * 3), w, b))

        with torch.no_grad():
            got = conv_fwd.conv3d(x, table, b)
            want = F.conv3d(F.pad(x, (1, 1) * 3), w, b)
            equal = bool(torch.equal(got, want))
            err = float((got - want).abs().max() / want.abs().max())
            assert err <= FWD_TOL, (name, err)
            got_r = kernel()
            assert torch.equal(got_r, F.relu(got)), f"{name}: ReLU"
            equal_r = bool(torch.equal(got_r, library()))
            # the module routes its no-graph calls through the kernel
            assert torch.equal(layer(x, relu=True), got_r), name
            plain = conv_fwd.conv3d_plain(x[:2], table, b, relu=True)
            err_plain = float((got_r[:2] - plain).abs().max()
                              / plain.abs().max())
            assert err_plain <= FWD_TOL, (name, err_plain)
            # every output alone, in 7-block calls and moved to another
            # place in the batch: bit for bit the FWD_BLOCKS-block call's
            for i in (0, 1, 64, n - 1):
                assert torch.equal(kernel(x[i:i + 1]), got_r[i:i + 1]), \
                    f"{name}: block {i} alone differs"
            for lo in range(0, n, 7):
                assert torch.equal(kernel(x[lo:lo + 7]), got_r[lo:lo + 7]), \
                    f"{name}: blocks {lo}.. in a 7-block call differ"
            rolled = kernel(torch.roll(x, 37, 0).contiguous())
            assert torch.equal(rolled, torch.roll(got_r, 37, 0)), \
                f"{name}: blocks moved in the batch differ"
            assert torch.equal(kernel(), got_r), f"{name}: two calls differ"
            ms = time_ms(kernel, 10, burst=4)
            library_ms = time_ms(library, 5, burst=4)
        flops = 2 * 27 * cin * cout * x[:, 0].numel()
        nbytes = 4 * (x.numel() + got.numel() + w.numel())
        bound_ms, bound_by = bound(nbytes, 0, flops)
        row = {"layer": name, "cin": cin, "cout": cout, "size": size,
               "blocks": n, "ms": ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_share": bound_ms / ms, "tflops": flops / ms / 1e9,
               "library_tflops": flops / library_ms / 1e9,
               "equal_to_library": equal and equal_r,
               "max_err_of_max": err, "plain_err_of_max": err_plain}
        rows.append(row)
        log(f"conv_fwd {name} ({cin} -> {cout} at {size}, {n} blocks, "
            f"{flops / 1e9:.1f} GFLOP): {ms:.4f} ms ({row['tflops']:.2f} "
            f"TFLOP/s), cuDNN layer (pad, conv + bias, ReLU) "
            f"{library_ms:.4f} ms ({library_ms / ms:.2f}x, "
            f"{row['library_tflops']:.2f} TFLOP/s), bound {bound_ms:.4f} ms "
            f"by {bound_by} ({100 * row['bound_share']:.1f}% reached); "
            f"bit-equal to cuDNN {equal} (with the ReLU {equal_r}; max "
            f"|err| / max |value| {err:.3g}), {err_plain:.3g} against the "
            f"plain version; batch widths 1, 7 and {n}, moved blocks and two "
            f"calls bit-equal [{card}]")
        del got, want, got_r, plain, rolled
    del routed, seen
    # the encoder's canonical x_hat and the decoder's of the same symbols,
    # with the route on; and against the layers on cuDNN (the route off)
    with torch.no_grad():
        enc = codec.canonical_chunk(pts, FWD_BLOCKS)
        kernels.reset_launches()
        x_dec = model.decode_y(enc["y_sym"])
        torch.cuda.synchronize()
        assert kernels.launches["conv_fwd"] == FWD_A_CHUNK
        assert torch.equal(enc["x_hat"][:FWD_BLOCKS], x_dec), \
            "encoder and decoder x_hat differ with the route on"
        routes = conv_fwd.routes
        conv_fwd.routes = lambda *a: False
        try:
            kernels.reset_launches()
            x_cudnn = model.decode_y(enc["y_sym"])
            assert kernels.launches["conv_fwd"] == 0
        finally:
            conv_fwd.routes = routes
        same = bool(torch.equal(x_cudnn, x_dec))
        diff = int((x_cudnn != x_dec).sum())
    log(f"conv_fwd in a decode_y of {FWD_BLOCKS} blocks: {launches} "
        f"launches ({', '.join(r['layer'] for r in rows)}); encoder "
        f"(canonical_chunk) and decoder x_hat bit-equal with the route on; "
        f"x_hat with the layers on cuDNN bit-equal {same} ({diff} values "
        f"differ) [{card}]")
    log(f"phase 25: {time.time() - t_phase:.1f} s")
    return rows, launches, same


def main():
    import os

    import torch

    # cuBLAS reads this when it makes its handle; phase 15 runs the
    # factorized prior's batched products under deterministic algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
            k5 = check_k5(codec, pts, res["x_hat"], res["picks"])
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
    blob_d1, decoded_d1 = blobs[0], decoded[0]
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
                    ("bucket_colsums", "halo_edt", "conv_one_out",
                     "conv_fwd"),
                    ("bucket_colsums_d2", "edt_sweep") + TRAIN_KERNELS)
    # the synthesis' last layer: one launch a chunk in the encoder's
    # canonical decode and one in the decoder's; its routed tails
    # FWD_A_CHUNK a chunk in each
    n_chunks = -(-len(blocks) // BATCH)
    assert counts_d1["conv_one_out"] == 2 * n_chunks, counts_d1
    assert counts_d1["conv_fwd"] == 2 * n_chunks * FWD_A_CHUNK, counts_d1

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
        assert codec_v.strings.has_z == (cfg == "c2")
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
        log(f"{cfg} ({'v2' if codec_v.strings.has_z else 'v1'}, V1 "
            f"transforms, "
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

    # phase 15: training c3p, then its weights through the d1 path
    counts_tr = check_training(device, blocks, params, drive,
                               expect_launches, points, psnr)

    # phase 16: the benchmark driver, K1 first at its 128-block chunk
    del codec_c, codec_cb, codec_b, codec_x
    torch.cuda.empty_cache()
    codec128 = BlockCodec(build_model("c3p", dtype=torch.bfloat16), params,
                          block_size=BLOCK, batch_blocks=128, device=device)
    k1["bench_chunk"], counts_bench, _ = check_bench(
        codec128, flat_dev, offsets, budget, expect_launches)
    k1["max_abs_err"] = max(k1["max_abs_err"],
                            k1["bench_chunk"]["max_abs_err"])
    del codec128
    torch.cuda.empty_cache()

    # phase 17: blocks round-robin over two replicas (the cards present when
    # there are several), streams and decoded blocks against phase 6's
    t_phase = time.time()
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    rr_devices = cards if len(cards) > 1 else cards * 2
    codec_rr = BlockCodec(build_model("c3p"), params, block_size=BLOCK,
                          batch_blocks=BATCH, devices=rr_devices)
    assert codec_rr._lanes[0].model is not codec_rr._lanes[1].model
    blobs, metadata, decoded, counts_rr, t_enc, t_dec = drive(codec_rr)
    assert blobs[0] == blob_d1, "the round-robin stream differs from phase 6's"
    assert np.array_equal(decoded[0], decoded_d1), "decoded blocks differ"
    expect_launches("the round robin", counts_rr,
                    ("bucket_colsums", "halo_edt"),
                    ("bucket_colsums_d2", "edt_sweep") + k4_names)
    assert counts_rr == counts_d1, (counts_rr, counts_d1)
    log(f"round robin over {[str(d) for d in rr_devices]} (one c3p replica "
        f"each, chunk k on replica k mod {len(rr_devices)}): stream bytes and "
        f"{len(decoded[0])} decoded points equal phase 6's; encode "
        f"{t_enc:.2f} s, decode {t_dec:.2f} s; launches {counts_rr}")
    del codec_rr
    log(f"phase 17: {time.time() - t_phase:.1f} s")

    # phase 18: data-parallel training
    torch.cuda.empty_cache()
    counts_dp = check_data_parallel(device, blocks)

    # phase 19: spatial sharding of a 256³ cell, then the dry run
    torch.cuda.empty_cache()
    counts_sp = check_spatial(device, points, card)

    # phase 20: the RD experiment pipeline on the committed λ ladder
    torch.cuda.empty_cache()
    counts_rd = check_rd_pipeline(device, card, expect_launches)

    # phase 21: the RD evaluation tools on the committed ladders
    torch.cuda.empty_cache()
    counts_rt = check_rd_tools(device, card, expect_launches)

    # phase 22: the --debug harness through the CLIs, against phase 6
    torch.cuda.empty_cache()
    counts_dbg = check_debug_cli(
        device, card, codec, points,
        lambda lo, hi: codec.chunk_points(flat_dev, offsets, lo, hi, budget),
        blob_d1, decoded_d1, counts_d1, expect_launches)

    # phase 23: conv_one_out on real activations of the first 128 blocks
    torch.cuda.empty_cache()
    one_out = check_conv_one_out(card, one_out_layers(
        device, codec,
        lambda lo, hi: codec.chunk_points(flat_dev, offsets, lo, hi, budget)))

    # phase 24: conv_wgrad, training's stride-1 k3 weight gradients; the
    # codec pass is the cut's encode and decode
    torch.cuda.empty_cache()
    wgrad, wgrad_step = check_conv_wgrad(card, device, blocks,
                                         lambda: drive(codec, cloud=cut))

    # phase 25: conv_fwd on real activations of the first 128 blocks
    torch.cuda.empty_cache()
    fwd, fwd_chunk, fwd_same = check_conv_fwd(
        card, device, params,
        lambda lo, hi: codec.chunk_points(flat_dev, offsets, lo, hi, budget))

    by_path = {"d1": counts_d1, "A": counts_a, "B": counts_b, "C": counts_c,
               "C_bf16": counts_cb, "c2": counts_v1["c2"],
               "c1": counts_v1["c1"], "host_fixed": counts_hf,
               "host_cut": counts_hc, "point_d2_cut": counts_pd,
               "trained_c3p": counts_tr, **counts_bench,
               "round_robin": counts_rr, "dp_nccl1": counts_dp,
               "sp_nccl1": counts_sp, "rd": counts_rd,
               "rd_eval": counts_rt, "debug_cli": counts_dbg}
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
    rows.append({"name": "conv_one_out", "route": "cuda",
                 "source": "pcc_geo_cnn_v2_tpu_torch/csrc/conv_one_out.cu",
                 "replaces": None, "launches": counts_d1["conv_one_out"],
                 "path": "d1", "shapes": one_out,
                 "launches_by_path": {k: v.get("conv_one_out")
                                      for k, v in by_path.items()}})
    rows.append({"name": "conv_wgrad", "route": "cuda",
                 "source": "pcc_geo_cnn_v2_tpu_torch/csrc/conv_wgrad.cu",
                 "replaces": None, "launches": wgrad_step,
                 "path": "a c3p training step", "shapes": wgrad,
                 "launches_by_path": {k: v.get("conv_wgrad")
                                      for k, v in by_path.items()}})
    rows.append({"name": "conv_fwd", "route": "cuda",
                 "source": "pcc_geo_cnn_v2_tpu_torch/csrc/conv_fwd.cu",
                 "replaces": None, "launches": fwd_chunk,
                 "path": f"a decode_y of {FWD_BLOCKS} blocks",
                 "x_hat_equal_to_cudnn": fwd_same, "shapes": fwd,
                 "launches_by_path": {k: v.get("conv_fwd")
                                      for k, v in by_path.items()}})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
