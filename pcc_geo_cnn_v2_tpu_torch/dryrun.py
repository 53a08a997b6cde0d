"""Dry run: the flagship's loss on one device, and the multi-device legs.

    python -m pcc_geo_cnn_v2_tpu_torch.dryrun [N] [--device cuda|cpu]

The port's counterpart of the root ``__graft_entry__.py``:

- :func:`entry` returns ``(fn, example_args)``: ``fn(model, points,
  noise)`` is c3p's training forward plus the RD loss and the aux loss
  (``training.make_loss_fn``) on one 64³ block of ``synthetic_blocks(1,
  64, seed=0)``, the scalar JAX ``entry()`` returns. The weights come from
  ``training.init_params`` with a seeded generator, or from a flax tree
  (``weights.params_from_jax``); the noise from a seeded generator, or as
  given (NDHWC, ``models/codec_models.py``).
- :func:`dryrun_multichip` spawns ``n`` ranks in a ``torch.distributed``
  group (``parallel.mesh.process_group``, a ``file://`` rendezvous in a
  temporary directory) and runs JAX ``_dryrun_impl``'s two legs: one
  data-parallel c3p training step at 16³ and a global batch of ``n``
  (``Trainer(group=...)``; the loss finite, the parameters bit-identical
  across the ranks), then ``parallel.spatial.encode_syms_spatial`` over
  ``min(n, 4)`` ranks on a block of depth ``max(16·min(n, 4), 32)`` with an
  8-filter ProgressiveV2 model, against the unsharded ``encode_syms`` (under
  5e-4 of the symbols differ). Its last analysis and hyper-analysis
  weights are scaled by 30 so that the symbols are not all zero (a fresh
  init's are, and then any two encodes agree). On cards rank r takes
  card r mod cards; ranks that share a card meet over ``gloo``
  (``mesh.backend_for``).

The command runs both and prints JAX's ``OK`` lines. A rank that fails or
outlives the timeout fails the run; without a card, ``device="cuda"``
raises.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import multiprocessing
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from pcc_geo_cnn_v2_tpu_torch.codec import deterministic_convs
from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
from pcc_geo_cnn_v2_tpu_torch.parallel.mesh import process_group
from pcc_geo_cnn_v2_tpu_torch.parallel.spatial import (
    depth_slab,
    encode_syms_spatial,
    gather_depth,
)
from pcc_geo_cnn_v2_tpu_torch.training import (
    TrainConfig,
    Trainer,
    draw_noise,
    init_params,
    make_loss_fn,
)
from pcc_geo_cnn_v2_tpu_torch.utils.data import BlockDataset, synthetic_blocks
from pcc_geo_cnn_v2_tpu_torch.weights import params_from_jax

__all__ = ["entry", "dryrun_multichip", "spawn_ranks"]

ENTRY_BLOCK = 64
DP_BLOCK, DP_MAX_POINTS = 16, 256
SP_MAX_WORLD, SP_POINTS, SP_MISMATCH = 4, 4096, 5e-4
# a fresh init's y and z round to zero symbols, which any two encodes
# share: the last analysis and hyper-analysis weights are scaled by this
SP_LATENT_SCALE = 30.0
SP_CONFIG = dict(model="v2", num_filters=8,
                 analysis="AnalysisTransformProgressiveV2",
                 synthesis="SynthesisTransformProgressiveV2")
TIMEOUT_S = 600


def _device(device):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "CPU explicitly")
    return device


def entry(device="cuda", params=None, noise=None):
    """(fn, example_args): ``fn(model, points, noise)`` → c3p's scalar RD
    + aux loss on one 64³ block.

    :param params: a flax param tree (``{"params": ...}``, numpy or JAX
        leaves) to load, e.g. JAX ``entry()``'s; default
        ``init_params`` from seed 0.
    :param noise: ``{"noise_y", "noise_z"}`` NDHWC arrays; default drawn
        from a generator seeded with 1.
    """
    device = _device(device)
    model = init_params(build_model("c3p"), torch.Generator().manual_seed(0))
    if params is not None:
        model.load_state_dict(params_from_jax(params))
    model.to(device).train()
    if device.type == "cuda":
        deterministic_convs()
    cfg = TrainConfig(block_size=ENTRY_BLOCK, batch_size=1)
    # every point of the block: a dropped point would corrupt the target
    points = torch.as_tensor(BlockDataset(synthetic_blocks(
        1, ENTRY_BLOCK, seed=0))._pack([0]), device=device)
    if noise is None:
        noise = draw_noise(model, 1, ENTRY_BLOCK,
                           torch.Generator(device=device).manual_seed(1))
    else:
        noise = {k: torch.as_tensor(np.asarray(v), device=device)
                 for k, v in noise.items()}

    def fn(model, points, noise):
        return make_loss_fn(model, cfg)(points, noise)[0]

    return fn, (model, points, noise)


def spawn_ranks(target, world, args=(), timeout_s=TIMEOUT_S):
    """Run ``target(rank, *args)`` in ``world`` spawned processes and wait
    for them all. A rank that exits non-zero, or is alive at the deadline
    (then killed), raises."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, *args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(timeout=max(deadline - time.monotonic(), 0))
    alive = [r for r, p in enumerate(procs) if p.is_alive()]
    for r in alive:
        procs[r].kill()
        procs[r].join()
    if alive:
        raise RuntimeError(f"ranks {alive} did not finish in {timeout_s} s")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"a rank failed: exit codes {codes}")


def _digest(model):
    h = hashlib.sha256()
    for v in model.state_dict().values():
        h.update(v.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _sp_block(depth):
    """JAX's sp input: ``SP_POINTS`` random voxels of a depth³ cube."""
    rng = np.random.default_rng(0)
    x = np.zeros((1, depth, depth, depth, 1), np.float32)
    pts = rng.integers(0, depth, size=(SP_POINTS, 3))
    x[0, pts[:, 0], pts[:, 1], pts[:, 2], 0] = 1.0
    return x


def _rank_main(rank, world, init_method, device, out_dir):
    """One rank of :func:`dryrun_multichip`: writes ``rank<r>.json``."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    out = {}
    with process_group(rank, world, init_method, device) as (group, dev):
        out["backend"], out["device"] = dist.get_backend(group), str(dev)
        # 1. one data-parallel c3p step
        cfg = TrainConfig(block_size=DP_BLOCK, batch_size=world)
        ds = BlockDataset(synthetic_blocks(world, DP_BLOCK, seed=0),
                          max_points=DP_MAX_POINTS)
        with tempfile.TemporaryDirectory() as ckpt:
            trainer = Trainer(build_model("c3p"), cfg, ckpt, seed=0,
                              device=dev, group=group)
            out["loss"] = float(trainer.step_batch(
                next(ds.batches(world, seed=0)), 1)["loss"])
            out["digest"] = _digest(trainer.model)
        # 2. the sp-sharded encode of one block over min(world, 4) ranks
        sp_world = min(world, SP_MAX_WORLD)
        sp_group = (group if sp_world == world
                    else dist.new_group(list(range(sp_world))))
        if rank < sp_world:
            depth = max(16 * sp_world, 32)
            model = init_params(build_model(SP_CONFIG),
                                torch.Generator().manual_seed(2))
            with torch.no_grad():  # latents an init rounds to 0 otherwise
                model.analysis_t.Conv_0.weight.mul_(SP_LATENT_SCALE)
                model.hyper_analysis_t.Conv_2.weight.mul_(SP_LATENT_SCALE)
            model.to(dev).eval()
            x = torch.from_numpy(_sp_block(depth)).to(dev)
            got = encode_syms_spatial(model, depth_slab(x, sp_group),
                                      sp_group)
            got = {k: gather_depth(v, sp_group) for k, v in got.items()}
            if rank == 0:
                deterministic_convs()
                want = model.encode_syms(x)
                out["sp"] = {"world": sp_world, "depth": depth, "mismatch": {
                    k: float((got[k] != want[k]).float().mean())
                    for k in want}, "nonzero": {
                    k: float((want[k] != 0).float().mean()) for k in want}}
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))


def dryrun_multichip(n_devices, device="cuda", timeout_s=TIMEOUT_S):
    """The two legs over ``n_devices`` ranks (module docstring); prints the
    OK lines and returns the ranks' records. Raises when a leg fails."""
    device = _device(device)
    with tempfile.TemporaryDirectory() as tmp:
        init = (Path(tmp) / "rendezvous").resolve().as_uri()
        spawn_ranks(_rank_main, n_devices,
                    (n_devices, init, device.type, tmp), timeout_s)
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                 for r in range(n_devices)]
    loss = ranks[0]["loss"]
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    if len({r["digest"] for r in ranks}) != 1:
        raise RuntimeError("the ranks' parameters differ after the step")
    devices = sorted({r["device"] for r in ranks})
    print(f"dryrun_multichip({n_devices}): loss={loss:.4f} group dp="
          f"{n_devices} ({ranks[0]['backend']} on {', '.join(devices)}) OK",
          flush=True)
    sp = ranks[0]["sp"]
    if not min(sp["nonzero"].values()) > 0:
        raise RuntimeError(f"all-zero symbols compare equal: {sp}")
    for k, mismatch in sp["mismatch"].items():
        if not mismatch < SP_MISMATCH:
            raise RuntimeError(f"sp-sharded {k}: {mismatch:.2e} of the "
                               f"symbols differ from the unsharded encode")
    print(f"dryrun_multichip({n_devices}): sp-sharded encode of a "
          f"{sp['depth']}^3 block over group sp={sp['world']} OK", flush=True)
    return ranks


def main(argv=None):
    parser = argparse.ArgumentParser(prog="dryrun", description=__doc__.split(
        "\n\n")[0])
    parser.add_argument("n_devices", nargs="?", type=int, default=2)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    fn, example = entry(args.device)
    print(f"entry loss: {fn(*example).item()}", flush=True)
    dryrun_multichip(args.n_devices, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
