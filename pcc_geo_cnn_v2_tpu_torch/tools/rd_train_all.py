"""Train a (config, α) λ sweep for the RD artifacts (port of the JAX
package's ``tools/rd_train_all.py``, the JAX argv plus ``--device``).

The reference protocol (``ev_experiment.yml:10-46`` λ grids,
``tr_train_all.py:57-61`` warm-seq chaining): a base model at the highest
λ, then each lower λ warm-started from the previous one. Checkpoints land
in ``<out>/<config>[-a<α>]/<λtag>/ckpt_<step>`` (the port's checkpoint
layout, which ``training.load_params``, ``tools/rd_eval.py`` and
``tools/export_rd_assets.py`` read) with ``done`` markers:

- a λ whose ``done`` marker exists is skipped and reloaded as the next
  λ's warm-start source; with ``--extend N`` it trains N more steps from
  its own checkpoint (params and Adam state);
- steps advance ``K_INNER`` = 50 at a time, as the JAX tool's scan calls,
  so ``--base_steps 3`` trains 50 steps; a validation probe every 1000
  steps, and with ``--patience_steps`` early stop and the best-val params
  checkpointed (a final probe of a tail shorter than 1000 steps).

The whole block dataset lives on the device as one int8 array, batches are
drawn there (``training.Trainer.step_blocks``).

    python -m pcc_geo_cnn_v2_tpu_torch.tools.rd_train_all [models/rd] \\
        [--config c3p] [--base_steps N] [--ft_steps N]
"""

from __future__ import annotations

import argparse
import json
import logging
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["LAMBDAS", "K_INNER", "lmbda_tag", "load_blocks", "train_sweep",
           "main"]

# reference λ grids, high→low rate (warm-seq chains down the curve);
# ev_experiment.yml:13,41-46
LAMBDAS = {
    "c1": [2e-4, 1e-4, 5e-5, 1e-5, 5e-6],
    "c2": [2e-4, 1e-4, 5e-5, 1e-5, 5e-6],
    "c3": [3e-4, 1e-4, 5e-5, 2e-5],
    "c3p": [3e-4, 1e-4, 5e-5, 2e-5, 1e-5],
}
TRAIN_SEEDS = range(24)
VAL_SEEDS = range(100, 102)
BUDGET = 8192
K_INNER = 50
PROBE_EVERY = 1000
# the JAX tool's keys: params init, the batches of the i-th λ, val probes
INIT_SEED, BATCH_SEED, VAL_STEP = 42, 1234, 7


def lmbda_tag(lmbda):
    return f"{float(lmbda):.2e}"


def load_blocks(seeds, cache_tag, cache_dir=None):
    """``figure_blocks`` of ``seeds`` packed to ``[N, BUDGET, 3]`` int8
    (-1 padding), with an on-disk cache in ``cache_dir`` (default the
    temporary directory; generation is seconds a cloud)."""
    from pcc_geo_cnn_v2_tpu_torch.utils.data import BlockDataset
    from pcc_geo_cnn_v2_tpu_torch.utils.scansim import figure_blocks

    cache = (Path(cache_dir or tempfile.gettempdir())
             / f"pcc_torch_rd_blocks_{cache_tag}.npz")
    if cache.exists():
        with np.load(cache) as z:
            return z["packed"]
    blocks = figure_blocks(list(seeds), max_points=BUDGET)
    ds = BlockDataset(blocks, max_points=BUDGET)
    packed = ds._pack(np.arange(len(ds))).astype(np.int8)
    cache.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(cache, packed=packed)
    return packed


def _probe(trainer, val_data):
    """Mean val RD loss with the same noise at every probe (JAX: one
    fixed key)."""
    return trainer.val_loss_blocks(val_data, VAL_STEP)


def train_sweep(out_dir, config, alpha, lambdas, train_blocks, val_blocks,
                base_steps=30_000, ft_steps=10_000, batch_size=32,
                extend=0, patience_steps=0, run_id=None, device="cuda",
                block_size=64):
    """Train ``lambdas`` in order under ``out_dir/<run_id>/<λtag>``.

    :param config: a model config name, or a config dict (then
        ``run_id`` is required).
    :param train_blocks, val_blocks: ``[N, P, 3]`` int arrays (-1
        padding), as :func:`load_blocks` gives them.
    :return: the run directories, in the order of ``lambdas``.
    """
    import torch

    from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
    from pcc_geo_cnn_v2_tpu_torch.training import (
        TrainConfig,
        Trainer,
        load_params,
    )
    from pcc_geo_cnn_v2_tpu_torch.weights import params_from_jax

    if run_id is None:
        if not isinstance(config, str):
            raise ValueError("a config dict needs a run_id")
        run_id = (config if alpha == 0.9 else f"{config}-a{alpha:g}")
    prev_params = None
    run_dirs = []
    for li, lmbda in enumerate(lambdas):
        cfg = TrainConfig(block_size=block_size, batch_size=batch_size,
                          lmbda=lmbda, alpha=alpha)
        run_dir = Path(out_dir) / run_id / lmbda_tag(lmbda)
        run_dir.mkdir(parents=True, exist_ok=True)
        run_dirs.append(run_dir)
        done = (run_dir / "done").exists()
        if done and not extend:
            print(f"λ={lmbda:g}: done marker exists, skipping", flush=True)
            # reloaded as the warm-start source of the next λ
            prev_params = params_from_jax(load_params(run_dir))
            continue
        if not done:
            # an unfinished run starts over, as the JAX tool's does
            for stale in run_dir.glob("ckpt_*"):
                shutil.rmtree(stale)
        # a done run's trainer restores its latest checkpoint (params,
        # Adam state, step)
        trainer = Trainer(build_model(config), cfg, run_dir, seed=INIT_SEED,
                          device=device)
        resumed = trainer.start_step
        if done:
            print(f"λ={lmbda:g}: extending from step {resumed}", flush=True)
            steps = extend
        else:
            if prev_params is not None:  # warm-seq from the previous λ
                trainer.model.load_state_dict(prev_params)
            steps = base_steps if li == 0 else ft_steps
        trainer.seed = BATCH_SEED + li
        data = torch.as_tensor(np.asarray(train_blocks, np.int8),
                               device=trainer.device)
        val_data = torch.as_tensor(np.asarray(val_blocks, np.int8),
                                   device=trainer.device)
        log_path = run_dir / "train_log.jsonl"
        t0 = time.time()
        done_steps = 0
        best_val, best_params, best_step = np.inf, None, 0

        def snapshot():
            return {k: v.detach().clone()
                    for k, v in trainer.model.state_dict().items()}

        early = False
        while done_steps < steps:
            for i in range(K_INNER):
                logs = trainer.step_blocks(data, done_steps + i + 1)
            done_steps += K_INNER
            if done_steps % PROBE_EVERY == 0:
                vloss = _probe(trainer, val_data)
                rate = done_steps / (time.time() - t0)
                rec = {"step": done_steps, "split": "train",
                       **{k: float(v) for k, v in logs.items()},
                       "val_loss": vloss, "steps_per_sec": rate}
                if patience_steps:
                    if vloss < best_val:
                        best_val, best_step = vloss, done_steps
                        best_params = snapshot()
                    elif done_steps - best_step >= patience_steps:
                        rec["early_stop"] = done_steps
                        rec["best_step"] = best_step
                        rec["best_val"] = best_val
                with open(log_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                print(f"λ={lmbda:g} step {done_steps}/{steps}: "
                      f"loss {rec['loss']:.1f} mbpov {rec['mbpov']:.3f} "
                      f"val {vloss:.1f} ({rate:.1f} it/s)", flush=True)
                if "early_stop" in rec:
                    print(f"λ={lmbda:g}: early stop at {done_steps} "
                          f"(best val {best_val:.1f} @ {best_step})",
                          flush=True)
                    early = True
                    break
        if not early and patience_steps and done_steps % PROBE_EVERY:
            # a tail between probes gets a final one, so that best-val
            # checkpointing cannot silently discard it
            vloss = _probe(trainer, val_data)
            with open(log_path, "a") as f:
                f.write(json.dumps({"step": done_steps,
                                    "split": "final_probe",
                                    "val_loss": vloss}) + "\n")
            if vloss < best_val:
                best_val, best_step = vloss, done_steps
                best_params = snapshot()
        if best_params is not None:
            # the checkpoint holds the BEST-val params (the reference's
            # best-loss Saver) beside the final Adam state
            trainer.model.load_state_dict(best_params)
            trainer.save(resumed + best_step)
        else:
            trainer.save(resumed + done_steps)
        (run_dir / "done").touch()
        print(f"λ={lmbda:g}: saved to {run_dir}", flush=True)
        prev_params = snapshot()
        del trainer
    return run_dirs


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(prog="rd_train_all")
    ap.add_argument("out_dir", nargs="?", default="models/rd")
    ap.add_argument("--config", default="c3p",
                    choices=["c1", "c2", "c3", "c3p"])
    ap.add_argument("--alpha", type=float, default=None,
                    help="focal-loss alpha; default 0.75 for c3p and the "
                         "reference's global 0.9 for c1/c2/c3")
    ap.add_argument("--base_steps", type=int, default=30_000)
    ap.add_argument("--ft_steps", type=int, default=10_000)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--extend", type=int, default=0,
                    help="Train each ALREADY-DONE λ this many further "
                         "steps from its own checkpoint (params + "
                         "optimizer state), instead of skipping it.")
    ap.add_argument("--patience_steps", type=int, default=0,
                    help="Early stop: end a λ's run when val loss has "
                         "not improved for this many steps (val probes "
                         "every 1000 steps); the best-val params are "
                         "checkpointed. 0 = off (save final params).")
    ap.add_argument("--lambdas", nargs="*", type=float, default=None,
                    help="Subset of the λ grid to process.")
    ap.add_argument("--run_id", default=None,
                    help="Override the derived run directory name "
                         "(default <config>[-a<alpha>]).")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="Train on the GPU (default) or, explicitly, on "
                         "the CPU.")
    args = ap.parse_args(argv)

    t0 = time.time()
    train_np = load_blocks(TRAIN_SEEDS, "train24")
    val_np = load_blocks(VAL_SEEDS, "val2")
    print(f"data: {len(train_np)} train / {len(val_np)} val blocks "
          f"({time.time()-t0:.0f}s)", flush=True)
    if args.alpha is None:
        args.alpha = 0.75 if args.config == "c3p" else 0.9
    return train_sweep(
        args.out_dir, args.config, args.alpha,
        args.lambdas or LAMBDAS[args.config], train_np, val_np,
        base_steps=args.base_steps, ft_steps=args.ft_steps,
        batch_size=args.batch_size, extend=args.extend,
        patience_steps=args.patience_steps, run_id=args.run_id,
        device=args.device)


if __name__ == "__main__":
    main()
