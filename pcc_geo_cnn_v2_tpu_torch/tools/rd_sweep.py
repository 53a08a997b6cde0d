"""RD validation sweep on synthetic data (port of the JAX package's
``tools/rd_sweep.py``, its argv plus ``--device``): fine-tunes c3p at
several λ from the committed benchmark weights, compresses a held-out
synthetic cloud at each and checks that the RD curve is monotone (higher λ
→ higher bpp and better D1 PSNR). Writes ``results_torch/synthetic_rd.json``.

    python -m pcc_geo_cnn_v2_tpu_torch.tools.rd_sweep [steps_per_lambda]

The JAX tool reads the step count from ``sys.argv`` when it is imported;
here :func:`main` parses it.
"""

from __future__ import annotations

import argparse
import gzip
import json
import tempfile
import time

import numpy as np

from pcc_geo_cnn_v2_tpu_torch.tools.paths import REPO, RESULTS_ROOT, writable

__all__ = ["LAMBDAS", "eval_cloud", "main"]

# warm-seq (reference tr_train_all.py:57-61): start from a converged base
# model (the committed benchmark weights, trained at λ=5e-4), then
# fine-tune to the neighbouring λs
BASE_LAMBDA = 5e-4
LAMBDAS = [5e-4, 5e-5, 5e-3]
FINETUNE_FRAC = 4
BENCH_CKPT = REPO / "pcc_geo_cnn_v2_tpu/assets/bench_c3p.msgpack.gz"


def eval_cloud():
    rng = np.random.default_rng(9)
    v = rng.normal(size=(300_000, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return np.unique(np.clip(np.round(v * 200 + 256), 0, 511), axis=0)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="rd_sweep")
    ap.add_argument("steps", nargs="?", type=int, default=4000,
                    help="training steps a λ (a quarter when fine-tuning)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="Run on the GPU (default) or, explicitly, on the "
                         "CPU.")
    args = ap.parse_args(argv)
    out = writable(RESULTS_ROOT / "synthetic_rd.json")

    from pcc_geo_cnn_v2_tpu_torch.codec import BlockCodec
    from pcc_geo_cnn_v2_tpu_torch.coding.syntax import save_compressed_file
    from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
    from pcc_geo_cnn_v2_tpu_torch.training import TrainConfig, Trainer
    from pcc_geo_cnn_v2_tpu_torch.utils.data import (
        BlockDataset,
        synthetic_blocks,
    )
    from pcc_geo_cnn_v2_tpu_torch.utils.octree import partition_octree
    from pcc_geo_cnn_v2_tpu_torch.weights import params_to_jax, save_asset

    pts = eval_cloud()
    blocks, binstr = partition_octree(pts, [0, 0, 0], [512] * 3, 3)
    print(f"eval cloud: {len(pts)} pts, {len(blocks)} blocks", flush=True)
    ds = BlockDataset(synthetic_blocks(192, block_size=64, seed=1,
                                       kind="mix"),
                      max_points=4096)
    base = BENCH_CKPT if BENCH_CKPT.exists() else None
    if base is not None:
        print(f"base: benchmark checkpoint (λ={BASE_LAMBDA:g})", flush=True)
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        for j, lmbda in enumerate(LAMBDAS):
            model = build_model("c3p")
            cfg = TrainConfig(block_size=64, batch_size=8, lmbda=lmbda)
            trainer = Trainer(model, cfg, f"{tmp}/{j}", seed=0,
                              warm_start=base, device=args.device)
            steps = args.steps
            if base is not None:  # warm-seq fine-tune from the base λ
                steps = args.steps // FINETUNE_FRAC
                if lmbda == BASE_LAMBDA:
                    steps = 0  # the base model IS this operating point
            it = ds.batches(cfg.batch_size, seed=0)
            t0 = time.time()
            logs = {"mbpov": float("nan")}
            for i in range(steps):
                logs = trainer.step_batch(next(it), i + 1)
            params = params_to_jax(trainer.model.state_dict())
            if j == 0 and base is None:
                base = f"{tmp}/base.msgpack.gz"
                save_asset(params, base)
            print(f"λ={lmbda:g}: trained {steps} steps in "
                  f"{time.time()-t0:.0f}s (mbpov {float(logs['mbpov']):.2f})",
                  flush=True)
            codec = BlockCodec(build_model("c3p"), params, block_size=64,
                               batch_blocks=32, device=args.device,
                               sweep_backend="auto")
            data_list, meta = codec.compress_blocks_device_opt(
                blocks, binstr, pts, 512, 3)
            raw = gzip.compress(
                save_compressed_file(binstr, data_list[0], 512, 3), mtime=0)
            bpp = len(raw) * 8 / len(pts)
            psnr = meta[0]["metrics"]["d1_psnr"]
            print(f"λ={lmbda:g}: {bpp:.3f} bpp @ {psnr:.2f} dB D1",
                  flush=True)
            results.append({"lmbda": lmbda, "bpp": bpp, "d1_psnr": psnr})
            del trainer, codec

    results.sort(key=lambda r: r["lmbda"])
    print(json.dumps(results, indent=2))
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=2))
    bpps = [r["bpp"] for r in results]
    psnrs = [r["d1_psnr"] for r in results]
    assert all(b2 > b1 for b1, b2 in zip(bpps, bpps[1:])), (
        f"bpp not increasing with λ: {bpps}")
    assert all(p2 > p1 for p1, p2 in zip(psnrs, psnrs[1:])), (
        f"PSNR not increasing with λ: {psnrs}")
    print("RD curve monotone: OK", flush=True)
    return results


if __name__ == "__main__":
    main()
