#!/usr/bin/env python3
"""Check and time the fused residual tails (K4a / K4b) on one GPU.

    python3 tools/torch_bench_fused_tail.py [--batch 32] [--check-only]
        [--slabs 8 16 32] [--chunks 1 2 4 8 16 32]

Builds ``csrc/fused_tail.cu`` and ``csrc/fused_tail_slab.cu`` (prints what
``ptxas -v`` says per kernel: registers, spills), then, on seeded random
inputs at the six stage shapes of c3p (K4a: 32³×16, 16³×32, 8³×64, 16³×64,
32³×32; K4b: 64³×16) and a ragged 12³×16 volume, in f32 and bf16:

- compares the kernel with its plain PyTorch version (largest error as a
  share of the largest value; share of equal elements), two launches with
  each other, N = 1 with row 0 of the batch, and K4b with K4a bit for bit;
- times the wrapper (median of 5 bursts of 4 calls between CUDA events, per
  call), the kernel alone (``torch.profiler`` device time) and the
  wrapper's host time, beside the cuDNN chain conv → relu → conv → relu →
  add on the same tensors, channels-last and NCDHW (the faster), and
  prints TFLOP/s of the function's 2·2·27·C²·S³·N FLOP, the
  launch plan (depth range, grid) and the share of the bound reached (f32:
  67 TFLOP/s FFMA; bf16: 989 TFLOP/s tensor cores).

``--slabs`` times K4b at several slab depths; ``--chunks`` times K4a's C
entry at the given depth ranges (bursts of raw calls through ctypes: the
kernel's time per depth range, to hold ``fused_conv.tail_plan``'s pick
against). Needs a CUDA device; exits non-zero without one or when a
comparison fails.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SHAPES = ((32, 16), (16, 32), (8, 64), (16, 64), (32, 32), (64, 16))
PEAK = {"f32": 67e12, "bf16": 989e12}


def time_ms(fn, reps=5, burst=4):
    """Median ms per call over ``reps`` bursts of ``burst`` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
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
    return sorted(times)[len(times) // 2]


def main():
    import torch
    import torch.nn.functional as F

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--slabs", type=int, nargs="*", default=[8])
    ap.add_argument("--chunks", type=int, nargs="*", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2

    from pcc_geo_cnn_v2_tpu_torch import native
    from pcc_geo_cnn_v2_tpu_torch.codec import deterministic_convs
    from pcc_geo_cnn_v2_tpu_torch.ops import fused_conv as fc
    from pcc_geo_cnn_v2_tpu_torch.ops import kernels

    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    jobs = {n: (kernels.CSRC / kernels.KERNELS[n][0], kernels._nvcc_cmd)
            for n in ("fused_tail", "fused_tail_slab")}
    t0 = time.time()
    logs = native.build(jobs, force=True)
    print(f"built in {time.time() - t0:.1f} s")
    lines = logs["fused_tail"].splitlines()
    for i, line in enumerate(lines):
        if "registers" in line:
            name = next((p for p in reversed(lines[:i])
                         if "Compiling entry" in p), "")
            at = name.find("tail_kernel")
            print("  ptxas:", name[at:at + 40], line.strip(), flush=True)

    deterministic_convs()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, scale=1.0):
        return scale * torch.randn(*shape, device="cuda", generator=gen)

    failed = []
    for S, C in SHAPES + ((12, 16),):
        n = args.batch if S < 64 else min(args.batch, 32)
        xf32 = F.relu(rand(n, S, S, S, C, scale=0.5))
        wf32 = [rand(27, C, C, scale=0.7 / (27 * C) ** 0.5)
                for _ in range(2)]
        b1, b2 = rand(C, scale=0.3), rand(C, scale=0.3)
        slab = S ** 3 * C // fc.LANES > fc.MAX_FUSED_ROWS
        for dtype in (torch.float32, torch.bfloat16):
            tag = "f32" if dtype == torch.float32 else "bf16"
            kw = dict(spatial=S, channels=C, dtype=dtype)
            fn = fc.fused_residual_tail_slab if slab else \
                fc.fused_residual_tail
            # operands in the working type, as the codec hands them over
            x, w1, w2 = (t.to(dtype) for t in (xf32, wf32[0], wf32[1]))
            got = fn(x, w1, b1, w2, b2, **kw)
            again = fn(x, w1, b1, w2, b2, **kw)
            one = fn(x[:1], w1, b1, w2, b2, **kw)
            ref = fc.fused_residual_tail_plain(x, w1, b1, w2, b2, **kw)
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            scale = float(ref.float().abs().max())
            equal = float((got == ref).float().mean())
            ok = torch.equal(got, again) and torch.equal(one, got[:1])
            if not slab and S % 4 == 0:
                other = fc.fused_residual_tail_slab(x, w1, b1, w2, b2,
                                                    slab=4, **kw)
                ok = ok and torch.equal(other, got)
            ok = ok and (err <= 1e-4 * scale if dtype == torch.float32
                         else equal >= 0.99 and err <= 0.04 * scale)
            if not ok:
                failed.append((S, C, tag))
            plan = fc.tail_plan(S, C, n, dtype,
                                depth_chunk=8 if slab else None)
            msg = (f"{'K4b' if slab else 'K4a'} {n}x{S}^3x{C} {tag}: "
                   f"{'ok' if ok else 'FAILED'} err {err / scale:.3g} of max,"
                   f" {100 * equal:.3f}% equal; depth range "
                   f"{plan['depth_chunk']}, grid {plan['grid']}")
            if not args.check_only:
                flop = 2 * 2 * 27 * C * C * S ** 3 * n
                ms = time_ms(lambda: fn(x, w1, b1, w2, b2, **kw))
                wk = [w.reshape(3, 3, 3, C, C)
                      .permute(4, 3, 0, 1, 2).contiguous() for w in (w1, w2)]
                bk = [b.to(dtype) for b in (b1, b2)]
                xl = x.permute(0, 4, 1, 2, 3)
                xf = xl.contiguous()

                def chain(v):
                    t = F.relu(F.conv3d(v, wk[0], bk[0], padding=1))
                    return v + F.relu(F.conv3d(t, wk[1], bk[1], padding=1))

                # device time of the kernel alone, and the wrapper's host
                # time per call (events around one call include both)
                from torch.profiler import ProfilerActivity, profile
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(3):
                        fn(x, w1, b1, w2, b2, **kw)
                    torch.cuda.synchronize()
                dev = [e for e in prof.key_averages()
                       if "tail_kernel" in e.key
                       or "tail_slab_kernel" in e.key]
                t0 = time.perf_counter()
                for _ in range(10):
                    fn(x, w1, b1, w2, b2, **kw)
                host = (time.perf_counter() - t0) / 10
                torch.cuda.synchronize()
                if dev:
                    msg += (f"; kernel alone {dev[0].device_time / 1e3:.3f}"
                            f" ms, host {host * 1e3:.3f} ms a call")
                lib = min(time_ms(lambda: chain(xl), 3),
                          time_ms(lambda: chain(xf), 3))
                msg += (f"; {ms:.3f} ms = {flop / ms / 1e9:.1f} TFLOP/s, "
                        f"{100 * flop / PEAK[tag] * 1e3 / ms:.1f}% of the "
                        f"bound; cuDNN chain {lib:.3f} ms, ms / library "
                        f"{ms / lib:.2f}")
                if not slab and args.chunks:
                    ops = fc._operands(x, w1, b1, w2, b2, S, C, dtype)
                    out = torch.empty_like(ops[0])
                    lib_k = kernels.load("fused_tail")

                    def raw(chunk):
                        for _ in range(2):
                            err = lib_k.pcc_fused_tail(
                                *(t.data_ptr() for t in ops), out.data_ptr(),
                                n, S, C, chunk, 1,
                                int(dtype == torch.bfloat16),
                                kernels.stream_ptr(x.device))
                            kernels.check_launch(err, "fused_tail")

                    msg += "; depth range -> ms: " + ", ".join(
                        f"{c}: {time_ms(lambda: raw(c)) / 2:.3f}"
                        for c in args.chunks if c <= S)
                if slab:
                    for sl in args.slabs:
                        if sl != 8:
                            t = time_ms(lambda: fn(x, w1, b1, w2, b2,
                                                   slab=sl, **kw))
                            msg += f"; slab {sl}: {t:.3f} ms"
            print(msg, flush=True)
    if failed:
        print("FAILED:", failed, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
