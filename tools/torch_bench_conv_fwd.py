#!/usr/bin/env python3
"""The stride-1 k3 layer table of ``conv_fwd`` against cuDNN, on one GPU.

    python3 tools/torch_bench_conv_fwd.py [--batch 128] [--reps 10]
        [--variants 16,16,16,4,64,4,1 32,32,8,4,32,4,2 ...]

For each stride-1 k3 C → C layer shape of c3p's transforms (16 → 16 at
64³ and 32³, 32 → 32 at 32³ and 16³, 64 → 64 at 16³ and 8³) at the
benchmark cells' chunk of ``--batch`` blocks, on seeded random inputs
(ReLU'd, as the layers see them), under ``codec.deterministic_convs()``:

- cuDNN's path as the modules take it where the kernel does not route:
  ``F.relu(F.conv3d(F.pad(x), w, b))`` (the padded copy, the convolution
  with its bias, the block's ReLU), and the convolution alone;
- the kernel (``conv_fwd.conv3d`` with the fused ReLU) where its (cin,
  cout) is instantiated, with its TFLOP/s, its bound and whether it equals
  cuDNN's result bit for bit (with and without the ReLU);
- each of ``--variants``: the source rebuilt with one instance
  ``CI,CO,RCO,TD,TW,CCH,MINB`` (the template arguments of
  ``PCC_CONV_FWD_SHAPES``) into its own library under ``_scratch/``, timed
  and checked bit-equal to the kernel at that (cin, cout) (a variant
  changes the tiling, not the order of any output's sum).

Median ms of ``--reps`` runs of bursts of four calls (CUDA events). Prints
the ``ptxas`` register and spill lines of every build, one JSON line a row
and the card line. Needs a CUDA device; exits non-zero without one or
when a variant differs from the kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402  (the timer, the bound, the card)

# (cin, cout, edge): c3p's stride-1 k3 C -> C layers (synthesis tails at
# 64^3, 32^3, 16^3; analysis tails at 32^3, 16^3, 8^3)
LAYERS = ((16, 16, 64), (16, 16, 32), (32, 32, 32), (32, 32, 16),
          (64, 64, 16), (64, 64, 8))
SCRATCH = REPO / "_scratch"


def ptxas_lines(name, text):
    for line in text.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas {name}: {line.strip()}", flush=True)


def build_variants(variants):
    """{variant: ctypes handle}, each the source with one instance."""
    from pcc_geo_cnn_v2_tpu_torch import native
    from pcc_geo_cnn_v2_tpu_torch.ops import kernels

    text = (kernels.CSRC / "conv_fwd.cu").read_text()
    head = text.index("#define PCC_CONV_FWD_SHAPES(X)")
    end = text.index("\n\n", head)
    SCRATCH.mkdir(exist_ok=True)
    jobs = {}
    for i, v in enumerate(variants):
        args = [int(a) for a in v.split(",")]
        if len(args) != 7:
            raise SystemExit(f"{v}: want CI,CO,RCO,TD,TW,CCH,MINB")
        src = SCRATCH / f"conv_fwd_variant{i}.cu"
        src.write_text(text[:head] + "#define PCC_CONV_FWD_SHAPES(X) X("
                       + ", ".join(map(str, args)) + ")" + text[end:])
        jobs[f"conv_fwd_variant{i}"] = (src, kernels._nvcc_cmd)
    logs = native.build(jobs, force=True)
    libs = {}
    for i, v in enumerate(variants):
        name = f"conv_fwd_variant{i}"
        ptxas_lines(f"{name} ({v})", logs[name])
        lib = ctypes.CDLL(str(native.BUILD_DIR / f"lib{name}.so"))
        lib.pcc_conv_fwd.argtypes = kernels.KERNELS["conv_fwd"][1][
            "pcc_conv_fwd"]
        lib.pcc_conv_fwd.restype = ctypes.c_int
        libs[v] = lib
    return libs


def main():
    import torch
    import torch.nn.functional as F

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--variants", nargs="*", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2

    from pcc_geo_cnn_v2_tpu_torch import native
    from pcc_geo_cnn_v2_tpu_torch.codec import deterministic_convs
    from pcc_geo_cnn_v2_tpu_torch.ops import conv_fwd, kernels

    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    logs = native.build({"conv_fwd": (kernels.CSRC / "conv_fwd.cu",
                                      kernels._nvcc_cmd)}, force=True)
    ptxas_lines("conv_fwd", logs["conv_fwd"])
    variants = build_variants(args.variants)
    deterministic_convs()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(25)
    n = args.batch
    failed = False
    for cin, cout, edge in LAYERS:
        x = torch.relu(torch.randn((n, cin, edge, edge, edge), generator=gen,
                                   device=dev))
        w = torch.randn((cout, cin, 3, 3, 3), generator=gen,
                        device=dev) / (27 * cin) ** 0.5
        b = torch.randn((cout,), generator=gen, device=dev) * 0.1
        table = conv_fwd.pack_weights(w)
        flops = 2 * 27 * cin * cout * x[:, 0].numel()
        nbytes = 4 * (x.numel() + n * cout * edge ** 3 + w.numel())
        bound_ms, bound_by = cs.bound(nbytes, 0, flops)
        row = {"cin": cin, "cout": cout, "edge": edge, "batch": n,
               "gflop": flops / 1e9, "bound_ms": bound_ms,
               "bound_by": bound_by,
               "routed": (cin, cout, (edge,) * 3) in conv_fwd.SHAPES}
        with torch.no_grad():
            want = F.conv3d(F.pad(x, (1, 1) * 3), w, b)
            row["cudnn_layer_ms"] = cs.time_ms(
                lambda: F.relu(F.conv3d(F.pad(x, (1, 1) * 3), w, b)),
                args.reps, burst=4)
            xp = F.pad(x, (1, 1) * 3)
            row["cudnn_conv_ms"] = cs.time_ms(
                lambda: F.conv3d(xp, w, b), args.reps, burst=4)
            del xp
            ref = F.relu(want)  # what each variant must give
            if (cin, cout) in conv_fwd.INSTANCES:
                got = conv_fwd.conv3d(x, table, b)
                row["equal"] = bool(torch.equal(got, want))
                row["max_abs_err"] = float((got - want).abs().max())
                row["max_err_of_max"] = row["max_abs_err"] / float(
                    want.abs().max())
                ref = conv_fwd.conv3d(x, table, b, relu=True)
                row["equal_relu"] = bool(torch.equal(ref, F.relu(want)))
                row["ms"] = cs.time_ms(
                    lambda: conv_fwd.conv3d(x, table, b, relu=True),
                    args.reps, burst=4)
                row["tflops"] = flops / row["ms"] / 1e9
                row["bound_share"] = bound_ms / row["ms"]
                row["layer_speedup"] = row["cudnn_layer_ms"] / row["ms"]
                del got
            for v, lib in variants.items():
                if tuple(int(a) for a in v.split(",")[:2]) != (cin, cout):
                    continue
                out = torch.empty_like(want)

                def call(lib=lib, out=out):
                    err = lib.pcc_conv_fwd(
                        x.data_ptr(), table.data_ptr(), b.data_ptr(),
                        out.data_ptr(), cin, cout, n, edge, edge, edge, 1,
                        kernels.stream_ptr(dev))
                    kernels.check_launch(err, f"variant {v}")

                call()
                ok = bool(torch.equal(out, ref))
                ms = cs.time_ms(call, args.reps, burst=4)
                row.setdefault("variants", {})[v] = {
                    "ms": ms, "tflops": flops / ms / 1e9, "equal_relu": ok}
                failed |= not ok
        print(json.dumps(row), flush=True)
        kern = (f"kernel {row['ms']:.4f} ms ({row['tflops']:.2f} TFLOP/s, "
                f"{100 * row['bound_share']:.1f}% of its bound), "
                f"{row['layer_speedup']:.2f}x the cuDNN layer, bit-equal "
                f"{row['equal']} / with ReLU {row['equal_relu']} (max |err| "
                f"{row['max_abs_err']:.3g})" if "ms" in row
                else "not instantiated")
        print(f"{cin} -> {cout} at {edge}^3, batch {n} ({row['gflop']:.1f} "
              f"GFLOP): cuDNN layer (pad, conv + bias, ReLU) "
              f"{row['cudnn_layer_ms']:.4f} ms, its conv alone "
              f"{row['cudnn_conv_ms']:.4f} ms "
              f"({flops / row['cudnn_conv_ms'] / 1e9:.2f} TFLOP/s); {kern}; "
              f"bound {bound_ms:.4f} ms by {bound_by}"
              + "".join(f"; variant {v} {r['ms']:.4f} ms ({r['tflops']:.2f} "
                        f"TFLOP/s, equal to the kernel {r['equal_relu']})"
                        for v, r in row.get("variants", {}).items()),
              flush=True)
        del x, want
        torch.cuda.empty_cache()
    print(card)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
