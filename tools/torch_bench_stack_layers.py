#!/usr/bin/env python3
"""Times of the c3p stacks' strided and final convolutions on one GPU.

    python3 tools/torch_bench_stack_layers.py [--batch 32]

The fused-conv backend (``conv_backend="pallas"``) keeps its data
channels-last between the hand-written tails and hands the strided
(transposed) convs and the final conv to cuDNN through the port's ``Conv``
/ ``ConvTranspose`` modules. This script times each of those layers at the
flagship shapes (64 filters, 64³ blocks), in f32 and in bf16, under
``codec.deterministic_convs()``, three ways:

- channels-last in, channels-last out (what the fused-conv backend does);
- NCDHW in, NCDHW out (what the module backend does);
- channels-last in, copied to NCDHW for the layer and copied back.

Median milliseconds of 5 runs by CUDA events. Needs a CUDA device; exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# (title, transposed, cin, cout, stride, spatial size of the input)
LAYERS = (("analysis conv 1->16 s2 @64", False, 1, 16, 2, 64),
          ("analysis conv 16->32 s2 @32", False, 16, 32, 2, 32),
          ("analysis conv 32->64 s2 @16", False, 32, 64, 2, 16),
          ("analysis final 64->64 s1 @8", False, 64, 64, 1, 8),
          ("synthesis deconv 64->64 s2 @8", True, 64, 64, 2, 8),
          ("synthesis deconv 64->32 s2 @16", True, 64, 32, 2, 16),
          ("synthesis deconv 32->16 s2 @32", True, 32, 16, 2, 32),
          ("synthesis final 16->1 s1 @64", True, 16, 1, 1, 64))


def time_ms(fn, reps=5):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2

    from pcc_geo_cnn_v2_tpu_torch.codec import deterministic_convs
    from pcc_geo_cnn_v2_tpu_torch.models.transforms import Conv, ConvTranspose

    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    deterministic_convs()
    torch.manual_seed(0)
    for title, transposed, cin, cout, stride, size in LAYERS:
        layer = (ConvTranspose if transposed else Conv)(cin, cout, 3,
                                                        stride).cuda()
        torch.nn.init.normal_(layer.weight, std=0.05)
        x = torch.randn(args.batch, size, size, size, cin, device="cuda")
        last = x.permute(0, 4, 1, 2, 3)  # NCDHW view, channels-last strides
        first = last.contiguous()
        cells = []
        for dtype in (None, torch.bfloat16):
            with torch.no_grad():
                t_last = time_ms(lambda: layer(last, dtype=dtype)
                                 .permute(0, 2, 3, 4, 1).contiguous())
                t_first = time_ms(lambda: layer(first, dtype=dtype))
                t_copy = time_ms(lambda: layer(last.contiguous(), dtype=dtype)
                                 .permute(0, 2, 3, 4, 1).contiguous())
            cells.append(f"{'bf16' if dtype else 'f32'}: channels-last "
                         f"{t_last:.3f} ms, NCDHW {t_first:.3f} ms, "
                         f"copied to NCDHW and back {t_copy:.3f} ms")
        print(f"{title:32s} " + "; ".join(cells), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
