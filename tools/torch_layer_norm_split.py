"""K7 and K8 of the PyTorch/CUDA port on one NVIDIA card, each launch apart.

    python3 tools/torch_layer_norm_split.py [--root DIR]

Times the port's LayerNorm forward (K7) and backward (K8) at the train
shapes (24576 x 768 and 16384 x 1536, bf16 x and dy, fp32 gamma and beta),
at 2048 rows of 5120 (the general kernels) and at 8 rows of 768 (beside one ``torch.neg`` of x, the timer's floor
for a launch-bound call): CUDA events around each call (20 calls, a write of
256 MB before each so that the inputs come from device memory), and
``torch.profiler``'s device time by kernel name, which splits K8 into its
row kernel and its column reduction. ``--root`` names the checkout whose
``paddle_tpu_torch`` is imported (an unpacked older commit, to time its
kernels in the same call). Prints the card's name and power limit, then
one JSON line a shape. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_layer_norm_split: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops.cuda import layer_norm as k7
    from paddle_tpu_torch.ops.cuda import library

    library()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def timer(fn, iters=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / iters

    # bring the clocks up before the first timing
    for _ in range(200):
        flush.add_(1)
    torch.cuda.synchronize()
    gen = torch.Generator().manual_seed(0)
    for rows, feat in ((24576, 768), (16384, 1536), (2048, 5120), (8, 768)):
        x = (torch.randn(rows, feat, generator=gen) * 2).to("cuda",
                                                           torch.bfloat16)
        g = (1 + 0.1 * torch.randn(feat, generator=gen)).cuda()
        b = (0.1 * torch.randn(feat, generator=gen)).cuda()
        dy = torch.randn(rows, feat, generator=gen).to("cuda", torch.bfloat16)
        rec = {"fwd_ms": timer(lambda: k7.layer_norm(x, g, b)),
               "bwd_ms": timer(lambda: k7.layer_norm_bwd(x, g, dy)),
               # the timer's floor: one small PyTorch kernel on x
               "neg_ms": timer(lambda: torch.neg(x))}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                flush.zero_()
                k7.layer_norm_bwd(x, g, dy)
                flush.zero_()
                k7.layer_norm(x, g, b)
            torch.cuda.synchronize()
        kernels = {}
        for e in prof.key_averages():
            if "layer_norm" in e.key or "ln_" in e.key:
                total = getattr(e, "device_time_total", None)
                if total is None:
                    total = getattr(e, "cuda_time_total", 0)
                if total > 0:
                    kernels[e.key] = [e.count, total / max(e.count, 1) / 1e3]
        rec["profiler_ms_by_kernel"] = kernels
        print(json.dumps({f"{rows}x{feat}": rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
