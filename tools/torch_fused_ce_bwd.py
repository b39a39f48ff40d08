"""K10 and K11 (flash cross-entropy dx and dW/db) of the PyTorch/CUDA port on
one NVIDIA card.

    python3 tools/torch_fused_ce_bwd.py [--root DIR] [--check] [--time]

``--check`` holds both kernels to their plain versions at small shapes
(cluster sizes 1 to 5 of the library's plan at hidden 128, 384, 640, 768,
1024, 1152 and 1536, tokens and vocab that are not multiples of 64, fp16,
a width on the streamed route) and at the GPT-2 124M train shape (24576
tokens, hidden 768, vocab 50304, bf16), within one step of the type of
the largest reference value, and checks that dx, dW and db are the same
bits on a second launch.
``--time`` times them (CUDA events around each call, 20 calls, a write of
256 MB before each so that the inputs come from device memory) at the
train shape, at GPT-3 Large's loss shape (16384 x 1536 x 50304) and at
hidden 384 (one CTA a cluster: no exchange), beside the chunked loop's
backward (cuBLAS products) at the train shape.
``--root`` names the checkout whose ``paddle_tpu_torch`` is imported (an
unpacked older commit, to time its kernels in the same call). Prints the
card's name and power limit, the toolchain, the registers and spills ptxas
reports for the backward kernels, then one JSON line a case. Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

BF16_STEP = 2.0 ** -7
FP16_STEP = 2.0 ** -10

# (name, tokens, vocab, hidden, dtype, bias)
CHECK_CASES = (
    ("h384", 300, 1000, 384, "bf16", True),
    ("h768", 130, 1000, 768, "bf16", False),
    ("h1152", 70, 300, 1152, "fp16", True),
    ("h1536", 100, 300, 1536, "bf16", True),
    ("h128_odd", 33, 77, 128, "bf16", False),
    ("h640", 100, 300, 640, "bf16", True),
    ("h1024", 90, 200, 1024, "fp16", False),
    ("h1408_streamed", 90, 150, 1408, "bf16", True),
    ("train", 24576, 50304, 768, "bf16", False),
)
TIME_CASES = (("train", 24576, 50304, 768), ("large", 16384, 50304, 1536),
              ("h384", 24576, 50304, 384))


def _ptxas(log):
    """``{kernel: [registers, spill store bytes]}`` of the backward kernels
    in nvcc's ``-Xptxas -v`` report."""
    out, cur, spill = {}, None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            cur = name if "ce_bwd" in name else None
        elif cur is not None and "spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif cur is not None and "Used" in line and "registers" in line:
            out[cur] = [int(re.search(r"Used (\d+) registers", line).group(1)),
                        spill]
            cur = None
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--time", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("torch_fused_ce_bwd: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops.cuda import build_info, library
    from paddle_tpu_torch.ops.cuda import fused_ce as k9

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    library()
    info = build_info()
    print(f"build: {info.get('per_source', {})}")
    log = info.get("log", "")
    print(f"ptxas [registers, spill bytes]: {json.dumps(_ptxas(log))}")
    # ptxas's advisories on the wgmma kernels (serialized products)
    for line in log.splitlines():
        if any(k in line.lower() for k in ("wgmma", "advisory", "setmaxnreg")):
            print(f"ptxas: {line.strip()}")
    plan = getattr(k9, "kernel_plan", None)
    dts = {"bf16": torch.bfloat16, "fp16": torch.float16}
    gen = torch.Generator().manual_seed(3)

    def inputs(n, v, h, dt, use_bias):
        x = torch.randn(n, h, generator=gen).to("cuda", dts[dt])
        w = (0.02 * torch.randn(v, h, generator=gen)).to("cuda", dts[dt])
        b = (0.1 * torch.randn(v, generator=gen)).cuda() if use_bias else None
        y = torch.randint(0, v, (n,), generator=gen).cuda()
        g = torch.full((n,), 1.0 / n, device="cuda")
        g[:2] = 0.0
        lse = k9.ce_forward_plain(x, w, b, y)[1]
        return x, w, b, y, g, lse

    def err(got, want, step):
        got, want = got.float(), want.float()
        assert bool(got.isfinite().all()), "non-finite output"
        e = float((got - want).abs().max())
        tol = step * float(want.abs().max())
        return e, tol

    if args.check:
        for name, n, v, h, dt, use_bias in CHECK_CASES:
            a = inputs(n, v, h, dt, use_bias)
            step = BF16_STEP if dt == "bf16" else FP16_STEP
            rec = {"case": name, "shape": [n, v, h, dt, use_bias]}
            if plan is not None:
                rec["plan_dx"] = plan(n, v, h, dts[dt], 0)
                rec["plan_dw"] = plan(n, v, h, dts[dt], 1)
            dx = k9.ce_backward_dx(*a)
            dw, db = k9.ce_backward_dw(*a)
            torch.cuda.synchronize()
            rec["dx_err_tol"] = err(dx, k9.ce_backward_dx_plain(*a), step)
            want_dw, want_db = k9.ce_backward_dw_plain(*a)
            rec["dw_err_tol"] = err(dw, want_dw, step)
            if use_bias:
                rec["db_err_tol"] = err(db, want_db, step)
            dx2 = k9.ce_backward_dx(*a)
            dw2, db2 = k9.ce_backward_dw(*a)
            rec["same_bits"] = bool(torch.equal(dx, dx2) and torch.equal(
                dw, dw2) and (db is None or torch.equal(db, db2)))
            rec["ok"] = rec["same_bits"] and all(
                v[0] <= v[1] for k, v in rec.items() if k.endswith("_err_tol"))
            print(json.dumps(rec), flush=True)
            del a, dx, dw, db, dx2, dw2, db2, want_dw, want_db
            torch.cuda.empty_cache()

    if args.time:
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

        for _ in range(200):
            flush.add_(1)
        torch.cuda.synchronize()
        for name, n, v, h in TIME_CASES:
            a = inputs(n, v, h, "bf16", False)
            rec = {"case": name, "shape": [n, v, h],
                   "dx_ms": timer(lambda: k9.ce_backward_dx(*a)),
                   "dw_ms": timer(lambda: k9.ce_backward_dw(*a))}
            if name == "train":
                from paddle_tpu_torch.ops import fused

                xg = a[0].detach().requires_grad_()
                wg = a[1].detach().requires_grad_()
                losses = fused._FusedLinearCE.apply(xg, wg, None, a[3], -100, 0)
                rec["chunked_loop_bwd_ms"] = timer(lambda: torch.autograd.grad(
                    losses, (xg, wg), a[4], retain_graph=True), 5)
                del losses, xg, wg
            print(json.dumps(rec), flush=True)
            del a
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
