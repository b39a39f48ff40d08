"""K9 (flash cross-entropy forward) of the PyTorch/CUDA port on one NVIDIA
card.

    python3 tools/torch_fused_ce_fwd.py [--root DIR] [--check] [--cublas]
                                        [--time] [--variants]

``--check`` holds K9 to its plain version (``ce_forward_plain``) at odd
shapes (300 tokens, vocab 1000, hidden 128, 384, 1408 and 1536, bias on and
off, labels in the last partial vocab tile, bf16 and fp16, and fp32) and at
the GPT-2 124M train shape (24576 tokens, hidden 768, vocab 50304, bf16):
loss and lse within one step of the type of the largest reference value
(fp32: 5e-5), the same bits on a second launch, and the library's plan
equal to ``kernel_plan``'s for the card's SMs.
``--cublas`` times the yardstick: the same product alone as one cuBLAS call
(``torch.matmul(x, w.t())``, bf16) at the train shape and at GPT-3 Large's
loss shape (16384 x 1536 x 50304), beside the chunked loop's forward.
``--time`` times K9 (and its plain version) at those two shapes.
``--variants`` builds copies of ``csrc/fused_ce.cu`` that this tool edits
(nothing in the library switches them): the product alone (the logsumexp
epilogue replaced by a sum that keeps the accumulator live), rings of 2
and 3 stages (4 is the library's; 5 do not fit), the plan forced to 1 to
4 vocab ranges, and the units taken stripe-major at 2 to 4 ranges; it
times them beside the library's kernel at both shapes (the variants are
built together, one nvcc each).
Times are CUDA events around each call, 20 calls, a write of 256 MB before
each so that the inputs come from device memory.
``--root`` names the checkout whose ``paddle_tpu_torch`` is imported (an
unpacked older commit, to time its kernels in the same call: ``--check``
and ``--variants`` need this tree's). Prints the card's name and power
limit, the toolchain, the registers and spills ptxas reports for the
forward kernels, then one JSON line a case. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

BF16_STEP = 2.0 ** -7
FP16_STEP = 2.0 ** -10

# (name, tokens, vocab, hidden, dtype, bias)
CHECK_CASES = (
    ("h128", 300, 1000, 128, "bf16", True),
    ("h128_nobias", 300, 1000, 128, "bf16", False),
    ("h384", 300, 1000, 384, "fp16", True),
    ("h1408", 300, 1000, 1408, "bf16", False),
    ("h1536", 300, 1000, 1536, "fp16", False),
    ("h1536_bias", 130, 777, 1536, "bf16", True),
    ("h768_fp32", 300, 1000, 768, "fp32", True),
    ("train", 24576, 50304, 768, "bf16", False),
)
TIME_CASES = (("train", 24576, 50304, 768), ("large", 16384, 50304, 1536))
#: the edits a variant makes to csrc/fused_ce.cu: (old, new) text pairs
_PRODUCT_ONLY = """__device__ __forceinline__ void fwd_tile_lse(float (&d)[128], int col0, int cq, int vocab,
                                             const float* bias, const int (&lab)[2],
                                             float (&m)[2], float (&l)[2], float (&pk)[2]) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 128; ++i) s += d[i];
  l[0] += s;
}
"""
_PLAN_LOOP = "for (int r = 1; r <= kFMaxRanges && r <= tiles; ++r) {"
_STRIPE_MAJOR = ("const int stripe = u % stripes, range = u / stripes;",
                 "const int stripe = u / ranges, range = u % ranges;")


def _forced(r):
    """The edit that makes the plan split the vocabulary into r ranges."""
    return (_PLAN_LOOP, f"for (int r = {r}; r <= {r}; ++r) {{")


#: the variants the tool builds: name -> the edits to csrc/fused_ce.cu
#: ("epilogue": the logsumexp replaced by _PRODUCT_ONLY)
VARIANTS = {
    "product_only": "epilogue",
    "stages_2": [("constexpr int kFStages = 4;", "constexpr int kFStages = 2;")],
    "stages_3": [("constexpr int kFStages = 4;", "constexpr int kFStages = 3;")],
    **{f"ranges_{r}": [_forced(r)] for r in (1, 2, 3, 4)},
    # units stripe-major: the ranges of a stripe run at once on neighbouring
    # CTAs, so fewer x stripes are live in L2
    **{f"stripe_major_ranges_{r}": [_STRIPE_MAJOR, _forced(r)]
       for r in (2, 3, 4)},
}


def _ptxas(log):
    """``{kernel: [registers, spill store bytes]}`` of the forward kernels
    in nvcc's ``-Xptxas -v`` report."""
    out, cur, spill = {}, None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            cur = name if "ce_fwd" in name else None
        elif cur is not None and "spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif cur is not None and "Used" in line and "registers" in line:
            out[cur] = [int(re.search(r"Used (\d+) registers", line).group(1)),
                        spill]
            cur = None
    return out


def _variant_source(src, name):
    """csrc/fused_ce.cu with variant ``name``'s edit."""
    edits = VARIANTS[name]
    if edits == "epilogue":
        a = src.index("// epilogue: begin")
        b = src.index("// epilogue: end")
        return src[:a] + _PRODUCT_ONLY + src[b:]
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"variant {name}: {old!r} not in the source")
        src = src.replace(old, new)
    return src


def _start_variant(root, name):
    """Start building a library of fused_ce.cu alone with variant
    ``name``'s edit, under the git-ignored build directory; returns
    (process, library path)."""
    csrc = os.path.join(root, "paddle_tpu_torch", "csrc")
    out = os.path.join(root, "paddle_tpu_torch", "ops", "cuda", "_build",
                       "variants", name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    path = os.path.join(out, "fused_ce.cu")
    with open(path) as f:
        src = f.read()
    with open(path, "w") as f:
        f.write(_variant_source(src, name))
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    so = os.path.join(out, "libvariant.so")
    proc = subprocess.Popen(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared", "-o", so,
         path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, so


def _load_variant(name, proc, so):
    """(ctypes library, ptxas report) of a variant whose build ``proc``
    runs."""
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"variant {name} failed to build:\n{log}")
    lib = ctypes.CDLL(so)
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ptt_fused_ce_fwd.argtypes = [p] * 7 + [i64] + [i32] * 4 + [p]
    lib.ptt_fused_ce_fwd.restype = i32
    return lib, _ptxas(log)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    for flag in ("check", "cublas", "time", "variants"):
        ap.add_argument(f"--{flag}", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_fused_ce_fwd: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops.cuda import build_info, library
    from paddle_tpu_torch.ops.cuda import fused_ce as k9

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, root {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    library()
    info = build_info()
    print(f"build: {info.get('per_source', {})}")
    log = info.get("log", "")
    print(f"ptxas [registers, spill bytes]: {json.dumps(_ptxas(log))}")
    # ptxas's warnings and advisories (serialized wgmma, ignored setmaxnreg)
    for line in log.splitlines():
        if "warning" in line.lower() or "advisory" in line.lower():
            print(f"ptxas: {line.strip()}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dts = {"bf16": torch.bfloat16, "fp16": torch.float16,
           "fp32": torch.float32}
    gen = torch.Generator().manual_seed(4)

    def inputs(n, v, h, dt, use_bias):
        x = torch.randn(n, h, generator=gen).to("cuda", dts[dt])
        w = (0.02 * torch.randn(v, h, generator=gen)).to("cuda", dts[dt])
        b = (0.1 * torch.randn(v, generator=gen)).cuda() if use_bias else None
        y = torch.randint(0, v, (n,), generator=gen)
        # labels in the last, partial vocab tile too
        y[::7] = torch.randint(v - v % 256 if v % 256 else v - 256, v,
                               (len(y[::7]),), generator=gen)
        return x, w, b, y.cuda()

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

    def bound_ms(n, v, h):
        return 2.0 * n * v * h / 989e12 * 1e3

    ok = True
    if args.check:
        for name, n, v, h, dt, use_bias in CHECK_CASES:
            a = inputs(n, v, h, dt, use_bias)
            rec = {"case": name, "shape": [n, v, h, dt, use_bias],
                   "plan": k9.library_plan(n, v, h, dts[dt], 2)}
            rec["plan_is_kernel_plan"] = rec["plan"] == k9.kernel_plan(
                n, v, h, dts[dt], 2, sms)
            loss, lse = k9.ce_forward(*a)
            torch.cuda.synchronize()
            want = k9.ce_forward_plain(*a)
            step = {"bf16": BF16_STEP, "fp16": FP16_STEP}.get(dt)
            errs = []
            for got, ref in zip((loss, lse), want):
                finite = bool(got.isfinite().all())
                e = float((got - ref).abs().max())
                tol = 5e-5 if step is None else step * float(ref.abs().max())
                errs.append([e, tol, finite])
            rec["loss_lse_err_tol_finite"] = errs
            loss2, lse2 = k9.ce_forward(*a)
            rec["same_bits"] = bool(torch.equal(loss, loss2)
                                    and torch.equal(lse, lse2))
            rec["ok"] = (rec["same_bits"] and rec["plan_is_kernel_plan"]
                         and all(e <= t and f for e, t, f in errs))
            ok = ok and rec["ok"]
            print(json.dumps(rec), flush=True)
            del a, loss, lse, loss2, lse2, want
            torch.cuda.empty_cache()

    if args.cublas or args.time:
        for _ in range(200):
            flush.add_(1)
        torch.cuda.synchronize()
        for name, n, v, h in TIME_CASES:
            a = inputs(n, v, h, "bf16", False)
            x, w, _, y = a
            rec = {"case": name, "shape": [n, v, h],
                   "bound_ms": bound_ms(n, v, h)}
            if args.cublas:
                rec["cublas_product_ms"] = timer(lambda: torch.matmul(x, w.t()))
                from paddle_tpu_torch.ops import fused

                rec["chunked_loop_fwd_ms"] = timer(
                    lambda: fused._FusedLinearCE.apply(x, w, None, y, -100, 0),
                    5)
            if args.time:
                rec["k9_ms"] = timer(lambda: k9.ce_forward(*a))
                rec["share_of_bound"] = rec["bound_ms"] / rec["k9_ms"]
                if hasattr(k9, "kernel_plan"):
                    try:
                        rec["plan"] = k9.kernel_plan(n, v, h, torch.bfloat16,
                                                     2, sms)
                    except (TypeError, KeyError, StopIteration):
                        pass
            print(json.dumps(rec), flush=True)
            del a, x, w, y
            torch.cuda.empty_cache()

    if args.variants:
        from paddle_tpu_torch.ops.cuda._build import check, dtype_code

        libs = {"library": (library(), None)}
        started = {name: _start_variant(root, name) for name in VARIANTS}
        for name, (proc, so) in started.items():
            libs[name] = _load_variant(name, proc, so)
            regs = {k: r for k, r in libs[name][1].items()
                    if "wgmma" in k and "bfloat16" in k}
            print(f"variant {name}: ptxas of the bf16 kernel "
                  f"{list(regs.values())}", flush=True)
        for case, n, v, h in TIME_CASES:
            x, w, _, y = inputs(n, v, h, "bf16", False)
            y32 = y.to(torch.int32)
            loss = torch.empty(n, device="cuda")
            lse = torch.empty(n, device="cuda")
            part = torch.empty(4 * 4 * n, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream

            def call(lib):
                check(lib.ptt_fused_ce_fwd(
                    x.data_ptr(), w.data_ptr(), None, y32.data_ptr(),
                    loss.data_ptr(), lse.data_ptr(), part.data_ptr(),
                    part.numel(), n, v, h, dtype_code(x.dtype), stream),
                    "variant")

            rec = {"case": case, "shape": [n, v, h],
                   "bound_ms": bound_ms(n, v, h),
                   "plan": k9.kernel_plan(n, v, h, torch.bfloat16, 2, sms)}
            for name, (lib, _) in libs.items():
                rec[f"{name}_ms"] = timer(lambda: call(lib))
            print(json.dumps(rec), flush=True)
            del x, w, y, y32, loss, lse, part
            torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
