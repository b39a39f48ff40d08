"""The 1 x 1 convolution route (``paddle_tpu_torch/nn/functional/conv.py``
``_pointwise``: one product on the channels-last view) against cuDNN's
convolution, on one NVIDIA card.

    python3 torch_tools/torch_pointwise_route.py

Two parts, bf16 channels-last (layout autotune on), TF32 off, cuDNN's
algorithm search on:

1. ShuffleNetV2 x1.0's 1 x 1 stride-1 shapes at batch 128 x 224 x 224:
   forward and backward (dx, dW) through the route and through cuDNN
   (``torch.nn.functional.conv2d``) on the same tensors: device ms a pass
   (``torch.profiler``, 20 passes), the ms of layout-transpose kernels in
   them, and the route's output and gradients against cuDNN's as relative
   L2 norms (``route_errors``: the same comparison, which
   ``chip_smoke.py``'s ``shufflenet_vs_plain`` runs).
2. The train step (``chip_smoke.py``'s recipe, batch 128 x 224 x 224),
   each run in a process of its own (cuDNN's algorithm search starts
   anew), under three rules for taking the route: ``never`` (cuDNN for
   every conv), ``not_x8`` (only where a channel count is not a multiple
   of 8) and ``every`` (the port's rule: every bf16/fp16 channels-last 1 x
   1 stride-1 conv). ShuffleNetV2 x1.0 in the order never, not_x8, every,
   every, not_x8, never; ResNet-50 and MobileNetV3-Large (every width a
   multiple of 8, so ``not_x8`` is ``never``) never, every, every, never.
   Each: ms a step (CUDA events, the median of 10 after 3 warm-up steps),
   device ms a step and the layout-transpose ms in it (2 profiled steps).

Prints the card's name and power limit, then one JSON line a part.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (C_in, C_out, H = W) of ShuffleNetV2 x1.0's 1 x 1 convs at 224 x 224
SHAPES = ((24, 58, 56), (24, 58, 28), (58, 58, 28), (116, 116, 28),
          (116, 116, 14), (232, 232, 14), (232, 232, 7), (464, 1024, 7))
BATCH = 128


def _device_ms(torch, prof, kinds, fn, passes=20):
    """Device ms a pass of ``fn`` and the layout-transpose ms in it."""
    fn()
    _, kernels = prof._profile(torch, lambda: [fn() for _ in range(passes)])
    transposes = sum(ms for k, ms in kernels.items()
                     if prof._kind(k, kinds) == "layout transposes")
    return sum(kernels.values()) / passes, transposes / passes


def _steps(torch, c_in, c_out, hw, batch, gen):
    """Forward + backward of the route and of cuDNN on the same seeded bf16
    channels-last input, weight and upstream gradient: ``{name: step}``,
    each step returning ``(out, dx, dW)``."""
    from paddle_tpu_torch.nn.functional import conv

    cl = torch.channels_last
    x = torch.randn(batch, c_in, hw, hw, generator=gen, device="cuda",
                    dtype=torch.bfloat16).contiguous(memory_format=cl)
    w = (torch.randn(c_out, c_in, 1, 1, generator=gen, device="cuda")
         / c_in ** 0.5).to(torch.bfloat16).contiguous(memory_format=cl)
    g = torch.randn(batch, c_out, hw, hw, generator=gen, device="cuda",
                    dtype=torch.bfloat16).contiguous(memory_format=cl)

    def step(fn):
        xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
        out = fn(xr, wr)
        out.backward(g)
        return out.detach(), xr.grad, wr.grad

    return {"route": lambda: step(conv._pointwise),
            "cudnn": lambda: step(torch.nn.functional.conv2d)}


def _errors(route, cudnn):
    return {k: float((r.float() - c.float()).norm() / c.float().norm())
            for k, r, c in zip(("out", "dx", "dw"), route, cudnn)}


def route_errors(torch, shapes, batch):
    """The largest relative L2 of the route's output, dx and dW from
    cuDNN's over ``shapes``."""
    gen = torch.Generator(device="cuda").manual_seed(96)
    worst = {"out": 0.0, "dx": 0.0, "dw": 0.0}
    for shape in shapes:
        steps = _steps(torch, *shape, batch, gen)
        for k, err in _errors(steps["route"](), steps["cudnn"]()).items():
            worst[k] = max(worst[k], err)
    return worst


def conv_shapes(torch):
    import chip_smoke as cs

    kinds = cs._torch_tool("torch_resnet_profile").KINDS
    prof = cs._torch_tool("torch_encoder_profile")
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for c_in, c_out, hw in SHAPES:
        steps = _steps(torch, c_in, c_out, hw, BATCH, gen)
        ms = {name: _device_ms(torch, prof, kinds, step)
              for name, step in steps.items()}
        rows.append({
            "c_in": c_in, "c_out": c_out, "hw": hw, "batch": BATCH,
            "route_fwd_bwd_device_ms": ms["route"][0],
            "cudnn_fwd_bwd_device_ms": ms["cudnn"][0],
            "cudnn_transpose_ms": ms["cudnn"][1],
            **{f"{k}_rel_l2": v for k, v in _errors(
                steps["route"](), steps["cudnn"]()).items()}})
    return rows


RULES = {
    "never": lambda port: (lambda *a: False),
    "not_x8": lambda port: (lambda x, weight, *a: port(x, weight, *a) and (
        weight.shape[0] % 8 or weight.shape[1] % 8) != 0),
    "every": lambda port: port,
}


ORDERS = {
    "shufflenet_v2_x1_0": ("never", "not_x8", "every", "every", "not_x8",
                           "never"),
    "resnet50": ("never", "every", "every", "never"),
    "mobilenet_v3_large": ("never", "every", "every", "never"),
}


def one_model(torch, model_name, rule):
    """The train step of ``model_name`` under ``rule``, in this process."""
    import chip_smoke as cs
    from paddle_tpu_torch.nn.functional import conv

    kinds = cs._torch_tool("torch_resnet_profile").KINDS
    prof = cs._torch_tool("torch_encoder_profile")
    build = {
        "shufflenet_v2_x1_0": lambda: cs._shufflenet(
            torch, "shufflenet_v2_x1_0", 90),
        "resnet50": lambda: cs._resnet50(torch, 1),
        "mobilenet_v3_large": lambda: cs._mobilenet(
            torch, "mobilenet_v3_large", 1),
    }[model_name]
    conv._pointwise_on_gemm = RULES[rule](conv._pointwise_on_gemm)
    batches = cs._image_batches(torch, 91, 15, BATCH, 224, 1000)
    with cs._vision_setup(torch):
        model = build()
        opt = cs._momentum(model)
        model.train()
        times = []
        for i, (images, labels) in enumerate(batches[:13]):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            cs._vision_step(model, opt, images, labels)
            e.record()
            torch.cuda.synchronize()
            if i >= 3:
                times.append(s.elapsed_time(e))
        _, kernels = prof._profile(torch, lambda: [
            cs._vision_step(model, opt, *b) for b in batches[13:]])
    transposes = sum(ms for k, ms in kernels.items()
                     if prof._kind(k, kinds) == "layout transposes")
    return {"model": model_name, "rule": rule,
            "step_ms": statistics.median(times),
            "device_ms_a_step": sum(kernels.values()) / 2,
            "transpose_ms_a_step": transposes / 2}


def model_steps():
    out = []
    for model_name, order in ORDERS.items():
        for rule in order:
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one",
                 model_name, rule], capture_output=True, text=True,
                timeout=600)
            if res.returncode != 0:
                raise RuntimeError(f"{model_name} {rule}: {res.stderr}")
            out.append(json.loads(res.stdout.strip().splitlines()[-1]))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--one", nargs=2, default=None,
                    metavar=("MODEL", "RULE"))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("torch_pointwise_route: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.one:
        print(json.dumps(one_model(torch, *args.one)))
        return 0
    print(cs._card_line())
    torch.backends.cudnn.benchmark = True
    print("conv_shapes", json.dumps(conv_shapes(torch)), flush=True)
    print("model_steps", json.dumps(model_steps()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
