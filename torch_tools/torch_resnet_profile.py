"""Where the time goes in a vision train step of the port (ResNet-50,
MobileNetV3-Large or ShuffleNetV2 x1.0), on one NVIDIA card.

    python3 torch_tools/torch_resnet_profile.py [--model M] [--steps N]

Runs ``chip_smoke.py``'s ``resnet50_train`` step (``--model resnet50``, the
default; ``tools/bench_resnet.py``'s recipe: ``resnet50(num_classes=1000)``
in bf16 with fp32 batch norms, layout autotune on, cuDNN's algorithm
search, ``Momentum(0.1, 0.9, weight decay 1e-4, multi_precision)``, cross
entropy on fp32 logits, batch 128 x 3 x 224 x 224, random weights and
seeded images) or its ``mobilenet_v3_large_train`` step (``--model
mobilenet_v3_large``: the same recipe on ``mobilenet_v3_large(scale=1.0,
num_classes=1000)``, the classifier's dropout live) or its
``shufflenet_v2_train`` step (``--model shufflenet_v2_x1_0``): 3 warm-up
steps, then
``--steps`` steps (default 2) under ``torch.profiler``, then the
optimizer's step alone, as often, under a second profile.

Prints the card's name and power limit, then one JSON line a window: the
wall time of the window (host clock around work ending in a synchronize),
the device time summed over CUDA kernels, the device's idle share (one
minus their ratio: the kernels run on one stream), the device time by kind
of kernel (conv forward, dgrad and wgrad; batch norm; copies and layout
transposes; the elementwise, reduction and loss kernels) and the 15
kernels with the most device time. The optimizer's own window gives its
share of the step's elementwise time. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: kernel kinds by name (first match wins)
KINDS = (
    # cuDNN's channels-last depthwise kernels (one input channel a group):
    # conv2d_c1_k1_nhwc*, dgrad2d_c1_k1_nhwc*, wgrad2d_c1_k1_nhwc*
    ("depthwise conv", r"_c1_k1_nhwc|[Dd]epthwise"),
    ("conv wgrad", r"wgrad"),
    ("conv dgrad", r"dgrad"),
    ("conv fwd", r"fprop|implicit_convolve|conv2d_fwd|conv_fwd|convolve"),
    ("GEMM kernels (cuDNN's 1x1 convs, the fc)",
     r"gemm|nvjet|cutlass|s16816|s1688"),
    ("batch norm", r"bn_|batch_norm|BatchNorm|batchnorm"),
    ("layout transposes", r"nchwToNhwc|nhwcToNchw|[Tt]ranspose"),
    ("copies and casts", r"copy|Copy|cast"),
    ("pooling", r"pool|Pool"),
    ("loss (softmax)", r"softmax|nll"),
    ("reductions", r"reduce_kernel|Reduce"),
    ("elementwise (relu, residual add, optimizer)",
     r"elementwise|vectorized|unrolled|threshold"),
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="resnet50",
                    choices=("resnet50", "mobilenet_v3_large",
                             "shufflenet_v2_x1_0"))
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "torch_tools"))
    import torch

    if not torch.cuda.is_available():
        print("torch_resnet_profile: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from torch_encoder_profile import _profile, _report

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    warm = 3
    if args.model == "resnet50":
        shape = (cs.RESNET_BATCH, cs.RESNET_SIZE, cs.RESNET_CLASSES)
    elif args.model == "mobilenet_v3_large":
        shape = (cs.MOBILENET_BATCH, cs.MOBILENET_SIZE,
                 cs.MOBILENET_CLASSES)
    else:
        shape = (cs.SHUFFLE_BATCH, cs.SHUFFLE_SIZE, cs.SHUFFLE_CLASSES)
    with cs._vision_setup(torch):
        model = (cs._resnet50(torch, 0) if args.model == "resnet50"
                 else cs._mobilenet(torch, args.model, 70)
                 if args.model == "mobilenet_v3_large"
                 else cs._shufflenet(torch, args.model, 90))
        opt = cs._momentum(model)
        batches = cs._image_batches(torch, 60, warm + args.steps, *shape)
        model.train()

        def steps(part):
            for images, labels in part:
                cs._vision_step(model, opt, images, labels)

        steps(batches[:warm])
        wall, kernels = _profile(torch, lambda: steps(batches[warm:]))
        print(json.dumps(_report(
            f"{args.model} train {shape[0]} x {shape[1]}^2", wall,
            kernels, f"{args.steps} steps", KINDS)))
        images, labels = batches[-1]
        model(images).float().sum().backward()      # gradients to apply

        def optimizer_steps():
            for _ in range(args.steps):
                opt.step()

        optimizer_steps()
        wall, kernels = _profile(torch, optimizer_steps)
        print(json.dumps(_report(
            f"optimizer.step alone ({len(model.parameters())} parameters, "
            f"fp32 masters)", wall, kernels, f"{args.steps} steps", KINDS)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
