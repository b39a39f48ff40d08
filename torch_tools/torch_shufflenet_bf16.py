"""ShuffleNetV2 x1.0 in bf16 against fp32 from the same weights, traced
stage by stage (the stem, the 16 blocks, ``conv_last``, the pooled head),
in train mode (batch statistics), on the CPU or the card.

    python3 torch_tools/torch_shufflenet_bf16.py [--device cpu|cuda]
        [--batch 32] [--seeds 6]

The bf16 model is the recipe of ``chip_smoke.py`` (``to(bfloat16)`` with
the batch norms kept fp32). For each seed (weights from
``torch.manual_seed(seed)``, one standard-normal batch of 224 x 224 images
and labels): the whole model's logits gap (max |bf16 - fp32| over the
largest fp32 logit, and in bf16 steps of it), the cross-entropy gap, and
the control that rounds only the input to bf16 and runs fp32 after it.
For seed 1: each stage alone (fed the fp32 run's input of that stage,
rounded to bf16, and a seeded upstream gradient) against the fp32 stage,
relative L2 of the output, dx and the stage's parameter gradients, and of
the output round-tripped through fp8 e4m3 (the fault control); then the
whole model with that fp8 fault at stages 4, 8, 12 and 16.
``chip_smoke.py``'s ``shufflenet_vs_plain`` uses ``stage_errors``.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_STEP = 2.0 ** -7


def stages(torch, model):
    """``(stage, parameters)`` of ShuffleNetV2's forward: the stem, each
    block, ``conv_last``, the pooled head."""
    head = (lambda h: model.fc(torch.flatten(model.pool(h), 1)),
            list(model.fc.parameters()))
    stem = (lambda h: model.maxpool(model.conv1(h)),
            list(model.conv1.parameters()))
    return ([stem] + [(b, list(b.parameters())) for b in model.blocks]
            + [(model.conv_last, list(model.conv_last.parameters())), head])


def _rel(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


def _fp8(torch, t):
    return t.to(torch.float8_e4m3fn).to(t.dtype)


def stage_errors(torch, m32, m16, images, gen, ctx32=contextlib.nullcontext,
                 ctx16=contextlib.nullcontext):
    """Each stage of ``m16`` (bf16) fed ``m32``'s (fp32) input of that
    stage, rounded to bf16 (channels-last on the card), and an upstream
    gradient drawn from ``gen``, against ``m32``'s stage: relative L2 of
    the output, dx, the parameter gradients, and the fp8 control. ``ctx32``
    / ``ctx16``: the setting each model runs under."""
    rows, h = [], images
    for (s32, p32), (s16, p16) in zip(stages(torch, m32), stages(torch, m16)):
        a32 = h.detach().requires_grad_()
        with ctx32():
            o32 = s32(a32)
            up = torch.randn(o32.shape, generator=gen, device=o32.device)
            o32.backward(up)
        a16 = h.detach().to(torch.bfloat16)
        if a16.dim() == 4 and a16.is_cuda:
            a16 = a16.contiguous(memory_format=torch.channels_last)
        a16.requires_grad_()
        with ctx16():
            o16 = s16(a16)
            o16.backward(up.to(torch.bfloat16))
        rows.append({
            "out": _rel(o16.detach(), o32.detach()),
            "dx": _rel(a16.grad, a32.grad),
            "dw": _rel(torch.cat([p.grad.float().flatten() for p in p16]),
                       torch.cat([p.grad.flatten() for p in p32])),
            "control": _rel(_fp8(torch, o16.detach()), o32.detach())})
        h = o32.detach()
    return rows


def whole_gap(torch, m32, m16, images, labels, fault=None, rounded=False):
    """The chained forward of both models: the logits gap over the largest
    fp32 logit and the cross-entropy gap. ``fault``: the stage whose bf16
    output goes through fp8; ``rounded``: run ``m32`` again on the input
    rounded to bf16 in place of ``m16`` (the input-rounding control)."""
    f = torch.nn.functional
    other = m32 if rounded else m16
    h32 = images
    h16 = images.to(torch.bfloat16)
    if rounded:
        h16 = h16.float()
    with torch.no_grad():
        for i, ((s32, _), (s16, _)) in enumerate(zip(stages(torch, m32),
                                                     stages(torch, other))):
            h32, h16 = s32(h32), s16(h16)
            if i == fault:
                h16 = _fp8(torch, h16)
        largest = float(h32.abs().max())
        loss32 = float(f.cross_entropy(h32.float(), labels))
        loss16 = float(f.cross_entropy(h16.float(), labels))
    gap = float((h16.float() - h32).abs().max()) / largest
    return {"logits_gap_of_largest": gap, "logits_gap_bf16_steps":
            gap / BF16_STEP, "largest": largest,
            "loss_gap": abs(loss16 - loss32)}


def models(torch, seed, device):
    from paddle_tpu_torch.vision import models as zoo

    torch.manual_seed(seed)
    m32 = zoo.shufflenet_v2_x1_0(num_classes=1000, device=device)
    m16 = copy.deepcopy(m32).to(torch.bfloat16)
    for m in m16.modules():
        if type(m).__name__.startswith("BatchNorm"):
            m.float()
    m32.train()
    m16.train()
    return m32, m16


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seeds", type=int, default=6)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    def batch(seed):
        gen = torch.Generator(device=args.device).manual_seed(100 + seed)
        return (torch.randn(args.batch, 3, 224, 224, generator=gen,
                            device=args.device),
                torch.randint(0, 1000, (args.batch,), generator=gen,
                              device=args.device))

    for seed in range(1, args.seeds + 1):
        m32, m16 = models(torch, seed, args.device)
        images, labels = batch(seed)
        print("seed", seed, json.dumps({
            "bf16": whole_gap(torch, m32, m16, images, labels),
            "input_rounded_fp32": whole_gap(torch, m32, m16, images, labels,
                                            rounded=True)}), flush=True)
    m32, m16 = models(torch, 1, args.device)
    images, labels = batch(1)
    gen = torch.Generator(device=args.device).manual_seed(101)
    rows = stage_errors(torch, m32, m16, images, gen)
    print("stages", json.dumps(rows), flush=True)
    for fault in (4, 8, 12, 16):
        print("fp8_fault_at_stage", fault, json.dumps(whole_gap(
            torch, m32, m16, images, labels, fault=fault)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
