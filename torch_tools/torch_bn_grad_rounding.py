"""How far PyTorch's CUDA batch norm puts the fp32 gradients of gamma and
beta of a bf16 input from an fp64 sum, by layout, on one NVIDIA card.

    python3 torch_tools/torch_bn_grad_rounding.py

At ResNet-50's layer1 shape (32 x 64 x 56 x 56, bf16 input, fp32 gamma and
beta, training), for each pairing of input layout and incoming-gradient
layout (channels-first or channels-last) it runs
``torch.nn.functional.batch_norm`` and the port's ``F.batch_norm`` and
prints one JSON line: the largest error of d gamma and d beta against
``sum(g * xhat)`` and ``sum(g)`` taken in fp64, beside the largest |d beta|.
PyTorch keeps them fp32 only when both layouts are channels-last; the
port's ``batch_norm`` runs every such input so (``nn/functional/norm.py``).
The first line is the card's name and power limit. Needs a CUDA card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("torch_bn_grad_rounding: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.nn import functional as PF

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(32, 64, 56, 56, generator=gen, device=dev).bfloat16()
    w = torch.rand(64, generator=gen, device=dev) + 0.5
    b = torch.randn(64, generator=gen, device=dev)
    go = torch.randn(x.shape, generator=gen, device=dev).bfloat16()
    xd = x.double()
    xhat = ((xd - xd.mean((0, 2, 3), keepdim=True))
            / torch.sqrt(xd.var((0, 2, 3), unbiased=False, keepdim=True)
                         + 1e-5))
    ref_dw = (go.double() * xhat).sum((0, 2, 3))
    ref_db = go.double().sum((0, 2, 3))
    fmts = {"channels_first": torch.contiguous_format,
            "channels_last": torch.channels_last}
    for fn_name, fn in (("torch", torch.nn.functional.batch_norm),
                        ("port", PF.batch_norm)):
        for xf in fmts:
            for gf in fmts:
                xx = x.contiguous(memory_format=fmts[xf]).requires_grad_()
                ww = w.clone().requires_grad_()
                bb = b.clone().requires_grad_()
                out = fn(xx, torch.zeros(64, device=dev),
                         torch.ones(64, device=dev), ww, bb, training=True)
                dw, db = torch.autograd.grad(
                    out, (ww, bb), go.contiguous(memory_format=fmts[gf]))
                print(json.dumps({
                    "batch_norm": fn_name, "input": xf, "gradient": gf,
                    "dgamma_max_err": (dw.double() - ref_dw).abs().max()
                    .item(),
                    "dbeta_max_err": (db.double() - ref_db).abs().max()
                    .item(),
                    "dbeta_largest": ref_db.abs().max().item()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
