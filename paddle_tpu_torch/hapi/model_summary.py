"""Model summary and FLOP count — port of
``paddle_tpu/hapi/model_summary.py`` (reference
``python/paddle/hapi/model_summary.py``, ``hapi/dynamic_flops.py``): a
layer table with output shapes and parameter counts, through the port
``Layer``'s ``register_forward_post_hook``. The sample input is zeros on the
network's device (its parameters'; the current place for a network without
any)."""
from __future__ import annotations

import numpy as np
import torch

from ..framework.dtype import convert_dtype
from ..framework.place import resolve_device

__all__ = ["summary", "flops"]


def _device(net):
    for t in net.parameters():
        return t.device
    return resolve_device(None)


def _zeros(shape, dtype, device):
    return torch.zeros([int(d) for d in shape],
                       dtype=convert_dtype(dtype or "float32"), device=device)


def _run(net, inputs, hooks):
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(*inputs)
    finally:
        if was_training:
            net.train()
        for h in hooks:
            h.remove()


def summary(net, input_size=None, dtypes=None, input=None):
    """Prints the per-layer table, returns
    ``{'total_params': int, 'trainable_params': int}``."""
    if input is None:
        if input_size is None:
            raise ValueError("summary needs input_size or a sample input")
        sizes = input_size if isinstance(input_size, list) else [input_size]
        sizes = [s if isinstance(s, (tuple, list)) else (s,) for s in sizes]
        dts = dtypes if isinstance(dtypes, (list, tuple)) else [dtypes] * len(sizes)
        dev = _device(net)
        inputs = [_zeros([d if d and d > 0 else 1 for d in s], dt, dev)
                  for s, dt in zip(sizes, dts)]
    else:
        inputs = input if isinstance(input, (list, tuple)) else [input]

    rows = []
    hooks = []

    def register(layer, prefix):
        for name, sub in layer._modules.items():
            path = f"{prefix}.{name}" if prefix else name
            if sub._modules:
                register(sub, path)
            else:
                def hook(l, ins, out, path=path):
                    shape = None
                    o = out[0] if isinstance(out, (tuple, list)) else out
                    if isinstance(o, torch.Tensor):
                        shape = list(o.shape)
                    n_params = sum(
                        int(np.prod(p.shape))
                        for p in l.parameters(include_sublayers=False))
                    rows.append((f"{type(l).__name__} ({path})", shape, n_params))

                hooks.append(sub.register_forward_post_hook(hook))

    register(net, "")
    _run(net, inputs, hooks)

    total = sum(int(np.prod(p.shape)) for p in net.parameters())
    trainable = sum(int(np.prod(p.shape)) for p in net.parameters()
                    if not p.stop_gradient)

    width = 72
    print("-" * width)
    print(f"{'Layer (type)':<40}{'Output Shape':<20}{'Param #':>10}")
    print("=" * width)
    for name, shape, n in rows:
        print(f"{name[:39]:<40}{str(shape):<20}{n:>10,}")
    print("=" * width)
    print(f"Total params: {total:,}")
    print(f"Trainable params: {trainable:,}")
    print(f"Non-trainable params: {total - trainable:,}")
    print("-" * width)
    return {"total_params": total, "trainable_params": trainable}


def flops(net, input_size, custom_ops=None, print_detail=False):
    """Reference ``hapi/dynamic_flops.py flops``: per-layer FLOP count via
    forward hooks, using the reference's counting conventions — a
    multiply-accumulate is ONE op, conv counts its bias add, so the numbers
    are directly comparable with upstream ``paddle.flops`` output."""
    from ..nn.layer.common import Linear
    from ..nn.layer.conv import Conv2D
    from ..nn.layer.norm import BatchNorm2D, LayerNorm

    counts = {"total": 0}
    rows = []
    hooks = []
    custom_ops = custom_ops or {}

    def count(layer, ins, out):
        x = ins[0] if isinstance(ins, (tuple, list)) else ins
        o = out[0] if isinstance(out, (tuple, list)) else out
        n = 0
        t = type(layer)
        if t in custom_ops:
            n = int(custom_ops[t](layer, x, o))
        elif isinstance(layer, Conv2D):
            # reference dynamic_flops.py count_convNd:
            # out_numel * (cin/groups * kh * kw + bias)
            kh, kw = layer._kernel_size
            cin_per_group = layer.weight.shape[1]
            bias_ops = 1 if getattr(layer, "bias", None) is not None else 0
            n = int(np.prod(o.shape)) * (cin_per_group * kh * kw + bias_ops)
        elif isinstance(layer, Linear):
            # reference count_linear: in_features * out_numel (MAC = 1 op)
            n = layer.weight.shape[0] * int(np.prod(o.shape))
        elif isinstance(layer, (BatchNorm2D, LayerNorm)):
            n = 2 * int(np.prod(o.shape))
        if n:
            counts["total"] += n
            rows.append((type(layer).__name__, n))

    for sub in net.sublayers(include_self=True):
        if not sub._modules:
            hooks.append(sub.register_forward_post_hook(count))
    sizes = input_size if isinstance(input_size, (tuple, list)) else [input_size]
    if isinstance(sizes[0], int):
        sizes = [sizes]
    dev = _device(net)
    _run(net, [_zeros(s, None, dev) for s in sizes], hooks)
    if print_detail:
        for name, n in rows:
            print(f"{name:<24}{n:>16,}")
        print(f"Total FLOPs: {counts['total']:,}")
    return counts["total"]
