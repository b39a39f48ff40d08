"""Gradient clipping — port of ``paddle_tpu/utils/clip.py``
(``ClipGradByValue``, ``ClipGradByNorm``, ``ClipGradByGlobalNorm``).

An optimizer's ``grad_clip`` gets its ``[(param, grad)]`` pairs after the
gradients are collected and before the learning rate, the regularizer and
the update (the JAX package's order). A parameter with ``need_clip =
False`` (and a missing gradient) passes through unchanged. New gradient
tensors are returned; ``p.grad`` is not touched.

``ClipGradByGlobalNorm`` sums the squares in fp32 and casts the scale to
each gradient's dtype before the multiply; ``ClipGradByNorm`` works in the
gradient's own dtype, both as in the JAX package.
"""
from __future__ import annotations

import torch

from ..framework.dtype import weak_scalar

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]


def _clipped(p, g):
    return g is not None and getattr(p, "need_clip", True)


class ClipGradBase:
    def __call__(self, params_grads):
        return self._dygraph_clip(params_grads)


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _dygraph_clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if _clipped(p, g):
                # the bounds in the gradient's dtype (JAX's weak scalars)
                lo = float(torch.tensor(self.min, dtype=g.dtype))
                hi = float(torch.tensor(self.max, dtype=g.dtype))
                g = torch.clamp(g, lo, hi)
            out.append((p, g))
        return out


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _dygraph_clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if _clipped(p, g):
                norm = torch.sqrt(torch.sum(torch.square(g)))
                scale = torch.clamp_max(
                    weak_scalar(self.clip_norm, norm)
                    / torch.clamp_min(norm, weak_scalar(1e-12, norm)), 1.0)
                g = g * scale
            out.append((p, g))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """The global norm over every clipped gradient; one scale for all. The
    squared sums are fp32, taken in another order than XLA's, so the scale
    may differ from the JAX package's by a few fp32 rounding steps."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def _dygraph_clip(self, params_grads):
        grads = [g for p, g in params_grads if _clipped(p, g)]
        if not grads:
            return params_grads
        sq = torch.stack([torch.sum(torch.square(g.float())) for g in grads])
        global_norm = torch.sqrt(torch.sum(sq))
        scale = torch.clamp_max(
            self.clip_norm / torch.clamp_min(global_norm, 1e-6), 1.0)
        scales = {}
        out = []
        for p, g in params_grads:
            if _clipped(p, g):
                if g.dtype not in scales:
                    scales[g.dtype] = scale.to(g.dtype)
                g = g * scales[g.dtype]
            out.append((p, g))
        return out
