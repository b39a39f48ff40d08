"""Normalization functionals — port of ``paddle_tpu/nn/functional/norm.py``
(``layer_norm`` only).

Routing as in the JAX package: a last-axis affine LayerNorm whose feature
count is a multiple of 128 goes to the kernel wrapper (K7 forward and K8
backward on CUDA, their plain versions on the CPU); anything else runs the
plain PyTorch expression, which autograd differentiates. Either
way the statistics are fp32 and the output is in ``x.dtype``, and gamma/beta
may be fp32 while ``x`` is bf16.
"""
from __future__ import annotations

import torch

from ...ops.cuda import layer_norm as _ln

__all__ = ["layer_norm"]


def _layer_norm_raw(x, normalized_shape, weight=None, bias=None,
                    epsilon=1e-5):
    """Plain path over the trailing ``len(normalized_shape)`` axes."""
    xf = x.float()
    axes = tuple(range(x.ndim - len(normalized_shape), x.ndim))
    mean = xf.mean(axes, keepdim=True)
    var = (xf - mean).square().mean(axes, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def _kernel_ln_ok(normalized_shape, weight, bias):
    """``_pallas_ln_ok`` of the JAX package: last-axis norm, affine,
    lane-aligned features."""
    return (len(normalized_shape) == 1 and weight is not None
            and bias is not None and _ln.supports(normalized_shape[0]))


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    if _kernel_ln_ok(normalized_shape, weight, bias):
        return _ln.layer_norm(x, weight, bias, epsilon)
    return _layer_norm_raw(x, normalized_shape, weight, bias, epsilon)
