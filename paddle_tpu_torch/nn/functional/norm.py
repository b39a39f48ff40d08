"""Normalization functionals — port of ``paddle_tpu/nn/functional/norm.py``
(``layer_norm``, ``batch_norm`` and ``normalize``).

Routing as in the JAX package: a last-axis affine LayerNorm whose feature
count is a multiple of 128 goes to the kernel wrapper (K7 forward and K8
backward on CUDA, their plain versions on the CPU); anything else runs the
plain PyTorch expression, which autograd differentiates. Either
way the statistics are fp32 and the output is in ``x.dtype``, and gamma/beta
may be fp32 while ``x`` is bf16.

``batch_norm`` has no Pallas kernel in the JAX package (XLA ops), so it runs
``torch.nn.functional.batch_norm`` (cuDNN or PyTorch's channels-last kernels
on the card) under the JAX package's contract: statistics and the affine
math in fp32 (the parameters and running statistics go in as fp32), the
output in ``x.dtype``, so a bf16 conv stack with fp32 batch norms stays
bf16. Paddle's ``momentum`` m weighs the old running value,
``running = m * running + (1 - m) * batch``, where PyTorch's weighs the
batch: PyTorch's momentum is ``1 - m``. The running variance takes the
unbiased batch variance (``n / (n - 1)``), in both. Running buffers of
another dtype than fp32 are updated in fp32 and rounded back once. On the
card a bf16/fp16 input whose gamma takes a gradient runs channels-last,
its gradient too (``_rounds_affine_grads``), and comes back in the layout
it came in.
"""
from __future__ import annotations

import torch

from ...amp.auto_cast import cast_inputs as _amp_cast
from ...ops.cuda import layer_norm as _ln
from ...ops.dispatch import op
from .conv import CHANNELS_LAST

__all__ = ["layer_norm", "batch_norm", "normalize"]


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


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    if _kernel_ln_ok(normalized_shape, weight, bias):
        x, weight, bias = _amp_cast("fused_layer_norm", x, weight, bias)
        return _ln.layer_norm(x, weight, bias, epsilon)
    x, weight, bias = _amp_cast("layer_norm_op", x, weight, bias)
    return _layer_norm_raw(x, normalized_shape, weight, bias, epsilon)


def _bn_axis(x, data_format):
    """The channel axis, as the JAX package reads ``data_format``."""
    if data_format in ("NHWC", "NLC", "NDHWC") or (
            data_format.endswith("C") and x.ndim > 2
            and data_format != "NCHW"):
        return x.ndim - 1
    return 1


def _as(t, dtype):
    return None if t is None else t.to(dtype)


def _rounds_affine_grads(x, weight):
    """PyTorch's CUDA batch norm backward rounds the fp32 gradients of gamma
    and beta of a bf16/fp16 input to about the input's precision unless both
    the input and the incoming gradient are channels-last, where its kernels
    keep them fp32 (``torch_tools/torch_bn_grad_rounding.py``)."""
    return (x.is_cuda and x.dtype in (torch.bfloat16, torch.float16)
            and x.ndim in (3, 4, 5) and weight is not None
            and weight.requires_grad and torch.is_grad_enabled())


class _GradLayout(torch.autograd.Function):
    """``y`` in ``out_fmt``; the gradient that flows back through it in
    ``fmt``, the batch norm's layout."""

    @staticmethod
    def forward(ctx, y, fmt, out_fmt):
        ctx.fmt = fmt
        return y.contiguous(memory_format=out_fmt) if out_fmt != fmt else \
            y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous(memory_format=ctx.fmt), None, None


def batch_norm(x, running_mean, running_var, weight, bias, training=False,
               momentum=0.9, epsilon=1e-5, data_format="NCHW",
               use_global_stats=None, name=None):
    """``paddle.nn.functional.batch_norm``: normalise over every axis but
    the channel axis with the batch's statistics (training) or the running
    ones (``use_global_stats``, or eval), updating ``running_mean`` and
    ``running_var`` in place in training."""
    axis = _bn_axis(x, data_format)
    use_stats = (use_global_stats if use_global_stats is not None
                 else not training)
    op = "batch_norm_infer" if use_stats else "batch_norm_train"
    x, weight, bias = _amp_cast(op, x, weight, bias)
    if axis != 1:
        x = x.movedim(axis, 1)
    shape, fmt = x.shape, None
    if _rounds_affine_grads(x, weight):
        # run channels-last ([N, C, L] as [N, C, L, 1]), the gradient too;
        # a channels-first input gets its output back channels-first
        fmt = CHANNELS_LAST[max(x.ndim, 4) - 2]
        x = x.reshape(*shape, *([1] * (4 - x.ndim)))
        out_fmt = (fmt if x.is_contiguous(memory_format=fmt)
                   else torch.contiguous_format)
        x = x.contiguous(memory_format=fmt)
    # fp32 statistics (fp64 for an fp64 input)
    dt = torch.promote_types(x.dtype, torch.float32)
    rm, rv = _as(running_mean, dt), _as(running_var, dt)
    out = torch.nn.functional.batch_norm(
        x, rm, rv, _as(weight, dt), _as(bias, dt), training=not use_stats,
        momentum=1.0 - momentum, eps=epsilon)
    if fmt is not None:
        out = _GradLayout.apply(out, fmt, out_fmt).reshape(shape)
    if not use_stats:
        with torch.no_grad():
            for buf, new in ((running_mean, rm), (running_var, rv)):
                if new is not buf:
                    buf.copy_(new)
    return out.movedim(1, axis) if axis != 1 else out


@op("normalize_op")
def _normalize_raw(x, p=2.0, axis=1, epsilon=1e-12):
    norm = torch.sum(torch.abs(x) ** p, dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp_min(norm, epsilon)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x`` over its ``p``-norm along ``axis`` (at least ``epsilon``)."""
    return _normalize_raw(x, p=float(p), axis=axis, epsilon=epsilon)
