"""Normalization functionals — port of ``paddle_tpu/nn/functional/norm.py``
(``layer_norm``, ``batch_norm``, ``normalize``, ``instance_norm``,
``group_norm``, ``local_response_norm`` and ``spectral_norm``).

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

``instance_norm`` and ``group_norm`` are the JAX ops ``instance_norm_op``
and ``group_norm_op`` (the ``amp`` black list): fp32 statistics (the mean,
then the mean of the squared deviations), the affine in fp32 and the output
in ``x``'s dtype. ``instance_norm`` takes the statistics of each sample's
channel and, as the JAX package and Paddle's dygraph op, ignores
``running_mean``, ``running_var``, ``use_input_stats``, ``momentum`` and
``data_format``. ``group_norm`` takes a group's statistics as the mean of
its channels' (every channel has as many elements), so neither reshapes the
input: elementwise ops keep a channels-last input channels-last.
``local_response_norm`` divides by ``(k + alpha * sum)^beta`` with the sum
of squares over a window of ``size`` channels (the JAX package's sum, not
Paddle's ``alpha / size``; ``ROADMAP.md`` C), and ``spectral_norm`` divides
the weight by its largest singular value from ``power_iters`` power
iterations from the given ``u``, ``v``, which it does not write back (as
Paddle's op); the gradient runs through the iterations, as JAX's does.
"""
from __future__ import annotations

import torch

from ...amp.auto_cast import cast_inputs as _amp_cast
from ...ops.cuda import layer_norm as _ln
from ...ops.dispatch import op
from .conv import CHANNELS_LAST

__all__ = ["layer_norm", "batch_norm", "normalize", "instance_norm",
           "group_norm", "local_response_norm", "spectral_norm"]


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


def _affine(out, weight, bias, axis):
    shape = [1] * out.ndim
    shape[axis] = -1
    return out * weight.float().reshape(shape) + bias.float().reshape(shape)


@op("instance_norm_op")
def _instance_norm_raw(x, weight=None, bias=None, epsilon=1e-5,
                       has_affine=False):
    xf = x.float()
    axes = tuple(range(2, x.ndim))
    mean = xf.mean(axes, keepdim=True)
    var = (xf - mean).square().mean(axes, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + epsilon)
    if has_affine:
        out = _affine(out, weight, bias, 1)
    return out.to(x.dtype)


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Each sample's channel normalised over its spatial axes (axis 1 the
    channel axis, whatever ``data_format`` says, as in the JAX package)."""
    if weight is not None and bias is not None:
        return _instance_norm_raw(x, weight, bias, epsilon=eps,
                                  has_affine=True)
    return _instance_norm_raw(x, epsilon=eps, has_affine=False)


@op("group_norm_op")
def _group_norm_raw(x, weight=None, bias=None, epsilon=1e-5, groups=1,
                    channel_last=False):
    if channel_last:
        x = x.movedim(-1, 1)
    n, c = x.shape[:2]
    xf = x.float()
    axes = tuple(range(2, x.ndim))
    lift = [n, c] + [1] * len(axes)

    def group_mean(per_channel):
        g = per_channel.reshape(n, groups, c // groups).mean(-1)
        return g.repeat_interleave(c // groups, 1).reshape(lift)

    mean = group_mean(xf.mean(axes))
    dev = xf - mean
    var = group_mean(dev.square().mean(axes))
    out = dev * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight.float().reshape(c, *[1] * len(axes))
    if bias is not None:
        out = out + bias.float().reshape(c, *[1] * len(axes))
    out = out.to(x.dtype)
    return out.movedim(1, -1) if channel_last else out


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    """Each sample's ``num_groups`` channel groups normalised over the
    group's channels and spatial axes, then ``weight`` and ``bias`` where
    given (the JAX package drops a bias given without a weight and fails
    on a weight without a bias; ``ROADMAP.md`` C)."""
    return _group_norm_raw(x, weight, bias, epsilon=epsilon,
                           groups=int(num_groups),
                           channel_last=data_format.endswith("C")
                           and data_format != "NCHW")


@op("local_response_norm_op")
def _lrn_raw(x, size=5, alpha=1e-4, beta=0.75, k=1.0, channel_last=False):
    if channel_last:
        x = x.movedim(-1, 1)
    c = x.shape[1]
    half = size // 2
    sq = torch.nn.functional.pad(x.square().movedim(1, -1),
                                 (half, size - half - 1)).movedim(-1, 1)
    acc = sum(sq[:, i:i + c] for i in range(size))
    out = x / (k + alpha * acc) ** beta
    return out.movedim(1, -1) if channel_last else out


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """``x / (k + alpha * s)^beta``, ``s`` the sum of squares over ``size``
    neighbouring channels (zeros past the ends)."""
    return _lrn_raw(x, size=int(size), alpha=alpha, beta=beta, k=k,
                    channel_last=data_format not in ("NCHW", "NCL", "NCW",
                                                     "NCDHW"))


@op("spectral_norm_op")
def _spectral_norm_raw(weight, u, v, dim=0, power_iters=1, eps=1e-12):
    wm = weight.movedim(dim, 0)
    wm = wm.reshape(wm.shape[0], -1)
    for _ in range(power_iters):
        v = wm.t() @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = wm @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    return weight / (u @ (wm @ v))


def spectral_norm(x, weight_u, weight_v, dim=0, power_iters=1, eps=1e-12,
                  name=None):
    """``x`` over its largest singular value (of ``x`` as a matrix with
    axis ``dim`` first), estimated from ``weight_u``, ``weight_v``."""
    return _spectral_norm_raw(x, weight_u, weight_v, dim=int(dim),
                              power_iters=int(power_iters), eps=eps)
