"""Activation functionals — port of ``paddle_tpu/nn/functional/activation.py``
(and ``tanh_`` of ``paddle_tpu/ops/math.py``), in plain PyTorch.

``gelu``, ``relu`` and ``softmax`` cast their inputs through the ``amp``
hook of their JAX op names (``gelu``, ``relu``, ``softmax_op``); every other
activation is an op of the port's registry (``ops/dispatch.py::op``) under
the JAX package's op name, so ``amp.auto_cast`` treats it as JAX does
(``log_softmax_op`` stays fp32 under O1 and O2).

The JAX package's own formulas are kept where PyTorch's function of the
same name means something else: ``hardsigmoid(slope, offset)`` clips
``slope * x + offset`` (torch's has neither and uses 1/6), ``leaky_relu``
and ``prelu`` keep ``x`` where ``x >= 0`` (their gradient at 0 is 1),
``thresholded_relu`` gives ``value`` at and below the threshold. A Python
number meets a tensor in the tensor's dtype, as a weakly typed scalar does
in JAX (``ops/dispatch.py::scalar_like``): in bf16 the slope, offset and
threshold are bf16 values, the same on the card and on the host.

Random activations draw from the port's generator of the input's device
(``framework/random.py``), as the JAX package draws from its global key:
``rrelu`` in training its slopes ``U(lower, upper)``, ``gumbel_softmax`` its
Gumbel noise. Given the same slopes or noise (``_prelu_like``,
``_gumbel_softmax_raw``) both packages give the same output.
"""
from __future__ import annotations

import torch

from ...amp.auto_cast import cast_inputs as _amp_cast
from ...framework import random as rnd
from ...framework.dtype import convert_dtype
from ...framework.tensor import check_inplace
from ...ops import math as _math
from ...ops.dispatch import op, plain, scalar_like
from ...ops.math import tanh_  # noqa: F401

__all__ = [
    "gelu", "relu", "softmax", "sigmoid", "tanh", "tanh_", "silu", "swish",
    "relu6", "relu_", "elu", "elu_", "selu", "celu", "softplus",
    "softsign", "softshrink", "hardshrink", "hardtanh", "hardswish",
    "hardsigmoid", "leaky_relu", "log_sigmoid", "log_softmax", "softmax_",
    "mish", "tanhshrink", "thresholded_relu", "prelu", "rrelu", "glu",
    "maxout", "gumbel_softmax",
]

_F = torch.nn.functional


def gelu(x, approximate=False, name=None):
    """GELU; ``approximate=True`` is the tanh form, as ``jax.nn.gelu``."""
    (x,) = _amp_cast("gelu", x)
    return _F.gelu(x, approximate="tanh" if approximate else "none")


def relu(x, name=None):
    (x,) = _amp_cast("relu", x)
    return torch.relu(x)


def softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(convert_dtype(dtype))
    (x,) = _amp_cast("softmax_op", x)
    return torch.softmax(x, dim=int(axis))


def _inplace(x, out):
    """``out`` written into ``x`` (the JAX package rebinds ``x``)."""
    check_inplace(x)
    torch._C.TensorBase.copy_(x, plain(out))
    return x


relu6 = op("relu6")(lambda x: torch.clamp(x, 0.0, 6.0))
sigmoid = op("sigmoid")(lambda x: torch.sigmoid(x))
tanh = op("tanh_act")(lambda x: torch.tanh(x))
silu = op("silu")(lambda x: _F.silu(x))
swish = silu
mish = op("mish")(lambda x: x * torch.tanh(_F.softplus(x)))
tanhshrink = op("tanhshrink")(lambda x: x - torch.tanh(x))


def relu_(x, name=None):
    return _inplace(x, relu(plain(x)))


@op("leaky_relu")
def _leaky_relu_raw(x, negative_slope=0.01):
    return torch.where(x >= 0, x, scalar_like(negative_slope, x) * x)


def leaky_relu(x, negative_slope=0.01, name=None):
    return _leaky_relu_raw(x, negative_slope=negative_slope)


@op("elu")
def _elu_raw(x, alpha=1.0):
    return _F.elu(x, alpha=alpha)


def elu(x, alpha=1.0, name=None):
    return _elu_raw(x, alpha=alpha)


def elu_(x, alpha=1.0, name=None):
    return _inplace(x, _elu_raw(x, alpha=alpha))


@op("celu")
def _celu_raw(x, alpha=1.0):
    return _F.celu(x, alpha=alpha)


def celu(x, alpha=1.0, name=None):
    return _celu_raw(x, alpha=alpha)


@op("selu")
def _selu_raw(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    return scalar_like(scale, x) * torch.where(
        x > 0, x, scalar_like(alpha, x) * torch.expm1(x))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return _selu_raw(x, scale=scale, alpha=alpha)


@op("hardshrink")
def _hardshrink_raw(x, threshold=0.5):
    return _F.hardshrink(x, threshold)


def hardshrink(x, threshold=0.5, name=None):
    return _hardshrink_raw(x, threshold=threshold)


@op("softshrink")
def _softshrink_raw(x, threshold=0.5):
    return _F.softshrink(x, threshold)


def softshrink(x, threshold=0.5, name=None):
    return _softshrink_raw(x, threshold=threshold)


@op("hardtanh")
def _hardtanh_raw(x, min=-1.0, max=1.0):
    return torch.clamp(x, min, max)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return _hardtanh_raw(x, min=min, max=max)


@op("hardsigmoid")
def _hardsigmoid_raw(x, slope=0.1666667, offset=0.5):
    return torch.clamp(scalar_like(slope, x) * x + scalar_like(offset, x),
                       0.0, 1.0)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    """``clip(slope * x + offset, 0, 1)``."""
    return _hardsigmoid_raw(x, slope=slope, offset=offset)


@op("hardswish")
def hardswish(x, name=None):
    """``x * clip(x + 3, 0, 6) / 6`` (PyTorch's one kernel computes it)."""
    return _F.hardswish(x)


@op("softplus_op")
def _softplus_raw(x, beta=1.0, threshold=20.0):
    # x where beta * x > threshold, else log1p(exp(beta * x)) / beta
    return _F.softplus(x, beta, threshold)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return _softplus_raw(x, beta=beta, threshold=threshold)


@op("softsign")
def softsign(x, name=None):
    return x / (1.0 + torch.abs(x))


@op("logsigmoid")
def log_sigmoid(x, name=None):
    return _F.logsigmoid(x)


def softmax_(x, axis=-1, dtype=None, name=None):
    return _inplace(x, softmax(plain(x), axis, dtype))


@op("log_softmax_op")
def _log_softmax_raw(x, axis=-1):
    return torch.log_softmax(x, dim=axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(convert_dtype(dtype))
    return _log_softmax_raw(x, axis=int(axis))


@op("gumbel_softmax_op")
def _gumbel_softmax_raw(x, g, temperature=1.0, axis=-1):
    return torch.softmax((x + g) / temperature, dim=axis)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """Softmax of ``(x + g) / temperature`` with Gumbel noise ``g``; ``hard``
    gives the one-hot of its argmax with the soft result's gradient
    (straight-through)."""
    u = torch.empty(plain(x).shape, dtype=x.dtype, device=x.device)
    u.exponential_(generator=rnd.generator(x.device))
    g = -torch.log(u.clamp_min_(torch.finfo(u.dtype).tiny))
    y = _gumbel_softmax_raw(x, g, temperature=temperature, axis=axis)
    if not hard:
        return y
    y = plain(y)
    onehot = torch.zeros_like(y).scatter_(
        axis, y.argmax(dim=axis, keepdim=True), 1.0)
    return _math.add(onehot - y.detach(), y)


@op("maxout_op")
def _maxout_raw(x, groups=2, axis=1):
    axis = axis % x.ndim
    shape = list(x.shape)
    shape[axis:axis + 1] = [shape[axis] // groups, groups]
    return torch.amax(x.reshape(shape), dim=axis + 1)


def maxout(x, groups, axis=1, name=None):
    return _maxout_raw(x, groups=groups, axis=axis)


@op("thresholded_relu_op")
def _thresholded_relu_raw(x, threshold=1.0, value=0.0):
    return torch.where(x > scalar_like(threshold, x), x, value)


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return _thresholded_relu_raw(x, threshold=threshold, value=value)


@op("prelu_op")
def _prelu_raw(x, weight, data_format="NCHW"):
    # an array of x's rank, never 0-d: a slope promotes x's dtype (an fp32
    # slope makes a bf16 result fp32) as in JAX
    shape = [1] * x.ndim
    if weight.numel() != 1:
        shape[1 if data_format == "NCHW" else x.ndim - 1] = weight.numel()
    w = weight.reshape(shape)
    return torch.where(x >= 0, x, w * x)


def prelu(x, weight, data_format="NCHW", name=None):
    return _prelu_raw(x, weight, data_format=data_format)


@op("rrelu_train")
def _prelu_like(x, alpha):
    return torch.where(x >= 0, x, alpha * x)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=False, name=None):
    """Training: a slope ``U(lower, upper)`` an element; else the leaky relu
    of their mean."""
    if training:
        a = torch.empty(plain(x).shape, dtype=x.dtype, device=x.device)
        a.uniform_(lower, upper, generator=rnd.generator(x.device))
        return _prelu_like(x, a)
    return _leaky_relu_raw(x, negative_slope=(lower + upper) / 2.0)


@op("glu_op")
def _glu_raw(x, axis=-1):
    return _F.glu(x, dim=axis)


def glu(x, axis=-1, name=None):
    return _glu_raw(x, axis=axis)
