"""Parameter initializers — port of ``paddle_tpu/nn/initializer``.

An initializer draws on the CPU, from ``generator`` (``None``: PyTorch's
default generator, which ``paddle.seed`` reseeds), as the port's layers
do, so one seed gives one model on every device; the layer that holds the
parameter moves it to its device. The draws are not the JAX package's (a
jax key split per draw): the deterministic initializers (Constant, Assign,
Dirac) give the same values, the random ones the same law (fan and gain).
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
           "XavierNormal", "XavierUniform", "KaimingNormal",
           "KaimingUniform", "Assign", "Dirac", "Orthogonal",
           "calculate_gain"]


def calculate_gain(nonlinearity, param=None):
    gains = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "tanh": 5.0 / 3, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(
            2.0 / (1 + (param if param is not None else 0.01) ** 2)),
        "selu": 3.0 / 4,
    }
    if nonlinearity not in gains:
        raise ValueError(f"unsupported nonlinearity: {nonlinearity}")
    return gains[nonlinearity]


def _fans(shape):
    """Paddle's fans: ``[in, out]`` for a 2-d weight, ``[out, in, *k]`` for
    a convolution's."""
    shape = list(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    def __call__(self, shape, dtype=torch.float32, generator=None):
        return self._init(tuple(int(s) for s in shape), generator).to(dtype)

    def _init(self, shape, generator):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _init(self, shape, generator):
        return torch.full(shape, float(self.value))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def _init(self, shape, generator):
        return torch.empty(shape).normal_(self.mean, self.std,
                                          generator=generator)


class TruncatedNormal(Initializer):
    """``N(mean, std^2)`` cut to ``[mean + a std, mean + b std]``."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0, name=None):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def _init(self, shape, generator):
        z = torch.empty(shape)
        torch.nn.init.trunc_normal_(z, 0.0, 1.0, self.a, self.b,
                                    generator=generator)
        return z * self.std + self.mean


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, name=None):
        self.low, self.high = low, high

    def _init(self, shape, generator):
        return torch.empty(shape).uniform_(self.low, self.high,
                                           generator=generator)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def std(self, shape):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        return self.gain * math.sqrt(2.0 / (fi + fo))

    def _init(self, shape, generator):
        return torch.empty(shape).normal_(0.0, self.std(shape),
                                          generator=generator)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def limit(self, shape):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        return self.gain * math.sqrt(6.0 / (fi + fo))

    def _init(self, shape, generator):
        lim = self.limit(shape)
        return torch.empty(shape).uniform_(-lim, lim, generator=generator)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.slope, self.nonlinearity = (fan_in, negative_slope,
                                                      nonlinearity)

    def std(self, shape):
        fi = self.fan_in if self.fan_in is not None else _fans(shape)[0]
        return calculate_gain(self.nonlinearity, self.slope) / math.sqrt(fi)

    def _init(self, shape, generator):
        return torch.empty(shape).normal_(0.0, self.std(shape),
                                          generator=generator)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.slope, self.nonlinearity = (fan_in, negative_slope,
                                                      nonlinearity)

    def limit(self, shape):
        fi = self.fan_in if self.fan_in is not None else _fans(shape)[0]
        return (calculate_gain(self.nonlinearity, self.slope)
                * math.sqrt(3.0 / fi))

    def _init(self, shape, generator):
        lim = self.limit(shape)
        return torch.empty(shape).uniform_(-lim, lim, generator=generator)


class Assign(Initializer):
    def __init__(self, value, name=None):
        self.value = value

    def _init(self, shape, generator):
        v = self.value
        if isinstance(v, torch.Tensor):
            v = v.detach().as_subclass(torch.Tensor).cpu().float()
        else:
            v = torch.as_tensor(np.asarray(v, dtype=np.float64))
        return v.reshape(shape)


class Dirac(Initializer):
    def __init__(self, groups=1, name=None):
        self.groups = groups

    def _init(self, shape, generator):
        out = torch.zeros(shape)
        oc, ic = shape[0], shape[1]
        per = oc // self.groups
        centers = [s // 2 for s in shape[2:]]
        for g in range(self.groups):
            for i in range(min(per, ic)):
                out[(g * per + i, i, *centers)] = 1.0
        return out


class Orthogonal(Initializer):
    def __init__(self, gain=1.0, name=None):
        self.gain = gain

    def _init(self, shape, generator):
        flat = torch.empty(shape[0], int(np.prod(shape[1:])))
        torch.nn.init.orthogonal_(flat, self.gain, generator=generator)
        return flat.reshape(shape)


def apply_initializer(init, shape, dtype, is_bias=False, generator=None):
    """A CPU tensor from ``init`` (None: zeros for a bias, XavierNormal
    for a weight; a tensor or array: Assign)."""
    if init is None:
        init = Constant(0.0) if is_bias else XavierNormal()
    if isinstance(init, (torch.Tensor, np.ndarray, list)):
        init = Assign(init)
    return init(shape, dtype, generator)
