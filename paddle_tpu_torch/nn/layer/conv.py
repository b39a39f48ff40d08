"""Convolution layers — port of ``paddle_tpu/nn/layer/conv.py`` (``Conv1D``,
``Conv2D``, ``Conv3D``).

The weight is ``[out, in/groups, *k]``, drawn on the CPU from ``generator``
(``None``: PyTorch's default one) Xavier-normal as the JAX package draws it,
``std = sqrt(2 / (fan_in + fan_out))`` with ``fan_in = in/groups * prod(k)``
and ``fan_out = out * prod(k)``; the bias starts at 0 and ``bias_attr=False``
leaves it out. A layer built while layout autotune is on keeps a 2-D or 3-D
weight in channels-last memory format, as the convolution wants it then.
Built on its own, a layer lands on the current place (``Layer``); inside
a model it moves with the model.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .. import functional as F
from ...framework.layout_autotune import layout_autotune_enabled
from ..functional.conv import CHANNELS_LAST, _norm_tuple
from .common import _check_attrs, normal_
from .layers import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D"]


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, nd, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 generator=None):
        super().__init__()
        _check_attrs(weight_attr, bias_attr, type(self).__name__)
        if padding_mode != "zeros":
            raise NotImplementedError(
                f"{type(self).__name__}: padding_mode {padding_mode!r}; the "
                f"port pads with zeros only")
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _norm_tuple(kernel_size, nd)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        shape = [out_channels, in_channels // groups, *self._kernel_size]
        receptive = math.prod(self._kernel_size)
        std = math.sqrt(2.0 / ((shape[1] + shape[0]) * receptive))
        weight = torch.empty(shape)
        normal_(weight, std, generator)
        if layout_autotune_enabled() and nd in CHANNELS_LAST:
            weight = weight.contiguous(memory_format=CHANNELS_LAST[nd])
        self.weight = nn.Parameter(weight)
        self.bias = (None if bias_attr is False
                     else nn.Parameter(torch.zeros(out_channels)))

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, kernel_size="
                f"{self._kernel_size}, stride={self._stride}, padding="
                f"{self._padding}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, generator)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, generator)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, generator)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)
