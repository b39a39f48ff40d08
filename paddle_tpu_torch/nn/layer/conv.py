"""Convolution layers — port of ``paddle_tpu/nn/layer/conv.py`` (``Conv1D``,
``Conv2D``, ``Conv3D`` and ``Conv1DTranspose``, ``Conv2DTranspose``,
``Conv3DTranspose``).

The weight is ``[out, in/groups, *k]`` (a transpose's ``[in, out/groups,
*k]``), drawn on the CPU from ``generator`` (``None``: PyTorch's default
one) by ``weight_attr`` (a :class:`~.layers.ParamAttr`, an initializer or
a name), by default Xavier-normal as the JAX package draws it, ``std =
sqrt(2 / (fan_in + fan_out))`` with ``fan_in = shape[1] * prod(k)`` and
``fan_out = shape[0] * prod(k)``; the bias is drawn by ``bias_attr``
(default zeros) and ``bias_attr=False`` leaves it out. A layer built while
layout autotune is on keeps a 2-D or 3-D weight in channels-last memory
format, as the convolution wants it then.
Built on its own, a layer lands on the current place (``Layer``); inside
a model it moves with the model.
"""
from __future__ import annotations

import torch

from .. import functional as F
from ...framework.layout_autotune import layout_autotune_enabled
from ..functional.conv import CHANNELS_LAST, _norm_tuple
from ..initializer import XavierNormal
from .layers import Layer, ParamAttr, make_parameter

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, nd, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 generator=None, transposed=False, output_padding=0):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(
                f"{type(self).__name__}: padding_mode {padding_mode!r}; the "
                f"port pads with zeros only")
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _norm_tuple(kernel_size, nd)
        self._stride = stride
        self._padding = padding
        self._output_padding = output_padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        shape = ([in_channels, out_channels // groups] if transposed
                 else [out_channels, in_channels // groups])
        self.weight = make_parameter(
            shape + list(self._kernel_size), ParamAttr._to_attr(weight_attr),
            torch.float32, default_initializer=XavierNormal(),
            generator=generator)
        if layout_autotune_enabled() and nd in CHANNELS_LAST:
            self.weight.data = self.weight.data.contiguous(
                memory_format=CHANNELS_LAST[nd])
        battr = ParamAttr._to_attr(bias_attr)
        self.bias = (None if battr is False else make_parameter(
            [out_channels], battr, torch.float32, is_bias=True,
            generator=generator))

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


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, generator, True,
                         output_padding)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, output_size,
                                  self._data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, generator, True,
                         output_padding)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, output_size,
                                  self._data_format)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, generator, True,
                         output_padding)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, output_size,
                                  self._data_format)
