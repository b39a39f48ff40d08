"""The common layers with the JAX package's initializers
(``paddle_tpu/nn/layer/common.py``): ``Linear``, ``Embedding``, the
dropouts, ``Identity``, ``Flatten``, ``CosineSimilarity``, ``Bilinear`` and
``PairwiseDistance``, and embedding tables for the port's own models.

* :class:`Linear` holds Paddle's ``[in, out]`` weight, drawn by its
  ``weight_attr`` (a :class:`~.layers.ParamAttr`, an initializer or a name;
  default XavierNormal, std ``sqrt(2 / (in + out))``), and a bias drawn by
  ``bias_attr`` (default zeros; ``False``: no bias). Its forward is the
  port's ``F.linear`` (the ``amp`` hook and JAX's dtype promotion).
* :class:`Embedding` holds a ``[num, dim]`` table (default XavierNormal)
  whose ``padding_idx`` row starts at zero; :class:`Bilinear` a ``[out,
  in1, in2]`` weight and an ``[out]`` bias, both ``U(-1/sqrt(in1),
  1/sqrt(in1))``. The dropout layers drop in ``train()`` only.
* :func:`embedding_table` is an ``nn.Embedding`` drawn from a normal of
  ``std`` (the encoders' ``Normal(initializer_range)``).
* The resampling, padding and rearranging layers (``Upsample``,
  ``UpsamplingNearest2D``, ``UpsamplingBilinear2D``, ``Pad1D/2D/3D``,
  ``ZeroPad2D``, ``PixelShuffle``, ``PixelUnshuffle``, ``ChannelShuffle``,
  ``Fold``, ``Unfold``) hold no parameter and call their functional.

Weights are drawn on the CPU from ``generator`` (``None``: PyTorch's
default one), so one seed gives one model on every device; a Linear built
on its own then moves to the current place, one inside a model moves with
the model.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .. import functional as F
from ...ops import linalg as _linalg
from ..initializer import Uniform, XavierNormal
from .layers import Layer, ParamAttr, make_parameter

__all__ = ["Linear", "Embedding", "Dropout", "Dropout2D", "Dropout3D",
           "AlphaDropout", "Identity", "Flatten", "CosineSimilarity",
           "Bilinear", "PairwiseDistance", "embedding_table", "Upsample",
           "UpsamplingNearest2D", "UpsamplingBilinear2D", "Pad1D", "Pad2D",
           "Pad3D", "ZeroPad2D", "PixelShuffle", "PixelUnshuffle",
           "ChannelShuffle", "Fold", "Unfold"]


def normal_(t, std, generator=None):
    """Redraw ``t`` in place from ``N(0, std^2)``."""
    with torch.no_grad():
        t.normal_(0.0, std, generator=generator)



class Linear(Layer):
    """``paddle.nn.Linear``: ``y = x W + b`` with ``W`` ``[in, out]``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, dtype=None, generator=None):
        super().__init__()
        self._in_features = in_features
        self._out_features = out_features
        dtype = dtype or torch.float32
        self.weight = make_parameter(
            [in_features, out_features], ParamAttr._to_attr(weight_attr),
            dtype, default_initializer=XavierNormal(), generator=generator)
        battr = ParamAttr._to_attr(bias_attr)
        self.bias = (None if battr is False else make_parameter(
            [out_features], battr, dtype, is_bias=True, generator=generator))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self._in_features}, "
                f"out_features={self._out_features}")


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, input):
        return input


class Embedding(Layer):
    """``paddle.nn.Embedding``: rows of a ``[num_embeddings, embedding_dim]``
    table; ``sparse`` gives the dense gradient (``ROADMAP.md`` C)."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._sparse = bool(sparse)
        self._padding_idx = (
            None if padding_idx is None
            else padding_idx if padding_idx >= 0
            else num_embeddings + padding_idx)
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=XavierNormal())
        if self._padding_idx is not None:
            with torch.no_grad():
                self.weight[self._padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx,
                           sparse=self._sparse)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, input):
        return F.dropout(input, self.p, axis=self.axis,
                         training=self.training, mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, input):
        return F.dropout2d(input, self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, input):
        return F.dropout3d(input, self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, input):
        return F.alpha_dropout(input, self.p, training=self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, input):
        return torch.flatten(input, self.start_axis, self.stop_axis)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class Bilinear(Layer):
    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        bound = 1 / math.sqrt(in1_features)
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr,
            default_initializer=Uniform(-bound, bound))
        self.bias = self.create_parameter(
            [out_features], attr=bias_attr, is_bias=True,
            default_initializer=Uniform(-bound, bound))

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class PairwiseDistance(Layer):
    """The ``p``-norm of ``x - y + epsilon`` along the last axis."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return _linalg.norm(x - y + self.epsilon, p=self.p, axis=-1,
                            keepdim=self.keepdim)


def embedding_table(num, dim, std, generator=None):
    """An ``nn.Embedding(num, dim)`` drawn from ``N(0, std^2)``."""
    emb = nn.Embedding(num, dim)
    normal_(emb.weight, std, generator)
    return emb


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0,
                         data_format)


class UpsamplingBilinear2D(Upsample):
    """Bilinear with ``align_corners=True`` (Paddle's result; the JAX
    package drops the flag, ``ROADMAP.md`` C)."""

    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0,
                         data_format)


class _PadNd(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value,
                     self.data_format)


class Pad1D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadNd):
    pass


class Pad3D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(_PadNd):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups = groups
        self.data_format = data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.args = (output_sizes, kernel_sizes, strides, paddings,
                     dilations)

    def forward(self, x):
        return F.fold(x, *self.args)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)
