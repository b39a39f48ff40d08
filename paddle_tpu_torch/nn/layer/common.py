"""The Linear layer and embedding tables with the JAX package's
initializers (``paddle_tpu/nn/layer/common.py``).

* :class:`Linear` holds Paddle's ``[in, out]`` weight, drawn by its
  ``weight_attr`` (a :class:`~.layers.ParamAttr`, an initializer or a name;
  default XavierNormal, std ``sqrt(2 / (in + out))``), and a bias drawn by
  ``bias_attr`` (default zeros; ``False``: no bias). Its forward is the
  port's ``F.linear`` (the ``amp`` hook and JAX's dtype promotion).
* :func:`embedding_table` is an ``nn.Embedding`` drawn from a normal of
  ``std`` (the encoders' ``Normal(initializer_range)``).

Weights are drawn on the CPU from ``generator`` (``None``: PyTorch's
default one), so one seed gives one model on every device; a Linear built
on its own then moves to the current place, one inside a model moves with
the model.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import functional as F
from ..initializer import XavierNormal
from .layers import Layer, ParamAttr, make_parameter

__all__ = ["Linear", "embedding_table"]


def normal_(t, std, generator=None):
    """Redraw ``t`` in place from ``N(0, std^2)``."""
    with torch.no_grad():
        t.normal_(0.0, std, generator=generator)


def _check_attrs(weight_attr, bias_attr, layer):
    """The layers other than Linear take no ``ParamAttr`` yet
    (``ROADMAP.md``): their default initializers only, and ``bias_attr=False``
    for no bias."""
    if weight_attr is not None or bias_attr not in (None, False):
        raise NotImplementedError(
            f"{layer}: the port takes weight_attr=None and bias_attr None or "
            f"False, not {weight_attr!r}, {bias_attr!r}")


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


def embedding_table(num, dim, std, generator=None):
    """An ``nn.Embedding(num, dim)`` drawn from ``N(0, std^2)``."""
    emb = nn.Embedding(num, dim)
    normal_(emb.weight, std, generator)
    return emb
