"""The Linear layer and embedding tables with the JAX package's
initializers (``paddle_tpu/nn/layer/common.py``), for the encoder stack.

Both are ``torch.nn`` modules built on the CPU, their weights drawn from the
``generator`` given (``None``: PyTorch's default one), so one seed gives one
model on every device; the model that holds them moves them to its device.

* :class:`Linear` keeps PyTorch's ``[out, in]`` weight (``load_jax_state``
  transposes paddle's ``[in, out]``), draws it Xavier-normal (std
  ``sqrt(2 / (in + out))``, the JAX default) and starts the bias at 0.
  ``bias_attr=False`` leaves the bias out, as in paddle. Its forward is the
  port's ``F.linear`` (the ``amp`` hook and JAX's dtype promotion).
* :func:`embedding_table` is an ``nn.Embedding`` drawn from a normal of
  ``std`` (the encoders' ``Normal(initializer_range)``).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .. import functional as F

__all__ = ["Linear", "embedding_table"]


def normal_(t, std, generator=None):
    """Redraw ``t`` in place from ``N(0, std^2)``."""
    with torch.no_grad():
        t.normal_(0.0, std, generator=generator)


def _check_attrs(weight_attr, bias_attr, layer="Linear"):
    """The port has no ``ParamAttr``: the default initializers only, and
    ``bias_attr=False`` for no bias."""
    if weight_attr is not None or bias_attr not in (None, False):
        raise NotImplementedError(
            f"{layer}: the port takes weight_attr=None and bias_attr None or "
            f"False, not {weight_attr!r}, {bias_attr!r}")


class Linear(nn.Linear):
    """``paddle.nn.Linear``: ``y = x W + b`` through ``F.linear``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, generator=None):
        _check_attrs(weight_attr, bias_attr)
        super().__init__(in_features, out_features,
                         bias=bias_attr is not False)
        normal_(self.weight, math.sqrt(2.0 / (in_features + out_features)),
                generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


def embedding_table(num, dim, std, generator=None):
    """An ``nn.Embedding(num, dim)`` drawn from ``N(0, std^2)``."""
    emb = nn.Embedding(num, dim)
    normal_(emb.weight, std, generator)
    return emb
