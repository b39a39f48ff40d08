"""Normalization layers — port of ``paddle_tpu/nn/layer/norm.py``
(``LayerNorm``, ``BatchNorm1D/2D/3D`` and the legacy ``BatchNorm``).

The batch norms keep their running statistics as buffers named ``_mean``
(zeros) and ``_variance`` (ones), the names of the JAX model's
``state_dict``; gamma starts at 1 and beta at 0. The class names are the JAX
package's, which ``amp.decorate`` reads to keep norm layers fp32.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import functional as F
from .common import _check_attrs
from .layers import Layer

__all__ = ["LayerNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D"]


class LayerNorm(Layer):
    """LayerNorm over the trailing ``normalized_shape`` axes through the
    :func:`~paddle_tpu_torch.nn.functional.layer_norm` router. gamma starts
    at 1 and beta at 0, as in the JAX package; ``weight_attr=False`` /
    ``bias_attr=False`` leave it without gamma / beta."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None):
        super().__init__()
        _check_attrs(None if weight_attr is False else weight_attr,
                     bias_attr, type(self).__name__)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = (None if weight_attr is False else nn.Parameter(
            torch.ones(self._normalized_shape, device=device, dtype=dtype)))
        self.bias = (None if bias_attr is False else nn.Parameter(
            torch.zeros(self._normalized_shape, device=device, dtype=dtype)))

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return (f"normalized_shape={self._normalized_shape}, "
                f"epsilon={self._epsilon}")


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        _check_attrs(weight_attr, bias_attr, type(self).__name__)
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = (None if bias_attr is False
                     else nn.Parameter(torch.zeros(num_features)))
        self.register_buffer("_mean", torch.zeros(num_features))
        self.register_buffer("_variance", torch.ones(num_features))

    def forward(self, input):
        return F.batch_norm(input, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, momentum="
                f"{self._momentum}, epsilon={self._epsilon}")


class BatchNorm(_BatchNormBase):
    """The legacy ``BatchNorm(num_channels)``, with ``act`` (a functional's
    name) after the norm."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", in_place=False, moving_mean_name=None,
                 moving_variance_name=None,
                 do_model_average_for_mean_and_var=True,
                 use_global_stats=False, trainable_statistics=False):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats or None)
        self._act = act

    def forward(self, input):
        out = super().forward(input)
        return getattr(F, self._act)(out) if self._act else out


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats)
