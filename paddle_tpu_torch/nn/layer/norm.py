"""Normalization layers — port of ``paddle_tpu/nn/layer/norm.py``
(``LayerNorm``, ``BatchNorm1D/2D/3D`` and the legacy ``BatchNorm``,
``RMSNorm``, ``GroupNorm``, ``InstanceNorm1D/2D/3D``,
``LocalResponseNorm`` and ``SpectralNorm``).

The batch norms keep their running statistics as buffers named ``_mean``
(zeros) and ``_variance`` (ones), the names of the JAX model's
``state_dict``. gamma starts at 1 and beta at 0, each drawn by its
``weight_attr`` / ``bias_attr`` (a :class:`~.layers.ParamAttr`, an
initializer or a name) when one is given; ``False`` leaves it out (an
instance norm loses both, as in the JAX package, and keeps them as
``scale`` and ``bias``). ``RMSNorm`` computes ``x * rsqrt(mean(x^2) + eps) *
weight`` in the input's dtype (the JAX op ``rms_norm``, fp32 under
``auto_cast``). ``SpectralNorm`` holds ``weight_u`` and ``weight_v`` drawn
from ``N(0, 1)`` as parameters that take no gradient, as the JAX layer does.
The class names are the JAX package's, which ``amp.decorate`` reads to keep
norm layers fp32.
"""
from __future__ import annotations

import math

import torch

from .. import functional as F
from ...ops.dispatch import apply_op
from ..initializer import Constant, Normal
from .layers import Layer

__all__ = ["LayerNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "RMSNorm", "GroupNorm", "InstanceNorm1D",
           "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm",
           "SpectralNorm"]


class LayerNorm(Layer):
    """LayerNorm over the trailing ``normalized_shape`` axes through the
    :func:`~paddle_tpu_torch.nn.functional.layer_norm` router. gamma starts
    at 1 and beta at 0, as in the JAX package; ``weight_attr=False`` /
    ``bias_attr=False`` leave it without gamma / beta."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            self._normalized_shape, weight_attr, dtype,
            default_initializer=Constant(1.0))
        self.bias = self.create_parameter(self._normalized_shape, bias_attr,
                                          dtype, is_bias=True)
        if device is not None:
            for name in ("weight", "bias"):
                p = getattr(self, name)
                if p is not None:
                    p.data = p.data.to(device)

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
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            [num_features], weight_attr, default_initializer=Constant(1.0))
        self.bias = self.create_parameter([num_features], bias_attr,
                                          is_bias=True)
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


class RMSNorm(Layer):
    """``x * rsqrt(mean(x^2, -1) + epsilon) * weight``, weight starting at
    1."""

    def __init__(self, normalized_shape, epsilon=1e-6, weight_attr=None,
                 name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            self._normalized_shape, weight_attr,
            default_initializer=Constant(1.0))

    def forward(self, x):
        eps = self._epsilon

        def rms(v, w):
            return v * torch.rsqrt(v.square().mean(-1, keepdim=True)
                                   + eps) * w

        return apply_op("rms_norm", rms, (x, self.weight), {})


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups = num_groups
        self._num_channels = num_channels
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_channels], weight_attr, default_initializer=Constant(1.0))
        self.bias = self.create_parameter([num_channels], bias_attr,
                                          is_bias=True)

    def forward(self, input):
        return F.group_norm(input, self._num_groups, self._epsilon,
                            self.weight, self.bias, self._data_format)

    def extra_repr(self):
        return (f"num_groups={self._num_groups}, num_channels="
                f"{self._num_channels}, epsilon={self._epsilon}")


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        if weight_attr is False or bias_attr is False:
            self.scale = self.bias = None
        else:
            self.scale = self.create_parameter(
                [num_features], weight_attr,
                default_initializer=Constant(1.0))
            self.bias = self.create_parameter([num_features], bias_attr,
                                              is_bias=True)

    def forward(self, input):
        return F.instance_norm(input, weight=self.scale, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=0.0001, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self.data_format = data_format

    def forward(self, input):
        return F.local_response_norm(input, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


class SpectralNorm(Layer):
    """The weight it is given over its largest singular value
    (``F.spectral_norm`` from ``weight_u`` ``[shape[dim]]`` and
    ``weight_v`` ``[numel / shape[dim]]``)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 dtype="float32"):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._epsilon = epsilon
        h = weight_shape[dim]
        w = math.prod(weight_shape) // h
        self.weight_u = self.create_parameter(
            [h], dtype=dtype, default_initializer=Normal(0.0, 1.0))
        self.weight_u.stop_gradient = True
        self.weight_v = self.create_parameter(
            [w], dtype=dtype, default_initializer=Normal(0.0, 1.0))
        self.weight_v.stop_gradient = True

    def forward(self, x):
        return F.spectral_norm(x, self.weight_u, self.weight_v, self._dim,
                               self._power_iters, self._epsilon)
