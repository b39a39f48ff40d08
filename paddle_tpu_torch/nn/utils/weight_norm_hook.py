"""Weight normalisation — port of
``paddle_tpu/nn/utils/weight_norm_hook.py``: ``w = g * v / ||v||``.

:func:`weight_norm` replaces the layer's parameter ``name`` by two
parameters, ``name_g`` (the norms, fp32, ``v``'s shape with every axis but
``dim`` of size 1; a scalar for ``dim=None``) and ``name_v`` (the weight),
registered after the layer's other parameters as in the JAX package, and
a forward pre-hook that recomputes ``name`` from them before each forward
(in fp32, the result in ``v``'s dtype), so its gradient reaches ``g`` and
``v``. :func:`remove_weight_norm` folds them back into one parameter.
"""
from __future__ import annotations

import torch

from ...framework.tensor import Parameter

__all__ = ["weight_norm", "remove_weight_norm"]


def _norm_except_dim(v, dim):
    if dim is None:
        return torch.sqrt(torch.sum(v * v))
    axes = tuple(i for i in range(v.ndim) if i != dim)
    return torch.sqrt(torch.sum(v * v, dim=axes, keepdim=True))


def _compute_weight(g, v, dim):
    vf = v.float()
    w = g.float() * vf / torch.clamp_min(_norm_except_dim(vf, dim), 1e-12)
    return w.to(v.dtype)


class _WeightNormHook:
    def __init__(self, name, dim):
        self.name = name
        self.dim = dim

    def __call__(self, layer, inputs):
        w = _compute_weight(getattr(layer, self.name + "_g"),
                            getattr(layer, self.name + "_v"), self.dim)
        object.__setattr__(layer, self.name, w)


def weight_norm(layer, name="weight", dim=0):
    """Reparameterise ``layer.<name>`` as ``g * v / ||v||`` (the norm over
    every axis but ``dim``)."""
    if name + "_g" in layer._parameters:
        raise ValueError(f"weight_norm already applied to {name!r}")
    w = layer._parameters[name]
    with torch.no_grad():
        g = Parameter(_norm_except_dim(w.detach().float(), dim).clone())
        v = Parameter(w.detach().clone())
    del layer._parameters[name]
    layer.add_parameter(name + "_g", g)
    layer.add_parameter(name + "_v", v)
    hook = _WeightNormHook(name, dim)
    handle = layer.register_forward_pre_hook(hook)
    hooks = layer.__dict__.setdefault("_weight_norm_hooks", {})
    hooks[name] = (hook, handle)
    hook(layer, ())
    return layer


def remove_weight_norm(layer, name="weight"):
    """Fold ``name_g`` and ``name_v`` back into the parameter ``name``."""
    hooks = layer.__dict__.get("_weight_norm_hooks", {})
    if name not in hooks:
        raise ValueError(f"weight_norm was not applied to {name!r}")
    hook, handle = hooks.pop(name)
    with torch.no_grad():
        w = _compute_weight(layer._parameters[name + "_g"],
                            layer._parameters[name + "_v"], hook.dim)
    handle.remove()
    del layer._parameters[name + "_g"]
    del layer._parameters[name + "_v"]
    layer.__dict__.pop(name, None)
    layer.add_parameter(name, Parameter(w.clone()))
    return layer
