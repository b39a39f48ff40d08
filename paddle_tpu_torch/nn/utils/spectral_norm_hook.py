"""Spectral normalisation — port of
``paddle_tpu/nn/utils/spectral_norm_hook.py``: ``w = w_orig / sigma``.

:func:`spectral_norm` moves the layer's parameter ``name`` to
``name_orig`` and registers the power iteration's ``name_u`` (fp32, from
``RandomState(0)`` normalised, as in the JAX package) as a buffer; a forward
pre-hook runs ``n_power_iterations`` power iterations from it before each
forward (in fp32), writes the new ``u`` back and sets ``name`` to
``w_orig / sigma`` (``sigma = u . W v``), which the forward differentiates
through the iterations. ``dim`` defaults to 1 for ``Linear`` (its weight
is ``[in, out]``) and 0 otherwise.
"""
from __future__ import annotations

import numpy as np
import torch

from ...framework.tensor import Parameter

__all__ = ["spectral_norm"]


class _SpectralNormHook:
    def __init__(self, name, n_power_iterations, eps, dim):
        self.name = name
        self.n = n_power_iterations
        self.eps = eps
        self.dim = dim

    def __call__(self, layer, inputs):
        w = getattr(layer, self.name + "_orig")
        u_buf = getattr(layer, self.name + "_u")
        wm = w.float().movedim(self.dim, 0)
        wm = wm.reshape(wm.shape[0], -1)
        u = u_buf.detach().float().clone()
        for _ in range(max(self.n, 1)):
            v = wm.t() @ u
            v = v / torch.clamp_min(torch.linalg.vector_norm(v), self.eps)
            u = wm @ v
            u = u / torch.clamp_min(torch.linalg.vector_norm(u), self.eps)
        sigma = u @ wm @ v
        object.__setattr__(layer, self.name,
                           (w.float() / sigma).to(w.dtype))
        with torch.no_grad():
            u_buf.copy_(u.detach())


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    """Reparameterise ``layer.<name>`` as its spectral normalisation."""
    if name + "_orig" in layer._parameters:
        raise ValueError(f"spectral_norm already applied to {name!r}")
    w = layer._parameters[name]
    if dim is None:
        dim = 1 if type(layer).__name__ == "Linear" else 0
    u0 = np.random.RandomState(0).randn(w.shape[dim]).astype(np.float32)
    u0 /= max(np.linalg.norm(u0), eps)
    with torch.no_grad():
        orig = Parameter(w.detach().clone())
    del layer._parameters[name]
    layer.add_parameter(name + "_orig", orig)
    layer.register_buffer(name + "_u", torch.from_numpy(u0).to(w.device))
    hook = _SpectralNormHook(name, n_power_iterations, eps, dim)
    handle = layer.register_forward_pre_hook(hook)
    hooks = layer.__dict__.setdefault("_spectral_norm_hooks", {})
    hooks[name] = (hook, handle)
    hook(layer, ())
    return layer
