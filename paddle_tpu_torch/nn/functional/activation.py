"""Activation functionals — port of ``paddle_tpu/nn/functional/activation.py``
(``gelu`` and ``softmax``), in plain PyTorch, each behind the ``amp``
hook of its JAX op name (``gelu``, ``softmax_op``).
"""
from __future__ import annotations

import torch

from ...amp.auto_cast import cast_inputs as _amp_cast

__all__ = ["gelu", "softmax"]


def gelu(x, approximate=False):
    """GELU; ``approximate=True`` is the tanh form, as ``jax.nn.gelu``."""
    (x,) = _amp_cast("gelu", x)
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def softmax(x, axis=-1, dtype=None):
    if dtype is not None:
        x = x.to(dtype)
    (x,) = _amp_cast("softmax_op", x)
    return torch.softmax(x, dim=int(axis))
