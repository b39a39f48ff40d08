"""Activation functionals — port of ``paddle_tpu/nn/functional/activation.py``
(``gelu``, ``relu`` and ``softmax``), in plain PyTorch, each behind the
``amp`` hook of its JAX op name (``gelu``, ``relu``, ``softmax_op``).
"""
from __future__ import annotations

import torch

from ...amp.auto_cast import cast_inputs as _amp_cast
from ...framework.dtype import convert_dtype

__all__ = ["gelu", "relu", "softmax"]


def gelu(x, approximate=False, name=None):
    """GELU; ``approximate=True`` is the tanh form, as ``jax.nn.gelu``."""
    (x,) = _amp_cast("gelu", x)
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def relu(x, name=None):
    (x,) = _amp_cast("relu", x)
    return torch.relu(x)


def softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(convert_dtype(dtype))
    (x,) = _amp_cast("softmax_op", x)
    return torch.softmax(x, dim=int(axis))
