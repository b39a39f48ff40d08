"""dtype helpers shared by the port's optimizer, clipping and amp code."""
from __future__ import annotations

import torch

__all__ = ["LOW_PRECISION", "weak_scalar"]

#: the dtypes multi_precision keeps fp32 master weights for
LOW_PRECISION = (torch.bfloat16, torch.float16)


def weak_scalar(value, like):
    """The Python constant ``value`` as JAX applies a weakly typed scalar to
    an array like ``like``: unchanged against fp32, rounded to a
    low-precision dtype first (as a 0-d CPU tensor, which torch broadcasts
    as a scalar). torch itself would apply the unrounded value."""
    if like.dtype in LOW_PRECISION:
        return torch.tensor(value, dtype=like.dtype)
    return value
