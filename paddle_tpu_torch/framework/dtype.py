"""Dtypes — port of ``paddle_tpu/framework/dtype.py``.

Paddle's dtype names map to torch dtypes: ``paddle_tpu_torch.float32`` *is*
``torch.float32``, and every op takes a name (``"float32"``), a torch dtype
or a numpy dtype. ``convert_dtype`` normalizes any of them; the default
floating dtype starts at float32.

The JAX package runs with x64 off, so there int64 and float64 requests come
back int32 and float32. The port keeps Paddle's int64 and float64
(``ROADMAP.md`` C, "Declared differences").
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["LOW_PRECISION", "weak_scalar", "convert_dtype", "dtype_name",
           "is_floating", "is_complex", "is_integer", "is_differentiable",
           "set_default_dtype", "get_default_dtype", "to_numpy_dtype",
           "bfloat16", "float16", "float32", "float64", "int8", "int16",
           "int32", "int64", "uint8", "bool_", "complex64", "complex128"]

#: the dtypes multi_precision keeps fp32 master weights for
LOW_PRECISION = (torch.bfloat16, torch.float16)

bfloat16 = torch.bfloat16
float16 = torch.float16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
bool_ = torch.bool
complex64 = torch.complex64
complex128 = torch.complex128

_NAME_TO_DTYPE = {
    "bfloat16": bfloat16, "float16": float16, "float32": float32,
    "float64": float64, "int8": int8, "int16": int16, "int32": int32,
    "int64": int64, "uint8": uint8, "uint16": torch.uint16,
    "uint32": torch.uint32, "uint64": torch.uint64, "bool": bool_,
    "complex64": complex64, "complex128": complex128,
}
_DTYPE_TO_NAME = {v: k for k, v in reversed(list(_NAME_TO_DTYPE.items()))}

_FLOATING = (bfloat16, float16, float32, float64)
_COMPLEX = (complex64, complex128)

_default_dtype = float32


def convert_dtype(dtype):
    """Any dtype spec (a paddle name, a torch dtype, a numpy dtype or type)
    as a ``torch.dtype``; ``None`` stays ``None``."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        try:
            return _NAME_TO_DTYPE[dtype]
        except KeyError:
            raise ValueError(f"unknown dtype name: {dtype}") from None
    if dtype in (bool, int, float, complex):
        return {bool: bool_, int: int64, float: float64,
                complex: complex128}[dtype]
    name = np.dtype(dtype).name
    if name not in _NAME_TO_DTYPE:
        raise ValueError(f"unknown dtype: {dtype!r}")
    return _NAME_TO_DTYPE[name]


def dtype_name(dtype) -> str:
    return _DTYPE_TO_NAME[convert_dtype(dtype)]


def to_numpy_dtype(dtype):
    """The numpy dtype of a torch dtype (bfloat16 has none here: float32,
    the dtype ``Tensor.numpy()`` and ``paddle.save`` give it)."""
    dtype = convert_dtype(dtype)
    if dtype == bfloat16:
        return np.dtype("float32")
    return np.dtype(dtype_name(dtype))


def is_floating(dtype) -> bool:
    return convert_dtype(dtype) in _FLOATING


def is_complex(dtype) -> bool:
    return convert_dtype(dtype) in _COMPLEX


def is_differentiable(dtype) -> bool:
    return is_floating(dtype) or is_complex(dtype)


def is_integer(dtype) -> bool:
    d = convert_dtype(dtype)
    return not (d.is_floating_point or d.is_complex or d == bool_)


def set_default_dtype(d):
    """``paddle.set_default_dtype``: a floating dtype."""
    global _default_dtype
    d = convert_dtype(d)
    if d not in _FLOATING:
        raise TypeError(f"default dtype must be floating, got {d}")
    _default_dtype = d


def get_default_dtype():
    """The default floating dtype's name, as Paddle returns it."""
    return dtype_name(_default_dtype)


def weak_scalar(value, like):
    """The Python constant ``value`` as JAX applies a weakly typed scalar to
    an array like ``like``: unchanged against fp32, rounded to a
    low-precision dtype first (as a 0-d CPU tensor, which torch broadcasts
    as a scalar). torch itself would apply the unrounded value."""
    if like.dtype in LOW_PRECISION:
        return torch.tensor(value, dtype=like.dtype)
    return value
