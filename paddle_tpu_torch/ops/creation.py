"""Tensor creation — port of ``paddle_tpu/ops/creation.py``. Every tensor
made here lands on the current place (``set_device``)."""
from __future__ import annotations

import numpy as np
import torch

from ..framework import dtype as dtypes
from ..framework.place import current_device
from ..framework.tensor import to_tensor, wrap
from .dispatch import op, plain


def _dt(dtype, default=None):
    d = dtypes.convert_dtype(dtype)
    if d is not None:
        return d
    return dtypes.convert_dtype(default or dtypes.get_default_dtype())


def _val(v):
    return plain(v).item() if isinstance(v, torch.Tensor) else v


def _shape_list(shape):
    if isinstance(shape, torch.Tensor):
        return [int(s) for s in plain(shape).reshape(-1).tolist()]
    if isinstance(shape, (int, np.integer)):
        return [int(shape)]
    return [int(_val(s)) for s in shape]


def _new(fn, *args, **kw):
    return wrap(fn(*args, device=current_device(), **kw))


def zeros(shape, dtype=None, name=None):
    return _new(torch.zeros, _shape_list(shape), dtype=_dt(dtype))


def ones(shape, dtype=None, name=None):
    return _new(torch.ones, _shape_list(shape), dtype=_dt(dtype))


def full(shape, fill_value, dtype=None, name=None):
    fill_value = _val(fill_value)
    if dtype is None:
        dtype = (dtypes.get_default_dtype() if isinstance(fill_value, float)
                 else "int64" if isinstance(fill_value, (int, bool))
                 else None)
    return _new(torch.full, _shape_list(shape), fill_value, dtype=_dt(dtype))


@op("zeros_like")
def _zeros_like_raw(x):
    # on the graph with a zero gradient, as the JAX op is
    return torch.where(torch.zeros_like(x, dtype=torch.bool), x,
                       torch.zeros_like(x))


def zeros_like(x, dtype=None, name=None):
    t = _zeros_like_raw(x)
    return t.astype(dtype) if dtype is not None else t


def ones_like(x, dtype=None, name=None):
    return wrap(torch.ones_like(plain(x), dtype=_dt(dtype, x.dtype)))


def full_like(x, fill_value, dtype=None, name=None):
    return wrap(torch.full_like(plain(x), _val(fill_value),
                                dtype=_dt(dtype, x.dtype)))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _val(start), _val(end), _val(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = ("int64" if all(isinstance(v, (int, np.integer))
                                for v in (start, end, step))
                 else dtypes.get_default_dtype())
    return _new(torch.arange, start, end, step, dtype=_dt(dtype))


def linspace(start, stop, num, dtype=None, name=None):
    return _new(torch.linspace, _val(start), _val(stop), int(_val(num)),
                dtype=_dt(dtype))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return _new(torch.logspace, _val(start), _val(stop), int(_val(num)),
                base=_val(base), dtype=_dt(dtype))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    return _new(torch.eye, int(num_rows),
                int(num_rows if num_columns is None else num_columns),
                dtype=_dt(dtype))


def meshgrid(*args, **kwargs):
    arrays = (args[0] if len(args) == 1 and isinstance(args[0], (list, tuple))
              else args)
    return list(wrap(torch.meshgrid(*[plain(a) for a in arrays],
                                    indexing="ij")))


@op("diag")
def _diag_raw(x, offset=0):
    return torch.diag(x, offset)


def diag(x, offset=0, padding_value=0, name=None):
    if padding_value != 0 and x.ndim == 1:
        xv = plain(x)
        n = xv.shape[0] + abs(offset)
        base = torch.full((n, n), padding_value, dtype=xv.dtype,
                          device=xv.device)
        mask = torch.diag(torch.ones_like(xv, dtype=torch.bool), offset)
        return wrap(torch.where(mask, torch.diag(xv, offset), base))
    return _diag_raw(x, offset=offset)


@op("diagflat")
def diagflat(x, offset=0):
    return torch.diagflat(x, offset)


@op("tril")
def tril(x, diagonal=0):
    return torch.tril(x, diagonal)


@op("triu")
def triu(x, diagonal=0):
    return torch.triu(x, diagonal)


def tril_indices(row, col, offset=0, dtype="int64"):
    return _new(torch.tril_indices, int(row), int(col), int(offset),
                dtype=_dt(dtype))


def triu_indices(row, col=None, offset=0, dtype="int64"):
    return _new(torch.triu_indices, int(row),
                int(row if col is None else col), int(offset),
                dtype=_dt(dtype))


@op("assign")
def _assign_raw(x):
    return x.clone()


def assign(x, output=None):
    if not isinstance(x, torch.Tensor):
        x = to_tensor(x)
    out = _assign_raw(x)
    if output is not None:
        output.set_value(out)
        return output
    return out


def clone(x, name=None):
    return assign(x)


def complex(real, imag, name=None):  # noqa: A001 - paddle API name
    return wrap(torch.complex(plain(real), plain(imag)))


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    from ..nn.layer.layers import ParamAttr, make_parameter

    attr = ParamAttr._to_attr(attr)
    if name and not attr.name:
        attr.name = name
    return make_parameter(shape, attr, _dt(dtype), is_bias,
                          default_initializer, current_device())
