"""Statistics — port of ``paddle_tpu/ops/stat.py``. ``median`` is JAX's
(the mean of the two middle values of an even count), not torch's lower
middle."""
from __future__ import annotations

import torch

from ..framework.tensor import wrap
from .dispatch import op, plain
from .math import _axis, dims, reduce


@op("var_op")
def _var_raw(x, axis=None, unbiased=True, keepdim=False):
    return reduce(torch.var, x, axis, keepdim, correction=int(unbiased))


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _var_raw(x, axis=_axis(axis), unbiased=unbiased, keepdim=keepdim)


@op("std_op")
def _std_raw(x, axis=None, unbiased=True, keepdim=False):
    return reduce(torch.std, x, axis, keepdim, correction=int(unbiased))


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _std_raw(x, axis=_axis(axis), unbiased=unbiased, keepdim=keepdim)


def _quantile(fn, x, q, axis, keepdim, interpolation="linear"):
    """``fn`` (torch.quantile or nanquantile) over ``axis`` (None: all;
    several axes are moved last and flattened first, as numpy does)."""
    if x.dtype not in (torch.float32, torch.float64):
        # torch's quantile takes fp32/fp64 only: low precision goes
        # through fp32 and back
        return _quantile(fn, x.float(), q, axis, keepdim,
                         interpolation).to(x.dtype)
    if isinstance(q, (list, tuple)):
        q = torch.tensor(q, dtype=x.dtype, device=x.device)
    if axis is None or (isinstance(axis, tuple) and len(axis) > 1):
        d = dims(axis, x.ndim)
        rest = [i for i in range(x.ndim) if i not in [a % x.ndim for a in d]]
        y = x.permute(rest + [a % x.ndim for a in d]).reshape(
            *[x.shape[i] for i in rest], -1)
        out = fn(y, q, dim=-1, keepdim=False, interpolation=interpolation)
        if keepdim:
            red = [a % x.ndim for a in d]
            kshape = [1 if i in red else x.shape[i] for i in range(x.ndim)]
            out = out.reshape(*out.shape[:out.ndim - len(rest)], *kshape)
        return out
    axis = axis[0] if isinstance(axis, tuple) else axis
    return fn(x, q, dim=axis, keepdim=keepdim, interpolation=interpolation)


@op("median_op")
def _median_raw(x, axis=None, keepdim=False):
    return _quantile(torch.quantile, x, 0.5, axis, keepdim)


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    return _median_raw(x, axis=_axis(axis), keepdim=keepdim)


def nanmedian(x, axis=None, keepdim=False, name=None):
    return wrap(_quantile(torch.nanquantile, plain(x), 0.5, _axis(axis),
                          keepdim))


@op("quantile_op")
def _quantile_raw(x, q=0.5, axis=None, keepdim=False,
                  interpolation="linear"):
    return _quantile(torch.quantile, x, q, axis, keepdim, interpolation)


def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    if isinstance(q, torch.Tensor):
        q = plain(q)
    return _quantile_raw(x, q=q, axis=_axis(axis), keepdim=keepdim,
                         interpolation=interpolation)


def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear",
                name=None):
    if isinstance(q, torch.Tensor):
        q = plain(q)
    return wrap(_quantile(torch.nanquantile, plain(x), q, _axis(axis),
                          keepdim, interpolation))


@op("nansum")
def _nansum_raw(x, axis=None, keepdim=False):
    return reduce(torch.nansum, x, axis, keepdim)


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    out = _nansum_raw(x, axis=_axis(axis), keepdim=keepdim)
    return out.astype(dtype) if dtype is not None else out


@op("nanmean")
def _nanmean_raw(x, axis=None, keepdim=False):
    return reduce(torch.nanmean, x, axis, keepdim)


def nanmean(x, axis=None, keepdim=False, name=None):
    return _nanmean_raw(x, axis=_axis(axis), keepdim=keepdim)
