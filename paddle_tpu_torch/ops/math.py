"""Elementwise and reduction math — port of ``paddle_tpu/ops/math.py``.

Each op is the JAX op's formula in torch, registered under the JAX op's
name (which ``amp.auto_cast`` reads). A Python scalar operand takes the
other operand's dtype, as the JAX package casts it (``dispatch.scalar_like``).
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..framework import dtype as dtypes
from ..framework.tensor import check_inplace, wrap
from .dispatch import apply_nondiff_op, op, plain, scalar_like

# ---------------------------------------------------------------- binary ----


def operand(v, like):
    """``v`` beside the tensor ``like``: a scalar in ``like``'s dtype, an
    array on ``like``'s device, a tensor as it is."""
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, (bool, int, float, np.number)):
        return scalar_like(v.item() if isinstance(v, np.number) else v,
                          like)
    return torch.as_tensor(np.asarray(v), device=like.device)


def _binop(name, fn):
    raw = op(name)(fn)

    def api(x, y, name=None):
        if not isinstance(x, torch.Tensor):
            x = operand(x, y)
        else:
            y = operand(y, x)
        return raw(x, y)

    api.__name__ = name
    api.raw = fn
    api.op_name = raw.op_name
    return api


add = _binop("add", torch.add)
subtract = _binop("subtract", torch.sub)
multiply = _binop("multiply", torch.mul)
divide = _binop("divide", torch.true_divide)
floor_divide = _binop("floor_divide", torch.floor_divide)
remainder = _binop("remainder", torch.remainder)
mod = remainder
floor_mod = remainder
pow_ = _binop("elementwise_pow", torch.pow)
maximum = _binop("maximum", torch.maximum)
minimum = _binop("minimum", torch.minimum)
fmax = _binop("fmax", torch.fmax)
fmin = _binop("fmin", torch.fmin)
atan2 = _binop("atan2", torch.atan2)
hypot = _binop("hypot", torch.hypot)
logaddexp = _binop("logaddexp", torch.logaddexp)
nextafter = _binop("nextafter", torch.nextafter)
copysign = _binop("copysign", torch.copysign)
heaviside = _binop("heaviside", torch.heaviside)
gcd = _binop("gcd", torch.gcd)
lcm = _binop("lcm", torch.lcm)


def pow(x, y, name=None):  # noqa: A001 - paddle API name
    return pow_(x, y)


def divide_no_nan(x, y):
    xv, yv = plain(x), plain(y)
    return wrap(torch.where(yv == 0, torch.zeros_like(xv), xv / yv))


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    s = plain(scale).item() if isinstance(scale, torch.Tensor) else scale

    @op("scale")
    def _scale(xv):
        sv = scalar_like(s, xv)
        bv = scalar_like(bias, xv)
        if bias_after_scale:
            return xv * sv + bv
        return (xv + bv) * sv

    out = _scale(x)
    if act is not None:
        from ..nn import functional as F

        out = getattr(F, act)(out)
    return out


# --------------------------------------------------------------- unary ------


def _unop(name, fn):
    return op(name)(fn)


def _via_fp32(fn):
    """``fn`` of a low-precision input through fp32 (torch has no bf16 or
    fp16 gradient of it), the result back in the input's dtype."""
    def f(x):
        if x.dtype in dtypes.LOW_PRECISION:
            return fn(x.float()).to(x.dtype)
        return fn(x)

    return f


def _imag(x):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


exp = _unop("exp", torch.exp)
expm1 = _unop("expm1", torch.expm1)
log = _unop("log", torch.log)
log2 = _unop("log2", torch.log2)
log10 = _unop("log10", torch.log10)
log1p = _unop("log1p", torch.log1p)
sqrt = _unop("sqrt", torch.sqrt)
rsqrt = _unop("rsqrt", torch.rsqrt)
square = _unop("square", torch.square)
abs = _unop("abs", torch.abs)  # noqa: A001
sign = _unop("sign", torch.sign)
ceil = _unop("ceil", torch.ceil)
floor = _unop("floor", torch.floor)
round = _unop("round", torch.round)  # noqa: A001
trunc = _unop("trunc", torch.trunc)
frac = _unop("frac", lambda x: x - torch.trunc(x))
sin = _unop("sin", torch.sin)
cos = _unop("cos", torch.cos)
tan = _unop("tan", torch.tan)
asin = _unop("asin", torch.asin)
acos = _unop("acos", torch.acos)
atan = _unop("atan", torch.atan)
sinh = _unop("sinh", torch.sinh)
cosh = _unop("cosh", torch.cosh)
tanh = _unop("tanh", torch.tanh)
asinh = _unop("asinh", torch.asinh)
acosh = _unop("acosh", torch.acosh)
atanh = _unop("atanh", torch.atanh)
reciprocal = _unop("reciprocal", torch.reciprocal)
neg = _unop("neg", torch.neg)
erf = _unop("erf", torch.special.erf)
erfinv = _unop("erfinv", torch.special.erfinv)
lgamma = _unop("lgamma", torch.lgamma)
digamma = _unop("digamma", torch.special.digamma)
i0 = _unop("i0", torch.special.i0)
i0e = _unop("i0e", torch.special.i0e)
i1 = _unop("i1", _via_fp32(torch.special.i1))
i1e = _unop("i1e", _via_fp32(torch.special.i1e))
angle = _unop("angle", _via_fp32(torch.angle))
conj = _unop("conj", torch.conj_physical)
real = _unop("real", torch.real)
imag = _unop("imag", _imag)
deg2rad = _unop("deg2rad", torch.deg2rad)
rad2deg = _unop("rad2deg", torch.rad2deg)


def isnan(x, name=None):
    return apply_nondiff_op("isnan", torch.isnan, (x,))


def isinf(x, name=None):
    return apply_nondiff_op("isinf", torch.isinf, (x,))


def isfinite(x, name=None):
    return apply_nondiff_op("isfinite", torch.isfinite, (x,))


@op("nan_to_num")
def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


@op("clip")
def _clip_raw(x, min=None, max=None):
    return torch.clamp(x, min, max)


def clip(x, min=None, max=None, name=None):
    mn = min.item() if isinstance(min, torch.Tensor) else min
    mx = max.item() if isinstance(max, torch.Tensor) else max
    return _clip_raw(x, min=mn, max=mx)


@op("lerp")
def lerp(x, y, weight):
    return x + weight * (y - x)


@op("logit")
def logit(x, eps=None):
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


@op("stanh")
def stanh(x, scale_a=0.67, scale_b=1.7159):
    # the constants in x's dtype first, as JAX applies weak scalars
    return (dtypes.weak_scalar(scale_b, x)
            * torch.tanh(dtypes.weak_scalar(scale_a, x) * x))


@op("multiplex")
def _multiplex_raw(*args):
    index = args[-1]
    ins = torch.stack(args[:-1], dim=0)
    idx = index.reshape(1, -1, *([1] * (ins.ndim - 2))).long()
    return torch.take_along_dim(ins, idx, dim=0)[0]


def multiplex(inputs, index, name=None):
    return _multiplex_raw(*inputs, index)


# ------------------------------------------------------------ reductions ----


def _axis(axis):
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        a = plain(axis).tolist()
        return tuple(a) if isinstance(a, list) else int(a)
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def dims(axis, ndim):
    """A reduction's dims: every axis for None (and for a 0-d input)."""
    if axis is None:
        return tuple(range(ndim))
    return axis if isinstance(axis, tuple) else (axis,)


def reduce(fn, x, axis, keepdim, **kw):
    """``fn(x, dim=..., keepdim=...)`` over ``axis`` (None: all), also for a
    0-d ``x``."""
    if x.ndim == 0:
        return fn(x.reshape(1), dim=0, keepdim=False, **kw)
    return fn(x, dim=dims(axis, x.ndim), keepdim=keepdim, **kw)


@op("sum")
def _sum_raw(x, axis=None, keepdim=False, out_dtype=None):
    return reduce(torch.sum, x, axis, keepdim, dtype=out_dtype)


def sum(x, axis=None, dtype=None, keepdim=False, name=None):  # noqa: A001
    out_dtype = dtypes.convert_dtype(dtype)
    if out_dtype is None and x.dtype == torch.bool:
        out_dtype = torch.int64
    if (out_dtype is None and dtypes.is_integer(x.dtype)
            and x.dtype != torch.int64):
        out_dtype = torch.int64
    return _sum_raw(x, axis=_axis(axis), keepdim=keepdim, out_dtype=out_dtype)


@op("mean")
def _mean_raw(x, axis=None, keepdim=False):
    if not (x.is_floating_point() or x.is_complex()):
        x = x.to(dtypes.convert_dtype(dtypes.get_default_dtype()))
    return reduce(torch.mean, x, axis, keepdim)


def mean(x, axis=None, keepdim=False, name=None):
    return _mean_raw(x, axis=_axis(axis), keepdim=keepdim)


@op("max")
def _max_raw(x, axis=None, keepdim=False):
    return reduce(torch.amax, x, axis, keepdim)


def max(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return _max_raw(x, axis=_axis(axis), keepdim=keepdim)


@op("min")
def _min_raw(x, axis=None, keepdim=False):
    return reduce(torch.amin, x, axis, keepdim)


def min(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return _min_raw(x, axis=_axis(axis), keepdim=keepdim)


@op("amax")
def _amax_raw(x, axis=None, keepdim=False):
    return reduce(torch.amax, x, axis, keepdim)


def amax(x, axis=None, keepdim=False, name=None):
    return _amax_raw(x, axis=_axis(axis), keepdim=keepdim)


def amin(x, axis=None, keepdim=False, name=None):
    return _min_raw(x, axis=_axis(axis), keepdim=keepdim)


def _prod_dims(x, dim, keepdim):
    for d in sorted((d % x.ndim for d in dim), reverse=True):
        x = torch.prod(x, dim=d, keepdim=True)
    if not keepdim:
        x = x.squeeze(dim) if dim else x
    return x


@op("prod")
def _prod_raw(x, axis=None, keepdim=False):
    if x.ndim == 0:
        return x.clone()
    return _prod_dims(x, dims(axis, x.ndim), keepdim)


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    out = _prod_raw(x, axis=_axis(axis), keepdim=keepdim)
    return out.astype(dtype) if dtype is not None else out


@op("logsumexp")
def _logsumexp_raw(x, axis=None, keepdim=False):
    return reduce(torch.logsumexp, x, axis, keepdim)


def logsumexp(x, axis=None, keepdim=False, name=None):
    return _logsumexp_raw(x, axis=_axis(axis), keepdim=keepdim)


def all(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return apply_nondiff_op("all", lambda v: reduce(
        torch.all, v.bool(), _axis(axis), keepdim), (x,))


def any(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return apply_nondiff_op("any", lambda v: reduce(
        torch.any, v.bool(), _axis(axis), keepdim), (x,))


def _count_nonzero(v, axis, keepdim):
    d = dims(axis, v.ndim)
    out = torch.count_nonzero(v, dim=d) if v.ndim else (v != 0).long()
    if keepdim and v.ndim:
        for a in sorted(a % v.ndim for a in d):
            out = out.unsqueeze(a)
    return out.long()


def count_nonzero(x, axis=None, keepdim=False, name=None):
    return apply_nondiff_op("count_nonzero", _count_nonzero, (x,),
                            {"axis": _axis(axis), "keepdim": keepdim})


@op("cumsum")
def _cumsum_raw(x, axis=None):
    dt = x.dtype if x.dtype != torch.bool else torch.int64
    if axis is None:
        return torch.cumsum(x.reshape(-1), 0, dtype=dt)
    return torch.cumsum(x, axis, dtype=dt)


def cumsum(x, axis=None, dtype=None, name=None):
    out = _cumsum_raw(x, axis=axis if axis is None else int(axis))
    return out.astype(dtype) if dtype is not None else out


@op("cumprod")
def _cumprod_raw(x, dim=None):
    if dim is None:
        return torch.cumprod(x.reshape(-1), 0)
    return torch.cumprod(x, dim)


def cumprod(x, dim=None, dtype=None, name=None):
    out = _cumprod_raw(x, dim=dim)
    return out.astype(dtype) if dtype is not None else out


def _cum_index(xv, v, axis):
    """The JAX package's index of a running max/min: the last position
    holding the running value."""
    ar = torch.arange(xv.shape[axis], device=xv.device).reshape(
        [-1 if i == axis % xv.ndim else 1 for i in range(xv.ndim)])
    idx = torch.where(xv == v, ar, torch.full_like(ar, -1))
    return torch.cummax(idx.expand(xv.shape), axis).values


@op("cummax_val")
def _cummax_raw(x, axis=0):
    return torch.cummax(x, axis).values


def cummax(x, axis=None, dtype="int64", name=None):
    if axis is None:
        x = x.reshape([-1])
        axis = 0
    v = _cummax_raw(x, axis=axis)
    idx = _cum_index(plain(x), plain(v), axis)
    return v, wrap(idx.to(dtypes.convert_dtype(dtype)))


@op("cummin_val")
def _cummin_raw(x, axis=None):
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    return torch.cummin(x, axis).values


def cummin(x, axis=None, dtype="int64", name=None):
    v = _cummin_raw(x, axis=axis)
    ax = 0 if axis is None else axis
    xv = plain(x).reshape(-1) if axis is None else plain(x)
    idx = _cum_index(xv, plain(v), ax)
    return v, wrap(idx.to(dtypes.convert_dtype(dtype)))


# ------------------------------------------------------------- matmul -------


def _promoted(a, b):
    if a.dtype == b.dtype:
        return a, b
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


@op("matmul")
def _matmul_raw(x, y, transpose_x=False, transpose_y=False):
    if transpose_x and x.ndim >= 2:
        x = x.transpose(-1, -2)
    if transpose_y and y.ndim >= 2:
        y = y.transpose(-1, -2)
    return torch.matmul(*_promoted(x, y))


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    return _matmul_raw(x, y, transpose_x=transpose_x, transpose_y=transpose_y)


mm = matmul


@op("dot")
def dot(x, y):
    return torch.sum(x * y, dim=-1)


@op("inner")
def inner(x, y):
    return torch.inner(x, y)


@op("outer")
def outer(x, y):
    return torch.outer(x.reshape(-1), y.reshape(-1))


@op("kron")
def kron(x, y):
    return torch.kron(x, y)


@op("addmm")
def addmm(input, x, y, beta=1.0, alpha=1.0):
    return beta * input + alpha * (x @ y)


@op("bmm")
def bmm(x, y):
    return torch.matmul(x, y)


@op("mv")
def mv(x, vec):
    return torch.matmul(x, vec)


@op("trace")
def _trace_raw(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return _trace_raw(x, offset=offset, axis1=axis1, axis2=axis2)


@op("diagonal")
def _diagonal_raw(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return _diagonal_raw(x, offset=offset, axis1=axis1, axis2=axis2)


# ------------------------------------------------------------ logic-ish -----


def _cmp(opname, fn):
    """Comparisons: never a gradient (the reference registers no grad op)."""

    def api(x, y, name=None):
        if not isinstance(x, torch.Tensor):
            x = operand(x, y)
        y = operand(y, x)
        return apply_nondiff_op(opname, fn, (x, y))

    api.__name__ = opname
    api.op_name = opname
    return api


equal = _cmp("equal", torch.eq)
not_equal = _cmp("not_equal", torch.ne)
greater_than = _cmp("greater_than", torch.gt)
greater_equal = _cmp("greater_equal", torch.ge)
less_than = _cmp("less_than", torch.lt)
less_equal = _cmp("less_equal", torch.le)


def equal_all(x, y, name=None):
    return apply_nondiff_op(
        "equal_all", lambda a, b: torch.tensor(
            builtins.bool(a.shape == b.shape and torch.equal(a, b)),
            device=a.device), (x, y))


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply_nondiff_op(
        "allclose", lambda a, b: torch.tensor(torch.allclose(
            a, b, rtol=rtol, atol=atol, equal_nan=equal_nan),
            device=a.device), (x, y))


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply_nondiff_op(
        "isclose", torch.isclose, (x, y),
        {"rtol": rtol, "atol": atol, "equal_nan": equal_nan})


@op("cross")
def _cross_raw(x, y, axis=0):
    return torch.linalg.cross(*_promoted(x, y), dim=axis)


def cross(x, y, axis=None, name=None):
    """Cross product along ``axis`` (default: the first dim of length 3)."""
    if axis is None:
        axis = next((i for i, s in enumerate(x.shape) if s == 3), None)
        if axis is None:
            raise ValueError("cross: no dimension of length 3 found")
    return _cross_raw(x, operand(y, x), axis=int(axis))


@op("diff")
def _diff_raw(x, prepend=None, append=None, n=1, axis=-1):
    return torch.diff(x, n=n, dim=axis, prepend=prepend, append=append)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    return _diff_raw(x, prepend, append, n=int(n), axis=int(axis))


@op("logcumsumexp")
def _logcumsumexp_raw(x, axis=None):
    # a low-precision scan accumulates its rounding: run it in fp32
    if axis is None:
        x, axis = x.reshape(-1), 0
    return _via_fp32(lambda v: torch.logcumsumexp(v, axis))(x)


def logcumsumexp(x, axis=None, dtype=None, name=None):
    out = _logcumsumexp_raw(x, axis=None if axis is None else int(axis))
    return out.astype(dtype) if dtype is not None else out


@op("renorm")
def _renorm_raw(x, p=2.0, axis=0, max_norm=1.0):
    ax = axis % x.ndim
    red = tuple(i for i in range(x.ndim) if i != ax)
    norms = torch.sum(torch.abs(x) ** p, dim=red, keepdim=True) ** (1.0 / p)
    scale = torch.where(norms > max_norm,
                        max_norm / torch.clamp(norms, min=1e-12),
                        torch.ones_like(norms))
    return x * scale


def renorm(x, p, axis, max_norm, name=None):
    """Per-slice p-norm clamp along ``axis``."""
    return _renorm_raw(x, p=float(p), axis=int(axis),
                       max_norm=float(max_norm))


@op("tensordot")
def _tensordot_raw(x, y, axes=2):
    return torch.tensordot(*_promoted(x, y), dims=axes)


def tensordot(x, y, axes=2, name=None):
    """Paddle's axes: an int n is the last n of x against the first n of y;
    a flat list applies to both tensors; ``[a_axes, b_axes]`` pairs them."""
    if isinstance(axes, torch.Tensor):
        axes = plain(axes).tolist()
    if isinstance(axes, (list, tuple)):
        seq = list(axes)
        if not builtins.any(isinstance(a, (list, tuple, np.ndarray,
                                           torch.Tensor)) for a in seq):
            t = [int(i) for i in seq]
            axes = (t, t)
        else:
            subs = [[int(i) for i in np.atleast_1d(
                plain(a).tolist() if isinstance(a, torch.Tensor) else a)]
                for a in seq]
            axes = ((subs[0], subs[0]) if len(subs) == 1
                    else (subs[0], subs[1]))
    else:
        axes = int(axes)
    return _tensordot_raw(x, operand(y, x), axes=axes)


def tanh_(x, name=None):
    check_inplace(x)
    torch._C.TensorBase.copy_(x, plain(tanh(x)))
    return x


def is_complex(x):
    return x.dtype.is_complex


def is_floating_point(x):
    return x.dtype.is_floating_point


def is_integer(x):
    return dtypes.is_integer(x.dtype)

