"""Pooling — port of ``paddle_tpu/nn/functional/pooling.py`` (max and avg
pooling in 1-3 D, adaptive avg and max pooling in 1-3 D, power-average
pooling in 1-2 D, and max unpooling in 1-3 D).

The JAX package pools with ``lax.reduce_window`` (no Pallas kernel), so the
port calls PyTorch's pooling ops, and follows the JAX package where the two
differ:

* ``ceil_mode`` pads on the right until the last window fits
  (``_ceil_pad``). The added windows may cover padding only: they give
  ``-inf`` for max pooling and ``0 / 0 = NaN`` for ``exclusive`` avg
  pooling, where PyTorch drops such windows (a 5 x 5 input with k2, s2, p1
  gives 4 x 4 in JAX, 3 x 3 in PyTorch).
* Padding wider than half the window, and unequal pads, are taken:
  max pooling pads with ``-inf`` through ``F.pad`` and pools unpadded
  (PyTorch refuses the former).
* ``padding`` takes the conv forms, ``"SAME"`` and ``"VALID"`` included
  (``ceil_mode`` does not apply to the strings, as in JAX).
* ``exclusive`` avg pooling divides each window's sum by its count of
  unpadded cells (PyTorch's ``count_include_pad=False``); otherwise by the
  window size. ``"VALID"`` padding always divides by the window size.
* ``return_mask`` gives each window's argmax (its first maximum) as a flat
  index into the input's spatial dims, int32, as JAX's mask.
* Adaptive windows are ``[floor(i * in / out), ceil((i + 1) * in / out))``
  in both packages.
* ``NHWC`` (``NLC``, ``NDHWC``) inputs pool on their channels-last view.
* ``adaptive_max_pool1d/2d/3d`` are the JAX op ``adaptive_max_pool_nd``;
  ``return_mask`` gives PyTorch's flat argmax indices (int64), where the
  JAX package raises.
* ``lp_pool1d/2d`` compute ``(k * avg_pool(|x|^p))^(1/p)`` from the port's
  ``abs``, ``pow`` and ``multiply`` ops, as the JAX package composes them
  (so ``amp`` casts the power to fp32).
* ``max_unpool1d/2d/3d`` scatter each value to its flat index in a zero
  output of ``(in - 1) * stride - 2 * padding + kernel`` (or the
  ``output_size``) a spatial dim.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ...ops import math as _m
from ...ops.dispatch import apply_op, op
from .conv import _norm_padding, _norm_tuple, pad_input, same_pads

__all__ = [
    "max_pool1d", "max_pool2d", "max_pool3d",
    "avg_pool1d", "avg_pool2d", "avg_pool3d",
    "adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_avg_pool3d",
    "adaptive_max_pool1d", "adaptive_max_pool2d", "adaptive_max_pool3d",
    "lp_pool1d", "lp_pool2d", "max_unpool1d", "max_unpool2d", "max_unpool3d",
]

_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG = {2: TF.avg_pool2d, 3: TF.avg_pool3d}


def _pads(padding, sizes, ks, st, ceil_mode, channel_last):
    """``([(l, r)] a spatial dim, whether padding was VALID)``, with JAX's
    ``_ceil_pad`` applied to explicit pads under ``ceil_mode``."""
    spec = _norm_padding(padding, len(sizes), channel_last)
    if spec == "VALID":
        return [(0, 0)] * len(sizes), True
    if spec == "SAME":
        return same_pads(sizes, ks, st), False
    pads = []
    for (lo, hi), size, k, s in zip(spec, sizes, ks, st):
        rem = (size + lo + hi - k) % s
        if ceil_mode and k > 1 and rem:
            hi += s - rem
        pads.append((lo, hi))
    return pads, False


def _native(pads, ks):
    """Pads PyTorch's pooling takes itself: equal, and at most half the
    window."""
    return all(lo == hi and 0 <= lo <= k // 2 for (lo, hi), k in zip(pads, ks))


def _to_input_index(idx, pads, padded, sizes):
    """Flat indices into the padded spatial dims -> into the input's."""
    flat = torch.zeros_like(idx)
    coords = []
    for p in reversed(padded):
        coords.append(idx % p)
        idx = idx // p
    for c, (lo, _), size in zip(reversed(coords), pads, sizes):
        flat = flat * size + (c - lo)
    return flat


def _max_pool(x, kernel_size, stride, padding, return_mask, ceil_mode,
              channel_last, nd):
    ks = _norm_tuple(kernel_size, nd)
    st = _norm_tuple(stride if stride is not None else kernel_size, nd)
    if channel_last:
        x = x.movedim(-1, 1)
    sizes = list(x.shape[2:])
    pads, _ = _pads(padding, sizes, ks, st, ceil_mode, channel_last)
    if _native(pads, ks):
        xp, pad_arg = x, tuple(lo for lo, _ in pads)
    else:
        xp, pad_arg = pad_input(x, pads, float("-inf")), 0
    res = _MAX[nd](xp, ks, st, pad_arg, return_indices=return_mask)
    if not return_mask:
        return res.movedim(1, -1) if channel_last else res
    out, idx = res
    if xp is not x:
        idx = _to_input_index(idx, pads, list(xp.shape[2:]), sizes)
    idx = idx.to(torch.int32)
    if channel_last:
        out, idx = out.movedim(1, -1), idx.movedim(1, -1)
    return out, idx


def _window_sum(x, ks, st, pads, nd):
    """Each window's sum over ``x`` zero-padded by ``pads``."""
    if nd == 1:
        return _window_sum(x.unsqueeze(-2), (1, *ks), (1, *st),
                           [(0, 0), *pads], 2).squeeze(-2)
    if _native(pads, ks):
        pad_arg = tuple(lo for lo, _ in pads)
    else:
        x, pad_arg = pad_input(x, pads), 0
    return _AVG[nd](x, ks, st, pad_arg, count_include_pad=True,
                    divisor_override=1)


def _avg_pool(x, kernel_size, stride, padding, exclusive, ceil_mode,
              channel_last, nd):
    ks = _norm_tuple(kernel_size, nd)
    st = _norm_tuple(stride if stride is not None else kernel_size, nd)
    if channel_last:
        x = x.movedim(-1, 1)
    pads, valid = _pads(padding, list(x.shape[2:]), ks, st, ceil_mode,
                        channel_last)
    out = _window_sum(x, ks, st, pads, nd)
    if exclusive and not valid:
        ones = torch.ones((1, 1, *x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        out = out / _window_sum(ones, ks, st, pads, nd)
    else:
        out = out / float(math.prod(ks))
    return out.movedim(1, -1) if channel_last else out


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    return _max_pool(x, kernel_size, stride, padding, return_mask, ceil_mode,
                     data_format in ("NLC", "NWC"), 1)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    return _max_pool(x, kernel_size, stride, padding, return_mask, ceil_mode,
                     data_format.endswith("C"), 2)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _max_pool(x, kernel_size, stride, padding, return_mask, ceil_mode,
                     data_format.endswith("C"), 3)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _avg_pool(x, kernel_size, stride, padding, exclusive, ceil_mode,
                     data_format in ("NLC", "NWC"), 1)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    """``divisor_override`` is accepted and ignored, as in the JAX
    package."""
    return _avg_pool(x, kernel_size, stride, padding, exclusive, ceil_mode,
                     data_format.endswith("C"), 2)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    """``divisor_override`` is accepted and ignored, as in the JAX
    package."""
    return _avg_pool(x, kernel_size, stride, padding, exclusive, ceil_mode,
                     data_format.endswith("C"), 3)


def _adaptive(fn, x, output_size, channel_last, nd):
    size = _norm_tuple(output_size, nd)
    if channel_last:
        return fn(x.movedim(-1, 1), size).movedim(1, -1)
    return fn(x, size)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(TF.adaptive_avg_pool1d, x, output_size, False, 1)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive(TF.adaptive_avg_pool2d, x, output_size,
                     data_format.endswith("C"), 2)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(TF.adaptive_avg_pool3d, x, output_size,
                     data_format.endswith("C"), 3)


_ADAPTIVE_MAX = {1: TF.adaptive_max_pool1d, 2: TF.adaptive_max_pool2d,
                 3: TF.adaptive_max_pool3d}


@op("adaptive_max_pool_nd")
def _adaptive_max_raw(x, output_size=(), return_mask=False, nd=2):
    return _ADAPTIVE_MAX[nd](x, output_size, return_indices=return_mask)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    """``return_mask`` gives PyTorch's flat argmax indices (int64); the JAX
    package raises there (``ROADMAP.md`` C)."""
    return _adaptive_max_raw(x, output_size=_norm_tuple(output_size, 1),
                             return_mask=return_mask, nd=1)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    """``return_mask`` gives PyTorch's flat argmax indices (int64); the JAX
    package raises there (``ROADMAP.md`` C)."""
    return _adaptive_max_raw(x, output_size=_norm_tuple(output_size, 2),
                             return_mask=return_mask, nd=2)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    """``return_mask`` gives PyTorch's flat argmax indices (int64); the JAX
    package raises there (``ROADMAP.md`` C)."""
    return _adaptive_max_raw(x, output_size=_norm_tuple(output_size, 3),
                             return_mask=return_mask, nd=3)


def _lp_pool(x, norm_type, pool, window):
    p = float(norm_type)
    pooled = pool(_m.pow_(_m.abs(x), p))
    return _m.pow_(_m.multiply(pooled, float(window)), 1.0 / p)


def lp_pool1d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCL", name=None):
    k = kernel_size if isinstance(kernel_size, int) else math.prod(
        kernel_size)
    return _lp_pool(x, norm_type, lambda v: avg_pool1d(
        v, kernel_size, stride, padding, exclusive=False,
        ceil_mode=ceil_mode, data_format=data_format), k)


def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCHW", name=None):
    return _lp_pool(x, norm_type, lambda v: avg_pool2d(
        v, kernel_size, stride, padding, ceil_mode=ceil_mode,
        exclusive=False, data_format=data_format),
        math.prod(_norm_tuple(kernel_size, 2)))


def _unpool(x, indices, kernel_size, stride, padding, nd, data_format,
            output_size):
    channel_last = data_format.endswith("C")
    ks = _norm_tuple(kernel_size, nd)
    st = _norm_tuple(stride if stride is not None else kernel_size, nd)
    pd = _norm_tuple(padding, nd)

    def fwd(v, idx):
        if channel_last:
            v, idx = v.movedim(-1, 1), idx.movedim(-1, 1)
        n, c = v.shape[:2]
        if output_size is not None:
            out = tuple(int(o) for o in output_size)[-nd:]
        else:
            out = tuple((v.shape[2 + d] - 1) * st[d] - 2 * pd[d] + ks[d]
                        for d in range(nd))
        flat = v.new_zeros(n, c, math.prod(out)).scatter(
            2, idx.reshape(n, c, -1).long(), v.reshape(n, c, -1))
        flat = flat.reshape(n, c, *out)
        return flat.movedim(1, -1) if channel_last else flat

    return apply_op("max_unpool%dd" % nd, fwd, (x, indices), {})


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    return _unpool(x, indices, kernel_size, stride, padding, 1,
                   "NCW" if data_format in ("NCL", "NCW") else "NWC",
                   output_size)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    return _unpool(x, indices, kernel_size, stride, padding, 2, data_format,
                   output_size)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    return _unpool(x, indices, kernel_size, stride, padding, 3, data_format,
                   output_size)
