"""Pooling — port of ``paddle_tpu/nn/functional/pooling.py`` (max and avg
pooling in 1-3 D, adaptive avg pooling in 1-3 D, adaptive max pooling in
2 D).

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
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from .conv import _norm_padding, _norm_tuple, pad_input, same_pads

__all__ = [
    "max_pool1d", "max_pool2d", "max_pool3d",
    "avg_pool1d", "avg_pool2d", "avg_pool3d",
    "adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_avg_pool3d",
    "adaptive_max_pool2d",
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


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    """``return_mask`` gives PyTorch's flat argmax indices (int64); the JAX
    package raises there (``ROADMAP.md`` C)."""
    return TF.adaptive_max_pool2d(x, _norm_tuple(output_size, 2),
                                  return_indices=return_mask)
