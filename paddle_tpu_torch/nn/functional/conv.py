"""Convolutions — port of ``paddle_tpu/nn/functional/conv.py`` (``conv1d``,
``conv2d``, ``conv3d``).

The JAX package lowers every convolution to one ``lax.conv_general_dilated``
(no Pallas kernel), so the port calls PyTorch's convolutions: cuDNN on the
card. The weight is ``[out, in/groups, *k]`` (OIHW) in both packages.

* Padding takes every form of the JAX package's ``_norm_padding``: an int,
  one int a spatial dim, ``2n`` ints ``[l0, r0, l1, r1, ...]``, nested
  ``[[l, r], ...]`` (with or without the batch and channel pairs), and the
  strings ``"SAME"`` / ``"VALID"``. (JAX reads a 2-D nested form with the
  batch and channel pairs as ``2n`` ints and raises; the port takes it.) ``"SAME"`` pads as XLA does: the output
  is ``ceil(in / stride)`` and an odd total puts the extra cell on the
  right (PyTorch's ``padding="same"`` refuses stride > 1). Unequal pads go
  through ``F.pad`` before the convolution.
* ``data_format`` ``NHWC`` (``NLC``, ``NDHWC``) is a channels-last view of
  the logical NCHW tensor: the channel axis moves to 1, the convolution
  runs on that view (cuDNN's NHWC kernels), and it moves back.
* Under layout autotune (``framework/layout_autotune.py``) an NCHW / NCDHW
  convolution runs on the input and weight in ``channels_last`` /
  ``channels_last_3d`` memory format; its output comes back in that format,
  with the logical shape unchanged.
* The inputs pass the ``amp`` hook as the JAX op ``conv_nd`` (white list).
  A bias of another dtype than the product is added after it, in the
  promoted dtype, as ``jnp`` adds it.
"""
from __future__ import annotations

import math
from numbers import Integral

import torch
import torch.nn.functional as TF

from ...amp.auto_cast import cast_inputs as _amp_cast
from ...framework.layout_autotune import layout_autotune_enabled

__all__ = ["conv1d", "conv2d", "conv3d"]

_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
#: the channels-last memory format of a rank (none for 1-D)
CHANNELS_LAST = {2: torch.channels_last, 3: torch.channels_last_3d}


def _norm_tuple(v, n):
    if isinstance(v, Integral):
        return (int(v),) * n
    v = [int(x) for x in v]
    return tuple(v * n) if len(v) == 1 else tuple(v)


def _norm_padding(padding, n, channel_last=False):
    """``"SAME"``, ``"VALID"`` or ``[(l, r)] * n``, as the JAX package's
    ``_norm_padding`` reads ``padding``; ``n + 2`` nested pairs carry the
    batch and channel pairs (zeros) where ``data_format`` puts those axes
    (Paddle's form, which the JAX package refuses)."""
    if isinstance(padding, str):
        spec = padding.upper()
        if spec not in ("SAME", "VALID"):
            raise ValueError(f"padding must be 'SAME' or 'VALID', not "
                             f"{padding!r}")
        return spec
    if isinstance(padding, Integral):
        return [(int(padding), int(padding))] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, Integral) for p in padding):
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n and all(isinstance(p, Integral)
                                     for p in padding):
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    # nested [[l, r], ...], possibly with the batch and channel pairs
    flat = [list(p) if isinstance(p, (list, tuple)) else [p, p]
            for p in padding]
    if len(flat) == n + 2:
        spatial = flat[1:n + 1] if channel_last else flat[2:]
        others = [flat[0], flat[-1] if channel_last else flat[1]]
        if any(int(v) for pair in others for v in pair):
            raise ValueError(f"padding {padding}: the batch and channel "
                             "pairs must be [0, 0]")
        flat = spatial
    return [(int(lo), int(hi)) for lo, hi in flat[:n]]


def same_pads(sizes, windows, strides):
    """XLA's ``SAME`` pads: output ``ceil(in / stride)``, the odd cell of the
    total on the right."""
    pads = []
    for size, k, s in zip(sizes, windows, strides):
        total = max((math.ceil(size / s) - 1) * s + k - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def explicit_pads(padding, sizes, windows, strides, channel_last=False):
    """``[(l, r)]`` a spatial dim for any padding form; ``windows`` are the
    dilated window sizes."""
    spec = _norm_padding(padding, len(sizes), channel_last)
    if spec == "VALID":
        return [(0, 0)] * len(sizes)
    if spec == "SAME":
        return same_pads(sizes, windows, strides)
    return spec


def pad_input(x, pads, value=0.0):
    """``x`` (``[N, C, *spatial]``) padded by ``[(l, r)]`` a spatial dim."""
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    return TF.pad(x, flat, value=value)


def _conv(x, weight, bias, stride, padding, dilation, groups, data_format, nd):
    x, weight, bias = _amp_cast("conv_nd", x, weight, bias)
    channel_last = data_format.endswith("C")
    stride = _norm_tuple(stride, nd)
    dilation = _norm_tuple(dilation, nd)
    if channel_last:
        x = x.movedim(-1, 1)
    elif layout_autotune_enabled() and nd in CHANNELS_LAST:
        fmt = CHANNELS_LAST[nd]
        x = x.contiguous(memory_format=fmt)
        weight = weight.contiguous(memory_format=fmt)
    windows = [d * (k - 1) + 1 for d, k in zip(dilation, weight.shape[2:])]
    pads = explicit_pads(padding, x.shape[2:], windows, stride, channel_last)
    if all(lo == hi >= 0 for lo, hi in pads):
        pad_arg = tuple(lo for lo, _ in pads)
    else:
        x, pad_arg = pad_input(x, pads), 0
    fused = bias if bias is None or bias.dtype == x.dtype else None
    out = _CONV[nd](x, weight, fused, stride, pad_arg, dilation, groups)
    if bias is not None and fused is None:
        out = out + bias.reshape([-1] + [1] * nd)
    return out.movedim(1, -1) if channel_last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    df = "NWC" if data_format in ("NLC", "NWC") else "NCW"
    return _conv(x, weight, bias, stride, padding, dilation, groups, df, 1)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 2)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 3)
