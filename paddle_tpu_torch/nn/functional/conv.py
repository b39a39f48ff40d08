"""Convolutions — port of ``paddle_tpu/nn/functional/conv.py`` (``conv1d``,
``conv2d``, ``conv3d`` and their transposes ``conv1d_transpose``,
``conv2d_transpose``, ``conv3d_transpose``).

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
  with the logical shape unchanged. There a bf16 or fp16 1 x 1 stride-1
  convolution on the card runs as one product on the NHWC view
  (``_pointwise``): cuDNN's backward converts some such tensors to NCHW
  and back.
* The inputs pass the ``amp`` hook as the JAX op ``conv_nd`` (white list).
  A bias of another dtype than the product is added after it, in the
  promoted dtype, as ``jnp`` adds it.
* A transposed convolution's weight is ``[in, out/groups, *k]`` in both
  packages (and PyTorch's). The JAX op ``conv_transpose_nd`` (white list)
  runs an lhs-dilated convolution of the flipped kernel; the port runs
  PyTorch's transposed convolution (cuDNN's on the card), whose result is
  the same. Padding takes the integer forms of ``conv*d`` (a string
  raises ``NotImplementedError``, as in JAX); ``output_size`` sets
  ``output_padding``. Equal pads and an ``output_padding`` below the
  stride or dilation are PyTorch's own arguments; otherwise the full
  transposed output is cropped by ``(l, r - output_padding)`` through
  ``F.pad`` (zeros where ``output_padding`` exceeds ``r``), which is what
  the JAX lowering's padding ``(k' - 1 - l, k' - 1 - r + output_padding)``
  gives.
"""
from __future__ import annotations

import math
from numbers import Integral

import torch
import torch.nn.functional as TF

from ...amp.auto_cast import cast_inputs as _amp_cast
from ...framework.layout_autotune import layout_autotune_enabled
from ...ops.dispatch import op

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}
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


def _pointwise_on_gemm(x, weight, stride, pads, groups, channel_last, nd):
    """A 1 x 1, stride-1, unpadded, ungrouped 2-D convolution of a
    channels-last bf16 or fp16 CUDA input: one product on the NHWC view.
    cuDNN runs the same product for most such shapes (the same bits), but
    at some (ShuffleNetV2's 58- and 116-wide) its backward picks an engine
    that converts NHWC -> NCHW and back. fp32 stays on cuDNN, under
    cuDNN's TF32 setting."""
    return (x.is_cuda and x.dtype in (torch.bfloat16, torch.float16)
            and nd == 2 and not channel_last
            and layout_autotune_enabled() and groups == 1
            and tuple(weight.shape[2:]) == (1, 1) and stride == (1, 1)
            and all(p == (0, 0) for p in pads))


def _pointwise(x, weight):
    """The 1 x 1 convolution ``x`` (``[N, C, H, W]``) * ``weight``
    (``[O, C, 1, 1]``) as ``[N H W, C] @ [C, O]`` on the channels-last
    view; the result is channels-last."""
    n, c, h, w = x.shape
    rows = x.movedim(1, -1).reshape(-1, c)
    out = torch.matmul(rows, weight.reshape(weight.shape[0], c).t())
    return out.reshape(n, h, w, -1).movedim(-1, 1)


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
    if _pointwise_on_gemm(x, weight, stride, pads, groups, channel_last, nd):
        out = _pointwise(x, weight)
        if bias is not None:
            out = out + bias.reshape(-1, 1, 1)
        return out
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



@op("conv_transpose_nd")
def _conv_transpose_raw(x, weight, bias=None, stride=(1,), padding=((0, 0),),
                        output_padding=(0,), dilation=(1,), groups=1,
                        channel_last=False, nd=2):
    if channel_last:
        x = x.movedim(-1, 1)
    elif layout_autotune_enabled() and nd in CHANNELS_LAST:
        fmt = CHANNELS_LAST[nd]
        x = x.contiguous(memory_format=fmt)
        weight = weight.contiguous(memory_format=fmt)
    fused = bias if bias is None or bias.dtype == x.dtype else None
    if all(lo == hi and 0 <= o < max(s, d) for (lo, hi), o, s, d in zip(
            padding, output_padding, stride, dilation)):
        out = _CONV_T[nd](x, weight, fused, stride,
                          [lo for lo, _ in padding], output_padding, groups,
                          dilation)
    else:
        out = _CONV_T[nd](x, weight, fused, stride, 0, 0, groups, dilation)
        out = pad_input(out, [(-lo, o - hi) for (lo, hi), o in zip(
            padding, output_padding)])
    if bias is not None and fused is None:
        out = out + bias.reshape([-1] + [1] * nd)
    return out.movedim(1, -1) if channel_last else out


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, data_format, nd, output_size=None):
    channel_last = data_format.endswith("C")
    spec = _norm_padding(padding, nd, channel_last)
    if isinstance(spec, str):
        raise NotImplementedError("string padding for conv_transpose")
    stride = _norm_tuple(stride, nd)
    dilation = _norm_tuple(dilation, nd)
    opd = _norm_tuple(output_padding, nd)
    if output_size is not None:
        sizes = (list(output_size) if isinstance(output_size, (list, tuple))
                 else [output_size] * nd)
        spatial = x.shape[1:-1] if channel_last else x.shape[2:]
        k = weight.shape[2:]
        opd = tuple(int(sizes[i]) - ((spatial[i] - 1) * stride[i]
                                     - spec[i][0] - spec[i][1]
                                     + dilation[i] * (k[i] - 1) + 1)
                    for i in range(nd))
    return _conv_transpose_raw(
        x, weight, *([bias] if bias is not None else []), stride=stride,
        padding=tuple(spec), output_padding=opd, dilation=dilation,
        groups=groups, channel_last=channel_last, nd=nd)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    df = "NWC" if data_format in ("NLC", "NWC") else "NCW"
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, df, 1, output_size)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, data_format, 2, output_size)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, data_format, 3, output_size)
