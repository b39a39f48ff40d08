"""Common functionals — port of ``paddle_tpu/nn/functional/common.py``
(``linear``, ``embedding``, the dropouts, ``one_hot``, ``label_smooth``,
``cosine_similarity``, ``bilinear``, ``diag_embed``, ``pad`` and
``zeropad2d``, ``interpolate``/``upsample``, the pixel and channel
shuffles, ``unfold``/``fold``, ``temporal_shift``, ``class_center_sample``)
and of ``paddle_tpu/ops/math.py::matmul``, in plain PyTorch.

``linear`` takes Paddle's ``[in, out]`` weight and computes ``x @ weight +
bias``, as the JAX package does (torch's own ``linear`` runs on the
weight's transposed view, so cuBLAS reads ``[in, out]`` as it is stored and
adds the bias in its epilogue). Operands of two float dtypes promote as in JAX
(bf16 against fp32 computes in fp32), where torch's own products would
refuse them; ``amp.auto_cast`` casts the inputs first by the JAX op names
``linear`` and ``matmul``; the other functionals are ops of the port's
registry under the JAX op names (``dropout_masked``,
``alpha_dropout_masked``, ``label_smooth_op``, ``cosine_similarity_op``,
``bilinear_op``, ``diag_embed``).

The dropouts draw their keep-mask from the port's generator of the input's
device (``framework/random.py``): an element is kept where a uniform draw
is below ``1 - p``, as ``jax.random.bernoulli`` keeps it. So a seed replays
within the port, and given the same mask (``_dropout_masked``,
``_alpha_dropout_masked``) both packages give the same output. ``dropout``
keeps the JAX package's options: ``p`` may be a Tensor, ``p == 1`` gives
zeros, ``axis`` draws one mask over those axes and broadcasts it along the
others, and ``mode="downscale_in_infer"`` leaves training unscaled and
scales by ``1 - p`` at inference.

``interpolate`` computes ``jax.image.resize``'s result where the JAX
package honours the caller's arguments: each resized axis is one product
with that function's weight matrix (a triangle or Keys' cubic, widened by
the ratio when downsampling and renormalised at the edges; the weights in
the input's dtype), ``"nearest"`` a gather at half-pixel centres.
``align_corners=True``, ``align_mode=1`` and ``"area"`` give Paddle's
results, which the JAX package drops (``ROADMAP.md`` C). The resampling,
the shuffles and ``zeropad2d`` keep a channels-last input channels-last:
the shuffles rearrange its NHWC view, with the NCHW channel order in both
data formats.
"""
from __future__ import annotations

import torch

from ...amp.auto_cast import cast_inputs as _amp_cast
from ...framework import dtype as dtypes
from ...framework import random as rnd
from ...framework.tensor import wrap
from ...ops.dispatch import op, plain
from ...ops.manipulation import pad  # noqa: F401  (F.pad is paddle.pad)

__all__ = ["linear", "matmul", "embedding", "dropout", "dropout2d",
           "dropout3d", "alpha_dropout", "one_hot", "label_smooth",
           "cosine_similarity", "bilinear", "diag_embed", "pad", "zeropad2d",
           "interpolate", "upsample", "pixel_shuffle", "pixel_unshuffle",
           "channel_shuffle", "unfold", "fold", "temporal_shift",
           "class_center_sample"]


def _promoted(a, b):
    if a.dtype == b.dtype:
        return a, b
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with ``weight`` ``[in, out]``."""
    x, weight, bias = _amp_cast("linear", x, weight, bias)
    x, weight = _promoted(x, weight)
    if bias is None or bias.dtype == x.dtype:
        return torch.nn.functional.linear(x, weight.t(), bias)
    # JAX adds the bias to the product in the promoted dtype of the two
    return torch.nn.functional.linear(x, weight.t()) + bias


def _swap_last(t):
    return t.transpose(-1, -2) if t.ndim >= 2 else t


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """``paddle.matmul``: ``transpose_x`` / ``transpose_y`` swap the last two
    axes of an operand of two or more dims first; ``name`` is accepted and
    ignored, as in the JAX package."""
    x, y = _amp_cast("matmul", x, y)
    if transpose_x:
        x = _swap_last(x)
    if transpose_y:
        y = _swap_last(y)
    return torch.matmul(*_promoted(x, y))


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at the ids ``x``. The rows at ``padding_idx`` (in
    ``[-vocab, vocab)``; a negative one counts from the end) are zeros, and
    so is their gradient, as in the JAX package. ``sparse`` gives the same
    gradient, stored dense (the JAX package gives a row-sparse one)."""
    out = torch.nn.functional.embedding(x, weight)
    if padding_idx is None:
        return out
    pi = padding_idx if padding_idx >= 0 else padding_idx + weight.shape[0]
    return out * (x != pi).unsqueeze(-1).to(out.dtype)


def _keep_mask(x, p, shape):
    """1 where kept (a uniform draw below ``1 - p``), 0 where dropped, in
    ``x``'s dtype, of ``shape``."""
    u = torch.rand(shape, device=x.device, generator=rnd.generator(x.device))
    return (u < 1.0 - p).to(x.dtype)


@op("dropout_masked")
def _dropout_masked(x, mask, scale=1.0):
    return x * mask * scale


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """``paddle.nn.functional.dropout`` (see the module docstring)."""
    if isinstance(p, torch.Tensor):
        p = float(plain(p).item())
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1 - p) if p else x
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    shape = list(plain(x).shape)
    if axis is not None:
        axes = [a % len(shape) for a in
                ([axis] if isinstance(axis, int) else axis)]
        shape = [d if i in axes else 1 for i, d in enumerate(shape)]
    scale = 1.0 / (1.0 - p) if mode == "upscale_in_train" else 1.0
    return _dropout_masked(x, _keep_mask(x, p, shape), scale=scale)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """One mask a ``[N, C]`` feature map."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=axis, training=training)


@op("alpha_dropout_masked")
def _alpha_dropout_masked(x, mask, alpha_p=0.0, a=1.0, b=0.0):
    return (x * mask + alpha_p * (1 - mask)) * a + b


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU's dropout: dropped elements take ``-alpha * scale`` and the
    result is moved by ``a``, ``b`` so that a zero-mean unit-variance input
    keeps its mean and variance."""
    if not training or p == 0:
        return x
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale
    mask = _keep_mask(x, p, plain(x).shape)
    a = 1.0 / ((1 - p) * (1 + p * alpha_p ** 2)) ** 0.5
    b = -a * alpha_p * p
    return _alpha_dropout_masked(x, mask, alpha_p=alpha_p, a=a, b=b)


def one_hot(x, num_classes, name=None):
    """Rows of the default float dtype; an id outside ``[0, num_classes)``
    gives a row of zeros, as ``jax.nn.one_hot``."""
    ids = plain(x)
    classes = torch.arange(num_classes, device=ids.device)
    return (ids.unsqueeze(-1) == classes).to(
        dtypes.convert_dtype(dtypes.get_default_dtype()))


@op("label_smooth_op")
def _label_smooth_raw(label, prior=None, epsilon=0.1):
    if prior is None:
        return (1 - epsilon) * label + epsilon / label.shape[-1]
    return (1 - epsilon) * label + epsilon * prior


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    if prior_dist is None:
        return _label_smooth_raw(label, epsilon=epsilon)
    return _label_smooth_raw(label, prior_dist, epsilon=epsilon)


@op("cosine_similarity_op")
def _cosine_similarity_raw(x1, x2, axis=1, eps=1e-8):
    dot = torch.sum(x1 * x2, dim=axis)
    n1 = torch.sqrt(torch.sum(x1 * x1, dim=axis))
    n2 = torch.sqrt(torch.sum(x2 * x2, dim=axis))
    return dot / torch.clamp_min(n1 * n2, eps)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    return _cosine_similarity_raw(x1, x2, axis=axis, eps=eps)


@op("bilinear_op")
def _bilinear_raw(x1, x2, weight, bias=None):
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = x1[b] @ weight[o] @ x2[b] + bias[o]``."""
    if bias is None:
        return _bilinear_raw(x1, x2, weight)
    return _bilinear_raw(x1, x2, weight, bias)


@op("diag_embed")
def _diag_embed_raw(x, offset=0, dim1=-2, dim2=-1):
    return torch.diag_embed(x, offset=offset, dim1=dim1, dim2=dim2)


def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):
    """Batched vectors as matrices with the vector on the ``offset``
    diagonal of the new axes ``dim1``, ``dim2`` (of the output)."""
    return _diag_embed_raw(input, offset=int(offset), dim1=int(dim1),
                           dim2=int(dim2))


# -------------------------------------------- padding and resampling ----

def _stored_last(x):
    """Whether ``x`` (``[N, C, *spatial]``) is stored channels-last (and
    not also contiguous as it stands)."""
    return (x.ndim >= 3 and not x.is_contiguous()
            and x.movedim(1, -1).is_contiguous())


def _memory_format(x):
    return ({4: torch.channels_last, 5: torch.channels_last_3d}[x.ndim]
            if x.ndim in (4, 5) and _stored_last(x)
            else torch.contiguous_format)


@op("zeropad2d")
def _zeropad2d_raw(x, pads=(0, 0, 0, 0), channel_last=False):
    left, right, top, bottom = pads
    if channel_last:
        return torch.nn.functional.pad(x, (0, 0, left, right, top, bottom))
    return torch.nn.functional.pad(x, (left, right, top, bottom))


def zeropad2d(x, padding, data_format="NCHW", name=None):
    """Zeros around a 4-D tensor's spatial dims, ``padding`` ``(left,
    right, top, bottom)``; a channels-last input stays channels-last."""
    pads = tuple(int(p) for p in (plain(padding).tolist() if isinstance(
        padding, torch.Tensor) else padding))
    return _zeropad2d_raw(x, pads=pads, channel_last=data_format != "NCHW")


def _keys_cubic(t):
    """The Keys cubic of ``a = -0.5`` (``jax.image``'s ``"cubic"``)."""
    out = ((1.5 * t - 2.5) * t) * t + 1.0
    out = torch.where(t >= 1.0, ((-0.5 * t + 2.5) * t - 4.0) * t + 2.0, out)
    return torch.where(t >= 2.0, torch.zeros_like(t), out)


def _triangle(t):
    return torch.clamp_min(1.0 - t.abs(), 0.0)


def _jax_resize_weights(m, n, kernel, device):
    """``[n, m]``: ``jax.image.resize``'s weights from ``m`` samples to
    ``n`` (``compute_weight_mat`` with the kernel widened by ``m / n`` when
    downsampling, normalised over the taps inside the input), fp32."""
    inv = 1.0 / (n / m)
    sample = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) \
        * inv - 0.5
    taps = torch.arange(m, dtype=torch.float32, device=device)
    w = kernel((sample[None, :] - taps[:, None]).abs() / max(inv, 1.0))
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).t()


def _asymmetric_weights(m, n, device):
    """``[n, m]``: Paddle's linear taps at ``align_mode=1``, sample ``i``
    reading ``i * m / n``."""
    src = torch.arange(n, dtype=torch.float32, device=device) * (m / n)
    lo = src.floor().clamp(0, m - 1)
    frac = src - lo
    lo = lo.long()
    hi = (lo + 1).clamp_max(m - 1)
    w = torch.zeros(n, m, dtype=torch.float32, device=device)
    rows = torch.arange(n, device=device)
    w.index_put_((rows, lo), 1.0 - frac, accumulate=True)
    w.index_put_((rows, hi), frac, accumulate=True)
    return w


def _along(x, axis, w):
    """``x`` with ``axis`` (of size ``m``) contracted with ``w`` ``[n, m]``."""
    return torch.matmul(x.movedim(axis, -1), w.t()).movedim(-1, axis)


_TORCH_MODE = {1: "linear", 2: "bilinear", 3: "trilinear"}


@op("interp_op")
def _interpolate_raw(x, size=(), mode="nearest", align_corners=False,
                     align_mode=0, data_format="NCHW"):
    chan_last = data_format.endswith("C")
    first = x.movedim(-1, 1) if chan_last else x        # [N, C, *spatial]
    nd = first.ndim - 2
    fmt = _memory_format(first)
    if mode == "area":
        y = getattr(torch.nn.functional, f"adaptive_avg_pool{nd}d")(
            first, tuple(size))
    elif align_corners:
        y = torch.nn.functional.interpolate(
            first, size=tuple(size), align_corners=True,
            mode="bicubic" if mode == "bicubic" else _TORCH_MODE[nd])
    else:
        y = first
        for i, (m, n) in enumerate(zip(first.shape[2:], size)):
            if m == n:
                continue
            if mode == "nearest":
                idx = (torch.arange(n, dtype=torch.float32) + 0.5) * m / n
                y = y.index_select(2 + i, idx.floor().long().to(y.device))
                continue
            if mode == "bicubic":
                w = _jax_resize_weights(m, n, _keys_cubic, y.device)
            elif align_mode == 1:
                w = _asymmetric_weights(m, n, y.device)
            else:
                w = _jax_resize_weights(m, n, _triangle, y.device)
            y = _along(y, 2 + i, w.to(y.dtype))
    y = y.contiguous(memory_format=fmt)
    return y.movedim(1, -1) if chan_last else y


_MODES = ("nearest", "bilinear", "trilinear", "linear", "bicubic", "area")


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format=None,
                name=None):
    """``paddle.nn.functional.interpolate`` (see ``ROADMAP.md`` C for what
    each mode computes): ``"nearest"`` reads the sample at
    ``floor((i + 0.5) * in / out)`` (half-pixel centres) and the linear
    modes and ``"bicubic"`` (Keys, ``a = -0.5``) take ``jax.image.resize``'s
    weights (a filter widened by the ratio when downsampling), as the JAX
    package does; ``align_corners=True``, ``align_mode=1`` and ``"area"``
    give Paddle's results, which the JAX package does not."""
    nd = plain(x).ndim - 2
    if mode not in _MODES:
        raise ValueError(f"interpolate: mode {mode!r} is not one of "
                         f"{_MODES}")
    if align_corners and mode in ("nearest", "area"):
        raise ValueError("align_corners option can only be set with the "
                         "interpolating modes: linear | bilinear | bicubic "
                         "| trilinear")
    if data_format is None:
        data_format = {1: "NCW", 2: "NCHW", 3: "NCDHW"}[nd]
    shape = plain(x).shape
    spatial = shape[1:-1] if data_format.endswith("C") else shape[2:]
    if size is None:
        if isinstance(scale_factor, torch.Tensor):
            scale_factor = plain(scale_factor).tolist()
        if isinstance(scale_factor, (int, float)):
            scale_factor = [scale_factor] * nd
        size = [int(s * f) for s, f in zip(spatial, scale_factor)]
    elif isinstance(size, torch.Tensor):
        size = [int(v) for v in plain(size).reshape(-1).tolist()]
    else:
        size = [int(plain(v).item()) if isinstance(v, torch.Tensor)
                else int(v) for v in (size if isinstance(size, (list, tuple))
                                      else [size] * nd)]
    return _interpolate_raw(x, size=tuple(size), mode=mode,
                            align_corners=bool(align_corners),
                            align_mode=int(align_mode),
                            data_format=data_format)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format=None, name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


# ------------------------------------------------------ rearrangements ----

@op("pixel_shuffle_op")
def _pixel_shuffle_raw(x, upscale_factor=1, data_format="NCHW"):
    r = upscale_factor
    t = x if data_format == "NCHW" else x.movedim(-1, 1)
    n, c, h, w = t.shape
    if _stored_last(t):
        y = t.movedim(1, -1).reshape(n, h, w, c // (r * r), r, r)
        y = y.permute(0, 1, 4, 2, 5, 3).reshape(n, h * r, w * r, c // (r * r))
        y = y.movedim(-1, 1)
    else:
        y = t.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        y = y.reshape(n, c // (r * r), h * r, w * r)
    return y if data_format == "NCHW" else y.movedim(1, -1)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    """Channel ``c * r^2 + i * r + j`` to the pixel ``(h r + i, w r + j)``
    of channel ``c``, in either data format (``ROADMAP.md`` C: the JAX
    package's NHWC form orders the channels ``(i, j, c)``)."""
    return _pixel_shuffle_raw(x, upscale_factor=int(upscale_factor),
                              data_format=data_format)


@op("pixel_unshuffle_op")
def _pixel_unshuffle_raw(x, downscale_factor=1, data_format="NCHW"):
    r = downscale_factor
    t = x if data_format == "NCHW" else x.movedim(-1, 1)
    n, c, h, w = t.shape
    if _stored_last(t):
        y = t.movedim(1, -1).reshape(n, h // r, r, w // r, r, c)
        y = y.permute(0, 1, 3, 5, 2, 4).reshape(n, h // r, w // r, c * r * r)
        y = y.movedim(-1, 1)
    else:
        y = t.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
        y = y.reshape(n, c * r * r, h // r, w // r)
    return y if data_format == "NCHW" else y.movedim(1, -1)


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    return _pixel_unshuffle_raw(x, downscale_factor=int(downscale_factor),
                                data_format=data_format)


@op("channel_shuffle_op")
def _channel_shuffle_raw(x, groups=1, data_format="NCHW"):
    t = x if data_format == "NCHW" else x.movedim(-1, 1)
    n, c = t.shape[:2]
    if _stored_last(t):
        tl = t.movedim(1, -1)
        y = tl.reshape(*tl.shape[:-1], groups, c // groups).transpose(-1, -2)
        y = y.reshape(tl.shape).movedim(-1, 1)
    else:
        y = t.reshape(n, groups, c // groups, *t.shape[2:]).transpose(1, 2)
        y = y.reshape(t.shape)
    return y if data_format == "NCHW" else y.movedim(1, -1)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    """Channel ``g * (C / groups) + k`` to ``k * groups + g``; a
    channels-last input stays channels-last."""
    return _channel_shuffle_raw(x, groups=int(groups),
                                data_format=data_format)


def _pair(v):
    return [int(v), int(v)] if isinstance(v, int) else [int(u) for u in v]


def _four(p):
    """``[top, left, bottom, right]``, as the JAX package reads
    ``paddings``."""
    if isinstance(p, int):
        return [p] * 4
    p = [int(u) for u in p]
    return p + p if len(p) == 2 else p


@op("unfold_op")
def _unfold_raw(x, kernel_sizes=(), strides=(), paddings=(), dilations=()):
    top, left, bottom, right = paddings
    if top == bottom and left == right:
        return torch.nn.functional.unfold(x, kernel_sizes, dilations,
                                          (top, left), strides)
    x = torch.nn.functional.pad(x, (left, right, top, bottom))
    return torch.nn.functional.unfold(x, kernel_sizes, dilations, 0, strides)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: ``[N, C * kh * kw, L]``, ``paddings`` ``[top, left, bottom,
    right]`` (or ``[h, w]``, or one int)."""
    return _unfold_raw(x, kernel_sizes=tuple(_pair(kernel_sizes)),
                       strides=tuple(_pair(strides)),
                       paddings=tuple(_four(paddings)),
                       dilations=tuple(_pair(dilations)))


@op("fold_op")
def _fold_raw(x, output_sizes=(), kernel_sizes=(), strides=(), paddings=(),
              dilations=()):
    top, left, bottom, right = paddings
    if top == bottom and left == right:
        return torch.nn.functional.fold(x, output_sizes, kernel_sizes,
                                        dilations, (top, left), strides)
    full = (output_sizes[0] + top + bottom, output_sizes[1] + left + right)
    y = torch.nn.functional.fold(x, full, kernel_sizes, dilations, 0,
                                 strides)
    return y[:, :, top:full[0] - bottom, left:full[1] - right]


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, :func:`unfold`'s adjoint: the blocks of ``x`` summed into
    ``[N, C, *output_sizes]``."""
    return _fold_raw(x, output_sizes=tuple(_pair(output_sizes)),
                     kernel_sizes=tuple(_pair(kernel_sizes)),
                     strides=tuple(_pair(strides)),
                     paddings=tuple(_four(paddings)),
                     dilations=tuple(_pair(dilations)))


@op("temporal_shift")
def _temporal_shift_raw(x, seg_num=1, shift_ratio=0.25, channel_last=False):
    if channel_last:
        x = x.movedim(-1, 1)
    nt, c, h, w = x.shape
    xr = x.reshape(nt // seg_num, seg_num, c, h, w)
    f = int(c * shift_ratio)
    back = torch.cat([xr[:, 1:, :f], torch.zeros_like(xr[:, :1, :f])], 1)
    fwd = torch.cat([torch.zeros_like(xr[:, :1, f:2 * f]),
                     xr[:, :-1, f:2 * f]], 1)
    out = torch.cat([back, fwd, xr[:, :, 2 * f:]], 2).reshape(nt, c, h, w)
    return out.movedim(1, -1) if channel_last else out


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None,
                   data_format="NCHW"):
    """TSM's shift: of each segment's channels, the first ``C *
    shift_ratio`` come from the next segment, the next as many from the
    previous one (zeros at the ends), the rest stay."""
    return _temporal_shift_raw(x, seg_num=int(seg_num),
                               shift_ratio=float(shift_ratio),
                               channel_last=data_format == "NHWC")


# -------------------------------------------------------------- sampling ----

def _class_center_sample_raw(label, noise, num_classes, num_samples):
    """The JAX package's rule given the draw ``noise`` (``[num_classes]``
    uniforms): the positive classes first, the negatives by ascending
    ``noise``, the first ``num_samples`` sorted; the labels remapped to
    their place among them."""
    pos = torch.zeros(num_classes, dtype=torch.bool, device=label.device)
    pos[label.reshape(-1)] = True
    key = torch.where(pos, torch.full_like(noise, -1.0), noise)
    order = torch.sort(key, stable=True).indices
    sampled = torch.sort(order[:num_samples]).values
    remap = torch.zeros(num_classes, dtype=label.dtype, device=label.device)
    remap[sampled] = torch.arange(num_samples, dtype=label.dtype,
                                  device=label.device)
    return remap[label], sampled


def class_center_sample(label, num_classes, num_samples, group=None):
    """PartialFC's class sampling: ``(remapped_label, sampled_classes)``.
    Every positive class is kept; the negatives are drawn from the port's
    generator of ``label``'s device (seeded replay within the port;
    ``ROADMAP.md`` C). ``group`` other than None or False raises: the
    model-parallel class split waits for the distributed port (A8)."""
    if group not in (None, False):
        raise NotImplementedError(
            "class_center_sample(group=...): the model-parallel class split "
            "waits for the distributed port (ROADMAP.md A8)")
    lab = plain(label)
    noise = torch.rand(num_classes, device=lab.device,
                       generator=rnd.generator(lab.device))
    return wrap(_class_center_sample_raw(lab, noise, int(num_classes),
                                         int(num_samples)))
