"""Common functionals — port of ``paddle_tpu/nn/functional/common.py``
(``linear``, ``embedding``, the dropouts, ``one_hot``, ``label_smooth``,
``cosine_similarity``, ``bilinear``, ``diag_embed``) and of
``paddle_tpu/ops/math.py::matmul``, in plain PyTorch.

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
"""
from __future__ import annotations

import torch

from ...amp.auto_cast import cast_inputs as _amp_cast
from ...framework import dtype as dtypes
from ...framework import random as rnd
from ...ops.dispatch import op, plain

__all__ = ["linear", "matmul", "embedding", "dropout", "dropout2d",
           "dropout3d", "alpha_dropout", "one_hot", "label_smooth",
           "cosine_similarity", "bilinear", "diag_embed"]


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
