"""Sampling grids — port of ``paddle_tpu/nn/functional/vision.py``
(``affine_grid``, ``grid_sample``).

``affine_grid`` maps the output pixels' normalised coordinates (the
corners at ±1 with ``align_corners``, the pixel centres without) through
``theta`` ``[N, 2, 3]`` as the JAX package does. ``grid_sample`` runs
PyTorch's ``grid_sample`` (bilinear or nearest, half to even as
``jnp.round``; a bf16 or fp16 call runs in fp32 and rounds once), which
gives the JAX package's result for ``"zeros"`` and ``"border"`` padding;
``"reflection"`` reflects the coordinates as Paddle documents it, where
the JAX package clamps them as ``"border"`` does (``ROADMAP.md`` C).
"""
from __future__ import annotations

import torch

from ...ops.dispatch import op, plain

__all__ = ["affine_grid", "grid_sample"]


@op("affine_grid_op")
def _affine_grid_raw(theta, out_shape=(), align_corners=True):
    n, c, h, w = out_shape
    kw = dict(dtype=theta.dtype, device=theta.device)
    if align_corners:
        ys = torch.linspace(-1.0, 1.0, h, **kw)
        xs = torch.linspace(-1.0, 1.0, w, **kw)
    else:
        ys = (torch.arange(h, **kw) + 0.5) * 2.0 / h - 1.0
        xs = (torch.arange(w, **kw) + 0.5) * 2.0 / w - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1).reshape(h * w, 3)
    grid = torch.einsum("bij,nj->bni", theta, base)
    return grid.reshape(theta.shape[0], h, w, 2)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """``[N, H, W, 2]`` sampling coordinates (x, y) of ``theta``'s affine
    maps for an output of ``out_shape`` ``[N, C, H, W]``."""
    if isinstance(out_shape, torch.Tensor):
        out_shape = plain(out_shape).tolist()
    return _affine_grid_raw(theta, out_shape=tuple(int(s) for s in out_shape),
                            align_corners=bool(align_corners))


@op("grid_sample_op")
def _grid_sample_raw(x, grid, mode="bilinear", padding_mode="zeros",
                     align_corners=True):
    # in the promoted dtype, as the JAX package's arithmetic: a bf16 input
    # sampled at fp32 coordinates gives fp32. A 2-byte type runs in fp32
    # and rounds once: PyTorch's CUDA backward adds the input's gradient
    # with atomics in the 2-byte type (the bf16 sweep stood 100 % off), and
    # its CPU sampler corrupts its heap in a bf16 backward
    dt = torch.promote_types(x.dtype, grid.dtype)
    run = torch.float32 if dt in (torch.bfloat16, torch.float16) else dt
    return torch.nn.functional.grid_sample(
        x.to(run), grid.to(run), mode=mode, padding_mode=padding_mode,
        align_corners=align_corners).to(dt)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """``x`` ``[N, C, H, W]`` sampled at ``grid`` ``[N, Ho, Wo, 2]``
    (normalised x, y) by ``mode`` ``"bilinear"`` or ``"nearest"``, outside
    the input by ``padding_mode`` ``"zeros"``, ``"border"`` or
    ``"reflection"``."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"grid_sample: mode {mode!r}")
    if padding_mode not in ("zeros", "border", "reflection"):
        raise ValueError(f"grid_sample: padding_mode {padding_mode!r}")
    return _grid_sample_raw(x, grid, mode=mode, padding_mode=padding_mode,
                            align_corners=bool(align_corners))
