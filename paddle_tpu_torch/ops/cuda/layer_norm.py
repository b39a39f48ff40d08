"""LayerNorm: kernels K7 (forward) and K8 (backward) and their plain versions.

Port of ``paddle_tpu/ops/pallas/layer_norm.py``. Statistics are fp32 and the
output is in ``x.dtype``; gamma and beta may be fp32 while ``x`` is bf16.

:func:`layer_norm` is differentiable. Under autograd it is an
``autograd.Function`` that saves ``x`` and ``gamma`` and runs K7 forward and
K8 backward (which recomputes the row statistics, as the JAX custom vjp
does); dgamma and dbeta come back in gamma's dtype. The raw launchers
(:func:`layer_norm_bwd`, and K7 itself) return outputs that autograd cannot
see, so on a CUDA tensor they raise when asked to record a gradient.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import check, dtype_code, library, needs_grad, stream_of
from .cost import costed

__all__ = ["layer_norm", "layer_norm_plain", "layer_norm_bwd",
           "layer_norm_bwd_plain", "supports", "kernel_plan", "LANES"]

#: the JAX gate's lane width: the router sends a LayerNorm here only when
#: its feature count is a multiple of it (``_pallas_ln_ok``)
LANES = 128
#: ``kernel_plan``'s names of the library's kernel kinds
_KINDS = ("rows, 16-byte vectors", "rows, single elements",
          "general, 16-byte vectors", "general, single elements")


def supports(features):
    """The routing gate of the JAX package (``layer_norm.supports``)."""
    return features % LANES == 0


def layer_norm_plain(x, gamma, beta, eps=1e-5):
    """Plain PyTorch LayerNorm over the last axis, fp32 statistics."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    return y.to(x.dtype)


def layer_norm_bwd_plain(x, gamma, dy, eps=1e-5):
    """Plain version of K8: ``(dx, dgamma, dbeta)`` of the LayerNorm at
    ``x`` for the output gradient ``dy``. dx is in x's dtype, dgamma and
    dbeta are fp32 sums over every row cast to gamma's dtype."""
    feat = x.shape[-1]
    xf = x.reshape(-1, feat).float()
    dyf = dy.reshape(-1, feat).float()
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    xhat = xc * rstd
    dxhat = dyf * gamma.float()
    dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return (dx.reshape(x.shape).to(x.dtype),
            (dyf * xhat).sum(0).to(gamma.dtype), dyf.sum(0).to(gamma.dtype))


def _check_cuda(x, gamma, what, *others):
    """Validate the operands of a K7/K8 launch (raises on anything the
    kernels do not take)."""
    feat = x.shape[-1]
    if x.device.type != "cuda":
        raise ValueError(f"{what} kernel needs a CUDA tensor, got {x.device}")
    if needs_grad(x, gamma, *others):
        raise RuntimeError(
            f"{what}: the kernel's output is not recorded by autograd; call "
            "layer_norm, which differentiates through K7 and K8")
    if gamma.shape != (feat,):
        raise ValueError(f"gamma must be ({feat},), got {tuple(gamma.shape)}")
    if gamma.device != x.device:
        raise ValueError("x and gamma must be on one device")
    if feat < 1:
        raise ValueError(f"{what} kernel takes 1 feature or more, got {feat}")
    if not (x.is_contiguous() and gamma.is_contiguous()):
        raise ValueError(f"{what} kernel needs contiguous x and gamma")
    return feat, x.numel() // feat


@costed("K7", "layer_norm")
def _forward(x, gamma, beta, eps):
    """K7 on a CUDA tensor, the plain version on a CPU one."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, gamma, beta, eps)
    feat, rows = _check_cuda(x, gamma, "layer_norm", beta)
    if beta.shape != (feat,) or beta.device != x.device:
        raise ValueError(f"beta must be ({feat},) on {x.device}, got "
                         f"{tuple(beta.shape)} on {beta.device}")
    if gamma.dtype != beta.dtype:
        raise TypeError(f"gamma is {gamma.dtype} but beta is {beta.dtype}")
    if not beta.is_contiguous():
        raise ValueError("layer_norm kernel needs a contiguous beta")
    y = torch.empty_like(x)
    check(library().ptt_layer_norm_fwd(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        rows, feat, float(eps), dtype_code(x.dtype), dtype_code(gamma.dtype),
        stream_of(x)), "layer_norm")
    layer_norm.launches += 1
    return y


@costed("K8")
def layer_norm_bwd(x, gamma, dy, eps=1e-5):
    """``(dx, dgamma, dbeta)`` of the LayerNorm at ``x`` (``(..., features)``)
    for the output gradient ``dy``. CPU tensors take the plain version;
    CUDA tensors launch kernel K8."""
    if x.device.type == "cpu":
        return layer_norm_bwd_plain(x, gamma, dy, eps)
    feat, rows = _check_cuda(x, gamma, "layer_norm_bwd", dy)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must match x {tuple(x.shape)} {x.dtype}, got "
                         f"{tuple(dy.shape)} {dy.dtype} on {dy.device}")
    dy = dy.contiguous()
    dx = torch.empty_like(x)
    dgamma = torch.empty_like(gamma)
    dbeta = torch.empty_like(gamma)
    # the row kernel writes dx and one workspace row of dgamma/dbeta
    # partials a CTA; a second launch sums them per column
    parts = _plan(x, dx, dy, rows, feat)[2]
    partials = torch.empty((2, max(parts, 1), feat), dtype=torch.float32,
                           device=x.device)
    check(library().ptt_layer_norm_bwd(
        x.data_ptr(), gamma.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        dgamma.data_ptr(), dbeta.data_ptr(), partials.data_ptr(), parts,
        rows, feat, float(eps), dtype_code(x.dtype), dtype_code(gamma.dtype),
        stream_of(x)), "layer_norm_bwd")
    layer_norm_bwd.launches += 1
    return dx, dgamma, dbeta


def _plan(x, out, dy, rows, feat):
    """The library's ``(kind, accesses a lane, CTAs)`` for a K7 (``dy``
    None) or K8 launch on these tensors."""
    plan = (ctypes.c_int * 3)()
    check(library().ptt_layer_norm_plan(
        x.data_ptr(), out.data_ptr(), None if dy is None else dy.data_ptr(),
        rows, feat, dtype_code(x.dtype), int(dy is not None),
        ctypes.byref(plan)),
        "layer_norm plan")
    return tuple(plan)


def kernel_plan(x, dy=None):
    """How the library runs K7 (or K8, given ``dy``) on the CUDA tensor
    ``x``: ``{"kernel", "accesses_per_lane", "ctas"}``. The row kernels
    take one warp a row and hold a lane's columns as 16-byte vectors (single
    elements where the width or a pointer does not allow vectors); wider
    rows, and K7 on as many rows as the card has SMs or fewer, take the
    general kernels (a CTA a row)."""
    feat = x.shape[-1]
    kind, accesses, ctas = _plan(x, torch.empty_like(x), dy,
                                 x.numel() // feat, feat)
    return {"kernel": _KINDS[kind], "accesses_per_lane": accesses,
            "ctas": ctas}


class _LayerNorm(torch.autograd.Function):
    """K7 forward, K8 backward; saves x and gamma."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        ctx.beta_dtype = beta.dtype
        return _forward(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        dx, dgamma, dbeta = layer_norm_bwd(x, gamma, dy, ctx.eps)
        return dx, dgamma, dbeta.to(ctx.beta_dtype), None


def layer_norm(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis of ``x`` (``(..., features)``) with
    ``gamma``/``beta`` of shape ``(features,)``. CPU tensors take the plain
    versions; CUDA tensors launch kernel K7 (and K8 in the backward)."""
    if needs_grad(x, gamma, beta):
        return _LayerNorm.apply(x, gamma, beta, eps)
    return _forward(x, gamma, beta, eps)


layer_norm.launches = 0
layer_norm_bwd.launches = 0
