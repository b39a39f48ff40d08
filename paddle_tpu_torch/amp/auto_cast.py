"""Autocast and decorate — port of ``paddle_tpu/amp/auto_cast.py``.

Not ``torch.autocast``: its op lists are not Paddle's. The JAX package hooks
its op dispatcher (``ops/dispatch.py::AMP_HOOK``) and casts the positional
array inputs of an op by the op's name; the port's functionals call
:func:`cast_inputs` with the same names (``linear``, ``matmul``, ``sdpa``,
``flash_sdpa``, ``layer_norm_op``, ``fused_layer_norm``, ``softmax_op``,
``gelu``), and it casts as the JAX hook does:

* O1: an op on the white list gets its fp32 inputs in the low-precision
  dtype; one on the black list gets its low-precision inputs in fp32.
* O2: only the black list is cast (back to fp32); every other op runs on
  what it is given. After ``decorate`` the LayerNorms keep fp32 weights, so
  a LayerNorm's output is fp32 and each following linear promotes against
  its bf16 weight to fp32: a property of the reference that the port keeps
  (the functionals promote mixed operands as JAX does).

``decorate(models, optimizers, level="O2")`` casts every non-norm
submodule's floating parameters and buffers to the low-precision dtype,
keeps norm layers fp32, and turns on the optimizers' ``multi_precision``
(master weights).
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

__all__ = ["auto_cast", "amp_guard", "decorate", "cast_inputs", "white_list",
           "black_list"]

# the JAX package's lists (reference imperative/amp_auto_cast.cc)
white_list = {
    "matmul", "conv_nd", "conv_transpose_nd", "linear", "bmm", "mv", "einsum",
    "addmm", "dot", "inner", "outer", "sdpa", "flash_sdpa", "bilinear_op",
}
black_list = {
    "exp", "log", "log2", "log10", "log1p", "logsumexp", "pow",
    "elementwise_pow", "square", "rsqrt", "softmax_op", "log_softmax_op",
    "softmax_ce", "weighted_nll", "soft_nll", "nll_loss_op", "bce_op",
    "bce_logits_op", "kl_div_op", "layer_norm_op", "fused_layer_norm",
    "batch_norm_train", "batch_norm_infer", "group_norm_op",
    "instance_norm_op", "mean", "sum", "cumsum", "norm_op", "dist",
    "cosine_similarity_op", "sigmoid_focal_op", "ctc_op", "rms_norm",
}

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}

#: the active policy: None, or (level, low-precision dtype, white, black)
_policy = None


def _cast(vals, src, dst):
    return tuple(v.to(dst) if torch.is_tensor(v) and v.dtype == src else v
                 for v in vals)


def cast_inputs(name, *vals):
    """The inputs of op ``name`` as the active ``auto_cast`` hands them to
    the op (unchanged outside ``auto_cast``)."""
    if _policy is None:
        return vals
    level, lowp, wl, bl = _policy
    if name in bl:
        return _cast(vals, lowp, torch.float32)
    if level == "O1" and name in wl:
        return _cast(vals, torch.float32, lowp)
    return vals


@contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """``paddle.amp.auto_cast`` (O1: per-op lists; O2: everything but the
    black list runs as given)."""
    global _policy
    if level not in ("O0", "O1", "O2"):
        raise ValueError(
            "level should be O0, O1 or O2, but received %r" % (level,))
    if not enable or level == "O0":
        yield
        return
    wl = set(white_list) | set(custom_white_list or ())
    bl = (set(black_list) | set(custom_black_list or ())) - set(
        custom_white_list or ())
    prev = _policy
    _policy = (level, _DTYPES[dtype], frozenset(wl), frozenset(bl))
    try:
        yield
    finally:
        _policy = prev


amp_guard = auto_cast

_NORM_TYPES = (
    "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
    "SyncBatchNorm", "LayerNorm", "RMSNorm", "InstanceNorm1D",
    "InstanceNorm2D", "InstanceNorm3D", "GroupNorm", "LocalResponseNorm",
    "SpectralNorm",
)


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """``paddle.amp.decorate``. O2 casts each non-norm submodule's own
    floating parameters and buffers to ``dtype`` in place (the optimizers
    keep the same ``Parameter`` objects) and leaves norm layers fp32;
    ``master_weight`` (default on for O2) turns on ``multi_precision``."""
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        lowp = _DTYPES[dtype]
        with torch.no_grad():
            for m in model_list:
                for sub in m.modules():
                    if type(sub).__name__ in _NORM_TYPES:
                        continue
                    for t in list(sub._parameters.values()) + list(
                            sub._buffers.values()):
                        if t is not None and t.is_floating_point():
                            t.data = t.data.to(lowp)
    if optimizers is None:
        return models if single else model_list
    single_opt = not isinstance(optimizers, (list, tuple))
    opt_list = [optimizers] if single_opt else list(optimizers)
    if master_weight is None:
        master_weight = level == "O2"
    if master_weight:
        for opt in opt_list:
            opt._multi_precision = True
    return ((models if single else model_list),
            (optimizers if single_opt else opt_list))
