"""Hand-written CUDA kernels for Hopper — the port of ``paddle_tpu.ops.pallas``.

Every kernel here replaces one Pallas TPU kernel and lives beside its plain
PyTorch version in the same module. A wrapper takes the plain version only
for tensors on the CPU; for a CUDA tensor it launches its kernel (built at
first use, see :mod:`._build`) or raises — there is no fallback.

Each wrapper keeps a launch count as a plain integer attribute
(``flash_attention_cached.launches``, ``layer_norm.launches``, ...), raised
by one where the kernel is launched and nowhere else, so a run can show that
its main path went through the kernels. The wrappers that return a kernel's
output directly raise when autograd is asked to record them; the
differentiable entry points (``layer_norm``, ``flash_attention_packed``,
``flash_linear_cross_entropy``) are ``autograd.Function``s over a forward
and a backward kernel.
"""
from __future__ import annotations

from . import flash_attention as _fa
from . import flash_attention_packed as _fp
from . import fused_ce as _ce
from . import layer_norm as _ln
from ._build import build_info, library

__all__ = ["build_info", "library", "launch_counts", "reset_launch_counts"]


def _wrappers():
    return {"flash_attention_cached": _fa.flash_attention_cached,
            "flash_attention_packed_fwd": _fp.flash_attention_packed_fwd,
            "flash_attention_packed_bwd": _fp.flash_attention_packed_bwd,
            "layer_norm": _ln.layer_norm,
            "layer_norm_bwd": _ln.layer_norm_bwd,
            "fused_ce_fwd": _ce.ce_forward,
            "fused_ce_dx": _ce.ce_backward_dx,
            "fused_ce_dw": _ce.ce_backward_dw}


def launch_counts():
    """``{kernel wrapper name: launches}`` since the last reset."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts():
    for fn in _wrappers().values():
        fn.launches = 0
