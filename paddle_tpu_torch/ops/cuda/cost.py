"""What the hand-written kernels cost, counted while a device cost report is
harvested (:mod:`paddle_tpu_torch.profiler.devprof`).

``torch.utils.flop_counter.FlopCounterMode`` sees aten operations only, and
the kernels are launched through ctypes, so it cannot see them. The JAX
package's XLA cost analysis does count the Pallas kernels that carry a
``pl.CostEstimate``: K1 (``paddle_tpu/ops/pallas/flash_attention.py:382``),
K4 (``:622``), K5 (``flash_attention_packed.py:432``) and K9
(``fused_ce.py:229``). So each kernel wrapper is decorated with
:func:`costed`: while a :class:`KernelCost` is active it adds its Pallas
counterpart's estimate (the same formula, from the launch's shapes), or
notes the kernel as uncounted where the Pallas kernel carries none, and
runs with every dispatch mode switched off, so the plain version's own aten
operations (the CPU path) are not counted a second time. With no harvest
active a wrapper costs one global read.
"""
from __future__ import annotations

import functools

__all__ = ["KernelCost", "costed", "ESTIMATES"]

#: the harvest's collector, or None
_ACTIVE = None


class KernelCost:
    """Flops, bytes and transcendentals the kernels launched inside one
    harvest would have cost their Pallas counterparts, and the launches by
    kernel, with and without an estimate."""

    def __init__(self):
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.transcendentals = 0.0
        self.counted = {}
        self.uncounted = {}

    def add(self, name, estimate):
        if estimate is None:
            self.uncounted[name] = self.uncounted.get(name, 0) + 1
            return
        self.counted[name] = self.counted.get(name, 0) + 1
        self.flops += estimate["flops"]
        self.bytes_accessed += estimate["bytes_accessed"]
        self.transcendentals += estimate["transcendentals"]

    def __enter__(self):
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("a kernel cost harvest is already active")
        _ACTIVE = self
        return self

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = None


def _round_up(n, m):
    return -(-int(n) // m) * m


def _attention(b, h, sq, sk, d, q_size, k_size, v_size, causal):
    # flash_attention.py:382 / flash_attention_packed.py:432 (and :622,
    # causal False): the bytes are the TPU kernel's own 2-byte count
    return {"flops": float(int(4 * b * h * sq * sk * d
                                * (0.5 if causal else 1.0))),
            "bytes_accessed": float(int(2 * (q_size + k_size + v_size
                                             + q_size))),
            "transcendentals": float(int(b * h * sq * sk))}


def _k1(q, k, v, bias=None, causal=False, *args, **kwargs):
    b, sq, h, d = q.shape
    return _attention(b, h, sq, k.shape[1], d, q.numel(), k.numel(),
                      v.numel(), causal)


def _k4(q, k, v, *args, **kwargs):
    b, sq, h, d = q.shape
    return _attention(b, h, sq, k.shape[1], d, q.numel(), k.numel(),
                      v.numel(), False)


def _k5(q, k, v, num_heads, bias=None, causal=False, *args, **kwargs):
    b, sq, width = q.shape
    h = int(num_heads)
    return _attention(b, h, sq, k.shape[1], width // h, q.numel(),
                      k.numel(), v.numel(), causal)


#: fused_ce.py's DEFAULT_BLOCK_N and DEFAULT_BLOCK_V, which pad the tokens
#: and the vocabulary the estimate counts
CE_BLOCK_N, CE_BLOCK_V = 1024, 512


def _k9(x, w, *args, **kwargs):
    n, hdim = x.shape
    np_, vp = _round_up(n, CE_BLOCK_N), _round_up(w.shape[0], CE_BLOCK_V)
    return {"flops": float(int(2 * np_ * vp * hdim)),
            "bytes_accessed": float(int(x.numel() * 2
                                        + (np_ // CE_BLOCK_N) * w.numel() * 2)),
            "transcendentals": float(int(np_ * vp))}


#: kernel id -> estimate from the wrapper's arguments; the Pallas kernels
#: of K2, K3, K6, K7, K8, K10 and K11 carry no CostEstimate
ESTIMATES = {"K1": _k1, "K4": _k4, "K5": _k5, "K9": _k9}


def costed(kernel_id, name=None):
    """Decorate the wrapper of kernel ``kernel_id`` (``"K1"`` ... ``"K11"``):
    inside a harvest it records the launch under ``"<id> <name>"`` (name:
    the wrapper's, by default) with
    :data:`ESTIMATES`' formula for it (None where the Pallas kernel has no
    estimate) and runs without dispatch modes."""
    estimate = ESTIMATES.get(kernel_id)

    def deco(fn):
        label = f"{kernel_id} {name or fn.__name__}"

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            rec = _ACTIVE
            if rec is None:
                return fn(*args, **kwargs)
            from torch.utils._python_dispatch import _disable_current_modes

            rec.add(label, None if estimate is None
                    else estimate(*args, **kwargs))
            with _disable_current_modes():
                return fn(*args, **kwargs)

        return wrapper

    return deco
