"""Length-masked (cached) attention forward: kernel K4 and its plain version.

Port of the cached part of ``paddle_tpu/ops/pallas/flash_attention.py``
(``flash_attention_cached`` / ``_cached_fwd_kernel``). The kernel is
``csrc/flash_attention_cached.cu``; it reads q, k and v in the paddle layout
``(batch, seq, heads, head_dim)`` through their strides, so a cache row
view goes in without a copy.

Key ``j`` attends to query row ``i`` of batch ``b`` iff ``j <= q_pos[b, i]``
and, when ``kv_len`` is given, ``j < kv_len[b]``; a row with no valid key
gives 0. Forward only: serving holds no gradients through the cache, and
on a CUDA tensor the wrapper raises rather than return an output that
autograd cannot see.
"""
from __future__ import annotations

import math

import torch

from ._build import check, dtype_code, library, needs_grad, stream_of

__all__ = ["flash_attention_cached", "flash_attention_cached_plain",
           "supports", "NEG_INF"]

NEG_INF = -1e30
#: head dims the kernel is instantiated for
HEAD_DIMS = (32, 64, 128)
#: the JAX kernel's q/k block preference and lane width, for the CPU gate
_DEFAULT_BLOCK = 1024
_LANES = 128


def _pick_block(seq, pref):
    """Largest lane-aligned block <= pref that divides seq (0 if none) —
    ``paddle_tpu/ops/pallas/flash_attention.py::_pick_block``."""
    b = min(pref, seq)
    b -= b % _LANES
    while b >= _LANES:
        if seq % b == 0:
            return b
        b -= _LANES
    return 0


def supports(seq_q, seq_k):
    """The JAX package's shape gate for its flash kernels, cached and
    layout-swapping alike (``flash_attention.supports`` and
    ``supports_cached``: 128-aligned sequence blocks, a Mosaic tiling
    constraint). The router consults it only on the CPU, to take the route
    the JAX package takes; the CUDA kernel takes any shape."""
    return (_pick_block(seq_q, _DEFAULT_BLOCK) > 0
            and _pick_block(seq_k, _DEFAULT_BLOCK) > 0)


def flash_attention_cached_plain(q, k, v, q_pos, kv_len=None, scale=None):
    """Plain PyTorch version: dense fp32 scores under the length mask."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = q.float().transpose(1, 2)
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * s      # [b,h,sq,sk]
    col = torch.arange(sk, device=q.device, dtype=torch.int32)
    ok = col[None, None, :] <= q_pos.to(torch.int32)[:, :, None]
    if kv_len is not None:
        ok = ok & (col[None, None, :] < kv_len.to(torch.int32)[:, None, None])
    ok = ok[:, None]                                          # [b,1,sq,sk]
    logits = torch.where(ok, logits, NEG_INF)
    m = logits.amax(-1, keepdim=True)
    p = torch.where(ok, torch.exp(logits - m), 0.0)
    l = p.sum(-1, keepdim=True)
    out = torch.matmul(p, vf) / torch.where(l == 0.0, 1.0, l)
    return out.transpose(1, 2).to(q.dtype)


def _check_operand(name, t, dtype):
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, q is {dtype}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name} needs a contiguous head_dim")
    per16 = 16 // t.element_size()
    if t.data_ptr() % 16 or any(st % per16 for st in t.stride()[:3]):
        raise ValueError(f"{name} must be 16-byte aligned in every row "
                         f"(strides {t.stride()})")


def flash_attention_cached(q, k, v, q_pos, kv_len=None, *, scale=None):
    """Length-masked attention over a static-shape KV cache.

    Args:
      q: ``(batch, seq_q, heads, head_dim)``; k, v: ``(batch, seq_k, heads,
        head_dim)`` (full cache buffers or views of them).
      q_pos: int ``(batch, seq_q)`` absolute position of each query row.
      kv_len: optional int ``(batch,)`` exclusive bound of valid key rows.

    CPU tensors take the plain version; CUDA tensors launch kernel K4.
    Returns ``(batch, seq_q, heads, head_dim)`` in q's dtype.
    """
    if q.device.type == "cpu":
        return flash_attention_cached_plain(q, k, v, q_pos, kv_len, scale)
    if q.device.type != "cuda":
        raise ValueError(f"cached attention kernel needs CUDA, got {q.device}")
    if needs_grad(q, k, v):
        raise RuntimeError("flash_attention_cached is forward-only: its "
                           "kernel's output is not recorded by autograd")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if k.shape != (b, sk, h, d) or v.shape != k.shape:
        raise ValueError(f"k/v must be ({b}, seq_k, {h}, {d}); got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"cached attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        _check_operand(name, t, q.dtype)
    if tuple(q_pos.shape) != (b, sq):
        raise ValueError(f"q_pos must be ({b}, {sq}), got {tuple(q_pos.shape)}")
    qp = q_pos.to(device=q.device, dtype=torch.int32).contiguous()
    kl = None
    if kv_len is not None:
        if tuple(kv_len.shape) != (b,):
            raise ValueError(f"kv_len must be ({b},), got {tuple(kv_len.shape)}")
        kl = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    ksplit = 4 if sq <= 8 else 1  # decode/verify: warps split the keys
    check(library().ptt_flash_attention_cached_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
        None if kl is None else kl.data_ptr(), out.data_ptr(),
        b, sq, sk, h, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        float(s), dtype_code(q.dtype), ksplit, stream_of(q)),
        "flash_attention_cached")
    flash_attention_cached.launches += 1
    return out


flash_attention_cached.launches = 0
