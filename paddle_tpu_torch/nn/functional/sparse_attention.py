"""``sparse_attention`` — port of
``paddle_tpu/nn/functional/sparse_attention.py``: attention whose softmax
runs over each query row's CSR-listed key positions only.

As in the JAX package it is not a kernel: the CSR pattern (``offset``
``[B, H, S + 1]`` row starts, ``columns`` ``[B, H, NNZ]``) becomes a dense
``[B, H, S, S]`` mask (here by one scatter of the listed positions, where
the JAX package compares every nonzero with every row and column), and the
scores outside it are ``finfo(float32).min`` before a softmax that gives
them zero weight. ``key_padding_mask`` (``[B, S]``, 0 drops a key) and an
additive ``attn_mask`` are taken as in the JAX package. Plain PyTorch
products, no library attention kernel; autograd differentiates it.
"""
from __future__ import annotations

import math

import torch

from ...ops.dispatch import apply_op

__all__ = ["sparse_attention"]


def _csr_mask(offset, cols, s):
    """``[B, H, S, S]`` booleans: ``(i, j)`` set where row ``i`` lists
    ``j``."""
    b, h, nnz = cols.shape
    t = torch.arange(nnz, device=cols.device).expand(b, h, nnz).contiguous()
    # the row of each nonzero: the last row start at or before it
    row = torch.searchsorted(offset[..., 1:].contiguous().long(), t,
                             right=True)
    live = row < s
    flat = torch.where(live, row * s + cols.long(), torch.zeros_like(t))
    mask = torch.zeros(b, h, s * s, dtype=torch.bool, device=cols.device)
    mask.scatter_(2, flat, live)
    return mask.reshape(b, h, s, s)


def _sparse_attention_raw(q, k, v, offset, cols, kpm=None, am=None):
    s, d = q.shape[-2], q.shape[-1]
    allowed = _csr_mask(offset, cols, s)
    scores = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    neg = torch.tensor(torch.finfo(torch.float32).min, dtype=scores.dtype,
                       device=scores.device)
    scores = torch.where(allowed, scores, neg)
    if kpm is not None:
        scores = torch.where(kpm[:, None, None, :].bool(), scores, neg)
    if am is not None:
        scores = scores + am
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    p = torch.where(allowed, p, torch.zeros_like(p))
    p = p / torch.clamp_min(p.sum(-1, keepdim=True), 1e-20)
    return torch.matmul(p, v)


def sparse_attention(query, key, value, sparse_csr_offset, sparse_csr_columns,
                     key_padding_mask=None, attn_mask=None, name=None):
    """``softmax(q k^T / sqrt(d))`` over the CSR pattern, times ``v``;
    ``query``/``key``/``value`` ``[B, H, S, D]``."""
    args = [query, key, value, sparse_csr_offset, sparse_csr_columns]
    return apply_op("sparse_attention", lambda *a, kpm=None, am=None:
                    _sparse_attention_raw(*a, kpm=kpm, am=am), tuple(args),
                    {"kpm": key_padding_mask, "am": attn_mask})
