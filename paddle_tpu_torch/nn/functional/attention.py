"""Attention functionals — port of ``paddle_tpu/nn/functional/attention.py``.

Five paths, as in the JAX package:

* the cached-attention kernel K4 (``ops/cuda/flash_attention.py``) for
  :class:`LengthMask` calls (forward only);
* the packed flash kernels K5/K6 (``ops/cuda/flash_attention_packed.py``)
  for uncached attention, differentiable;
* the layout-swapping flash kernels K1-K3 (``ops/cuda/flash_attention.py``)
  for the uncached calls the packed kernels do not take, differentiable
  (a trainable mask too);
* a blockwise online-softmax loop over KV blocks (``_sdpa_blockwise``) that
  never builds the ``[b, h, q, sk]`` score matrix, with a custom backward
  that recomputes tiles from the saved logsumexp;
* the dense path (``_sdpa_raw``: matmul + softmax, causal by iota compare).

Routing of a LengthMask call:

* **CUDA** — every call goes to K4: prefill, chunked prefill, decode and
  verify. K4 computes exactly what the blockwise and dense paths compute
  under a LengthMask; the JAX package's split between them rests on a
  Mosaic tiling constraint (128-aligned blocks) and a crossover measured on
  a TPU, neither of which holds on this card.
* **CPU** — the route the JAX package takes with its Pallas kernels
  available (the interpret mode its CPU tests use): at least
  ``blockwise_attention_min_kv`` keys and 128-aligned sequence dims call
  K4's wrapper, which runs the plain version on a CPU tensor; other calls
  with enough keys run the blockwise loop; shorter ones the dense path.

Routing of an uncached call (``_flash_ok`` / ``_sdpa_flash``):

* **CUDA** — at ``sq * sk >= flash_attention_min_seq_prod`` with a mask
  the kernels stream exactly (none, ``(sq, sk)`` or ``(B|1, H|1, sq, sk)``),
  any sequence length: K5/K6 when the mask is absent or a constant shared
  2-D one and the head dim is in K5's ``HEAD_DIMS`` — every call JAX sends
  to its packed kernel, without the Mosaic constraints (128-aligned blocks,
  128-lane head groups, the dq slab cap); every other call (a 4-D or
  trainable mask, another head dim such as GPT-3 Large's 96) K1-K3, as JAX
  sends it to its layout-swapping kernel, without the 128 alignment.
  Attention dropout in training runs inside those kernels from a Philox
  keep-mask keyed by two words of :func:`~paddle_tpu_torch.framework.random.next_seed_words`,
  as JAX's kernels draw theirs from the TPU PRNG; with a trainable mask it
  takes the dense path, as in JAX.
* **CPU** — JAX's route under interpret mode (which skips the min-seq-prod
  crossover): 128-aligned sequence dims take the packed wrapper when
  ``flash_attention_packed.supports`` holds and the K1-K3 wrapper
  otherwise (their plain versions on a CPU tensor, which zero a row with no
  visible key as the JAX kernels do).
  Attention dropout in training takes no flash route on the CPU (JAX's
  interpret mode has no lowering of its in-kernel PRNG).
* Anything else (a ``(b, 1, 1, s)`` padding bias, a short or unaligned
  call) runs the blockwise loop (long causal calls without a mask) or the
  dense path, as in JAX.

Attention dropout on the dense path (any call with dropout in training that
no flash kernel takes, LengthMask calls included, on either device) drops
the softmax output with a ``[b, h, sq, sk]`` keep-mask drawn by
``torch.bernoulli`` from the port's generator of the tensors' device, where
JAX draws ``jax.random.bernoulli``.
"""
from __future__ import annotations

import math

import torch

from ...amp.auto_cast import cast_inputs as _amp_cast
from ...framework import random as rnd
from ...framework.flags import flag_value
from ...ops.cuda import flash_attention as _fa
from ...ops.cuda import flash_attention_packed as _fp

__all__ = ["LengthMask", "scaled_dot_product_attention", "NEG_INF"]

#: additive-mask floor shared with serving.kv_cache.MASK_MIN
NEG_INF = -1e30


class LengthMask:
    """Compact validity descriptor for cached (length-masked) attention.

    Key slot ``j`` attends to query row ``i`` of batch ``b`` iff
    ``j <= q_pos[b, i]`` and, when ``kv_len`` is given, ``j < kv_len[b]``.
    ``q_pos`` is int32 ``[batch, q]``; ``kv_len`` is int32 ``[batch]``.
    """

    __slots__ = ("q_pos", "kv_len")

    def __init__(self, q_pos, kv_len=None):
        self.q_pos = torch.as_tensor(q_pos).to(torch.int32)
        self.kv_len = (None if kv_len is None
                       else torch.as_tensor(kv_len).to(torch.int32))

    def valid(self, sk):
        """Boolean ``[b, 1, q, sk]`` validity (broadcasts over heads)."""
        col = torch.arange(sk, dtype=torch.int32, device=self.q_pos.device)
        ok = col[None, None, None, :] <= self.q_pos[:, None, :, None]
        if self.kv_len is not None:
            ok = ok & (col[None, None, None, :]
                       < self.kv_len[:, None, None, None])
        return ok

    def additive(self, sk, dtype, mask_min=-1e9):
        """Dense additive mask in ``dtype`` — the short-sequence path."""
        return torch.where(self.valid(sk), torch.zeros((), dtype=dtype),
                           torch.full((), mask_min, dtype=dtype))


def _pick_block(n, pref):
    """Largest divisor of ``n`` that is <= ``pref`` (no padding)."""
    for c in range(min(int(pref), n), 0, -1):
        if n % c == 0:
            return c
    return 1


# ---------------------------------------------------------------------------
# blockwise online-softmax loop
# ---------------------------------------------------------------------------
def _valid(q_pos, kv_len, b0, n):
    """``[b, 1, sq, n]`` validity of keys ``b0 .. b0 + n`` (LengthMask)."""
    col = b0 + torch.arange(n, dtype=torch.int32, device=q_pos.device)
    ok = col <= q_pos.to(torch.int32)[:, None, :, None]
    if kv_len is not None:
        ok = ok & (col < kv_len.to(torch.int32)[:, None, None, None])
    return ok


def _bw_fwd(q, k, v, q_pos, kv_len, scale, block_k):
    """Forward loop over KV blocks: ``(out, lse)``. Carry: running (max,
    denom, acc) per query row; the only block-wide temporary is the
    ``[b, h, sq, block_k]`` score tile of the current block."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qf = q.transpose(1, 2).float() * scale                   # [b,h,sq,d]
    kf = k.transpose(1, 2).float()
    vf = v.transpose(1, 2).float()
    m = torch.full((b, h, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, h, sq), device=q.device)
    acc = torch.zeros((b, h, sq, d), device=q.device)
    for b0 in range(0, sk, block_k):
        kb = kf[:, :, b0:b0 + block_k]
        vb = vf[:, :, b0:b0 + block_k]
        ok = _valid(q_pos, kv_len, b0, kb.shape[2])
        s_ = torch.where(ok, torch.matmul(qf, kb.transpose(-1, -2)), NEG_INF)
        m_new = torch.maximum(m, s_.amax(-1))
        # masked entries must contribute 0 even when the whole row is masked
        # so far (m_new == NEG_INF would make exp(s - m_new) = 1)
        p = torch.where(ok, torch.exp(s_ - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.matmul(p, vb)
        m = m_new
    lse = m + torch.log(torch.clamp_min(l, 1e-30))
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype), lse


def _bw_bwd(q, k, v, q_pos, kv_len, out, lse, g, scale, block_q, block_k):
    """FlashAttention-2 recurrence: dq loops over K blocks, dk/dv over Q
    blocks; every score tile is recomputed from the saved logsumexp, so
    nothing O(sq·sk) is live."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qf, kf, vf, gf, of = (t.transpose(1, 2).float()
                          for t in (q, k, v, g, out))
    delta = (of * gf).sum(-1)                                 # [b,h,sq]
    dq = torch.zeros((b, h, sq, d), device=q.device)
    for b0 in range(0, sk, block_k):
        kb, vb = kf[:, :, b0:b0 + block_k], vf[:, :, b0:b0 + block_k]
        s_ = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        ok = _valid(q_pos, kv_len, b0, kb.shape[2])
        p = torch.where(ok, torch.exp(s_ - lse[..., None]), 0.0)
        ds = p * (torch.matmul(gf, vb.transpose(-1, -2)) - delta[..., None])
        dq = dq + torch.matmul(ds, kb) * scale
    dk = torch.zeros((b, h, sk, d), device=q.device)
    dv = torch.zeros((b, h, sk, d), device=q.device)
    for q0 in range(0, sq, block_q):
        qb, gb = qf[:, :, q0:q0 + block_q], gf[:, :, q0:q0 + block_q]
        s_ = torch.matmul(qb, kf.transpose(-1, -2)) * scale
        ok = _valid(q_pos[:, q0:q0 + block_q], kv_len, 0, sk)
        p = torch.where(ok, torch.exp(s_ - lse[:, :, q0:q0 + block_q, None]),
                        0.0)
        dv = dv + torch.matmul(p.transpose(-1, -2), gb)
        ds = p * (torch.matmul(gb, vf.transpose(-1, -2))
                  - delta[:, :, q0:q0 + block_q, None])
        dk = dk + torch.matmul(ds.transpose(-1, -2), qb) * scale

    def back(x, dt):
        return x.transpose(1, 2).to(dt)

    return back(dq, q.dtype), back(dk, k.dtype), back(dv, v.dtype)


class _Blockwise(torch.autograd.Function):
    """The custom vjp of the JAX ``_blockwise``: autograd through the
    forward loop would keep every block's probability tile (O(sq·sk))."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_len, scale, block_q, block_k):
        out, lse = _bw_fwd(q, k, v, q_pos, kv_len, scale, block_k)
        ctx.save_for_backward(q, k, v, q_pos, kv_len, out, lse)
        ctx.args = (scale, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, q_pos, kv_len, out, lse = ctx.saved_tensors
        dq, dk, dv = _bw_bwd(q, k, v, q_pos, kv_len, out, lse, g, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def _sdpa_blockwise(q, k, v, q_pos, kv_len=None, scale=None, block_q=0,
                    block_k=0):
    """Blockwise online-softmax attention (q, k, v in paddle (b, s, h, d)
    layout). ``q_pos``/``kv_len`` follow :class:`LengthMask` semantics.
    The forward loop tiles KV; the backward tiles Q by ``block_q`` too."""
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    bk = block_k or _pick_block(k.shape[1], 512)
    bq = block_q or _pick_block(q.shape[1], 512)
    return _Blockwise.apply(q, k, v, q_pos, kv_len, s, bq, bk)


def _blockwise_ok(q_shape, k_shape, dropout_p, training):
    """No attention dropout and at least ``blockwise_attention_min_kv`` key
    slots."""
    if flag_value("disable_blockwise_attention"):
        return False
    if dropout_p > 0.0 and training:
        return False
    return k_shape[1] >= flag_value("blockwise_attention_min_kv")


def _blockwise_blocks(sq, sk):
    bq = _pick_block(sq, flag_value("blockwise_attention_block_q") or 512)
    bk = _pick_block(sk, flag_value("blockwise_attention_block_k") or 512)
    return bq, bk


def _keep_mask(query, key, p):
    """The dense path's ``[b, h, sq, sk]`` bool keep-mask: kept with
    probability ``1 - p``, from the port's generator of the device."""
    b, sq, h, _ = query.shape
    probs = torch.full((b, h, sq, key.shape[1]), 1.0 - p,
                       device=query.device)
    return torch.bernoulli(probs, generator=rnd.generator(query.device)).bool()


def _route_length_masked(query, key, value, lm, dropout_p, training, scale):
    """Cached-attention routing (see the module docstring); with dropout in
    training the dense path on either device, as ``_blockwise_ok`` sends it
    there in JAX."""
    b, sq, h, d = query.shape
    sk = key.shape[1]
    active_p = dropout_p if training else 0.0
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    if query.device.type == "cuda" and active_p == 0.0:
        return _fa.flash_attention_cached(query, key, value, lm.q_pos,
                                          lm.kv_len, scale=s)
    if _blockwise_ok(query.shape, key.shape, dropout_p, training):
        if _fa.supports(sq, sk):
            return _fa.flash_attention_cached(query, key, value, lm.q_pos,
                                              lm.kv_len, scale=s)
        bq, bk = _blockwise_blocks(sq, sk)
        return _sdpa_blockwise(query, key, value, lm.q_pos, lm.kv_len,
                               scale=s, block_q=bq, block_k=bk)
    mask = lm.additive(sk, query.dtype)
    keep = _keep_mask(query, key, active_p) if active_p > 0.0 else None
    return _sdpa_raw(query, key, value, mask, keep, causal=False, scale=scale,
                     dropout_p=active_p)


def _flash_ok(q_shape, k_shape, mask, on_cuda, dropout_p=0.0, training=False,
              mask_trainable=False):
    """Where the JAX package runs a flash kernel (``_flash_ok`` with Pallas
    available): enabled, a mask the kernels stream exactly (trailing dims
    ``(sq, sk)``, broadcastable batch/head dims), and — on CUDA — at least
    ``flash_attention_min_seq_prod`` score entries; on the CPU (interpret
    mode, which skips that crossover) 128-aligned sequence dims
    (``flash_attention.supports``). With attention dropout in training, as
    in JAX, no flash route on the CPU (interpret mode) and none with a
    trainable mask (its gradient cannot regenerate the in-kernel mask)."""
    if flag_value("disable_flash_attention"):
        return False
    if dropout_p > 0.0 and training and (not on_cuda or mask_trainable):
        return False
    sq, sk = q_shape[1], k_shape[1]
    if on_cuda and sq * sk < flag_value("flash_attention_min_seq_prod"):
        return False
    if mask is not None:
        ms = tuple(mask.shape)
        if len(ms) == 4:
            if ms[2:] != (sq, sk):
                return False
            if ms[0] not in (1, q_shape[0]) or ms[1] not in (1, q_shape[2]):
                return False
        elif ms != (sq, sk):
            return False
    return on_cuda or _fa.supports(sq, sk)


def _sdpa_flash(q, k, v, mask=None, causal=False, scale=None,
                mask_trainable=False, dropout_p=0.0, dropout_seed=None):
    """q, k, v: ``(batch, seq, heads, head_dim)``. The packed kernels take
    the ``(b, s, h·d)`` reshape of the qkv projection's views (strides
    ``(s·3hd, 3hd, 1)``: no copy) when the mask is absent or a constant
    shared 2-D one; every other call takes K1-K3, which read the views
    through their strides. ``dropout_seed`` keys the kernels' dropout mask.
    See the module docstring."""
    q, k, v, mask = _amp_cast("flash_sdpa", q, k, v, mask)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    packed = mask is None or (mask.ndim == 2 and not mask_trainable)
    if q.device.type == "cuda":
        packed = packed and d in _fp.HEAD_DIMS
    else:
        packed = packed and _fp.supports(sq, sk, h, h * d)
    if packed:
        out = _fp.flash_attention_packed(
            q.reshape(b, sq, h * d), k.reshape(b, sk, h * d),
            v.reshape(b, sk, h * d), h, bias=mask, causal=causal,
            scale=scale, dropout_p=dropout_p, dropout_seed=dropout_seed)
        return out.reshape(b, sq, h, d)
    return _fa.flash_attention(q, k, v, bias=mask, causal=causal,
                               scale=scale, bias_grad=mask_trainable,
                               dropout_p=dropout_p, dropout_seed=dropout_seed)


def _sdpa_raw(q, k, v, mask=None, dropout_mask=None, causal=False,
              scale=None, dropout_p=0.0):
    """Dense path: matmul + softmax in the input dtype (small shapes).
    ``dropout_mask`` is a keep-mask drawn by the caller, as in JAX: the
    kept probabilities are scaled by ``1 / (1 - dropout_p)``."""
    q, k, v, mask = _amp_cast("sdpa", q, k, v, mask)
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * s
    if causal:
        # iota compare, bottom-right aligned as in the JAX package
        ql, kl = logits.shape[-2], logits.shape[-1]
        row = torch.arange(ql, device=q.device)[:, None]
        col = torch.arange(kl, device=q.device)[None, :]
        logits = torch.where(col - row <= kl - ql, logits,
                             torch.full((), NEG_INF, dtype=logits.dtype,
                                        device=q.device))
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = torch.where(mask, logits, -1e30)
        else:
            logits = logits + mask
    probs = torch.softmax(logits, dim=-1)
    if dropout_mask is not None:
        probs = probs * dropout_mask.to(probs.dtype) / (1.0 - dropout_p)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _sdpa(query, key, value, attn_mask=None, dropout_p=0.0, is_causal=False,
          training=True, scale=None):
    if isinstance(attn_mask, LengthMask):
        return _route_length_masked(query, key, value, attn_mask, dropout_p,
                                    training, scale)
    trainable = attn_mask is not None and attn_mask.requires_grad
    if _flash_ok(query.shape, key.shape, attn_mask,
                 query.device.type == "cuda", dropout_p, training, trainable):
        active_p = dropout_p if training else 0.0
        # two 32-bit words key the kernels' dropout mask
        seed = rnd.next_seed_words(query.device) if active_p > 0.0 else None
        return _sdpa_flash(query, key, value, attn_mask, causal=is_causal,
                           scale=scale, mask_trainable=trainable,
                           dropout_p=active_p, dropout_seed=seed)
    if (attn_mask is None and is_causal
            and _blockwise_ok(query.shape, key.shape, dropout_p, training)):
        # long causal attention without the flash kernel: blockwise loop
        # instead of the O(seq²) score matrix
        b, sq, _, d = query.shape
        sk = key.shape[1]
        s = scale if scale is not None else 1.0 / math.sqrt(d)
        q_pos = torch.arange(sk - sq, sk, dtype=torch.int32,
                             device=query.device)[None, :].expand(b, sq)
        bq, bk = _blockwise_blocks(sq, sk)
        return _sdpa_blockwise(query, key, value, q_pos, None, scale=s,
                               block_q=bq, block_k=bk)
    keep = None
    if dropout_p > 0.0 and training:
        keep = _keep_mask(query, key, dropout_p)
    return _sdpa_raw(query, key, value, attn_mask, keep, causal=is_causal,
                     scale=scale, dropout_p=dropout_p)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """q, k, v: ``(batch, seq, heads, head_dim)`` (paddle layout)."""
    return _sdpa(query, key, value, attn_mask, dropout_p, is_causal,
                 training)
