"""Fused LM head + softmax cross-entropy — port of ``paddle_tpu/ops/fused.py``.

``fused_linear_cross_entropy(h, w, labels)`` is ``cross_entropy(h @ w.T + b,
labels)`` without the ``[tokens, vocab]`` logits: an ``autograd.Function``
over token chunks (``_pick_chunk``) whose forward keeps one fp32 logsumexp a
token and whose backward recomputes each chunk's logits from it. Only one
chunk's logits are live at a time.

This is the JAX package's default route on hardware, the chunked scan: its
products run outside any Pallas kernel, so here they are ``torch`` matrix
products. The casts are JAX's: logits and the dw accumulator are fp32
(``preferred_element_type``), the label logit is a row gather of ``w`` plus
a row dot, ``dl`` is cast to ``w.dtype`` before ``dh = dl @ w``, and
``ignore_index`` zeroes both the loss and the gradient. The opt-in Pallas
route (``FLAGS_enable_flash_ce``, kernels K9–K11) is not ported yet: on CUDA
the flag raises, on the CPU the chunked loop runs.
"""
from __future__ import annotations

import torch

from ..framework.flags import flag_value

__all__ = ["fused_linear_cross_entropy"]

_FLASH_CE = ("FLAGS_enable_flash_ce routes the loss to the Pallas flash-CE "
             "kernels K9-K11, which belong to the next slice of the port")


def _pick_chunk(tokens):
    """Largest power-of-two chunk <= 2048 that fits the token count (the
    JAX package's choice, swept on its TPU)."""
    for c in (2048, 1024, 512, 256, 128):
        if tokens >= c:
            return c
    return tokens


def _mm_f32(a, b):
    """``a @ b`` with an fp32 result, as ``jnp.dot(...,
    preferred_element_type=float32)``: low-precision operands keep their type
    (fp32 accumulation) on the card and are widened on the CPU."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.mm(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _chunk_logits(h_c, w, b):
    logits = _mm_f32(h_c, w.t())
    return logits if b is None else logits + b


class _FusedLinearCE(torch.autograd.Function):
    """Per-token losses of the fused head; saves h, w, b, the labels and
    the fp32 logsumexp."""

    @staticmethod
    def forward(ctx, h, w, b, labels, ignore_index, chunk):
        tokens = h.shape[0]
        chunk = chunk or _pick_chunk(tokens)
        ignored = labels == ignore_index
        safe = torch.where(ignored, 0, labels)
        lse = torch.empty(tokens, dtype=torch.float32, device=h.device)
        for c0 in range(0, tokens, chunk):
            logits = _chunk_logits(h[c0:c0 + chunk], w, b)
            m = logits.amax(-1)
            lse[c0:c0 + chunk] = m + torch.log(
                torch.exp(logits - m[:, None]).sum(-1))
        # the label logit is a row gather of w plus a row dot, never a
        # one-hot pass over the logits
        picked = (h.float() * w[safe].float()).sum(-1)
        if b is not None:
            picked = picked + b[safe]
        losses = torch.where(ignored, 0.0, lse - picked)
        ctx.save_for_backward(h, w, b, safe, ignored, lse)
        ctx.chunk = chunk
        return losses

    @staticmethod
    def backward(ctx, g):
        h, w, b, safe, ignored, lse = ctx.saved_tensors
        g = torch.where(ignored, 0.0, g.float())
        dh = torch.empty_like(h)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        db = None if b is None else torch.zeros_like(b)
        for c0 in range(0, h.shape[0], ctx.chunk):
            h_c = h[c0:c0 + ctx.chunk]
            n = h_c.shape[0]
            dl = torch.exp(_chunk_logits(h_c, w, b) - lse[c0:c0 + n, None])
            dl[torch.arange(n, device=h.device), safe[c0:c0 + n]] -= 1.0
            dl = (dl * g[c0:c0 + n, None]).to(w.dtype)          # [C, V]
            dh[c0:c0 + n] = torch.mm(dl, w).to(h.dtype)
            dw += _mm_f32(dl.t(), h_c)
            if db is not None:
                db += dl.float().sum(0)
        return dh, dw.to(w.dtype), db, None, None, None


def fused_linear_cross_entropy(hidden, weight, labels, bias=None,
                               ignore_index=-100, reduction="mean", chunk=0):
    """``cross_entropy(hidden @ weight.T + bias, labels)`` without
    materializing the logits.

    Args:
        hidden: ``[..., hidden_size]`` activations (bf16/fp32).
        weight: ``[vocab, hidden_size]`` LM head / tied embedding weight.
        labels: integer class ids, shape ``hidden.shape[:-1]``.
        bias: optional ``[vocab]`` LM-head bias.
        ignore_index: label value excluded from the loss and the mean.
        reduction: ``"mean" | "sum" | "none"``.
        chunk: token-chunk size (0 = auto).
    """
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be mean, sum or none: {reduction!r}")
    if flag_value("enable_flash_ce") and hidden.device.type == "cuda":
        raise NotImplementedError(_FLASH_CE)
    labels = torch.as_tensor(labels, device=hidden.device)
    h2 = hidden.reshape(-1, hidden.shape[-1])
    y = labels.reshape(-1).long()
    if y.shape[0] != h2.shape[0]:
        raise ValueError(f"labels {tuple(labels.shape)} do not match hidden "
                         f"{tuple(hidden.shape)}")
    b = None if bias is None else bias.float()
    losses = _FusedLinearCE.apply(h2, weight, b, y, int(ignore_index),
                                  int(chunk))
    if reduction == "none":
        return losses.reshape(labels.shape)
    total = losses.sum()
    if reduction == "sum":
        return total
    valid = (y != ignore_index).sum().float()
    return total / torch.clamp_min(valid, 1.0)
