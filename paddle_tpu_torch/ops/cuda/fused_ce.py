"""Flash cross-entropy: kernels K9 (forward), K10 (dx) and K11 (dw, db) and
their plain versions.

Port of ``paddle_tpu/ops/pallas/fused_ce.py``, the route
``FLAGS_enable_flash_ce`` sends ``fused_linear_cross_entropy`` to. The
logits ``s = x · wᵀ (+ b)`` are fp32 tiles that never reach device memory:

* K9 (:func:`ce_forward`): online logsumexp over vocab blocks and the label
  logit picked from the fp32 tile; ``loss = lse - s[y]``, both fp32.
* K10 (:func:`ce_backward_dx`): recomputes each tile, ``dl = (exp(s - lse)
  - onehot(y)) · g`` in fp32, cast to ``w.dtype``; ``dx = dl · w`` with
  fp32 accumulation, in ``x.dtype``.
* K11 (:func:`ce_backward_dw`): the same ``dl`` cast to ``x.dtype``;
  ``dw = dlᵀ · x`` with fp32 accumulation, in ``w.dtype``, and ``db`` summed
  from the fp32 ``dl``.

The plain versions follow the kernels' math (not the chunked loop's row
gather) over token chunks, so they also run at full width. Labels must lie
in ``[0, vocab)`` (the router passes ``ignore_index`` rows as label 0 and
zeroes their ``g``). x and w may differ in dtype (bf16 against fp32, as
``amp.auto_cast`` can give): both are widened to fp32, which is exact and is
what JAX's ``dot_general`` promotion computes, and ``dl`` is still rounded
to the narrower operand's type where the reference casts it so. The kernels
take fp32, bf16 and fp16 operands and every hidden size the JAX gate admits
(a multiple of 128): up to 1024 the token (or vocab) block stays in shared
memory, above that the hidden width streams through it in 256-column
chunks.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel (``csrc/fused_ce.cu``) or raises. The raw launchers
raise when autograd is asked to record them: :func:`flash_linear_cross_entropy`
is the differentiable entry, an ``autograd.Function`` over K9, K10 and K11.
"""
from __future__ import annotations

import torch

from ._build import check, dtype_code, library, needs_grad, stream_of

__all__ = ["flash_linear_cross_entropy", "ce_forward", "ce_forward_plain",
           "ce_backward_dx", "ce_backward_dx_plain", "ce_backward_dw",
           "ce_backward_dw_plain", "mm_f32", "supports", "LANES"]

#: the JAX gate's lane width (``fused_ce.supports``)
LANES = 128
#: token chunk of the plain versions (a [2048, vocab] fp32 tile at a time)
_PLAIN_CHUNK = 2048
#: dl's rounding on the fp32 path (csrc/fused_ce.cu ``round_dl``)
_ROUND_DL = {torch.bfloat16: 1, torch.float16: 2}


def supports(hidden_size):
    """The routing gate of the JAX package (``fused_ce.supports``)."""
    return hidden_size % LANES == 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def mm_f32(a, b):
    """``a @ b`` with an fp32 result and fp32 accumulation; operands of two
    dtypes are both widened to fp32 first (JAX's promotion)."""
    if a.dtype != b.dtype:
        a, b = a.float(), b.float()
    if a.dtype == torch.float32:
        return torch.mm(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _logits(x_c, w, b):
    s = mm_f32(x_c, w.t())
    return s if b is None else s + b.float()


def _dl(x_c, w, b, y_c, g_c, lse_c):
    """fp32 ``(softmax - onehot) · g`` of one token chunk."""
    dl = torch.exp(_logits(x_c, w, b) - lse_c[:, None])
    dl[torch.arange(x_c.shape[0], device=dl.device), y_c.long()] -= 1.0
    return dl * g_c[:, None]


def ce_forward_plain(x, w, b, y):
    """Plain version of K9: ``(loss, lse)``, fp32 ``[tokens]``."""
    n = x.shape[0]
    loss = torch.empty(n, dtype=torch.float32, device=x.device)
    lse = torch.empty_like(loss)
    for c0 in range(0, n, _PLAIN_CHUNK):
        s = _logits(x[c0:c0 + _PLAIN_CHUNK], w, b)
        m = s.amax(-1)
        l = m + torch.log(torch.exp(s - m[:, None]).sum(-1))
        picked = s.gather(1, y[c0:c0 + _PLAIN_CHUNK, None].long())[:, 0]
        lse[c0:c0 + _PLAIN_CHUNK] = l
        loss[c0:c0 + _PLAIN_CHUNK] = l - picked
    return loss, lse


def ce_backward_dx_plain(x, w, b, y, g, lse):
    """Plain version of K10: ``dx`` in ``x.dtype``."""
    dx = torch.empty_like(x)
    for c0 in range(0, x.shape[0], _PLAIN_CHUNK):
        sl = slice(c0, c0 + _PLAIN_CHUNK)
        dl = _dl(x[sl], w, b, y[sl], g[sl], lse[sl])
        dx[sl] = mm_f32(dl.to(w.dtype), w).to(x.dtype)
    return dx


def ce_backward_dw_plain(x, w, b, y, g, lse):
    """Plain version of K11: ``(dw, db)``; dw in ``w.dtype``, db fp32 (None
    without a bias)."""
    dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
    db = None if b is None else torch.zeros(w.shape[0], dtype=torch.float32,
                                            device=w.device)
    for c0 in range(0, x.shape[0], _PLAIN_CHUNK):
        sl = slice(c0, c0 + _PLAIN_CHUNK)
        dl = _dl(x[sl], w, b, y[sl], g[sl], lse[sl])
        dw += mm_f32(dl.to(x.dtype).t(), x[sl])
        if db is not None:
            db += dl.sum(0)
    return dw.to(w.dtype), db


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _aligned(t):
    """``t`` contiguous at a 16-byte aligned address (the kernels' cp.async
    copies move 16 bytes)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _operands(what, x, w, b, y, *per_token):
    """Validate a K9-K11 launch; returns the operands as the kernel takes
    them (one dtype: fp32 when x and w differ), contiguous and aligned."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} kernel needs a CUDA tensor, got {x.device}")
    if needs_grad(x, w, b):
        raise RuntimeError(
            f"{what}: the kernel's output is not recorded by autograd; call "
            "flash_linear_cross_entropy, which differentiates through K9-K11")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} must be "
                         "[tokens, hidden] and [vocab, hidden]")
    n, h = x.shape
    v = w.shape[0]
    if not supports(h):
        raise ValueError(f"{what} kernel takes hidden sizes that are multiples "
                         f"of {LANES}, got {h}")
    for t in (w, b, y, *per_token):
        if t is not None and t.device != x.device:
            raise ValueError(f"{what}: all operands must be on {x.device}")
    dtype_code(x.dtype)
    dtype_code(w.dtype)
    if x.dtype != w.dtype:
        x, w = x.float(), w.float()
    if b is not None:
        if b.shape != (v,):
            raise ValueError(f"bias must be ({v},), got {tuple(b.shape)}")
        b = _aligned(b.float())
    if y.shape != (n,):
        raise ValueError(f"labels must be ({n},), got {tuple(y.shape)}")
    per_token = [_aligned(t.float()) for t in per_token]
    for t in per_token:
        if t.shape != (n,):
            raise ValueError(f"per-token operands must be ({n},), got "
                             f"{tuple(t.shape)}")
    return (_aligned(x), _aligned(w), b, _aligned(y.to(torch.int32)),
            *per_token)


def _ptr(t):
    return None if t is None else t.data_ptr()


def ce_forward(x, w, b, y):
    """K9: ``(loss, lse)`` of ``cross_entropy(x · wᵀ + b, y)`` per token,
    fp32. CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return ce_forward_plain(x, w, b, y)
    xk, wk, bk, yk = _operands("fused_ce_fwd", x, w, b, y)
    n, h = xk.shape
    loss = torch.empty(n, dtype=torch.float32, device=x.device)
    lse = torch.empty_like(loss)
    if n == 0:
        return loss, lse
    check(library().ptt_fused_ce_fwd(
        xk.data_ptr(), wk.data_ptr(), _ptr(bk), yk.data_ptr(),
        loss.data_ptr(), lse.data_ptr(), n, wk.shape[0], h,
        dtype_code(xk.dtype), stream_of(xk)), "fused_ce_fwd")
    ce_forward.launches += 1
    return loss, lse


def _bwd(what, mode, x, w, b, y, g, lse, round_to):
    xk, wk, bk, yk, gk, lk = _operands(what, x, w, b, y, g, lse)
    n, h = xk.shape
    v = wk.shape[0]
    rows = n if mode == 0 else v
    out = torch.empty((rows, h), dtype=xk.dtype, device=x.device)
    db = (torch.empty(v, dtype=torch.float32, device=x.device)
          if mode == 1 and bk is not None else None)
    if n == 0:
        out.zero_()
        if db is not None:
            db.zero_()
        return out, db
    # dl is rounded to the narrower operand's type when the operands were
    # widened to fp32 (the reference casts dl to w.dtype for dx, x.dtype for dw)
    round_dl = _ROUND_DL.get(round_to, 0) if xk.dtype == torch.float32 else 0
    check(library().ptt_fused_ce_bwd(
        xk.data_ptr(), wk.data_ptr(), _ptr(bk), yk.data_ptr(), gk.data_ptr(),
        lk.data_ptr(), out.data_ptr(), _ptr(db), n, v, h, mode, round_dl,
        dtype_code(xk.dtype), stream_of(xk)), what)
    return out, db


def ce_backward_dx(x, w, b, y, g, lse):
    """K10: ``dx`` in ``x.dtype``. ``g`` is the per-token upstream gradient
    (already 0 at ignored labels). CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return ce_backward_dx_plain(x, w, b, y, g, lse)
    dx, _ = _bwd("fused_ce_dx", 0, x, w, b, y, g, lse, w.dtype)
    if x.shape[0]:
        ce_backward_dx.launches += 1
    return dx.to(x.dtype)


def ce_backward_dw(x, w, b, y, g, lse):
    """K11: ``(dw, db)``; dw in ``w.dtype``, db fp32 (None without a
    bias). CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return ce_backward_dw_plain(x, w, b, y, g, lse)
    dw, db = _bwd("fused_ce_dw", 1, x, w, b, y, g, lse, x.dtype)
    if x.shape[0]:
        ce_backward_dw.launches += 1
    return dw.to(w.dtype), db


ce_forward.launches = 0
ce_backward_dx.launches = 0
ce_backward_dw.launches = 0


class _FlashCE(torch.autograd.Function):
    """K9 forward, K10/K11 backward; saves x, w, b, the labels, the ignored
    mask and the fp32 logsumexp."""

    @staticmethod
    def forward(ctx, h, w, b, safe, ignored):
        losses, lse = ce_forward(h, w, b, safe)
        ctx.save_for_backward(h, w, b, safe, ignored, lse)
        return torch.where(ignored, 0.0, losses)

    @staticmethod
    def backward(ctx, g):
        h, w, b, safe, ignored, lse = ctx.saved_tensors
        g = torch.where(ignored, 0.0, g.float())
        dh = dw = db = None
        if ctx.needs_input_grad[0]:
            dh = ce_backward_dx(h, w, b, safe, g, lse)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = ce_backward_dw(h, w, b, safe, g, lse)
        return dh, dw, db, None, None


def flash_linear_cross_entropy(h, w, b, safe, ignored):
    """Per-token losses of ``cross_entropy(h · wᵀ + b, safe)``, zero where
    ``ignored``; differentiable in h, w and b. ``h`` is ``[tokens,
    hidden]``, ``w`` ``[vocab, hidden]``, ``b`` fp32 ``[vocab]`` or None,
    ``safe`` labels in ``[0, vocab)``."""
    return _FlashCE.apply(h, w, b, safe, ignored)
