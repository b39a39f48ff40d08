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
(a multiple of 128). :func:`kernel_plan` names each kernel's route for a
call. K9 at bf16/fp16: a warp-specialised kernel (TMA ring, wgmma
m64n256k16) over stripes of 128 tokens and 256-column vocab tiles, the
logsumexp on the accumulator registers, the vocabulary split into ranges
where that fills the card's last wave (partials merged in range order).
K10/K11 at bf16/fp16: a thread-block cluster shares 64 rows over slices of
the hidden width (wgmma, TMA) where the width splits so, the hidden width
streamed through shared memory in 256-column chunks where it does not. At
fp32 all three run FMA kernels.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel (``csrc/fused_ce.cu``) or raises. The raw launchers
raise when autograd is asked to record them: :func:`flash_linear_cross_entropy`
is the differentiable entry, an ``autograd.Function`` over K9, K10 and K11.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import check, dtype_code, library, needs_grad, stream_of
from .cost import costed

__all__ = ["flash_linear_cross_entropy", "ce_forward", "ce_forward_plain",
           "ce_backward_dx", "ce_backward_dx_plain", "ce_backward_dw",
           "ce_backward_dw_plain", "mm_f32", "supports", "kernel_plan",
           "library_plan", "LANES", "SLICE_CHUNKS"]

#: the JAX gate's lane width (``fused_ce.supports``)
LANES = 128
#: token chunk of the plain versions (a [2048, vocab] fp32 tile at a time)
_PLAIN_CHUNK = 2048
#: dl's rounding on the fp32 path (csrc/fused_ce.cu ``round_dl``)
_ROUND_DL = {torch.bfloat16: 1, torch.float16: 2}


def supports(hidden_size):
    """The routing gate of the JAX package (``fused_ce.supports``)."""
    return hidden_size % LANES == 0


#: K9-K11's routes by the library's code (csrc/fused_ce.cu ``Route``)
ROUTES = ("cluster", "streamed", "resident", "wgmma")
#: 64-column chunks of a cluster CTA's slice, widest first: even, so the two
#: consumer warpgroups take half each (one kernel instantiation a type each)
SLICE_CHUNKS = (6, 4, 2)
_MAX_CLUSTER = 8
#: K9's wgmma kernel: token rows a stripe, vocab columns a tile, the most
#: vocab ranges, and the SMs of an H100 SXM (one persistent CTA an SM)
FWD_ROWS, FWD_TILE, FWD_MAX_RANGES, H100_SMS = 128, 256, 8, 132


def _ring_slots(nc, c):
    """T tiles (64 x 64, 8 KB) in a cluster CTA's ring: what the H100's 227
    KB leave after the R slice, two dl tiles, term buffers, barriers and
    the c - 1 partners' received partials (csrc/fused_ce.cu
    ``ClusterLayout``)."""
    tile, rx_slot = 8192, 64 * 72 * 4
    rx = nc * tile + 2 * tile + 4 * 64 * 16 + 2 * 64 * 4 + 512
    ring = -(-(rx + (c - 1) * rx_slot) // 1024) * 1024
    return (232448 - 1024 - ring) // tile


def _fwd_plan(tokens, vocab, hidden, dtype, sms):
    if dtype == torch.float32:
        return {"route": "resident" if hidden <= 768 else "streamed",
                "ranges": 1, "tile": 32, "ctas": -(-tokens // 32)}
    stripes = -(-tokens // FWD_ROWS)
    tiles = -(-vocab // FWD_TILE)
    _, ranges = min((-(-stripes * r // sms) * -(-tiles // r), r)
                    for r in range(1, min(FWD_MAX_RANGES, tiles) + 1))
    return {"route": "wgmma", "ranges": ranges, "tile": FWD_TILE,
            "ctas": min(stripes * ranges, sms)}


def kernel_plan(tokens, vocab, hidden, dtype, mode, sms=H100_SMS):
    """How the library runs K9 (``mode`` 2), K10 (``mode`` 0) or K11
    (``mode`` 1) on operands of ``dtype`` (the type the kernel takes: fp32
    for a mixed pair).

    K9: ``{"route", "ranges", "tile", "ctas"}``. bf16/fp16 take the wgmma
    kernel: units of 128 tokens x a range of 256-column vocab tiles, at
    most one persistent CTA of ``sms`` an SM; ``ranges`` (1 to 8, at most
    one a tile) minimises the units a CTA takes times the tiles of a range,
    the fewest on a tie. fp32 takes the resident FMA kernel up to hidden
    768 and the streamed one above (32-token blocks, one range).

    K10/K11:
    ``{"route", "cluster", "slice", "ctas"}``. bf16/fp16 take the cluster
    kernel (``cluster`` CTAs share 64 rows, each ``slice`` hidden columns:
    384, 256 or 128, the fewest CTAs, at most 8, as long as the CTA's ring
    still holds two T blocks beside the partners' partials) where such a
    split exists, else the streamed kernel; fp32 the resident FMA kernel up to hidden
    768 and the streamed one above. Off the cluster route ``slice`` is the
    output columns a CTA (32 rows). A copy of ``ptt_fused_ce_plan``
    (:func:`library_plan`), which decides on the card."""
    if mode == 2:
        return _fwd_plan(tokens, vocab, hidden, dtype, sms)
    rows = tokens if mode == 0 else vocab
    blocks = -(-rows // 32)
    if dtype != torch.float32:
        for nc in SLICE_CHUNKS:
            c = hidden // 64 // nc
            if ((hidden // 64) % nc == 0 and c <= _MAX_CLUSTER
                    and _ring_slots(nc, c) >= 2 * nc):
                return {"route": "cluster", "cluster": c, "slice": nc * 64,
                        "ctas": c * -(-rows // 64)}
    elif hidden <= 768:
        return {"route": "resident", "cluster": 1, "slice": hidden,
                "ctas": blocks}
    piece = next(p for p in range(768, 0, -128) if hidden % p == 0)
    return {"route": "streamed", "cluster": 1, "slice": piece,
            "ctas": blocks * (hidden // piece)}


def library_plan(tokens, vocab, hidden, dtype, mode):
    """:func:`kernel_plan` as the kernel library makes it
    (``ptt_fused_ce_plan``; K9's on the current card's SMs). Builds the
    library at first use."""
    plan = (ctypes.c_int * 4)()
    check(library().ptt_fused_ce_plan(tokens, vocab, hidden,
                                      dtype_code(dtype), mode,
                                      ctypes.byref(plan)),
          "fused_ce plan")
    keys = (("route", "ranges", "tile", "ctas") if mode == 2
            else ("route", "cluster", "slice", "ctas"))
    return dict(zip(keys, (ROUTES[plan[0]], *plan[1:])))


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
    copies move 16 bytes; TMA needs the alignment too)."""
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


@costed("K9")
def ce_forward(x, w, b, y):
    """K9: ``(loss, lse)`` of ``cross_entropy(x · wᵀ + b, y)`` per token,
    fp32. CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return ce_forward_plain(x, w, b, y)
    xk, wk, bk, yk = _operands("fused_ce_fwd", x, w, b, y)
    n, h = xk.shape
    v = wk.shape[0]
    loss = torch.empty(n, dtype=torch.float32, device=x.device)
    lse = torch.empty_like(loss)
    if n == 0:
        return loss, lse
    # the range partials (m, l, picked) of the wgmma kernel's vocab split
    ranges = library_plan(n, v, h, xk.dtype, 2)["ranges"]
    part = (torch.empty(4 * ranges * n, dtype=torch.float32, device=x.device)
            if ranges > 1 else None)
    check(library().ptt_fused_ce_fwd(
        xk.data_ptr(), wk.data_ptr(), _ptr(bk), yk.data_ptr(),
        loss.data_ptr(), lse.data_ptr(), _ptr(part),
        0 if part is None else part.numel(), n, v, h,
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


@costed("K10")
def ce_backward_dx(x, w, b, y, g, lse):
    """K10: ``dx`` in ``x.dtype``. ``g`` is the per-token upstream gradient
    (already 0 at ignored labels). CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return ce_backward_dx_plain(x, w, b, y, g, lse)
    dx, _ = _bwd("fused_ce_dx", 0, x, w, b, y, g, lse, w.dtype)
    if x.shape[0]:
        ce_backward_dx.launches += 1
    return dx.to(x.dtype)


@costed("K11")
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
