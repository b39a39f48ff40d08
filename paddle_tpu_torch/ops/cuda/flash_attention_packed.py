"""Packed (seq-major) flash attention: kernels K5 (forward) and K6 (backward)
and their plain versions.

K5 launches K1's forward (``csrc/flash_attention.cu``: ``mma.sync`` tensor
cores at bf16 and fp16, fp32 FMA at fp32; :func:`~.flash_attention.kernel_route`):
a ``(b, s, h·d)`` view read through its row stride is a ``(b, s, h, d)``
view with head stride d, and the shared ``(sq, sk)`` bias is K1's bias with
batch and head strides 0. Its plain version is K1's: the 64-key online
softmax with p rounded to v's dtype before ``p v`` on the tensor-core route,
as the TPU kernel rounds it (flash_attention_packed.py:149, :195). K6
(``csrc/flash_attention_packed.cu``) is one pass over key tiles on the same
views: at bf16 and fp16 K3's tensor-core kernel with a dq product, p and
``ds * scale`` rounded to the input dtype before their products as the TPU
kernel rounds them (:295, :304, :312), dq added into an fp32 workspace
with vector atomics; at fp32 an FMA kernel. Its plain version rounds at the
same places on the tensor-core route.

Port of ``paddle_tpu/ops/pallas/flash_attention_packed.py``. q, k and v are
``(batch, seq, heads * head_dim)``: the reshaped views of one fused qkv
projection go in without a copy (the kernels take batch and row strides) and
the output feeds the out-projection as it is. Causal masking is bottom-right
aligned (key ``j`` is visible to query ``i`` iff ``j <= i + sk - sq``); an
optional shared ``(sq, sk)`` additive bias carries no gradient. A query row
with no visible key gives output 0, logsumexp -1e30 and zero gradients.

:func:`flash_attention_packed` is differentiable: under autograd it saves
q, k, v, the output and the fp32 logsumexp, and the backward recomputes the
probabilities from them (K6), as the JAX custom vjp does. The raw launchers
(:func:`flash_attention_packed_fwd`, :func:`flash_attention_packed_bwd`)
raise on a CUDA tensor that asks autograd to record them. The JAX kernels'
block sizes are TPU matters: the flags ``flash_attention_block_q``,
``flash_attention_block_k`` and ``flash_attention_bwd_block`` are accepted
and unused here. Attention dropout runs inside the kernels from a Philox
keep-mask keyed by ``dropout_seed`` (``ops/philox.py``,
``csrc/philox.cuh``), which depends only on (batch, head, row, column), so
K5 and K6 regenerate it whatever their tiling, and the plain versions draw
it bit for bit the same.
"""
from __future__ import annotations

import math

import torch

from .. import philox
from ._build import check, dtype_code, library, needs_grad, stream_of
from .cost import costed
from .flash_attention import (_dropped, _pick_block, dropout_seed_words,
                              flash_attention_fwd_plain, kernel_route)

__all__ = ["flash_attention_packed", "flash_attention_packed_plain",
           "flash_attention_packed_fwd", "flash_attention_packed_fwd_plain",
           "flash_attention_packed_bwd", "flash_attention_packed_bwd_plain",
           "supports", "HEAD_DIMS", "NEG_INF"]

NEG_INF = -1e30
#: head dims the packed route takes (K6 is instantiated for them; K5 runs
#: K1's forward at their widths)
HEAD_DIMS = (32, 64, 128)
# the JAX kernel's gate constants, for the CPU route
# (paddle_tpu/ops/pallas/flash_attention_packed.py)
_LANES = 128
_DEFAULT_BLOCK = 1024
_MAX_BWD_SLAB_BYTES = 10 * 2 ** 20


def _group_width(d):
    """(heads a 128-lane group, its lane width) of the JAX kernel."""
    if d >= _LANES:
        return (1, d) if d % _LANES == 0 else (0, 0)
    return (_LANES // d, _LANES) if _LANES % d == 0 else (0, 0)


def supports(seq_q, seq_k, num_heads, embed_dim):
    """The JAX kernel's shape gate (``flash_attention_packed.supports``):
    head dims that pack into 128-lane groups, 128-aligned sequence blocks
    and a backward dq slab under 10 MB — Mosaic constraints. The router
    consults it only on the CPU; the CUDA kernels take any sequence length
    and the head dims in :data:`HEAD_DIMS`."""
    if embed_dim % num_heads:
        return False
    hpg, width = _group_width(embed_dim // num_heads)
    if not hpg or num_heads % hpg:
        return False
    if seq_q * width * 4 > _MAX_BWD_SLAB_BYTES:
        return False
    return (_pick_block(seq_q, _DEFAULT_BLOCK) > 0
            and _pick_block(seq_k, _DEFAULT_BLOCK) > 0)


def _heads(q, k, num_heads):
    """``(b, sq, sk, h, d)`` of packed operands."""
    b, sq, e = q.shape
    h = int(num_heads)
    if k.shape[0] != b or k.shape[2] != e or e % h:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"pack {h} heads")
    return b, sq, k.shape[1], h, e // h


def _logits(q, k, num_heads, bias, causal, scale):
    """fp32 ``[b, h, sq, sk]`` scores with the bias and causal mask applied
    (masked entries at -1e30), and the boolean visibility."""
    b, sq, sk, h, d = _heads(q, k, num_heads)
    qf = q.float().reshape(b, sq, h, d).transpose(1, 2)
    kf = k.float().reshape(b, sk, h, d).transpose(1, 2)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    ok = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        row = torch.arange(sq, device=q.device)[:, None]
        col = torch.arange(sk, device=q.device)[None, :]
        ok = col <= row + (sk - sq)
    return torch.where(ok, s, NEG_INF), ok


def _keep(q, k, num_heads, dropout_p, seed):
    if not dropout_p:
        return None
    b, sq, sk, h, _ = _heads(q, k, num_heads)
    return philox.keep_mask(seed, b, h, sq, sk, dropout_p, q.device)


def flash_attention_packed_fwd_plain(q, k, v, num_heads, bias=None,
                                     causal=False, scale=None, dropout_p=0.0,
                                     seed=None):
    """Plain version of K5: ``(out, lse)``; out in q's dtype, lse fp32
    ``(b, h, sq)``. K1's plain version on the ``(b, s, h, d)`` views with
    the bias broadcast, as K5 runs K1's kernel: the 64-key online softmax,
    p rounded to v's dtype before ``p v`` on the tensor-core route; with
    dropout the row sum takes the undropped p and ``p v`` the kept p times
    ``1 / (1 - p)`` (flash_attention_packed.py:145, :189). A row with no
    visible key gives output 0 and lse -1e30."""
    b, sq, sk, h, d = _heads(q, k, num_heads)
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    out, lse = flash_attention_fwd_plain(
        q.reshape(b, sq, h, d), k.reshape(b, sk, h, d),
        v.reshape(b, sk, h, d), None if bias is None else bias[None, None],
        causal, scale, dropout_p, seed)
    return out.reshape(b, sq, h * d), lse


def flash_attention_packed_bwd_plain(q, k, v, out, lse, dout, num_heads,
                                     bias=None, causal=False, scale=None,
                                     dropout_p=0.0, seed=None):
    """Plain version of K6: ``(dq, dk, dv)`` in the inputs' dtypes, from the
    saved output and logsumexp, in fp32. With dropout, dv takes the dropped
    p and ds the masked and scaled dp (:286-290). On K6's tensor-core route
    (bf16, fp16) the dropped p is rounded to dout's dtype before ``p^T
    dout`` and ``ds * scale`` to q's and k's before ``ds^T q`` and ``ds k``,
    as K6 and the TPU kernel round them (:295, :304, :312)."""
    b, sq, sk, h, d = _heads(q, k, num_heads)
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    s, ok = _logits(q, k, num_heads, bias, causal, scale)
    lse_ = lse.float()[..., None]
    p = torch.where(ok & (lse_ > NEG_INF * 0.5), torch.exp(s - lse_), 0.0)

    def heads(t, n):
        return t.float().reshape(b, n, h, d).transpose(1, 2)

    gf, of = heads(dout, sq), heads(out, sq)
    delta = (gf * of).sum(-1, keepdim=True)
    dp = torch.matmul(gf, heads(v, sk).transpose(-1, -2))
    keep = _keep(q, k, num_heads, dropout_p, seed)
    ds = p * (_dropped(dp, keep, dropout_p) - delta) * scale
    pd = _dropped(p, keep, dropout_p)
    if kernel_route(q.dtype, d) == "mma.sync":
        ds = ds.to(q.dtype).float()
        pd = pd.to(dout.dtype).float()
    dq = torch.matmul(ds, heads(k, sk))
    dk = torch.matmul(ds.transpose(-1, -2), heads(q, sq))
    dv = torch.matmul(pd.transpose(-1, -2), gf)

    def back(t, n, like):
        return t.transpose(1, 2).reshape(b, n, h * d).to(like.dtype)

    return back(dq, sq, q), back(dk, sk, k), back(dv, sk, v)


def _check_operands(q, k, v, bias, num_heads, what, *others):
    if q.device.type != "cuda":
        raise ValueError(f"{what} kernel needs CUDA, got {q.device}")
    if needs_grad(q, k, v, *others):
        raise RuntimeError(
            f"{what}: the kernel's output is not recorded by autograd; call "
            "flash_attention_packed, which differentiates through K5 and K6")
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"q, k, v must be (batch, seq, heads * head_dim); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, sk, h, d = _heads(q, k, num_heads)
    if d not in HEAD_DIMS:
        raise ValueError(f"{what} kernel takes head_dim in {HEAD_DIMS}, got {d}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(2) != 1:
            raise ValueError(f"{name} needs a contiguous last axis "
                             f"(strides {t.stride()})")
    if bias is not None:
        if (bias.shape != (sq, sk) or bias.dtype != torch.float32
                or not bias.is_contiguous() or bias.device != q.device):
            raise ValueError(f"bias must be contiguous fp32 ({sq}, {sk}) on "
                             f"{q.device}")
    return b, sq, sk, h, d


def _strides(q, k, v, d, bias, sk):
    """K1's strides on the packed views: q, k, v (batch, seq, head), heads
    d apart; then the shared bias's (batch, head, row), 0, 0, sk."""
    st = [x for t in (q, k, v) for x in (*t.stride()[:2], d)]
    return st + [0, 0, sk if bias is not None else 0]


def _tail(scale, causal, dropout_p, seed, dtype, t):
    """The kernels' trailing C arguments (``_build._ATTN_TAIL``)."""
    return (float(scale), int(bool(causal)),
            *philox.kernel_args(dropout_p, seed), dtype_code(dtype),
            stream_of(t))


@costed("K5")
def flash_attention_packed_fwd(q, k, v, num_heads, bias=None, causal=False,
                               scale=None, dropout_p=0.0, seed=None):
    """``(out, lse)``: CPU tensors take the plain version; CUDA tensors
    launch kernel K5, K1's forward on the packed strides (q, k and v rows
    at their row strides, heads d apart; the bias's rows sk apart, its batch
    and head strides 0). ``bias`` is None or a contiguous fp32 ``(sq, sk)``;
    ``seed`` (two words) keys the dropout mask when ``dropout_p > 0``."""
    if q.device.type == "cpu":
        return flash_attention_packed_fwd_plain(q, k, v, num_heads, bias,
                                                causal, scale, dropout_p,
                                                seed)
    b, sq, sk, h, d = _check_operands(q, k, v, bias, num_heads,
                                      "flash_attention_packed_fwd")
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    out = torch.empty((b, sq, h * d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    check(library().ptt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, sq, sk, h, d, *_strides(q, k, v, d, bias, sk),
        *_tail(scale, causal, dropout_p, seed, q.dtype, q)),
        "flash_attention_packed_fwd")
    flash_attention_packed_fwd.launches += 1
    flash_attention_packed_fwd.dropout_launches += int(bool(dropout_p))
    return out, lse


@costed("K6")
def flash_attention_packed_bwd(q, k, v, out, lse, dout, num_heads, bias=None,
                               causal=False, scale=None, dropout_p=0.0,
                               seed=None):
    """``(dq, dk, dv)`` from the forward's ``out`` and ``lse``: CPU tensors
    take the plain version; CUDA tensors launch kernel K6 (on the packed
    strides, as K5; fp32 with a delta pre-pass; then a dq cast pass). dq is
    summed with atomics, so its last bits vary from run to run."""
    if q.device.type == "cpu":
        return flash_attention_packed_bwd_plain(q, k, v, out, lse, dout,
                                                num_heads, bias, causal, scale,
                                                dropout_p, seed)
    b, sq, sk, h, d = _check_operands(q, k, v, bias, num_heads,
                                      "flash_attention_packed_bwd", out, dout)
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q {tuple(q.shape)} "
                             f"{q.dtype}, got {tuple(t.shape)} {t.dtype}")
    if (lse.shape != (b, h, sq) or lse.dtype != torch.float32
            or lse.device != q.device):
        raise ValueError(f"lse must be fp32 ({b}, {h}, {sq}) on {q.device}")
    out, dout, lse = out.contiguous(), dout.contiguous(), lse.contiguous()
    # the FMA route's delta pre-pass (the tensor-core route recomputes delta
    # a tile)
    delta = None
    if kernel_route(q.dtype, d) == "fma":
        delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    dq_ws = torch.empty((b, sq, h * d), dtype=torch.float32, device=q.device)
    dq = torch.empty((b, sq, h * d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, h * d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, sk, h * d), dtype=q.dtype, device=q.device)
    check(library().ptt_flash_attention_packed_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(),
        None if delta is None else delta.data_ptr(), dq_ws.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, sk, h, d,
        *_strides(q, k, v, d, bias, sk),
        *_tail(scale, causal, dropout_p, seed, q.dtype, q)),
        "flash_attention_packed_bwd")
    flash_attention_packed_bwd.launches += 1
    flash_attention_packed_bwd.dropout_launches += int(bool(dropout_p))
    return dq, dk, dv


class _FlashPacked(torch.autograd.Function):
    """K5 forward, K6 backward; saves q, k, v, out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, bias, num_heads, causal, scale, dropout_p,
                seed):
        out, lse = flash_attention_packed_fwd(q, k, v, num_heads, bias,
                                              causal, scale, dropout_p, seed)
        ctx.save_for_backward(q, k, v, out, lse, bias)
        ctx.args = (num_heads, causal, scale, dropout_p, seed)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, bias = ctx.saved_tensors
        num_heads, causal, scale, dropout_p, seed = ctx.args
        dq, dk, dv = flash_attention_packed_bwd(
            q, k, v, out, lse, dout, num_heads, bias, causal, scale,
            dropout_p, seed)
        return dq, dk, dv, None, None, None, None, None, None


def _bias_f32(bias, sq, sk):
    """The shared bias as the kernels take it: fp32, contiguous, boolean
    masks as 0 / -1e30 (as ``flash_attention_packed`` converts them)."""
    if bias is None:
        return None
    if tuple(bias.shape) != (sq, sk):
        raise ValueError(f"packed attention takes a shared ({sq}, {sk}) "
                         f"bias, got {tuple(bias.shape)}")
    if bias.dtype == torch.bool:
        bias = torch.where(bias, 0.0, NEG_INF)
    return bias.detach().to(torch.float32).contiguous()


def flash_attention_packed(q, k, v, num_heads, bias=None, *, causal=False,
                           scale=None, dropout_p=0.0, dropout_seed=None):
    """Flash attention over packed ``(batch, seq, heads * head_dim)``
    tensors; returns ``(batch, seq_q, heads * head_dim)`` in q's dtype.

    ``bias`` (optional) is a shared 2-D ``(seq_q, seq_k)`` additive or
    boolean mask, constant (no gradient). ``dropout_p`` drops attention
    probabilities inside the kernels from the keep-mask keyed by
    ``dropout_seed`` (two words; required with dropout, as are fewer than
    1024 heads, as in the JAX wrapper). CPU tensors take the plain versions;
    CUDA tensors launch K5, and K6 in the backward."""
    b, sq, sk, h, d = _heads(q, k, num_heads)
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    bias = _bias_f32(bias, sq, sk)
    dropout_p = float(dropout_p)
    seed = dropout_seed_words(dropout_p, dropout_seed, h)
    if needs_grad(q, k, v):
        return _FlashPacked.apply(q, k, v, bias, h, bool(causal), scale,
                                  dropout_p, seed)
    return flash_attention_packed_fwd(q, k, v, h, bias, causal, scale,
                                      dropout_p, seed)[0]


def flash_attention_packed_plain(q, k, v, num_heads, bias=None, *,
                                 causal=False, scale=None, dropout_p=0.0,
                                 dropout_seed=None):
    """The plain version of :func:`flash_attention_packed`, differentiable
    by autograd itself (the reference run on the card); it drops the same
    elements as the kernels for the same seed."""
    b, sq, sk, h, d = _heads(q, k, num_heads)
    dropout_p = float(dropout_p)
    seed = dropout_seed_words(dropout_p, dropout_seed, h)
    return flash_attention_packed_fwd_plain(
        q, k, v, h, _bias_f32(bias, sq, sk), causal, scale, dropout_p,
        seed)[0]


flash_attention_packed_fwd.launches = 0
flash_attention_packed_fwd.dropout_launches = 0
flash_attention_packed_bwd.launches = 0
flash_attention_packed_bwd.dropout_launches = 0
