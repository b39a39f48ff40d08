"""Flash attention kernels K1-K4 and their plain versions.

Port of ``paddle_tpu/ops/pallas/flash_attention.py``. Both kernels read q, k
and v in the paddle layout ``(batch, seq, heads, head_dim)`` through their
strides, so the views of a fused qkv projection or a cache row go in
without a copy.

* :func:`flash_attention` — the layout-swapping flash attention (K1
  forward, K2 dq, K3 dk/dv; ``csrc/flash_attention.cu``), differentiable.
  An optional additive bias ``(sq, sk)`` or ``(B|1, H|1, sq, sk)`` (boolean
  masks become 0 / -1e30) is read through its strides with stride 0 on a
  broadcast dim; causal masking is bottom-right aligned (key ``j`` is
  visible to query ``i`` iff ``j <= i + sk - sq``). A query row with no
  visible key gives output 0, logsumexp -1e30 and zero gradients. Under
  autograd it saves q, k, v, the bias, the output and the fp32 logsumexp;
  the backward recomputes the probabilities from them, dq swept over key
  tiles (K2) and dk/dv over query tiles (K3): no atomics, the same bits
  from run to run. bf16 and fp16 inputs up to head dim 128 run K1-K3 on
  the tensor cores (``mma.sync``), rounding p (K1, K3) and ``ds * scale``
  (K2, K3) to the input type before their products as the TPU kernels do;
  fp32 inputs and head dims above 128 run fp32 FMA kernels
  (:func:`kernel_route`). A trainable bias gets its gradient from PyTorch
  operations on the saved residuals, as the JAX package computes it with
  XLA operations outside its kernels. The raw launchers
  (:func:`flash_attention_fwd`, :func:`flash_attention_bwd_dq`,
  :func:`flash_attention_bwd_dkv`) raise on a CUDA tensor that asks
  autograd to record them. Block sizes and the interpret switch are TPU
  matters (accepted, unused). Attention dropout runs inside the kernels: a
  Philox keep-mask keyed by ``dropout_seed`` and counted from (batch, head,
  row, column) (``ops/philox.py``, ``csrc/philox.cuh``), which the plain
  versions draw bit for bit the same; the JAX wrapper's refusals are kept
  (no seed, dropout with a bias gradient, 1024 heads or more).
* :func:`flash_attention_cached` — the length-masked cached forward (K4,
  ``csrc/flash_attention_cached.cu``). Key ``j`` attends to query row ``i``
  of batch ``b`` iff ``j <= q_pos[b, i]`` and, when ``kv_len`` is given,
  ``j < kv_len[b]``; a row with no valid key gives 0. Forward only: serving
  holds no gradients through the cache, and on a CUDA tensor the wrapper
  raises rather than return an output that autograd cannot see. Three
  routes (:func:`cached_route`): prefill and chunked prefill (more than
  :data:`DECODE_ROWS` query rows) at bf16 and fp16 up to head dim 128 run
  K1's tensor-core forward under the length mask, p rounded to v's dtype
  before ``p v`` as the TPU kernel rounds it; decode and verify split the
  keys into parts of :data:`PART_KEYS` (flash-decoding), each warp's 32
  keys with their own row maxima and p rounded to v's dtype, merged in a
  second launch in part order; fp32 prefill and head dims above 256 run
  an fp32 FMA kernel. The plain version follows each route's order. On
  the card the kernel library chooses the route and sizes the split
  workspace (:func:`cached_plan`); :func:`cached_route`,
  :data:`DECODE_ROWS` and :data:`PART_KEYS` are the plain version's copy of
  that rule, held to the library's by the card tests and ``chip_smoke.py``.

Both take every head dim, as the JAX kernels do: up to 256 a head dim runs
in the smallest instantiated width at or above it (:data:`FLASH_WIDTHS` for
K1-K3), the columns past it zero-filled inside the kernel; above 256 it
runs in 256-column chunks (one chunked FMA kernel a type), the output
columns split into 256-column slices over the grid.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import philox
from ._build import check, dtype_code, library, needs_grad, stream_of

__all__ = ["flash_attention", "flash_attention_fwd",
           "flash_attention_fwd_plain", "flash_attention_bwd_dq",
           "flash_attention_bwd_dq_plain", "flash_attention_bwd_dkv",
           "flash_attention_bwd_dkv_plain", "flash_attention_cached",
           "flash_attention_cached_plain", "flash_attention_cached_parts",
           "cached_plan", "supports", "kernel_route", "cached_route",
           "split_parts", "FLASH_WIDTHS", "MAX_DROPOUT_HEADS",
           "DECODE_ROWS", "PART_KEYS", "NEG_INF"]

NEG_INF = -1e30
#: widths K1-K3 are instantiated at (csrc/flash_attention.cuh), and K4's
#: tensor-core and split-key routes; K4's FMA route is at 32, 64, 96, 128
#: and 256 (csrc/flash_attention_cached.cu); above 256 both run the head dim
#: in 256-column chunks
FLASH_WIDTHS = (16, 32, 64, 80, 96, 128, 256)
#: K4 splits the keys (decode, verify) up to this many query rows
DECODE_ROWS = 8
#: keys a part of K4's split-key route (a CTA: 4 warps of 32 keys)
PART_KEYS = 128
#: keys that share their row maxima on K4's split-key route (a warp)
_SPLIT_BLOCK = 32
#: the JAX kernels' in-kernel dropout takes fewer heads than this (their
#: per-tile seed packs the head into 10 bits; flash_attention.py:754-759)
MAX_DROPOUT_HEADS = 1024
#: the JAX kernels' q/k block preference and lane width, for the CPU gate
_DEFAULT_BLOCK = 1024
DEFAULT_BLOCK_Q = DEFAULT_BLOCK_K = _DEFAULT_BLOCK
_LANES = 128
#: keys a tile of K1's online softmax on the tensor cores
_KEY_TILE = 64


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


def cached_route(dtype, seq_q, head_dim):
    """The route K4 takes on the card (the dispatch of
    csrc/flash_attention_cached.cu): ``"split"`` split keys for up to
    :data:`DECODE_ROWS` query rows at head dims to 256, ``"mma.sync"`` K1's
    tensor-core forward for bf16 and fp16 prefill up to head dim 128,
    ``"fma"`` the fp32 FMA kernel otherwise."""
    dtype_code(dtype)
    if seq_q <= DECODE_ROWS and head_dim <= 256:
        return "split"
    if dtype != torch.float32 and head_dim <= 128:
        return "mma.sync"
    return "fma"


def split_parts(seq_k):
    """Key parts of K4's split-key route over ``seq_k`` cache rows (the
    grid's and the workspace's part dimension)."""
    return max(1, -(-seq_k // PART_KEYS))


def _length_ok(q_pos, kv_len, sk, device):
    """``[b, 1, sq, sk]`` visibility of the LengthMask contract."""
    col = torch.arange(sk, device=device, dtype=torch.int32)
    ok = col[None, None, :] <= q_pos.to(device, torch.int32)[:, :, None]
    if kv_len is not None:
        ok = ok & (col[None, None, :]
                   < kv_len.to(device, torch.int32)[:, None, None])
    return ok[:, None]


def _cached_split_plain(q, k, v, ok, scale):
    """K4's split-key route: the keys in blocks of 32 (a warp's), each with
    its own row maxima, ``p`` summed unrounded and rounded to v's dtype
    before ``p v``; the blocks merged by their maxima."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    pad = -sk % _SPLIT_BLOCK
    nb = (sk + pad) // _SPLIT_BLOCK
    qf = q.float().transpose(1, 2)
    kf = torch.nn.functional.pad(k.float().transpose(1, 2), (0, 0, 0, pad))
    vf = v.transpose(1, 2)
    vf = torch.nn.functional.pad(vf, (0, 0, 0, pad)).float()
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * scale    # [b,h,sq,sk']
    ok = torch.nn.functional.pad(ok, (0, pad))
    logits = torch.where(ok, logits, NEG_INF).reshape(b, h, sq, nb, -1)
    m = logits.amax(-1, keepdim=True)                          # [b,h,sq,nb,1]
    p = torch.where(m > NEG_INF * 0.5, torch.exp(logits - m), 0.0)
    l = p.sum(-1)                                              # [b,h,sq,nb]
    if v.dtype != torch.float32:
        p = p.to(v.dtype).float()
    acc = torch.einsum("bhqnk,bhnkd->bhqnd", p,
                       vf.reshape(b, h, nb, _SPLIT_BLOCK, d))
    m = m.squeeze(-1)
    w = torch.exp(m - m.amax(-1, keepdim=True))               # [b,h,sq,nb]
    lsum = (l * w).sum(-1, keepdim=True)
    out = (acc * w[..., None]).sum(-2) / torch.where(lsum == 0.0, 1.0, lsum)
    return out.transpose(1, 2).to(q.dtype)


def flash_attention_cached_plain(q, k, v, q_pos, kv_len=None, scale=None):
    """Plain version of K4 in the order of the route it takes
    (:func:`cached_route`): on the split-key route at bf16 and fp16 the
    32-key blocks merged by their maxima (:func:`_cached_split_plain`); on
    the tensor-core route K1's plain version under the length mask (the
    64-key online softmax, p rounded to v's dtype before ``p v``); else
    (fp32, wide heads) dense fp32 scores under the length mask."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    ok = _length_ok(q_pos, kv_len, sk, q.device)              # [b,1,sq,sk]
    route = cached_route(q.dtype, sq, d)
    if route == "split" and q.dtype != torch.float32:
        return _cached_split_plain(q, k, v, ok, s)
    if route == "mma.sync":
        return flash_attention_fwd_plain(
            q, k, v, torch.where(ok, 0.0, NEG_INF), False, s)[0]
    qf = q.float().transpose(1, 2)
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * s      # [b,h,sq,sk]
    logits = torch.where(ok, logits, NEG_INF)
    m = logits.amax(-1, keepdim=True)
    p = torch.where(ok, torch.exp(logits - m), 0.0)
    l = p.sum(-1, keepdim=True)
    out = torch.matmul(p, vf) / torch.where(l == 0.0, 1.0, l)
    return out.transpose(1, 2).to(q.dtype)


def _check_qkv(q, k, v, what):
    """``(b, sq, sk, h, d)`` of q, k and v as a kernel takes them: paddle
    layout, one dtype and device and a contiguous head_dim (any head dim, as
    the JAX kernels take). Raises on anything else."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q, k, v must be (batch, seq, heads, head_dim); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if k.shape != (b, sk, h, d) or v.shape != k.shape:
        raise ValueError(f"k/v must be ({b}, seq_k, {h}, {d}); got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if d < 1:
        raise ValueError(f"{what} kernel needs a head dim of at least 1")
    dtype_code(q.dtype)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if d > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous head_dim "
                             f"(strides {t.stride()})")
    return b, sq, sk, h, d


#: the C side's route codes (csrc/flash_attention_cached.cu ``Route``)
_CACHED_ROUTES = ("fma", "mma.sync", "split")


def cached_plan(b, seq_q, seq_k, heads, head_dim, dtype):
    """K4's plan as the kernel library makes it: ``(route, parts,
    workspace_floats)``, the route as :func:`cached_route` names it, and on
    the split-key route its key parts and the fp32 workspace it needs (0
    and 0 on the others). Builds the library at first use."""
    route, parts, floats = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    check(library().ptt_flash_attention_cached_plan(
        b, seq_q, seq_k, heads, head_dim, dtype_code(dtype),
        ctypes.byref(route), ctypes.byref(parts), ctypes.byref(floats)),
        "flash_attention_cached_plan")
    return _CACHED_ROUTES[route.value], parts.value, floats.value


def _cached_launch(q, k, v, q_pos, kv_len, scale, probe):
    """Launch K4; returns ``(out, ctas, ws)``: the split kernel's CTAs as
    the launcher reports them (0 on the other routes) and the workspace
    (None off the split route). ``probe`` sets the workspace to NaN first,
    so the records the kernel wrote can be counted."""
    if needs_grad(q, k, v):
        raise RuntimeError("flash_attention_cached is forward-only: its "
                           "kernel's output is not recorded by autograd")
    b, sq, sk, h, d = _check_qkv(q, k, v, "cached attention")
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
    # the split-key route's parts: (m, l, acc) a row, merged by a second
    # launch; sized by the library, which refuses a smaller one
    _, _, floats = cached_plan(b, sq, sk, h, d, q.dtype)
    ws = None
    if floats:
        ws = (torch.full if probe else torch.empty)(
            (floats,), *((math.nan,) if probe else ()), dtype=torch.float32,
            device=q.device)
    ctas = ctypes.c_longlong()
    check(library().ptt_flash_attention_cached_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
        None if kl is None else kl.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), floats, ctypes.byref(ctas),
        b, sq, sk, h, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        float(s), dtype_code(q.dtype), stream_of(q)),
        "flash_attention_cached")
    flash_attention_cached.launches += 1
    return out, ctas.value, ws


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
    return _cached_launch(q, k, v, q_pos, kv_len, scale, probe=False)[0]


def flash_attention_cached_parts(q, k, v, q_pos, kv_len=None, *, scale=None):
    """K4 on the card with its split-key parts counted: ``(out, launched,
    live)``, the split kernel's CTAs as its launcher reports them and the
    parts that wrote their records (the rest exit at once); ``(out, 0, 0)``
    off the split route. One launch, counted as any other."""
    if q.device.type != "cuda":
        raise ValueError(f"cached attention kernel needs CUDA, got {q.device}")
    out, ctas, ws = _cached_launch(q, k, v, q_pos, kv_len, scale, probe=True)
    if ws is None:
        return out, 0, 0
    # each record is m, l, then head_dim columns, sq records a part; a live
    # part writes every one of them, so its first row's m says
    sq, d = q.shape[1], q.shape[3]
    m = ws.view(-1, sq, d + 2)[:, 0, 0]
    return out, ctas, int((~torch.isnan(m)).sum())


flash_attention_cached.launches = 0


# ---------------------------------------------------------------------------
# K1-K3: the layout-swapping flash attention
# ---------------------------------------------------------------------------
def _scores(q, k, bias, causal, scale):
    """fp32 ``[b, h, sq, sk]`` logits ``q.k * scale + bias`` with causal
    entries at -1e30, and the causal visibility (None without causal)."""
    sq, sk = q.shape[1], k.shape[1]
    s = torch.matmul(q.float().transpose(1, 2),
                     k.float().permute(0, 2, 3, 1)) * scale
    if bias is not None:
        s = s + bias.float()
    ok = None
    if causal:
        row = torch.arange(sq, device=q.device)[:, None]
        col = torch.arange(sk, device=q.device)[None, :]
        ok = col <= row + (sk - sq)
        s = torch.where(ok, s, NEG_INF)
    return s, ok


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def _keep(q, k, dropout_p, seed):
    """The call's ``[b, h, sq, sk]`` keep-mask (None without dropout)."""
    if not dropout_p:
        return None
    b, sq, h, _ = q.shape
    return philox.keep_mask(seed, b, h, sq, k.shape[1], dropout_p, q.device)


def _dropped(x, keep, dropout_p):
    """``x`` where kept, times ``1 / (1 - p)``; 0 where dropped."""
    if keep is None:
        return x
    return torch.where(keep, x * philox.inv_keep(dropout_p), 0.0)


def kernel_route(dtype, head_dim=None):
    """The route K1, K2 and K3 (and the packed forward K5, which runs K1)
    take on the card for inputs of ``dtype`` and ``head_dim`` (the dispatch
    of csrc/flash_attention*.cu): ``"mma.sync"`` tensor-core tiles for bf16
    and fp16 up to head dim 128, ``"fma"`` fp32 FMA for fp32 and wider
    heads."""
    dtype_code(dtype)
    wide = head_dim is not None and head_dim > 128
    return "fma" if dtype == torch.float32 or wide else "mma.sync"


def _rounds(t):
    """Whether K1-K3 round p (K1, K3) and ds * scale (K2, K3) to ``t``'s
    type: on the tensor-core route."""
    return kernel_route(t.dtype, t.shape[-1]) == "mma.sync"


def flash_attention_fwd_plain(q, k, v, bias=None, causal=False, scale=None,
                              dropout_p=0.0, seed=None):
    """Plain version of K1: ``(out, lse)``; out in q's dtype ``(b, sq, h,
    d)``, lse fp32 ``(b, h, sq)``. ``bias`` is None or ``(B|1, H|1, sq,
    sk)``. The online softmax over 64-key tiles, as K1 runs it: each tile's
    ``p = exp(s - m)`` against the row's running max ``m`` goes into ``l``
    undropped; with dropout the kept p is scaled by ``1 / (1 - p)`` and the
    dropped p is 0 in ``p v`` (flash_attention.py:148-154); on K1's
    tensor-core route p is rounded to v's dtype before ``p v`` (as the TPU
    kernel rounds it, :156)."""
    s, _ = _scores(q, k, bias, causal, _scale(q, scale))
    keep = _keep(q, k, dropout_p, seed)
    vf = v.float().transpose(1, 2)
    rnd = _rounds(v)
    m = torch.full(s.shape[:-1] + (1,), NEG_INF, device=s.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(s.shape[:-1] + (vf.shape[-1],), device=s.device)
    for k0 in range(0, s.shape[-1], _KEY_TILE):
        st = s[..., k0:k0 + _KEY_TILE]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        # rows with no visible key so far: p 0 (_zero_masked_rows)
        p = torch.where(m_new > NEG_INF * 0.5, torch.exp(st - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        if keep is not None:
            p = _dropped(p, keep[..., k0:k0 + _KEY_TILE], dropout_p)
        if rnd:
            p = p.to(v.dtype).float()
        acc = acc * alpha + torch.matmul(p, vf[..., k0:k0 + _KEY_TILE, :])
        m = m_new
    # rows with no visible key: output 0, lse -1e30
    l_safe = torch.where(l == 0.0, 1.0, l)
    lse = (m + torch.log(l_safe)).squeeze(-1)
    return (acc / l_safe).transpose(1, 2).to(q.dtype), lse


def _probs_ds(q, k, v, out, lse, dout, bias, causal, scale, dropout_p=0.0,
              seed=None):
    """fp32 ``(p, ds)`` ``[b, h, sq, sk]`` recomputed from the saved lse:
    ``p = exp(s - lse)`` (0 where masked and on rows with no visible key),
    ``ds = p * (dp - rowsum(dout * out))``. With dropout, p comes back
    dropped (the dv operand) and dp is masked and scaled before ds
    (flash_attention.py:246-251). The bias gradient uses them unrounded;
    K2's and K3's plain versions round them on the tensor-core route."""
    s, ok = _scores(q, k, bias, causal, scale)
    lse_ = lse.float()[..., None]
    live = lse_ > NEG_INF * 0.5
    if ok is not None:
        live = live & ok
    p = torch.where(live, torch.exp(s - lse_), 0.0)
    gf = dout.float().transpose(1, 2)
    delta = (gf * out.float().transpose(1, 2)).sum(-1, keepdim=True)
    dp = torch.matmul(gf, v.float().permute(0, 2, 3, 1))
    keep = _keep(q, k, dropout_p, seed)
    ds = p * (_dropped(dp, keep, dropout_p) - delta)
    return _dropped(p, keep, dropout_p), ds


def flash_attention_bwd_dq_plain(q, k, v, out, lse, dout, bias=None,
                                 causal=False, scale=None, dropout_p=0.0,
                                 seed=None):
    """Plain version of K2: dq ``(b, sq, h, d)`` in q's dtype, fp32 math;
    on K2's tensor-core route ``ds * scale`` is rounded to k's dtype before
    ``ds k``, as K2 and the TPU kernel (flash_attention.py:207-209) do."""
    scale = _scale(q, scale)
    _, ds = _probs_ds(q, k, v, out, lse, dout, bias, causal, scale,
                      dropout_p, seed)
    kf = k.float().transpose(1, 2)
    if _rounds(q):
        dq = torch.matmul((ds * scale).to(k.dtype).float(), kf)
    else:
        dq = torch.matmul(ds, kf) * scale
    return dq.transpose(1, 2).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, out, lse, dout, bias=None,
                                  causal=False, scale=None, dropout_p=0.0,
                                  seed=None):
    """Plain version of K3: ``(dk, dv)`` ``(b, sk, h, d)`` in k's and v's
    dtypes, fp32 math; on K3's tensor-core route the (dropped) p and
    ``ds * scale`` are rounded to dout's and q's types before their
    products, as K3 and the TPU kernel (flash_attention.py:254, :257-259)
    do."""
    scale = _scale(q, scale)
    p, ds = _probs_ds(q, k, v, out, lse, dout, bias, causal, scale,
                      dropout_p, seed)
    ds = ds * scale
    if _rounds(q):
        p = p.to(dout.dtype).float()
        ds = ds.to(q.dtype).float()
    dk = torch.matmul(ds.transpose(-1, -2), q.float().transpose(1, 2))
    dv = torch.matmul(p.transpose(-1, -2), dout.float().transpose(1, 2))
    return dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype)


def _dbias(q, k, v, out, lse, dout, bias, causal, scale):
    """The trainable bias's gradient, ``ds`` reduced onto the bias's
    broadcast shape (``paddle_tpu/ops/pallas/flash_attention.py:492-514``):
    PyTorch operations on the saved residuals on either device, exactly 0
    on rows with no visible key (no dropout: the wrapper refuses it with a
    bias gradient, as JAX does)."""
    _, ds = _probs_ds(q, k, v, out, lse, dout, bias, causal, scale)
    red = tuple(i for i in (0, 1) if bias.shape[i] == 1)
    if red:
        ds = ds.sum(red, keepdim=True)
    return ds.to(bias.dtype)


def _flash_check(q, k, v, bias, what, *others):
    """``(b, sq, sk, h, d)`` of CUDA operands the kernels take; raises on
    anything else."""
    if q.device.type != "cuda":
        raise ValueError(f"{what} kernel needs CUDA, got {q.device}")
    if needs_grad(q, k, v, bias, *others):
        raise RuntimeError(
            f"{what}: the kernel's output is not recorded by autograd; call "
            "flash_attention, which differentiates through K1, K2 and K3")
    b, sq, sk, h, d = _check_qkv(q, k, v, what)
    if bias is not None:
        if (bias.dim() != 4 or bias.shape[2:] != (sq, sk)
                or bias.shape[0] not in (1, b) or bias.shape[1] not in (1, h)
                or bias.dtype != torch.float32 or bias.device != q.device
                or (sk > 1 and bias.stride(3) != 1)):
            raise ValueError(
                f"bias must be fp32 (B|1, H|1, {sq}, {sk}) on {q.device} with "
                f"contiguous columns; got {tuple(bias.shape)} {bias.dtype}")
    return b, sq, sk, h, d


def _flash_strides(q, k, v, bias):
    """The kernels' strides: q, k, v (batch, seq, head), then the bias
    (batch, head, row), 0 on a broadcast dim or without a bias."""
    st = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3]]
    if bias is None:
        return st + [0, 0, 0]
    return st + [0 if bias.shape[0] == 1 else bias.stride(0),
                 0 if bias.shape[1] == 1 else bias.stride(1), bias.stride(2)]


def _check_saved(q, out, lse, dout):
    b, sq, h, _ = q.shape
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q {tuple(q.shape)} "
                             f"{q.dtype}, got {tuple(t.shape)} {t.dtype}")
    if (lse.shape != (b, h, sq) or lse.dtype != torch.float32
            or lse.device != q.device):
        raise ValueError(f"lse must be fp32 ({b}, {h}, {sq}) on {q.device}")
    return out.contiguous(), lse.contiguous(), dout.contiguous()


def _tail(q, scale, causal, dropout_p, seed):
    """The kernels' trailing C arguments (``_build._ATTN_TAIL``)."""
    return (_scale(q, scale), int(bool(causal)),
            *philox.kernel_args(dropout_p, seed), dtype_code(q.dtype),
            stream_of(q))


def flash_attention_fwd(q, k, v, bias=None, causal=False, scale=None,
                        dropout_p=0.0, seed=None):
    """``(out, lse)``: CPU tensors take the plain version; CUDA tensors
    launch kernel K1. ``bias`` is None or fp32 ``(B|1, H|1, sq, sk)``;
    ``seed`` (two words) keys the dropout mask when ``dropout_p > 0``."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, bias, causal, scale,
                                         dropout_p, seed)
    b, sq, sk, h, d = _flash_check(q, k, v, bias, "flash_attention_fwd")
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    check(library().ptt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, sq, sk, h, d, *_flash_strides(q, k, v, bias),
        *_tail(q, scale, causal, dropout_p, seed)), "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    flash_attention_fwd.dropout_launches += int(bool(dropout_p))
    return out, lse


def flash_attention_bwd_dq(q, k, v, out, lse, dout, bias=None, causal=False,
                           scale=None, dropout_p=0.0, seed=None):
    """dq from the forward's ``out`` and ``lse``: CPU tensors take the plain
    version; CUDA tensors launch kernel K2."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, out, lse, dout, bias,
                                            causal, scale, dropout_p, seed)
    b, sq, sk, h, d = _flash_check(q, k, v, bias, "flash_attention_bwd_dq",
                                   out, dout)
    out, lse, dout = _check_saved(q, out, lse, dout)
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    check(library().ptt_flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), b, sq, sk, h, d,
        *_flash_strides(q, k, v, bias),
        *_tail(q, scale, causal, dropout_p, seed)), "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    flash_attention_bwd_dq.dropout_launches += int(bool(dropout_p))
    return dq


def flash_attention_bwd_dkv(q, k, v, out, lse, dout, bias=None, causal=False,
                            scale=None, dropout_p=0.0, seed=None):
    """``(dk, dv)`` from the forward's ``out`` and ``lse``: CPU tensors take
    the plain version; CUDA tensors launch kernel K3."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, out, lse, dout, bias,
                                             causal, scale, dropout_p, seed)
    b, sq, sk, h, d = _flash_check(q, k, v, bias, "flash_attention_bwd_dkv",
                                   out, dout)
    out, lse, dout = _check_saved(q, out, lse, dout)
    dk = torch.empty((b, sk, h, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, sk, h, d), dtype=q.dtype, device=q.device)
    check(library().ptt_flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq,
        sk, h, d, *_flash_strides(q, k, v, bias),
        *_tail(q, scale, causal, dropout_p, seed)), "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    flash_attention_bwd_dkv.dropout_launches += int(bool(dropout_p))
    return dk, dv


class _Flash(torch.autograd.Function):
    """K1 forward; K2 and K3 backward; the bias's gradient, when it is
    trainable, from PyTorch operations. The launchers are looked up by
    their module names at call time."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, scale, dropout_p, seed):
        out, lse = flash_attention_fwd(q, k, v, bias, causal, scale,
                                       dropout_p, seed)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.args = (causal, scale, dropout_p, seed)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, lse = ctx.saved_tensors
        causal, scale, dropout_p, seed = ctx.args
        dout = dout.contiguous()
        args = (q, k, v, out, lse, dout, bias, causal, scale)
        need = ctx.needs_input_grad
        dq = dk = dv = dbias = None
        if need[0]:
            dq = flash_attention_bwd_dq(*args, dropout_p, seed)
        if need[1] or need[2]:
            dk, dv = flash_attention_bwd_dkv(*args, dropout_p, seed)
        if need[3]:
            dbias = _dbias(*args)
        return dq, dk, dv, dbias, None, None, None, None


def _bias_4d(bias):
    """The bias as the kernels take it: fp32 ``(B|1, H|1, sq, sk)``,
    boolean masks as 0 / -1e30 (as ``flash_attention`` converts them)."""
    if bias is None:
        return None
    if bias.dim() not in (2, 4):
        raise ValueError(f"flash_attention mask must be (sq, sk) or "
                         f"(B|1, H|1, sq, sk); got shape {tuple(bias.shape)} "
                         "— a 3-D mask is ambiguous")
    if bias.dtype == torch.bool:
        bias = torch.where(bias, 0.0, NEG_INF)
    bias = bias.to(torch.float32)
    if bias.shape[-1] > 1 and bias.stride(-1) != 1:
        bias = bias.contiguous()
    return bias.reshape((1,) * (4 - bias.dim()) + tuple(bias.shape))


def dropout_seed_words(dropout_p, dropout_seed, heads, bias_grad=False):
    """The two seed words of an attention call with dropout (None without),
    after the JAX wrapper's refusals (flash_attention.py:740-759): a seed is
    required, a bias gradient cannot be taken (the bias's gradient is
    recomputed outside the kernels, which cannot regenerate the mask), and
    the heads must be fewer than :data:`MAX_DROPOUT_HEADS`."""
    if not dropout_p:
        return None
    if dropout_seed is None:
        raise ValueError("dropout_p > 0 requires dropout_seed")
    if bias_grad:
        raise ValueError(
            "bias_grad with attention dropout is unsupported: the dbias "
            "recompute cannot regenerate the in-kernel mask (pass "
            "bias_grad=False for constant masks)")
    if heads >= MAX_DROPOUT_HEADS:
        raise ValueError(f"in-kernel dropout supports < {MAX_DROPOUT_HEADS} "
                         f"heads (got {heads})")
    seed = [int(w) for w in torch.as_tensor(dropout_seed).reshape(-1).tolist()]
    if len(seed) != 2:
        raise ValueError(f"dropout_seed must be two words, got {seed}")
    return tuple(w & 0xFFFFFFFF for w in seed)


def flash_attention(q, k, v, bias=None, *, causal=False, scale=None,
                    block_q=DEFAULT_BLOCK_Q, block_k=DEFAULT_BLOCK_K,
                    interpret=None, bias_grad=True, dropout_p=0.0,
                    dropout_seed=None):
    """Blockwise flash attention (the JAX package's signature).

    Args:
      q, k, v: ``(batch, seq, heads, head_dim)`` (paddle layout).
      bias: optional additive mask (bool masks are converted), shape
        ``(sq, sk)`` or ``(B|1, H|1, sq, sk)``.
      causal: bottom-right-aligned causal mask.
      scale: softmax scale; default ``1/sqrt(head_dim)``.
      bias_grad: whether the backward computes the bias's gradient (False:
        the bias is a constant).
      block_q, block_k, interpret: TPU matters, unused.
      dropout_p: attention-probability dropout rate, applied inside the
        kernels (no mask in device memory).
      dropout_seed: two int32 words; the forward and backward kernels
        regenerate the same keep-mask from them.

    CPU tensors take the plain versions; CUDA tensors launch K1, and K2 and
    K3 in the backward. Returns ``(batch, seq_q, heads, head_dim)``.
    """
    dropout_p = float(dropout_p)
    bias = _bias_4d(bias)
    seed = dropout_seed_words(dropout_p, dropout_seed, q.shape[2],
                              bias is not None and bias_grad)
    if bias is not None and not bias_grad:
        bias = bias.detach()
    scale = _scale(q, scale)
    if needs_grad(q, k, v, bias):
        return _Flash.apply(q, k, v, bias, bool(causal), scale, dropout_p,
                            seed)
    return flash_attention_fwd(q, k, v, bias, bool(causal), scale, dropout_p,
                               seed)[0]


flash_attention_fwd.launches = 0
flash_attention_fwd.dropout_launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.dropout_launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.dropout_launches = 0
