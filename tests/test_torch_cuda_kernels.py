"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card (marker ``cuda``) and skip without one. They
import nothing of JAX, so they also run where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Tolerances (kernel vs plain version on the same card and inputs): fp32
outputs agree to 5e-5 absolute (other summation order, ``__expf``; K6's dq
is summed with atomics in an order that varies from run to run); bf16 and
fp16 outputs round the same fp32 value once, so they agree to one step of
the type: |Δ| <= 2^-7 · max(1, |ref|) for bf16, 2^-10 · max(1, |ref|) for
fp16. The one exception is K8's fp32 dgamma and dbeta: sums of one term a
row, taken in another order than the plain version's, where each addition
rounds by up to 2^-24 of the running sum, so they are held to
1e-4 · max(1, |ref|) + 1e-7 · rows (about 3e-4 apart at 24576 rows on an
H100). K9-K11 at bf16 hold their fp32 loss and logsumexp to
one bf16 step of the largest value (the tile products are exact products
summed in fp32 in another order) and their bf16 gradients to one bf16 step.
"""
import math

import pytest
import torch

from paddle_tpu_torch.nn import LayerNorm
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.ops.cuda import flash_attention as k4
from paddle_tpu_torch.ops.cuda import flash_attention_packed as k5
from paddle_tpu_torch.ops.cuda import fused_ce as k9
from paddle_tpu_torch.ops.cuda import layer_norm as k7

pytestmark = pytest.mark.cuda

_STEP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _assert_close(got, want, fp32_atol=5e-5, fp32_rtol=0.0):
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    if got.dtype == torch.float32:
        tol = fp32_atol + fp32_rtol * torch.clamp_min(w.abs(), 1.0)
    else:
        tol = _STEP[got.dtype] * torch.clamp_min(w.abs(), 1.0)
    err = (g - w).abs()
    assert bool((err <= tol).all()), f"max err {err.max().item()}"


def _param_grad_tol(rows):
    """K8's fp32 dgamma/dbeta tolerance over ``rows`` rows (module
    docstring)."""
    return {"fp32_atol": 1e-7 * rows, "fp32_rtol": 1e-4}


@pytest.mark.parametrize("rows,feat", [(1, 768), (8, 768), (1000, 768),
                                       (5, 128), (3, 4096), (7, 100)])
@pytest.mark.parametrize("xdt,wdt", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.float32),
    (torch.float16, torch.float16), (torch.bfloat16, torch.bfloat16)])
def test_layer_norm_kernel_matches_plain(dev, rows, feat, xdt, wdt):
    g = torch.Generator(device="cpu").manual_seed(rows * feat)
    x = (torch.randn(rows, feat, generator=g) * 3 + 1).to(dev, xdt)
    gamma = (1 + 0.1 * torch.randn(feat, generator=g)).to(dev, wdt)
    beta = (0.1 * torch.randn(feat, generator=g)).to(dev, wdt)
    before = k7.layer_norm.launches
    got = k7.layer_norm(x, gamma, beta, 1e-5)
    torch.cuda.synchronize()
    assert k7.layer_norm.launches == before + 1
    _assert_close(got, k7.layer_norm_plain(x, gamma, beta, 1e-5))


def _qkv(dev, dtype, b, sq, sk, h, d, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn(b, s, h, d, generator=g).to(dev, dtype)
               for s in (sq, sk, sk))
    return q, k, v


# (b, sq, sk, h, d, dtype): the serving shapes of GPT-2 124M first, then
# ragged ones (sk not a tile multiple, sq across the 8-row split boundary)
_CASES = [
    (1, 1024, 1024, 12, 64, torch.bfloat16),   # prefill at bucket 1024
    (1, 256, 1024, 12, 64, torch.bfloat16),    # chunk
    (8, 1, 1024, 12, 64, torch.bfloat16),      # decode
    (8, 5, 1024, 12, 64, torch.bfloat16),      # verify
    (3, 37, 100, 2, 32, torch.float32),
    (2, 8, 33, 3, 128, torch.float16),
    (2, 9, 65, 3, 128, torch.float32),
    (1, 70, 129, 1, 64, torch.bfloat16),
]


@pytest.mark.parametrize("b,sq,sk,h,d,dtype", _CASES)
def test_cached_attention_kernel_matches_plain(dev, b, sq, sk, h, d, dtype):
    q, k, v = _qkv(dev, dtype, b, sq, sk, h, d, seed=sq * sk + d)
    g = torch.Generator(device="cpu").manual_seed(b + sq)
    start = torch.randint(0, max(1, sk - sq + 1), (b,), generator=g)
    q_pos = (start[:, None] + torch.arange(sq)[None]).int()
    q_pos[0, 0] = -1                                    # fully masked row
    kv_len = torch.randint(0, sk + 1, (b,), generator=g).int()
    kv_len[-1] = sk
    q_pos, kv_len = q_pos.to(dev), kv_len.to(dev)
    before = k4.flash_attention_cached.launches
    got = k4.flash_attention_cached(q, k, v, q_pos, kv_len)
    torch.cuda.synchronize()
    assert k4.flash_attention_cached.launches == before + 1
    _assert_close(got, k4.flash_attention_cached_plain(q, k, v, q_pos,
                                                        kv_len))
    assert bool((got[0, 0] == 0).all())
    got = k4.flash_attention_cached(q, k, v, q_pos, None,
                                    scale=0.5 / math.sqrt(d))
    _assert_close(got, k4.flash_attention_cached_plain(
        q, k, v, q_pos, None, scale=0.5 / math.sqrt(d)))


def test_cached_attention_reads_strided_views_in_place(dev):
    """q from a fused qkv projection and K/V as one slot's row view of a
    cache: strided inputs, no copies."""
    b, s, h, d, max_len = 1, 40, 4, 64, 96
    qkv = torch.randn(b, s, 3, h, d, device=dev, dtype=torch.bfloat16)
    cache_k = torch.randn(3, max_len, h, d, device=dev, dtype=torch.bfloat16)
    cache_v = torch.randn_like(cache_k)
    q = qkv[:, :, 0]
    k, v = cache_k[1:2], cache_v[1:2]
    q_pos = (30 + torch.arange(s, device=dev)).int()[None]
    got = k4.flash_attention_cached(q, k, v, q_pos)
    want = k4.flash_attention_cached_plain(q, k, v, q_pos)
    _assert_close(got, want)


def test_cached_attention_rejects_misaligned_rows(dev):
    q = torch.randn(1, 4, 2, 65, device=dev, dtype=torch.bfloat16)[..., 1:]
    qp = torch.zeros(1, 4, dtype=torch.int32, device=dev)
    before = k4.flash_attention_cached.launches
    with pytest.raises(ValueError, match="aligned"):
        k4.flash_attention_cached(q, q, q, qp)
    assert k4.flash_attention_cached.launches == before


def _packed_qkv(dev, dtype, b, sq, sk, h, d, seed):
    """q, k, v as the strided views of fused qkv projections (row stride
    3·h·d), reshaped to (b, s, h·d) without a copy."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    qkv_q = torch.randn(b, sq, 3, h, d, generator=g).to(dev, dtype)
    qkv_k = torch.randn(b, sk, 3, h, d, generator=g).to(dev, dtype)
    q = qkv_q[:, :, 0].reshape(b, sq, h * d)
    k = qkv_k[:, :, 1].reshape(b, sk, h * d)
    v = qkv_k[:, :, 2].reshape(b, sk, h * d)
    assert q.stride() == (sq * 3 * h * d, 3 * h * d, 1)
    return q, k, v


# (b, sq, sk, h, d, dtype, causal, bias): GPT-2 head shapes, then sq > sk
# (rows 0..39 see no key; the boundary falls inside the first 64-row tile),
# sq < sk with ragged tiles, a bias that masks a whole row, and d = 32/128
_PACKED = [
    (2, 256, 256, 4, 64, torch.bfloat16, True, False),
    (2, 100, 60, 2, 64, torch.float32, True, False),
    (1, 70, 130, 3, 32, torch.float16, True, True),
    (2, 65, 65, 2, 128, torch.float32, False, True),
    (1, 128, 192, 2, 64, torch.bfloat16, True, True),
]


def _bias(dev, sq, sk, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    bias = 0.5 * torch.randn(sq, sk, generator=g)
    bias[3] = k5.NEG_INF                                  # a fully masked row
    return bias.to(dev)


@pytest.mark.parametrize("b,sq,sk,h,d,dtype,causal,use_bias", _PACKED)
def test_packed_attention_kernels_match_plain(dev, b, sq, sk, h, d, dtype,
                                              causal, use_bias):
    q, k, v = _packed_qkv(dev, dtype, b, sq, sk, h, d, seed=sq + sk + d)
    bias = _bias(dev, sq, sk, seed=d) if use_bias else None
    fwd0 = k5.flash_attention_packed_fwd.launches
    out, lse = k5.flash_attention_packed_fwd(q, k, v, h, bias, causal)
    torch.cuda.synchronize()
    assert k5.flash_attention_packed_fwd.launches == fwd0 + 1
    want_out, want_lse = k5.flash_attention_packed_fwd_plain(q, k, v, h, bias,
                                                             causal)
    _assert_close(out, want_out)
    _assert_close(lse, want_lse)
    masked = torch.zeros(sq, dtype=torch.bool)
    if causal and sq > sk:
        masked[:sq - sk] = True
    if use_bias:
        masked[3] = True
    assert bool((out[:, masked.to(dev)] == 0).all())

    g = torch.Generator(device="cpu").manual_seed(7)
    dout = torch.randn(b, sq, h * d, generator=g).to(dev, dtype)
    bwd0 = k5.flash_attention_packed_bwd.launches
    grads = k5.flash_attention_packed_bwd(q, k, v, out, lse, dout, h, bias,
                                          causal)
    torch.cuda.synchronize()
    assert k5.flash_attention_packed_bwd.launches == bwd0 + 1
    want = k5.flash_attention_packed_bwd_plain(q, k, v, out, lse, dout, h,
                                               bias, causal)
    for got, ref in zip(grads, want):
        _assert_close(got, ref)
    assert bool((grads[0][:, masked.to(dev)] == 0).all())


def test_packed_attention_autograd_matches_plain(dev):
    b, s, h, d = 2, 192, 2, 64
    q, k, v = (t.detach().requires_grad_()
               for t in _packed_qkv(dev, torch.float32, b, s, s, h, d, 3))
    g = torch.Generator(device="cpu").manual_seed(4)
    dout = torch.randn(b, s, h * d, generator=g).to(dev)
    counts = (k5.flash_attention_packed_fwd.launches,
              k5.flash_attention_packed_bwd.launches)
    out = k5.flash_attention_packed(q, k, v, h, causal=True)
    got = torch.autograd.grad(out, (q, k, v), dout)
    assert (k5.flash_attention_packed_fwd.launches,
            k5.flash_attention_packed_bwd.launches) == (counts[0] + 1,
                                                        counts[1] + 1)
    ref = k5.flash_attention_packed_plain(q, k, v, h, causal=True)
    want = torch.autograd.grad(ref, (q, k, v), dout)
    _assert_close(out.detach(), ref.detach())
    for a, w in zip(got, want):
        _assert_close(a, w)


@pytest.mark.parametrize("rows,feat", [(1, 768), (7, 768), (24576, 768),
                                       (300, 128), (5, 100)])
@pytest.mark.parametrize("xdt,wdt", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.float32),
    (torch.float16, torch.float16)])
def test_layer_norm_bwd_kernel_matches_plain(dev, rows, feat, xdt, wdt):
    g = torch.Generator(device="cpu").manual_seed(rows + feat)
    x = (torch.randn(rows, feat, generator=g) * 3 + 1).to(dev, xdt)
    gamma = (1 + 0.1 * torch.randn(feat, generator=g)).to(dev, wdt)
    dy = torch.randn(rows, feat, generator=g).to(dev, xdt)
    before = k7.layer_norm_bwd.launches
    dx, dgamma, dbeta = k7.layer_norm_bwd(x, gamma, dy, 1e-5)
    torch.cuda.synchronize()
    assert k7.layer_norm_bwd.launches == before + 1
    want = k7.layer_norm_bwd_plain(x, gamma, dy, 1e-5)
    _assert_close(dx, want[0])
    _assert_close(dgamma, want[1], **_param_grad_tol(rows))
    _assert_close(dbeta, want[2], **_param_grad_tol(rows))


def test_layer_norm_grad_on_the_card_equals_plain(dev):
    """The router's LayerNorm differentiates through K7 and K8 and gives
    the plain version's gradients (x bf16, gamma/beta fp32)."""
    g = torch.Generator(device="cpu").manual_seed(0)
    ln = LayerNorm(768).to(dev)
    with torch.no_grad():
        ln.weight.copy_(1 + 0.1 * torch.randn(768, generator=g))
        ln.bias.copy_(0.1 * torch.randn(768, generator=g))
    x = torch.randn(4, 33, 768, generator=g).to(dev, torch.bfloat16)
    x.requires_grad_()
    dy = torch.randn(4, 33, 768, generator=g).to(dev, torch.bfloat16)
    counts = k7.layer_norm.launches, k7.layer_norm_bwd.launches
    y = ln(x)
    assert y.grad_fn is not None
    got = torch.autograd.grad(y, (x, ln.weight, ln.bias), dy)
    assert (k7.layer_norm.launches, k7.layer_norm_bwd.launches) == (
        counts[0] + 1, counts[1] + 1)
    ref = k7.layer_norm_plain(x, ln.weight, ln.bias)
    want = torch.autograd.grad(ref, (x, ln.weight, ln.bias), dy)
    _assert_close(y.detach(), ref.detach())
    _assert_close(got[0], want[0])
    for a, w in zip(got[1:], want[1:]):
        _assert_close(a, w, **_param_grad_tol(x.numel() // 768))


def test_forward_only_wrappers_raise_under_grad(dev):
    q = torch.randn(1, 8, 2, 64, device=dev, requires_grad=True)
    qp = torch.arange(8, dtype=torch.int32, device=dev)[None]
    with pytest.raises(RuntimeError, match="autograd"):
        k4.flash_attention_cached(q, q, q, qp)
    with torch.no_grad():
        k4.flash_attention_cached(q, q, q, qp)
    x = torch.randn(3, 128, device=dev, requires_grad=True)
    gamma = torch.ones(128, device=dev)
    with pytest.raises(RuntimeError, match="autograd"):
        k7.layer_norm_bwd(x, gamma, torch.ones_like(x))
    p = torch.randn(1, 8, 128, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="autograd"):
        k5.flash_attention_packed_fwd(p, p, p, 2)


def test_router_sends_training_attention_to_k5_k6_on_the_card(dev):
    """At sq·sk >= 1024² a causal call takes K5 and K6; a 4-D mask or a head
    dim the packed kernels do not take raises, naming the K1-K3 slice."""
    qkv = torch.randn(1, 1024, 3, 2, 64, device=dev, requires_grad=True)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    counts = (k5.flash_attention_packed_fwd.launches,
              k5.flash_attention_packed_bwd.launches)
    out = PF.scaled_dot_product_attention(q, k, v, is_causal=True)
    out.sum().backward()
    assert (k5.flash_attention_packed_fwd.launches,
            k5.flash_attention_packed_bwd.launches) == (counts[0] + 1,
                                                        counts[1] + 1)
    mask = torch.zeros(1, 2, 1024, 1024, device=dev)
    with pytest.raises(NotImplementedError, match="K1-K3"):
        PF.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    odd = torch.randn(1, 1024, 2, 96, device=dev)
    with pytest.raises(NotImplementedError, match="K1-K3"):
        PF.scaled_dot_product_attention(odd, odd, odd, is_causal=True)
    with pytest.raises(NotImplementedError, match="dropout"):
        PF.scaled_dot_product_attention(q, k, v, dropout_p=0.1,
                                        is_causal=True, training=True)


# (tokens, vocab, hidden, x dtype, w dtype, bias): the odd shape of the CPU
# parity test (tokens and vocab not multiples of the 32-row blocks), both
# buffer counts of the fp32 path (768: one buffer), the widest hidden size,
# a head-dim count of 6 n8 tiles a warp, and a mixed pair that is widened
_FCE = [
    (300, 1000, 128, torch.float32, torch.float32, True),
    (300, 1000, 128, torch.bfloat16, torch.bfloat16, True),
    (70, 77, 256, torch.bfloat16, torch.bfloat16, False),
    (64, 130, 768, torch.float32, torch.float32, False),
    (100, 300, 1024, torch.bfloat16, torch.bfloat16, True),
    (33, 200, 384, torch.bfloat16, torch.bfloat16, False),
    (90, 150, 128, torch.float32, torch.bfloat16, True),
]


def _fce_inputs(dev, n, v, h, xdt, wdt, use_bias, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(n, h, generator=g).to(dev, xdt)
    w = (0.05 * torch.randn(v, h, generator=g)).to(dev, wdt)
    b = (0.1 * torch.randn(v, generator=g)).to(dev) if use_bias else None
    y = torch.randint(0, v, (n,), generator=g).to(dev)
    go = torch.randn(n, generator=g).to(dev)
    go[:2] = 0.0                          # two ignored labels
    return x, w, b, y, go


def _close_to_max(got, want):
    """One bf16 step of the largest reference value (fp32 outputs of bf16
    tile products), or 5e-5 absolute for fp32 operands."""
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2.0 ** -7 * want.float().abs().max().item(), err


@pytest.mark.parametrize("n,v,h,xdt,wdt,use_bias", _FCE)
def test_fused_ce_kernels_match_plain(dev, n, v, h, xdt, wdt, use_bias):
    x, w, b, y, go = _fce_inputs(dev, n, v, h, xdt, wdt, use_bias, n + v + h)
    c0 = k9.ce_forward.launches
    loss, lse = k9.ce_forward(x, w, b, y)
    torch.cuda.synchronize()
    assert k9.ce_forward.launches == c0 + 1
    want = k9.ce_forward_plain(x, w, b, y)
    low = torch.bfloat16 in (xdt, wdt)
    for got, ref in zip((loss, lse), want):
        if low:
            _close_to_max(got, ref)
        else:
            _assert_close(got, ref)
    c1, c2 = k9.ce_backward_dx.launches, k9.ce_backward_dw.launches
    dx = k9.ce_backward_dx(x, w, b, y, go, lse)
    dw, db = k9.ce_backward_dw(x, w, b, y, go, lse)
    torch.cuda.synchronize()
    assert (k9.ce_backward_dx.launches, k9.ce_backward_dw.launches) == (
        c1 + 1, c2 + 1)
    assert bool((dx[:2] == 0).all())
    want_dx = k9.ce_backward_dx_plain(x, w, b, y, go, lse)
    want_dw, want_db = k9.ce_backward_dw_plain(x, w, b, y, go, lse)
    _assert_close(dx, want_dx)
    _assert_close(dw, want_dw)
    if use_bias:
        _assert_close(db, want_db)
    else:
        assert db is None


def test_fused_ce_autograd_through_the_router(dev):
    """With the flag on a CUDA tensor the loss runs K9 forward and K10/K11
    backward, never the chunked loop, and equals the plain versions'."""
    from paddle_tpu_torch.framework import get_flags, set_flags
    from paddle_tpu_torch.ops import fused

    x, w, b, y, _ = _fce_inputs(dev, 200, 500, 128, torch.float32,
                                torch.float32, True, 5)
    y[::7] = -100
    leaves = [t.detach().requires_grad_() for t in (x, w, b)]
    prev = get_flags("enable_flash_ce")
    set_flags({"enable_flash_ce": True})
    real = fused._FusedLinearCE.apply

    def no_loop(*a):
        raise AssertionError("the chunked loop ran with the flag on")

    fused._FusedLinearCE.apply = no_loop
    try:
        counts = (k9.ce_forward.launches, k9.ce_backward_dx.launches,
                  k9.ce_backward_dw.launches)
        loss = PF.fused_linear_cross_entropy(leaves[0], leaves[1], y,
                                             leaves[2])
        got = torch.autograd.grad(loss, leaves)
    finally:
        fused._FusedLinearCE.apply = real
        set_flags(prev)
    assert (k9.ce_forward.launches, k9.ce_backward_dx.launches,
            k9.ce_backward_dw.launches) == tuple(c + 1 for c in counts)
    ref = PF.fused_linear_cross_entropy(*leaves[:2], y, leaves[2])
    want = torch.autograd.grad(ref, leaves)
    _assert_close(loss.detach(), ref.detach())
    for a, r in zip(got, want):
        _assert_close(a, r)


def test_fused_ce_launchers_refuse_what_they_do_not_take(dev):
    x, w, b, y, go = _fce_inputs(dev, 16, 40, 128, torch.float32,
                                 torch.float32, False, 1)
    xg = x.detach().requires_grad_()
    with pytest.raises(RuntimeError, match="autograd"):
        k9.ce_forward(xg, w, None, y)
    lse = k9.ce_forward(x, w, None, y)[1]
    with pytest.raises(RuntimeError, match="autograd"):
        k9.ce_backward_dx(xg, w, None, y, go, lse)
    with pytest.raises(RuntimeError, match="autograd"):
        k9.ce_backward_dw(xg, w, None, y, go, lse)
    with pytest.raises(TypeError, match="bf16"):
        k9.ce_forward(x.half(), w.half(), None, y)
    wide = torch.zeros(16, 1152, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="1024"):
        k9.ce_forward(wide, wide, None, y)
    x32 = torch.zeros(16, 1024, device=dev)
    with pytest.raises(ValueError, match="768"):
        k9.ce_backward_dx(x32, x32, None, y, go, go)
