"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card (marker ``cuda``) and skip without one. They
import nothing of JAX, so they also run where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Tolerances (kernel vs plain version on the same card and inputs): fp32
outputs agree to 5e-5 absolute (other summation order, ``__expf``; K6's dq
is summed with atomics in an order that varies from run to run); bf16 and
fp16 outputs round the same fp32 value once, so they agree to one step of
the type: |Δ| <= 2^-7 · max(1, |ref|) for bf16, 2^-10 · max(1, |ref|) for
fp16. K1-K3 (the layout-swapping flash attention) are held to the same
limits (at bf16 and fp16 up to head dim 128 K1 and K3 round p, and K2 and
K3 ds * scale, to the input type before their products, as do their plain
versions; K5 runs K1's forward and rounds p the same way), and their
gradients, summed without atomics, must be the same bits from launch to
launch. K4 (p rounded on its tensor-core prefill and its split-key
decode) and K6 (p and ds * scale rounded on its tensor-core pass) are held
to those limits too, and at 2-byte types also to a quarter step in
relative L2 norm; K4's split-key merge runs in a fixed order and must give
the same bits twice. The one exception is K8's fp32 dgamma and dbeta:
sums of one term a row, taken in another order than the plain version's,
where each addition rounds by up to 2^-24 of the running sum, so they are
held to 1e-4 · max(1, |ref|) + 1e-7 · rows (about 3e-4 apart at 24576 rows
on an H100); summed in a fixed order, they must be the same bits twice. K9-K11 at bf16 hold their fp32 loss and logsumexp to one bf16
step of the largest value (the tile products are exact products summed in
fp32 in another order) and their bf16 gradients to one bf16 step; K10 and
K11 (no atomics, sums in a fixed order) must give the same bits twice.
The encoders' shapes are held to the same limits: K7/K8 at width 1024 with
eps 1e-12 (K7 on bf16 and fp32 rows, beta exactly on a row of zero
variance) and K9-K11 at hidden 1024 with vocabularies 18000 (bias) and
30522, 85 % of the labels ignored (dx exactly 0 on those rows).
"""
import math

import pytest
import torch

from paddle_tpu_torch.nn import LayerNorm
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.ops.cuda import flash_attention as k1
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


def _assert_rel(got, want):
    """2-byte outputs: a quarter of one step of the type in relative L2
    norm (one rounding of each output gives far less; a dropped tile or a
    wrong scale gives percents even where every value is below 1)."""
    if got.dtype == torch.float32:
        return
    g, w = got.float(), want.float()
    norm = float(w.norm())
    if norm > 0:
        rel = float((g - w).norm()) / norm
        assert rel <= _STEP[got.dtype] / 4, f"relative L2 {rel}"


def _param_grad_tol(rows):
    """K8's fp32 dgamma/dbeta tolerance over ``rows`` rows (module
    docstring)."""
    return {"fp32_atol": 1e-7 * rows, "fp32_rtol": 1e-4}


# rows not a multiple of a CTA's 8 warps; widths above 4096 (C5: GPT-NeoX
# 20B's 6144 and GPT-3 175B's 12288 class) take the general kernels, and
# above 24576 the general K8 sums its partials in device memory
_LN_WIDE = [(1, 4224), (7, 4224), (1, 5120), (7, 5120), (1, 12288),
            (7, 12288), (3, 25600)]


@pytest.mark.parametrize("rows,feat", [(1, 768), (8, 768), (1000, 768),
                                       (5, 128), (3, 4096), (7, 100),
                                       (7, 768), (9, 1536), (333, 1536),
                                       (1000, 100), *_LN_WIDE])
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
    (1, 300, 2048, 16, 96, torch.bfloat16),    # GPT-3 Large prefill
    (8, 1, 2048, 16, 96, torch.bfloat16),      # GPT-3 Large decode
    (2, 9, 65, 3, 96, torch.float32),
    # head dims in the next instantiated width (zero-filled columns):
    # GPT-3 2.7B's 80 (prefill and decode), 256, and 20 (rows not 16-byte
    # aligned: plain loads)
    (1, 300, 512, 32, 80, torch.bfloat16),
    (8, 1, 2048, 32, 80, torch.bfloat16),
    (2, 40, 130, 2, 256, torch.bfloat16),
    (2, 9, 65, 2, 256, torch.float32),
    (2, 9, 65, 3, 20, torch.float16),
    # above 256 (the chunked kernel: q and K in 128-column chunks, the
    # output in 256-column slices): a ragged last chunk, two slices, decode
    (2, 9, 65, 2, 320, torch.bfloat16),
    (1, 40, 100, 2, 512, torch.float32),
    (4, 1, 300, 2, 300, torch.float16),
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
    want = k4.flash_attention_cached_plain(q, k, v, q_pos, kv_len)
    _assert_close(got, want)
    _assert_rel(got, want)
    assert bool((got[0, 0] == 0).all())
    got = k4.flash_attention_cached(q, k, v, q_pos, None,
                                    scale=0.5 / math.sqrt(d))
    _assert_close(got, k4.flash_attention_cached_plain(
        q, k, v, q_pos, None, scale=0.5 / math.sqrt(d)))


@pytest.mark.parametrize("sq,d,dtype", [(1, 64, torch.bfloat16),
                                        (5, 96, torch.bfloat16),
                                        (1, 128, torch.float16),
                                        (3, 64, torch.float32)])
def test_cached_decode_parts_and_merge(dev, sq, d, dtype):
    """The split-key route at slot prefixes of 0, 1, 255, 256, 257 and 2047
    keys over a 2048-row cache: empty slots, parts that end at, one before
    and one after a part boundary, and 16 parts; each against the plain
    version, the empty slot exactly 0, and the merge of the parts (in part
    order) the same bits on a second run."""
    prefix = torch.tensor([0, 1, 255, 256, 257, 2047])
    b, sk, h = len(prefix), 2048, 4
    assert k4.cached_route(dtype, sq, d) == "split"
    q, k, v = _qkv(dev, dtype, b, sq, sk, h, d, seed=sq + d)
    # the last query row sits at the slot's last key; verify rows before it
    q_pos = (prefix[:, None] - sq + torch.arange(sq)[None]).int().to(dev)
    kv_len = prefix.int().to(dev)
    got = k4.flash_attention_cached(q, k, v, q_pos, kv_len)
    torch.cuda.synchronize()
    want = k4.flash_attention_cached_plain(q, k, v, q_pos, kv_len)
    _assert_close(got, want)
    _assert_rel(got, want)
    assert bool((got[0] == 0).all())
    assert torch.equal(got, k4.flash_attention_cached(q, k, v, q_pos, kv_len))
    # parts: 16 launched for each (slot, head); live as far as each prefix
    # reaches (none for the empty slot)
    again, launched, live = k4.flash_attention_cached_parts(
        q, k, v, q_pos, kv_len)
    assert torch.equal(again, got)
    assert launched == 16 * b * h
    assert live == h * (0 + 1 + 2 + 2 + 3 + 16)


def test_cached_plan_of_the_library_matches_the_plain_version(dev):
    """The library's route and key parts for K4 (which size the split
    workspace) are the ones the plain version follows, across the route
    edges: 8 and 9 query rows, widths 128/129 and 256/257, every type, and
    caches of 0, 1, 127, 128, 129 and 2047 rows."""
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for sq in (1, 5, 8, 9, 64):
            for d in (32, 64, 80, 96, 128, 129, 256, 257, 320):
                for sk in (0, 1, 127, 128, 129, 2047):
                    route, parts, floats = k4.cached_plan(2, sq, sk, 3, d,
                                                          dtype)
                    assert route == k4.cached_route(dtype, sq, d)
                    split = route == "split"
                    assert parts == (k4.split_parts(sk) if split else 0)
                    assert floats == (2 * 3 * parts * sq * (d + 2)
                                      if split else 0)


def test_cached_split_refuses_a_short_workspace(dev):
    """The split-key entry checks the workspace's size against its own part
    rule: one float short is refused before any launch."""
    import ctypes

    from paddle_tpu_torch.ops.cuda._build import dtype_code, library, stream_of
    b, sq, sk, h, d = 2, 1, 300, 4, 64
    q, k, v = _qkv(dev, torch.bfloat16, b, sq, sk, h, d, seed=7)
    qp = torch.full((b, sq), sk - 1, dtype=torch.int32, device=dev)
    out = torch.empty_like(q)
    _, _, floats = k4.cached_plan(b, sq, sk, h, d, q.dtype)
    ws = torch.empty(floats, dtype=torch.float32, device=dev)
    args = (b, sq, sk, h, d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], 0.125, dtype_code(q.dtype), stream_of(q))
    lib = library()
    ctas = ctypes.c_longlong(-1)
    assert lib.ptt_flash_attention_cached_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(), None,
        out.data_ptr(), ws.data_ptr(), floats - 1, ctypes.byref(ctas),
        *args) != 0
    assert ctas.value == 0
    assert lib.ptt_flash_attention_cached_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(), None,
        out.data_ptr(), ws.data_ptr(), floats, ctypes.byref(ctas), *args) == 0
    assert ctas.value == 3 * b * h


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
    """Rows that are not 16-byte aligned load with plain loads in the same
    kernel: the bits of the same inputs made contiguous, and the plain
    version's values."""
    q = torch.randn(1, 4, 2, 65, device=dev, dtype=torch.bfloat16)[..., 1:]
    qp = torch.arange(4, dtype=torch.int32, device=dev)[None]
    before = k4.flash_attention_cached.launches
    got = k4.flash_attention_cached(q, q, q, qp)
    assert k4.flash_attention_cached.launches == before + 1
    qc = q.contiguous()
    assert torch.equal(got, k4.flash_attention_cached(qc, qc, qc, qp))
    _assert_close(got, k4.flash_attention_cached_plain(q, q, q, qp))


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
# (rows 0..39 see no key; the boundary falls inside the first 64-row tile;
# fp32 on K6's FMA route, bf16 on its tensor-core route),
# sq < sk with ragged tiles, a bias that masks a whole row, and d = 32/128
_PACKED = [
    (2, 256, 256, 4, 64, torch.bfloat16, True, False),
    (2, 100, 60, 2, 64, torch.float32, True, False),
    (2, 100, 60, 2, 64, torch.bfloat16, True, False),
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
        _assert_rel(got, ref)
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
                                       (300, 128), (5, 100), (1000, 768),
                                       (9, 1536), *_LN_WIDE])
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


# the encoders' LayerNorms (BERT-large, ERNIE-large): width 1024, eps
# 1e-12; bf16 rows, and the fp32 rows a padding mask gives K7 (attention
# promotes against the fp32 mask); rows of zero variance, where the
# statistics rest on eps alone, give beta exactly (a constant with bf16's 8
# significant bits sums exactly in fp32)
@pytest.mark.parametrize("rows", [1, 7, 4096])
@pytest.mark.parametrize("xdt", [torch.bfloat16, torch.float32])
def test_layer_norm_kernels_at_the_encoder_width(dev, rows, xdt):
    g = torch.Generator(device="cpu").manual_seed(rows)
    x = (torch.randn(rows, 1024, generator=g) * 3 + 1).to(dev, xdt)
    gamma = (1 + 0.1 * torch.randn(1024, generator=g)).to(dev)
    beta = (0.1 * torch.randn(1024, generator=g)).to(dev)
    dy = torch.randn(rows, 1024, generator=g).to(dev, xdt)
    _assert_close(k7.layer_norm(x, gamma, beta, 1e-12),
                  k7.layer_norm_plain(x, gamma, beta, 1e-12))
    flat = x.clone()
    flat[0] = flat[0, 0].to(torch.bfloat16).to(xdt)
    got = k7.layer_norm(flat, gamma, beta, 1e-12)
    _assert_close(got, k7.layer_norm_plain(flat, gamma, beta, 1e-12))
    assert torch.equal(got[0], beta.to(xdt))
    if xdt == torch.float32:
        return
    dx, dgamma, dbeta = k7.layer_norm_bwd(x, gamma, dy, 1e-12)
    want = k7.layer_norm_bwd_plain(x, gamma, dy, 1e-12)
    _assert_close(dx, want[0])
    _assert_close(dgamma, want[1], **_param_grad_tol(rows))
    _assert_close(dbeta, want[2], **_param_grad_tol(rows))


@pytest.mark.parametrize("rows,feat,accesses", [(24576, 768, 3),
                                                (16384, 1536, 6)])
def test_layer_norm_bwd_gives_the_same_bits_twice(dev, rows, feat, accesses):
    """K8 at the train shapes runs the row kernel on 16-byte vectors and
    sums dgamma/dbeta in a fixed order: two launches, the same bits."""
    g = torch.Generator(device="cpu").manual_seed(feat)
    x = (torch.randn(rows, feat, generator=g) * 2).to(dev, torch.bfloat16)
    gamma = (1 + 0.1 * torch.randn(feat, generator=g)).to(dev)
    dy = torch.randn(rows, feat, generator=g).to(dev, torch.bfloat16)
    plan = k7.kernel_plan(x, dy)
    assert plan["kernel"] == "rows, 16-byte vectors"
    assert plan["accesses_per_lane"] == accesses
    first = k7.layer_norm_bwd(x, gamma, dy, 1e-5)
    second = k7.layer_norm_bwd(x, gamma, dy, 1e-5)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rows,feat,kernel", [
    (1000, 100, "rows, single elements"),
    (9, 768, "general, single elements"),
    (7, 5120, "general, single elements")])
@pytest.mark.parametrize("xdt", [torch.bfloat16, torch.float32])
def test_layer_norm_kernels_read_a_view_at_an_odd_offset(dev, rows, feat,
                                                         kernel, xdt):
    """Contiguous views one element into their storage are not 16-byte
    aligned: K7 and K8 read them one element an access."""
    g = torch.Generator(device="cpu").manual_seed(rows * feat)
    buf = (torch.randn(rows * feat + 1, generator=g) * 3 + 1).to(dev, xdt)
    dbuf = torch.randn(rows * feat + 1, generator=g).to(dev, xdt)
    x, dy = buf[1:].view(rows, feat), dbuf[1:].view(rows, feat)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    gamma = (1 + 0.1 * torch.randn(feat, generator=g)).to(dev)
    beta = (0.1 * torch.randn(feat, generator=g)).to(dev)
    assert k7.kernel_plan(x)["kernel"] == kernel
    _assert_close(k7.layer_norm(x, gamma, beta, 1e-5),
                  k7.layer_norm_plain(x, gamma, beta, 1e-5))
    got = k7.layer_norm_bwd(x, gamma, dy, 1e-5)
    want = k7.layer_norm_bwd_plain(x, gamma, dy, 1e-5)
    _assert_close(got[0], want[0])
    _assert_close(got[1], want[1], **_param_grad_tol(rows))
    _assert_close(got[2], want[2], **_param_grad_tol(rows))


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


def _k1_counts():
    return (k1.flash_attention_fwd.launches,
            k1.flash_attention_bwd_dq.launches,
            k1.flash_attention_bwd_dkv.launches)


def test_router_sends_training_attention_to_k5_k6_on_the_card(dev):
    """At sq·sk >= 1024² a causal call takes K5 and K6; a 4-D mask or a head
    dim the packed kernels do not take (GPT-3 Large's 96) takes K1, and K2
    and K3 in the backward; with dropout in training they launch with
    in-kernel dropout."""
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
    before = _k1_counts()
    out = PF.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    out.sum().backward()
    assert _k1_counts() == tuple(c + 1 for c in before)
    odd = torch.randn(1, 1024, 3, 2, 96, device=dev, requires_grad=True)
    before = _k1_counts()
    out = PF.scaled_dot_product_attention(odd[:, :, 0], odd[:, :, 1],
                                          odd[:, :, 2], is_causal=True)
    out.sum().backward()
    assert _k1_counts() == tuple(c + 1 for c in before)
    assert (k5.flash_attention_packed_fwd.launches,
            k5.flash_attention_packed_bwd.launches) == (counts[0] + 1,
                                                        counts[1] + 1)
    # dropout in training: K5 and K6 with in-kernel dropout, keyed by two
    # seed words of the port's generator
    drops = (k5.flash_attention_packed_fwd.dropout_launches,
             k5.flash_attention_packed_bwd.dropout_launches)
    out = PF.scaled_dot_product_attention(q, k, v, dropout_p=0.1,
                                          is_causal=True, training=True)
    out.sum().backward()
    assert (k5.flash_attention_packed_fwd.dropout_launches,
            k5.flash_attention_packed_bwd.dropout_launches) == (
                drops[0] + 1, drops[1] + 1)
    # ... and K1-K3 for a head dim the packed kernels do not take
    drops = (k1.flash_attention_fwd.dropout_launches,
             k1.flash_attention_bwd_dkv.dropout_launches)
    out = PF.scaled_dot_product_attention(odd[:, :, 0], odd[:, :, 1],
                                          odd[:, :, 2], dropout_p=0.1,
                                          is_causal=True, training=True)
    out.sum().backward()
    assert (k1.flash_attention_fwd.dropout_launches,
            k1.flash_attention_bwd_dkv.dropout_launches) == (
                drops[0] + 1, drops[1] + 1)


# (b, sq, sk, h, d, dtype, causal, bias (B, H) or None): GPT-3 Large's head
# dim; sq > sk (rows 0..99 see no key, the boundary inside a 64-row tile)
# with a per-batch bias; ragged lengths; per-head and shared 4-D biases;
# every other head dim and type. A bias masks row 3 and key 5 everywhere.
# bf16 and fp16 run K1 and K3 on the tensor cores, fp32 on FMA; then the
# tensor-core route at every head dim in both types: ragged sq = sk = 77,
# causal sq 300 > sk 200, (2, 1) and (1, H) biases, 5 and 3 query tiles
_FLASH = [
    (2, 256, 256, 4, 96, torch.bfloat16, True, None),
    (2, 300, 200, 2, 96, torch.bfloat16, True, (2, 1)),
    (1, 130, 70, 3, 96, torch.float32, True, (1, 3)),
    (2, 65, 129, 2, 80, torch.float16, False, (2, 2)),
    (1, 100, 100, 2, 32, torch.float32, True, None),
    (2, 64, 192, 2, 64, torch.bfloat16, True, (1, 1)),
    (1, 77, 77, 2, 128, torch.float32, False, (1, 2)),
    (2, 77, 77, 2, 32, torch.bfloat16, True, None),
    (1, 77, 77, 3, 32, torch.float16, False, (1, 3)),
    (2, 320, 320, 2, 64, torch.float16, True, None),
    (2, 300, 200, 2, 80, torch.bfloat16, True, (2, 1)),
    (1, 300, 200, 4, 96, torch.float16, True, (1, 4)),
    (2, 77, 77, 2, 128, torch.bfloat16, True, (2, 1)),
    (1, 192, 130, 2, 128, torch.float16, False, (1, 2)),
    # head dims in the next instantiated width (zero-filled columns): 16,
    # 48 and 112 on the tensor cores, 256 on FMA with 32 x 32 tiles, 20
    # (rows not 16-byte aligned: plain loads)
    (1, 100, 100, 2, 16, torch.bfloat16, True, None),
    (2, 130, 130, 2, 48, torch.float16, True, (1, 2)),
    (1, 100, 150, 2, 112, torch.bfloat16, True, None),
    (2, 130, 100, 2, 256, torch.bfloat16, True, (2, 1)),
    (1, 70, 70, 2, 256, torch.float32, False, None),
    (1, 77, 77, 2, 20, torch.bfloat16, True, (1, 1)),
    # above 256 (chunked FMA kernels in every type): a ragged last chunk
    # with sq > sk and a bias, two output slices, a head dim not a multiple
    # of 16
    (1, 100, 90, 2, 320, torch.bfloat16, True, (1, 2)),
    (1, 70, 130, 2, 512, torch.float16, False, None),
    (1, 65, 65, 2, 300, torch.float32, True, None),
]


def _flash_inputs(dev, dtype, b, sq, sk, h, d, bias_bh, seed):
    """q, k, v as strided views of fused qkv buffers (b, s, 3, h, d), as the
    GPT layer hands them over, and an fp32 (B|1, H|1, sq, sk) bias."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    qkv_q = torch.randn(b, sq, 3, h, d, generator=g).to(dev, dtype)
    qkv_k = torch.randn(b, sk, 3, h, d, generator=g).to(dev, dtype)
    bias = None
    if bias_bh is not None:
        bias = 0.5 * torch.randn(*bias_bh, sq, sk, generator=g)
        bias[:, :, 3] = k1.NEG_INF
        bias[:, :, :, 5] = k1.NEG_INF
        bias = bias.to(dev)
    return qkv_q[:, :, 0], qkv_k[:, :, 1], qkv_k[:, :, 2], bias


@pytest.mark.parametrize("b,sq,sk,h,d,dtype,causal,bias_bh", _FLASH)
def test_flash_attention_kernels_match_plain(dev, b, sq, sk, h, d, dtype,
                                             causal, bias_bh):
    q, k, v, bias = _flash_inputs(dev, dtype, b, sq, sk, h, d, bias_bh,
                                  seed=sq + sk + d)
    before = _k1_counts()
    out, lse = k1.flash_attention_fwd(q, k, v, bias, causal)
    torch.cuda.synchronize()
    want_out, want_lse = k1.flash_attention_fwd_plain(q, k, v, bias, causal)
    _assert_close(out, want_out)
    _assert_close(lse, want_lse)
    rows = torch.zeros(sq, dtype=torch.bool)
    if causal and sq > sk:
        rows[:sq - sk] = True
    if bias is not None:
        rows[3] = True
    rows = rows.to(dev)
    assert bool((out[:, rows] == 0).all())

    g = torch.Generator(device="cpu").manual_seed(7)
    dout = torch.randn(b, sq, h, d, generator=g).to(dev, dtype)
    dq = k1.flash_attention_bwd_dq(q, k, v, out, lse, dout, bias, causal)
    dk, dv = k1.flash_attention_bwd_dkv(q, k, v, out, lse, dout, bias, causal)
    torch.cuda.synchronize()
    assert _k1_counts() == tuple(c + 1 for c in before)
    args = (q, k, v, out, lse, dout, bias, causal)
    _assert_close(dq, k1.flash_attention_bwd_dq_plain(*args))
    for got, ref in zip((dk, dv), k1.flash_attention_bwd_dkv_plain(*args)):
        _assert_close(got, ref)
    assert bool((dq[:, rows] == 0).all())
    if bias is not None:           # key 5 is seen by no row
        assert bool((dk[:, 5] == 0).all()) and bool((dv[:, 5] == 0).all())
    # no atomics: the same bits from run to run
    assert torch.equal(dq, k1.flash_attention_bwd_dq(*args))
    again = k1.flash_attention_bwd_dkv(*args)
    assert torch.equal(dk, again[0]) and torch.equal(dv, again[1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_attention_reads_misaligned_views(dev, dtype):
    """q, k and v whose base and rows are not 16-byte aligned (views one
    element into a wider buffer) load their tiles with plain loads in the
    same tensor-core kernels: the bits of the same inputs made contiguous."""
    b, s, h, d = 2, 150, 2, 96
    g = torch.Generator(device="cpu").manual_seed(12)
    wide = torch.randn(3, b, s, h, d + 1, generator=g).to(dev, dtype)
    q, k, v = (wide[i, ..., 1:] for i in range(3))
    assert q.data_ptr() % 16 and q.stride(1) % 8
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    out, lse = k1.flash_attention_fwd(q, k, v, None, True)
    want_out, want_lse = k1.flash_attention_fwd(qc, kc, vc, None, True)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    _assert_close(out, k1.flash_attention_fwd_plain(q, k, v, None, True)[0])
    dout = torch.randn(b, s, h, d, generator=g).to(dev, dtype)
    got = k1.flash_attention_bwd_dkv(q, k, v, out, lse, dout, None, True)
    want = k1.flash_attention_bwd_dkv(qc, kc, vc, out, lse, dout, None, True)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    ref = k1.flash_attention_bwd_dkv_plain(q, k, v, out, lse, dout, None,
                                           True)
    for a, w in zip(got, ref):
        _assert_close(a, w)
    dq = k1.flash_attention_bwd_dq(q, k, v, out, lse, dout, None, True)
    assert torch.equal(dq, k1.flash_attention_bwd_dq(qc, kc, vc, out, lse,
                                                     dout, None, True))
    _assert_close(dq, k1.flash_attention_bwd_dq_plain(q, k, v, out, lse,
                                                      dout, None, True))


def test_flash_attention_routes_by_dtype():
    assert k1.kernel_route(torch.bfloat16) == "mma.sync"
    assert k1.kernel_route(torch.float16) == "mma.sync"
    assert k1.kernel_route(torch.float32) == "fma"
    assert k1.kernel_route(torch.bfloat16, 128) == "mma.sync"
    assert k1.kernel_route(torch.bfloat16, 256) == "fma"
    assert k1.kernel_route(torch.float16, 320) == "fma"


# (b, sq, sk, h, d, dtype, causal, bias (B, H) or None) with dropout 0.3:
# the tensor-core route, FMA (fp32, and width 256), a constant bias and a
# causal boundary inside a tile
_FLASH_DROPOUT = [
    (2, 200, 200, 3, 96, torch.bfloat16, True, None),
    (1, 130, 100, 2, 64, torch.float32, True, (1, 2)),
    (2, 100, 130, 2, 32, torch.float16, False, None),
    (1, 90, 90, 2, 256, torch.bfloat16, True, None),
    (1, 90, 80, 2, 320, torch.bfloat16, True, None),
]
_SEED = (0x9E3779B9, 12345)


@pytest.mark.parametrize("b,sq,sk,h,d,dtype,causal,bias_bh", _FLASH_DROPOUT)
def test_flash_attention_dropout_matches_plain(dev, b, sq, sk, h, d, dtype,
                                               causal, bias_bh):
    """K1-K3 with in-kernel dropout against their plain versions on the
    same seed (one Philox mask), under the dropout-0 limits; the same bits
    from run to run; each launch counted as a dropout launch."""
    q, k, v, bias = _flash_inputs(dev, dtype, b, sq, sk, h, d, bias_bh,
                                  seed=sq + d)
    drop = (0.3, _SEED)
    before = (k1.flash_attention_fwd.dropout_launches,
              k1.flash_attention_bwd_dq.dropout_launches,
              k1.flash_attention_bwd_dkv.dropout_launches)
    out, lse = k1.flash_attention_fwd(q, k, v, bias, causal, None, *drop)
    want_out, want_lse = k1.flash_attention_fwd_plain(q, k, v, bias, causal,
                                                      None, *drop)
    _assert_close(out, want_out)
    _assert_close(lse, want_lse)
    g = torch.Generator(device="cpu").manual_seed(8)
    dout = torch.randn(b, sq, h, d, generator=g).to(dev, dtype)
    args = (q, k, v, out, lse, dout, bias, causal, None)
    dq = k1.flash_attention_bwd_dq(*args, *drop)
    dk, dv = k1.flash_attention_bwd_dkv(*args, *drop)
    torch.cuda.synchronize()
    assert (k1.flash_attention_fwd.dropout_launches,
            k1.flash_attention_bwd_dq.dropout_launches,
            k1.flash_attention_bwd_dkv.dropout_launches) == tuple(
                c + 1 for c in before)
    _assert_close(dq, k1.flash_attention_bwd_dq_plain(*args, *drop))
    for got, ref in zip((dk, dv),
                        k1.flash_attention_bwd_dkv_plain(*args, *drop)):
        _assert_close(got, ref)
    assert torch.equal(dq, k1.flash_attention_bwd_dq(*args, *drop))
    # another seed drops other elements
    other = k1.flash_attention_fwd(q, k, v, bias, causal, None, 0.3, (1, 2))
    assert not torch.equal(out, other[0])


@pytest.mark.parametrize("b,s,h,d,dtype", [
    (2, 300, 4, 64, torch.bfloat16), (1, 200, 2, 128, torch.float32),
    (2, 130, 4, 32, torch.float16)])
def test_packed_attention_dropout_matches_plain(dev, b, s, h, d, dtype):
    """K5/K6 with in-kernel dropout against their plain versions on the
    same seed, causal, under the dropout-0 limits."""
    q, k, v = _packed_qkv(dev, dtype, b, s, s, h, d, seed=s + d)
    drop = (0.1, _SEED)
    before = (k5.flash_attention_packed_fwd.dropout_launches,
              k5.flash_attention_packed_bwd.dropout_launches)
    out, lse = k5.flash_attention_packed_fwd(q, k, v, h, None, True, None,
                                             *drop)
    want = k5.flash_attention_packed_fwd_plain(q, k, v, h, None, True, None,
                                               *drop)
    _assert_close(out, want[0])
    _assert_close(lse, want[1])
    g = torch.Generator(device="cpu").manual_seed(9)
    dout = torch.randn(b, s, h * d, generator=g).to(dev, dtype)
    grads = k5.flash_attention_packed_bwd(q, k, v, out, lse, dout, h, None,
                                          True, None, *drop)
    torch.cuda.synchronize()
    assert (k5.flash_attention_packed_fwd.dropout_launches,
            k5.flash_attention_packed_bwd.dropout_launches) == (
                before[0] + 1, before[1] + 1)
    want = k5.flash_attention_packed_bwd_plain(q, k, v, out, lse, dout, h,
                                               None, True, None, *drop)
    for got, ref in zip(grads, want):
        _assert_close(got, ref)


@pytest.mark.parametrize("b,h,sq,sk,p", [(2, 3, 70, 77, 0.1),
                                         (1, 12, 1024, 1024, 0.5),
                                         (3, 1, 5, 9, 0.01)])
def test_device_philox_draws_the_plain_mask(dev, b, h, sq, sk, p):
    from paddle_tpu_torch.ops import philox

    got = philox.keep_mask_kernel(_SEED, b, h, sq, sk, p)
    want = philox.keep_mask(_SEED, b, h, sq, sk, p, dev)
    assert torch.equal(got, want)


def test_flash_attention_autograd_matches_plain(dev, monkeypatch):
    """The differentiable wrapper on the card (K1-K3, and PyTorch operations
    for a trainable per-head bias's gradient) against the same wrapper over
    the plain versions of the three launchers."""
    b, s, h, d = 2, 160, 2, 96
    q, k, v, bias = _flash_inputs(dev, torch.float32, b, s, s, h, d, (1, h),
                                  seed=9)
    q, k, v, bias = (t.detach().requires_grad_() for t in (q, k, v, bias))
    g = torch.Generator(device="cpu").manual_seed(4)
    dout = torch.randn(b, s, h, d, generator=g).to(dev)
    before = _k1_counts()
    out = k1.flash_attention(q, k, v, bias=bias, causal=True)
    got = torch.autograd.grad(out, (q, k, v, bias), dout)
    assert _k1_counts() == tuple(c + 1 for c in before)
    after = _k1_counts()
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        monkeypatch.setattr(k1, name, getattr(k1, name + "_plain"))
    ref = k1.flash_attention(q, k, v, bias=bias, causal=True)
    want = torch.autograd.grad(ref, (q, k, v, bias), dout)
    monkeypatch.undo()
    assert _k1_counts() == after
    _assert_close(out.detach(), ref.detach())
    for a, w in zip(got, want):
        _assert_close(a, w)
    assert bool((got[3][:, :, 3] == 0).all())


def test_flash_attention_refuses_what_it_does_not_take(dev):
    y = torch.randn(1, 64, 2, 96, device=dev)
    with pytest.raises(ValueError, match="bias"):
        k1.flash_attention_fwd(y, y, y, torch.zeros(1, 1, 64, 64, device=dev,
                                                    dtype=torch.bfloat16))
    y.requires_grad_()
    with pytest.raises(RuntimeError, match="autograd"):
        k1.flash_attention_fwd(y, y, y)


# (tokens, vocab, hidden, x dtype, w dtype, bias): the odd shape of the CPU
# parity test (tokens and vocab not multiples of the 32-row blocks), both
# buffer counts of the fp32 path (768: one buffer), the widest hidden size,
# a head-dim count of 6 n8 tiles a warp, and a mixed pair that is widened.
# bf16/fp16 widths take K10/K11's cluster kernel (kernel_plan): 128, 256 and
# 384 one CTA, 768 two, 1152 three, 1024 and 1536 four, 640 five; 1408 keeps
# the streamed route
_FCE = [
    (300, 1000, 128, torch.float32, torch.float32, True),
    (300, 1000, 128, torch.bfloat16, torch.bfloat16, True),
    (70, 77, 256, torch.bfloat16, torch.bfloat16, False),
    (64, 130, 768, torch.float32, torch.float32, False),
    (100, 300, 1024, torch.bfloat16, torch.bfloat16, True),
    (33, 200, 384, torch.bfloat16, torch.bfloat16, False),
    (90, 150, 128, torch.float32, torch.bfloat16, True),
    # fp16, and widths whose hidden streams through 256-column chunks:
    # GPT-3 Large's 1536, a ragged last chunk (1152), fp32 above 768
    (300, 1000, 768, torch.float16, torch.float16, True),
    (100, 300, 1536, torch.bfloat16, torch.bfloat16, True),
    (70, 130, 1152, torch.float16, torch.float16, False),
    (64, 130, 1024, torch.float32, torch.float32, True),
    (90, 150, 1536, torch.float32, torch.float16, True),
    # the cluster kernel: C = 2, 4 and 5 at tokens and vocab that are not
    # multiples of its 64-row blocks, fp16 at C = 4, and a width the
    # streamed kernel keeps
    (130, 1000, 768, torch.bfloat16, torch.bfloat16, False),
    (65, 129, 1536, torch.float16, torch.float16, True),
    (70, 77, 640, torch.bfloat16, torch.bfloat16, True),
    (90, 150, 1408, torch.bfloat16, torch.bfloat16, True),
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


def _close_to_max(got, want, step=2.0 ** -7):
    """One step of the operand type (bf16 by default) of the largest
    reference value (fp32 outputs of 2-byte tile products)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= step * want.float().abs().max().item(), err


@pytest.mark.parametrize("n,v,h,xdt,wdt,use_bias", _FCE)
def test_fused_ce_kernels_match_plain(dev, n, v, h, xdt, wdt, use_bias):
    x, w, b, y, go = _fce_inputs(dev, n, v, h, xdt, wdt, use_bias, n + v + h)
    c0 = k9.ce_forward.launches
    loss, lse = k9.ce_forward(x, w, b, y)
    torch.cuda.synchronize()
    assert k9.ce_forward.launches == c0 + 1
    want = k9.ce_forward_plain(x, w, b, y)
    low = xdt == wdt != torch.float32
    for got, ref in zip((loss, lse), want):
        if low:
            _close_to_max(got, ref, _STEP[xdt])
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


# the encoders' MLM heads at hidden 1024: ERNIE-large's vocabulary (18000:
# 70 full 256-column tiles and 80 columns, 281 64-column blocks and 16) with
# its bias, all labels live or 85 % ignored (g = 0 and label 0, as the
# router passes them), and BERT-large's (30522) without a bias
@pytest.mark.parametrize("n,v,use_bias,ignored", [
    (300, 18000, True, 0.0), (2048, 18000, True, 0.85),
    (1000, 30522, False, 0.85)])
def test_fused_ce_kernels_at_the_encoder_heads(dev, n, v, use_bias,
                                               ignored):
    x, w, b, y, go = _fce_inputs(dev, n, v, 1024, torch.bfloat16,
                                 torch.bfloat16, use_bias, n + v)
    drop = torch.rand(n, generator=torch.Generator().manual_seed(n)) < ignored
    drop = drop.to(dev)
    drop[:2] = True
    y[drop] = 0
    go[drop] = 0.0
    loss, lse = k9.ce_forward(x, w, b, y)
    for got, ref in zip((loss, lse), k9.ce_forward_plain(x, w, b, y)):
        _close_to_max(got, ref)
    dx = k9.ce_backward_dx(x, w, b, y, go, lse)
    dw, db = k9.ce_backward_dw(x, w, b, y, go, lse)
    assert bool((dx[drop] == 0).all())
    _assert_close(dx, k9.ce_backward_dx_plain(x, w, b, y, go, lse))
    want_dw, want_db = k9.ce_backward_dw_plain(x, w, b, y, go, lse)
    _assert_close(dw, want_dw)
    if use_bias:
        _assert_close(db, want_db)


def test_fused_ce_backward_gives_the_same_bits_twice(dev):
    """K10 and K11 at the GPT-2 124M train shape (24576 x 768 x 50304, bf16;
    the cluster kernel, two CTAs a cluster): no atomics and every sum in a
    fixed order, so dx, dW and db are the same bits on a second launch."""
    x, w, b, y, go = _fce_inputs(dev, 24576, 50304, 768, torch.bfloat16,
                                 torch.bfloat16, True, 11)
    go = go.abs() / 24576
    assert k9.kernel_plan(24576, 50304, 768, torch.bfloat16, 0)["cluster"] == 2
    lse = k9.ce_forward(x, w, b, y)[1]
    dx = k9.ce_backward_dx(x, w, b, y, go, lse)
    dw, db = k9.ce_backward_dw(x, w, b, y, go, lse)
    dx2 = k9.ce_backward_dx(x, w, b, y, go, lse)
    dw2, db2 = k9.ce_backward_dw(x, w, b, y, go, lse)
    torch.cuda.synchronize()
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    assert torch.equal(db, db2)


def test_fused_ce_plan_of_the_library_matches_kernel_plan(dev):
    """The library's K10/K11 plan (``ptt_fused_ce_plan``: route, CTAs of a
    cluster, slice columns, CTAs launched) is ``kernel_plan``'s, over every
    hidden size the gate admits up to 4096, three types, both modes and row
    counts at and around the 32- and 64-row blocks."""
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for hidden in range(128, 4097, 128):
            for n, v in ((1, 1), (63, 65), (24576, 50304)):
                for mode in (0, 1):
                    assert (k9.library_plan(n, v, hidden, dtype, mode)
                            == k9.kernel_plan(n, v, hidden, dtype, mode))


# K9's wgmma kernel at odd shapes: 300 tokens (not a multiple of its 128-row
# stripes), vocab 1000 (not a multiple of its 256-column tiles, so the last
# tile is partial, and 4 ranges merged), hidden 128 to 1536, bias on and
# off, bf16 and fp16; labels in the last partial tile
_FCE_FWD = [
    (300, 1000, 128, torch.bfloat16, True),
    (300, 1000, 128, torch.float16, False),
    (300, 1000, 384, torch.bfloat16, False),
    (300, 1000, 384, torch.float16, True),
    (300, 1000, 1408, torch.bfloat16, True),
    (300, 1000, 1408, torch.float16, False),
    (300, 1000, 1536, torch.bfloat16, False),
    (300, 1000, 1536, torch.float16, True),
    (1, 257, 256, torch.bfloat16, True),
    (4000, 3000, 768, torch.bfloat16, False),
]


@pytest.mark.parametrize("n,v,h,dtype,use_bias", _FCE_FWD)
def test_fused_ce_forward_kernel_matches_plain(dev, n, v, h, dtype, use_bias):
    x, w, b, y, _ = _fce_inputs(dev, n, v, h, dtype, dtype, use_bias, n + h)
    last = v - (v % 256 or 256)
    y[::5] = torch.randint(last, v, y[::5].shape, device=dev)
    assert k9.library_plan(n, v, h, dtype, 2)["route"] == "wgmma"
    c0 = k9.ce_forward.launches
    loss, lse = k9.ce_forward(x, w, b, y)
    torch.cuda.synchronize()
    assert k9.ce_forward.launches == c0 + 1
    for got, ref in zip((loss, lse), k9.ce_forward_plain(x, w, b, y)):
        _close_to_max(got, ref, _STEP[dtype])


def test_fused_ce_forward_gives_the_same_bits_twice(dev):
    """K9 at the GPT-2 124M train shape (24576 x 768 x 50304, bf16), where
    the plan splits the vocabulary into ranges: no atomics, the ranges'
    partials merged in a fixed order, so loss and lse are the same bits on
    a second launch."""
    x, w, b, y, _ = _fce_inputs(dev, 24576, 50304, 768, torch.bfloat16,
                                torch.bfloat16, False, 12)
    assert k9.library_plan(24576, 50304, 768, torch.bfloat16, 2)["ranges"] > 1
    a = k9.ce_forward(x, w, b, y)
    c = k9.ce_forward(x, w, b, y)
    torch.cuda.synchronize()
    assert torch.equal(a[0], c[0]) and torch.equal(a[1], c[1])


def test_fused_ce_forward_plan_of_the_library_matches_kernel_plan(dev):
    """The library's K9 plan (route, vocab ranges, tile columns, CTAs) is
    ``kernel_plan``'s for the card's SMs, over three types, every hidden
    size up to 4096 and token and vocab counts around the stripes and
    tiles."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for hidden in range(128, 4097, 128):
            for n, v in ((1, 1), (127, 257), (300, 1000), (16384, 50304),
                         (24576, 50304), (100000, 50304)):
                assert (k9.library_plan(n, v, hidden, dtype, 2)
                        == k9.kernel_plan(n, v, hidden, dtype, 2, sms))


def test_fused_ce_forward_launcher_refuses_what_it_does_not_take(dev):
    """The C entry refuses a range-partials workspace shorter than the
    plan's, none at all, and hidden sizes off the 128-column gate."""
    from paddle_tpu_torch.ops.cuda import library
    from paddle_tpu_torch.ops.cuda._build import dtype_code, stream_of

    n, v, h = 300, 1000, 128
    x, w, _, y, _ = _fce_inputs(dev, n, v, h, torch.bfloat16, torch.bfloat16,
                                False, 3)
    y = y.to(torch.int32)
    loss = torch.empty(n, device=dev)
    lse = torch.empty(n, device=dev)
    ranges = k9.library_plan(n, v, h, torch.bfloat16, 2)["ranges"]
    assert ranges > 1
    part = torch.empty(4 * ranges * n, device=dev)

    def call(floats, ptr=part.data_ptr(), hidden=h):
        return library().ptt_fused_ce_fwd(
            x.data_ptr(), w.data_ptr(), None, y.data_ptr(), loss.data_ptr(),
            lse.data_ptr(), ptr, floats, n, v, hidden, dtype_code(x.dtype),
            stream_of(x))

    assert call(part.numel()) == 0
    assert call(part.numel() - 1) != 0
    assert call(part.numel(), None) != 0
    assert call(part.numel(), hidden=64) != 0
    torch.cuda.synchronize()


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
    # fp16 and every hidden size that is a multiple of 128 are taken now;
    # other sizes and types are not
    with pytest.raises(TypeError, match="no CUDA kernel"):
        k9.ce_forward(x.double(), w.double(), None, y)
    odd = torch.zeros(16, 200, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 128"):
        k9.ce_forward(odd, odd, None, y)


# -- the vision path: channels-last against NCHW -------------------------------

def _vision_op(op, x, p):
    if op == "conv":
        return PF.conv2d(x, p[0], stride=2, padding=1)
    if op == "batch_norm":
        rm, rv = torch.zeros_like(p[0]), torch.ones_like(p[0])
        out = PF.batch_norm(x, rm, rv, p[0], p[1], training=True)
        return out, rm, rv
    return PF.max_pool2d(x, 3, 2, 1)


def _bn_affine_grads_fp64(x, go):
    xd = x.double()
    mean = xd.mean((0, 2, 3), keepdim=True)
    var = xd.var((0, 2, 3), unbiased=False, keepdim=True)
    xhat = (xd - mean) / torch.sqrt(var + 1e-5)
    return (go.double() * xhat).sum((0, 2, 3)), go.double().sum((0, 2, 3))


@pytest.mark.parametrize("op", ["conv", "batch_norm", "max_pool"])
def test_channels_last_matches_nchw_on_the_card(dev, op):
    """ResNet-50's conv (layer2's 3x3, stride 2), its training batch norm
    (bf16 x, fp32 parameters) and its max pool, each run in channels-last
    memory (layout autotune) and in NCHW on the same bf16 inputs: outputs
    and gradients within one bf16 step; the channels-last outputs
    channels-last, the batch norm's running statistics within 5e-5. The
    batch norm's fp32 gamma and beta gradients (sums over 100,352 values,
    up to ~900) are held in both layouts to an fp64 sum of the same terms
    within 5e-5 + 1e-6 · |ref|: PyTorch's channels-first kernel rounds them
    to bf16 (3.3 off at 871 on an H100), so ``F.batch_norm`` runs such an
    input channels-last."""
    from paddle_tpu_torch.incubate import autotune

    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(32, 64, 56, 56, generator=gen, device=dev).bfloat16()
    if op == "conv":
        params = [torch.randn(128, 64, 3, 3, generator=gen,
                              device=dev).bfloat16() * 0.05]
    elif op == "batch_norm":
        params = [torch.rand(64, generator=gen, device=dev) + 0.5,
                  torch.randn(64, generator=gen, device=dev)]
    else:
        params = []
    runs = []
    for layout in (False, True):
        fmt = torch.channels_last if layout else torch.contiguous_format
        leaves = [x.contiguous(memory_format=fmt).requires_grad_()] + [
            (p.contiguous(memory_format=fmt) if p.ndim == 4 else p.clone())
            .requires_grad_() for p in params]
        autotune.set_config({"layout": {"enable": layout}})
        try:
            res = _vision_op(op, *leaves[:1], leaves[1:])
        finally:
            autotune.set_config(None)
        out = res[0] if op == "batch_norm" else res
        assert out.dtype == torch.bfloat16
        assert out.is_contiguous(memory_format=fmt)
        go = torch.randn(out.shape, generator=torch.Generator(
            device=dev).manual_seed(8), device=dev).bfloat16()
        grads = torch.autograd.grad(out, leaves, go)
        if op == "batch_norm":
            for got, want in zip(grads[1:], _bn_affine_grads_fp64(x, go)):
                _assert_close(got, want.float(), fp32_rtol=1e-6)
        runs.append((res, grads))
    (ref, ref_grads), (got, got_grads) = runs
    if op == "batch_norm":
        for a, r in zip(got[1:], ref[1:]):
            assert a.dtype == torch.float32
            _assert_close(a, r)
        got, ref = got[0], ref[0]
    _assert_close(got.contiguous(), ref)
    for a, r in zip(got_grads, ref_grads):
        _assert_close(a.contiguous(), r.contiguous(), fp32_rtol=1e-6)


# ---------------------------------------------------------------------------
# the serving engine's measured footprints and the profiler's device trace
# ---------------------------------------------------------------------------
def _small_gpt(dev):
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=2, max_position_embeddings=256,
                    hidden_dropout=0.0, attention_dropout=0.0)
    model = GPTForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(0))
    return model.eval()


def test_predicted_footprints_are_measured_on_the_card(dev):
    from paddle_tpu_torch.serving import GenerationEngine, Request, Scheduler

    model = _small_gpt(dev)
    eng = GenerationEngine(model, max_batch=4, max_len=256, spec_k=2)
    sched = Scheduler(eng)
    reqs = [sched.submit(Request(prompt=list(range(1, 20 + i)),
                                 max_new_tokens=12)) for i in range(3)]
    for _ in range(3):
        sched.step()
    lengths = eng.lengths().tolist()
    rows = [k.clone() for k in eng.cache.ks]
    fp = eng.predicted_footprints()
    params = sum(p.numel() * p.element_size() for p in model.parameters())
    assert fp["timeline"] is None
    assert fp["cache_bytes"] == eng.cache.nbytes()
    # measured: the tick's transient above the weights and the cache
    assert fp["decode_peak_bytes"] > params + fp["cache_bytes"]
    assert fp["base_bytes"] == fp["decode_peak_bytes"] - fp["cache_bytes"]
    # the measurement ran on a scratch cache: no slot moved
    assert eng.lengths().tolist() == lengths
    assert all(torch.equal(a, b) for a, b in zip(rows, eng.cache.ks))
    sched.run()
    assert all(r.finish_reason == "length" for r in reqs)


def test_device_trace_names_the_ports_kernels(dev):
    import json
    import os
    import shutil

    from paddle_tpu_torch.profiler import (Profiler, ProfilerTarget,
                                           RecordEvent)
    from paddle_tpu_torch.profiler.profiler import DEVICE_TRACE
    from paddle_tpu_torch.serving import GenerationEngine

    eng = GenerationEngine(_small_gpt(dev), max_batch=2, max_len=256)
    eng.prefill(0, list(range(1, 40)))
    with Profiler(targets=[ProfilerTarget.CPU, ProfilerTarget.GPU],
                  on_trace_ready=lambda p: None) as prof:
        with RecordEvent("decode"):
            eng.decode_once([5, 0])
        torch.cuda.synchronize()
    path = os.path.join(prof.profiler_result.xplane_dir, DEVICE_TRACE)
    events = json.load(open(path))["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert any("cached_" in e["name"] and e["dur"] > 0 for e in kernels)
    assert any("ln_fwd" in e["name"] and e["dur"] > 0 for e in kernels)
    assert "decode" in {e.get("name") for e in events}
    shutil.rmtree(prof.profiler_result.xplane_dir)
