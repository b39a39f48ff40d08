"""Cached attention of the port against the JAX package, on the CPU.

* K4's plain version against the Pallas ``flash_attention_cached`` in
  interpret mode (partial ``kv_len``, a fully masked row), in fp32, and in
  bf16 on its tensor-core route (p rounded as the Pallas kernel rounds it);
  at bf16 decode and verify (its split-key route) against the JAX route
  for them (``_sdpa_blockwise``); its split-key order against its dense
  fp32 order;
* the blockwise loop against ``_sdpa_blockwise`` at decode and verify
  shapes, and its backward against the JAX custom vjp's gradients;
* the dense path against ``_sdpa_raw``;
* the router: on the CPU the port takes the JAX package's route (Pallas
  available, as under interpret mode) for the prefill, chunk, decode and
  verify shapes, and gives the same output.

Tolerance: 1e-5 absolute on outputs of magnitude ~1 (the same fp32
arithmetic in another order), 1e-4 on gradients relative to their largest
entry; bf16 outputs one bf16 step a element and a quarter step in relative
L2 norm (p rounded to bf16 at other places or not at all).
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.nn.functional import attention as JA
from paddle_tpu.ops.pallas import interpret_mode
from paddle_tpu.ops.pallas.flash_attention import flash_attention_cached

from paddle_tpu_torch.nn.functional import attention as PA
from paddle_tpu_torch.ops.cuda import flash_attention as k4
from tests.torch_port_util import FP32_TOL, both_flags, no_persistent_compile_cache  # noqa: F401


def _qkv(b, sq, sk, h, d, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, sq, h, d).astype(np.float32)
    k = rng.randn(b, sk, h, d).astype(np.float32)
    v = rng.randn(b, sk, h, d).astype(np.float32)
    return q, k, v


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


def test_k4_plain_matches_pallas_cached_kernel(no_persistent_compile_cache):
    b, sq, sk, h, d = 2, 128, 256, 2, 32
    q, k, v = _qkv(b, sq, sk, h, d)
    q_pos = np.broadcast_to(np.arange(sq, dtype=np.int32) + 64,
                            (b, sq)).copy()
    q_pos[0, 5] = -1                      # a fully masked row
    kv_len = np.array([150, 256], np.int32)  # partial for batch 0
    with interpret_mode():
        want = np.asarray(flash_attention_cached(
            *_j(q, k, v), jnp.asarray(q_pos), jnp.asarray(kv_len),
            block_q=128, block_k=128))
    got = k4.flash_attention_cached(*_t(q, k, v, q_pos, kv_len))
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_TOL, rtol=0)
    assert np.all(got.numpy()[0, 5] == 0.0)


def test_k4_plain_without_kv_len_and_explicit_scale(
        no_persistent_compile_cache):
    b, sq, sk, h, d = 1, 128, 128, 2, 16
    q, k, v = _qkv(b, sq, sk, h, d, seed=1)
    q_pos = np.arange(sq, dtype=np.int32)[None]
    with interpret_mode():
        want = np.asarray(flash_attention_cached(
            *_j(q, k, v), jnp.asarray(q_pos), None, scale=0.3,
            block_q=128, block_k=128))
    got = k4.flash_attention_cached(*_t(q, k, v, q_pos), scale=0.3)
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_TOL, rtol=0)


def test_k4_plain_matches_pallas_cached_kernel_at_head_dim_320(
        no_persistent_compile_cache):
    """Above 256, where K4 runs q and K in 128-column chunks and its output
    in 256-column slices: the plain version against the Pallas kernel at
    d = 320, with a fully masked row and a partial kv_len."""
    b, sq, sk, h, d = 2, 128, 128, 1, 320
    q, k, v = _qkv(b, sq, sk, h, d, seed=3)
    q_pos = np.broadcast_to(np.arange(sq, dtype=np.int32), (b, sq)).copy()
    q_pos[1, 7] = -1
    kv_len = np.array([100, 128], np.int32)
    with interpret_mode():
        want = np.asarray(flash_attention_cached(
            *_j(q, k, v), jnp.asarray(q_pos), jnp.asarray(kv_len),
            block_q=128, block_k=128))
    got = k4.flash_attention_cached(*_t(q, k, v, q_pos, kv_len))
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_TOL, rtol=0)
    assert np.all(got.numpy()[1, 7] == 0.0)


BF16_STEP = 2.0 ** -7


def _bf16(*arrs):
    """The same bf16 values as torch tensors and jax arrays."""
    ts = [torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)
          for a in arrs]
    return ts, [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in ts]


def _bf16_close(got, want, rel_steps=0.25):
    """One bf16 step a element, ``|d| <= 2^-7 max(1, |ref|)``, and
    ``rel_steps`` of a step (a quarter by default) in relative L2 norm."""
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    err = np.abs(g - w)
    assert np.all(err <= BF16_STEP * np.maximum(1.0, np.abs(w))), err.max()
    rel = np.linalg.norm(g - w) / np.linalg.norm(w)
    assert rel <= BF16_STEP * rel_steps, rel


def test_bf16_plain_k4_rounds_as_the_pallas_cached_kernel(
        no_persistent_compile_cache):
    """K4's plain version on its tensor-core route (bf16 prefill: K1's
    64-key online softmax under the length mask, p rounded to v's dtype
    before p v) against the Pallas ``flash_attention_cached`` in interpret
    mode, which rounds p the same way over 128-key blocks
    (flash_attention.py:575), at a 128-aligned prefill with a q_pos -1 row
    and a partial kv_len: one bf16 step a element, a quarter step in
    relative L2 norm, the masked row exactly 0."""
    b, sq, sk, h, d = 2, 128, 256, 2, 64
    q, k, v = _qkv(b, sq, sk, h, d, seed=11)
    q_pos = np.broadcast_to(np.arange(sq, dtype=np.int32) + 100,
                            (b, sq)).copy()
    q_pos[1, 9] = -1
    kv_len = np.array([170, 256], np.int32)
    (tq, tk, tv), (jq, jk, jv) = _bf16(q, k, v)
    assert k4.cached_route(torch.bfloat16, sq, d) == "mma.sync"
    with interpret_mode():
        want = flash_attention_cached(jq, jk, jv, jnp.asarray(q_pos),
                                      jnp.asarray(kv_len), block_q=128,
                                      block_k=128)
    got = k4.flash_attention_cached(tq, tk, tv, *_t(q_pos, kv_len))
    assert got.dtype == torch.bfloat16
    _bf16_close(got, want)
    assert bool((got[1, 9] == 0).all())


@pytest.mark.parametrize("sq", [1, 5])  # decode, verify (spec_k = 4)
def test_bf16_plain_k4_split_keys_match_the_jax_route(
        sq, no_persistent_compile_cache):
    """Decode and verify at bf16: K4's plain version on its split-key route
    (32-key blocks with their own maxima, p rounded to v's dtype, merged)
    against the JAX package's route for those calls, ``_sdpa_blockwise``
    (``supports_cached`` takes 128-aligned blocks only), on the same bf16
    inputs, with a kv_len 0 slot (exactly 0): one bf16 step a element and
    half a step in relative L2 norm. The JAX route keeps p in fp32 where
    the port rounds it to bf16, as the Pallas cached kernel does: without
    that rounding the two outputs are the same bits here, with it they are
    2.0e-3 to 2.3e-3 apart in relative L2 (three seeds), above a quarter
    step (1.95e-3) and below half of one."""
    b, sk, h, d = 4, 384, 2, 64
    q, k, v = _qkv(b, sq, sk, h, d, seed=12)
    pos0 = np.array([0, 100, 250, 379], np.int32)
    q_pos = pos0[:, None] + np.arange(sq, dtype=np.int32)[None]
    kv_len = np.array([0, 130, 256, 384], np.int32)
    (tq, tk, tv), (jq, jk, jv) = _bf16(q, k, v)
    assert k4.cached_route(torch.bfloat16, sq, d) == "split"
    want = JA._sdpa_blockwise.raw(jq, jk, jv, jnp.asarray(q_pos),
                                  jnp.asarray(kv_len), scale=1 / math.sqrt(d),
                                  block_q=sq, block_k=128)
    got = k4.flash_attention_cached(tq, tk, tv, *_t(q_pos, kv_len))
    assert got.dtype == torch.bfloat16
    _bf16_close(got, want, rel_steps=0.5)
    assert bool((got[0] == 0).all())


@pytest.mark.parametrize("seed", range(20, 36))
@pytest.mark.parametrize("sq", [1, 5])  # decode, verify (spec_k = 4)
def test_bf16_split_keys_stay_within_half_a_step_of_the_jax_route_per_slot(
        sq, seed, no_persistent_compile_cache):
    """The distance the port's bf16 decode and verify keep from the JAX
    package's decode route (``_sdpa_blockwise``, p in fp32) by rounding p
    to bf16 as the Pallas cached kernel does, slot by slot, over 16 seeds:
    prefixes of 0 (exactly 0 on both), 1 (p = 1: the same bits), one before,
    at and one after the 128-key part edges, and a full 512-key cache; each
    slot within one bf16 step a element and half a step in relative L2
    norm. Run with ``-s`` to print each slot's distance in bf16 steps."""
    b, sk, h, d = 8, 512, 2, 64
    q, k, v = _qkv(b, sq, sk, h, d, seed=seed)
    kv_len = np.array([0, 1, 127, 128, 129, 256, 257, 512], np.int32)
    q_pos = (kv_len - sq)[:, None] + np.arange(sq, dtype=np.int32)[None]
    (tq, tk, tv), (jq, jk, jv) = _bf16(q, k, v)
    want = np.asarray(JA._sdpa_blockwise.raw(
        jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(kv_len),
        scale=1 / math.sqrt(d), block_q=sq, block_k=128), np.float32)
    got = k4.flash_attention_cached(tq, tk, tv, *_t(q_pos, kv_len))
    steps = []
    for i in range(b):
        if kv_len[i] == 0:
            assert bool((got[i] == 0).all()) and not want[i].any()
            steps.append(0.0)
            continue
        _bf16_close(got[i], want[i], rel_steps=0.5)
        g = got[i].float().numpy()
        steps.append(float(np.linalg.norm(g - want[i])
                           / np.linalg.norm(want[i]) / BF16_STEP))
    assert steps[1] == 0.0                       # one key: p = 1 exactly
    print(f"sq {sq} seed {seed} relative L2 in bf16 steps by slot "
          f"{dict(zip(kv_len.tolist(), np.round(steps, 3).tolist()))}")


def test_split_plain_equals_the_dense_plain_in_fp32():
    """The part-merged plain version (32-key blocks with their own maxima)
    is the dense one in another order: within 1e-5 in fp32, at decode and
    verify, with an empty slot and a block with no visible key."""
    b, sk, h, d = 3, 200, 2, 32
    for sq in (1, 5):
        q, k, v = _t(*_qkv(b, sq, sk, h, d, seed=13 + sq))
        q_pos = torch.tensor([[3], [90], [199]], dtype=torch.int32) + \
            torch.arange(sq, dtype=torch.int32)[None] - sq + 1
        kv_len = torch.tensor([0, 91, 200], dtype=torch.int32)
        ok = k4._length_ok(q_pos, kv_len, sk, q.device)
        got = k4._cached_split_plain(q, k, v, ok, 0.3)
        want = k4.flash_attention_cached_plain(q, k, v, q_pos, kv_len, 0.3)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                                   rtol=0)
        assert bool((got[0] == 0).all())


@pytest.mark.parametrize("sq", [1, 5])  # decode, verify (spec_k = 4)
def test_blockwise_matches_jax_scan(sq, no_persistent_compile_cache):
    b, sk, h, d = 3, 256, 2, 16
    q, k, v = _qkv(b, sq, sk, h, d, seed=2)
    pos0 = np.array([0, 100, 251], np.int32)
    q_pos = pos0[:, None] + np.arange(sq, dtype=np.int32)[None]
    kv_len = np.array([1, 256, 200], np.int32)
    s = 1.0 / math.sqrt(d)
    want = np.asarray(JA._sdpa_blockwise.raw(
        *_j(q, k, v), jnp.asarray(q_pos), jnp.asarray(kv_len), scale=s,
        block_q=sq, block_k=64))
    got = PA._sdpa_blockwise(*_t(q, k, v, q_pos, kv_len), scale=s,
                             block_q=sq, block_k=64)
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_TOL, rtol=0)


def test_blockwise_backward_matches_jax_custom_vjp():
    """Causal long-context training without the flash kernel: q_pos from
    ``sk - sq`` and a partial ``kv_len``, tiled by 64 on both axes."""
    b, sq, sk, h, d = 2, 128, 192, 2, 16
    q, k, v = _qkv(b, sq, sk, h, d, seed=5)
    q_pos = np.broadcast_to(np.arange(sk - sq, sk, dtype=np.int32),
                            (b, sq)).copy()
    kv_len = np.array([150, 192], np.int32)
    co = np.random.RandomState(6).randn(b, sq, h, d).astype(np.float32)

    def f(q, k, v):
        out = JA._sdpa_blockwise.raw(q, k, v, jnp.asarray(q_pos),
                                     jnp.asarray(kv_len), block_q=64,
                                     block_k=64)
        return jnp.vdot(out, co)

    want = jax.grad(f, (0, 1, 2))(*_j(q, k, v))
    qt, kt, vt = (t.requires_grad_() for t in _t(q, k, v))
    out = PA._sdpa_blockwise(qt, kt, vt, *_t(q_pos, kv_len), block_q=64,
                             block_k=64)
    assert out.grad_fn is not None and "Blockwise" in out.grad_fn.name()
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(co))
    for name, a, w in zip("qkv", got, want):
        w = np.asarray(w)
        err = float(np.abs(a.numpy() - w).max() / np.abs(w).max())
        assert err < 1e-4, (name, err)


def test_dense_matches_jax_sdpa_raw():
    b, sq, sk, h, d = 2, 16, 16, 2, 8
    q, k, v = _qkv(b, sq, sk, h, d, seed=3)
    q_pos = np.broadcast_to(np.arange(sq, dtype=np.int32), (b, sq))
    kv_len = np.array([9, 16], np.int32)
    jmask = JA.LengthMask(jnp.asarray(q_pos),
                          jnp.asarray(kv_len)).additive(sk, jnp.float32)
    pmask = PA.LengthMask(*_t(q_pos, kv_len)).additive(sk, torch.float32)
    np.testing.assert_array_equal(pmask.numpy(), np.asarray(jmask))
    want = np.asarray(JA._sdpa_raw.raw(*_j(q, k, v), jmask))
    got = PA._sdpa_raw(*_t(q, k, v), pmask)
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_TOL, rtol=0)
    # causal, bottom-right aligned (sq < sk)
    want = np.asarray(JA._sdpa_raw.raw(*_j(q[:, :4], k, v), causal=True))
    got = PA._sdpa_raw(*_t(q[:, :4], k, v), causal=True)
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_TOL, rtol=0)


def _spy(monkeypatch, module, names, log):
    for name in names:
        fn = getattr(module, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            log.append(_name)
            return _fn(*a, **kw)

        monkeypatch.setattr(module, name, wrapped)


# (b, sq, sk): one-shot prefill at bucket 128, chunk 128 of a 256 row,
# decode and verify over a 256 cache, and a short prefill (dense)
_ROUTE_CASES = {
    "prefill": ((1, 128, 128), "kernel"),
    "chunk": ((1, 128, 256), "kernel"),
    "decode": ((2, 1, 256), "blockwise"),
    "verify": ((2, 5, 256), "blockwise"),
    "short": ((1, 16, 16), "dense"),
}


@pytest.mark.parametrize("case", sorted(_ROUTE_CASES))
def test_router_takes_the_jax_route_on_cpu(case, monkeypatch,
                                           no_persistent_compile_cache):
    (b, sq, sk), route = _ROUTE_CASES[case]
    h, d = 2, 16
    q, k, v = _qkv(b, sq, sk, h, d, seed=4)
    off = sk - sq
    q_pos = np.broadcast_to(off + np.arange(sq, dtype=np.int32),
                            (b, sq)).copy()
    kv_len = np.full((b,), sk - 3, np.int32)
    jlog, plog = [], []
    _spy(monkeypatch, JA, ["_sdpa_flash_cached", "_sdpa_blockwise",
                           "_sdpa_raw"], jlog)
    _spy(monkeypatch, k4, ["flash_attention_cached"], plog)
    _spy(monkeypatch, PA, ["_sdpa_blockwise", "_sdpa_raw"], plog)
    names = {"_sdpa_flash_cached": "kernel", "flash_attention_cached":
             "kernel", "_sdpa_blockwise": "blockwise", "_sdpa_raw": "dense"}
    with both_flags(blockwise_attention_min_kv=128,
                    blockwise_attention_block_k=64), interpret_mode():
        want = JA.scaled_dot_product_attention(
            *_j(q, k, v), attn_mask=JA.LengthMask(jnp.asarray(q_pos),
                                                  jnp.asarray(kv_len)))
        got = PA.scaled_dot_product_attention(
            *_t(q, k, v), attn_mask=PA.LengthMask(*_t(q_pos, kv_len)))
    assert [names[n] for n in jlog] == [route]
    assert [names[n] for n in plog] == [route]
    want = np.asarray(getattr(want, "_value", want))
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_TOL, rtol=0)


def test_length_mask_valid_matches_jax():
    q_pos = np.array([[0, 3, 7], [2, 2, -1]], np.int32)
    kv_len = np.array([5, 8], np.int32)
    want = np.asarray(JA.LengthMask(jnp.asarray(q_pos),
                                    jnp.asarray(kv_len)).valid(8))
    got = PA.LengthMask(*_t(q_pos, kv_len)).valid(8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_kernel_wrapper_refuses_a_non_cuda_device():
    q = torch.empty(1, 1, 2, 64, device="meta")
    qp = torch.zeros(1, 1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        k4.flash_attention_cached(q, q, q, qp)


def test_uncached_dropout_waits_for_the_training_slice(monkeypatch):
    """Attention dropout in training runs on the CPU: the dense path with a
    bernoulli keep-mask from the port's generator, replayed by
    ``framework.random.seed`` and equal to JAX's ``_sdpa_raw`` given the
    mask it drew."""
    from paddle_tpu_torch.framework import random as rnd

    q, k, v = _qkv(1, 4, 4, 2, 8, seed=5)
    drawn = []
    real = PA._keep_mask

    def spy(*a):
        drawn.append(real(*a))
        return drawn[-1]

    monkeypatch.setattr(PA, "_keep_mask", spy)
    outs = []
    for _ in range(2):
        rnd.seed(11)
        outs.append(PA.scaled_dot_product_attention(
            *_t(q, k, v), dropout_p=0.1, is_causal=True, training=True))
    assert torch.equal(outs[0], outs[1])
    want = np.asarray(JA._sdpa_raw.raw(*_j(q, k, v), None,
                                       jnp.asarray(drawn[0].numpy()),
                                       causal=True, dropout_p=0.1))
    np.testing.assert_allclose(outs[0].numpy(), want, atol=FP32_TOL, rtol=0)


_BF16_STEP = 2.0 ** -7
_DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
           "fp32": (jnp.float32, torch.float32)}


def _mask_pair(kind, b, sq, sk, seed):
    """The same mask for both packages: additive ``[b, 1, 1, sk]`` (an
    encoder's padding mask, -1e4 on the padded keys) in bf16 or fp32, or a
    bool ``[b, 1, sq, sk]`` keep-mask."""
    if kind == "none":
        return None, None
    rng = np.random.RandomState(seed)
    if kind == "bool":
        keep = rng.rand(b, 1, sq, sk) < 0.7
        keep[..., 0] = True
        return jnp.asarray(keep), torch.from_numpy(keep)
    keep = np.ones((b, sk), np.float32)
    keep[1, sk // 2:] = 0.0
    add = ((1.0 - keep) * -1e4)[:, None, None, :]
    jdt, tdt = _DTYPES[kind]
    return jnp.asarray(add).astype(jdt), torch.from_numpy(add).to(tdt)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask_kind", ["none", "bf16", "fp32", "bool"])
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_dense_path_promotes_as_jax(dtype, mask_kind, causal):
    """C7: the dense path computes in JAX's dtypes. The logits plus a float
    mask and the probabilities times v promote as ``jnp`` promotes, so bf16
    q/k/v with an fp32 padding mask give an fp32 output (where torch's own
    einsum would refuse the mixed operands). Values: fp32 within 1e-5 when
    the logits are fp32; bf16 q/k/v round their logits to bf16 in either
    package (in other orders), so within two bf16 steps of the largest
    output."""
    b, sq, sk, h, d = 2, 8, 8, 2, 16
    q, k, v = _qkv(b, sq, sk, h, d, seed=5)
    jdt, tdt = _DTYPES[dtype]
    jm, tm = _mask_pair(mask_kind, b, sq, sk, seed=6)
    jq, jk, jv = (a.astype(jdt) for a in _j(q, k, v))
    tq, tk, tv = (t.to(tdt) for t in _t(q, k, v))
    want = JA._sdpa_raw.raw(jq, jk, jv, jm, causal=causal)
    got = PA._sdpa_raw(tq, tk, tv, tm, causal=causal)
    assert got.dtype == {"bfloat16": torch.bfloat16,
                         "float32": torch.float32}[str(want.dtype)]
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    tol = (FP32_TOL if dtype == "fp32"
           else 2 * _BF16_STEP * float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_bf16_dense_path_with_a_padding_mask_is_fp32():
    """The encoders' case of C7, through the router: bf16 q/k/v at s 16 with
    the fp32 ``[b, 1, 1, s]`` mask take the dense path and come back
    fp32."""
    q, k, v = (t.to(torch.bfloat16) for t in _t(*_qkv(2, 16, 16, 2, 16)))
    _, mask = _mask_pair("fp32", 2, 16, 16, seed=7)
    out = PA.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          training=False)
    assert out.dtype == torch.float32 and out.shape == (2, 16, 2, 16)
