"""Packed flash attention of the port (K5/K6's plain versions through the
differentiable wrapper) against the JAX package's Pallas
``flash_attention_packed`` in interpret mode and its ``jax.grad``, on the
CPU, fp32, at B=2, S=256, H=4, D=64 (``tests/test_flash_packed.py``'s
shapes; the JAX kernel runs one 256-row tile, except where the masked-row
test sets 128).

Tolerance: 2e-5 absolute on outputs and 1e-4 on gradients relative to
their largest entry (the same fp32 arithmetic in another order: the JAX
kernel's tiled softmax against one dense softmax).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.nn.functional import attention as JA
from paddle_tpu.ops.pallas import interpret_mode
from paddle_tpu.ops.pallas.flash_attention_packed import (
    flash_attention_packed as jax_packed,
)
from paddle_tpu.ops.pallas.flash_attention_packed import supports as jax_supports

from paddle_tpu_torch.nn.functional import attention as PA
from paddle_tpu_torch.ops.cuda import flash_attention_packed as k5
from tests.torch_port_util import no_persistent_compile_cache  # noqa: F401

B, H, D = 2, 4, 64
OUT_TOL = 2e-5
GRAD_RTOL = 1e-4


def _inputs(sq, sk, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, sq, H * D).astype(np.float32)
    k = rng.randn(B, sk, H * D).astype(np.float32)
    v = rng.randn(B, sk, H * D).astype(np.float32)
    bias = (rng.randn(sq, sk) * 0.5).astype(np.float32)
    co = rng.randn(B, sq, H * D).astype(np.float32)
    return q, k, v, bias, co


def _jax_value_and_grads(q, k, v, bias, co, causal, block_q=256, block_k=256):
    def f(q, k, v):
        out = jax_packed(q, k, v, H, bias=bias, causal=causal,
                         block_q=block_q, block_k=block_k,
                         bwd_block=block_q, interpret=True)
        return jnp.vdot(out, co), out

    (_, out), grads = jax.value_and_grad(f, (0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_value_and_grads(q, k, v, bias, co, causal):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = k5.flash_attention_packed(
        qt, kt, vt, H, None if bias is None else torch.from_numpy(bias),
        causal=causal)
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(co))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _close_grads(got, want):
    for name, a, b in zip("qkv", got, want):
        err = float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))
        assert err < GRAD_RTOL, (name, err)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("use_bias", [False, True])
def test_value_and_grads_match_pallas(causal, use_bias,
                                      no_persistent_compile_cache):
    q, k, v, bias, co = _inputs(256, 256)
    bias = bias if use_bias else None
    want, want_g = _jax_value_and_grads(q, k, v, bias, co, causal)
    got, got_g = _port_value_and_grads(q, k, v, bias, co, causal)
    np.testing.assert_allclose(got, want, atol=OUT_TOL, rtol=0)
    _close_grads(got_g, want_g)


@pytest.mark.parametrize("block_q", [128, 256])
def test_fully_masked_rows_give_zero_output_and_grads(
        block_q, no_persistent_compile_cache):
    """Causal with sq=256 > sk=128: rows 0..127 see no key. At block_q=256
    the boundary falls inside the JAX kernel's tile."""
    q, k, v, _, co = _inputs(256, 128, seed=1)
    want, want_g = _jax_value_and_grads(q, k, v, None, co, True,
                                        block_q=block_q, block_k=128)
    got, got_g = _port_value_and_grads(q, k, v, None, co, True)
    np.testing.assert_allclose(got, want, atol=OUT_TOL, rtol=0)
    _close_grads(got_g, want_g)
    assert np.all(got[:, :128] == 0.0)
    assert np.all(got_g[0][:, :128] == 0.0)
    _, lse = k5.flash_attention_packed_fwd_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), H, causal=True)
    assert bool((lse[:, :, :128] == k5.NEG_INF).all())


BF16_STEP = 2.0 ** -7


@pytest.mark.parametrize("causal,use_bias", [(True, False), (False, True)])
def test_bf16_plain_k5_rounds_as_the_pallas_kernel(
        causal, use_bias, no_persistent_compile_cache):
    """K5's plain version is K1's (K5 runs K1's kernel): the 64-key online
    softmax with p rounded to v's dtype before p v, as the Pallas packed
    kernel rounds it (flash_attention_packed.py:149, :195). Against that
    kernel in interpret mode (128-key blocks, so some roundings fall
    elsewhere) on the same bf16 inputs: one bf16 step a element,
    ``|d| <= 2^-7 max(1, |ref|)``, and a quarter step in relative L2 norm;
    the logsumexp within 1e-5 (both fp32)."""
    q, k, v, bias, _ = _inputs(256, 256, seed=5)
    bias = bias if use_bias else None
    ts = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in ts)
    want = np.asarray(jax_packed(jq, jk, jv, H, bias=bias, causal=causal,
                                 block_q=128, block_k=128, interpret=True),
                      np.float32)
    got, lse = k5.flash_attention_packed_fwd_plain(
        *ts, H, None if bias is None else torch.from_numpy(bias), causal)
    assert got.dtype == torch.bfloat16
    g = got.float().numpy()
    err = np.abs(g - want)
    assert np.all(err <= BF16_STEP * np.maximum(1.0, np.abs(want))), err.max()
    rel = np.linalg.norm(g - want) / np.linalg.norm(want)
    assert rel <= BF16_STEP / 4, rel
    # the fp32 logsumexp of the same scores, from K1's plain version
    s = (torch.einsum("bqhd,bkhd->bhqk", *(t.float().reshape(B, 256, H, D)
                                             for t in ts[:2])) / D ** 0.5)
    if bias is not None:
        s = s + torch.from_numpy(bias)
    if causal:
        s = s.masked_fill(torch.ones(256, 256, dtype=torch.bool).triu(1),
                          -1e30)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), atol=1e-5,
                               rtol=1e-5)


def _bf16_close(got, want, name):
    """One bf16 step a element, ``|d| <= 2^-7 max(1, |ref|)``, and a
    quarter step in relative L2 norm."""
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    err = np.abs(g - w)
    assert np.all(err <= BF16_STEP * np.maximum(1.0, np.abs(w))), (
        name, err.max())
    rel = np.linalg.norm(g - w) / np.linalg.norm(w)
    assert rel <= BF16_STEP / 4, (name, rel)


# (sq, sk, causal, bias): causal; a shared bias; sq 256 > sk 128 causal,
# where rows 0..127 see no key
_K6_BF16 = {"causal": (256, 256, True, False),
            "shared_bias": (256, 256, False, True),
            "dead_rows": (256, 128, True, False)}


@pytest.mark.parametrize("case", sorted(_K6_BF16))
def test_bf16_plain_k6_rounds_as_the_pallas_kernel(
        case, no_persistent_compile_cache):
    """K6's plain version on its tensor-core route rounds the dropped p to
    dout's dtype before p^T dout and ds * scale to q's and k's before ds^T
    q and ds k, as the Pallas ``_bwd_fused_kernel`` does
    (flash_attention_packed.py:295, :304, :312): dq, dk and dv through the
    differentiable wrapper against ``jax.grad`` of the Pallas kernel in
    interpret mode (128-row blocks) on the same bf16 inputs, at one bf16
    step a element and a quarter step in relative L2 norm; dead rows give
    exactly 0 in dq."""
    sq, sk, causal, use_bias = _K6_BF16[case]
    q, k, v, bias, co = _inputs(sq, sk, seed=7)
    bias = bias if use_bias else None
    ts = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, co)]
    jq, jk, jv, jco = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                       for t in ts)

    def f(q_, k_, v_):
        out = jax_packed(q_, k_, v_, H, bias=bias, causal=causal,
                         block_q=128, block_k=128, bwd_block=128,
                         interpret=True)
        return jnp.vdot(out.astype(jnp.float32), jco.astype(jnp.float32))

    want = jax.grad(f, (0, 1, 2))(jq, jk, jv)
    qt, kt, vt = (t.requires_grad_() for t in ts[:3])
    out = k5.flash_attention_packed(
        qt, kt, vt, H, None if bias is None else torch.from_numpy(bias),
        causal=causal)
    got = torch.autograd.grad(out, (qt, kt, vt), ts[3])
    assert all(g.dtype == torch.bfloat16 for g in got)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _bf16_close(g, w, name)
    if sq > sk:
        assert bool((got[0][:, :sq - sk] == 0).all())


def test_shape_gate_mirrors_pallas_gate():
    for sq, sk, h, e in [(256, 256, 4, 256), (1024, 1024, 12, 768),
                         (100, 128, 2, 128), (256, 256, 3, 288),
                         (128, 128, 1, 256), (40960, 128, 2, 128)]:
        assert k5.supports(sq, sk, h, e) == jax_supports(sq, sk, h, e)


def test_router_sends_causal_training_attention_to_the_packed_wrapper(
        monkeypatch, no_persistent_compile_cache):
    """sdpa on (b, s, h, d) views of one fused qkv buffer: the CPU port takes
    the JAX route under interpret mode (its packed kernel) and gives the
    same output and gradients."""
    rng = np.random.RandomState(2)
    qkv = rng.randn(B, 256, 3, H, D).astype(np.float32)
    co = rng.randn(B, 256, H, D).astype(np.float32)
    calls = []
    real = k5.flash_attention_packed

    def spy(*a, **kw):
        calls.append(a[0].stride())
        return real(*a, **kw)

    monkeypatch.setattr(k5, "flash_attention_packed", spy)

    def jf(qkv):
        out = JA.scaled_dot_product_attention(
            qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], is_causal=True)
        out = getattr(out, "_value", out)
        return jnp.vdot(out, co), out

    with interpret_mode():
        (_, want), want_g = jax.value_and_grad(jf, has_aux=True)(
            jnp.asarray(qkv))
    qt = torch.from_numpy(qkv).requires_grad_()
    got = PA.scaled_dot_product_attention(qt[:, :, 0], qt[:, :, 1],
                                          qt[:, :, 2], is_causal=True)
    (got_g,) = torch.autograd.grad(got, (qt,), torch.from_numpy(co))
    # the packed wrapper received the qkv views as they are: no copy
    assert calls == [(256 * 3 * H * D, 3 * H * D, 1)]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=OUT_TOL, rtol=0)
    _close_grads([got_g.numpy()], [np.asarray(want_g)])
