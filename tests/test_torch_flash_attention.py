"""The port's layout-swapping flash attention (K1-K3's plain versions through
the differentiable wrapper) against the JAX package's Pallas
``flash_attention`` in interpret mode and its ``jax.grad``, on the CPU,
fp32, on seeded numpy inputs; and the attention router's K1-K3 route
against the JAX package's (``tests/test_pallas_kernels.py``'s oracles).

Tolerances, those of the JAX package's own tests: 2e-5 on outputs; 5e-5
absolute plus 5e-4 relative on gradients (the same fp32 arithmetic in
another order: the JAX kernels' tiled online softmax against one dense
softmax); exact zeros on rows with no visible key.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.nn.functional import attention as JA
from paddle_tpu.ops.pallas import interpret_mode
from paddle_tpu.ops.pallas.flash_attention import flash_attention as jax_fa

from paddle_tpu_torch.nn.functional import attention as PA
from paddle_tpu_torch.ops.cuda import flash_attention as k1
from tests.torch_port_util import gpt_pair, no_persistent_compile_cache  # noqa: F401

OUT_TOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 5e-5, 5e-4


def _qkv(b, sq, sk, h, d, seed):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, sq, h, d) * 0.5).astype(np.float32)
    k = (rng.randn(b, sk, h, d) * 0.5).astype(np.float32)
    v = (rng.randn(b, sk, h, d) * 0.5).astype(np.float32)
    co = rng.randn(b, sq, h, d).astype(np.float32)
    return q, k, v, co, rng


def _jax(q, k, v, co, bias, causal, bias_grad, block_q=128, block_k=128):
    """Output and gradients (q, k, v, and the bias when ``bias_grad``) of
    the JAX kernels in interpret mode, for the cotangent ``co``."""
    args = [jnp.asarray(a) for a in (q, k, v)]
    if bias_grad:
        args.append(jnp.asarray(bias))

    def f(*xs):
        b = xs[3] if bias_grad else (None if bias is None
                                     else jnp.asarray(bias))
        out = jax_fa(xs[0], xs[1], xs[2], bias=b, causal=causal,
                     block_q=block_q, block_k=block_k, interpret=True,
                     bias_grad=bias_grad)
        return jnp.vdot(out, co), out

    (_, out), grads = jax.value_and_grad(
        f, tuple(range(len(args))), has_aux=True)(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port(q, k, v, co, bias, causal, bias_grad):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    bt = None
    if bias is not None:
        bt = torch.from_numpy(bias)
        if bias_grad:
            bt.requires_grad_()
            ts.append(bt)
    out = k1.flash_attention(*ts[:3], bias=bt, causal=causal,
                             bias_grad=bias_grad)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(co))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _close(got, want, got_g, want_g):
    np.testing.assert_allclose(got, want, atol=OUT_TOL, rtol=OUT_TOL)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got_g, want_g):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)


# name: (b, sq, sk, h, d, causal, bias kind)
_CASES = {
    "causal_d96": (2, 256, 256, 2, 96, True, None),
    "full_d96": (2, 256, 256, 2, 96, False, None),
    "causal_d64": (2, 256, 256, 2, 64, True, None),
    "full_bias_batch_d96": (2, 256, 256, 2, 96, False, "batch"),
    "causal_bias_head_d96": (2, 256, 256, 2, 96, True, "head"),
    "bool_mask_d96": (2, 128, 128, 2, 96, False, "bool"),
    "cross_length_causal_d96": (1, 128, 256, 2, 96, True, None),
    "multi_kblock_causal_d96": (1, 512, 512, 2, 96, True, None),
    # above 256, where the kernels run the head dim in 256-column chunks
    # (a ragged last chunk of 64)
    "causal_bias_head_d320": (1, 128, 128, 2, 320, True, "head"),
    "full_d320": (1, 128, 128, 2, 320, False, None),
}


def _bias(kind, b, sq, sk, h, rng):
    if kind is None:
        return None
    if kind == "bool":
        keep = np.ones((1, 1, sq, sk), bool)
        keep[..., 100:] = False     # trailing keys out
        keep[:, :, 7] = False       # a row with no key
        return keep
    shape = (b, 1, sq, sk) if kind == "batch" else (1, h, sq, sk)
    return (rng.randn(*shape) * 0.5).astype(np.float32)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_value_and_grads_match_pallas(case, no_persistent_compile_cache):
    b, sq, sk, h, d, causal, kind = _CASES[case]
    q, k, v, co, rng = _qkv(b, sq, sk, h, d, seed=len(case))
    bias = _bias(kind, b, sq, sk, h, rng)
    want, want_g = _jax(q, k, v, co, bias, causal, bias_grad=False)
    got, got_g = _port(q, k, v, co, bias, causal, bias_grad=False)
    _close(got, want, got_g, want_g)
    if kind == "bool":
        assert np.all(got[:, 7] == 0.0) and np.all(got_g[0][:, 7] == 0.0)


@pytest.mark.parametrize("block_q", [128, 256])
def test_fully_masked_rows_give_zero_output_and_grads(
        block_q, no_persistent_compile_cache):
    """Causal with sq = 512 > sk = 384 (offset -128): rows 0..127 see no
    key; at block_q = 256 the boundary falls inside the JAX kernel's tile
    (``test_flash_causal_fully_masked_rows``)."""
    q, k, v, co, _ = _qkv(1, 512, 384, 2, 96, seed=11)
    want, want_g = _jax(q, k, v, co, None, True, False, block_q=block_q)
    got, got_g = _port(q, k, v, co, None, True, False)
    _close(got, want, got_g, want_g)
    assert np.all(got[:, :128] == 0.0)
    assert np.all(got_g[0][:, :128] == 0.0)
    _, lse = k1.flash_attention_fwd_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    assert bool((lse[:, :, :128] == k1.NEG_INF).all())


@pytest.mark.parametrize("shape", [(256, 128), (2, 1, 256, 128),
                                   (1, 2, 256, 128)])
def test_trainable_bias_gradient_matches_pallas(
        shape, no_persistent_compile_cache):
    """dbias reduced onto the bias's broadcast shape, exactly 0 on the
    causal rows that see no key (``test_flash_causal_fully_masked_rows_dbias``:
    sq = 256 > sk = 128)."""
    q, k, v, co, rng = _qkv(2, 256, 128, 2, 96, seed=13)
    bias = (rng.randn(*shape) * 0.1).astype(np.float32)
    want, want_g = _jax(q, k, v, co, bias, True, bias_grad=True,
                        block_q=256)
    got, got_g = _port(q, k, v, co, bias, True, bias_grad=True)
    _close(got, want, got_g, want_g)
    dbias = got_g[3]
    assert dbias.shape == shape
    assert np.all(dbias[..., :128, :] == 0.0)
    assert np.abs(dbias[..., 128:, :]).max() > 0


def test_constant_bias_takes_no_gradient():
    q, k, v, _, rng = _qkv(1, 128, 128, 2, 96, seed=3)
    bias = torch.from_numpy((rng.randn(128, 128) * 0.1).astype(np.float32))
    bias.requires_grad_()
    qt = torch.from_numpy(q).requires_grad_()
    out = k1.flash_attention(qt, torch.from_numpy(k), torch.from_numpy(v),
                             bias=bias, bias_grad=False)
    out.sum().backward()
    assert bias.grad is None and qt.grad is not None


def test_plain_backward_matches_autograd_of_the_plain_forward():
    """The custom backward (K2/K3's plain versions from the saved lse)
    against autograd through K1's plain version, at d = 80 and an odd
    shape (both fp32: 1e-5)."""
    q, k, v, co, rng = _qkv(2, 96, 160, 2, 80, seed=5)
    bias = torch.from_numpy(rng.randn(2, 1, 96, 160).astype(np.float32))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    g = torch.from_numpy(co)
    out, lse = k1.flash_attention_fwd_plain(*ts, bias, True)
    want = torch.autograd.grad(out, ts, g)
    x = [t.detach() for t in ts]
    dq = k1.flash_attention_bwd_dq_plain(*x, out.detach(), lse, g, bias,
                                         True)
    dk, dv = k1.flash_attention_bwd_dkv_plain(*x, out.detach(), lse, g, bias,
                                              True)
    for a, b in zip((dq, dk, dv), want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


BF16_STEP = 2.0 ** -7


def _bf16_close(got, want, name):
    """The card's rule for bf16 kernels: one bf16 step per element,
    ``|d| <= 2^-7 max(1, |ref|)``, and a quarter step in relative L2 norm."""
    g = got.detach().float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, name
    err = np.abs(g - w)
    assert np.all(err <= BF16_STEP * np.maximum(1.0, np.abs(w))), (
        name, err.max())
    rel = np.linalg.norm(g - w) / np.linalg.norm(w)
    assert rel <= BF16_STEP / 4, (name, rel)


def _bf16_pallas_and_port(seed):
    """bf16 at d = 96, causal, with a (1, H) bias: the Pallas kernels'
    (interpret mode) and the port's plain versions' output and dq, dk, dv
    on the same bf16 inputs, ``{name: (port, pallas)}``."""
    b, s, h, d = 2, 256, 2, 96
    q, k, v, co, rng = _qkv(b, s, s, h, d, seed=seed)
    bias = (rng.randn(1, h, s, s) * 0.5).astype(np.float32)
    ts = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, co)]
    jq, jk, jv, jco = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                       for t in ts)
    jb = jnp.asarray(bias)

    def f(q_, k_, v_):
        out = jax_fa(q_, k_, v_, bias=jb, causal=True, block_q=128,
                     block_k=128, interpret=True, bias_grad=False)
        return jnp.vdot(out.astype(jnp.float32),
                        jco.astype(jnp.float32)), out

    (_, want), want_g = jax.value_and_grad(
        f, (0, 1, 2), has_aux=True)(jq, jk, jv)
    qt, kt, vt = (t.requires_grad_() for t in ts[:3])
    out = k1.flash_attention(qt, kt, vt, bias=torch.from_numpy(bias),
                             causal=True, bias_grad=False)
    got_g = torch.autograd.grad(out, (qt, kt, vt), ts[3])
    assert all(t.dtype == torch.bfloat16 for t in (out, *got_g))
    return dict(zip(("out", "dq", "dk", "dv"),
                    zip((out, *got_g), (want, *want_g))))


def test_bf16_plain_k1_k3_round_as_the_pallas_kernels(
        no_persistent_compile_cache):
    """bf16 at d = 96, causal, with a (1, H) bias: K1's plain version (p
    rounded to bf16 before p v) and K3's (p and ds * scale rounded before
    their products) against the Pallas kernels in interpret mode, which
    round at the same places, on the same bf16 inputs."""
    pairs = _bf16_pallas_and_port(seed=31)
    for name in ("out", "dk", "dv"):
        _bf16_close(*pairs[name], name)


def test_bf16_plain_k2_rounds_as_the_pallas_kernel(
        no_persistent_compile_cache):
    """K2's plain version on its tensor-core route rounds ds * scale to
    k's dtype before ds k, as K2 and the Pallas kernel do
    (flash_attention.py:207-209): dq against the Pallas dq in interpret
    mode on the same bf16 inputs, at the bf16 limits."""
    pairs = _bf16_pallas_and_port(seed=32)
    _bf16_close(*pairs["dq"], "dq")
    assert k1.kernel_route(torch.bfloat16, 96) == "mma.sync"


@pytest.mark.parametrize("d", [257, 320, 512, 1000])
def test_kernel_checks_take_head_dims_above_256(d):
    """The card path's checks (K1-K4 share them) pass every head dim, as
    the JAX kernels take it; above 128 the route is FMA."""
    q = torch.zeros(2, 5, 3, d, dtype=torch.bfloat16)
    kv = torch.zeros(2, 7, 3, d, dtype=torch.bfloat16)
    assert k1._check_qkv(q, kv, kv, "flash_attention_fwd") == (2, 5, 7, 3, d)
    assert k1.kernel_route(torch.bfloat16, d) == "fma"


def test_wrapper_refuses_dropout_and_3d_masks():
    """The wrapper refuses what the JAX wrapper refuses: dropout without a
    seed or with a bias gradient, and a 3-D mask. With a seed, dropout runs
    in the plain versions from the Philox mask (tests/test_torch_dropout.py
    holds them to the dense path)."""
    x = torch.zeros(1, 128, 2, 96)
    with pytest.raises(ValueError, match="dropout_seed"):
        k1.flash_attention(x, x, x, dropout_p=0.1)
    with pytest.raises(ValueError, match="bias_grad"):
        k1.flash_attention(x, x, x, bias=torch.zeros(128, 128),
                           dropout_p=0.1, dropout_seed=(1, 2))
    out = k1.flash_attention(x + 1, x, x + 1, dropout_p=0.5,
                             dropout_seed=(1, 2))
    assert out.shape == x.shape and bool(out.isfinite().all())
    with pytest.raises(ValueError, match="3-D"):
        k1.flash_attention(x, x, x, bias=torch.zeros(1, 128, 128))


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------
def _sdpa_pair(q, k, v, mask, causal):
    """``scaled_dot_product_attention`` of the JAX package (interpret mode)
    and of the port on the same numpy inputs."""
    with interpret_mode():
        want = JA.scaled_dot_product_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            attn_mask=None if mask is None else jnp.asarray(mask),
            is_causal=causal)
    want = np.asarray(getattr(want, "_value", want))
    got = PA.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        attn_mask=None if mask is None else torch.from_numpy(mask),
        is_causal=causal)
    return got.numpy(), want


def _masked_rows_call(name):
    if name == "bool_mask_d96":
        q, k, v, _, _ = _qkv(2, 128, 128, 2, 96, seed=21)
        keep = np.ones((1, 1, 128, 128), bool)
        rows = [0, 5, 50, 99, 127]
        keep[:, :, rows] = False
        return q, k, v, keep, False, rows
    d = 96 if name == "causal_sq_gt_sk_d96" else 64
    q, k, v, _, _ = _qkv(2, 256, 128, 2, d, seed=20)
    return q, k, v, None, True, list(range(128))


@pytest.mark.parametrize("name", ["causal_sq_gt_sk_d96", "bool_mask_d96",
                                  "causal_sq_gt_sk_d64"])
def test_rows_with_no_visible_key_match_jax(name,
                                            no_persistent_compile_cache):
    """Calls with rows that see no key, through both packages' sdpa: JAX
    gives those rows 0 (its K1, or its packed kernel at d = 64), and so
    does the port, which takes the same route."""
    q, k, v, mask, causal, rows = _masked_rows_call(name)
    got, want = _sdpa_pair(q, k, v, mask, causal)
    np.testing.assert_array_equal(want[:, rows], 0.0)
    np.testing.assert_array_equal(got[:, rows], 0.0)
    np.testing.assert_allclose(got, want, atol=OUT_TOL, rtol=OUT_TOL)


def _spy(monkeypatch):
    calls = []
    real = k1.flash_attention

    def spy(q, k, v, bias=None, **kw):
        calls.append((tuple(q.stride()), None if bias is None
                      else tuple(bias.shape), kw.get("bias_grad")))
        return real(q, k, v, bias=bias, **kw)

    monkeypatch.setattr(k1, "flash_attention", spy)
    return calls


def test_router_sends_head_dim_96_and_4d_masks_to_k1_k3(
        monkeypatch, no_persistent_compile_cache):
    """On the CPU, the calls JAX sends to its layout-swapping kernel reach
    the K1-K3 wrapper: causal d = 96 on views of one fused qkv buffer (no
    copy), a ``(b, 1, s, s)`` mask, a trainable 2-D mask. Output and
    gradients match JAX's route."""
    calls = _spy(monkeypatch)
    rng = np.random.RandomState(22)
    qkv = (rng.randn(2, 128, 3, 2, 96) * 0.5).astype(np.float32)
    co = rng.randn(2, 128, 2, 96).astype(np.float32)

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
    assert calls == [((128 * 3 * 2 * 96, 3 * 2 * 96, 96, 1), None, False)]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=OUT_TOL, rtol=OUT_TOL)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                               atol=GRAD_ATOL, rtol=GRAD_RTOL)

    q, k, v, _, _ = _qkv(2, 128, 128, 2, 64, seed=23)
    mask = (rng.randn(2, 1, 128, 128) * 0.5).astype(np.float32)
    got, want = _sdpa_pair(q, k, v, mask, False)
    np.testing.assert_allclose(got, want, atol=OUT_TOL, rtol=OUT_TOL)
    assert calls[-1] == ((128 * 2 * 64, 2 * 64, 64, 1), (2, 1, 128, 128),
                         False)

    trainable = torch.zeros(128, 128, requires_grad=True)
    out = PA.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        attn_mask=trainable)
    out.sum().backward()
    assert calls[-1][1:] == ((128, 128), True)
    assert trainable.grad is not None


def test_router_sends_head_dim_320_to_k1_k3(monkeypatch,
                                            no_persistent_compile_cache):
    """A causal call at head dim 320 (no packed route: 320 is not a
    128-lane group) on views of one fused qkv buffer reaches the K1-K3
    wrapper on the CPU, as JAX sends it to its layout-swapping kernel;
    output and gradients match JAX's route."""
    calls = _spy(monkeypatch)
    rng = np.random.RandomState(25)
    qkv = (rng.randn(1, 128, 3, 2, 320) * 0.5).astype(np.float32)
    co = rng.randn(1, 128, 2, 320).astype(np.float32)

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
    assert calls == [((128 * 3 * 2 * 320, 3 * 2 * 320, 320, 1), None, False)]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=OUT_TOL, rtol=OUT_TOL)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                               atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_router_sends_a_padding_bias_to_the_dense_path(
        monkeypatch, no_persistent_compile_cache):
    """A ``(b, 1, 1, s)`` padding bias (BERT's and ERNIE's) is not streamed
    by the flash kernels: the dense path, in both packages
    (``test_sdpa_broadcast_padding_mask_routes_to_einsum``)."""
    calls = _spy(monkeypatch)
    q, k, v, _, rng = _qkv(2, 128, 128, 2, 96, seed=24)
    mask = np.where(rng.rand(2, 1, 1, 128) < 0.2, -1e9, 0.0).astype(
        np.float32)
    got, want = _sdpa_pair(q, k, v, mask, False)
    assert calls == []
    np.testing.assert_allclose(got, want, atol=OUT_TOL, rtol=OUT_TOL)


def test_gpt_at_head_dim_96_loads_the_jax_state(no_persistent_compile_cache):
    """``load_jax_state`` builds the same GPT at head dim 96 (hidden 192, 2
    heads) in both packages: logits within fp32 noise."""
    import paddle_tpu as paddle

    jm, tm = gpt_pair(seed=4, vocab=97, hidden=192, layers=2, heads=2,
                      max_pos=128, init_std=0.02)
    assert tm.gpt.layers[0].head_dim == 96
    ids = np.random.RandomState(5).randint(0, 97, (2, 128)).astype(np.int64)
    with interpret_mode():
        want = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    got = tm(torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
