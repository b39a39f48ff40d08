"""Public signatures the JAX package takes, run through the port on the CPU
and held against the JAX package on the same inputs:

* ``GPTConfig(use_tp=, use_sep=, tie_embeddings=)`` at degree 1: the plain
  model, the same logits within 1e-4 (``tests/test_torch_gpt.py``'s
  tolerance); above degree 1 the port raises;
* ``Optimizer.minimize`` / ``backward`` / ``apply_gradients`` (dygraph):
  two AdamW steps within ``tests/test_torch_optimizer.py``'s 1e-6
  relative;
* ``nn.functional.flash_attention`` and the ``name=`` keyword of
  ``scaled_dot_product_attention`` and ``fused_linear_cross_entropy``:
  fp32 outputs within 1e-5 (the same arithmetic in another order);
* ``DeviceLoader.shutdown``: safe to call twice, before and after a pass;
* ``matmul(x, y, transpose_x=, transpose_y=, name=)`` (C8) against
  ``paddle_tpu.ops.matmul``: fp32 within 1e-5, a bf16 operand against an
  fp32 one promoted to fp32 as in JAX, and ``amp.auto_cast`` casting the
  inputs by the op name ``matmul``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.framework.tensor import Parameter
from paddle_tpu.models import GPTConfig, GPTForCausalLM
from paddle_tpu.utils import unique_name

import paddle_tpu_torch as pt
import paddle_tpu_torch.models as pm
from paddle_tpu_torch.models import gpt as pm_gpt
from paddle_tpu_torch.nn import functional as PF
from tests.torch_port_util import FP32_TOL, no_persistent_compile_cache  # noqa: F401

LOGIT_TOL = 1e-4
RTOL = 1e-6


def _gpt_kw(**extra):
    return dict(vocab_size=61, hidden_size=64, num_layers=2, num_heads=2,
                max_position_embeddings=32, hidden_dropout=0.0,
                attention_dropout=0.0, initializer_range=0.3, **extra)


@pytest.mark.parametrize("extra", [
    {"use_tp": True}, {"use_sep": True}, {"tie_embeddings": False},
    {"use_tp": True, "use_sep": True, "tie_embeddings": True}])
def test_gpt_config_parallel_fields_build_the_plain_model(
        extra, no_persistent_compile_cache):
    kw = _gpt_kw(**extra)
    with unique_name.guard():
        paddle.seed(1)
        jm = GPTForCausalLM(GPTConfig(**kw))
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = pm.GPTForCausalLM(pm.GPTConfig(**kw), device="cpu")
    pm.load_jax_state(tm, state)
    tm.eval()
    ids = np.random.RandomState(3).randint(0, 61, (2, 24))
    want = np.asarray(jm(paddle.to_tensor(ids.astype(np.int64))).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)
    for k, v in extra.items():
        assert getattr(tm.cfg, k) == v


@pytest.mark.parametrize("field,degree_fn,what", [
    ("use_tp", "_mp_degree", "tensor"), ("use_sep", "_sep_degree",
                                         "sequence")])
def test_gpt_config_refuses_parallel_degrees_above_one(field, degree_fn, what,
                                                       monkeypatch):
    monkeypatch.setattr(pm_gpt, degree_fn, lambda: 2)
    cfg = pm.GPTConfig(**_gpt_kw(**{field: True}))
    with pytest.raises(NotImplementedError, match=f"{what} parallelism.*A8"):
        pm.GPTForCausalLM(cfg, device="cpu")
    # the flag off builds the plain model at any degree
    pm.GPTForCausalLM(pm.GPTConfig(**_gpt_kw()), device="cpu")


_SHAPES = [(6, 4), (4,), (3, 2)]


def _losses(rng):
    """Two steps' (targets, weights) of the loss sum(c * (p - t)^2)."""
    return [[(rng.randn(*s).astype(np.float32),
              rng.rand(*s).astype(np.float32) + 0.5) for s in _SHAPES]
            for _ in range(2)]


def _jax_loss(ps, terms):
    total = None
    for p, (t, c) in zip(ps, terms):
        d = p - paddle.to_tensor(t)
        v = paddle.sum(paddle.to_tensor(c) * d * d)
        total = v if total is None else total + v
    return total


def _port_loss(ps, terms):
    return sum((torch.from_numpy(c) * (p - torch.from_numpy(t)) ** 2).sum()
               for p, (t, c) in zip(ps, terms))


@pytest.mark.parametrize("route", ["minimize", "backward_apply"])
def test_optimizer_minimize_and_apply_gradients_match_jax(route):
    rng = np.random.RandomState(5)
    values = [rng.randn(*s).astype(np.float32) for s in _SHAPES]
    steps = _losses(rng)
    with unique_name.guard():
        jps = [Parameter(jnp.asarray(v)) for v in values]
    jopt = paddle.optimizer.AdamW(learning_rate=1e-2, parameters=jps)
    tps = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in values]
    topt = pt.optimizer.AdamW(learning_rate=1e-2, parameters=tps)
    for terms in steps:
        jl, tl = _jax_loss(jps, terms), _port_loss(tps, terms)
        if route == "minimize":
            assert jopt.minimize(jl) == (None, None)
            assert topt.minimize(tl) == (None, None)
        else:
            jpg = jopt.backward(jl)
            tpg = topt.backward(tl)
            assert [p for p, _ in tpg] == tps
            for (_, jg), (_, tg) in zip(jpg, tpg):
                np.testing.assert_allclose(tg.numpy(), np.asarray(jg),
                                           rtol=RTOL, atol=1e-9)
            jopt.apply_gradients(jpg)
            topt.apply_gradients(tpg)
        jopt.clear_grad()
        topt.clear_grad()
        for jp, tp in zip(jps, tps):
            np.testing.assert_allclose(tp.detach().numpy(),
                                       np.asarray(jp._value), rtol=RTOL,
                                       atol=1e-9)
    jsd, tsd = jopt.state_dict(), topt.state_dict()
    assert sorted(tsd) == sorted(jsd)
    # apply_gradients leaves the step count alone, in both packages
    assert tsd["@step"] == jsd["@step"] == (2 if route == "minimize" else 0)
    for k, v in tsd.items():
        if k != "@step":
            np.testing.assert_allclose(v.numpy(), np.asarray(jsd[k]._value),
                                       rtol=RTOL, atol=1e-9)


def test_optimizer_refuses_a_static_program_loss():
    p = torch.nn.Parameter(torch.ones(2))
    opt = pt.optimizer.AdamW(learning_rate=1e-2, parameters=[p])

    class ProgramVariable:   # what a static Program's loss would be
        program = None

    for call in (opt.minimize, opt.backward):
        with pytest.raises(NotImplementedError, match="A10"):
            call(ProgramVariable())


def _qkv(seed, b=2, s=16, h=2, d=32):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, s, h, d).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_matches_jax(causal, no_persistent_compile_cache):
    arrs = _qkv(7)
    want, jsm = JF.flash_attention(*[paddle.to_tensor(a) for a in arrs],
                                   causal=causal, training=False, name="fa")
    got, tsm = PF.flash_attention(*[torch.from_numpy(a) for a in arrs],
                                  causal=causal, training=False, name="fa")
    assert jsm is None and tsm is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               atol=FP32_TOL, rtol=0)
    # the same router as scaled_dot_product_attention without a mask
    sdpa = PF.scaled_dot_product_attention(
        *[torch.from_numpy(a) for a in arrs], is_causal=causal,
        training=False, name="sdpa")
    assert torch.equal(got, sdpa)


def test_name_keyword_is_accepted_and_ignored(no_persistent_compile_cache):
    arrs = _qkv(8)
    want = JF.scaled_dot_product_attention(
        *[paddle.to_tensor(a) for a in arrs], is_causal=True, name="attn")
    got = PF.scaled_dot_product_attention(
        *[torch.from_numpy(a) for a in arrs], is_causal=True, name="attn")
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               atol=FP32_TOL, rtol=0)
    rng = np.random.RandomState(9)
    h = rng.randn(2, 5, 128).astype(np.float32)
    w = (0.1 * rng.randn(37, 128)).astype(np.float32)
    y = rng.randint(0, 37, (2, 5))
    want = JF.fused_linear_cross_entropy(
        paddle.to_tensor(h), paddle.to_tensor(w), paddle.to_tensor(y),
        name="loss")
    got = PF.fused_linear_cross_entropy(
        torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(y),
        name="loss")
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               atol=FP32_TOL, rtol=0)


def test_device_loader_shutdown_is_safe_twice():
    from paddle_tpu.io.device_loader import DeviceLoader as JaxLoader

    batches = [np.full((2, 3), i, np.float32) for i in range(4)]
    jl = JaxLoader(batches)
    tl = pt.io.DeviceLoader(batches, device="cpu")
    for loader in (jl, tl):
        loader.shutdown()
        loader.shutdown()
    want = [np.asarray(getattr(b, "_value", b)) for b in jl]
    got = [b.numpy() for b in tl]
    for loader in (jl, tl):
        loader.shutdown()
        loader.shutdown()
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # a pass after the shutdowns still hands out every batch
    assert [int(b[0, 0]) for b in tl] == [0, 1, 2, 3]


# (x shape, y shape) before the transposes: 2-D, batched 3-D against 3-D,
# batched against a shared 2-D, and a vector (whose flag changes nothing)
_MATMUL_SHAPES = [((4, 6), (6, 5)), ((3, 4, 6), (3, 6, 5)),
                  ((3, 4, 6), (6, 5)), ((6,), (6, 5))]


def _swapped(a, flag):
    return np.swapaxes(a, -1, -2) if flag and a.ndim >= 2 else a


@pytest.mark.parametrize("transpose_y", [False, True])
@pytest.mark.parametrize("transpose_x", [False, True])
@pytest.mark.parametrize("shapes", _MATMUL_SHAPES,
                         ids=["2d", "batched", "shared_y", "vector_x"])
def test_matmul_transposes_match_jax(shapes, transpose_x, transpose_y):
    """C8: the flags swap an operand's last two axes first (operands given
    in their transposed layout, so each product is defined)."""
    rng = np.random.RandomState(11)
    x = _swapped(rng.randn(*shapes[0]).astype(np.float32), transpose_x)
    y = _swapped(rng.randn(*shapes[1]).astype(np.float32), transpose_y)
    x, y = np.ascontiguousarray(x), np.ascontiguousarray(y)
    want = paddle.ops.matmul(paddle.to_tensor(x), paddle.to_tensor(y),
                             transpose_x=transpose_x,
                             transpose_y=transpose_y, name="mm")
    got = PF.matmul(torch.from_numpy(x), torch.from_numpy(y),
                    transpose_x=transpose_x, transpose_y=transpose_y,
                    name="mm")
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               atol=FP32_TOL, rtol=0)


def test_matmul_transpose_keeps_promotion_and_amp():
    """bf16 ``h`` against an fp32 weight with ``transpose_y`` (the encoders'
    tied MLM head) computes in fp32, as JAX promotes; under
    ``auto_cast(O1)`` both operands go to bf16 by the op name."""
    rng = np.random.RandomState(12)
    h = rng.randn(2, 3, 8).astype(np.float32)
    w = rng.randn(10, 8).astype(np.float32)
    hb = torch.from_numpy(h).to(torch.bfloat16)
    want = paddle.ops.matmul(paddle.to_tensor(h).astype("bfloat16"),
                             paddle.to_tensor(w), transpose_y=True)
    got = PF.matmul(hb, torch.from_numpy(w), transpose_y=True)
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               atol=FP32_TOL, rtol=0)
    with paddle.amp.auto_cast(level="O1"):
        jw = paddle.ops.matmul(paddle.to_tensor(h), paddle.to_tensor(w),
                               transpose_y=True)
    with pt.amp.auto_cast(level="O1"):
        tw = PF.matmul(torch.from_numpy(h), torch.from_numpy(w),
                       transpose_y=True)
    assert tw.dtype == torch.bfloat16 and str(jw.dtype) == "bfloat16"
    # both round an fp32 sum to bf16: one bf16 step of the largest value
    jw = np.asarray(jw.astype("float32").numpy())
    np.testing.assert_allclose(tw.float().numpy(), jw,
                               atol=2.0 ** -7 * np.abs(jw).max(), rtol=0)
