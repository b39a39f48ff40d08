"""The port's AdamW against the JAX package's, on the CPU, given the same
gradients: fp32, bf16 parameters under ``multi_precision`` (fp32 master
weights and moments), and bf16 parameters without it, over 3 steps; then
``load_jax_optimizer_state`` resuming a JAX run of a GPT's optimizer
mid-way (AdamW, AdamW under an LR scheduler, Momentum).

Tolerance: both run the same elementwise fp32 update (an fp32 0-d learning
rate, beta-power accumulators), so masters, moments and fp32 parameters
agree to 1e-6 relative (one or two roundings apart at most); bf16
parameters under multi_precision are the master rounded once and agree to
one bf16 step. Without multi_precision a bf16 update promotes through the
fp32 learning rate exactly as JAX's does, so parameters, accumulators and
their dtypes are equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.framework.tensor import Parameter
from paddle_tpu.utils import unique_name

import paddle_tpu_torch as pt
from paddle_tpu_torch.models import load_jax_optimizer_state, load_jax_state
from tests.torch_port_util import gpt_pair

RTOL = 1e-6
BF16_STEP = 2.0 ** -7
_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _np(x):
    """A JAX value (Tensor or array) as a writable fp32 numpy array."""
    return np.array(jnp.asarray(getattr(x, "_value", x), jnp.float32))


def _close(got, want):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-9)


def _close_param(got, want, dtype):
    g = got.detach().float().numpy()
    if dtype == torch.float32:
        _close(g, want)
    else:
        assert np.all(np.abs(g - want)
                      <= BF16_STEP * np.maximum(np.abs(want), 1e-30))


@pytest.mark.parametrize("dtype,multi_precision,kw", [
    (torch.float32, False, {}),
    (torch.bfloat16, True, {}),
    # JAX's promotion: the decayed base is fp32, so are the moments born
    # from it; the parameter that does not decay keeps bf16 moments
    (torch.bfloat16, False, {"apply_decay_param_fun":
                             lambda n: n != "param_1"}),
    # a non-float weight_decay means 0.01; one parameter does not decay
    (torch.float32, False, {"weight_decay": None,
                            "apply_decay_param_fun": lambda n: n != "param_1"}),
])
def test_adamw_matches_jax_over_three_steps(dtype, multi_precision, kw):
    exact = dtype == torch.bfloat16 and not multi_precision
    rng = np.random.RandomState(0)
    shapes = [(8, 16), (16,), (3, 5)]
    values = [rng.randn(*s).astype(np.float32) * 0.5 for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) * 1e-2 for s in shapes]
             for _ in range(3)]
    with unique_name.guard():
        jps = [Parameter(jnp.asarray(v).astype(_JNP[dtype])) for v in values]
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3, parameters=jps,
                                  multi_precision=multi_precision, **kw)
    tps = [torch.nn.Parameter(torch.from_numpy(v).to(dtype)) for v in values]
    topt = pt.optimizer.AdamW(learning_rate=1e-3, parameters=tps,
                              multi_precision=multi_precision, **kw)
    for gs in grads:
        for jp, tp, g in zip(jps, tps, gs):
            gj = jnp.asarray(g).astype(_JNP[dtype])
            jp.grad = gj
            tp.grad = torch.from_numpy(_np(gj)).to(dtype)
        jopt.step()
        jopt.clear_grad()
        topt.step()
        topt.clear_grad()
        for jp, tp in zip(jps, tps):
            assert tp.grad is None and tp.dtype == dtype
            if exact:
                np.testing.assert_array_equal(tp.detach().float().numpy(),
                                              _np(jp))
            else:
                _close_param(tp, _np(jp), dtype)
    jsd, tsd = jopt.state_dict(), topt.state_dict()
    assert sorted(tsd) == sorted(jsd)
    assert tsd["@step"] == jsd["@step"] == 3
    for k, v in tsd.items():
        if k != "@step":
            assert str(v.dtype) == "torch." + str(jsd[k]._value.dtype), k
            if exact:
                np.testing.assert_array_equal(v.float().numpy(),
                                              _np(jsd[k]))
            else:
                _close(v, _np(jsd[k]))
    if exact:
        dtypes = {k: v.dtype for k, v in tsd.items() if k != "@step"}
        assert dtypes["param_0_moment1"] == torch.float32
        assert dtypes["param_1_moment1"] == torch.bfloat16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_load_jax_optimizer_state_resumes_a_jax_run(dtype):
    """Two JAX AdamW steps on a GPT's parameters, then the port takes over
    the weights and the optimizer state (moments, beta powers, master
    weights, transposed for Linear weights) and the third step of both
    agrees."""
    jm, tm = gpt_pair(layers=1)
    mp = dtype == torch.bfloat16
    if mp:
        jm.to(dtype="bfloat16")
        tm.to(torch.bfloat16)
    jparams = dict(jm.named_parameters())
    rng = np.random.RandomState(1)
    grads = [{n: rng.randn(*p.shape).astype(np.float32) * 1e-2
              for n, p in jparams.items()} for _ in range(3)]
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters(),
                                  multi_precision=mp)

    def jax_step(gs):
        for n, p in jparams.items():
            p.grad = jnp.asarray(gs[n]).astype(_JNP[dtype])
        jopt.step()
        jopt.clear_grad()

    jax_step(grads[0])
    jax_step(grads[1])
    load_jax_state(tm, {k: _np(v) for k, v in jm.state_dict().items()})
    topt = pt.optimizer.AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                              multi_precision=mp)
    state = {k: (v if k == "@step" else _np(v))
             for k, v in jopt.state_dict().items()}
    load_jax_optimizer_state(topt, state, tm,
                             {n: p.name for n, p in jparams.items()})
    assert topt._step_count == 2
    jax_step(grads[2])
    for n, p in tm.named_parameters():
        g = _np(jnp.asarray(grads[2][n]).astype(_JNP[dtype]))
        p.grad = torch.from_numpy(g).to(dtype)
    topt.step()
    for n, p in tm.named_parameters():
        _close_param(p, _np(jparams[n]), dtype)


def test_load_jax_optimizer_state_rejects_an_unknown_entry():
    jm, tm = gpt_pair(layers=1)
    topt = pt.optimizer.AdamW(parameters=tm.parameters())
    names = {n: p.name for n, p in jm.named_parameters()}
    with pytest.raises(KeyError, match="lookahead"):
        load_jax_optimizer_state(topt, {"param_0_lookahead": np.zeros(3)},
                                 tm, names)


def _jax_port_opts(kind, jm, tm):
    if kind == "momentum":
        return (paddle.optimizer.Momentum(learning_rate=0.05, momentum=0.9,
                                          use_nesterov=True,
                                          parameters=jm.parameters()),
                pt.optimizer.Momentum(learning_rate=0.05, momentum=0.9,
                                      use_nesterov=True,
                                      parameters=tm.parameters()))

    # a scheduler whose whole state is in its state_dict (LinearWarmup's
    # inner scheduler is not, in the JAX package either)
    def sched(lr):
        return lr.CosineAnnealingDecay(1e-3, T_max=4, eta_min=1e-4)

    return (paddle.optimizer.AdamW(learning_rate=sched(paddle.optimizer.lr),
                                   parameters=jm.parameters()),
            pt.optimizer.AdamW(learning_rate=sched(pt.optimizer.lr),
                               parameters=tm.parameters()))


@pytest.mark.parametrize("kind", ["momentum", "adamw_scheduled"])
def test_load_jax_optimizer_state_resumes_momentum_and_a_schedule(kind):
    """Three JAX steps (the scheduler stepped after each), then the port
    takes over weights, accumulators (``velocity``; or moments and the
    ``LR_Scheduler`` state) and both run two more steps in step."""
    jm, tm = gpt_pair(layers=1)
    jparams = dict(jm.named_parameters())
    rng = np.random.RandomState(2)
    grads = [{n: rng.randn(*p.shape).astype(np.float32) * 1e-2
              for n, p in jparams.items()} for _ in range(5)]
    jopt, topt = _jax_port_opts(kind, jm, tm)
    jsched = jopt._learning_rate if kind != "momentum" else None
    for gs in grads[:3]:
        for n, p in jparams.items():
            p.grad = jnp.asarray(gs[n])
        jopt.step()
        jopt.clear_grad()
        if jsched is not None:
            jsched.step()
    load_jax_state(tm, {k: _np(v) for k, v in jm.state_dict().items()})
    state = {k: (v if k in ("@step", "LR_Scheduler") else _np(v))
             for k, v in jopt.state_dict().items()}
    load_jax_optimizer_state(topt, state, tm,
                             {n: p.name for n, p in jparams.items()})
    assert topt._step_count == 3
    assert topt.get_lr() == jopt.get_lr()
    for gs in grads[3:]:
        for n, p in jparams.items():
            p.grad = jnp.asarray(gs[n])
        jopt.step()
        jopt.clear_grad()
        for n, p in tm.named_parameters():
            p.grad = torch.from_numpy(gs[n])
        topt.step()
        topt.clear_grad()
        if jsched is not None:
            jsched.step()
            topt._learning_rate.step()
        assert topt.get_lr() == jopt.get_lr()
    for n, p in tm.named_parameters():
        _close(p, _np(jparams[n]))
