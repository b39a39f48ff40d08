"""The port's training recipe pieces against the JAX package's, on the CPU:
every optimizer, every LR scheduler, the three gradient clips, the
regularizers and per-parameter attributes, and ``GradScaler``'s dynamics
and inf-skip state. Both sides get the same parameters and gradients (made
with numpy from a seed) and run 3 steps.

Tolerances: fp32 parameters and accumulators to 1e-6 relative (the same
elementwise fp32 arithmetic; only the global norm's sum runs in another
order); bf16 ones exactly, with the same dtypes, because the port spells
out JAX's promotions (the fp32 learning rate widens what it meets, Python
constants round to bf16 first) and every elementwise bf16 op rounds the
same exact fp32 result in both frameworks. Schedulers are the same host
arithmetic: exactly equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.framework.tensor import Parameter
from paddle_tpu.utils import unique_name

import paddle_tpu_torch as pt

RTOL = 1e-6
_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
_SHAPES = [(8, 16), (16,), (3, 5)]


def _np(x):
    """A JAX value (Tensor or array) as a writable fp32 numpy array."""
    return np.array(jnp.asarray(getattr(x, "_value", x), jnp.float32))


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


def _pair(dtype, seed=0, steps=3, scale=1e-2):
    """JAX and port parameters holding the same values, and ``steps`` lists
    of gradients."""
    rng = np.random.RandomState(seed)
    values = [rng.randn(*s).astype(np.float32) * 0.5 for s in _SHAPES]
    grads = [[rng.randn(*s).astype(np.float32) * scale for s in _SHAPES]
             for _ in range(steps)]
    with unique_name.guard():
        jps = [Parameter(jnp.asarray(v).astype(_JNP[dtype])) for v in values]
    tps = [torch.nn.Parameter(torch.from_numpy(v).to(dtype)) for v in values]
    return jps, tps, grads


def _set_grads(jps, tps, gs, dtype):
    for jp, tp, g in zip(jps, tps, gs):
        gj = jnp.asarray(g).astype(_JNP[dtype])
        jp.grad = gj
        tp.grad = torch.from_numpy(_np(gj)).to(dtype)


def _assert_same(got, want, exact, rtol=RTOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-9)


def _assert_state(jopt, topt, jps, tps, exact, rtol=RTOL):
    for jp, tp in zip(jps, tps):
        _assert_same(tp, _np(jp), exact, rtol)
    jsd, tsd = jopt.state_dict(), topt.state_dict()
    assert sorted(tsd) == sorted(jsd)
    assert tsd["@step"] == jsd["@step"]
    for k, v in tsd.items():
        if k in ("@step", "LR_Scheduler"):
            continue
        assert _dtype_name(v) == str(jsd[k]._value.dtype), k
        _assert_same(v, _np(jsd[k]), exact, rtol)


_OPTIMIZERS = [
    ("SGD", {"learning_rate": 0.1}),
    ("Momentum", {"learning_rate": 0.1}),
    ("Momentum", {"learning_rate": 0.1, "use_nesterov": True}),
    ("Adam", {"learning_rate": 1e-3}),
    ("AdamW", {"learning_rate": 1e-3}),
    ("Adamax", {"learning_rate": 1e-2}),
    ("Adagrad", {"learning_rate": 1e-2}),
    ("Adadelta", {"learning_rate": 1.0}),
    ("RMSProp", {"learning_rate": 1e-2, "momentum": 0.9}),
    ("RMSProp", {"learning_rate": 1e-2, "centered": True}),
    ("Lamb", {"learning_rate": 1e-2}),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,kw", _OPTIMIZERS)
def test_optimizer_matches_jax_over_three_steps(name, kw, dtype):
    jps, tps, grads = _pair(dtype)
    jopt = getattr(paddle.optimizer, name)(parameters=jps, **kw)
    topt = getattr(pt.optimizer, name)(parameters=tps, **kw)
    for gs in grads:
        _set_grads(jps, tps, gs, dtype)
        jopt.step()
        jopt.clear_grad()
        topt.step()
        topt.clear_grad()
    _assert_state(jopt, topt, jps, tps, exact=dtype == torch.bfloat16)


def test_regularizers_lr_attrs_and_groups_match_jax():
    """A coupled float weight_decay, an L1Decay on one parameter
    (``regularizer`` attribute), a per-parameter learning rate
    (``optimize_attr``) and parameter groups, on Momentum."""
    jps, tps, grads = _pair(torch.float32, seed=2)
    for ps, reg in ((jps, paddle.regularizer.L1Decay(0.05)),
                    (tps, pt.regularizer.L1Decay(0.05))):
        ps[1].regularizer = reg
        ps[2].optimize_attr = {"learning_rate": 0.5}
    jopt = paddle.optimizer.Momentum(
        learning_rate=0.1, weight_decay=0.01,
        parameters=[{"params": jps[:2]}, {"params": jps[2:]}])
    topt = pt.optimizer.Momentum(
        learning_rate=0.1, weight_decay=0.01,
        parameters=[{"params": tps[:2]}, {"params": tps[2:]}])
    for gs in grads:
        _set_grads(jps, tps, gs, torch.float32)
        jopt.step()
        topt.step()
    _assert_state(jopt, topt, jps, tps, exact=False)
    jps, tps, grads = _pair(torch.float32, seed=3)
    jopt = paddle.optimizer.SGD(learning_rate=0.1, parameters=jps,
                                weight_decay=paddle.regularizer.L2Decay(0.1))
    topt = pt.optimizer.SGD(learning_rate=0.1, parameters=tps,
                            weight_decay=pt.regularizer.L2Decay(0.1))
    for gs in grads:
        _set_grads(jps, tps, gs, torch.float32)
        jopt.step()
        topt.step()
    _assert_state(jopt, topt, jps, tps, exact=False)


def _schedulers(lr):
    return [
        lr.NoamDecay(d_model=64, warmup_steps=5),
        lr.PiecewiseDecay(boundaries=[3, 8], values=[0.1, 0.05, 0.01]),
        lr.NaturalExpDecay(0.1, gamma=0.2),
        lr.InverseTimeDecay(0.1, gamma=0.3),
        lr.PolynomialDecay(0.1, decay_steps=7, end_lr=0.01, power=2.0),
        lr.PolynomialDecay(0.1, decay_steps=7, cycle=True),
        lr.LinearWarmup(lr.CosineAnnealingDecay(6e-4, T_max=8, eta_min=6e-5),
                        warmup_steps=5, start_lr=0.0, end_lr=6e-4),
        lr.LinearWarmup(0.1, warmup_steps=4, start_lr=0.01, end_lr=0.1),
        lr.ExponentialDecay(0.1, gamma=0.9),
        lr.MultiStepDecay(0.1, milestones=[2, 5, 11], gamma=0.5),
        lr.StepDecay(0.1, step_size=3),
        lr.LambdaDecay(0.1, lambda e: 0.95 ** e),
        lr.MultiplicativeDecay(0.1, lambda e: 0.9),
        lr.CosineAnnealingDecay(0.1, T_max=6),
        lr.OneCycleLR(0.1, total_steps=15),
        lr.OneCycleLR(0.1, total_steps=15, anneal_strategy="linear"),
        lr.CyclicLR(0.01, 0.1, step_size_up=3, mode="triangular2"),
        lr.CyclicLR(0.01, 0.1, step_size_up=3, step_size_down=5,
                    mode="exp_range", exp_gamma=0.9),
        lr.ReduceOnPlateau(0.1, patience=1, cooldown=1),
    ]


@pytest.mark.parametrize("i", range(len(_schedulers(pt.optimizer.lr))))
def test_scheduler_matches_jax_over_twenty_steps(i):
    js = _schedulers(paddle.optimizer.lr)[i]
    ts = _schedulers(pt.optimizer.lr)[i]
    assert type(ts).__name__ == type(js).__name__
    metrics = [1.0, 0.9, 0.95, 0.97, 0.96, 0.99, 0.8] * 3
    got, want = [], []
    for step in range(20):
        got.append(ts())
        want.append(js())
        if isinstance(ts, pt.optimizer.lr.ReduceOnPlateau):
            ts.step(metrics[step])
            js.step(metrics[step])
        else:
            ts.step()
            js.step()
    assert got == want
    assert ts.state_dict() == js.state_dict()


def test_scheduler_drives_the_learning_rate_and_the_state_dict():
    """An LRScheduler as ``learning_rate``: ``get_lr`` follows it,
    ``set_lr`` raises, and ``state_dict`` carries ``LR_Scheduler`` back
    into a fresh scheduler."""
    lr = pt.optimizer.lr
    sched = lr.StepDecay(0.1, step_size=2, gamma=0.1)
    opt = pt.optimizer.SGD(learning_rate=sched,
                           parameters=[torch.nn.Parameter(torch.zeros(2))])
    sched.step()
    sched.step()
    assert abs(opt.get_lr() - 0.01) < 1e-12
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.5)
    sd = opt.state_dict()
    assert sd["LR_Scheduler"]["last_epoch"] == 2
    fresh = lr.StepDecay(0.1, step_size=2, gamma=0.1)
    opt2 = pt.optimizer.SGD(learning_rate=fresh,
                            parameters=[torch.nn.Parameter(torch.zeros(2))])
    opt2.set_state_dict(sd)
    assert fresh.last_epoch == 2 and abs(opt2.get_lr() - 0.01) < 1e-12
    opt2.set_lr_scheduler(lr.ExponentialDecay(0.2, gamma=0.5))
    assert opt2.get_lr() == 0.2


@pytest.mark.parametrize("clip", ["value", "norm", "global_norm"])
def test_grad_clip_matches_jax(clip):
    """Each clip on AdamW over 3 steps with large gradients (so every clip
    acts); one parameter has ``need_clip = False``. The global norm sums
    the squares of 159 values in another order than XLA, so its scale, and
    every clipped gradient, carries a few fp32 rounding steps: 4e-6."""
    rtol = 4e-6 if clip == "global_norm" else RTOL
    jps, tps, grads = _pair(torch.float32, seed=4, scale=3.0)
    jps[1].need_clip = False
    tps[1].need_clip = False
    make = {"value": lambda m: m.ClipGradByValue(0.5, min=-0.2),
            "norm": lambda m: m.ClipGradByNorm(1.0),
            "global_norm": lambda m: m.ClipGradByGlobalNorm(1.0)}[clip]
    jopt = paddle.optimizer.AdamW(learning_rate=1e-2, parameters=jps,
                                  grad_clip=make(paddle.nn))
    topt = pt.optimizer.AdamW(learning_rate=1e-2, parameters=tps,
                              grad_clip=make(pt.nn))
    for gs in grads:
        _set_grads(jps, tps, gs, torch.float32)
        jout = jopt._grad_clip([(p, p.grad) for p in jps])
        tout = topt._grad_clip([(p, p.grad) for p in tps])
        for (_, jg), (tp, tg) in zip(jout, tout):
            _assert_same(tg, _np(jg), False, rtol)
        assert tout[1][1] is tps[1].grad
        jopt.step()
        jopt.clear_grad()
        topt.step()
        topt.clear_grad()
    _assert_state(jopt, topt, jps, tps, False, rtol)


# ---------------------------------------------------------------------------
# GradScaler
# ---------------------------------------------------------------------------
def _scaled_run(name, kw, dtype, infs, jopt=None, topt=None, pair=None,
                **scaler_kw):
    """Drive a JAX and a port scaler in lockstep: each step sets the
    gradients to ``g * scale`` (an inf in the first element on the steps in
    ``infs``), then ``scaler.step(opt)`` and ``scaler.update()``; checks
    the scaler's dynamics and the whole optimizer state after each."""
    jps, tps, grads = pair or _pair(dtype, steps=len(infs))
    if jopt is None:
        jopt = getattr(paddle.optimizer, name)(parameters=jps, **kw)
        topt = getattr(pt.optimizer, name)(parameters=tps, **kw)
    js = paddle.amp.GradScaler(**scaler_kw)
    ts = pt.amp.GradScaler(**scaler_kw)
    for step, (gs, bad) in enumerate(zip(grads, infs)):
        scale = js.get_init_loss_scaling()
        assert ts.get_init_loss_scaling() == scale
        gs = [g * np.float32(scale) for g in gs]
        if bad:
            gs[0] = gs[0].copy()
            gs[0].flat[0] = np.inf
        _set_grads(jps, tps, gs, dtype)
        js.step(jopt)
        js.update()
        ts.step(topt)
        ts.update()
        jopt.clear_grad()
        topt.clear_grad()
        assert ts.state_dict() == js.state_dict(), step
        _assert_state(jopt, topt, jps, tps, exact=dtype == torch.bfloat16)
    return jopt, topt, jps, tps


@pytest.mark.parametrize("name,kw,dtype", [
    # bf16 with master weights: masters and moments born in a skipped step
    ("AdamW", {"learning_rate": 1e-2, "multi_precision": True},
     torch.bfloat16),
    # bf16 without: RMSProp's momentum comes back fp32 from a skipped step
    ("RMSProp", {"learning_rate": 1e-2, "momentum": 0.9}, torch.bfloat16),
    ("Adam", {"learning_rate": 1e-2}, torch.float32),
])
def test_grad_scaler_matches_jax_dynamics_and_skip(name, kw, dtype):
    _scaled_run(name, kw, dtype, [True, False, False, True, True, False],
                init_loss_scaling=2.0 ** 10, incr_every_n_steps=2,
                decr_every_n_nan_or_inf=2)


def test_grad_scaler_skip_after_set_state_dict_keeps_the_checkpoint():
    """The first step after ``set_state_dict`` overflows: accumulators still
    pending (born in that very step) keep their checkpoint values, not their
    fills, as in the JAX scaler."""
    kw = {"learning_rate": 1e-2, "multi_precision": True}
    jopt, topt, jps, tps = _scaled_run("AdamW", kw, torch.bfloat16,
                                       [False, False])
    jsd, tsd = jopt.state_dict(), topt.state_dict()
    jps2, tps2, grads = _pair(torch.bfloat16, seed=5, steps=2)
    for a, b in zip(jps2, jps):
        a._value = b._value
    with torch.no_grad():
        for a, b in zip(tps2, tps):
            a.copy_(b)
    jopt2 = paddle.optimizer.AdamW(parameters=jps2, **kw)
    topt2 = pt.optimizer.AdamW(parameters=tps2, **kw)
    jopt2.set_state_dict(jsd)
    topt2.set_state_dict(tsd)
    _scaled_run("AdamW", kw, torch.bfloat16, [True, False], jopt=jopt2,
                topt=topt2, pair=(jps2, tps2, grads))
    assert topt2._step_count == 4


def test_grad_scaler_unscale_once_and_load_jax_state():
    """``unscale_`` then ``step`` divides once; ``load_state_dict`` takes the
    JAX scaler's ``state_dict()``; ``scale`` multiplies the loss."""
    tp = torch.nn.Parameter(torch.ones(3))
    opt = pt.optimizer.SGD(learning_rate=1.0, parameters=[tp])
    scaler = pt.amp.GradScaler(init_loss_scaling=8.0)
    loss = (tp * 2).sum()
    scaled = scaler.scale(loss)
    assert float(scaled) == float(loss) * 8.0
    scaled.backward()
    scaler.unscale_(opt)
    scaler.unscale_(opt)
    scaler.step(opt)
    scaler.update()
    assert torch.equal(tp.detach(), torch.full((3,), -1.0))
    js = paddle.amp.GradScaler(init_loss_scaling=64.0)
    js._good_steps = jnp.asarray(7, jnp.int32)
    scaler.load_state_dict(js.state_dict())
    assert scaler.get_init_loss_scaling() == 64.0
    assert scaler.state_dict()["good_steps"] == 7
    off = pt.amp.GradScaler(enable=False)
    assert off.scale(loss) is loss
