"""The port's GPT train step against the JAX package's, on the CPU, fp32:
``model.loss(ids, labels)``, ``loss.backward()``, ``AdamW.step()``,
``clear_grad()``, from the same weights (``load_jax_state``) and batches
(fed through the port's ``DeviceLoader``, as ``bench.py`` feeds its step).

* ``bench.py``'s smoke config (vocab 1024, hidden 128, 2 layers, 4 heads,
  batch 4, seq 64): attention is dense and LayerNorm the plain expression
  in both packages;
* seq 256 with 2 heads (head_dim 64) under JAX ``interpret_mode()``, one
  layer and 3 steps (interpreted Pallas costs seconds a step): JAX runs its
  packed flash and LayerNorm Pallas kernels, and the port routes through
  the packed-attention and LayerNorm kernel wrappers (their plain versions
  on the CPU), which a spy asserts;
* hidden 192 with 2 heads of 96 (GPT-3 Large's head dim), 2 layers, seq
  256, 5 steps under JAX ``interpret_mode()``: head dim 96 does not pack
  into 128 lanes, so JAX runs its layout-swapping flash kernels (K1-K3)
  and the port routes through the K1-K3 wrapper, which a spy asserts.

* the GPT-3 Small recipe (Brown et al. 2020, Table 2.1 and Appendix B) on
  the smoke config, fp32, 5 steps: AdamW(beta2 0.95, epsilon 1e-8, weight
  decay 0.1 on all but biases and LayerNorms), a linear warm-up into a
  cosine schedule (``sched.step()`` after each step), global-norm clipping
  at 1.0, a dynamic ``GradScaler`` and ``FLAGS_enable_flash_ce`` (the port
  runs the plain K9-K11 on the CPU; JAX, without a TPU, its scan: the same
  math). ``amp.decorate`` is left out: bf16 matmuls on the CPU round
  differently in the two frameworks (``tests/test_torch_amp.py`` holds it).

Tolerance: losses within 1e-5 relative and parameters within 1e-4
absolute after the run (fp32 in another order; AdamW's normalised step
keeps the difference near the rounding noise of the gradients).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.ops.pallas import interpret_mode
from paddle_tpu.utils import unique_name

import paddle_tpu_torch as pt
import paddle_tpu_torch.models as pm
from paddle_tpu_torch.ops.cuda import flash_attention as k1
from paddle_tpu_torch.ops.cuda import fused_ce as k9
from paddle_tpu_torch.ops.cuda import flash_attention_packed as k5
from paddle_tpu_torch.ops.cuda import layer_norm as k7
from tests.torch_port_util import both_flags

LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4


def _cfg(**kw):
    base = dict(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=4,
                max_position_embeddings=128, hidden_dropout=0.0,
                attention_dropout=0.0)
    base.update(kw)
    return base


def _batches(cfg, batch, seq, steps, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        a = rng.randint(0, cfg["vocab_size"], (batch, seq)).astype(np.int64)
        out.append((a, a.copy()))
    return out


def _jax_run(cfg, batches):
    with unique_name.guard():
        paddle.seed(0)
        jm = JGPT(JConfig(**cfg))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    opt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=jm.parameters())
    losses = []
    for ids, labels in batches:
        loss = jm.loss(paddle.to_tensor(ids), paddle.to_tensor(labels))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    final = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    return state, losses, final


def _port_run(cfg, state, batches):
    tm = pm.GPTForCausalLM(pm.GPTConfig(**cfg), device="cpu")
    pm.load_jax_state(tm, state)
    opt = pt.optimizer.AdamW(learning_rate=1e-4, parameters=tm.parameters())
    losses = []
    for ids, labels in pt.io.DeviceLoader(batches, device="cpu"):
        loss = tm.loss(ids, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    return tm, losses


def _check(tm, losses, want_losses, final):
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL, atol=0)
    assert losses[-1] < losses[0]
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[name],
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)


def test_smoke_config_loss_curve_matches_jax():
    cfg = _cfg()
    batches = _batches(cfg, 4, 64, 5)
    state, want, final = _jax_run(cfg, batches)
    tm, got = _port_run(cfg, state, batches)
    _check(tm, got, want, final)


def test_packed_attention_and_layer_norm_route_matches_jax(monkeypatch):
    cfg = _cfg(num_heads=2, num_layers=1, max_position_embeddings=256)
    batches = _batches(cfg, 2, 256, 3, seed=1)
    with interpret_mode():
        state, want, final = _jax_run(cfg, batches)
    calls = {"packed": 0, "ln_bwd": 0}
    real_packed, real_ln_bwd = k5.flash_attention_packed, k7.layer_norm_bwd

    def packed(*a, **kw):
        calls["packed"] += 1
        return real_packed(*a, **kw)

    def ln_bwd(*a):
        calls["ln_bwd"] += 1
        return real_ln_bwd(*a)

    monkeypatch.setattr(k5, "flash_attention_packed", packed)
    monkeypatch.setattr(k7, "layer_norm_bwd", ln_bwd)
    tm, got = _port_run(cfg, state, batches)
    # one attention call a step; 2 LayerNorms a layer plus ln_f
    assert calls == {"packed": 3, "ln_bwd": 3 * 3}
    _check(tm, got, want, final)


def test_head_dim_96_loss_curve_matches_jax(monkeypatch):
    cfg = _cfg(hidden_size=192, num_heads=2, max_position_embeddings=256)
    batches = _batches(cfg, 1, 256, 5, seed=3)
    with interpret_mode():
        state, want, final = _jax_run(cfg, batches)
    calls = []
    real = k1.flash_attention

    def flash(q, *a, **kw):
        calls.append(q.shape[-1])
        return real(q, *a, **kw)

    monkeypatch.setattr(k1, "flash_attention", flash)
    tm, got = _port_run(cfg, state, batches)
    assert calls == [96] * (5 * 2)   # every layer of every step
    _check(tm, got, want, final)


def test_device_loader_keeps_structure_and_order():
    batches = [(np.full((2, 3), i), {"y": np.arange(i, i + 2), "tag": f"b{i}"})
               for i in range(5)]
    loader = pt.io.DeviceLoader(batches, buffer_size=1, device="cpu")
    assert loader.buffer_size == 2 and len(loader) == 5
    for _ in range(2):  # one pass a call to iter()
        seen = list(loader)
        assert [b[1]["tag"] for b in seen] == [f"b{i}" for i in range(5)]
        for i, (x, d) in enumerate(seen):
            assert isinstance(x, torch.Tensor) and int(x[0, 0]) == i
            assert torch.equal(d["y"], torch.arange(i, i + 2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if not torch.cuda.is_available():
            pt.io.DeviceLoader(batches)
        else:
            raise RuntimeError("device='cpu'")


def _recipe(pkg, model, decays):
    """GPT-3 Small's optimizer recipe over ``model`` in package ``pkg``
    (the JAX package or the port); ``decays(name)`` is the AdamW decay
    filter on the package's own parameter keys."""
    lr = pkg.optimizer.lr
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(6e-4, T_max=8,
                                                    eta_min=6e-5),
                            warmup_steps=5, start_lr=0.0, end_lr=6e-4)
    opt = pkg.optimizer.AdamW(
        learning_rate=sched, beta1=0.9, beta2=0.95, epsilon=1e-8,
        weight_decay=0.1, parameters=model.parameters(),
        apply_decay_param_fun=decays,
        grad_clip=pkg.nn.ClipGradByGlobalNorm(1.0))
    return sched, opt, pkg.amp.GradScaler(init_loss_scaling=2.0 ** 15)


def _no_decay(name):
    return name.endswith(".bias") or ".ln_" in name


def test_recipe_loss_curve_matches_jax(monkeypatch):
    cfg = _cfg()
    batches = _batches(cfg, 4, 64, 5, seed=2)
    with unique_name.guard():
        paddle.seed(0)
        jm = JGPT(JConfig(**cfg))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = pm.GPTForCausalLM(pm.GPTConfig(**cfg), device="cpu")
    pm.load_jax_state(tm, state)
    jdecay = {p.name for n, p in jm.named_parameters() if not _no_decay(n)}
    tdecay = {f"param_{i}" for i, (n, _) in enumerate(tm.named_parameters())
              if not _no_decay(n)}
    jsched, jopt, jscaler = _recipe(paddle, jm, lambda k: k in jdecay)
    tsched, topt, tscaler = _recipe(pt, tm, lambda k: k in tdecay)
    calls = {"flash": 0}
    real = k9.flash_linear_cross_entropy

    def flash(*a):
        calls["flash"] += 1
        return real(*a)

    monkeypatch.setattr(k9, "flash_linear_cross_entropy", flash)
    want, got, lrs = [], [], []
    with both_flags(enable_flash_ce=True):
        for ids, labels in batches:
            loss = jm.loss(paddle.to_tensor(ids), paddle.to_tensor(labels))
            jscaler.scale(loss).backward()
            jscaler.step(jopt)
            jscaler.update()
            jopt.clear_grad()
            jsched.step()
            want.append(float(loss))
        for ids, labels in pt.io.DeviceLoader(batches, device="cpu"):
            lrs.append(topt.get_lr())
            loss = tm.loss(ids, labels)
            tscaler.scale(loss).backward()
            tscaler.step(topt)
            tscaler.update()
            topt.clear_grad()
            tsched.step()
            got.append(float(loss.detach()))
    assert calls["flash"] == 5
    assert lrs[0] == 0.0 and lrs[1] > 0.0
    assert tscaler.state_dict() == jscaler.state_dict()
    final = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    _check(tm, got, want, final)
