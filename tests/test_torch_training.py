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
  on the CPU), which a spy asserts.

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
from paddle_tpu_torch.ops.cuda import flash_attention_packed as k5
from paddle_tpu_torch.ops.cuda import layer_norm as k7

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
    linear = {f"{n}.weight" for n, mod in tm.named_modules()
              if isinstance(mod, torch.nn.Linear)}
    for name, p in tm.named_parameters():
        want = final[name].T if name in linear else final[name]
        np.testing.assert_allclose(p.detach().numpy(), want,
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
