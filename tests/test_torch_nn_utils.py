"""The port's ``nn.utils`` (weight-norm and spectral-norm hooks, the
parameter-vector transforms; ``paddle_tpu_torch/nn/utils/``) and the
``ParamAttr`` of the conv, norm and transformer layers against the JAX
package's on the CPU.

The hooks' twins hold the same layer (JAX's weights, ``load_jax_state``,
the hooks' tensors under their JAX names) to JAX's forward, gradients and
state within ``FP32_TOL`` (1e-5) of the largest magnitude, ten times that
for gradients. A ``ParamAttr`` with a deterministic initializer
(``Assign``, ``Constant``), a name and ``trainable`` gives the JAX layer's
parameters, names and forward.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
from paddle_tpu.framework.tensor import Tensor as JT
from paddle_tpu.utils import unique_name

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as pnn
from paddle_tpu_torch.models import load_jax_state
from tests.torch_port_util import (FP32_TOL, jax_state, port_cpu,  # noqa: F401
                                   sweep_close)

pytestmark = pytest.mark.usefixtures("port_cpu")


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _step(layer, x, pkg):
    """Forward, ``sum(y^2)`` backward; ``(y, {name: grad})``."""
    y = layer(x)
    (y * y).sum().backward()
    grads = {n: p.grad for n, p in layer.named_parameters()}
    return y, {n: np.asarray((g if pkg == "jax" else g).numpy())
               for n, g in grads.items() if g is not None}


def _hooked(name, build, apply, seed=0):
    with unique_name.guard():
        jp.seed(seed)
        jl = build(jnn)
    tl = build(pnn)
    load_jax_state(tl, jax_state(jl))
    apply(jnn, jl)
    apply(pnn, tl)
    return jl, tl


@pytest.mark.parametrize("dim", [0, 1, None])
def test_weight_norm_matches_jax(dim):
    jl, tl = _hooked("lin", lambda nn: nn.Linear(4, 3),
                     lambda nn, m: nn.utils.weight_norm(m, "weight", dim=dim))
    assert list(tl.state_dict()) == list(jl.state_dict())
    assert [n for n, _ in tl.named_parameters()] == ["bias", "weight_g",
                                                     "weight_v"]
    x = _x(2, 4)
    jy, jg = _step(jl, JT(x), "jax")
    ty, tg = _step(tl, pt.to_tensor(x), "port")
    sweep_close(ty.detach().numpy(), jy.numpy(), FP32_TOL, "forward")
    assert set(tg) == set(jg)
    for n in jg:
        sweep_close(tg[n], jg[n], 10 * FP32_TOL, n)
    sweep_close(tl.weight.detach().numpy(), jl.weight.numpy(), FP32_TOL,
                "derived weight")


def test_weight_norm_trains_and_remove_restores_the_parameter():
    """The oracles of ``tests/test_nn_utils_fused_lamb.py`` on the port."""
    pt.seed(0)
    lin = pnn.Linear(4, 3)
    w0 = lin.weight.detach().clone()
    pnn.utils.weight_norm(lin, "weight", dim=0)
    x = pt.to_tensor(_x(2, 4))
    y = lin(x)
    np.testing.assert_allclose(lin.weight.detach().numpy(), w0.numpy(),
                               rtol=1e-5, atol=1e-6)
    (y ** 2).mean().backward()
    assert lin.weight_g.grad is not None and lin.weight_v.grad is not None
    opt = pt.optimizer.SGD(0.1, parameters=lin.parameters())
    opt.step()
    opt.clear_grad()
    assert not np.allclose(lin(x).detach().numpy(), y.detach().numpy())
    ref = lin(x).detach().numpy()
    pnn.utils.remove_weight_norm(lin, "weight")
    names = [n for n, _ in lin.named_parameters()]
    assert "weight" in names and "weight_g" not in names
    np.testing.assert_allclose(lin(x).detach().numpy(), ref, rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError):
        pnn.utils.remove_weight_norm(lin, "weight")


@pytest.mark.parametrize("build,iters", [
    (lambda nn: nn.Linear(6, 8), 1), (lambda nn: nn.Linear(6, 8), 5),
    (lambda nn: nn.Conv2D(3, 4, 3), 2)])
def test_spectral_norm_hook_matches_jax(build, iters):
    jl, tl = _hooked("sn", build, lambda nn, m: nn.utils.spectral_norm(
        m, "weight", n_power_iterations=iters), seed=2)
    assert list(tl.state_dict()) == list(jl.state_dict())
    assert "weight_u" in dict(tl.named_buffers())
    x = _x(2, 6) if isinstance(tl, pnn.Linear) else _x(2, 3, 5, 5)
    for step in range(2):                 # u is written back each call
        jy, jg = _step(jl, JT(x), "jax")
        ty, tg = _step(tl, pt.to_tensor(x), "port")
        sweep_close(ty.detach().numpy(), jy.numpy(), FP32_TOL, f"{step}")
        for n in jg:
            sweep_close(tg[n], jg[n], 10 * FP32_TOL, f"{step} {n}")
        sweep_close(tl.weight_u.numpy(), jl.weight_u.numpy(), FP32_TOL, "u")
        for m in (jl, tl):
            m.clear_gradients()


def test_spectral_norm_bounds_the_singular_value():
    lin = pnn.Linear(6, 8)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(_x(6, 8, seed=3) * 5.0))
    pnn.utils.spectral_norm(lin, "weight", n_power_iterations=20)
    x = pt.to_tensor(_x(2, 6, seed=4))
    lin(x)
    sigma = np.linalg.svd(lin.weight.detach().numpy(), compute_uv=False)
    assert sigma.max() == pytest.approx(1.0, rel=1e-2)
    (lin(x) ** 2).mean().backward()
    assert lin.weight_orig.grad is not None


def test_parameters_to_vector_round_trip_matches_jax():
    with unique_name.guard():
        jp.seed(5)
        jnet = jnn.Sequential(jnn.Linear(3, 4), jnn.Linear(4, 2))
    tnet = pnn.Sequential(pnn.Linear(3, 4), pnn.Linear(4, 2))
    load_jax_state(tnet, jax_state(jnet))
    tv = pnn.utils.parameters_to_vector(tnet.parameters())
    jv = jnn.utils.parameters_to_vector(jnet.parameters())
    np.testing.assert_array_equal(tv.numpy(), jv.numpy())
    assert tv.stop_gradient
    new = np.arange(tv.shape[0], dtype=np.float32)
    pnn.utils.vector_to_parameters(pt.to_tensor(new), tnet.parameters())
    jnn.utils.vector_to_parameters(JT(new), jnet.parameters())
    for (n, p), (_, q) in zip(tnet.named_parameters(),
                              jnet.named_parameters()):
        np.testing.assert_array_equal(p.detach().numpy(), q.numpy(), n)
    with pytest.raises(ValueError, match="elements"):
        pnn.utils.vector_to_parameters(pt.to_tensor(np.zeros(3, np.float32)),
                                       tnet.parameters())


# --------------------------------------------------------- ParamAttr ----

#: (layer, args, input shape)
ATTR_LAYERS = [
    ("Conv1D", (3, 4, 3), (2, 3, 6)), ("Conv2D", (3, 4, 3), (2, 3, 5, 5)),
    ("Conv3D", (2, 4, 2), (1, 2, 3, 3, 3)),
    ("Conv1DTranspose", (3, 4, 3), (2, 3, 6)),
    ("Conv2DTranspose", (3, 4, 3), (2, 3, 4, 4)),
    ("Conv3DTranspose", (2, 4, 2), (1, 2, 3, 3, 3)),
    ("BatchNorm1D", (3,), (4, 3, 5)), ("BatchNorm2D", (3,), (2, 3, 4, 4)),
    ("BatchNorm3D", (3,), (2, 3, 2, 2, 2)), ("LayerNorm", (5,), (2, 3, 5)),
    ("GroupNorm", (2, 4), (2, 4, 3, 3)),
    ("InstanceNorm1D", (3,), (2, 3, 5)), ("InstanceNorm2D", (3,),
                                          (2, 3, 4, 4)),
    ("InstanceNorm3D", (3,), (1, 3, 2, 3, 3)), ("RMSNorm", (5,), (2, 3, 5)),
]


def _attrs(pkg, layer, shapes):
    """A weight ``ParamAttr`` (Assign of seeded values, a name, trainable)
    and a bias one (Constant, a name, not trainable)."""
    init = pkg.nn.initializer
    w = pkg.ParamAttr(name=f"{layer}_w", initializer=init.Assign(
        _x(*shapes[0], seed=7)), learning_rate=0.5)
    b = pkg.ParamAttr(name=f"{layer}_b", initializer=init.Constant(0.25),
                      trainable=False)
    return w, b


@pytest.mark.parametrize("layer,args,shape", ATTR_LAYERS,
                         ids=[c[0] for c in ATTR_LAYERS])
def test_layers_take_a_param_attr_as_jax(layer, args, shape):
    with unique_name.guard():
        probe = getattr(jnn, layer)(*args)
    shapes = [list(p.shape) for p in probe.parameters()]
    kw = lambda pkg: dict(zip(("weight_attr", "bias_attr"),
                              _attrs(pkg, layer, shapes)))
    with unique_name.guard():
        jl = getattr(jnn, layer)(*args, **(
            {"weight_attr": kw(jp)["weight_attr"]} if layer == "RMSNorm"
            else kw(jp)))
    tl = getattr(pnn, layer)(*args, **(
        {"weight_attr": kw(pt)["weight_attr"]} if layer == "RMSNorm"
        else kw(pt)))
    jps, tps = dict(jl.named_parameters()), dict(tl.named_parameters())
    assert list(tps) == list(jps)
    for n, p in tps.items():
        q = jps[n]
        assert p.name == q.name, n
        assert p.stop_gradient == q.stop_gradient, n
        assert p.optimize_attr["learning_rate"] == \
            q.optimize_attr["learning_rate"], n
        np.testing.assert_array_equal(p.detach().numpy(), q.numpy(), n)
    x = _x(*shape, seed=1)
    sweep_close(tl(pt.to_tensor(x)).detach().numpy(), jl(JT(x)).numpy(),
                FP32_TOL, layer)


@pytest.mark.parametrize("layer", ["TransformerEncoderLayer",
                                   "MultiHeadAttention"])
def test_transformer_layers_take_a_param_attr_as_jax(layer):
    def build(pkg, nn):
        init = pkg.nn.initializer
        w = pkg.ParamAttr(initializer=init.Constant(0.05))
        b = pkg.ParamAttr(initializer=init.Constant(-0.02))
        if layer == "MultiHeadAttention":
            return nn.MultiHeadAttention(8, 2, weight_attr=w, bias_attr=b)
        return nn.TransformerEncoderLayer(8, 2, 16, 0.0, weight_attr=w,
                                          bias_attr=b)

    with unique_name.guard():
        jl = build(jp, jnn)
    tl = build(pt, pnn)
    for (n, p), (_, q) in zip(tl.named_parameters(), jl.named_parameters()):
        np.testing.assert_array_equal(p.detach().numpy(), q.numpy(), n)
    jl.eval()
    tl.eval()
    x = _x(2, 3, 8)
    sweep_close(tl(pt.to_tensor(x)).detach().numpy(), jl(JT(x)).numpy(),
                FP32_TOL, layer)
