"""The port's instance, group, local-response, spectral and RMS norms and
the adaptive max, power-average and unpooling functionals and their
layers (``paddle_tpu_torch/nn/functional/norm.py``, ``pooling.py``,
``nn/layer/norm.py``, ``pooling.py``) against the JAX package's on the
CPU.

Limits: ``FP32_TOL`` (1e-5) of the largest JAX magnitude for outputs, ten
times that for gradients (``twin_check``); bf16 inputs within one bf16
step (2^-8) of the largest magnitude of JAX's fp32-statistics result.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.framework.tensor import Tensor as JT
from paddle_tpu.utils import unique_name

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as pnn
import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch.models import load_jax_state
from tests.torch_port_util import (jax_state, port_cpu,  # noqa: F401
                                   sweep_close, twin_check)

pytestmark = pytest.mark.usefixtures("port_cpu")

BF16_STEP = 2.0 ** -8


def _x(*shape, seed=0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) + shift).astype(
        np.float32)


def _pair(name, *args, **kw):
    """The JAX layer ``name`` and the port's holding its weights."""
    with unique_name.guard():
        jl = getattr(jnn, name)(*args, **kw)
    tl = getattr(pnn, name)(*args, **kw)
    load_jax_state(tl, jax_state(jl))
    return jl, tl


# -------------------------------------------------------------- norms ----

@pytest.mark.parametrize("shape", [(2, 3, 5), (2, 3, 4, 5), (1, 2, 3, 4, 3)])
def test_instance_norm_matches_jax(shape):
    x, w, b = _x(*shape, shift=2.0), _x(shape[1], seed=1), _x(shape[1], seed=2)
    twin_check(lambda a, u, v: JF.instance_norm(a, weight=u, bias=v),
               lambda a, u, v: PF.instance_norm(a, weight=u, bias=v),
               [x, w, b], diff=(0, 1, 2))
    twin_check(JF.instance_norm, PF.instance_norm, [x])
    # ignored, as in the JAX package and Paddle's dygraph op
    rm, rv = np.zeros(shape[1], np.float32), np.ones(shape[1], np.float32)
    twin_check(lambda a, m, v: JF.instance_norm(a, m, v,
                                                use_input_stats=False),
               lambda a, m, v: PF.instance_norm(a, m, v,
                                                use_input_stats=False),
               [x, rm, rv])


@pytest.mark.parametrize("groups,df", [(1, "NCHW"), (2, "NCHW"), (6, "NCHW"),
                                       (3, "NHWC")])
def test_group_norm_matches_jax(groups, df):
    x = _x(2, 6, 3, 4, shift=1.0) if df == "NCHW" else _x(2, 3, 4, 6)
    w, b = _x(6, seed=1), _x(6, seed=2)
    twin_check(lambda a, u, v: JF.group_norm(a, groups, 1e-5, u, v, df),
               lambda a, u, v: PF.group_norm(a, groups, 1e-5, u, v, df),
               [x, w, b], diff=(0, 1, 2))
    twin_check(lambda a: JF.group_norm(a, groups, data_format=df),
               lambda a: PF.group_norm(a, groups, data_format=df), [x])


def test_norms_keep_a_channels_last_input_channels_last_and_bf16():
    x = _x(2, 8, 5, 6, shift=3.0)
    xc = torch.from_numpy(x).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    w, b = torch.from_numpy(_x(8, seed=1)), torch.from_numpy(_x(8, seed=2))
    for name, fn, jfn in (
            ("group_norm", lambda a: PF.group_norm(a, 4, 1e-5, w, b),
             lambda a: JF.group_norm(a, 4, 1e-5, JT(w.numpy()),
                                     JT(b.numpy()))),
            ("instance_norm", lambda a: PF.instance_norm(a, weight=w,
                                                         bias=b),
             lambda a: JF.instance_norm(a, weight=JT(w.numpy()),
                                        bias=JT(b.numpy())))):
        y = fn(xc)
        assert y.dtype == torch.bfloat16, name
        assert y.is_contiguous(memory_format=torch.channels_last), name
        want = np.asarray(jfn(JT(xc.float().numpy()).astype("bfloat16"))
                          .astype("float32").numpy())
        sweep_close(y.float().numpy(), want, BF16_STEP, name)


@pytest.mark.parametrize("size,df", [(3, "NCHW"), (5, "NCHW"), (4, "NHWC")])
def test_local_response_norm_matches_jax(size, df):
    """The JAX package's formula, kept (ROADMAP.md C): ``alpha`` times the
    window's sum of squares, not Paddle's ``alpha / size``."""
    x = _x(2, 7, 3, 4) if df == "NCHW" else _x(2, 3, 4, 7)
    kw = dict(alpha=1e-2, beta=0.75, k=1.0, data_format=df)
    twin_check(lambda a: JF.local_response_norm(a, size, **kw),
               lambda a: PF.local_response_norm(a, size, **kw), [x])
    jl, tl = _pair("LocalResponseNorm", size, **kw)
    twin_check(jl, tl, [x])


@pytest.mark.parametrize("dim,iters", [(0, 1), (1, 3)])
def test_spectral_norm_matches_jax(dim, iters):
    w, u = _x(4, 3, 2), _x(4 if dim == 0 else 3, seed=1)
    v = _x(6 if dim == 0 else 8, seed=2)
    twin_check(lambda a, p, q: JF.spectral_norm(a, p, q, dim, iters),
               lambda a, p, q: PF.spectral_norm(a, p, q, dim, iters),
               [w, u, v], diff=(0,))
    jl, tl = _pair("SpectralNorm", [4, 3, 2], dim, iters)
    assert [n for n, _ in tl.named_parameters()] == ["weight_u", "weight_v"]
    assert not tl.weight_u.requires_grad
    out = twin_check(jl, tl, [w])[0]
    twin_check(jl, tl, [w])                       # u, v are not written
    np.testing.assert_allclose(tl(pt.to_tensor(w)).numpy(), out.numpy())


def test_rms_norm_layer_matches_jax_in_the_input_dtype():
    jl, tl = _pair("RMSNorm", 6)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(_x(6, seed=3)))
    jl.weight.set_value(tl.weight.detach().numpy())
    x = _x(3, 4, 6)
    twin_check(jl, tl, [x])
    y = tl(torch.from_numpy(x).to(torch.bfloat16))
    assert y.dtype == torch.float32          # promoted against fp32 gamma
    xb = torch.from_numpy(x).to(torch.bfloat16)
    tl.to(torch.bfloat16)
    assert tl(xb).dtype == torch.bfloat16


@pytest.mark.parametrize("name,args", [
    ("GroupNorm", (2, 6)), ("InstanceNorm1D", (6,)), ("InstanceNorm2D", (6,)),
    ("InstanceNorm3D", (6,))])
def test_norm_layers_match_jax(name, args):
    jl, tl = _pair(name, *args)
    assert [n for n, _ in tl.named_parameters()] == [
        n for n, _ in jl.named_parameters()]
    nd = {"1D": 1, "3D": 3}.get(name[-2:], 2)
    x = _x(2, 6, *(3,) * nd, shift=0.5)
    twin_check(jl, tl, [x])
    for flag in ("weight_attr", "bias_attr"):
        j2, t2 = _pair(name, *args, **{flag: False})
        assert [n for n, _ in t2.named_parameters()] == [
            n for n, _ in j2.named_parameters()]
        if name != "GroupNorm":
            twin_check(j2, t2, [x])


def test_group_norm_takes_a_weight_or_a_bias_alone():
    """Declared: Paddle applies whichever of ``weight`` and ``bias`` is
    given; the JAX package drops a bias given alone and fails on a weight
    given alone."""
    x, w, b = _x(2, 6, 3, 4), _x(6, seed=1), _x(6, seed=2)
    base = JF.group_norm(JT(x), 2).numpy()
    c = (1, 6, 1, 1)
    for kw, want in ((dict(weight=w), base * w.reshape(c)),
                     (dict(bias=b), base + b.reshape(c))):
        got = PF.group_norm(pt.to_tensor(x), 2, **{
            k: pt.to_tensor(v) for k, v in kw.items()}).numpy()
        sweep_close(got, want, 1e-5, str(list(kw)))
    jax = JF.group_norm(JT(x), 2, bias=JT(b)).numpy()
    np.testing.assert_array_equal(jax, base)


# -------------------------------------------------------------- pools ----

@pytest.mark.parametrize("nd,out", [(1, 3), (1, 4), (2, [2, 3]), (3, 2),
                                    (3, [1, 2, 3])])
def test_adaptive_max_pool_matches_jax(nd, out):
    x = _x(2, 3, *[7, 6, 5][:nd])
    name = f"adaptive_max_pool{nd}d"
    twin_check(lambda a: getattr(JF, name)(a, out),
               lambda a: getattr(PF, name)(a, out), [x])
    layer = f"AdaptiveMaxPool{nd}D"
    twin_check(getattr(jnn, layer)(out), getattr(pnn, layer)(out), [x])
    y, idx = getattr(PF, name)(pt.to_tensor(x), out, return_mask=True)
    flat = x.reshape(2, 3, -1)
    np.testing.assert_array_equal(
        np.take_along_axis(flat, idx.numpy().reshape(2, 3, -1), 2),
        y.numpy().reshape(2, 3, -1))


@pytest.mark.parametrize("p", [1.0, 2.0, 3.0])
def test_lp_pool_matches_jax(p):
    x1, x2 = _x(2, 3, 9), _x(2, 3, 6, 7)
    twin_check(lambda a: JF.lp_pool1d(a, p, 3, 2),
               lambda a: PF.lp_pool1d(a, p, 3, 2), [x1])
    twin_check(lambda a: JF.lp_pool2d(a, p, [2, 3], [2, 1]),
               lambda a: PF.lp_pool2d(a, p, [2, 3], [2, 1]), [x2])


@pytest.mark.parametrize("nd", [1, 2, 3])
def test_max_unpool_matches_jax(nd):
    shape = (2, 3) + (8, 6, 4)[:nd]
    x = _x(*shape)
    pool = getattr(PF, f"max_pool{nd}d")
    out, mask = pool(pt.to_tensor(x), 2, 2, return_mask=True)
    name = f"max_unpool{nd}d"
    twin_check(lambda a, m: getattr(JF, name)(a, m, 2, 2),
               lambda a, m: getattr(PF, name)(a, m, 2, 2),
               [out.numpy(), mask.numpy()])
    layer = f"MaxUnPool{nd}D"
    twin_check(getattr(jnn, layer)(2, 2), getattr(pnn, layer)(2, 2),
               [out.numpy(), mask.numpy()])
    size = [s + 1 for s in shape[2:]]
    twin_check(lambda a, m: getattr(JF, name)(a, m, 2, 2, output_size=size),
               lambda a, m: getattr(PF, name)(a, m, 2, 2, output_size=size),
               [out.numpy(), mask.numpy()])


def test_max_pool_mask_and_unpool_as_the_oracle():
    """``tests/test_api_audit_round4.py::test_max_pool_mask_and_unpool`` on
    the port."""
    x = np.random.RandomState(1).randn(2, 3, 8, 8).astype(np.float32)
    out, mask = PF.max_pool2d(pt.to_tensor(x), 2, 2, return_mask=True)
    m, o = mask.numpy(), out.numpy()
    win = x.reshape(2, 3, 4, 2, 4, 2).max((3, 5))
    np.testing.assert_array_equal(x.reshape(2, 3, 64)[
        np.arange(2)[:, None, None], np.arange(3)[None, :, None],
        m.reshape(2, 3, 16)].reshape(2, 3, 4, 4), win)
    un = PF.max_unpool2d(out, mask, 2, 2).numpy()
    want = torch.nn.functional.max_unpool2d(
        torch.from_numpy(o), torch.from_numpy(m.astype(np.int64)), 2, 2)
    np.testing.assert_allclose(un, want.numpy())
    nhwc = PF.max_unpool2d(pt.to_tensor(o.transpose(0, 2, 3, 1)),
                           pt.to_tensor(m.transpose(0, 2, 3, 1)), 2, 2,
                           data_format="NHWC").numpy()
    np.testing.assert_allclose(nhwc.transpose(0, 3, 1, 2), un)
