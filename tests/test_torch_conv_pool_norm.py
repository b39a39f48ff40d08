"""The port's convolution, pooling and batch-norm functionals and layers
(``paddle_tpu_torch/nn``), layout autotune and the weight and state
carry-over of the vision path, against the JAX package on the CPU, from the
same numpy inputs.

Limits:
* fp32 values and gradients: ``FP32_TOL`` (1e-5) absolute and 1e-5
  relative, the same fp32 arithmetic in another order (XLA:CPU against
  PyTorch's CPU kernels);
* a bf16 input with fp32 batch-norm parameters: the output is bf16 in both,
  and within one bf16 step (2^-7 · max(1, |ref|)) of JAX's, since both
  compute in fp32 and round once, at places a rounding apart;
* pooling windows that cover padding only (JAX's ``ceil_mode``) must be
  exactly ``-inf`` (max) or NaN (exclusive avg) in both; return masks are
  equal integers.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import nn as jnn
from paddle_tpu.framework.tensor import Tensor

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.framework.layout_autotune import layout_autotune_enabled
from paddle_tpu_torch.incubate import autotune
from tests.torch_port_util import FP32_TOL, jax_state, port_cpu  # noqa: F401

# the layers here are built on the CPU place
pytestmark = pytest.mark.usefixtures("port_cpu")

TOL = dict(atol=FP32_TOL, rtol=1e-5)
BF16_STEP = 2.0 ** -7


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) else np.asarray(
        t.astype("float32").numpy())


def _close(got, want, **kw):
    np.testing.assert_allclose(_np(got), _np(want), **(kw or TOL))


@pytest.fixture
def layout(request):
    """Layout autotune on or off for the test, in both packages."""
    import paddle_tpu.incubate.autotune as jautotune

    on = request.param
    autotune.set_config({"layout": {"enable": on}})
    jautotune.set_config({"layout": {"enable": on}})
    yield on
    autotune.set_config(None)
    jautotune.set_config(None)


def _grads_of(fn_j, fn_t, arrays, w_seed=9):
    """Forward values and the gradients of sum(out * r) for every input,
    in JAX and in the port."""
    jin = [Tensor(a) for a in arrays]
    for t in jin:
        t.stop_gradient = False
    tin = [torch.from_numpy(a).requires_grad_() for a in arrays]
    jout, tout = fn_j(*jin), fn_t(*tin)
    r = _x(*tout.shape, seed=w_seed)
    (jout * Tensor(r)).sum().backward()
    (tout * torch.from_numpy(r)).sum().backward()
    return (jout, tout), [(j.grad, t.grad) for j, t in zip(jin, tin)]


# -- convolutions --------------------------------------------------------------

CONV_CASES = {
    "int": dict(padding=1),
    "per_dim": dict(padding=[1, 2]),
    "2n_asymmetric": dict(padding=[0, 1, 2, 0]),
    "nested_with_batch_channel": dict(padding=[[0, 0], [0, 0], [1, 0],
                                               [2, 1]]),
    "nested_with_batch_channel_nhwc": dict(padding=[[0, 0], [1, 0], [2, 1],
                                                    [0, 0]],
                                           data_format="NHWC"),
    "nested": dict(padding=[[1, 0], [0, 2]]),
    "same_stride2": dict(padding="SAME", stride=2),
    "same_lower_stride2_dilation2": dict(padding="same", stride=2,
                                          dilation=2),
    "valid": dict(padding="VALID", stride=(2, 1)),
    "dilation_groups": dict(padding=2, dilation=2, groups=2),
    "nhwc": dict(padding=[1, 0], stride=2, data_format="NHWC"),
}


#: JAX reads four [l, r] pairs of a 2-D conv as ``2n`` ints and raises; its
#: result for the same pads without the batch and channel pairs stands in
JAX_PADDING = {"nested_with_batch_channel": [[1, 0], [2, 1]],
               "nested_with_batch_channel_nhwc": [[1, 0], [2, 1]]}


@pytest.mark.parametrize("layout", [False, True], indirect=True,
                         ids=["nchw", "autotune"])
@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv2d_matches_jax(case, layout):
    kw = dict(CONV_CASES[case])
    jkw = dict(kw, padding=JAX_PADDING.get(case, kw["padding"]))
    nhwc = kw.get("data_format") == "NHWC"
    groups = kw.get("groups", 1)
    x = _x(2, 7, 7, 4) if nhwc else _x(2, 4, 7, 7)
    w = _x(6, 4 // groups, 3, 3, seed=1) * 0.3
    b = _x(6, seed=2)
    (jo, to), grads = _grads_of(lambda *a: JF.conv2d(*a, **jkw),
                                lambda *a: PF.conv2d(*a, **kw), [x, w, b])
    assert list(to.shape) == list(jo.shape)
    _close(to, jo)
    for jg, tg in grads:
        _close(tg, jg)
    if layout and not nhwc:
        assert to.is_contiguous(memory_format=torch.channels_last)


def test_same_padding_at_stride_2_puts_the_odd_cell_on_the_right():
    # XLA's SAME: a 6 x 6 input, k3, s2 gives 3 x 3 with pads (0, 1)
    x, w = _x(1, 1, 6, 6), _x(1, 1, 3, 3, seed=1)
    got = PF.conv2d(torch.from_numpy(x), torch.from_numpy(w), padding="SAME",
                    stride=2)
    assert tuple(got.shape) == (1, 1, 3, 3)
    want = PF.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                     padding=[0, 1, 0, 1], stride=2)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    _close(got, JF.conv2d(Tensor(x), Tensor(w), padding="SAME", stride=2))


@pytest.mark.parametrize("layout", [False, True], indirect=True,
                         ids=["ncl", "autotune"])
@pytest.mark.parametrize("data_format", ["NCL", "NLC"])
def test_conv1d_matches_jax(data_format, layout):
    kw = dict(padding="SAME", stride=2, data_format=data_format)
    x = _x(2, 9, 3) if data_format == "NLC" else _x(2, 3, 9)
    (jo, to), grads = _grads_of(lambda *a: JF.conv1d(*a, **kw),
                                lambda *a: PF.conv1d(*a, **kw),
                                [x, _x(5, 3, 3, seed=1)])
    _close(to, jo)
    for jg, tg in grads:
        _close(tg, jg)


@pytest.mark.parametrize("layout", [False, True], indirect=True,
                         ids=["ncdhw", "autotune"])
@pytest.mark.parametrize("data_format", ["NCDHW", "NDHWC"])
def test_conv3d_matches_jax(data_format, layout):
    pads = [[1, 0], [1, 1], [0, 2]]
    kw = dict(padding=[1, 0, 1, 1, 0, 2], stride=(1, 2, 1),
              data_format=data_format)
    if data_format == "NCDHW":      # nested, with the batch and channel pairs
        kw["padding"] = [[0, 0], [0, 0], *pads]
    x = _x(1, 5, 6, 4, 2) if data_format == "NDHWC" else _x(1, 2, 5, 6, 4)
    (jo, to), grads = _grads_of(lambda *a: JF.conv3d(*a, **kw),
                                lambda *a: PF.conv3d(*a, **kw),
                                [x, _x(3, 2, 3, 2, 3, seed=1), _x(3, seed=2)])
    _close(to, jo)
    for jg, tg in grads:
        _close(tg, jg)


def test_conv_passes_the_amp_hook_as_conv_nd():
    x, w = torch.randn(1, 2, 5, 5), torch.randn(3, 2, 3, 3)
    with pt.amp.auto_cast(level="O1"):
        out = PF.conv2d(x, w, padding=1)
    assert out.dtype == torch.bfloat16
    assert PF.conv2d(x, w).dtype == torch.float32


# -- pooling -------------------------------------------------------------------

def _pool_pair(name, x, *args, **kw):
    return (getattr(JF, name)(Tensor(x), *args, **kw),
            getattr(PF, name)(torch.from_numpy(x), *args, **kw))


def _mask_reference(x, ks, st, pads):
    """Each window's first maximum as a flat index into ``x``'s spatial dims
    (``[N, C, *spatial]``), padding read as -inf; a window of padding only
    gives its first cell."""
    nd = len(ks)
    xp = np.pad(x, [(0, 0), (0, 0), *pads], constant_values=-np.inf)
    out_sizes = [(xp.shape[2 + d] - ks[d]) // st[d] + 1 for d in range(nd)]
    mask = np.zeros(x.shape[:2] + tuple(out_sizes), np.int64)
    for o in np.ndindex(*out_sizes):
        win = xp[(slice(None), slice(None), *(
            slice(o[d] * st[d], o[d] * st[d] + ks[d]) for d in range(nd)))]
        off = np.unravel_index(win.reshape(*x.shape[:2], -1).argmax(-1), ks)
        flat = 0
        for d in range(nd):
            flat = flat * x.shape[2 + d] + (o[d] * st[d] - pads[d][0]
                                             + off[d])
        mask[(slice(None), slice(None), *o)] = flat
    return mask


def test_ceil_mode_windows_of_padding_only_follow_jax():
    # 5 x 5, k2, s2, p1: JAX pads on the right until the last window fits
    # and gives 4 x 4 (PyTorch's own ceil_mode gives 3 x 3); its last row
    # and column cover padding only: -inf for max, 0 / 0 for exclusive avg
    x = _x(2, 3, 5, 5)
    jo, to = _pool_pair("max_pool2d", x, 2, 2, 1, ceil_mode=True)
    assert tuple(to.shape) == tuple(jo.shape) == (2, 3, 4, 4)
    assert torch.isneginf(to[..., 3, :]).all()
    assert torch.isneginf(to[..., :, 3]).all()
    _close(to, jo)
    jo, to = _pool_pair("avg_pool2d", x, 2, 2, 1, ceil_mode=True,
                        exclusive=True)
    assert tuple(to.shape) == (2, 3, 4, 4)
    assert torch.isnan(to[..., 3, :]).all() and torch.isnan(to[..., :, 3]).all()
    assert not torch.isnan(to[..., :3, :3]).any()
    np.testing.assert_allclose(_np(to), _np(jo), equal_nan=True, **TOL)


def test_max_pool_padding_wider_than_half_the_window_follows_jax():
    # k3, p2 on 5 x 5 gives 7 x 7 in JAX; PyTorch's pooling refuses p > k/2
    x = _x(2, 3, 5, 5)
    jo, to = _pool_pair("max_pool2d", x, 3, 1, 2)
    assert tuple(to.shape) == (2, 3, 7, 7)
    _close(to, jo)


POOL_CASES = {
    "max_k3_s2_p1": ("max_pool2d", (3, 2, 1), {}),
    "max_same": ("max_pool2d", (3, 2, "SAME"), {}),
    "max_asymmetric": ("max_pool2d", (2, 2, [[0, 1], [1, 0]]), {}),
    "max_nhwc_ceil": ("max_pool2d", (3, 2, 1),
                      dict(ceil_mode=True, data_format="NHWC")),
    "avg_exclusive_p1": ("avg_pool2d", (3, 2, 1), dict(exclusive=True)),
    "avg_inclusive_p1": ("avg_pool2d", (3, 2, 1), dict(exclusive=False)),
    "avg_same": ("avg_pool2d", (3, 2, "SAME"), {}),
    "avg_valid": ("avg_pool2d", (2, 2, "VALID"), {}),
    "avg_nhwc_ceil": ("avg_pool2d", (2, 2, 0),
                      dict(ceil_mode=True, data_format="NHWC")),
    "max1d": ("max_pool1d", (3, 2, 1), {}),
    "avg1d_ceil": ("avg_pool1d", (2, 2, 0), dict(ceil_mode=True)),
    "max3d": ("max_pool3d", (2, 2, [0, 1, 1]), {}),
    "avg3d_exclusive": ("avg_pool3d", (3, 2, 1), {}),
}


@pytest.mark.parametrize("name", ["max_pool2d", "avg_pool2d"])
@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_pooling_takes_four_nested_pairs_where_jax_raises(name, data_format):
    """A declared widening (ROADMAP.md C, beside conv2d's): four nested
    ``[l, r]`` pairs, the batch and channel pairs zeros, give the two-pair
    call's values in the port; the JAX package raises ``TypeError``."""
    hw = [[1, 0], [0, 1]]
    four = ([[0, 0], [0, 0], *hw] if data_format == "NCHW"
            else [[0, 0], *hw, [0, 0]])
    x = _x(2, 3, 7, 6)
    if data_format == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    fn = getattr(PF, name)
    got = fn(torch.from_numpy(x), 3, 2, four, data_format=data_format)
    want = fn(torch.from_numpy(x), 3, 2, hw, data_format=data_format)
    assert torch.equal(got, want)
    with pytest.raises(TypeError):
        getattr(JF, name)(Tensor(x), 3, 2, four, data_format=data_format)


@pytest.mark.parametrize("case", list(POOL_CASES))
def test_pooling_matches_jax(case):
    name, args, kw = POOL_CASES[case]
    nd = int(name[-2])
    shape = {1: (2, 3, 9), 2: (2, 3, 7, 6), 3: (1, 2, 5, 6, 4)}[nd]
    x = _x(*shape)
    if kw.get("data_format") == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    (jo, to), ((jg, tg),) = _grads_of(lambda a: getattr(JF, name)(a, *args,
                                                                   **kw),
                                      lambda a: getattr(PF, name)(a, *args,
                                                                  **kw), [x])
    assert list(to.shape) == list(jo.shape)
    _close(to, jo)
    _close(tg, jg)


def test_max_pool_mask_matches_jax_where_no_window_meets_padding():
    x = _x(2, 3, 7, 6)
    jo, to = _pool_pair("max_pool2d", x, 2, 2, 0, return_mask=True)
    _close(to[0], jo[0])
    assert to[1].dtype == torch.int32
    np.testing.assert_array_equal(to[1].numpy(), np.asarray(jo[1].numpy()))


MASK_CASES = {   # name, shape, (kernel, stride, padding), kw, the pads
    "2d_k3_s2_p1": ("max_pool2d", (2, 3, 7, 6), (3, 2, 1), {},
                    [(1, 1), (1, 1)]),
    "2d_ceil_padding_only": ("max_pool2d", (2, 3, 5, 5), (2, 2, 1),
                             dict(ceil_mode=True), [(1, 2), (1, 2)]),
    "2d_wide_padding": ("max_pool2d", (2, 3, 5, 5), (3, 1, 2), {},
                        [(2, 2), (2, 2)]),
    "2d_nhwc_ceil": ("max_pool2d", (2, 3, 7, 6), (3, 2, 1),
                     dict(ceil_mode=True, data_format="NHWC"),
                     [(1, 1), (1, 2)]),
    "1d": ("max_pool1d", (2, 3, 9), (3, 2, 1), {}, [(1, 1)]),
    "3d": ("max_pool3d", (1, 2, 5, 6, 4), (2, 2, [0, 1, 1]), {},
           [(0, 0), (1, 1), (1, 1)]),
}


@pytest.mark.parametrize("case", list(MASK_CASES))
def test_max_pool_mask_with_padding_is_the_first_maximum(case):
    # JAX's mask reads each window through conv_general_dilated_patches of
    # the -inf-padded input, where -inf * 0 gives NaN and argmax picks the
    # padding (ROADMAP.md C): where a window meets padding the port is held
    # to the mask's definition instead, the first maximum in input
    # coordinates (a window of padding only: its first cell)
    name, shape, (k, st, pad), kw, pads = MASK_CASES[case]
    x = _x(*shape)
    nhwc = kw.get("data_format") == "NHWC"
    xin = np.ascontiguousarray(x.transpose(0, 2, 3, 1)) if nhwc else x
    jo, (out, mask) = _pool_pair(name, xin, k, st, pad, return_mask=True,
                                 **kw)
    _close(out, jo[0])
    if nhwc:
        mask = mask.permute(0, 3, 1, 2)
    nd = len(shape) - 2
    np.testing.assert_array_equal(
        mask.numpy(), _mask_reference(x, (k,) * nd, (st,) * nd, pads))


@pytest.mark.parametrize("name,shape,size,kw", [
    ("adaptive_avg_pool1d", (2, 3, 10), 4, {}),
    ("adaptive_avg_pool2d", (2, 3, 7, 9), (3, 4), {}),
    ("adaptive_avg_pool2d", (2, 6, 8, 3), (2, 1), dict(data_format="NHWC")),
    ("adaptive_avg_pool2d", (2, 3, 7, 7), 1, {}),
    ("adaptive_avg_pool3d", (1, 2, 5, 6, 7), (2, 3, 3), {}),
    ("adaptive_max_pool2d", (2, 3, 7, 9), (3, 4), {}),
    ("adaptive_max_pool2d", (2, 3, 8, 8), 4, {}),
], ids=["avg1d", "avg2d_uneven", "avg2d_nhwc", "avg2d_global", "avg3d",
        "max2d_uneven", "max2d_even"])
def test_adaptive_pooling_matches_jax(name, shape, size, kw):
    (jo, to), ((jg, tg),) = _grads_of(
        lambda a: getattr(JF, name)(a, size, **kw),
        lambda a: getattr(PF, name)(a, size, **kw), [_x(*shape)])
    assert list(to.shape) == list(jo.shape)
    _close(to, jo)
    _close(tg, jg)


# -- batch norm ----------------------------------------------------------------

BN_FORMATS = {"NCHW": (4, 3, 5, 5), "NHWC": (4, 5, 5, 3), "NC": (16, 3),
              "NCL": (4, 3, 7), "NLC": (4, 7, 3), "NCDHW": (2, 3, 3, 4, 2)}


def _bn_state(seed=5):
    rng = np.random.RandomState(seed)
    return [rng.randn(3).astype(np.float32) * 0.1,
            rng.rand(3).astype(np.float32) + 0.5,
            rng.rand(3).astype(np.float32) + 0.5,
            rng.randn(3).astype(np.float32)]


@pytest.mark.parametrize("data_format", list(BN_FORMATS))
def test_batch_norm_training_matches_jax_with_running_stats(data_format):
    rm, rv, w, b = _bn_state()
    jrm, jrv = Tensor(rm.copy()), Tensor(rv.copy())
    trm, trv = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    for step in range(3):
        x = _x(*BN_FORMATS[data_format], seed=step) * 2.0 + 0.5
        kw = dict(training=True, momentum=0.9, epsilon=1e-5,
                  data_format=data_format)
        (jo, to), grads = _grads_of(
            lambda a, ww, bb: JF.batch_norm(a, jrm, jrv, ww, bb, **kw),
            lambda a, ww, bb: PF.batch_norm(a, trm, trv, ww, bb, **kw),
            [x, w, b], w_seed=20 + step)
        _close(to, jo)
        for jg, tg in grads:
            _close(tg, jg)
    _close(trm, jrm)
    _close(trv, jrv)


@pytest.mark.parametrize("use_global_stats,training",
                         [(None, False), (True, True)],
                         ids=["eval", "global_stats_in_training"])
def test_batch_norm_running_stats_path_matches_jax(use_global_stats,
                                                   training):
    rm, rv, w, b = _bn_state()
    x = _x(4, 3, 5, 5)
    jrm, trm = Tensor(rm.copy()), torch.from_numpy(rm.copy())
    kw = dict(training=training, use_global_stats=use_global_stats)
    (jo, to), grads = _grads_of(
        lambda a, ww, bb: JF.batch_norm(a, jrm, Tensor(rv), ww, bb, **kw),
        lambda a, ww, bb: PF.batch_norm(a, trm, torch.from_numpy(rv), ww, bb,
                                        **kw), [x, w, b])
    _close(to, jo)
    for jg, tg in grads:
        _close(tg, jg)
    np.testing.assert_array_equal(trm.numpy(), rm)     # not updated


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_bf16_input_with_fp32_params_stays_bf16(training):
    rm, rv, w, b = _bn_state()
    x = _x(4, 3, 6, 6) * 3.0 + 1.0
    jrm, jrv = Tensor(rm.copy()), Tensor(rv.copy())
    trm, trv = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    want = JF.batch_norm(Tensor(x).astype("bfloat16"), jrm, jrv, Tensor(w),
                         Tensor(b), training=training)
    got = PF.batch_norm(torch.from_numpy(x).bfloat16(), trm, trv,
                        torch.from_numpy(w), torch.from_numpy(b),
                        training=training)
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    g, ref = _np(got), _np(want)
    assert (np.abs(g - ref) <= BF16_STEP * np.maximum(1, np.abs(ref))).all()
    assert trm.dtype == trv.dtype == torch.float32
    _close(trm, jrm)
    _close(trv, jrv)


# -- layers --------------------------------------------------------------------

def test_conv_layers_draw_xavier_normal_and_take_no_param_attr():
    conv = pnn.Conv2D(64, 128, 3, groups=2,
                      generator=torch.Generator().manual_seed(0))
    assert tuple(conv.weight.shape) == (128, 32, 3, 3)
    want = math.sqrt(2.0 / ((32 + 128) * 9))
    assert abs(float(conv.weight.detach().std()) / want - 1) < 0.02
    assert float(conv.bias.detach().abs().max()) == 0.0
    assert pnn.Conv1D(2, 3, 3, bias_attr=False).bias is None
    # a ParamAttr is taken since A7(a2) (tests/test_torch_nn_utils.py
    # holds every layer's against the JAX package's)
    attr = pt.ParamAttr(name="w", initializer=pnn.initializer.Constant(0.5))
    w = pnn.Conv2D(2, 3, 3, weight_attr=attr).weight
    assert w.name == "w" and float(w.detach().min()) == 0.5 == float(
        w.detach().max())
    with pytest.raises(NotImplementedError):
        pnn.Conv2D(2, 3, 3, padding_mode="reflect")


def test_layers_built_under_layout_autotune_keep_channels_last_weights():
    try:
        autotune.set_config({"layout": {"enable": True}})
        assert layout_autotune_enabled()
        assert autotune.get_status()["layout"]["enable"] is True
        conv = pnn.Conv2D(3, 8, 3, padding=1)
        assert conv.weight.is_contiguous(memory_format=torch.channels_last)
        out = conv(torch.randn(2, 3, 8, 8))
        assert out.shape == (2, 8, 8, 8)
        assert out.is_contiguous(memory_format=torch.channels_last)
    finally:
        autotune.set_config(None)
    assert not layout_autotune_enabled()
    assert pnn.Conv2D(3, 8, 3).weight.is_contiguous()


def test_autotune_sections_map_as_in_jax(tmp_path):
    from paddle_tpu_torch.framework import flag_value

    autotune.set_config({"kernel": {"enable": False}})
    try:
        assert flag_value("disable_flash_attention") is True
        assert autotune.get_status()["kernel"]["enable"] is False
        autotune.set_config({"kernel": {"enable": True},
                             "dataloader": {"enable": True}})
        assert flag_value("disable_flash_attention") is False
        assert autotune.get_status()["dataloader"]["enable"] is True
        path = tmp_path / "tune.json"
        path.write_text('{"layout": {"enable": true}}')
        autotune.set_config(str(path))
        assert layout_autotune_enabled()
    finally:
        autotune.set_config(None)
    assert not layout_autotune_enabled()
    assert autotune.get_status() == {"kernel": {"enable": True},
                                     "layout": {"enable": False},
                                     "dataloader": {"enable": False}}
    with pytest.raises(ValueError):
        autotune.set_config({"nope": {}})
    with pytest.raises(TypeError):
        autotune.set_config(3)


@pytest.mark.parametrize("cls,shape,fmt", [
    ("BatchNorm1D", (8, 4, 5), "NCL"),
    ("BatchNorm2D", (4, 5, 5, 4), "NHWC"),
    ("BatchNorm3D", (2, 4, 3, 3, 2), "NCDHW"),
])
def test_batch_norm_layers_match_jax(cls, shape, fmt):
    jm = getattr(jnn, cls)(4, momentum=0.8, data_format=fmt)
    tm = getattr(pnn, cls)(4, momentum=0.8, data_format=fmt)
    assert set(tm.state_dict()) == set(jm.state_dict()) == {
        "weight", "bias", "_mean", "_variance"}
    pt.models.load_jax_state(tm, jax_state(jm))
    for seed in range(2):
        x = _x(*shape, seed=seed) + 1.0
        _close(tm(torch.from_numpy(x)), jm(Tensor(x)))
    _close(tm._mean, jm._mean)
    _close(tm._variance, jm._variance)
    jm.eval()
    tm.eval()
    x = _x(*shape, seed=7)
    _close(tm(torch.from_numpy(x)), jm(Tensor(x)))


def test_legacy_batch_norm_applies_act():
    jm, tm = jnn.BatchNorm(3, act="relu"), pnn.BatchNorm(3, act="relu")
    x = _x(4, 3, 2, 2)
    out = tm(torch.from_numpy(x))
    assert float(out.min()) == 0.0
    _close(out, jm(Tensor(x)))


def test_decorate_o2_keeps_batch_norms_fp32():
    from paddle_tpu_torch.vision.models import resnet18

    model = resnet18(num_classes=10, device="cpu")
    pt.amp.decorate(model, level="O2", dtype="bfloat16")
    for name, mod in model.named_modules():
        tensors = list(mod.parameters(recurse=False)) + list(
            mod.buffers(recurse=False))
        want = (torch.float32 if type(mod).__name__ == "BatchNorm2D"
                else torch.bfloat16)
        assert all(t.dtype == want for t in tensors), name
    model.train()
    out = model(torch.randn(2, 3, 32, 32).bfloat16())
    assert out.dtype == torch.bfloat16
    assert model.bn1._mean.dtype == torch.float32
    assert float(model.bn1._mean.abs().sum()) > 0


# -- weights and optimizer state -----------------------------------------------

def test_load_jax_state_carries_batch_norm_buffers_and_raises_on_names():
    from paddle_tpu.utils import unique_name

    with unique_name.guard():
        paddle.seed(0)
        jm = jnn.Sequential(jnn.Conv2D(2, 4, 3), jnn.BatchNorm2D(4))
    jm.train()
    jm(Tensor(_x(4, 2, 6, 6)))                        # moves the buffers
    state = jax_state(jm)
    assert {"1._mean", "1._variance"} <= set(state)
    tm = pnn.Sequential(pnn.Conv2D(2, 4, 3), pnn.BatchNorm2D(4))
    pt.models.load_jax_state(tm, state)
    for name in ("1._mean", "1._variance", "0.weight"):
        np.testing.assert_array_equal(
            dict(tm.state_dict())[name].numpy(), state[name])
    missing = dict(state)
    del missing["1._variance"]
    with pytest.raises(KeyError, match="1._variance"):
        pt.models.load_jax_state(tm, missing)
    with pytest.raises(KeyError, match="2.weight"):
        pt.models.load_jax_state(tm, {**state, "2.weight": state["0.weight"]})
    with pytest.raises(KeyError):
        pt.models.load_jax_state(pt.vision.LeNet(device="cpu"), state)


def test_momentum_state_of_a_conv_weight_carries_over():
    from paddle_tpu.utils import unique_name
    from paddle_tpu.vision.models import LeNet as JLeNet

    from paddle_tpu_torch.optimizer import Momentum

    with unique_name.guard():
        paddle.seed(1)
        jm = JLeNet()
    tm = pt.vision.LeNet(device="cpu")
    pt.models.load_jax_state(tm, jax_state(jm))
    jopt = paddle.optimizer.Momentum(0.05, 0.9, parameters=jm.parameters(),
                                     weight_decay=1e-4)
    x, y = _x(8, 1, 28, 28), np.arange(8).reshape(8, 1).astype(np.int64)

    def jstep():
        loss = JF.cross_entropy(jm(Tensor(x)), Tensor(y))
        loss.backward()
        jopt.step()
        jopt.clear_grad()

    jstep()
    jstate = {k: (v if isinstance(v, (int, dict)) else np.asarray(v.numpy()))
              for k, v in jopt.state_dict().items()}
    conv_v = f"{jm.features[0].weight.name}_velocity"
    assert jstate[conv_v].ndim == 4
    pt.models.load_jax_state(tm, jax_state(jm))
    topt = Momentum(0.05, 0.9, parameters=tm.parameters(), weight_decay=1e-4)
    pt.models.load_jax_optimizer_state(
        topt, jstate, tm, {n: p.name for n, p in jm.named_parameters()})
    jstep()
    loss = PF.cross_entropy(tm(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    topt.step()
    for name, p in tm.named_parameters():
        want = np.asarray(dict(jm.named_parameters())[name].numpy())
        np.testing.assert_allclose(p.detach().numpy(), want, **TOL,
                                   err_msg=name)
