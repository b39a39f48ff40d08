"""The port's transposed convolutions, padding, resampling, rearranging and
sampling-grid functionals and layers (``paddle_tpu_torch/nn/functional/
conv.py``, ``common.py``, ``vision.py``, ``nn/layer/conv.py``,
``common.py``) against the JAX package's on the CPU.

Limits: ``FP32_TOL`` (1e-5) of the largest JAX magnitude for outputs, ten
times that for the gradients of ``sum(out * c)`` (``twin_check``). Where
``ROADMAP.md`` C declares a difference (``align_corners=True``,
``align_mode=1`` and ``"area"`` resampling, ``grid_sample``'s
``"reflection"``, the NHWC ``pixel_shuffle``), the port is held to Paddle's
documented result and the JAX value is shown beside it.
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
from tests.torch_port_util import (FP32_TOL, jax_state, port_cpu,  # noqa: F401
                                   sweep_close, twin_check)

pytestmark = pytest.mark.usefixtures("port_cpu")


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _cl(a):
    """A channels-last port tensor of ``a`` (NCHW / NCDHW)."""
    fmt = torch.channels_last if a.ndim == 4 else torch.channels_last_3d
    return torch.from_numpy(a).contiguous(memory_format=fmt)


# ------------------------------------------------- transposed convs ----

#: (nd, in, out, k, groups, kwargs)
CONV_T = [
    (1, 4, 6, 3, 1, dict(stride=2, padding=1, output_padding=1)),
    (1, 4, 6, 3, 2, dict(stride=2, padding=[1, 0], dilation=2)),
    (2, 4, 6, 3, 1, dict()),
    (2, 4, 6, 4, 1, dict(stride=2, padding=1)),
    (2, 4, 6, 3, 2, dict(stride=[2, 1], padding=[1, 2], dilation=[1, 2])),
    (2, 4, 6, 3, 1, dict(stride=2, padding=[[1, 0], [2, 1]])),
    (2, 4, 6, 3, 1, dict(stride=2, output_size=[10, 11])),
    (2, 4, 6, 3, 1, dict(stride=2, padding=1, data_format="NHWC")),
    (3, 2, 4, 3, 1, dict(stride=2, padding=1, output_padding=1)),
]


@pytest.mark.parametrize("case", CONV_T, ids=[str(i) for i in range(
    len(CONV_T))])
def test_conv_transpose_matches_jax(case):
    nd, cin, cout, k, groups, kw = case
    spatial = (5,) * nd
    nhwc = kw.get("data_format") == "NHWC"
    x = _x(2, *spatial, cin) if nhwc else _x(2, cin, *spatial)
    w = _x(cin, cout // groups, *(k,) * nd, seed=1) * 0.3
    b = _x(cout, seed=2)
    name = f"conv{nd}d_transpose"
    twin_check(lambda a, u, v: getattr(JF, name)(a, u, v, groups=groups,
                                                 **kw),
               lambda a, u, v: getattr(PF, name)(a, u, v, groups=groups,
                                                 **kw),
               [x, w, b], diff=(0, 1, 2))


def test_conv_transpose_refuses_string_padding_as_jax():
    x, w = _x(1, 2, 4, 4), _x(2, 3, 3, 3)
    with pytest.raises(NotImplementedError):
        JF.conv2d_transpose(JT(x), JT(w), padding="SAME")
    with pytest.raises(NotImplementedError):
        PF.conv2d_transpose(pt.to_tensor(x), pt.to_tensor(w), padding="SAME")


@pytest.mark.parametrize("nd", [1, 2, 3])
def test_conv_transpose_layers_match_jax(nd):
    name = f"Conv{nd}DTranspose"
    kw = dict(stride=2, padding=1, output_padding=1, groups=2)
    with unique_name.guard():
        jl = getattr(jnn, name)(4, 6, 3, **kw)
    tl = getattr(pnn, name)(4, 6, 3, **kw)
    assert list(tl.weight.shape) == [4, 3] + [3] * nd
    load_jax_state(tl, jax_state(jl))
    x = _x(2, 4, *(4,) * nd)
    twin_check(lambda a: jl(a), lambda a: tl(a), [x])
    # the JAX _ConvNd's fan rule: std sqrt(2 / ((in + out/groups) k^nd))
    big = getattr(pnn, name)(64, 64, 3, groups=2)
    want = (2.0 / ((64 + 32) * 3 ** nd)) ** 0.5
    assert abs(float(big.weight.std()) / want - 1) < 0.05


# ------------------------------------------------------------ padding ----

PADS = [((2, 3, 4, 5), [1, 2, 0, 1], "constant", "NCHW"),
        ((2, 3, 4, 5), [1, 2, 2, 1], "reflect", "NCHW"),
        ((2, 3, 4, 5), [1, 0, 2, 1], "replicate", "NHWC"),
        ((2, 3, 5), [2, 1], "circular", "NCL"),
        ((1, 2, 3, 4, 5), [1, 0, 0, 1, 2, 1], "constant", "NCDHW"),
        ((3, 4), [1, 1, 0, 2], "constant", "NCHW")]


@pytest.mark.parametrize("case", PADS, ids=[p[2] + str(i) for i, p in
                                            enumerate(PADS)])
def test_pad_matches_jax(case):
    shape, pad, mode, df = case
    kw = dict(mode=mode, value=0.5, data_format=df) if mode == "constant" \
        else dict(mode=mode, data_format=df)
    twin_check(lambda a: JF.pad(a, pad, **kw), lambda a: PF.pad(a, pad, **kw),
               [_x(*shape)])


@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
def test_zeropad2d_and_pad_layers_match_jax(df):
    x = _x(1, 2, 3, 4)
    twin_check(lambda a: JF.zeropad2d(a, [1, 2, 3, 4], df),
               lambda a: PF.zeropad2d(a, [1, 2, 3, 4], df), [x])
    want = torch.nn.functional.pad(torch.from_numpy(x), (1, 2, 3, 4))
    if df == "NCHW":       # the oracle: tests/test_api_audit_round4.py
        np.testing.assert_allclose(
            PF.zeropad2d(pt.to_tensor(x), [1, 2, 3, 4]).numpy(), want)
    for name, shape, pad in (("Pad1D", (2, 3, 5), [1, 2]),
                             ("Pad2D", (2, 3, 4, 5), [1, 0, 2, 1]),
                             ("Pad3D", (1, 2, 3, 4, 5), [1] * 6),
                             ("ZeroPad2D", (2, 3, 4, 5), [1, 2, 0, 1])):
        kw = {} if name == "ZeroPad2D" else dict(mode="replicate")
        jl, tl = getattr(jnn, name)(pad, **kw), getattr(pnn, name)(pad, **kw)
        twin_check(jl, tl, [_x(*shape)])


@pytest.mark.parametrize("mode", ["constant", "reflect", "replicate"])
def test_pads_keep_a_channels_last_input_channels_last(mode):
    x = _cl(_x(2, 8, 5, 6))
    y = PF.pad(x, [1, 2, 0, 1], mode=mode)
    assert y.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(y.numpy(), PF.pad(
        x.contiguous(), [1, 2, 0, 1], mode=mode).numpy())
    assert PF.zeropad2d(x, [1, 2, 0, 1]).is_contiguous(
        memory_format=torch.channels_last)


# --------------------------------------------------------- resampling ----

#: (shape, kwargs) of the modes whose arguments the JAX package honours
RESIZE = [
    ((2, 3, 5, 6), dict(scale_factor=2, mode="nearest")),
    ((2, 3, 5, 7), dict(size=[3, 4], mode="nearest")),
    ((2, 3, 5, 7), dict(size=[7, 3], mode="nearest")),
    ((2, 3, 4, 5), dict(scale_factor=2, mode="bilinear")),
    ((2, 3, 9, 8), dict(size=[4, 3], mode="bilinear")),
    ((2, 3, 9, 8), dict(size=[5, 11], mode="bilinear")),
    ((2, 3, 4, 5), dict(scale_factor=[2, 1.5], mode="bicubic")),
    ((2, 3, 9, 8), dict(size=[4, 5], mode="bicubic")),
    ((2, 3, 7), dict(size=4, mode="linear")),
    ((2, 3, 7), dict(size=12, mode="linear")),
    ((1, 2, 3, 4, 5), dict(size=[5, 2, 7], mode="trilinear")),
    ((1, 2, 3, 4, 5), dict(scale_factor=2, mode="nearest")),
    ((2, 5, 6, 3), dict(size=[3, 9], mode="bilinear", data_format="NHWC")),
]


@pytest.mark.parametrize("case", RESIZE, ids=[
    f"{c[1]['mode']}-{i}" for i, c in enumerate(RESIZE)])
def test_interpolate_matches_jax(case):
    shape, kw = case
    twin_check(lambda a: JF.interpolate(a, **kw),
               lambda a: PF.interpolate(a, **kw), [_x(*shape)])


def test_upsample_layers_match_jax():
    x = _x(2, 3, 5, 6)
    for jl, tl in (
            (jnn.Upsample(scale_factor=2, mode="bilinear"),
             pnn.Upsample(scale_factor=2, mode="bilinear")),
            (jnn.Upsample(size=[3, 4], mode="bicubic"),
             pnn.Upsample(size=[3, 4], mode="bicubic")),
            (jnn.UpsamplingNearest2D(scale_factor=2),
             pnn.UpsamplingNearest2D(scale_factor=2))):
        twin_check(jl, tl, [x])
    twin_check(lambda a: JF.upsample(a, scale_factor=2),
               lambda a: PF.upsample(a, scale_factor=2), [x])


def _paddle_linear_1d(x, out, align_corners, align_mode):
    """Paddle's linear resampling along the last axis (numpy)."""
    m = x.shape[-1]
    y = np.zeros(x.shape[:-1] + (out,), np.float64)
    for i in range(out):
        if align_corners:
            src = i * (m - 1) / (out - 1) if out > 1 else 0.0
        elif align_mode == 1:
            src = i * m / out
        else:
            src = max((i + 0.5) * m / out - 0.5, 0.0)
        lo = min(int(np.floor(src)), m - 1)
        hi = min(lo + 1, m - 1)
        frac = src - lo
        y[..., i] = (1 - frac) * x[..., lo] + frac * x[..., hi]
    return y


@pytest.mark.parametrize("kw", [dict(align_corners=True),
                                dict(align_mode=1)], ids=["corners", "mode1"])
@pytest.mark.parametrize("size", [4, 11])
def test_linear_align_options_give_paddles_result(kw, size):
    """Declared (ROADMAP.md C): the JAX package drops ``align_corners`` and
    ``align_mode``; the port gives Paddle's result."""
    x = _x(2, 3, 7)
    got = PF.interpolate(pt.to_tensor(x), size=size, mode="linear",
                         **kw).numpy()
    want = _paddle_linear_1d(x, size, kw.get("align_corners", False),
                             kw.get("align_mode", 0))
    np.testing.assert_allclose(got, want, atol=1e-6)
    jax = JF.interpolate(JT(x), size=size, mode="linear", **kw).numpy()
    assert np.abs(jax - want).max() > 1e-3        # what JAX gives instead


def test_align_corners_matches_torch_in_2d_and_3d():
    for shape, mode in (((2, 3, 5, 6), "bilinear"), ((2, 3, 5, 6), "bicubic"),
                        ((1, 2, 3, 4, 5), "trilinear")):
        x = _x(*shape)
        size = [2 * s - 1 for s in shape[2:]]
        got = PF.interpolate(pt.to_tensor(x), size=size, mode=mode,
                             align_corners=True).numpy()
        want = torch.nn.functional.interpolate(
            torch.from_numpy(x), size=size, mode=mode, align_corners=True)
        np.testing.assert_allclose(got, want.numpy(), atol=1e-6)
    x = _x(2, 3, 5, 6)
    up = pnn.UpsamplingBilinear2D(scale_factor=2)(pt.to_tensor(x)).numpy()
    want = torch.nn.functional.interpolate(torch.from_numpy(x),
                                           scale_factor=2, mode="bilinear",
                                           align_corners=True)
    np.testing.assert_allclose(up, want.numpy(), atol=1e-6)
    jax = jnn.UpsamplingBilinear2D(scale_factor=2)(JT(x)).numpy()
    assert np.abs(jax - want.numpy()).max() > 1e-2   # JAX: half-pixel


def test_area_is_an_adaptive_average_pool():
    """Declared: Paddle's ``"area"`` is an adaptive average pool; the JAX
    package runs antialiased linear resampling there."""
    x = _x(2, 3, 9, 7)
    got = PF.interpolate(pt.to_tensor(x), size=[4, 3], mode="area").numpy()
    want = torch.nn.functional.adaptive_avg_pool2d(torch.from_numpy(x),
                                                   [4, 3]).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    jax = JF.interpolate(JT(x), size=[4, 3], mode="area").numpy()
    assert np.abs(jax - want).max() > 1e-3


def test_nearest_refuses_align_corners():
    with pytest.raises(ValueError, match="align_corners"):
        PF.interpolate(pt.to_tensor(_x(1, 1, 3, 3)), scale_factor=2,
                       align_corners=True)


def test_resampling_keeps_a_channels_last_input_channels_last():
    x = _cl(_x(2, 8, 5, 6))
    for kw in (dict(scale_factor=2), dict(size=[3, 4], mode="bilinear"),
               dict(scale_factor=2, mode="bicubic")):
        y = PF.interpolate(x, **kw)
        assert y.is_contiguous(memory_format=torch.channels_last), kw
        np.testing.assert_allclose(y.numpy(), PF.interpolate(
            x.contiguous(), **kw).numpy(), atol=1e-6)


# ------------------------------------------------------ rearrangements ----

REARRANGE = [("pixel_shuffle", (2, 8, 3, 4), 2, "NCHW"),
             ("pixel_shuffle", (1, 9, 2, 2), 3, "NCHW"),
             ("pixel_unshuffle", (2, 3, 4, 6), 2, "NCHW"),
             ("pixel_unshuffle", (2, 4, 6, 3), 2, "NHWC"),
             ("channel_shuffle", (2, 6, 3, 4), 2, "NCHW"),
             ("channel_shuffle", (2, 6, 3, 4), 3, "NCHW"),
             ("channel_shuffle", (2, 3, 4, 6), 3, "NHWC")]


@pytest.mark.parametrize("case", REARRANGE, ids=[
    f"{c[0]}-{c[3]}-{i}" for i, c in enumerate(REARRANGE)])
def test_rearrangements_match_jax(case):
    name, shape, r, df = case
    twin_check(lambda a: getattr(JF, name)(a, r, df),
               lambda a: getattr(PF, name)(a, r, df), [_x(*shape)])
    layer = {"pixel_shuffle": "PixelShuffle",
             "pixel_unshuffle": "PixelUnshuffle",
             "channel_shuffle": "ChannelShuffle"}[name]
    twin_check(getattr(jnn, layer)(r, df), getattr(pnn, layer)(r, df),
               [_x(*shape)])


@pytest.mark.parametrize("name,r", [("pixel_shuffle", 2),
                                    ("pixel_unshuffle", 2),
                                    ("channel_shuffle", 2)])
def test_rearrangements_keep_a_channels_last_input_channels_last(name, r):
    x = _x(2, 8, 4, 6)
    y = getattr(PF, name)(_cl(x), r)
    assert y.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(y.numpy(), getattr(PF, name)(
        pt.to_tensor(x), r).numpy())


def test_nhwc_pixel_shuffle_orders_channels_as_paddle():
    """Declared: an NHWC ``pixel_shuffle`` takes channel ``c r^2 + i r + j``
    to pixel ``(i, j)`` of channel ``c``, as NCHW does and as Paddle's
    kernel does; the JAX package's NHWC form orders the channels ``(i, j,
    c)``, so it is not the inverse of its own ``pixel_unshuffle``."""
    x = _x(2, 3, 4, 8)                      # NHWC, 8 = 2 channels x 2^2
    got = PF.pixel_shuffle(pt.to_tensor(x), 2, "NHWC").numpy()
    want = PF.pixel_shuffle(pt.to_tensor(x.transpose(0, 3, 1, 2)), 2,
                            "NCHW").numpy().transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(got, want)
    back = PF.pixel_unshuffle(pt.to_tensor(got), 2, "NHWC").numpy()
    np.testing.assert_array_equal(back, x)
    jax = JF.pixel_shuffle(JT(x), 2, "NHWC").numpy()
    assert not np.array_equal(jax, got)
    assert not np.array_equal(
        JF.pixel_unshuffle(JT(jax), 2, "NHWC").numpy(), x)


UNFOLD = [dict(kernel_sizes=2), dict(kernel_sizes=[2, 3], strides=2,
                                     paddings=1, dilations=[1, 2]),
          dict(kernel_sizes=3, paddings=[1, 0, 2, 1]),
          dict(kernel_sizes=2, paddings=[0, 1])]


@pytest.mark.parametrize("kw", UNFOLD, ids=[str(i) for i in range(
    len(UNFOLD))])
def test_unfold_and_fold_match_jax(kw):
    x = _x(2, 3, 6, 7)
    cols = twin_check(lambda a: JF.unfold(a, **kw),
                      lambda a: PF.unfold(a, **kw), [x])[0]
    fkw = dict(kw, output_sizes=[6, 7])
    twin_check(lambda a: JF.fold(a, **fkw), lambda a: PF.fold(a, **fkw),
               [cols.numpy()])
    twin_check(jnn.Unfold(**kw), pnn.Unfold(**kw), [x])
    twin_check(jnn.Fold(**fkw), pnn.Fold(**fkw), [cols.numpy()])


@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
def test_temporal_shift_matches_jax(df):
    x = _x(4, 8, 2, 2) if df == "NCHW" else _x(4, 2, 2, 8)
    out = twin_check(lambda a: JF.temporal_shift(a, 2, 0.25, data_format=df),
                     lambda a: PF.temporal_shift(a, 2, 0.25, data_format=df),
                     [x])[0].numpy()
    if df == "NCHW":       # the oracle: tests/test_api_audit_round4.py
        xr, o, f = x.reshape(2, 2, 8, 2, 2), out.reshape(2, 2, 8, 2, 2), 2
        np.testing.assert_allclose(o[:, 0, :f], xr[:, 1, :f])
        np.testing.assert_allclose(o[:, 1, :f], 0.0)
        np.testing.assert_allclose(o[:, 1, f:2 * f], xr[:, 0, f:2 * f])
        np.testing.assert_allclose(o[:, 0, f:2 * f], 0.0)
        np.testing.assert_allclose(o[:, :, 2 * f:], xr[:, :, 2 * f:])


# ------------------------------------------------------ sampling grids ----

@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("mode,padding", [("bilinear", "zeros"),
                                          ("bilinear", "border"),
                                          ("nearest", "zeros"),
                                          ("nearest", "border")])
def test_affine_grid_and_grid_sample_match_jax(align, mode, padding):
    theta = (np.eye(2, 3)[None] + 0.3 * _x(2, 2, 3, seed=4)).astype(
        np.float32)
    grid = twin_check(
        lambda t: JF.affine_grid(t, [2, 3, 5, 6], align_corners=align),
        lambda t: PF.affine_grid(t, [2, 3, 5, 6], align_corners=align),
        [theta])[0].numpy()
    only = (0,) if mode == "nearest" else (0, 1)
    twin_check(lambda a, g: JF.grid_sample(a, g, mode, padding, align),
               lambda a, g: PF.grid_sample(a, g, mode, padding, align),
               [_x(2, 3, 4, 5), grid * 1.2], diff=only)


def test_grid_sample_reflection_reflects_as_paddle():
    """Declared: ``"reflection"`` reflects the coordinates (PyTorch's and
    Paddle's rule); the JAX package clamps them as ``"border"`` does."""
    x = _x(1, 2, 4, 5)
    grid = np.random.RandomState(5).uniform(-1.8, 1.8, (1, 3, 4, 2)).astype(
        np.float32)
    got = PF.grid_sample(pt.to_tensor(x), pt.to_tensor(grid),
                         padding_mode="reflection").numpy()
    want = torch.nn.functional.grid_sample(
        torch.from_numpy(x), torch.from_numpy(grid),
        padding_mode="reflection", align_corners=True).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    jax = JF.grid_sample(JT(x), JT(grid), padding_mode="reflection").numpy()
    border = PF.grid_sample(pt.to_tensor(x), pt.to_tensor(grid),
                            padding_mode="border").numpy()
    sweep_close(jax, border, FP32_TOL, "JAX's reflection is border")
    assert np.abs(jax - want).max() > 1e-2


def test_pointwise_product_equals_the_convolution():
    """The 1 x 1 convolutions the card runs as one product on the NHWC view
    (bf16 and fp16 under layout autotune) give the convolution's result,
    channels-last; on the CPU the route is never taken."""
    from paddle_tpu_torch.nn.functional import conv as pconv

    x = _cl(_x(2, 58, 5, 6))
    w = torch.from_numpy(_x(116, 58, 1, 1, seed=1))
    y = pconv._pointwise(x, w)
    assert y.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(y.numpy(), torch.nn.functional.conv2d(
        x, w).numpy(), rtol=1e-5, atol=1e-5)
    assert not pconv._pointwise_on_gemm(x, w, (1, 1), [(0, 0)] * 2, 1,
                                        False, 2)
