"""The MobileNet family — port of ``paddle_tpu/vision/models/mobilenet.py``:
``MobileNetV1``, ``MobileNetV2``, ``MobileNetV3Small``, ``MobileNetV3Large``
and their factories.

Depthwise-separable convolutions (``groups`` = channels) with batch norms
and ReLU (V1), ReLU6 (V2's ``ConvBNReLU``) or Hardswish (V3), V2's inverted
residuals, V3's squeeze-excite blocks (ReLU, then Hardsigmoid) and the
classifiers' ``Dropout(0.2)``. The module tree and its names are the JAX
model's (``features.1.block.2.fc1``, ``classifier.3``), so
``models.load_jax_state`` carries a JAX MobileNet's weights and batch-norm
buffers over. Models are built on the CPU from ``generator`` (``None``:
PyTorch's default one) and placed by ``Layer`` on ``device`` (None: the
current place; ``"cpu"`` to stay on the host). The factories refuse
``pretrained=True``: the weights need a download (the JAX package ignores
it, ``ROADMAP.md`` C).
"""
from __future__ import annotations

import torch

from ...nn.layer.activation import Hardsigmoid, Hardswish, ReLU, ReLU6
from ...nn.layer.common import Dropout, Linear
from ...nn.layer.container import Sequential
from ...nn.layer.conv import Conv2D
from ...nn.layer.layers import Layer
from ...nn.layer.norm import BatchNorm2D
from ...nn.layer.pooling import AdaptiveAvgPool2D

__all__ = [
    "MobileNetV1", "MobileNetV2", "MobileNetV3Small", "MobileNetV3Large",
    "mobilenet_v1", "mobilenet_v2", "mobilenet_v3_small",
    "mobilenet_v3_large",
]


def _make_divisible(v, divisor=8, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNReLU(Sequential):
    def __init__(self, in_c, out_c, kernel=3, stride=1, groups=1, act=ReLU6,
                 *, generator=None):
        pad = (kernel - 1) // 2
        super().__init__(
            Conv2D(in_c, out_c, kernel, stride=stride, padding=pad,
                   groups=groups, bias_attr=False, generator=generator),
            BatchNorm2D(out_c),
            act())


class MobileNetV1(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None, generator=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        gen = generator

        def dw_sep(in_c, out_c, stride):
            return Sequential(
                ConvBNReLU(in_c, in_c, 3, stride, groups=in_c, act=ReLU,
                           generator=gen),
                ConvBNReLU(in_c, out_c, 1, 1, act=ReLU, generator=gen))

        def s(c):
            return int(c * scale)

        self.features = Sequential(
            ConvBNReLU(3, s(32), 3, 2, act=ReLU, generator=gen),
            dw_sep(s(32), s(64), 1),
            dw_sep(s(64), s(128), 2),
            dw_sep(s(128), s(128), 1),
            dw_sep(s(128), s(256), 2),
            dw_sep(s(256), s(256), 1),
            dw_sep(s(256), s(512), 2),
            *[dw_sep(s(512), s(512), 1) for _ in range(5)],
            dw_sep(s(512), s(1024), 2),
            dw_sep(s(1024), s(1024), 1))
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = Linear(s(1024), num_classes, generator=gen)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


class InvertedResidual(Layer):
    def __init__(self, inp, oup, stride, expand_ratio, *, generator=None):
        super().__init__()
        self.stride = stride
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU(inp, hidden, 1, generator=generator))
        layers += [
            ConvBNReLU(hidden, hidden, 3, stride, groups=hidden,
                       generator=generator),
            Conv2D(hidden, oup, 1, bias_attr=False, generator=generator),
            BatchNorm2D(oup)]
        self.conv = Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None, generator=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        gen = generator
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        input_channel = _make_divisible(32 * scale)
        layers = [ConvBNReLU(3, input_channel, 3, 2, generator=gen)]
        for t, c, n, s in cfg:
            out_c = _make_divisible(c * scale)
            for i in range(n):
                layers.append(InvertedResidual(
                    input_channel, out_c, s if i == 0 else 1, t,
                    generator=gen))
                input_channel = out_c
        self.last_channel = _make_divisible(1280 * max(1.0, scale))
        layers.append(ConvBNReLU(input_channel, self.last_channel, 1,
                                 generator=gen))
        self.features = Sequential(*layers)
        if with_pool:
            self.pool2d_avg = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = Sequential(
                Dropout(0.2),
                Linear(self.last_channel, num_classes, generator=gen))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


class SqueezeExcite(Layer):
    def __init__(self, c, r=4, *, generator=None):
        super().__init__()
        mid = _make_divisible(c // r)
        self.pool = AdaptiveAvgPool2D(1)
        self.fc1 = Conv2D(c, mid, 1, generator=generator)
        self.fc2 = Conv2D(mid, c, 1, generator=generator)
        self.relu = ReLU()
        self.hsig = Hardsigmoid()

    def forward(self, x):
        s = self.hsig(self.fc2(self.relu(self.fc1(self.pool(x)))))
        return x * s


class _MBV3Block(Layer):
    def __init__(self, in_c, exp, out_c, kernel, stride, se, act, *,
                 generator=None):
        super().__init__()
        gen = generator
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if exp != in_c:
            layers.append(ConvBNReLU(in_c, exp, 1, act=act, generator=gen))
        layers.append(ConvBNReLU(exp, exp, kernel, stride, groups=exp,
                                 act=act, generator=gen))
        if se:
            layers.append(SqueezeExcite(exp, generator=gen))
        layers += [Conv2D(exp, out_c, 1, bias_attr=False, generator=gen),
                   BatchNorm2D(out_c)]
        self.block = Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


_V3_SMALL = [
    # k, exp, out, se, act, stride
    (3, 16, 16, True, ReLU, 2),
    (3, 72, 24, False, ReLU, 2),
    (3, 88, 24, False, ReLU, 1),
    (5, 96, 40, True, Hardswish, 2),
    (5, 240, 40, True, Hardswish, 1),
    (5, 240, 40, True, Hardswish, 1),
    (5, 120, 48, True, Hardswish, 1),
    (5, 144, 48, True, Hardswish, 1),
    (5, 288, 96, True, Hardswish, 2),
    (5, 576, 96, True, Hardswish, 1),
    (5, 576, 96, True, Hardswish, 1),
]

_V3_LARGE = [
    (3, 16, 16, False, ReLU, 1),
    (3, 64, 24, False, ReLU, 2),
    (3, 72, 24, False, ReLU, 1),
    (5, 72, 40, True, ReLU, 2),
    (5, 120, 40, True, ReLU, 1),
    (5, 120, 40, True, ReLU, 1),
    (3, 240, 80, False, Hardswish, 2),
    (3, 200, 80, False, Hardswish, 1),
    (3, 184, 80, False, Hardswish, 1),
    (3, 184, 80, False, Hardswish, 1),
    (3, 480, 112, True, Hardswish, 1),
    (3, 672, 112, True, Hardswish, 1),
    (5, 672, 160, True, Hardswish, 2),
    (5, 960, 160, True, Hardswish, 1),
    (5, 960, 160, True, Hardswish, 1),
]


class _MobileNetV3(Layer):
    def __init__(self, cfg, last_exp, scale=1.0, num_classes=1000,
                 with_pool=True, *, device=None, generator=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        gen = generator
        in_c = _make_divisible(16 * scale)
        layers = [ConvBNReLU(3, in_c, 3, 2, act=Hardswish, generator=gen)]
        for k, exp, out_c, se, act, s in cfg:
            exp_c = _make_divisible(exp * scale)
            o = _make_divisible(out_c * scale)
            layers.append(_MBV3Block(in_c, exp_c, o, k, s, se, act,
                                     generator=gen))
            in_c = o
        last_c = _make_divisible(last_exp * scale)
        layers.append(ConvBNReLU(in_c, last_c, 1, act=Hardswish,
                                 generator=gen))
        self.features = Sequential(*layers)
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = Sequential(
                Linear(last_c, 1280, generator=gen),
                Hardswish(),
                Dropout(0.2),
                Linear(1280, num_classes, generator=gen))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


class MobileNetV3Small(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None, generator=None):
        super().__init__(_V3_SMALL, 576, scale, num_classes, with_pool,
                         device=device, generator=generator)


class MobileNetV3Large(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None, generator=None):
        super().__init__(_V3_LARGE, 960, scale, num_classes, with_pool,
                         device=device, generator=generator)


def _refuse_pretrained(pretrained):
    if pretrained:
        raise ValueError("pretrained=True needs the weights' download; the "
                         "port builds random weights only")


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    _refuse_pretrained(pretrained)
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    _refuse_pretrained(pretrained)
    return MobileNetV2(scale=scale, **kwargs)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    _refuse_pretrained(pretrained)
    return MobileNetV3Small(scale=scale, **kwargs)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    _refuse_pretrained(pretrained)
    return MobileNetV3Large(scale=scale, **kwargs)
