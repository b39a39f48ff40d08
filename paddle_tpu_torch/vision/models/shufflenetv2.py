"""ShuffleNetV2 — port of ``paddle_tpu/vision/models/shufflenetv2.py``
(Ma et al. 2018): ``ShuffleNetV2`` and its factories ``x0_25`` to
``x2_0`` and ``swish``.

A stem (a 3 x 3 stride-2 conv, batch norm, activation and a 3 x 3 max
pool), three stages of 4, 8 and 4 blocks and a 1 x 1 conv to the last
width. A stride-1 block splits the channels in two, runs one half through
a 1 x 1 conv, a 3 x 3 depthwise conv and a 1 x 1 conv (each with a batch
norm, the 1 x 1 ones with the activation) and joins it to the other half;
a stride-2 block runs the whole input through two such branches (one with
a depthwise conv first). Each block ends in ``F.channel_shuffle(x, 2)``,
which keeps a channels-last input channels-last. The module tree and its
names are the JAX model's (``blocks.3.b2.4``), so ``models.load_jax_state``
carries a JAX ShuffleNetV2's weights and batch-norm buffers over. Models
are built on the CPU from ``generator`` (``None``: PyTorch's default one)
and placed by ``Layer`` on ``device`` (None: the current place). The
factories refuse ``pretrained=True``: the weights need a download (the JAX
package ignores it, ``ROADMAP.md`` C).
"""
from __future__ import annotations

import torch

from ...nn import functional as F
from ...nn.layer.activation import ReLU, Swish
from ...nn.layer.common import Linear
from ...nn.layer.container import Sequential
from ...nn.layer.conv import Conv2D
from ...nn.layer.layers import Layer
from ...nn.layer.norm import BatchNorm2D
from ...nn.layer.pooling import AdaptiveAvgPool2D, MaxPool2D
from .mobilenet import _refuse_pretrained

__all__ = [
    "ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
    "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
    "shufflenet_v2_x2_0", "shufflenet_v2_swish",
]

#: the stem, three stages' and last conv's widths of each scale
_WIDTHS = {0.25: [24, 24, 48, 96, 512], 0.33: [24, 32, 64, 128, 512],
           0.5: [24, 48, 96, 192, 1024], 1.0: [24, 116, 232, 464, 1024],
           1.5: [24, 176, 352, 704, 1024], 2.0: [24, 244, 488, 976, 2048]}
_REPEATS = (4, 8, 4)


def _act(name):
    return Swish() if name == "swish" else ReLU()


def _conv(c_in, c_out, k, gen, stride=1, groups=1):
    return Conv2D(c_in, c_out, k, stride=stride, padding=k // 2,
                  groups=groups, bias_attr=False, generator=gen)


class InvertedResidual(Layer):
    def __init__(self, c_in, c_out, stride, act="relu", *, generator=None):
        super().__init__()
        self.stride = stride
        branch, gen = c_out // 2, generator
        if stride == 1:
            self.b2 = Sequential(
                _conv(branch, branch, 1, gen), BatchNorm2D(branch), _act(act),
                _conv(branch, branch, 3, gen, groups=branch),
                BatchNorm2D(branch),
                _conv(branch, branch, 1, gen), BatchNorm2D(branch), _act(act))
        else:
            self.b1 = Sequential(
                _conv(c_in, c_in, 3, gen, stride, groups=c_in),
                BatchNorm2D(c_in),
                _conv(c_in, branch, 1, gen), BatchNorm2D(branch), _act(act))
            self.b2 = Sequential(
                _conv(c_in, branch, 1, gen), BatchNorm2D(branch), _act(act),
                _conv(branch, branch, 3, gen, stride, groups=branch),
                BatchNorm2D(branch),
                _conv(branch, branch, 1, gen), BatchNorm2D(branch), _act(act))

    def forward(self, x):
        if self.stride == 1:
            # chunk, not two slices: its backward joins the two gradients
            # in their layout, where a slice's scatters into fresh NCHW
            # zeros
            x1, x2 = x.chunk(2, 1)
            out = torch.cat([x1, self.b2(x2)], 1)
        else:
            out = torch.cat([self.b1(x), self.b2(x)], 1)
        return F.channel_shuffle(out, 2)


class ShuffleNetV2(Layer):
    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True, *, device=None, generator=None):
        super().__init__()
        ch, gen = _WIDTHS[scale], generator
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.conv1 = Sequential(_conv(3, ch[0], 3, gen, 2),
                                BatchNorm2D(ch[0]), _act(act))
        self.maxpool = MaxPool2D(3, stride=2, padding=1)
        blocks, c_in = [], ch[0]
        for stage, reps in enumerate(_REPEATS):
            for i in range(reps):
                blocks.append(InvertedResidual(
                    c_in, ch[stage + 1], 2 if i == 0 else 1, act,
                    generator=gen))
                c_in = ch[stage + 1]
        self.blocks = Sequential(*blocks)
        self.conv_last = Sequential(_conv(c_in, ch[-1], 1, gen),
                                    BatchNorm2D(ch[-1]), _act(act))
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = Linear(ch[-1], num_classes, generator=gen)

    def forward(self, x):
        x = self.conv_last(self.blocks(self.maxpool(self.conv1(x))))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


def _build(pretrained, scale, act="relu", **kwargs):
    _refuse_pretrained(pretrained)
    return ShuffleNetV2(scale=scale, act=act, **kwargs)


def shufflenet_v2_x0_25(pretrained=False, **kwargs):
    return _build(pretrained, 0.25, **kwargs)


def shufflenet_v2_x0_33(pretrained=False, **kwargs):
    return _build(pretrained, 0.33, **kwargs)


def shufflenet_v2_x0_5(pretrained=False, **kwargs):
    return _build(pretrained, 0.5, **kwargs)


def shufflenet_v2_x1_0(pretrained=False, **kwargs):
    return _build(pretrained, 1.0, **kwargs)


def shufflenet_v2_x1_5(pretrained=False, **kwargs):
    return _build(pretrained, 1.5, **kwargs)


def shufflenet_v2_x2_0(pretrained=False, **kwargs):
    return _build(pretrained, 2.0, **kwargs)


def shufflenet_v2_swish(pretrained=False, **kwargs):
    return _build(pretrained, 1.0, "swish", **kwargs)
