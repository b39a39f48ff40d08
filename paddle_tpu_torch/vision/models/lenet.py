"""LeNet — port of ``paddle_tpu/vision/models/lenet.py``: two conv + relu +
max-pool stages and three Linears, for 1 x 28 x 28 images. Built on the CPU
from ``generator``, then placed by ``Layer`` on ``device`` (None: the
current place)."""
from __future__ import annotations

import torch

from ...nn.layer.activation import ReLU
from ...nn.layer.common import Linear
from ...nn.layer.container import Sequential
from ...nn.layer.conv import Conv2D
from ...nn.layer.layers import Layer
from ...nn.layer.pooling import MaxPool2D

__all__ = ["LeNet"]


class LeNet(Layer):
    def __init__(self, num_classes=10, *, device=None, generator=None):
        super().__init__()
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1, generator=generator),
            ReLU(),
            MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0, generator=generator),
            ReLU(),
            MaxPool2D(2, 2))
        if num_classes > 0:
            self.fc = Sequential(
                Linear(400, 120, generator=generator),
                Linear(120, 84, generator=generator),
                Linear(84, num_classes, generator=generator))

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x
