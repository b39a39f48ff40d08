"""Vision models of the port: LeNet, the MobileNets, the ResNet family and
ShuffleNetV2."""
from .lenet import LeNet  # noqa: F401
from .mobilenet import (  # noqa: F401
    MobileNetV1,
    MobileNetV2,
    MobileNetV3Large,
    MobileNetV3Small,
    mobilenet_v1,
    mobilenet_v2,
    mobilenet_v3_large,
    mobilenet_v3_small,
)
from .resnet import (  # noqa: F401
    BasicBlock,
    BottleneckBlock,
    ResNet,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
    resnext50_32x4d,
    resnext50_64x4d,
    resnext101_32x4d,
    resnext101_64x4d,
    resnext152_32x4d,
    resnext152_64x4d,
    wide_resnet50_2,
    wide_resnet101_2,
)
from .shufflenetv2 import (  # noqa: F401
    ShuffleNetV2,
    shufflenet_v2_swish,
    shufflenet_v2_x0_25,
    shufflenet_v2_x0_33,
    shufflenet_v2_x0_5,
    shufflenet_v2_x1_0,
    shufflenet_v2_x1_5,
    shufflenet_v2_x2_0,
)
