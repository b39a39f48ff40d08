"""``paddle_tpu_torch.vision`` — port of ``paddle_tpu/vision`` (its models
so far: ``LeNet`` and the ResNet family)."""
from . import models  # noqa: F401
from .models import LeNet, ResNet  # noqa: F401
