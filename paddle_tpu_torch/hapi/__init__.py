"""paddle.hapi of the port — port of ``paddle_tpu/hapi``: the high-level
``Model`` API (reference ``python/paddle/hapi/``), its callbacks and
``summary``/``flops``."""
from . import callbacks  # noqa: F401
from .callbacks import (  # noqa: F401
    Callback,
    EarlyStopping,
    LRScheduler,
    ModelCheckpoint,
    ProgBarLogger,
    TelemetryLogger,
)
from .model import Model  # noqa: F401
from .model_summary import flops, summary  # noqa: F401

__all__ = ["Model", "callbacks", "summary", "flops"]
