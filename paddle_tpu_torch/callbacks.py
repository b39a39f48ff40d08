# Copied unchanged from paddle_tpu/callbacks.py (the port imports nothing of the
# JAX package).
"""paddle.callbacks — re-export of the hapi callback family
(reference ``python/paddle/callbacks.py``)."""
from .hapi.callbacks import (  # noqa: F401
    Callback,
    EarlyStopping,
    LRScheduler,
    ModelCheckpoint,
    ProgBarLogger,
    ReduceLROnPlateau,
    TelemetryLogger,
    VisualDL,
)
