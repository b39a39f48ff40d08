"""Optimizers of the port (``paddle_tpu.optimizer``: the base, Adam and
AdamW with multi_precision master weights)."""
from .optimizer import Optimizer  # noqa: F401
from .optimizers import Adam, AdamW  # noqa: F401

__all__ = ["Optimizer", "Adam", "AdamW"]
