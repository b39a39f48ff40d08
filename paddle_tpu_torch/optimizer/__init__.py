"""Optimizers of the port (``paddle_tpu.optimizer``): the base with
multi_precision master weights, gradient clipping and regularizers, the
nine concrete optimizers, and the LR schedulers (``lr``)."""
from . import lr  # noqa: F401
from .lr import LRScheduler  # noqa: F401
from .optimizer import Optimizer  # noqa: F401
from .optimizers import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,  # noqa: F401
                         Lamb, Momentum, RMSProp)

__all__ = ["Optimizer", "LRScheduler", "lr", "SGD", "Momentum", "Adam",
           "AdamW", "Adamax", "Adagrad", "Adadelta", "RMSProp", "Lamb"]
