"""Automatic mixed precision — port of ``paddle_tpu.amp``: ``auto_cast``
(O1/O2 by the JAX package's op lists), ``decorate`` and the loss scaler."""
from .auto_cast import (amp_guard, auto_cast, black_list, decorate,  # noqa: F401
                        white_list)
from .grad_scaler import AmpScaler, GradScaler  # noqa: F401
