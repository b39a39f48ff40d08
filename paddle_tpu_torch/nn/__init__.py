"""``paddle_tpu_torch.nn``: functionals, layers and gradient clipping."""
from . import functional  # noqa: F401
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue  # noqa: F401
from .layer import LayerNorm  # noqa: F401
