"""``paddle_tpu_torch.incubate``: the autotune switches
(``paddle_tpu/incubate/autotune.py``)."""
from . import autotune  # noqa: F401
