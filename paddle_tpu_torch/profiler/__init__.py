"""paddle.profiler (reference ``python/paddle/profiler/__init__.py``):
the port's ``profiler.py`` (on ``torch.profiler``) and ``devprof.py``, and
copies of the JAX package's jax-free ``tracing.py``, ``telemetry.py``,
``export.py`` and ``slo.py``."""
from . import devprof  # noqa: F401
from . import export  # noqa: F401
from . import slo  # noqa: F401
from . import telemetry  # noqa: F401
from . import tracing  # noqa: F401
from .profiler import (  # noqa: F401
    Profiler,
    ProfilerState,
    ProfilerTarget,
    RecordEvent,
    SortedKeys,
    export_chrome_tracing,
    export_protobuf,
    get_profiler,
    in_profiler_mode,
    load_profiler_result,
    make_scheduler,
    wrap_optimizers,
)

__all__ = [
    "ProfilerState", "ProfilerTarget", "make_scheduler",
    "export_chrome_tracing", "export_protobuf", "Profiler", "RecordEvent",
    "load_profiler_result", "SortedKeys", "telemetry", "devprof",
    "tracing", "export", "slo",
]
