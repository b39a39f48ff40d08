"""Request tracing, telemetry and SLOs (copies of the JAX package's jax-free
``profiler/tracing.py``, ``telemetry.py``, ``export.py`` and ``slo.py``)."""
