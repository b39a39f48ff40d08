"""Utilities (``utils/log_writer.py`` is a copy of the JAX package's;
``warn_once`` and ``_WARNED_ONCE`` are copied from
``paddle_tpu/utils/__init__.py``, which imports jax)."""

_WARNED_ONCE = set()


def warn_once(key, msg, stacklevel=3):
    """Emit ``msg`` as a UserWarning at most once per process for ``key``
    (shared one-shot-warning helper for accepted-but-inert knobs and
    degraded fallbacks)."""
    if key not in _WARNED_ONCE:
        _WARNED_ONCE.add(key)
        import warnings

        warnings.warn(msg, stacklevel=stacklevel)
