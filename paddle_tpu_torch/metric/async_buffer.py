"""Non-blocking metric accumulation (``AsyncMetricBuffer``) — port of
``paddle_tpu/metric/async_buffer.py``.

``float(loss)`` after every step fences the card: the host waits for the
step's whole chain of kernels, and the launch queue runs dry. This buffer
holds the *device* scalars and defers the read back to explicit
:meth:`drain` calls — the train loops fence only at ``log_freq`` boundaries
and epoch ends, keeping the launch queue full between fences. A drain
moves every pending scalar to the host in ONE transfer (``torch.stack``,
then one copy), not one synchronising read a scalar.
"""
from __future__ import annotations

import time

import torch

from ..framework.tensor import unwrap
from ..profiler import telemetry as _telemetry

__all__ = ["AsyncMetricBuffer"]


def _read(pending):
    """The floats of ``pending`` (0-d tensors, numbers) in order: the
    tensors of one device in one stacked copy."""
    tensors = [unwrap(v).detach() for v in pending
               if isinstance(v, torch.Tensor)]
    if len(tensors) == len(pending) and len({t.device for t in tensors}) == 1:
        dt = tensors[0].dtype
        if any(t.dtype != dt for t in tensors):
            tensors = [t.float() for t in tensors]
        return [float(v) for v in
                torch.stack([t.reshape(()) for t in tensors]).cpu().tolist()]
    return [float(unwrap(v).detach().cpu()) if isinstance(v, torch.Tensor)
            else float(v) for v in pending]


class AsyncMetricBuffer:
    """Accumulates device scalars; fences only on :meth:`drain`.

    ``append`` is non-blocking (it keeps the tensor). ``drain`` reads back
    everything pending in one transfer, appends the floats to
    :attr:`values` in arrival order, and returns just the newly drained
    floats.
    """

    def __init__(self):
        self._pending = []
        self.values = []  # all drained floats, in append order

    def append(self, value):
        if value is not None:
            self._pending.append(value)

    def __len__(self):
        return len(self.values) + len(self._pending)

    @property
    def num_pending(self):
        return len(self._pending)

    def drain(self):
        """Fence: read back every pending scalar. Returns the new floats."""
        pending, self._pending = self._pending, []
        if not pending:
            return []
        if _telemetry.enabled():
            t0 = time.perf_counter_ns()
            new = _read(pending)
            t1 = time.perf_counter_ns()
            tm = _telemetry.get_telemetry()
            tm.add_phase("readback", t0, t1)
            tm.inc("metric.fences")
            tm.inc("metric.scalars_read", len(new))
        else:
            new = _read(pending)
        self.values.extend(new)
        return new

    def last(self):
        """Most recently *drained* value (no fence); None before any."""
        return self.values[-1] if self.values else None

    def result(self):
        """Drain anything pending and return the full history."""
        self.drain()
        return list(self.values)
