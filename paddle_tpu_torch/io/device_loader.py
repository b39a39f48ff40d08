"""Host→device staging of training batches (``DeviceLoader``) — port of
``paddle_tpu/io/device_loader.py``.

``DeviceLoader`` wraps any iterable of host batches (numpy arrays or CPU
tensors, nested in tuples, lists or dicts) and keeps the next
``buffer_size`` batches staged on the card: each array is copied into
pinned host memory and sent to the device by a non-blocking copy issued on
a side stream, so the transfer of batch ``i + buffer_size`` overlaps the
compute of batch ``i``. A batch is handed out only after the consumer's
stream has been made to wait for its copy, and its tensors are recorded on
that stream so the caching allocator does not reuse their memory early.

The JAX package stages from a background thread because ``device_put`` may
block; here the copies are asynchronous already, so the staging runs on the
consumer's thread with no thread to manage. On the CPU (``device="cpu"``)
batches are only converted to tensors. A tensor already on ``device`` is
handed out as it is, and a Paddle Tensor stays one.

As in the JAX package, each batch's staging passes the ``"stage"``
fault-injection point and is retried with backoff on an ``OSError`` (a
``TransientError``); anything else raises at once. With telemetry on, the
staging time is the ``h2d_copy`` phase (the host's share: pinning and
issuing the copies) and the consumer's time inside the iterator is
``data_wait``; the ``device_loader.*`` counters count batches and bytes
staged and prefetch hits (the batch's copy had finished when it was handed
out) and misses, and ``device_loader.queue_depth`` is the number of batches
staged ahead.
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch

from ..framework.place import resolve_device
from ..framework.tensor import Tensor, unwrap, wrap
from ..profiler import telemetry as _telemetry

__all__ = ["DeviceLoader"]


class DeviceLoader:
    """Prefetch ``buffer_size`` (at least 2) batches of ``data`` onto
    ``device`` (``None``: the card; ``"cpu"`` to stay on the host).

    Batch structure is preserved: numpy arrays and tensors are staged, other
    leaves pass through. Each ``iter()`` is one pass over ``data``.
    """

    def __init__(self, data, buffer_size=2, device=None):
        self.data = data
        self.buffer_size = max(2, int(buffer_size))
        self.device = resolve_device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    def __len__(self):
        return len(self.data)

    def _stage_leaf(self, leaf):
        if isinstance(leaf, (np.ndarray, np.generic)):
            leaf = torch.from_numpy(np.ascontiguousarray(leaf))
        if not isinstance(leaf, torch.Tensor):
            return leaf
        paddle = isinstance(leaf, Tensor)
        leaf = unwrap(leaf)
        if leaf.device == self.device:
            out = leaf
        elif self._stream is None:
            out = leaf.to(self.device)
        else:
            if not leaf.is_pinned():
                leaf = leaf.pin_memory()
            out = leaf.to(self.device, non_blocking=True)
        return wrap(out) if paddle else out

    def _map(self, fn, batch):
        if isinstance(batch, (tuple, list)):
            return type(batch)(self._map(fn, b) for b in batch)
        if isinstance(batch, dict):
            return {k: self._map(fn, v) for k, v in batch.items()}
        return fn(batch)

    def _stage_once(self, batch):
        """``(staged batch, copy-done event)``; copies go on the side
        stream."""
        from ..fault import inject

        inject.check("stage")  # transient-stage-error injection point
        if self._stream is None:
            return self._map(self._stage_leaf, batch), None
        with torch.cuda.stream(self._stream):
            staged = self._map(self._stage_leaf, batch)
            done = torch.cuda.Event()
            done.record(self._stream)
        return staged, done

    def _stage(self, batch):
        from ..fault.retry import retry

        if not _telemetry.enabled():
            # a transient staging failure (an injected TransientError)
            # retries with jittered backoff; anything that is not an
            # OSError raises on the first try
            return retry(self._stage_once, batch, tries=3, base_delay=0.02,
                         retry_on=(OSError,))
        t0 = time.perf_counter_ns()
        out = retry(self._stage_once, batch, tries=3, base_delay=0.02,
                    retry_on=(OSError,))
        t1 = time.perf_counter_ns()
        nbytes = []
        self._map(lambda leaf: nbytes.append(_leaf_bytes(leaf)), batch)
        tm = _telemetry.get_telemetry()
        tm.add_phase("h2d_copy", t0, t1)
        tm.inc("device_loader.batches_staged")
        tm.inc("device_loader.bytes_staged", sum(nbytes))
        return out

    def _hand_out(self, staged, done):
        if done is None:
            return staged
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(done)

        def record(leaf):
            if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                leaf.record_stream(consumer)
            return leaf

        return self._map(record, staged)

    def __iter__(self):
        it = iter(self.data)
        ahead = collections.deque()
        tm_on = _telemetry.enabled()
        t0 = time.perf_counter_ns() if tm_on else 0
        for batch in it:
            ahead.append(self._stage(batch))
            if len(ahead) > self.buffer_size:
                if tm_on:
                    self._note_wait(t0, ahead)
                yield self._hand_out(*ahead.popleft())
                t0 = time.perf_counter_ns() if tm_on else 0
        while ahead:
            if tm_on:
                self._note_wait(t0, ahead)
            yield self._hand_out(*ahead.popleft())
            t0 = time.perf_counter_ns() if tm_on else 0
        self._clear_gauges()

    def _note_wait(self, t0, ahead):
        """Telemetry of one hand-out: the consumer's time in the iterator
        since the last one (``data_wait``), and a prefetch hit when the
        batch's copy has finished (an event query: no wait)."""
        t1 = time.perf_counter_ns()
        tm = _telemetry.get_telemetry()
        tm.add_phase("data_wait", t0, t1)
        done = ahead[0][1]
        hit = done is None or done.query()
        tm.inc("device_loader.prefetch_hit" if hit
               else "device_loader.prefetch_miss")
        if not hit:
            tm.inc("device_loader.stall_s", (t1 - t0) / 1e9)
        tm.set_gauge("device_loader.queue_depth", len(ahead) - 1)

    def _clear_gauges(self):
        """Retire this loader's point-in-time gauges at the end of a pass;
        the cumulative counters stay."""
        _telemetry.get_telemetry().clear_gauges("device_loader.")

    def shutdown(self):
        """Retire the loader's gauges; safe to call any number of times.
        The JAX package also stops its stager threads here, but the port
        stages on the consumer's thread (the copies themselves are
        asynchronous), so there is no thread to stop and nothing staged
        outlives its iterator."""
        self._clear_gauges()


def _leaf_bytes(leaf):
    try:
        return int(getattr(leaf, "nbytes", 0) or 0)
    except Exception:
        return 0
