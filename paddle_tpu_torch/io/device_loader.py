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
batches are only converted to tensors.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from ..framework.place import resolve_device

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
        if self._stream is None:
            return leaf.to(self.device)
        if not leaf.is_pinned():
            leaf = leaf.pin_memory()
        return leaf.to(self.device, non_blocking=True)

    def _map(self, fn, batch):
        if isinstance(batch, (tuple, list)):
            return type(batch)(self._map(fn, b) for b in batch)
        if isinstance(batch, dict):
            return {k: self._map(fn, v) for k, v in batch.items()}
        return fn(batch)

    def _stage(self, batch):
        """``(staged batch, copy-done event)``; copies go on the side
        stream."""
        if self._stream is None:
            return self._map(self._stage_leaf, batch), None
        with torch.cuda.stream(self._stream):
            staged = self._map(self._stage_leaf, batch)
            done = torch.cuda.Event()
            done.record(self._stream)
        return staged, done

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
        for batch in it:
            ahead.append(self._stage(batch))
            if len(ahead) > self.buffer_size:
                yield self._hand_out(*ahead.popleft())
        while ahead:
            yield self._hand_out(*ahead.popleft())
