"""DataLoader — port of ``paddle_tpu/io/dataloader.py`` (reference
``python/paddle/fluid/reader.py:275 DataLoader``, multiprocess workers
``fluid/dataloader/dataloader_iter.py:342``).

The same three modes as the JAX package, with its constructor:

 - ``num_workers=0``: batches are fetched and collated in the consumer;
 - ``num_workers>0``: a thread pool with a bounded prefetch queue;
 - ``num_workers>0, use_process=True``: worker processes
   (``io/worker.py``, forkserver by default) with shared-memory batch
   transport, a restart budget for killed workers, epoch tags and
   ``persistent_workers``.

Workers (threads or processes) collate into numpy only
(:func:`~.collate.collate_numpy`) and never touch CUDA. The consumer turns
the arrays into Tensors on ``places``: ``None`` is the current place
(``gpu:0`` unless ``set_device("cpu")``; without a card the constructor
raises, as ``to_tensor`` does), ``"cpu"`` the host. On a card the arrays
are staged by :class:`~.device_loader.DeviceLoader` (pinned memory, copies
on a side stream, two batches ahead). A ``collate_fn`` of the caller's runs
in the workers and its batches are handed out as it returns them.
"""
from __future__ import annotations

import itertools
import queue
import threading

import numpy as np

import torch

from ..framework.place import resolve_device
from ..framework.tensor import wrap
from .collate import collate_numpy, to_place
from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "get_worker_info"]

_worker_info = threading.local()


def _wrap_tree(batch):
    if isinstance(batch, torch.Tensor):
        return wrap(batch)
    if isinstance(batch, (list, tuple)):
        return type(batch)(_wrap_tree(b) for b in batch)
    if isinstance(batch, dict):
        return {k: _wrap_tree(v) for k, v in batch.items()}
    return batch


class _WorkerError:
    """Exception captured in a worker thread, re-raised by the consumer."""

    def __init__(self, exc):
        self.exc = exc


class WorkerInfo:
    def __init__(self, id, num_workers, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


def get_worker_info():
    return getattr(_worker_info, "info", None)


class DataLoader:
    def __init__(
        self,
        dataset,
        feed_list=None,
        places=None,
        return_list=True,
        batch_sampler=None,
        batch_size=1,
        shuffle=False,
        drop_last=False,
        collate_fn=None,
        num_workers=0,
        use_buffer_reader=True,
        prefetch_factor=2,
        use_shared_memory=True,
        timeout=0,
        worker_init_fn=None,
        persistent_workers=False,
        use_process=False,
        worker_restart_limit=2,
    ):
        self._pool = None
        self.dataset = dataset
        self.return_list = return_list
        if isinstance(places, (list, tuple)):
            places = places[0] if places else None
        #: where batches are handed out (a ``torch.device``)
        self.place = resolve_device(places)
        # the default collation runs in the workers as numpy; the consumer
        # places the arrays (``_place``)
        self._placed = collate_fn is None
        self.collate_fn = collate_fn or collate_numpy
        self.num_workers = num_workers
        self.prefetch_factor = max(2, prefetch_factor)
        self.worker_init_fn = worker_init_fn
        self.use_process = bool(use_process)
        # process-mode fault tolerance: a worker killed by SIGKILL/segfault
        # is respawned (with backoff) and its in-flight batches re-dispatched
        # up to this many times per pool before WorkerFailure surfaces;
        # worker EXCEPTIONS (user-code bugs) always propagate immediately
        self.worker_restart_limit = max(0, int(worker_restart_limit or 0))
        self.use_shared_memory = bool(use_shared_memory)
        self.persistent_workers = bool(persistent_workers)
        self.timeout = timeout
        self._pool = None
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size, drop_last=drop_last
            )

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    # -- iteration ----------------------------------------------------------
    def _fetch(self, indices):
        samples = [self.dataset[i] for i in indices]
        return self.collate_fn(samples)

    def _iter_single(self):
        if self._iterable_mode:
            it = iter(self.dataset)
            while True:
                batch = list(itertools.islice(it, self.batch_size))
                if not batch or (len(batch) < self.batch_size and self.drop_last):
                    return
                yield self.collate_fn(batch)
        else:
            for indices in self.batch_sampler:
                yield self._fetch(indices)

    def _iter_threaded(self):
        """Bounded-queue prefetch with a worker thread pool."""
        if self._iterable_mode:
            yield from self._iter_single()
            return
        work_q: queue.Queue = queue.Queue()
        out: dict[int, object] = {}
        done = threading.Event()
        lock = threading.Condition()
        next_needed = [0]  # consumer cursor, guarded by `lock`
        capacity = self.num_workers * self.prefetch_factor
        batches = list(self.batch_sampler)
        for i, idxs in enumerate(batches):
            work_q.put((i, idxs))

        def worker(wid):
            _worker_info.info = WorkerInfo(wid, self.num_workers, self.dataset)
            if self.worker_init_fn is not None:
                self.worker_init_fn(wid)
            while not done.is_set():
                with lock:
                    # bounded prefetch relative to the consumer cursor: batch i
                    # may be produced once it is within `capacity` of the next
                    # batch to be consumed (bounding on len(out) alone can
                    # deadlock: the buffer fills with later batches while the
                    # batch the consumer needs is still being fetched).
                    try:
                        i, idxs = work_q.get_nowait()
                    except queue.Empty:
                        return
                    while i >= next_needed[0] + capacity and not done.is_set():
                        lock.wait(0.1)
                if done.is_set():
                    return
                try:
                    batch = self._fetch(idxs)
                except BaseException as e:  # propagate to the consumer
                    batch = _WorkerError(e)
                with lock:
                    out[i] = batch
                    lock.notify_all()

        threads = [
            threading.Thread(target=worker, args=(w,), daemon=True)
            for w in range(self.num_workers)
        ]
        for t in threads:
            t.start()
        try:
            for i in range(len(batches)):
                with lock:
                    while i not in out:
                        lock.wait(0.1)
                    batch = out.pop(i)
                    next_needed[0] = i + 1
                    lock.notify_all()
                if isinstance(batch, _WorkerError):
                    raise batch.exc
                yield batch
        finally:
            done.set()
            for t in threads:
                try:
                    t.join(timeout=1.0)
                except Exception:
                    # abandoned iterators may be GC'd during interpreter
                    # shutdown, when threading internals are already gone
                    pass

    def _iter_process(self):
        """Forked worker processes + shared-memory transport (io/worker.py)."""
        from .worker import ProcessPool

        iterable_cfg = ((self.batch_size, self.drop_last)
                        if self._iterable_mode else None)
        pool = self._pool
        # a persistent pool serves ONE live iterator; concurrent iterators
        # would cross epoch tags (each discarding the other's batches as
        # stale) — the overlapping iterator gets its own temporary pool
        if pool is None or pool._busy:
            pool = ProcessPool(self, iterable_cfg)
            if self.persistent_workers and self._pool is None:
                self._pool = pool
        pool._busy = True
        try:
            if self._iterable_mode:
                yield from pool.run_iterable_epoch()
            else:
                batches = list(self.batch_sampler)
                capacity = max(2, self.num_workers * self.prefetch_factor)
                yield from pool.run_epoch(batches, capacity)
        finally:
            pool._busy = False
            if pool is not self._pool:
                pool.shutdown()

    def __iter__(self):
        if self.num_workers == 0:
            it = self._iter_single()
        elif self.use_process:
            it = self._iter_process()
        else:
            it = self._iter_threaded()
        if not self._placed:
            yield from it
        elif self.place.type == "cpu":
            for batch in it:
                yield to_place(batch, self.place)
        else:
            from .device_loader import DeviceLoader

            for batch in DeviceLoader(it, device=self.place):
                yield _wrap_tree(batch)

    def __del__(self):
        pool, self._pool = self._pool, None
        if pool is not None:
            try:
                pool.shutdown()
            except Exception:
                pass

    @staticmethod
    def from_generator(*args, **kwargs):
        raise NotImplementedError(
            "from_generator is a legacy static-graph API; use a Dataset"
        )
