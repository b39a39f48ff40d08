# Copied from paddle_tpu/io/worker.py (it needs no jax, and the port imports
# nothing of the JAX package); the forkserver's preload is added and a
# restart replaces every worker and the queues, and iterable-mode workers
# take their epoch starts from a queue each (see ProcessPool). Workers
# get numpy-only collation from the DataLoader
# (io/collate.py) and never touch CUDA; the parent builds the Tensors.
# forkserver stays the default start: a fork of a parent whose CUDA context
# is live gives a child that dies or hangs on its first CUDA call.
# shutdown_workers (run at exit) is added: the server would otherwise
# outlive the program by the time it takes to unload torch.
"""Multiprocess DataLoader workers with shared-memory batch transport.

Reference: ``python/paddle/fluid/dataloader/dataloader_iter.py:342``
(``_DataLoaderIterMultiProcess``) + the mmap shared-memory tensor channel
(``paddle/fluid/memory/allocation/mmap_allocator.cc``).  TPU-native
redesign of the same capability:

 - workers are forked OS processes (true parallelism for Python-heavy
   per-sample transforms — the thread pool in ``dataloader.py`` is the
   better default only while transforms are numpy-C-bound);
 - each produced batch travels through ONE ``multiprocessing.shared_memory``
   segment: the worker lays every ndarray leaf of the (collated) batch
   into the segment back-to-back and sends only a small pickled meta
   record (segment name + per-leaf offset/shape/dtype + pytree spec) over
   the result queue — the reference's mmap channel, minus the C++;
 - the parent reorders by batch index, bounds in-flight work by
   ``num_workers * prefetch_factor`` (back-pressure = task issuance, not a
   consumer-cursor dance), re-raises worker exceptions with the worker's
   traceback text, and detects killed workers by liveness-checking on
   every poll timeout;
 - ``persistent_workers=True`` keeps the pool across epochs; tasks and
   results carry an epoch tag so an abandoned mid-epoch iterator can never
   leak stale batches into the next epoch.
"""
from __future__ import annotations

import atexit
import itertools
import multiprocessing as mp
import os
import queue as _queue
import random
import traceback
import weakref
from multiprocessing import shared_memory

import numpy as np

__all__ = ["ProcessPool", "WorkerFailure", "shutdown_workers"]

_STOP = "__stop__"
_EPOCH_END = "__epoch_end__"

_live_pools = weakref.WeakSet()
_atexit_registered = False


class WorkerFailure(RuntimeError):
    """A worker raised (carries its traceback) or died (SIGKILL/segfault)."""


class _WorkersDied(Exception):
    """Internal control flow: dead worker slots that may still be restarted
    (``DataLoader(worker_restart_limit=...)``)."""

    def __init__(self, slots):
        self.slots = slots


# -- batch <-> shared memory ------------------------------------------------

def _flatten(obj, arrays, spec):
    """Pytree flatten where ndarray leaves are hoisted into ``arrays``;
    everything else rides pickled inside the spec."""
    if isinstance(obj, np.ndarray) and obj.nbytes > 0:
        arrays.append(np.ascontiguousarray(obj))
        spec.append(("a", len(arrays) - 1))
    elif isinstance(obj, (list, tuple)):
        spec.append(("s" if isinstance(obj, list) else "t", len(obj)))
        for c in obj:
            _flatten(c, arrays, spec)
    elif isinstance(obj, dict):
        keys = list(obj.keys())
        spec.append(("d", keys))
        for k in keys:
            _flatten(obj[k], arrays, spec)
    else:
        spec.append(("o", obj))
    return arrays, spec


def _unflatten(spec, arrays, pos=0):
    kind, payload = spec[pos]
    pos += 1
    if kind == "a":
        return arrays[payload], pos
    if kind in ("s", "t"):
        items = []
        for _ in range(payload):
            item, pos = _unflatten(spec, arrays, pos)
            items.append(item)
        return (items if kind == "s" else tuple(items)), pos
    if kind == "d":
        out = {}
        for k in payload:
            out[k], pos = _unflatten(spec, arrays, pos)
        return out, pos
    return payload, pos


def _encode_shm(batch):
    """Lay every ndarray leaf into one fresh shm segment; return meta."""
    arrays, spec = _flatten(batch, [], [])
    total = sum(a.nbytes for a in arrays)
    if total == 0:
        return {"shm": None, "spec": spec, "leaves": []}
    seg = shared_memory.SharedMemory(create=True, size=total)
    leaves, off = [], 0
    for a in arrays:
        view = np.ndarray(a.shape, a.dtype, buffer=seg.buf, offset=off)
        view[...] = a
        leaves.append((off, a.shape, a.dtype.str))
        off += a.nbytes
    name = seg.name
    seg.close()  # parent unlinks after copying out
    return {"shm": name, "spec": spec, "leaves": leaves}


def _decode_shm(meta):
    if meta["shm"] is None:
        obj, _ = _unflatten(meta["spec"], [])
        return obj
    seg = shared_memory.SharedMemory(name=meta["shm"])
    try:
        arrays = [
            np.ndarray(shape, np.dtype(dt), buffer=seg.buf, offset=off).copy()
            for off, shape, dt in meta["leaves"]
        ]
        obj, _ = _unflatten(meta["spec"], arrays)
        return obj
    finally:
        seg.close()
        seg.unlink()


def _drop_shm(meta):
    """Free a segment whose batch will never be consumed (stale epoch)."""
    if meta.get("shm"):
        try:
            seg = shared_memory.SharedMemory(name=meta["shm"])
            seg.close()
            seg.unlink()
        except FileNotFoundError:
            pass


# -- worker main ------------------------------------------------------------

def _worker_loop(wid, num_workers, dataset, collate_fn, task_q, result_q,
                 worker_init_fn, use_shared_memory, iterable_cfg, base_seed):
    from .dataloader import WorkerInfo, _worker_info

    _worker_info.info = WorkerInfo(wid, num_workers, dataset)
    # distinct RNG stream per worker (reference _worker_loop seeds
    # base_seed + worker_id); without this forked workers would share the
    # parent's byte-identical numpy state and produce correlated augments
    np.random.seed((base_seed + wid) % (2 ** 32))
    random.seed(base_seed + wid)
    try:
        if worker_init_fn is not None:
            worker_init_fn(wid)
    except BaseException:
        result_q.put(("init", wid, None, traceback.format_exc()))
        return
    try:
        if iterable_cfg is not None:
            _iterable_worker(wid, dataset, collate_fn, task_q, result_q,
                             use_shared_memory, iterable_cfg)
            return
        while True:
            msg = task_q.get()
            if msg == _STOP:
                return
            epoch, idx, indices = msg
            try:
                from ..fault import inject

                inject.check("worker.fetch")  # deterministic worker-death
                batch = collate_fn([dataset[i] for i in indices])
                payload = (_encode_shm(batch) if use_shared_memory
                           else {"shm": None, "pickled": True,
                                 "data": batch})
                result_q.put(("ok", epoch, idx, payload))
            except BaseException:
                result_q.put(("err", epoch, idx, traceback.format_exc()))
    except (KeyboardInterrupt, SystemExit):
        pass


def _iterable_worker(wid, dataset, collate_fn, task_q, result_q,
                     use_shared_memory, cfg):
    """IterableDataset mode: each worker streams its OWN iterator (the user
    shards via get_worker_info, reference semantics); task messages are
    epoch starts."""
    batch_size, drop_last = cfg
    while True:
        msg = task_q.get()
        if msg == _STOP:
            return
        epoch = msg
        try:
            it = iter(dataset)
            while True:
                chunk = list(itertools.islice(it, batch_size))
                if not chunk or (len(chunk) < batch_size and drop_last):
                    break
                batch = collate_fn(chunk)
                payload = (_encode_shm(batch) if use_shared_memory
                           else {"shm": None, "pickled": True, "data": batch})
                result_q.put(("ok", epoch, None, payload))
        except BaseException:
            result_q.put(("err", epoch, None, traceback.format_exc()))
        result_q.put((_EPOCH_END, epoch, wid, None))


# -- parent-side pool -------------------------------------------------------

class ProcessPool:
    """Worker pool shared by every iterator of one DataLoader.

    Start method: ``forkserver`` by default — plain ``fork`` of a parent
    whose JAX runtime threads are live risks a child deadlocked on an
    inherited mutex (CPython/JAX both warn).  ``forkserver`` re-execs a
    clean helper, at the cost of requiring a picklable dataset /
    collate_fn / worker_init_fn (same contract as the reference's
    non-fork platforms).  Override via PADDLE_TPU_WORKER_START=fork for
    non-picklable datasets in single-threaded parents.
    """

    def __init__(self, loader, iterable_cfg=None):
        method = os.environ.get("PADDLE_TPU_WORKER_START", "forkserver")
        ctx = mp.get_context(method)
        if method == "forkserver":
            # the server imports this module (torch with it) once, before
            # any CUDA use, and forks every worker from that: a worker
            # starts in a fork, not in an import of torch of its own, which
            # the parent waits out worker by worker while it writes the
            # worker's arguments (seconds each). Takes effect when the
            # process's forkserver starts.
            ctx.set_forkserver_preload(["__main__", __name__])
        self._nw = loader.num_workers
        self._iterable = iterable_cfg is not None
        self._timeout = float(getattr(loader, "timeout", 0) or 0)
        self._restart_limit = int(
            getattr(loader, "worker_restart_limit", 0) or 0)
        self._restarts_used = 0
        # bounded: back-pressure for iterable-mode workers (map-style is
        # already bounded by task issuance, which never exceeds this)
        self._capacity = max(2, self._nw * loader.prefetch_factor)
        self._epoch = 0
        self._busy = False   # one live iterator at a time (epoch tags)
        base_seed = int.from_bytes(os.urandom(4), "little")
        # capture spawn args (not the loader: its __del__ owns this pool)
        self._ctx = ctx
        self._spawn_args = (loader.dataset, loader.collate_fn,
                            loader.worker_init_fn, loader.use_shared_memory,
                            iterable_cfg, base_seed)
        global _atexit_registered
        if not _atexit_registered:
            # registered after multiprocessing's own exit hook, so it runs
            # before that one
            atexit.register(shutdown_workers)
            _atexit_registered = True
        _live_pools.add(self)
        self._start()

    def _start(self):
        """Fresh task and result queues and a worker on every slot.

        Map-style workers share one task queue. Iterable-mode workers get
        a task queue each: on a shared one a worker that ends its stream
        first can take another's epoch start and stream its own shard
        twice, the other's not at all (the JAX pool's race)."""
        ctx = self._ctx
        dataset, collate_fn, init_fn, shm, cfg, seed = self._spawn_args
        self._task_q = ctx.Queue()
        self._task_qs = ([self._task_q] + [ctx.Queue()
                                           for _ in range(self._nw - 1)]
                         if self._iterable else [self._task_q] * self._nw)
        self._result_q = ctx.Queue(maxsize=self._capacity + self._nw)
        self._procs = [ctx.Process(
            target=_worker_loop,
            args=(w, self._nw, dataset, collate_fn, self._task_qs[w],
                  self._result_q, init_fn, shm, cfg, seed), daemon=True)
            for w in range(self._nw)]
        for p in self._procs:
            p.start()

    def _check_alive(self, restartable=False):
        dead = [i for i, p in enumerate(self._procs) if not p.is_alive()]
        if not dead:
            return
        if restartable and self._restarts_used < self._restart_limit:
            raise _WorkersDied(dead)
        pids = [self._procs[i].pid for i in dead]
        raise WorkerFailure(
            f"DataLoader worker (pid {pids}) exited unexpectedly — "
            "killed or crashed; see worker stderr"
            + (f" ({self._restarts_used} restarts already used)"
               if self._restarts_used else "")
        )

    def _restart_workers(self, slots):
        """After a worker death, with exponential backoff + jitter, replace
        every worker and both queues. A worker killed inside a queue call
        dies holding that queue's cross-process lock (the task queue's
        reader lock while it waits for a task, the result queue's writer
        lock while its feeder thread writes a batch), and every other
        worker then blocks on it for good; the JAX package respawns only
        the dead slots on the old queues and can hang there. Map-style
        recovery path: the caller re-dispatches in-flight tasks onto the
        new task queue; results already sent on the old queue are lost
        with it (their shared-memory segments too, until the resource
        tracker frees them at exit)."""
        import random as _random
        import time as _time

        self._restarts_used += 1
        delay = min(0.05 * (2 ** (self._restarts_used - 1)), 2.0)
        _time.sleep(delay * (1.0 + 0.5 * _random.random()))
        for p in self._procs:
            if p.is_alive():
                p.terminate()
            p.join(timeout=1.0)
        for q in {*self._task_qs, self._result_q}:
            q.close()
            q.cancel_join_thread()
        self._start()
        from ..profiler import telemetry

        if telemetry.enabled():
            telemetry.get_telemetry().inc("fault.worker_restarts", len(slots))

    def _poll(self, restartable=False):
        """One result, liveness-checked; honors the DataLoader timeout."""
        waited = 0.0
        while True:
            try:
                return self._result_q.get(timeout=1.0)
            except _queue.Empty:
                self._check_alive(restartable)
                waited += 1.0
                if self._timeout and waited >= self._timeout:
                    raise WorkerFailure(
                        f"DataLoader timed out after {self._timeout:.0f}s "
                        "waiting for a worker batch"
                    )

    def _handle(self, msg, epoch):
        kind, ep, idx, payload = msg
        if kind == "init":
            raise WorkerFailure(
                f"worker_init_fn failed in worker {ep}:\n{payload}")
        if ep != epoch:      # stale result from an abandoned iterator
            if kind == "ok" and isinstance(payload, dict):
                _drop_shm(payload)
            return None
        if kind == "err":
            raise WorkerFailure(f"DataLoader worker raised:\n{payload}")
        if kind == _EPOCH_END:
            return (_EPOCH_END, idx)
        batch = (_decode_shm(payload) if not payload.get("pickled")
                 else payload["data"])
        return ("ok", idx, batch)

    # -- map-style epochs ---------------------------------------------------
    def run_epoch(self, batches, capacity):
        """Yield collated batches in order, issuing at most ``capacity``
        in-flight tasks.

        A worker death (SIGKILL/segfault) is survivable: up to
        ``worker_restart_limit`` times the pool respawns the dead slots and
        re-dispatches every in-flight index — a task the dead worker had
        claimed would otherwise never produce its batch. Re-dispatch can
        duplicate work still owned by a live worker; duplicate results are
        dropped by batch index. Worker EXCEPTIONS (user-code bugs) are not
        retried — they propagate immediately via ``WorkerFailure``."""
        self._epoch += 1
        epoch = self._epoch
        n = len(batches)
        capacity = min(capacity, self._capacity)
        next_task = 0
        buf = {}
        in_flight = {}  # idx -> sample indices, issued but not received

        def issue(i):
            self._task_q.put((epoch, i, batches[i]))
            in_flight[i] = batches[i]

        for _ in range(min(capacity, n)):
            issue(next_task)
            next_task += 1
        for want in range(n):
            while want not in buf:
                try:
                    out = self._handle(self._poll(restartable=True), epoch)
                except _WorkersDied as dead:
                    self._restart_workers(dead.slots)
                    for i, idxs in list(in_flight.items()):
                        self._task_q.put((epoch, i, idxs))
                    continue
                if out is None:
                    continue
                _, idx, batch = out
                in_flight.pop(idx, None)
                if idx < want or idx in buf:
                    continue  # duplicate from a re-dispatch
                buf[idx] = batch
            if next_task < n:
                issue(next_task)
                next_task += 1
            yield buf.pop(want)

    # -- iterable epochs ----------------------------------------------------
    def run_iterable_epoch(self):
        self._epoch += 1
        epoch = self._epoch
        for q in self._task_qs:
            q.put(epoch)
        finished = 0
        while finished < self._nw:
            out = self._handle(self._poll(), epoch)
            if out is None:
                continue
            if out[0] == _EPOCH_END:
                finished += 1
                continue
            yield out[2]

    def shutdown(self):
        _live_pools.discard(self)
        for q in self._task_qs:
            try:
                q.put(_STOP)
            except Exception:
                pass
        for p in self._procs:
            p.join(timeout=2.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=2.0)
        # free any segments still parked in the result queue
        try:
            while True:
                msg = self._result_q.get_nowait()
                if msg[0] == "ok" and isinstance(msg[3], dict):
                    _drop_shm(msg[3])
        except Exception:
            pass

    def __del__(self):
        try:
            self.shutdown()
        except Exception:
            pass


def shutdown_workers():
    """Stop every live pool's workers, then the forkserver that forked them
    and multiprocessing's resource tracker, waiting until each has ended.

    Runs at interpreter exit. Without it the server, which has imported
    torch, outlives the program by the second it takes to unload it, and
    the tracker outlives it until the server is gone. The two are stopped
    only when the process has no other multiprocessing child, which could
    hold their pipes open; a pool started afterwards starts them anew.
    """
    for pool in list(_live_pools):
        try:
            pool.shutdown()
        except Exception:
            pass
    if mp.active_children():
        return
    from multiprocessing import forkserver, resource_tracker

    server = forkserver._forkserver
    if getattr(server, "_forkserver_pid", None) is not None:
        server._stop()
    tracker = resource_tracker._resource_tracker
    if getattr(tracker, "_pid", None) is not None:
        tracker._stop()
