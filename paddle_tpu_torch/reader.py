# Copied unchanged from paddle_tpu/reader.py: it needs no jax, and the port imports
# nothing of the JAX package.
"""paddle.reader — generator-composition utilities.

Reference: ``python/paddle/reader/decorator.py`` (cache/shuffle/chain/
compose/buffered/firstn/map_readers + multiprocess variants). These are
host-side python generators feeding DataLoader-style pipelines; the
process-pool variants map onto :mod:`paddle_tpu.io`'s worker machinery, so
here the pure-python combinators are provided and the xmap/multiprocess
forms delegate to threads (device feeding on TPU is one process per host).
"""
from __future__ import annotations

import queue as _queue
import random as _random
import threading

__all__ = [
    "cache", "map_readers", "shuffle", "chain", "compose", "buffered",
    "firstn", "xmap_readers", "ComposeNotAligned",
]


class ComposeNotAligned(ValueError):
    pass


def cache(reader):
    all_data = []
    state = {"filled": False}

    def cached():
        if not state["filled"]:
            for item in reader():
                all_data.append(item)
            state["filled"] = True
        yield from all_data

    return cached


def map_readers(func, *readers):
    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)

    return reader


def shuffle(reader, buf_size):
    def shuffled():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) >= buf_size:
                _random.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            _random.shuffle(buf)
            yield from buf

    return shuffled


def chain(*readers):
    def chained():
        for r in readers:
            yield from r()

    return chained


def compose(*readers, **kwargs):
    check_alignment = kwargs.pop("check_alignment", True)

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def composed():
        rs = [r() for r in readers]
        for items in zip(*rs):
            yield sum((make_tuple(i) for i in items), ())
        if check_alignment:
            for r in rs:
                try:
                    next(r)
                except StopIteration:
                    continue
                raise ComposeNotAligned(
                    "readers have different lengths (check_alignment=True)")

    return composed


def buffered(reader, size):
    end = object()

    def buffered_reader():
        q = _queue.Queue(maxsize=size)

        def fill():
            for item in reader():
                q.put(item)
            q.put(end)

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is end:
                break
            yield item

    return buffered_reader


def firstn(reader, n):
    def firstn_reader():
        for i, item in enumerate(reader()):
            if i >= n:
                break
            yield item

    return firstn_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map over a reader (reference uses processes; threads here —
    the mapper typically releases the GIL in numpy, and TPU hosts feed from
    one process)."""
    end = object()

    def xreader():
        in_q = _queue.Queue(buffer_size)
        out_q = _queue.Queue(buffer_size)

        def feed():
            for i, item in enumerate(reader()):
                in_q.put((i, item))
            for _ in range(process_num):
                in_q.put(end)

        def work():
            while True:
                got = in_q.get()
                if got is end:
                    out_q.put(end)
                    break
                i, item = got
                out_q.put((i, mapper(item)))

        threading.Thread(target=feed, daemon=True).start()
        for _ in range(process_num):
            threading.Thread(target=work, daemon=True).start()

        done = 0
        pending = {}
        next_i = 0
        while done < process_num:
            got = out_q.get()
            if got is end:
                done += 1
                continue
            if not order:
                yield got[1]
                continue
            pending[got[0]] = got[1]
            while next_i in pending:
                yield pending.pop(next_i)
                next_i += 1
        if order:
            while next_i in pending:
                yield pending.pop(next_i)
                next_i += 1

    return xreader
