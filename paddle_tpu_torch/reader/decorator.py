"""Reader decorators (counterpart of ``paddle_tpu/reader/decorator.py``;
reference: python/paddle/v2/reader/decorator.py).  ``native_buffered``
needs the ``native/`` binding and is not ported yet."""
from __future__ import annotations

import itertools
import queue as _queue
import random as _random
import threading


def map_readers(func, *readers):
    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)
    return reader


def shuffle(reader, buf_size):
    """Shuffle within windows of ``buf_size`` samples, with the
    ``random`` module's generator (seed it for a repeatable order)."""
    def new_reader():
        buf = []
        for s in reader():
            buf.append(s)
            if len(buf) >= buf_size:
                _random.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            _random.shuffle(buf)
            yield from buf
    return new_reader


def chain(*readers):
    def reader():
        for r in readers:
            yield from r()
    return reader


def compose(*readers, check_alignment=True):
    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        for outputs in itertools.zip_longest(*rs):
            if check_alignment and any(o is None for o in outputs):
                raise ValueError("readers not aligned in compose()")
            yield sum((make_tuple(o) for o in outputs), ())
    return reader


def buffered(reader, size):
    """Read ahead through a bounded queue on one worker thread
    (``pipeline.prefetch``): order-preserving; a reader exception
    re-raises in the consumer; abandoning the generator stops and joins
    the worker."""
    from .pipeline import prefetch
    return prefetch(reader, buffer_size=size, num_workers=1)


def batch(reader, batch_size, drop_last=True):
    """Group samples into lists of ``batch_size``."""
    def batch_reader():
        b = []
        for sample in reader():
            b.append(sample)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b
    return batch_reader


def firstn(reader, n):
    def firstn_reader():
        for i, item in enumerate(reader()):
            if i == n:
                break
            yield item
    return firstn_reader


def cache(reader):
    all_data = []

    def cache_reader():
        if not all_data:
            all_data.extend(reader())
        yield from all_data
    return cache_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Map ``mapper`` over the samples on ``process_num`` worker threads;
    the output order is the workers' (``order`` is accepted and, as in
    the JAX package, not enforced)."""
    end = object()

    def data_reader():
        in_q: _queue.Queue = _queue.Queue(buffer_size)
        out_q: _queue.Queue = _queue.Queue(buffer_size)

        def read_worker():
            for d in reader():
                in_q.put(d)
            for _ in range(process_num):
                in_q.put(end)

        def map_worker():
            while True:
                d = in_q.get()
                if d is end:
                    out_q.put(end)
                    return
                out_q.put(mapper(d))

        threading.Thread(target=read_worker, daemon=True,
                         name="pt-reader-xmap-read").start()
        workers = [threading.Thread(target=map_worker, daemon=True,
                                    name=f"pt-reader-xmap-map-{i}")
                   for i in range(process_num)]
        for w in workers:
            w.start()
        finished = 0
        while finished < process_num:
            d = out_q.get()
            if d is end:
                finished += 1
            else:
                yield d
    return data_reader
