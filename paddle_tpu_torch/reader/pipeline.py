"""Asynchronous bounded multi-worker input pipeline (counterpart of
``paddle_tpu/reader/pipeline.py``).

tf.data-style prefetch/interleave for the reader protocol (a *reader* is
a zero-arg callable returning an iterable of samples): decode work moves
off the dispatch thread onto N workers feeding one bounded queue.

* **bounded**: at most ``buffer_size`` samples wait in the queue, so a
  slow consumer exerts backpressure;
* **exceptions**: a worker that raises forwards the exception to the
  consumer's ``next()``;
* **clean shutdown**: abandoning the output generator early (``break``,
  ``close()``, garbage collection) stops every worker and joins it;
* **shard-aware interleave**: N readers (data shards) are spread over the
  workers round-robin, and each worker cycles its shards.

``Executor.run_pipelined`` runs its staging stage on this engine.  The
JAX module's observability hooks and autotuned defaults are not ported.
"""
from __future__ import annotations

import queue as _queue
import threading
from typing import Callable, Optional, Sequence

__all__ = ["prefetch", "interleave", "THREAD_NAME_PREFIX"]

# every worker thread the engine spawns carries this name prefix
THREAD_NAME_PREFIX = "pt-input-pipeline"

_DATA, _DONE, _ERROR = 0, 1, 2
_POLL_S = 0.05          # worker put/stop poll; bounds shutdown latency


def _offer(q: _queue.Queue, stop: threading.Event, msg) -> bool:
    """Blocking put that gives up when the pipeline is being torn down."""
    while not stop.is_set():
        try:
            q.put(msg, timeout=_POLL_S)
            return True
        except _queue.Full:
            continue
    return False


def _pump(source: Callable[[], object], q: _queue.Queue,
          stop: threading.Event):
    """Worker loop: drain one source iterable into the shared queue."""
    try:
        for item in source():
            if not _offer(q, stop, (_DATA, item)):
                return
    except BaseException as e:          # noqa: BLE001 — forwarded, not eaten
        _offer(q, stop, (_ERROR, e))
    finally:
        _offer(q, stop, (_DONE, None))


def _run(sources: Sequence[Callable], buffer_size: int):
    """Generator over the merged output of ``sources``, each drained by its
    own worker thread through one bounded queue."""
    q: _queue.Queue = _queue.Queue(maxsize=max(1, buffer_size))
    stop = threading.Event()
    threads = [threading.Thread(target=_pump, args=(src, q, stop),
                                daemon=True,
                                name=f"{THREAD_NAME_PREFIX}-{i}")
               for i, src in enumerate(sources)]
    for t in threads:
        t.start()
    done = 0
    try:
        while done < len(threads):
            tag, payload = q.get()
            if tag == _DATA:
                yield payload
            elif tag == _ERROR:
                raise payload
            else:
                done += 1
    finally:
        # break / close() / error / normal end all land here: wake every
        # blocked putter, then join — consumer exit means worker exit
        stop.set()
        while True:
            try:
                q.get_nowait()
            except _queue.Empty:
                break
        for t in threads:
            t.join(timeout=5.0)


def prefetch(reader: Callable, buffer_size: int = 8, num_workers: int = 1,
             mapper: Optional[Callable] = None) -> Callable:
    """Decode ahead through ``num_workers`` threads and a bounded queue.

    Workers share the source iterator (pulls are serialized under a
    lock); ``mapper``, when given, runs outside the lock, which is where
    parallel decode happens.  With ``num_workers == 1`` the sample order
    is preserved; with more, order across workers is not guaranteed."""
    if num_workers < 1:
        raise ValueError(f"prefetch: num_workers must be >= 1, "
                         f"got {num_workers}")

    def data_reader():
        it = iter(reader())
        lock = threading.Lock()
        exhausted = object()

        def source():
            while True:
                with lock:
                    # a pull that raises also closes the shared generator,
                    # so the other workers wind down with StopIteration
                    # while the engine forwards this exception
                    item = next(it, exhausted)
                if item is exhausted:
                    return
                yield mapper(item) if mapper is not None else item

        yield from _run([source] * num_workers, buffer_size)
    return data_reader


def interleave(readers: Sequence[Callable], buffer_size: int = 8,
               num_workers: Optional[int] = None,
               mapper: Optional[Callable] = None) -> Callable:
    """Merge N shard readers through parallel workers (tf.data
    interleave): worker ``i`` owns shards ``i, i+W, ...`` and cycles them
    one sample at a time.  ``num_workers`` defaults to one per shard."""
    readers = list(readers)
    if not readers:
        raise ValueError("interleave: need at least one reader")
    W = min(num_workers or len(readers), len(readers))
    if W < 1:
        raise ValueError(f"interleave: num_workers must be >= 1, got {W}")

    def data_reader():
        def make_source(widx):
            shards = readers[widx::W]

            def source():
                iters = [iter(r()) for r in shards]
                while iters:
                    alive = []
                    for it in iters:
                        try:
                            item = next(it)
                        except StopIteration:
                            continue
                        yield mapper(item) if mapper is not None else item
                        alive.append(it)
                    iters = alive
            return source

        yield from _run([make_source(i) for i in range(W)], buffer_size)
    return data_reader
