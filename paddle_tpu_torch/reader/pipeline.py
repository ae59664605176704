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

``Executor.run_pipelined`` runs its staging stage on this engine.

**Instrumentation** (``paddle_tpu_torch.observability``): with the
``observe`` flag on — or ``instrument=True`` passed explicitly — the
engine records sampled queue depth and consumer stall time at every get,
per-worker busy/blocked seconds, a ``reader/pipeline`` root span and one
``reader/item`` span per produced item.  Off by default and entirely
outside the data path when off.

**Autotuned defaults**: ``prefetch``'s omitted ``buffer_size`` and
``num_workers`` are (8, 1), or, with the ``autotune`` flag on, the
persisted ``reader/prefetch`` winner (``paddle_tpu_torch.tuning``,
imported only then).  An explicit argument always wins.
"""
from __future__ import annotations

import queue as _queue
import threading
import time as _time
from typing import Callable, Optional, Sequence

from .. import observability as _obs
from ..core.registry import register_tunable
from ..testing import lockwatch as _lw

__all__ = ["prefetch", "interleave", "THREAD_NAME_PREFIX"]

# Autotuner knob (paddle_tpu_torch.tuning), beside the engine it controls,
# with the JAX package's space and default: num_workers trades decode
# parallelism against GIL and core contention, buffer_size bounds the
# decoded samples in flight.
register_tunable(
    "reader/prefetch", side="host",
    space={"num_workers": (1, 2, 4), "buffer_size": (2, 4, 8, 16)},
    default={"num_workers": 1, "buffer_size": 8},
    description="prefetch engine defaults: decode worker threads and the "
                "bounded decoded-sample queue.")

# every worker thread the engine spawns carries this name prefix
THREAD_NAME_PREFIX = "pt-input-pipeline"

_DATA, _DONE, _ERROR = 0, 1, 2
_POLL_S = 0.05          # worker put/stop poll; bounds shutdown latency
_FLUSH_EVERY = 32       # instrumented busy/wait counter flush cadence


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
          stop: threading.Event, instrument: bool = False,
          span_parent=None, widx: int = 0):
    """Worker loop: drain one source iterable into the shared queue.

    ``instrument`` splits the loop's wall time into *busy* (producing —
    decode/stage work inside the source) and *wait* (blocked offering to
    a full queue — consumer backpressure); deltas flush into the counters
    every ``_FLUSH_EVERY`` items and at worker exit, so a live pipeline's
    periodic snapshots see current numbers while the loop still pays only
    two perf_counter reads per item and ~zero lock traffic.

    ``span_parent`` (instrumented runs): each produce emits a
    ``reader/item`` span — attached to this worker thread while the
    source runs, so spans the source itself creates (run_pipelined's
    ``pipeline/stage``) nest under the item that carried them."""
    busy = wait = 0.0
    n = 0
    try:
        if not instrument:
            for item in source():
                if not _offer(q, stop, (_DATA, item)):
                    return
        else:
            it = iter(source())
            while True:
                sp = None
                if span_parent is not None:
                    sp = _obs.tracing.start_span(
                        "reader/item", parent=span_parent,
                        worker=widx, seq=n)
                t0 = _time.perf_counter()
                try:
                    if sp is not None:
                        with _obs.tracing.attach(sp):
                            item = next(it)
                    else:
                        item = next(it)
                except StopIteration:
                    busy += _time.perf_counter() - t0
                    if sp is not None:
                        sp.cancel()      # the final empty pull: no span
                    break
                if sp is not None:
                    sp.end()
                t1 = _time.perf_counter()
                busy += t1 - t0
                ok = _offer(q, stop, (_DATA, item))
                wait += _time.perf_counter() - t1
                if not ok:
                    return
                n += 1
                if n % _FLUSH_EVERY == 0:
                    _obs.inc_counter("pipeline/worker_busy_s", busy)
                    _obs.inc_counter("pipeline/worker_wait_s", wait)
                    busy = wait = 0.0
    except BaseException as e:          # noqa: BLE001 — forwarded, not eaten
        _offer(q, stop, (_ERROR, e))
    finally:
        if instrument and (busy or wait):
            _obs.inc_counter("pipeline/worker_busy_s", busy)
            _obs.inc_counter("pipeline/worker_wait_s", wait)
        _offer(q, stop, (_DONE, None))


def _resolve_instrument(instrument: Optional[bool]) -> bool:
    """None defers to the global ``observe`` flag; resolved ONCE at
    pipeline start (a mid-stream flag flip doesn't change a live run)."""
    return _obs.enabled() if instrument is None else bool(instrument)


def _run(sources: Sequence[Callable], buffer_size: int,
         instrument: Optional[bool] = None, trace_parent=None):
    """Generator over the merged output of ``sources``, each drained by its
    own worker thread through one bounded queue.

    Instrumented runs get a ``reader/pipeline`` root span (parented to
    ``trace_parent`` when the caller supplies one — run_pipelined joins
    its staging engine into the pipelined trace this way) with one
    ``reader/item`` child span per produced item."""
    instrument = _resolve_instrument(instrument)
    root_sp = _obs.tracing.start_span(
        "reader/pipeline", parent=trace_parent,
        workers=len(sources), buffer_size=int(buffer_size)) \
        if instrument else None
    q: _queue.Queue = _queue.Queue(maxsize=max(1, buffer_size))
    stop = threading.Event()
    threads = [
        threading.Thread(target=_pump,
                         args=(src, q, stop, instrument, root_sp, i),
                         daemon=True, name=f"{THREAD_NAME_PREFIX}-{i}")
        for i, src in enumerate(sources)]
    for t in threads:
        t.start()
    done = 0
    try:
        while done < len(threads):
            if instrument:
                t0 = _time.perf_counter()
                tag, payload = q.get()
                _obs.observe_hist("pipeline/consumer_stall_ms",
                                  (_time.perf_counter() - t0) * 1e3)
                _obs.observe_hist("pipeline/queue_depth", q.qsize())
            else:
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
        if root_sp is not None:
            root_sp.end()


def _tuned_defaults(buffer_size: Optional[int], num_workers: Optional[int]):
    """Omitted prefetch knobs: (8, 1), or the persisted ``reader/prefetch``
    winner under the ``autotune`` flag.  An explicit argument wins."""
    if buffer_size is not None and num_workers is not None:
        return buffer_size, num_workers
    from ..core.registry import resolve_tuned
    cfg = resolve_tuned("reader/prefetch",
                        {"buffer_size": 8, "num_workers": 1})
    return (cfg["buffer_size"] if buffer_size is None else buffer_size,
            cfg["num_workers"] if num_workers is None else num_workers)


def prefetch(reader: Callable, buffer_size: Optional[int] = None,
             num_workers: Optional[int] = None,
             mapper: Optional[Callable] = None,
             instrument: Optional[bool] = None,
             trace_parent=None) -> Callable:
    """Decode ahead through ``num_workers`` threads and a bounded queue.

    Workers share the source iterator (pulls are serialized under a
    lock); ``mapper``, when given, runs outside the lock, which is where
    parallel decode happens.  With ``num_workers == 1`` the sample order
    is preserved; with more, order across workers is not guaranteed.
    ``instrument``: queue-depth/stall/busy metrics and the
    ``reader/pipeline`` / ``reader/item`` spans (None follows the
    ``observe`` flag); ``trace_parent`` joins those spans into a
    caller's trace.  ``buffer_size``/``num_workers`` default to (8, 1),
    or the persisted ``reader/prefetch`` winner under the ``autotune``
    flag."""
    buffer_size, num_workers = _tuned_defaults(buffer_size, num_workers)
    if num_workers < 1:
        raise ValueError(f"prefetch: num_workers must be >= 1, "
                         f"got {num_workers}")

    def data_reader():
        it = iter(reader())
        lock = _lw.make_lock("pipeline.shared_source")
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

        yield from _run([source] * num_workers, buffer_size,
                        instrument=instrument, trace_parent=trace_parent)
    return data_reader


def interleave(readers: Sequence[Callable], buffer_size: int = 8,
               num_workers: Optional[int] = None,
               mapper: Optional[Callable] = None,
               instrument: Optional[bool] = None,
               trace_parent=None) -> Callable:
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

        yield from _run([make_source(i) for i in range(W)], buffer_size,
                        instrument=instrument, trace_parent=trace_parent)
    return data_reader
