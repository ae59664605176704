"""Inference server: dynamic batching with a robustness envelope.

Counterpart of ``paddle_tpu/serving/server.py``, its batching data path.
Per model (one :class:`~paddle_tpu_torch.serving.model.Model` each):

    submit ──admission──▶ bounded queue ──batcher──▶ staged batches
                                              │  (stack_feeds + pad to
                                              │   bucket, double-buffered)
                                              ▼
                                        dispatcher ──▶ model fn ──▶ host,
                                                                    split rows,
                                                                    complete

* **Batching** — the batcher coalesces same-signature requests up to
  ``max_batch``, waiting at most ``max_wait_ms`` after the first one, and
  pads the stacked batch up to the next power-of-two bucket.  A bounded
  staging queue double-buffers batcher and dispatcher.
* **Deadlines** — a request expired at batch formation or at dispatch
  completes with :class:`~paddle_tpu_torch.faults.DeadlineExceeded` and
  is never computed.
* **Admission control** — the queue is bounded; when full, the request
  with the soonest deadline is rejected with ``Overloaded``.
* **Circuit breaking** — after ``breaker_threshold`` consecutive failed
  batches a model's breaker opens and its requests fail fast with
  ``ModelUnavailable`` until a probe after the cooldown succeeds.
* **Health** — ``warming → ready → draining → stopped``.
* **Graceful drain** — :meth:`Server.shutdown` closes admission, lets
  every admitted request complete, then joins the threads.

Outputs come back as device tensors; the dispatcher moves each to the
host once per batch (bfloat16 widens to float32: numpy has no bfloat16)
and hands every request its own row.

Not ported yet: retries, fault injection, metrics and tracing, decode
tenants, the HTTP front and the fleet router.
"""
from __future__ import annotations

import collections
import logging
import queue as _queue_mod
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import faults as _faults
from ..core.executor import pad_batch, stack_feeds
from ..core.scope import to_numpy
from .model import Model

logger = logging.getLogger("paddle_tpu_torch")

__all__ = ["Server", "PendingResponse", "ModelError"]

# health states, in lifecycle order
WARMING, READY, DRAINING, STOPPED = "warming", "ready", "draining", "stopped"


class ModelError(RuntimeError):
    """A dispatched batch failed; carries the underlying error string.
    The request was computed-and-lost, not shed."""


def _buckets(max_batch: int) -> List[int]:
    """Power-of-two bucket sizes up to (and always including) max_batch."""
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


def _bucket_for(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _feed_sig(feeds: Dict[str, np.ndarray]):
    return tuple(sorted((k, v.shape, str(v.dtype)) for k, v in feeds.items()))


class PendingResponse:
    """Future-like handle for one admitted request.  Terminal exactly
    once: either ``outputs`` (a list of per-request arrays) or a typed
    error.  ``result()`` blocks."""

    __slots__ = ("id", "model", "feeds", "sig", "deadline", "outputs",
                 "error", "_event", "_lock")

    def __init__(self, req_id, model: str, feeds, deadline: Optional[float]):
        self.id = req_id
        self.model = model
        self.feeds = feeds
        self.sig = _feed_sig(feeds)
        self.deadline = deadline          # time.monotonic() or None
        self.outputs = None
        self.error: Optional[BaseException] = None
        self._event = threading.Event()
        self._lock = threading.Lock()

    def expired(self, now: Optional[float] = None) -> bool:
        return (self.deadline is not None
                and (now if now is not None else time.monotonic())
                >= self.deadline)

    def done(self) -> bool:
        return self._event.is_set()

    def _complete(self, outputs=None, error: Optional[BaseException] = None):
        with self._lock:
            if self._event.is_set():
                return False
            self.outputs = outputs
            self.error = error
            self._event.set()
        return True

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.id!r}: no response within {timeout}s")
        if self.error is not None:
            raise self.error
        return self.outputs


class _ModelRuntime:
    """Per-tenant state: admission queue, batcher + dispatcher threads,
    circuit breaker."""

    def __init__(self, model: Model, server: "Server"):
        self.model = model
        self.srv = server
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.queue: collections.deque = collections.deque()
        self.staging: _queue_mod.Queue = _queue_mod.Queue(
            maxsize=max(1, server.staging_depth))
        self.batcher: Optional[threading.Thread] = None
        self.dispatcher: Optional[threading.Thread] = None
        self.closed = False               # no more admissions (drain/stop)
        self.consecutive_failures = 0
        self.breaker_open = False
        self.breaker_open_until = 0.0     # monotonic; probe allowed after
        self.served = 0
        self.dispatched_batches = 0

    def breaker_state(self, now: Optional[float] = None) -> str:
        with self.lock:
            if not self.breaker_open:
                return "closed"
            now = time.monotonic() if now is None else now
            return "half_open" if now >= self.breaker_open_until else "open"

    def _note_batch_failure(self, err: BaseException):
        with self.lock:
            self.consecutive_failures += 1
            opened = (self.consecutive_failures >= self.srv.breaker_threshold
                      and not self.breaker_open)
            if opened:
                self.breaker_open = True
            if self.breaker_open:
                self.breaker_open_until = (time.monotonic()
                                           + self.srv.breaker_cooldown_s)
        if opened:
            logger.error("serving: circuit breaker OPEN for model %r "
                         "after %d consecutive failures (%s: %s)",
                         self.model.name, self.consecutive_failures,
                         type(err).__name__, err)

    def _note_batch_success(self):
        with self.lock:
            self.consecutive_failures = 0
            closed, self.breaker_open = self.breaker_open, False
        if closed:
            logger.info("serving: circuit breaker closed for model %r "
                        "(probe succeeded)", self.model.name)


class Server:
    """In-process multi-tenant inference server (see module docstring).

    Minimal use::

        srv = Server(max_batch=32, max_wait_ms=5)
        srv.add_model(Model.from_program(exe, infer_prog, [pred]))
        srv.start()
        out = srv.infer({"img": example}, timeout=1.0)
        srv.shutdown()                                   # graceful drain

    ``deadline_ms=None`` disables deadlines; ``queue_capacity=None``
    disables admission bounds.
    """

    def __init__(self, max_batch: int = 32,
                 max_wait_ms: float = 5.0,
                 deadline_ms: Optional[float] = 100.0,
                 queue_capacity: Optional[int] = 256,
                 shed: bool = True,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 30.0,
                 staging_depth: int = 2,
                 warmup: bool = True,
                 warmup_buckets: Optional[Sequence[int]] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if queue_capacity is not None and queue_capacity < 1:
            raise ValueError(
                f"queue_capacity must be >= 1 or None, got {queue_capacity}")
        if breaker_threshold < 1:
            raise ValueError(
                f"breaker_threshold must be >= 1, got {breaker_threshold}")
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.default_deadline_ms = deadline_ms
        self.queue_capacity = queue_capacity
        self.shed = bool(shed)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.staging_depth = int(staging_depth)
        self.buckets = _buckets(self.max_batch)
        self.warmup = bool(warmup)
        self.warmup_buckets = list(warmup_buckets) if warmup_buckets \
            else [self.buckets[0], self.buckets[-1]]
        self._models: Dict[str, _ModelRuntime] = {}
        self._state = WARMING
        self._state_lock = threading.Lock()
        self._req_counter = 0
        self._started = False

    # -- lifecycle -----------------------------------------------------------
    @property
    def state(self) -> str:
        return self._state

    def _set_state(self, state: str):
        with self._state_lock:
            self._state = state

    def ready(self) -> bool:
        return self._state == READY

    def add_model(self, model: Model):
        if self._started:
            raise RuntimeError("Server.add_model: server already started")
        if model.name in self._models:
            raise ValueError(f"duplicate model name {model.name!r}")
        self._models[model.name] = _ModelRuntime(model, self)

    def start(self):
        """Warm up every tenant at the smallest and largest bucket, spawn
        its batcher/dispatcher pair, flip to ready."""
        if self._started:
            raise RuntimeError("Server.start: already started")
        if not self._models:
            raise ValueError("Server.start: no models added")
        self._started = True
        self._set_state(WARMING)
        for rt in self._models.values():
            if self.warmup and rt.model.example is not None:
                for b in self.warmup_buckets:
                    outs = rt.model(pad_batch(stack_feeds([rt.model.example]),
                                              b))
                    for o in outs:                     # block: real warmup
                        if o is not None:
                            to_numpy(o)
            rt.batcher = threading.Thread(
                target=self._batch_loop, args=(rt,),
                name=f"pt-serving-batch-{rt.model.name}", daemon=True)
            rt.dispatcher = threading.Thread(
                target=self._dispatch_loop, args=(rt,),
                name=f"pt-serving-dispatch-{rt.model.name}", daemon=True)
            rt.batcher.start()
            rt.dispatcher.start()
        self._set_state(READY)
        return self

    def begin_drain(self):
        """Close admission; keep completing admitted work.  Idempotent."""
        if self._state in (DRAINING, STOPPED):
            return
        self._set_state(DRAINING)
        for rt in self._models.values():
            with rt.cond:
                rt.closed = True
                rt.cond.notify_all()

    def shutdown(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop the server.  ``drain=True``: admission closes, every
        admitted request completes, then the threads join.
        ``drain=False``: queued requests complete with ``ServerClosed``;
        the in-flight batch still finishes."""
        if not self._started:
            self._set_state(STOPPED)
            return
        if not drain:
            self._set_state(DRAINING)
            for rt in self._models.values():
                with rt.cond:
                    rt.closed = True
                    aborted = list(rt.queue)
                    rt.queue.clear()
                    rt.cond.notify_all()
                for r in aborted:
                    r._complete(error=_faults.ServerClosed(
                        "server stopped before this request was dispatched"))
        else:
            self.begin_drain()
        deadline = None if timeout is None else time.monotonic() + timeout
        for rt in self._models.values():
            for t in (rt.batcher, rt.dispatcher):
                if t is not None:
                    t.join(None if deadline is None
                           else max(0.0, deadline - time.monotonic()))
        self._set_state(STOPPED)

    # -- admission -----------------------------------------------------------
    def _resolve_model(self, model: Optional[str]) -> _ModelRuntime:
        if model is None:
            if len(self._models) != 1:
                raise ValueError(
                    f"model name required (tenants: {sorted(self._models)})")
            return next(iter(self._models.values()))
        rt = self._models.get(model)
        if rt is None:
            raise ValueError(f"unknown model {model!r} "
                             f"(tenants: {sorted(self._models)})")
        return rt

    def submit(self, feeds: Dict[str, object], model: Optional[str] = None,
               deadline_ms: Optional[float] = -1.0,
               req_id=None) -> PendingResponse:
        """Admit one single-example request (feeds carry NO batch axis).

        Admission failures raise typed errors immediately:
        ``ServerClosed``, ``ModelUnavailable`` (breaker open),
        ``Overloaded`` (queue full and this request had the soonest
        deadline).  ``deadline_ms``: the default sentinel (-1) means the
        server default, ``None`` means no deadline."""
        rt = self._resolve_model(model)
        if req_id is None:
            with self._state_lock:
                self._req_counter += 1
                req_id = self._req_counter
        if self._state != READY:
            raise _faults.ServerClosed(
                f"server is {self._state}; admission closed")
        if rt.breaker_state() == "open":
            raise _faults.ModelUnavailable(
                f"model {rt.model.name!r}: circuit breaker open (repeated "
                f"fatal dispatch errors); retry after cooldown")
        if deadline_ms == -1.0:
            deadline_ms = self.default_deadline_ms
        deadline = None if deadline_ms is None \
            else time.monotonic() + deadline_ms / 1e3
        req = PendingResponse(req_id, rt.model.name,
                              rt.model.coerce_feeds(feeds), deadline)
        return self._admit(rt, req)

    def _admit(self, rt: _ModelRuntime, req: PendingResponse):
        shed_req = None
        with rt.cond:
            if rt.closed:
                raise _faults.ServerClosed(
                    f"server is {self._state}; admission closed")
            if (self.queue_capacity is not None
                    and len(rt.queue) >= self.queue_capacity):
                if not self.shed:
                    raise _faults.Overloaded(
                        f"model {rt.model.name!r}: queue full "
                        f"({self.queue_capacity})")
                # oldest-deadline-first: shed the soonest deadline among
                # queued + incoming; deadline-less requests are never
                # preferred as victims
                victim = min(
                    [r for r in list(rt.queue) + [req]
                     if r.deadline is not None],
                    key=lambda r: r.deadline,
                    default=req)
                if victim is req:
                    raise _faults.Overloaded(
                        f"model {rt.model.name!r}: queue full "
                        f"({self.queue_capacity}) and this request has "
                        f"the soonest deadline")
                rt.queue.remove(victim)
                shed_req = victim
            rt.queue.append(req)
            rt.cond.notify()
        if shed_req is not None:
            shed_req._complete(error=_faults.Overloaded(
                f"model {rt.model.name!r}: shed under overload "
                f"(oldest deadline first)"))
        return req

    def infer(self, feeds: Dict[str, object], model: Optional[str] = None,
              deadline_ms: Optional[float] = -1.0,
              timeout: Optional[float] = None):
        """Synchronous submit+wait; raises the typed error on rejection."""
        return self.submit(feeds, model=model,
                           deadline_ms=deadline_ms).result(timeout)

    # -- health --------------------------------------------------------------
    def health(self) -> dict:
        models = {}
        for name, rt in self._models.items():
            with rt.lock:
                depth, served, batches = (len(rt.queue), rt.served,
                                          rt.dispatched_batches)
            models[name] = {"breaker": rt.breaker_state(),
                            "queue_depth": depth, "served": served,
                            "batches": batches}
        return {"state": self._state, "ready": self.ready(),
                "models": models}

    # -- batcher -------------------------------------------------------------
    def _expire(self, req: PendingResponse, where: str) -> bool:
        """Complete an expired request with DeadlineExceeded; True if it
        was expired.  Never dispatched, never computed."""
        if not req.expired():
            return False
        req._complete(error=_faults.DeadlineExceeded(
            f"request {req.id!r}: deadline expired before {where}"))
        return True

    def _batch_loop(self, rt: _ModelRuntime):
        """Coalesce queued requests into staged batches until drained."""
        try:
            while True:
                with rt.cond:
                    while not rt.queue and not rt.closed:
                        rt.cond.wait(timeout=0.1)
                    if not rt.queue and rt.closed:
                        break
                    first = rt.queue.popleft()
                if self._expire(first, "batching"):
                    continue
                batch = [first]
                wait_until = time.monotonic() + self.max_wait_s
                while len(batch) < self.max_batch:
                    with rt.cond:
                        # only same-signature requests can stack; others
                        # stay queued, order preserved
                        got = mismatched = None
                        for r in rt.queue:
                            if r.sig == first.sig:
                                got = r
                                break
                            mismatched = r
                        if got is not None:
                            rt.queue.remove(got)
                    if got is not None:
                        if not self._expire(got, "batching"):
                            batch.append(got)
                        continue
                    if mismatched is not None:
                        break       # ship now; its batch starts next
                    if rt.closed:       # draining: no waiting for stragglers
                        break
                    remaining = wait_until - time.monotonic()
                    if remaining <= 0:
                        break
                    with rt.cond:
                        if not rt.queue:
                            rt.cond.wait(timeout=remaining)
                live = [r for r in batch
                        if not self._expire(r, "batching")]
                if not live:
                    continue
                stacked = stack_feeds([r.feeds for r in live])
                padded = pad_batch(stacked,
                                   _bucket_for(len(live), self.buckets))
                rt.staging.put((live, padded))
        except BaseException:
            logger.exception("serving: batcher for model %r died",
                             rt.model.name)
        finally:
            rt.staging.put(None)        # dispatcher drain sentinel

    # -- dispatcher ----------------------------------------------------------
    def _dispatch_loop(self, rt: _ModelRuntime):
        while True:
            item = rt.staging.get()
            if item is None:
                break
            live, padded = item
            try:
                self._dispatch_one(rt, live, padded)
            except BaseException as e:   # noqa: BLE001 — containment:
                # a dispatcher death would wedge the staging queue and hang
                # shutdown(drain=True); every request of the batch gets a
                # terminal error instead
                logger.exception("serving: dispatcher for model %r hit an "
                                 "unexpected error", rt.model.name)
                err = ModelError(
                    f"model {rt.model.name!r}: internal dispatch error "
                    f"({type(e).__name__}: {e})")
                for r in live:
                    r._complete(error=err)

    def _dispatch_one(self, rt: _ModelRuntime, live, padded):
        # deadline re-check at the dispatch rim: staging adds wait
        rows = [(i, r) for i, r in enumerate(live)
                if not self._expire(r, "dispatch")]
        if not rows:
            return
        if rt.breaker_state() == "open":
            for _, r in rows:
                r._complete(error=_faults.ModelUnavailable(
                    f"model {rt.model.name!r}: circuit breaker open"))
            return
        try:
            outs = rt.model(padded)
            # to the host once per output, then one row per request; a
            # model whose outputs are not row-indexable is a model failure
            host = [None if o is None else to_numpy(o) for o in outs]
            split = [[None if h is None else np.array(h[i]) for h in host]
                     for i, _ in rows]
        except Exception as e:
            rt._note_batch_failure(e)
            err = ModelError(
                f"model {rt.model.name!r}: dispatch failed "
                f"({type(e).__name__}: {e})")
            for _, r in rows:
                r._complete(error=err)
            return
        rt._note_batch_success()
        with rt.lock:
            rt.dispatched_batches += 1
            rt.served += len(rows)
        for (_, r), out in zip(rows, split):
            r._complete(outputs=out)
