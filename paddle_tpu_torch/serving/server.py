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
* **Retry** — each batch's model call runs inside a retry rim
  (``retry_policy``, by default 2 attempts): a failure that
  ``faults.classify`` calls retryable is tried once more before it
  fails the batch.  Fault-injection sites: ``serving.request`` at
  admission, ``serving.dispatch`` inside the rim.
* **Decode tenants** — :meth:`Server.add_decode_model` mounts a
  continuous-batching slot pool (``serving/decode.py``) beside the
  request tenants, under the same lifecycle, health and typed
  rejections; :meth:`Server.submit_decode` is its front door.
* **Health** — ``warming → ready → draining → stopped``.
* **Graceful drain** — :meth:`Server.shutdown` closes admission, lets
  every admitted request complete, then joins the threads.

Outputs come back as device tensors; the dispatcher moves each to the
host once per batch (bfloat16 widens to float32: numpy has no bfloat16)
and hands every request its own row.

Observability, with the ``observe`` flag on when the server is built
(read once, at construction): the ``serving/*`` counters
and histograms, ``serving`` events in the JSONL log, one
``serving/request`` span per request (its own trace, started at
admission, ended with the terminal status) and one ``serving/batch``
span per dispatched batch.  With it off no path of the server builds a
span or writes the registry or the log.  The locks come from the lock
watch (``testing/lockwatch.py``).

Not ported yet: the HTTP front and the fleet router (ROADMAP Queue A
item 9c).
"""
from __future__ import annotations

import collections
import logging
import queue as _queue_mod
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .. import faults as _faults
from .. import observability as obs
from ..core.executor import pad_batch, stack_feeds
from ..core.scope import to_numpy
from ..testing import faultinject as _fi
from ..testing import lockwatch as _lw
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
    error.  ``result()`` blocks; ``add_done_callback`` fires on the
    completing thread (or at once if already terminal).  ``t_admit`` is
    the admission time (``time.monotonic()``); ``dispatch_ms`` the model
    dispatch wall of the batch that served it (None until served);
    ``span`` its ``serving/request`` span, None when the runtime does
    not observe (completion then writes no metric either)."""

    __slots__ = ("id", "model", "feeds", "sig", "deadline", "t_admit",
                 "outputs", "error", "dispatch_ms", "span", "_event",
                 "_callbacks", "_lock")

    def __init__(self, req_id, model: str, feeds, deadline: Optional[float]):
        self.id = req_id
        self.model = model
        self.feeds = feeds
        self.sig = _feed_sig(feeds)
        self.deadline = deadline          # time.monotonic() or None
        self.t_admit = time.monotonic()
        self.outputs = None
        self.error: Optional[BaseException] = None
        self.dispatch_ms: Optional[float] = None
        self.span = None
        self._event = threading.Event()
        self._callbacks: List[Callable] = []
        self._lock = _lw.make_lock("serving.request")

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
            cbs, self._callbacks = self._callbacks, []
            self._event.set()
        if self.span is not None:
            obs.observe_hist("serving/request_ms",
                             (time.monotonic() - self.t_admit) * 1e3)
            self.span.end(status="ok" if error is None
                          else type(error).__name__)
        for cb in cbs:
            try:
                cb(self)
            except Exception:
                logger.exception("serving: response callback failed")
        return True

    def add_done_callback(self, cb: Callable):
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(cb)
                return
        cb(self)

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
        self.lock = _lw.make_lock("serving.rt")
        self.cond = _lw.make_condition("serving.rt", self.lock)
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

    def _note_batch_failure(self, err: BaseException, span=None):
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
            if self.srv.observe:
                obs.inc_counter("serving/breaker_open")
                obs.emit_event("serving", event="breaker_open",
                               model=self.model.name,
                               error=f"{type(err).__name__}: {err}")
            if span is not None:
                span.event("breaker_open",
                           error=f"{type(err).__name__}: {err}")
            logger.error("serving: circuit breaker OPEN for model %r "
                         "after %d consecutive failures (%s: %s)",
                         self.model.name, self.consecutive_failures,
                         type(err).__name__, err)

    def _note_batch_success(self, span=None):
        with self.lock:
            self.consecutive_failures = 0
            closed, self.breaker_open = self.breaker_open, False
        if closed:
            if self.srv.observe:
                obs.emit_event("serving", event="breaker_close",
                               model=self.model.name)
            if span is not None:
                span.event("breaker_close")
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
    disables admission bounds (with ``shed=False``, the no-robustness
    control arm of ``benchmark.serving``).  ``retry_policy``: the
    dispatch's retry rim (default 2 attempts, 5 ms backoff).
    The server writes its metrics, events and spans when the
    ``observe`` flag is on at construction; its decode tenants follow.
    """

    def __init__(self, max_batch: int = 32,
                 max_wait_ms: float = 5.0,
                 deadline_ms: Optional[float] = 100.0,
                 queue_capacity: Optional[int] = 256,
                 shed: bool = True,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 30.0,
                 staging_depth: int = 2,
                 retry_policy: Optional[_faults.RetryPolicy] = None,
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
        # a retryable failure is tried once more: 2 attempts in all
        self.retry_policy = retry_policy if retry_policy is not None else \
            _faults.RetryPolicy(max_attempts=2, backoff_base_s=0.005,
                                backoff_max_s=0.1, seed=0)
        self.buckets = _buckets(self.max_batch)
        self.warmup = bool(warmup)
        self.warmup_buckets = list(warmup_buckets) if warmup_buckets \
            else [self.buckets[0], self.buckets[-1]]
        self.observe = obs.enabled()
        self._models: Dict[str, _ModelRuntime] = {}
        self._decode: Dict[str, object] = {}   # name -> DecodeRuntime
        self._state = WARMING
        self._state_lock = _lw.make_lock("serving.server.state")
        self._req_counter = 0
        self._started = False

    # -- lifecycle -----------------------------------------------------------
    @property
    def state(self) -> str:
        return self._state

    def _set_state(self, state: str):
        with self._state_lock:
            self._state = state
        if self.observe:
            obs.emit_event("serving", event="state", state=state)

    def ready(self) -> bool:
        return self._state == READY

    def add_model(self, model: Model):
        if self._started:
            raise RuntimeError("Server.add_model: server already started")
        if model.name in self._models or model.name in self._decode:
            raise ValueError(f"duplicate model name {model.name!r}")
        self._models[model.name] = _ModelRuntime(model, self)

    def add_decode_model(self, engine, name: Optional[str] = None,
                         mode: str = "continuous",
                         step_wait_ms: Optional[float] = None,
                         retry_policy: Optional[_faults.RetryPolicy] = None,
                         autotune: Optional[bool] = None):
        """Mount an incremental-decode slot pool as a tenant: ``engine``
        is a :class:`~paddle_tpu_torch.serving.decode.DecodeEngine`;
        requests go through :meth:`submit_decode`.  The pool takes the
        server's deadline, shedding and breaker settings and shares its
        lifecycle (start, drain, shutdown, health)."""
        from .decode import DecodeRuntime   # decode imports this module
        if self._started:
            raise RuntimeError(
                "Server.add_decode_model: server already started")
        pool = DecodeRuntime(
            engine, name=name, mode=mode, step_wait_ms=step_wait_ms,
            default_deadline_ms=self.default_deadline_ms,
            queue_capacity=self.queue_capacity, shed=self.shed,
            breaker_threshold=self.breaker_threshold,
            breaker_cooldown_s=self.breaker_cooldown_s,
            retry_policy=(retry_policy if retry_policy is not None
                          else self.retry_policy),
            autotune=autotune, observe=self.observe)
        if pool.name in self._models or pool.name in self._decode:
            raise ValueError(f"duplicate model name {pool.name!r}")
        self._decode[pool.name] = pool
        return pool

    def start(self):
        """Warm up every tenant at the smallest and largest bucket, spawn
        its batcher/dispatcher pair, flip to ready."""
        if self._started:
            raise RuntimeError("Server.start: already started")
        if not self._models and not self._decode:
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
        for pool in self._decode.values():
            pool.start(warmup=self.warmup)
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
        for pool in self._decode.values():
            pool.close()

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
        for pool in self._decode.values():
            pool.shutdown(drain=drain,
                          timeout=None if deadline is None
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
               req_id=None, trace_parent=None) -> PendingResponse:
        """Admit one single-example request (feeds carry NO batch axis).

        Admission failures raise typed errors immediately:
        ``ServerClosed``, ``ModelUnavailable`` (breaker open),
        ``Overloaded`` (queue full and this request had the soonest
        deadline).  ``deadline_ms``: the default sentinel (-1) means the
        server default, ``None`` means no deadline.  ``trace_parent``: a
        remote caller's extracted trace context
        (``tracing.RemoteParent``), which the request span parents onto
        instead of starting a trace of its own."""
        rt = self._resolve_model(model)
        if _fi.ENABLED:
            action = _fi.check("serving.request")
            if action is not None:
                if action.startswith("delay"):
                    _, _, ms = action.partition(":")
                    time.sleep((float(ms) if ms else 50.0) / 1e3)
                else:
                    _fi.raise_for(action, "serving.request")
        if req_id is None:
            with self._state_lock:
                self._req_counter += 1
                req_id = self._req_counter
        # one trace per request, started before the admission checks so
        # every typed rejection reaches the log with its status; the span
        # ends at the terminal completion, or here on a rejection
        sp = obs.tracing.start_span(
            "serving/request",
            parent=trace_parent if trace_parent is not None
            else obs.tracing.ROOT,
            model=rt.model.name, id=req_id) if self.observe else None
        try:
            if self._state != READY:
                raise _faults.ServerClosed(
                    f"server is {self._state}; admission closed")
            if rt.breaker_state() == "open":
                raise _faults.ModelUnavailable(
                    f"model {rt.model.name!r}: circuit breaker open "
                    f"(repeated fatal dispatch errors); retry after "
                    f"cooldown")
            if deadline_ms == -1.0:
                deadline_ms = self.default_deadline_ms
            deadline = None if deadline_ms is None \
                else time.monotonic() + deadline_ms / 1e3
            req = PendingResponse(req_id, rt.model.name,
                                  rt.model.coerce_feeds(feeds), deadline)
            req.span = sp
            return self._admit(rt, req)
        except BaseException as e:
            if sp is not None:
                sp.end(status=type(e).__name__)
            raise

    def _admit(self, rt: _ModelRuntime, req: PendingResponse):
        shed_req = None
        with rt.cond:
            if rt.closed:
                raise _faults.ServerClosed(
                    f"server is {self._state}; admission closed")
            if (self.queue_capacity is not None
                    and len(rt.queue) >= self.queue_capacity):
                if not self.shed:
                    self._note_shed(rt, "incoming")
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
                    self._note_shed(rt, "incoming")
                    raise _faults.Overloaded(
                        f"model {rt.model.name!r}: queue full "
                        f"({self.queue_capacity}) and this request has "
                        f"the soonest deadline")
                rt.queue.remove(victim)
                shed_req = victim
            rt.queue.append(req)
            rt.cond.notify()
        if shed_req is not None:
            self._note_shed(rt, "queued")
            shed_req._complete(error=_faults.Overloaded(
                f"model {rt.model.name!r}: shed under overload "
                f"(oldest deadline first)"))
        if self.observe:
            obs.inc_counter("serving/requests")
        return req

    def _note_shed(self, rt: _ModelRuntime, victim: str):
        if self.observe:
            obs.inc_counter("serving/shed")
            obs.emit_event("serving", event="shed", model=rt.model.name,
                           victim=victim)

    def infer(self, feeds: Dict[str, object], model: Optional[str] = None,
              deadline_ms: Optional[float] = -1.0,
              timeout: Optional[float] = None):
        """Synchronous submit+wait; raises the typed error on rejection."""
        return self.submit(feeds, model=model,
                           deadline_ms=deadline_ms).result(timeout)

    def submit_decode(self, tokens, max_new_tokens: int,
                      model: Optional[str] = None,
                      deadline_ms: Optional[float] = -1.0,
                      req_id=None) -> PendingResponse:
        """Admit one generate request to a decode slot pool (see
        :meth:`add_decode_model`).  Completes with ``{"tokens", "finish",
        "ttft_ms", "inter_token_ms"}``; admission rejections raise the
        typed errors of :meth:`submit`."""
        if model is None:
            if len(self._decode) != 1:
                raise ValueError(
                    f"decode model name required (decode tenants: "
                    f"{sorted(self._decode)})")
            pool = next(iter(self._decode.values()))
        else:
            pool = self._decode.get(model)
            if pool is None:
                raise ValueError(
                    f"unknown decode model {model!r} (decode tenants: "
                    f"{sorted(self._decode)})")
        if self._state != READY:
            raise _faults.ServerClosed(
                f"server is {self._state}; admission closed")
        if deadline_ms == -1.0:
            deadline_ms = self.default_deadline_ms
        return pool.submit(tokens, max_new_tokens,
                           deadline_ms=deadline_ms, req_id=req_id)

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
        out = {"state": self._state, "ready": self.ready(),
               "models": models}
        if self._decode:
            out["decode"] = {name: pool.health()
                             for name, pool in self._decode.items()}
        return out

    # -- batcher -------------------------------------------------------------
    def _expire(self, req: PendingResponse, where: str) -> bool:
        """Complete an expired request with DeadlineExceeded; True if it
        was expired.  Never dispatched, never computed."""
        if not req.expired():
            return False
        if self.observe:
            obs.inc_counter("serving/deadline_expired")
            obs.emit_event("serving", event="deadline_expired",
                           model=req.model, where=where)
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
                    if self.observe:
                        obs.observe_hist("serving/queue_depth",
                                         len(rt.queue))
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
    def _dispatch_batch(self, rt: _ModelRuntime, padded, span=None):
        """One model call through the injection site and the retry rim."""
        def attempt():
            if _fi.ENABLED:
                action = _fi.check("serving.dispatch")
                if action is not None:
                    if action == "fatal":
                        raise _faults.InjectedFault(
                            "injected fatal fault at serving.dispatch")
                    _fi.raise_for(action, "serving.dispatch")
            return rt.model(padded)

        def on_retry(i, e, d):
            obs.inc_counter("fault/retries")
            obs.emit_event("fault", event="retry", site="serving.dispatch",
                           attempt=i + 1, delay_s=round(d, 4),
                           error=f"{type(e).__name__}: {e}")
            if span is not None:
                span.event("retry", attempt=i + 1, delay_s=round(d, 4),
                           error=f"{type(e).__name__}: {e}")

        if self.retry_policy is None:
            return attempt()
        return _faults.retry_call(
            attempt, self.retry_policy,
            what=f"serving dispatch [{rt.model.name}]",
            on_retry=on_retry if self.observe else None)

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
        # the batch's own trace (a join point, not a child of one
        # request), linking every member request's trace by id
        bsp = obs.tracing.start_span(
            "serving/batch", parent=obs.tracing.ROOT,
            model=rt.model.name, size=len(rows),
            bucket=next((int(v.shape[0]) for v in padded.values()), 0),
            requests=[r.id for _, r in rows],
            traces=[r.span.trace_id for _, r in rows
                    if r.span is not None]) if self.observe else None
        t0 = time.monotonic()
        try:
            outs = self._dispatch_batch(rt, padded, span=bsp)
            # to the host once per output, then one row per request; a
            # model whose outputs are not row-indexable is a model failure
            host = [None if o is None else to_numpy(o) for o in outs]
            split = [[None if h is None else np.array(h[i]) for h in host]
                     for i, _ in rows]
        except Exception as e:
            rt._note_batch_failure(e, span=bsp)
            err = ModelError(
                f"model {rt.model.name!r}: dispatch failed "
                f"({type(e).__name__}: {e})")
            for _, r in rows:
                r._complete(error=err)
            if bsp is not None:
                obs.emit_event("serving", event="error",
                               model=rt.model.name,
                               error=f"{type(e).__name__}: {e}")
                bsp.end(status=type(e).__name__)
            return
        dispatch_ms = (time.monotonic() - t0) * 1e3
        rt._note_batch_success(span=bsp)
        with rt.lock:
            rt.dispatched_batches += 1
            rt.served += len(rows)
        if bsp is not None:
            obs.inc_counter("serving/batches")
            obs.observe_hist("serving/batch_size", len(rows))
            obs.emit_event("serving", event="batch", model=rt.model.name,
                           size=len(rows), bucket=bsp.labels["bucket"],
                           dispatch_ms=round(dispatch_ms, 3))
        for (_, r), out in zip(rows, split):
            r.dispatch_ms = dispatch_ms
            r._complete(outputs=out)
        if bsp is not None:
            bsp.end(status="ok", dispatch_ms=round(dispatch_ms, 3))
