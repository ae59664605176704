"""Serving fleet: N server replicas behind a queue-depth-aware router,
with supervisor-backed relaunch and metric-driven replica autoscaling
(counterpart of ``paddle_tpu/serving/fleet.py``).

The reference framework's serving story is the C inference API deployed
behind a web service; one process, however robust, is not a fleet.  This
module horizontally scales the serving runtime as library code:

* **Replicas** — :class:`LocalReplica` wraps an in-process
  :class:`~paddle_tpu_torch.serving.server.Server` (tests, single-process
  ``serve --http``); :class:`ProcessReplica` supervises one
  ``python -m paddle_tpu_torch serve`` subprocess over its stdio JSON
  protocol, including the ``{"cmd": "health"}`` control-plane poll.  On
  one card every replica process holds its own CUDA context, caching
  allocator and captured graphs; their kernels time-slice the card.
* **Router** (:class:`FleetRouter`) — load-balances ``submit()`` onto
  the *ready* replica with the lowest live ``serving/queue_depth``
  (health-polled, plus the requests routed since the last poll).
  Replicas leave the routable set (an **eviction**) when their health
  state leaves ``ready`` (draining/stopped), their circuit breaker
  opens, their health goes stale, or they die — and re-enter it when
  the condition clears.  A replica that dies with admitted requests
  in flight triggers **failover**: every lost request is resubmitted
  to a surviving replica (inference is stateless), so a SIGKILL under
  load drops zero admitted requests fleet-wide.  Signal-dead replicas
  are relaunched through the supervisor's bounded-restart accounting
  (:meth:`~paddle_tpu_torch.distributed.supervisor.Supervisor.
  relaunch_gate`) with exponential backoff.
* **Autoscaler** (:class:`AutoscalePolicy` + the router's autoscale
  thread) — scale-out triggers when the queue-wait share of the rolling
  p99 (the live form of the doctor's ``serving_budget`` decomposition:
  ``wait = total - dispatch`` per completed request) exceeds a
  threshold: latency dominated by queueing means more replicas help;
  latency dominated by dispatch means they don't.  Sustained idle
  (empty queues, per-replica rate under a floor) scales in through
  graceful drain.  Every decision lands as a ``fleet`` JSONL event and
  a ``fleet/autoscale`` span, so the trace, doctor and summary readers
  attribute fleet behavior.

The stdio wire carries feeds as nested JSON lists (the JAX package's
protocol): the router encodes each request and the replica parses it,
both on the host.

Clients only ever see the server's typed rejections (``Overloaded``,
``DeadlineExceeded``, ``ServerClosed``, ``ModelUnavailable``) plus
``ModelError`` — replica loss is an internal failover, not a client
error.

ZERO COST WHEN UNUSED: nothing in ``paddle_tpu_torch`` — including
``paddle_tpu_torch.serving`` itself — imports this module at top level
(``tests/test_torch_imports.py`` enforces it); only the ``fleet`` CLI and
explicit imports pay for it.
"""
from __future__ import annotations

import collections
import json
import logging
import os
import queue as _queue_mod
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from .. import faults as _faults
from .. import observability as obs
from ..distributed.supervisor import Supervisor
from ..testing import lockwatch as _lw
from .server import Server
from .server import ModelError as _ModelError

logger = logging.getLogger("paddle_tpu_torch")

__all__ = ["FleetRouter", "AutoscalePolicy", "LocalReplica",
           "ProcessReplica", "serve_argv"]

# replica lifecycle: the server's health states plus the fleet-only terminal
DEAD = "dead"

# wire error name -> typed exception (the stdio protocol's error lines)
_WIRE_ERRORS = {
    "Overloaded": _faults.Overloaded,
    "DeadlineExceeded": _faults.DeadlineExceeded,
    "ServerClosed": _faults.ServerClosed,
    "ModelUnavailable": _faults.ModelUnavailable,
}


class ReplicaGone(_faults.TransientError):
    """Internal: the replica holding this request died before answering.
    Routed requests never surface this — the router fails over to a
    surviving replica or completes with a public typed error."""


def serve_argv(model_args: Sequence[str], *, max_batch: Optional[int] = None,
               max_wait_ms: Optional[float] = None,
               deadline_ms: Optional[float] = None,
               queue: Optional[int] = None, warmup_all: bool = False,
               device: Optional[str] = None,
               extra: Sequence[str] = ()) -> List[str]:
    """The ``python -m paddle_tpu_torch serve`` command line for one
    replica — the same artifacts/flags for every member of the fleet.
    ``device`` (``cuda``/``cpu``; None: serve's default, the card)."""
    argv = [sys.executable, "-m", "paddle_tpu_torch", "serve"]
    for m in model_args:
        argv += ["--model", m]
    if device is not None:
        argv += ["--device", device]
    if max_batch is not None:
        argv += ["--max-batch", str(max_batch)]
    if max_wait_ms is not None:
        argv += ["--max-wait-ms", str(max_wait_ms)]
    if deadline_ms is not None:
        argv += ["--deadline-ms", str(deadline_ms)]
    if queue is not None:
        argv += ["--queue", str(queue)]
    if warmup_all:
        argv += ["--warmup-all"]
    return argv + list(extra)


class FleetPending:
    """Future-like handle for one fleet-routed request.  Stable across
    failover: the client holds ONE handle while the router may carry the
    request through several replicas.  Terminal exactly once."""

    __slots__ = ("id", "model", "feeds", "deadline_ms", "outputs", "error",
                 "dispatch_ms", "t_admit", "attempts", "_event",
                 "_callbacks", "_lock", "ctx")

    def __init__(self, req_id, model: Optional[str], feeds,
                 deadline_ms, ctx: Optional[str] = None):
        self.id = req_id
        self.model = model
        self.feeds = feeds
        self.deadline_ms = deadline_ms
        # wire trace context captured at admission (None when the router
        # is not observing): survives failover, so a request re-routed
        # to a second replica still joins the same trace
        self.ctx = ctx
        self.outputs = None
        self.error: Optional[BaseException] = None
        self.dispatch_ms: Optional[float] = None
        self.t_admit = time.monotonic()
        self.attempts = 0            # replicas this request was offered to
        self._event = threading.Event()
        self._callbacks: List[Callable] = []
        self._lock = _lw.make_lock("fleet.request")

    def done(self) -> bool:
        return self._event.is_set()

    def _complete(self, outputs=None, error=None, dispatch_ms=None):
        with self._lock:
            if self._event.is_set():
                return False
            self.outputs = outputs
            self.error = error
            self.dispatch_ms = dispatch_ms
            cbs, self._callbacks = self._callbacks, []
            self._event.set()
        for cb in cbs:
            try:
                cb(self)
            except Exception:
                logger.exception("fleet: response callback failed")
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


# ---------------------------------------------------------------------------
# replicas
# ---------------------------------------------------------------------------
class LocalReplica:
    """One in-process :class:`~paddle_tpu_torch.serving.server.Server` as
    a fleet member — the fast path for tests and single-process fronts."""

    def __init__(self, server: Server, name: str = "local"):
        self.server = server
        self.name = name
        self.routed_since_poll = 0
        self.last_health: dict = {}
        self.last_health_ts = time.monotonic()
        self.last_metrics: Optional[dict] = None
        self.last_metrics_ts = 0.0
        self.last_identity: Optional[dict] = None
        self.restarts = 0
        self.cordoned = False

    # -- surface shared with ProcessReplica ---------------------------------
    @property
    def alive(self) -> bool:
        return self.server.state not in ("stopped",)

    @property
    def state(self) -> str:
        return self.server.state

    def poll_health(self, metrics: bool = False):
        self.last_health = self.server.health()
        self.last_health_ts = time.monotonic()
        self.routed_since_poll = 0
        if metrics:
            # in-process member: its registry IS this process's registry
            self.last_metrics = obs.metrics_snapshot()
            self.last_metrics_ts = self.last_health_ts
            self.last_identity = {"role": "local", "pid": os.getpid()}

    def queue_depth(self) -> int:
        models = (self.last_health or {}).get("models", {})
        return sum(int(m.get("queue_depth", 0)) for m in models.values())

    def breaker_open(self, model: Optional[str]) -> bool:
        models = (self.last_health or {}).get("models", {})
        if model is not None:
            return models.get(model, {}).get("breaker") == "open"
        return any(m.get("breaker") == "open" for m in models.values())

    def submit(self, fp: FleetPending):
        """Admit ``fp``; terminal results (or typed errors raised here at
        admission) propagate through the router's completion path."""
        pending = self.server.submit(
            fp.feeds, model=fp.model, deadline_ms=fp.deadline_ms,
            req_id=fp.id,
            trace_parent=obs.tracing.extract(fp.ctx)
            if fp.ctx is not None else None)
        self.routed_since_poll += 1

        def relay(p):
            err = p.error
            if isinstance(err, _faults.ServerClosed):
                # the replica aborted an admitted request (non-drain
                # shutdown / death): internal loss, let the router
                # fail it over instead of surfacing the abort
                err = ReplicaGone(str(err))
            if err is not None:
                self._terminal(fp, error=err)
            else:
                self._terminal(fp, outputs=p.outputs,
                               dispatch_ms=p.dispatch_ms)

        pending.add_done_callback(relay)

    def _terminal(self, fp, **kw):
        # bound by the router at registration; LocalReplica keeps the
        # hook so both replica kinds share one completion path
        self.on_terminal(fp, **kw)

    on_terminal: Callable = None    # set by the router

    def begin_drain(self):
        """Graceful: admission closes now; a background thread finishes
        the drain so the replica reaches ``stopped`` (and the router's
        reaper) once every admitted request completes — the in-process
        analog of the serve CLI's SIGTERM path."""
        self.server.begin_drain()
        threading.Thread(
            target=lambda: self.server.shutdown(drain=True),
            name=f"pt-fleet-drain-{self.name}", daemon=True).start()

    def stop(self, drain: bool = True):
        self.server.shutdown(drain=drain)

    def kill(self):
        """Abrupt death for tests: queued admitted work is aborted (the
        router sees ReplicaGone and fails over).  Bounded join: a
        dispatch wedged mid-batch must not block the killer."""
        self.server.shutdown(drain=False, timeout=5.0)


class ProcessReplica:
    """One ``python -m paddle_tpu_torch serve`` subprocess as a fleet
    member, driven over its stdio JSON protocol.

    A reader thread dispatches stdout lines: responses complete routed
    requests, ``health`` answers refresh the routing signal, ``state``
    events track the replica lifecycle.  Only whole lines are read: a
    line cut short by a SIGKILL is dropped.  EOF with requests in flight
    marks the replica :data:`DEAD` and hands every lost request back to
    the router for failover.  ``cpu_affinity`` pins the child to fixed
    cores — the fleet benchmark's "identical per-replica resources"
    control.  ``ready_timeout_s`` bounds :meth:`wait_ready`: a replica
    on the card pays CUDA init, the artifact load and one warm-up per
    bucket before it is ready."""

    def __init__(self, argv: Sequence[str], name: str,
                 env: Optional[dict] = None,
                 cpu_affinity: Optional[Sequence[int]] = None,
                 ready_timeout_s: float = 300.0):
        self.argv = list(argv)
        self.name = name
        self.env = dict(env) if env is not None else None
        self.cpu_affinity = list(cpu_affinity) if cpu_affinity else None
        self.ready_timeout_s = ready_timeout_s
        self.proc: Optional[subprocess.Popen] = None
        self.state = "warming"
        self.last_health: dict = {}
        self.last_health_ts = 0.0
        self.last_metrics: Optional[dict] = None
        self.last_metrics_ts = 0.0
        self.last_identity: Optional[dict] = None
        self.routed_since_poll = 0
        self.restarts = 0
        self.deliberate_stop = False
        self.cordoned = False
        self._wire = 0
        self._pending: Dict[str, FleetPending] = {}
        self._lock = _lw.make_lock("fleet.replica")
        self._reader: Optional[threading.Thread] = None
        # outbound lines drain on a dedicated writer thread: a full
        # stdin pipe (slow replica) must never block the router's
        # submit path — head-of-line blocking there throttles the whole
        # fleet to the slowest replica's pipe
        self._outq: Optional[_queue_mod.Queue] = None
        self._writer: Optional[threading.Thread] = None

    on_terminal: Callable = None    # set by the router
    on_death: Callable = None       # set by the router (lost fps)

    # -- lifecycle -----------------------------------------------------------
    def spawn(self):
        if self.proc is not None and self.proc.poll() is None:
            raise RuntimeError(f"replica {self.name}: already running")
        preexec = None
        if self.cpu_affinity and hasattr(os, "sched_setaffinity"):
            cores = set(self.cpu_affinity)

            def preexec():          # noqa: F811 — child-side pin
                os.sched_setaffinity(0, cores)
        self.state = "warming"
        self.deliberate_stop = False
        self.proc = subprocess.Popen(
            self.argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True, env=self.env, preexec_fn=preexec)
        self._outq = _queue_mod.Queue()
        self._reader = threading.Thread(
            target=self._read_loop, name=f"pt-fleet-read-{self.name}",
            daemon=True)
        self._reader.start()
        self._writer = threading.Thread(
            target=self._write_loop, args=(self.proc, self._outq),
            name=f"pt-fleet-write-{self.name}", daemon=True)
        self._writer.start()
        obs.emit_event("fleet", event="replica_spawn", replica=self.name,
                       pid=self.proc.pid)
        return self

    def wait_ready(self, timeout_s: Optional[float] = None) -> bool:
        deadline = time.monotonic() + (timeout_s if timeout_s is not None
                                       else self.ready_timeout_s)
        while time.monotonic() < deadline:
            if self.state == "ready":
                return True
            if self.state == DEAD:
                return False
            time.sleep(0.02)
        return False

    @property
    def alive(self) -> bool:
        return (self.proc is not None and self.proc.poll() is None
                and self.state not in (DEAD, "stopped"))

    # -- wire ----------------------------------------------------------------
    def _send(self, obj: dict) -> bool:
        """Enqueue one line for the writer thread; never blocks on the
        pipe.  False only when the replica is already known-dead (a
        line enqueued to a dying replica is recovered by the reader's
        EOF -> on_death failover, not here)."""
        proc, outq = self.proc, self._outq
        if proc is None or outq is None or proc.poll() is not None:
            return False
        outq.put(json.dumps(obj, default=repr))
        return True

    def _write_loop(self, proc, outq):
        try:
            while True:
                line = outq.get()
                if line is None:
                    return
                proc.stdin.write(line + "\n")
                proc.stdin.flush()
        except (BrokenPipeError, ValueError, OSError):
            return          # replica gone: reader EOF owns the cleanup

    def _read_loop(self):
        proc = self.proc
        try:
            for raw in proc.stdout:
                if not raw.endswith("\n"):
                    continue    # cut short at the pipe's end: never whole
                try:
                    msg = json.loads(raw)
                except json.JSONDecodeError:
                    continue
                self._on_message(msg)
        except (ValueError, OSError):
            pass
        # EOF: drain or death — the exit status decides, the router's
        # monitor relaunches if it was a signal
        rc = proc.wait()
        if self._outq is not None:
            self._outq.put(None)        # retire this spawn's writer
        self.state = "stopped" if (rc == 0 or self.deliberate_stop) else DEAD
        lost = self._take_pending()
        if lost:
            logger.warning("fleet: replica %s exited rc=%s with %d "
                           "requests in flight", self.name, rc, len(lost))
        if self.on_death is not None:
            self.on_death(self, rc, lost)

    def _take_pending(self) -> List[FleetPending]:
        with self._lock:
            lost = list(self._pending.values())
            self._pending.clear()
        return lost

    def _on_message(self, msg: dict):
        if "health" in msg and isinstance(msg.get("health"), dict):
            self.last_health = msg["health"]
            self.last_health_ts = time.monotonic()
            self.routed_since_poll = 0
            if isinstance(msg.get("metrics"), dict):
                # opt-in piggyback answered by serve's health handler
                self.last_metrics = msg["metrics"]
                self.last_metrics_ts = self.last_health_ts
                self.last_identity = msg.get("identity")
            st = msg["health"].get("state")
            if st and self.state not in (DEAD,):
                self.state = st
            return
        if msg.get("event") == "state":
            st = msg.get("state")
            if st and self.state not in (DEAD,):
                self.state = st
            return
        if "id" not in msg or msg.get("event") is not None:
            return
        with self._lock:
            fp = self._pending.pop(msg["id"], None)
        if fp is None:
            return
        if "error" in msg:
            err_cls = _WIRE_ERRORS.get(msg["error"])
            message = msg.get("message", msg["error"])
            if err_cls is not None:
                err = err_cls(message)
                if isinstance(err, _faults.ServerClosed):
                    # admitted-then-aborted: internal loss -> failover
                    err = ReplicaGone(message)
            elif msg["error"] == "BadRequest":
                err = ValueError(message)
            else:
                err = _ModelError(f"{msg['error']}: {message}")
            self.on_terminal(fp, error=err)
        else:
            outs = msg.get("outputs") or []
            self.on_terminal(fp, outputs=outs,
                             dispatch_ms=msg.get("dispatch_ms"))

    # -- router surface ------------------------------------------------------
    @property
    def local_backlog(self) -> int:
        """Requests accepted by :meth:`submit` but still waiting in the
        writer queue — part of the routing score (a fresh health poll
        resets routed_since_poll, but these are not on the wire yet)."""
        outq = self._outq
        return outq.qsize() if outq is not None else 0

    def poll_health(self, metrics: bool = False):
        msg = {"cmd": "health"}
        if metrics:
            msg["metrics"] = True
        if not self._send(msg):
            return
        # answer arrives asynchronously on the reader thread

    def queue_depth(self) -> int:
        models = (self.last_health or {}).get("models", {})
        return sum(int(m.get("queue_depth", 0)) for m in models.values())

    def breaker_open(self, model: Optional[str]) -> bool:
        models = (self.last_health or {}).get("models", {})
        if model is not None:
            return models.get(model, {}).get("breaker") == "open"
        return any(m.get("breaker") == "open" for m in models.values())

    def submit(self, fp: FleetPending):
        self._wire += 1
        wire_id = f"{self.name}-{self._wire}"
        msg = {"id": wire_id, "feeds": _wire_feeds(fp.feeds)}
        if fp.model is not None:
            msg["model"] = fp.model
        if fp.deadline_ms != -1.0:      # -1 = replica default, omit
            msg["deadline_ms"] = fp.deadline_ms
        if fp.ctx is not None:          # observing caller: propagate
            msg["ctx"] = fp.ctx
        with self._lock:
            self._pending[wire_id] = fp
        if not self._send(msg):
            with self._lock:
                self._pending.pop(wire_id, None)
            raise ReplicaGone(f"replica {self.name}: not accepting input")
        self.routed_since_poll += 1

    def begin_drain(self):
        """Graceful: SIGTERM — the serve CLI stops admission, completes
        every admitted request, exits 0."""
        self.deliberate_stop = True
        proc = self.proc
        if proc is not None and proc.poll() is None:
            try:
                proc.send_signal(signal.SIGTERM)
            except (ProcessLookupError, OSError):
                pass

    def stop(self, drain: bool = True, timeout_s: float = 60.0):
        self.begin_drain()
        proc = self.proc
        if proc is None:
            return
        try:
            proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            logger.warning("fleet: replica %s ignored SIGTERM for %.0fs; "
                           "killing", self.name, timeout_s)
            proc.kill()
            proc.wait(timeout=10)

    def kill(self):
        """SIGKILL, the chaos case: no handler runs, requests in flight
        are lost at the replica and failed over by the router."""
        proc = self.proc
        if proc is not None and proc.poll() is None:
            try:
                proc.kill()
            except (ProcessLookupError, OSError):
                pass


def _wire_feeds(feeds) -> dict:
    """JSON form of one request's feeds (arrays -> nested lists)."""
    out = {}
    for k, v in feeds.items():
        out[k] = v.tolist() if hasattr(v, "tolist") else v
    return out


# ---------------------------------------------------------------------------
# autoscaling policy
# ---------------------------------------------------------------------------
class AutoscalePolicy:
    """Pure decision function over a fleet snapshot — separated from the
    router so tests drive the matrix without threads or clocks.

    Scale-out: the queue-wait share of the rolling p99 exceeds
    ``wait_share_threshold`` (and p99 itself exceeds ``p99_floor_ms`` so
    an idle-but-jittery fleet never scales on noise).  Queue wait is
    ``total - dispatch`` per completed request — the live form of the
    doctor's ``serving_budget`` decomposition: when most of the p99 is
    waiting, capacity (not the model) is the bottleneck and a replica
    helps; when dispatch dominates, it won't.

    Scale-in: sustained idle — total queue depth zero AND per-replica
    served rate under ``idle_rate_per_replica`` for at least
    ``idle_for_s`` — drains one replica.

    ``cooldown_s`` spaces decisions so a scale-out's effect is observed
    before the next one; ``min_replicas``/``max_replicas`` bound the
    fleet."""

    def __init__(self, *, wait_share_threshold: float = 0.5,
                 p99_floor_ms: float = 20.0,
                 idle_rate_per_replica: float = 0.5,
                 idle_for_s: float = 10.0,
                 min_replicas: int = 1, max_replicas: int = 8,
                 cooldown_s: float = 5.0):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas}..{max_replicas}")
        self.wait_share_threshold = float(wait_share_threshold)
        self.p99_floor_ms = float(p99_floor_ms)
        self.idle_rate_per_replica = float(idle_rate_per_replica)
        self.idle_for_s = float(idle_for_s)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.cooldown_s = float(cooldown_s)

    def decide(self, snap: dict) -> Optional[dict]:
        """``snap``: replicas (live process count — the resource the
        min/max bounds cap), routable_replicas, p99_ms, wait_share_p99,
        queue_depth, served_per_s, idle_s, since_last_decision_s.
        Returns {"action": "scale_out"|"scale_in", "reason": ...} or
        None."""
        n = int(snap.get("replicas", 0))
        if snap.get("since_last_decision_s", 1e9) < self.cooldown_s:
            return None
        p99 = snap.get("p99_ms")
        share = snap.get("wait_share_p99")
        if (n < self.max_replicas and p99 is not None
                and share is not None and p99 >= self.p99_floor_ms
                and share >= self.wait_share_threshold):
            return {"action": "scale_out",
                    "reason": f"queue-wait share of p99 "
                              f"{share:.2f} >= {self.wait_share_threshold} "
                              f"(p99 {p99:.1f}ms)",
                    "p99_ms": round(p99, 3),
                    "wait_share_p99": round(share, 4)}
        rate = snap.get("served_per_s", 0.0) or 0.0
        if (n > self.min_replicas
                and int(snap.get("queue_depth", 0)) == 0
                and rate < self.idle_rate_per_replica * n
                and snap.get("idle_s", 0.0) >= self.idle_for_s):
            return {"action": "scale_in",
                    "reason": f"idle {snap.get('idle_s', 0.0):.1f}s "
                              f"(rate {rate:.2f}/s over {n} replicas)",
                    "served_per_s": round(rate, 3)}
        return None


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------
class FleetRouter:
    """Queue-depth-aware load balancer + replica lifecycle manager.

    ::

        router = FleetRouter(replica_factory=make_replica, replicas=2)
        router.start()
        out = router.submit(feeds).result(timeout=5)
        router.shutdown()

    ``replica_factory(index) -> replica`` builds members
    (:class:`LocalReplica` or :class:`ProcessReplica`); ``autoscale``
    (an :class:`AutoscalePolicy`) enables the scaling thread.  The
    router exposes the server surface (``submit``/``health``/``state``)
    so :class:`~paddle_tpu_torch.serving.http.HttpFront` fronts a fleet
    the same way it fronts one server."""

    def __init__(self, replica_factory: Callable[[int], object],
                 replicas: int = 1, *,
                 autoscale: Optional[AutoscalePolicy] = None,
                 poll_interval_s: float = 0.2,
                 health_stale_s: float = 5.0,
                 max_restarts: int = 3,
                 restart_backoff_base_s: float = 0.5,
                 default_deadline_ms: Optional[float] = -1.0,
                 failover_attempts: Optional[int] = None,
                 backlog_limit: Optional[int] = None,
                 failover_wait_s: float = 10.0):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.replica_factory = replica_factory
        self.initial_replicas = int(replicas)
        self.policy = autoscale
        self.poll_interval_s = float(poll_interval_s)
        self.health_stale_s = float(health_stale_s)
        self.max_restarts = int(max_restarts)
        self.restart_backoff_base_s = float(restart_backoff_base_s)
        self.default_deadline_ms = default_deadline_ms
        self.failover_attempts = failover_attempts
        # how long a failover may wait for SOME replica to become
        # routable again before failing the admitted request: a dying
        # replica and a momentarily-stale survivor often overlap (the
        # health poll that would re-admit it is in flight), and an
        # admitted request must not lose that race
        self.failover_wait_s = float(failover_wait_s)
        # fleet-rim admission control: when every routable replica's
        # live score (queue depth + in-flight since poll) is at or past
        # this bound, reject with Overloaded HERE — the replica-side
        # shed would first pay wire+parse on a core that should be
        # serving admitted work
        self.backlog_limit = backlog_limit
        self.replicas: List[object] = []
        self._next_index = 0
        self._lock = _lw.make_rlock("fleet.router")
        self._state = "warming"
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._sups: Dict[str, Supervisor] = {}
        self._routable_before: Dict[str, bool] = {}
        # rolling latency window for the autoscaler: (total_ms,
        # dispatch_ms) of completed-ok routed requests
        self._window = collections.deque(maxlen=512)
        self._served = 0
        self._served_window_t0 = time.monotonic()
        self._served_window_n = 0
        self._last_decision_ts = 0.0
        self._idle_since: Optional[float] = None
        self._req_counter = 0
        # observe resolved ONCE at construction (the server's discipline):
        # off -> no ctx is captured at admission and no ctx field ever
        # reaches a replica's stdio wire
        self._observe = obs.enabled()

    # -- lifecycle -----------------------------------------------------------
    @property
    def state(self) -> str:
        return self._state

    def start(self, wait_ready: bool = True,
              ready_timeout_s: float = 600.0) -> "FleetRouter":
        for _ in range(self.initial_replicas):
            self._add_replica(wait_ready=False)
        if wait_ready:
            deadline = time.monotonic() + ready_timeout_s
            while time.monotonic() < deadline:
                self._poll_all()
                if self._routable():
                    break
                time.sleep(0.05)
            else:
                raise RuntimeError(
                    f"fleet: no replica became ready within "
                    f"{ready_timeout_s}s")
        self._state = "ready"
        t = threading.Thread(target=self._poll_loop, name="pt-fleet-poll",
                             daemon=True)
        t.start()
        self._threads.append(t)
        if self.policy is not None:
            t2 = threading.Thread(target=self._autoscale_loop,
                                  name="pt-fleet-autoscale", daemon=True)
            t2.start()
            self._threads.append(t2)
        return self

    def _new_replica(self):
        with self._lock:
            idx = self._next_index
            self._next_index += 1
        rep = self.replica_factory(idx)
        rep.on_terminal = self._on_terminal
        if hasattr(rep, "on_death"):
            rep.on_death = self._on_death
        return rep

    def _add_replica(self, wait_ready: bool = True):
        rep = self._new_replica()
        if hasattr(rep, "spawn"):
            rep.spawn()
        with self._lock:
            self.replicas.append(rep)
            self._sups[rep.name] = Supervisor(
                max_restarts=self.max_restarts,
                backoff_base_s=self.restart_backoff_base_s,
                jitter=0.1, seed=len(self._sups))
        if wait_ready and hasattr(rep, "wait_ready"):
            rep.wait_ready()
        self._set_replica_gauges()
        return rep

    def _set_replica_gauges(self):
        counts = {st: 0 for st in ("warming", "ready", "draining",
                                   "stopped", DEAD)}
        with self._lock:
            for r in self.replicas:
                counts[r.state] = counts.get(r.state, 0) + 1
        for st, n in counts.items():   # zeros too: relaunch clears "dead"
            obs.set_gauge("fleet/replicas", n, label=st)

    def begin_drain(self):
        """Close fleet admission and drain every replica gracefully."""
        if self._state in ("draining", "stopped"):
            return
        self._state = "draining"
        obs.emit_event("fleet", event="state", state="draining")
        with self._lock:
            reps = list(self.replicas)
        for r in reps:
            r.begin_drain()

    def shutdown(self, drain: bool = True, timeout_s: float = 120.0):
        self.begin_drain()
        self._stop.set()
        with self._lock:
            reps = list(self.replicas)
        for r in reps:
            r.stop(drain=drain)
        for t in self._threads:
            t.join(timeout=10)
        self._state = "stopped"
        obs.emit_event("fleet", event="state", state="stopped")

    # -- health / routing ----------------------------------------------------
    def _fresh(self, rep) -> bool:
        return (time.monotonic() - getattr(rep, "last_health_ts", 0.0)
                < self.health_stale_s)

    def _is_routable(self, rep, model: Optional[str] = None) -> bool:
        return (rep.alive and rep.state == "ready"
                and not getattr(rep, "cordoned", False)
                and self._fresh(rep)
                and not rep.breaker_open(model))

    def cordon(self, name: str, cordoned: bool = True):
        """Administratively remove (or re-add) a replica from the
        routable set without touching its process — maintenance,
        canarying, or A/B capacity measurement.  Admitted work keeps
        completing; only NEW routing skips it."""
        with self._lock:
            reps = [r for r in self.replicas if r.name == name]
        if not reps:
            raise ValueError(f"fleet: no replica named {name!r}")
        reps[0].cordoned = bool(cordoned)
        obs.emit_event("fleet", event="cordon" if cordoned
                       else "uncordon", replica=name)

    def _routable(self, model: Optional[str] = None) -> List[object]:
        with self._lock:
            reps = list(self.replicas)
        return [r for r in reps if self._is_routable(r, model)]

    def _poll_all(self):
        with self._lock:
            reps = list(self.replicas)
        for r in reps:
            try:
                r.poll_health()
            except Exception:
                logger.exception("fleet: health poll of %s failed", r.name)
        # eviction accounting: routable -> unroutable transitions.  A
        # replica seen for the first time (fresh spawn, still warming)
        # just records its state — it was never routable, so counting
        # it as an eviction would poison fleet/evictions at every cold
        # start and scale-out
        for r in reps:
            now_routable = self._is_routable(r)
            was = self._routable_before.get(r.name)
            if was is None:
                self._routable_before[r.name] = now_routable
                continue
            if was and not now_routable:
                obs.inc_counter("fleet/evictions")
                obs.emit_event(
                    "fleet", event="evict", replica=r.name,
                    state=r.state,
                    breaker_open=bool(r.breaker_open(None)),
                    stale=not self._fresh(r))
            elif not was and now_routable:
                obs.emit_event("fleet", event="readd", replica=r.name)
            self._routable_before[r.name] = now_routable
        self._set_replica_gauges()

    def _poll_loop(self):
        while not self._stop.wait(self.poll_interval_s):
            self._poll_all()
            self._reap_stopped()

    def _reap_stopped(self):
        """Drop replicas that finished a deliberate drain (scale-in or
        fleet drain)."""
        with self._lock:
            gone = [r for r in self.replicas
                    if r.state == "stopped" and not r.alive]
            for r in gone:
                self.replicas.remove(r)
                self._routable_before.pop(r.name, None)

    def health(self) -> dict:
        with self._lock:
            reps = list(self.replicas)
        out_reps = {}
        depth = 0
        for r in reps:
            d = r.queue_depth()
            depth += d
            out_reps[r.name] = {
                "state": r.state, "alive": r.alive, "queue_depth": d,
                "routable": self._is_routable(r),
                "restarts": getattr(r, "restarts", 0),
            }
        ready = self._state == "ready" and any(
            v["routable"] for v in out_reps.values())
        return {"state": self._state, "ready": ready,
                "queue_depth": depth, "replicas": out_reps}

    def metrics_snapshots(self, timeout_s: float = 2.0) -> Dict[str, dict]:
        """One metrics-piggybacked health poll of every replica, gathered:
        ``{replica_name: {"metrics": snapshot, "identity": {...}|None}}``.
        Process replicas answer asynchronously on their reader threads,
        so this waits (bounded) for replies newer than the ask; members
        that don't answer in time are simply absent — the fleet
        collector labels what it got, it never blocks on a wedged
        replica."""
        with self._lock:
            reps = list(self.replicas)
        t_ask = time.monotonic()
        for r in reps:
            try:
                r.poll_health(metrics=True)
            except Exception:
                logger.exception("fleet: metrics poll of %s failed",
                                 r.name)
        deadline = t_ask + timeout_s
        while time.monotonic() < deadline:
            if all(getattr(r, "last_metrics_ts", 0.0) >= t_ask
                   or not r.alive for r in reps):
                break
            time.sleep(0.02)
        out = {}
        for r in reps:
            if getattr(r, "last_metrics", None) is not None \
                    and getattr(r, "last_metrics_ts", 0.0) >= t_ask:
                out[r.name] = {"metrics": r.last_metrics,
                               "identity": getattr(r, "last_identity",
                                                   None)}
        return out

    # -- submission ----------------------------------------------------------
    def submit(self, feeds, model: Optional[str] = None,
               deadline_ms: Optional[float] = -1.0,
               req_id=None) -> FleetPending:
        """Route one request to the least-loaded ready replica.  Raises
        the typed rejection when the fleet cannot admit it."""
        if self._state != "ready":
            raise _faults.ServerClosed(
                f"fleet is {self._state}; admission closed")
        if deadline_ms == -1.0:
            deadline_ms = self.default_deadline_ms
        if req_id is None:
            with self._lock:
                self._req_counter += 1
                req_id = self._req_counter
        fp = FleetPending(
            req_id, model, feeds, deadline_ms,
            ctx=obs.tracing.inject() if self._observe else None)
        obs.inc_counter("fleet/requests")
        self._route(fp, exclude=())
        return fp

    def infer(self, feeds, model: Optional[str] = None,
              deadline_ms: Optional[float] = -1.0,
              timeout: Optional[float] = None):
        return self.submit(feeds, model=model,
                           deadline_ms=deadline_ms).result(timeout)

    def _score(self, rep) -> float:
        # live signal: last polled queue depth, plus what we routed at
        # it since that poll answered, plus lines not yet on the wire
        return (rep.queue_depth() + rep.routed_since_poll
                + getattr(rep, "local_backlog", 0))

    def _route(self, fp: FleetPending, exclude: Sequence[str],
               admitted: bool = False):
        """Offer ``fp`` to routable replicas, least-loaded first; raises
        the last typed rejection when every candidate refuses.
        ``admitted``: failover resubmission of an already-admitted
        request — exempt from the fleet-rim backlog shed."""
        candidates = [r for r in self._routable(fp.model)
                      if r.name not in exclude]
        candidates.sort(key=self._score)
        if (not admitted and self.backlog_limit is not None and candidates
                and self._score(candidates[0]) >= self.backlog_limit):
            obs.inc_counter("fleet/router_shed")
            obs.emit_event("fleet", event="router_shed", request=fp.id,
                           best_score=self._score(candidates[0]))
            raise _faults.Overloaded(
                f"fleet saturated: every ready replica is at the "
                f"backlog limit ({self.backlog_limit})")
        limit = (self.failover_attempts if self.failover_attempts
                 is not None else max(2, len(candidates)))
        last_exc: Optional[BaseException] = None
        for rep in candidates[:limit]:
            fp.attempts += 1
            try:
                rep.submit(fp)
                return
            except (ReplicaGone, _faults.ServerClosed,
                    _faults.ModelUnavailable, _faults.Overloaded) as e:
                last_exc = e
                continue
        if last_exc is not None and not isinstance(last_exc, ReplicaGone):
            raise last_exc
        raise _faults.ModelUnavailable(
            "fleet: no ready replica available"
            + (f" (excluded: {sorted(exclude)})" if exclude else ""))

    # -- completion / failover ----------------------------------------------
    def _on_terminal(self, fp: FleetPending, outputs=None, error=None,
                     dispatch_ms=None):
        if error is not None and isinstance(error, ReplicaGone):
            self._failover(fp, error)
            return
        if error is not None:
            fp._complete(error=error)
            return
        total_ms = (time.monotonic() - fp.t_admit) * 1e3
        with self._lock:
            self._window.append((total_ms, dispatch_ms))
            self._served += 1
            self._served_window_n += 1
        fp._complete(outputs=outputs, dispatch_ms=dispatch_ms)

    def _on_death(self, rep, rc, lost: List[FleetPending]):
        """A replica process exited.  Fail admitted requests over to
        survivors, then relaunch through the supervisor's bounded-restart
        gate when the death was not deliberate."""
        retry_until = time.monotonic() + self.failover_wait_s
        for fp in lost:
            self._failover(fp, ReplicaGone(
                f"replica {rep.name} exited rc={rc}"),
                retry_until=retry_until)
        if rep.state != DEAD or self._stop.is_set():
            return
        obs.emit_event("fleet", event="replica_death", replica=rep.name,
                       rc=rc)
        sup = self._sups.get(rep.name)
        if sup is None or not sup.relaunch_gate(
                f"fleet replica {rep.name}", f"exit status {rc}"):
            logger.error("fleet: replica %s exhausted its restart budget; "
                         "leaving it dead", rep.name)
            obs.emit_event("fleet", event="replica_abandoned",
                           replica=rep.name)
            self._set_replica_gauges()
            return
        rep.restarts += 1
        obs.inc_counter("fleet/relaunches")
        obs.emit_event("fleet", event="relaunch", replica=rep.name,
                       attempt=rep.restarts)
        try:
            rep.spawn()
        except Exception:
            logger.exception("fleet: relaunch of %s failed", rep.name)
        self._set_replica_gauges()

    def _failover(self, fp: FleetPending, cause: BaseException,
                  retry_until: Optional[float] = None):
        """Resubmit an admitted-but-lost request to a surviving replica
        — the fleet-wide zero-drop path.  No-candidate windows are
        WAITED OUT up to ``failover_wait_s``: right after a death the
        survivor's health is often one poll away from fresh, and an
        admitted request must not lose that race."""
        if fp.done():
            return
        if self._state != "ready":
            fp._complete(error=_faults.ServerClosed(
                f"fleet draining; request lost by a dying replica "
                f"({cause})"))
            return
        obs.inc_counter("fleet/failovers")
        obs.emit_event("fleet", event="failover", request=fp.id,
                       cause=str(cause), attempts=fp.attempts)
        if retry_until is None:
            retry_until = time.monotonic() + self.failover_wait_s
        while True:
            try:
                self._route(fp, exclude=(), admitted=True)
                return
            except (ReplicaGone, _faults.ModelUnavailable,
                    _faults.Overloaded, _faults.ServerClosed) as e:
                if self._state != "ready" \
                        or time.monotonic() >= retry_until:
                    fp._complete(
                        error=e if not isinstance(e, ReplicaGone)
                        else _faults.ModelUnavailable(
                            f"fleet: request lost and no surviving "
                            f"replica ({cause})"))
                    return
                time.sleep(0.05)        # poller refreshes health
            except BaseException as e:  # unexpected: surface typed
                fp._complete(error=e)
                return

    # -- autoscaling ---------------------------------------------------------
    def autoscale_snapshot(self) -> dict:
        now = time.monotonic()
        with self._lock:
            window = list(self._window)
            n_window = self._served_window_n
            t0 = self._served_window_t0
            self._served_window_n = 0
            self._served_window_t0 = now
        p99 = wait_share = None
        if window:
            totals = sorted(t for t, _ in window)
            p99 = totals[min(len(totals) - 1, int(len(totals) * 0.99))]
            waits = sorted(
                max(0.0, t - (d or 0.0)) for t, d in window)
            wait_p99 = waits[min(len(waits) - 1, int(len(waits) * 0.99))]
            wait_share = (wait_p99 / p99) if p99 > 0 else 0.0
        h = self.health()
        depth = h["queue_depth"]
        rate = n_window / max(1e-6, now - t0)
        # "replicas" is the RESOURCE count (every live process, routable
        # or not): the policy's min/max bounds cap processes, and a
        # transiently-evicted replica still holds its core — counting
        # only routables would let scale-out overshoot max_replicas
        n_live = len(h["replicas"])
        # the idle clock must mirror the policy's own scale-in rate
        # threshold, or fleets with a higher idle_rate_per_replica than
        # this clock's floor never accumulate idle_s and never scale in
        idle_rate = (self.policy.idle_rate_per_replica
                     if self.policy is not None else 1.0)
        if depth == 0 and rate < idle_rate * max(1, n_live):
            if self._idle_since is None:
                self._idle_since = now
        else:
            self._idle_since = None
        return {
            "replicas": n_live,
            "routable_replicas": sum(1 for v in h["replicas"].values()
                                     if v["routable"]),
            "p99_ms": p99, "wait_share_p99": wait_share,
            "queue_depth": depth, "served_per_s": rate,
            "idle_s": 0.0 if self._idle_since is None
            else now - self._idle_since,
            "since_last_decision_s": now - self._last_decision_ts,
        }

    def _autoscale_loop(self):
        interval = max(self.poll_interval_s, 0.5)
        while not self._stop.wait(interval):
            try:
                snap = self.autoscale_snapshot()
                decision = self.policy.decide(snap)
                if decision is not None:
                    self.apply_decision(decision, snap)
            except Exception:
                logger.exception("fleet: autoscale tick failed")

    def apply_decision(self, decision: dict, snap: dict):
        """Execute one policy decision (public so tests and the bench
        drive it without the timer thread)."""
        self._last_decision_ts = time.monotonic()
        sp = obs.tracing.start_span(
            "fleet/autoscale", parent=obs.tracing.ROOT,
            action=decision["action"], replicas=snap.get("replicas"))
        sp.event("decision", **decision)
        obs.emit_event("fleet", event=decision["action"],
                       reason=decision.get("reason"), **{
                           k: v for k, v in snap.items()
                           if isinstance(v, (int, float)) or v is None})
        try:
            if decision["action"] == "scale_out":
                rep = self._add_replica(wait_ready=True)
                obs.inc_counter("fleet/scale_outs")
                sp.end(status="ok", replica=rep.name)
            elif decision["action"] == "scale_in":
                victim = self._pick_scale_in_victim()
                if victim is None:
                    sp.end(status="no_victim")
                    return
                victim.begin_drain()     # reaped once it stops
                obs.inc_counter("fleet/scale_ins")
                sp.end(status="ok", replica=victim.name)
            else:
                sp.end(status="unknown_action")
        except Exception as e:
            sp.end(status=type(e).__name__)
            raise

    def _pick_scale_in_victim(self):
        routable = self._routable()
        if len(routable) <= (self.policy.min_replicas
                             if self.policy else 1):
            return None
        return min(routable, key=self._score)


# ---------------------------------------------------------------------------
# CLI: python -m paddle_tpu_torch fleet
# ---------------------------------------------------------------------------
def fleet_main(argv=None) -> int:
    """``python -m paddle_tpu_torch fleet --model DIR --replicas N --http
    PORT`` — N supervised ``serve`` replicas behind the queue-depth
    router and the HTTP front, with optional autoscaling.  SIGTERM/SIGINT
    drains the whole fleet gracefully and exits 0.  The router stays on
    the host; ``--device`` is passed on to every replica."""
    import argparse

    from .cli import _parse_tokens
    from .http import HttpFront

    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch fleet",
        description="horizontally scaled serving: N `paddle_tpu_torch "
                    "serve` replica processes behind a queue-depth-aware "
                    "router and an HTTP/1.1 front, with supervisor-backed "
                    "relaunch and optional metric-driven autoscaling.")
    ap.add_argument("--model", action="append", required=True,
                    metavar="[NAME=]DIR",
                    help="artifact directory each replica serves "
                         "(repeatable, forwarded to `serve`)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where every replica loads and runs its "
                         "artifacts (default the card)")
    ap.add_argument("--replicas", type=int, default=2,
                    help="initial fleet size (default 2)")
    ap.add_argument("--http", type=int, default=0, metavar="PORT",
                    help="HTTP front port (default 0 = ephemeral, "
                         "printed on the ready line)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--token", action="append", metavar="TOKEN[=MODEL]",
                    help="auth token, optionally bound to one model "
                         "(repeatable; omit for an open front)")
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--max-wait-ms", type=float, default=None)
    ap.add_argument("--deadline-ms", type=float, default=None)
    ap.add_argument("--queue", type=int, default=None)
    ap.add_argument("--poll-interval-s", type=float, default=0.2,
                    help="router health-poll period (default 0.2)")
    ap.add_argument("--backlog-limit", type=int, default=None,
                    help="fleet-rim admission bound: reject Overloaded "
                         "at the router once every ready replica's "
                         "live backlog reaches this (default: off; "
                         "replica-side shedding still applies)")
    ap.add_argument("--max-restarts", type=int, default=3,
                    help="bounded relaunches per replica (default 3)")
    ap.add_argument("--autoscale", action="store_true",
                    help="enable the replica autoscaler")
    ap.add_argument("--min-replicas", type=int, default=1)
    ap.add_argument("--max-replicas", type=int, default=8)
    ap.add_argument("--wait-share-threshold", type=float, default=0.5,
                    help="queue-wait share of p99 that triggers "
                         "scale-out (default 0.5)")
    ap.add_argument("--idle-for-s", type=float, default=30.0,
                    help="sustained idle before scale-in (default 30)")
    ap.add_argument("--cooldown-s", type=float, default=10.0)
    args = ap.parse_args(argv)

    obs.set_process_identity("fleet")
    argv_tpl = serve_argv(args.model, max_batch=args.max_batch,
                          max_wait_ms=args.max_wait_ms,
                          deadline_ms=args.deadline_ms, queue=args.queue,
                          device=args.device)

    def factory(i):
        # --replica-index stamps the child's JSONL identity line, so a
        # multi-file trace/stats merge labels its events "serve:i"
        return ProcessReplica(argv_tpl + ["--replica-index", str(i)],
                              name=f"replica{i}")

    policy = None
    if args.autoscale:
        policy = AutoscalePolicy(
            wait_share_threshold=args.wait_share_threshold,
            idle_for_s=args.idle_for_s, cooldown_s=args.cooldown_s,
            min_replicas=args.min_replicas,
            max_replicas=args.max_replicas)

    router = FleetRouter(factory, replicas=args.replicas,
                         autoscale=policy,
                         poll_interval_s=args.poll_interval_s,
                         max_restarts=args.max_restarts,
                         backlog_limit=args.backlog_limit)

    drain = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: drain.set())

    def emit(obj):
        sys.stdout.write(json.dumps(obj) + "\n")
        sys.stdout.flush()

    emit({"event": "state", "state": "warming",
          "replicas": args.replicas})
    router.start()
    front = HttpFront(router, host=args.host, port=args.http,
                      tokens=_parse_tokens(args.token)).start()
    host, port = front.address
    emit({"event": "state", "state": "ready", "host": host, "port": port,
          "replicas": args.replicas})
    while not drain.is_set():
        drain.wait(0.1)
    emit({"event": "state", "state": "draining"})
    # admission closes fleet-wide first: late HTTP requests get typed
    # 503 + Connection: close while admitted work completes
    router.begin_drain()
    router.shutdown(drain=True)
    front.stop()
    emit({"event": "state", "state": "stopped"})
    emit({"event": "stopped", "health": router.health()})
    return 0
