"""Typed, thread-safe metrics registry (counterpart of
``paddle_tpu/observability/metrics.py``; v1's ``StatSet`` of named
``Stat`` timers, utils/Stat.h, printed every ``log_period``).

Three metric kinds, all namespaced ``<subsystem>/<name>``:

* **counter** — monotonically increasing float (steps, bytes, seconds).
* **gauge** — last-written value, optionally per label (examples/sec,
  per-card memory).
* **histogram** — fixed bucket boundaries chosen per metric, plus
  count/sum/min/max (step times, queue depths).

Every metric name is a literal member of the frozen :data:`METRIC_NAMES`
table below, whose rows (name, kind, help, buckets) are the JAX
package's for every name this package writes; the module-level helpers
reject unknown names at run time and ``tests/test_torch_observability.py``
rejects non-literal or unregistered names at test time.

Writers are gated by their call sites (``Executor._observing()``, the
reader pipeline's ``instrument``), not here: with ``observe`` off the
hot paths never reach these helpers.
"""
from __future__ import annotations

import bisect as _bisect
import threading
from typing import Dict, List, Optional, Tuple

from .. import flags as _flags

__all__ = [
    "METRIC_NAMES", "THREAD_NAME_PREFIXES", "HISTOGRAM_BUCKETS",
    "MetricsRegistry", "registry",
    "inc_counter", "set_gauge", "observe_hist", "enabled",
]

# ---------------------------------------------------------------------------
# Frozen metric-name registry.  (name, kind, help) — names used through the
# helpers below MUST appear here as literals (AST-gated in
# tests/test_torch_observability.py; duplicates rejected at import).
# ---------------------------------------------------------------------------
METRIC_NAMES = (
    ("executor/steps", "counter",
     "training/inference steps executed (a K-step scan counts K)"),
    ("executor/dispatches", "counter",
     "compiled dispatches issued (run=1 step, run_steps=K steps)"),
    ("executor/step_time_ms", "histogram",
     "per-step wall time: dispatch wall / steps in the dispatch"),
    ("executor/dispatch_steps", "histogram",
     "steps per compiled dispatch (K of run_steps / run_pipelined chunks)"),
    ("executor/feed_bytes", "counter",
     "feed bytes entering dispatches (after dtype coercion)"),
    ("executor/fetch_block_ms", "histogram",
     "host time blocked materializing fetches to numpy"),
    ("executor/stage_put_ms", "histogram",
     "device_put staging time per run_pipelined chunk (staging thread)"),
    ("executor/examples_per_sec", "gauge",
     "examples/sec of the most recent dispatch (batch * K / wall)"),
    ("executor/nan_events", "counter",
     "check_nan_inf trips that ran the NaN-provenance bisect"),
    ("pipeline/queue_depth", "histogram",
     "prefetch queue depth sampled at each consumer get"),
    ("pipeline/consumer_stall_ms", "histogram",
     "consumer time blocked on an empty prefetch queue"),
    ("pipeline/worker_busy_s", "counter",
     "pipeline-worker seconds spent producing (decode/stage work)"),
    ("pipeline/worker_wait_s", "counter",
     "pipeline-worker seconds blocked on a full queue (backpressure)"),
    ("trainer/reports", "counter",
     "periodic log_period reports emitted by the trainer"),
    ("device/bytes_in_use", "gauge",
     "live device memory per device (memory_stats, where supported)"),
    ("device/peak_bytes_in_use", "gauge",
     "peak device memory per device (memory_stats, where supported)"),
    # fault-tolerance events (cold paths: written unconditionally — the
    # zero-overhead-when-off contract covers per-step hot paths, and a
    # run's fault history must survive into `stats` regardless of observe)
    ("fault/injected", "counter",
     "deterministic fault injections fired (testing.faultinject)"),
    ("fault/retries", "counter",
     "transient-error retries at the dispatch and master RPC rims"),
    ("fault/preemptions", "counter",
     "SIGTERM/SIGINT preemptions that took an emergency checkpoint"),
    ("fault/restarts", "counter",
     "supervisor relaunches of a preempted/transiently-failed run"),
    ("fault/checkpoint_saves", "counter",
     "trainer checkpoint commits (periodic + emergency)"),
    ("fault/checkpoint_restores", "counter",
     "successful checkpoint restores into a training run"),
    ("fault/checkpoint_fallbacks", "counter",
     "restores that skipped a corrupt/truncated checkpoint for an older "
     "intact one"),
    ("fault/tasks_returned", "counter",
     "in-flight master tasks handed back before a retry/shutdown"),
    # serving runtime (serving/server.py, serving/decode.py): per-request
    # and per-batch writes, made only by a server or pool built with
    # observe on
    ("serving/requests", "counter",
     "requests admitted past admission control (a queued request may "
     "still be shed later under overload)"),
    ("serving/batches", "counter",
     "coalesced batches dispatched by the serving runtime"),
    ("serving/shed", "counter",
     "requests rejected by load shedding (Overloaded: queue full, "
     "oldest-deadline-first eviction)"),
    ("serving/deadline_expired", "counter",
     "requests whose deadline expired before dispatch (never computed)"),
    ("serving/breaker_open", "counter",
     "per-model circuit-breaker open transitions (repeated fatal errors)"),
    ("serving/queue_depth", "histogram",
     "admission queue depth sampled as each batch is formed"),
    ("serving/batch_size", "histogram",
     "live (unpadded) requests per dispatched serving batch"),
    ("serving/request_ms", "histogram",
     "admitted-request latency: admission to completed response"),
    # incremental decode serving (paddle_tpu.serving.decode): the slot
    # pool is the instrumented subsystem, same rationale as serving/*
    ("serving/decode_tokens", "counter",
     "tokens generated by decode slot pools (prefill first-tokens + one "
     "per live slot per decode step)"),
    ("serving/decode_tokens_per_s", "gauge",
     "decode throughput: cumulative generated tokens over pool uptime"),
    ("serving/decode_ttft_ms", "histogram",
     "time to first token: request admission to prefill emitting the "
     "first generated token"),
    ("serving/decode_inter_token_ms", "histogram",
     "gap between consecutive generated tokens of one sequence (the "
     "streaming cadence; its p99 is what continuous batching bounds)"),
    ("serving/decode_slot_occupancy", "gauge",
     "live sequences over total slots at the last decode step (padded "
     "compute fraction is 1 minus this)"),
    ("pipeline/fallback_steps", "counter",
     "run_pipelined steps dispatched through the per-step fallback "
     "(stream tail or padding-bucket signature change) instead of a "
     "K-step scan"),
    ("opprof/runs", "counter",
     "per-op profile runs executed (profile CLI / doctor --per-op)"),
    ("opprof/ops", "counter",
     "ops measured by the per-op profiler (one per op per run)"),
    ("opprof/op_ms", "histogram",
     "measured per-op eager wall time (median of timed windows)"),
    # sparse parameter server (paddle_tpu.sparse): the session resolves
    # an observe switch ONCE at construction (obs.enabled() unless
    # overridden) and only writes when observing — training paths that
    # never build a session never reach these helpers (the package is
    # lazy-import gated like serving)
    ("sparse/pulls", "counter",
     "sparse-table pulls executed (one per bound table per batch)"),
    ("sparse/pulled_rows", "counter",
     "unique live rows pulled from host sparse tables"),
    ("sparse/pushes", "counter",
     "sparse-table gradient pushes applied (one per table per batch)"),
    ("sparse/pushed_rows", "counter",
     "rows updated by host-side sparse optimizer pushes"),
    ("sparse/pull_ms", "histogram",
     "host wall time of one table pull (dedup'd batch rows, cache-first)"),
    ("sparse/push_ms", "histogram",
     "host wall time of one gradient push (sparse optimizer update)"),
    ("sparse/cache_hits", "counter",
     "hot-rows cache hits on the pull path"),
    ("sparse/cache_misses", "counter",
     "hot-rows cache misses on the pull path (row fetched from shard)"),
    ("sparse/live_rows", "gauge",
     "lazily-materialized rows resident per table (labels: table name)"),
    ("sparse/rows_initialized", "counter",
     "rows lazily initialized by the batched Philox draw (cold-row "
     "materializations inside pulls/pushes)"),
    ("sparse/init_rows_per_sec", "gauge",
     "lazy-init throughput of the most recent cold-row batch (labels: "
     "table name) — the vectorized-vs-scalar init signal"),
    ("sparse/prefetch_hits", "counter",
     "pull-ahead prefetch hits: the consumer found the next batch "
     "already prepared (overlap won)"),
    ("sparse/prefetch_misses", "counter",
     "pull-ahead prefetch misses: the consumer blocked on the worker "
     "(pulls slower than dispatch, or depth too small)"),
    ("sparse/push_flush_ms", "histogram",
     "host wall time of one async-push worker drain (up to "
     "push_flush_batch queued gradient pushes applied FIFO)"),
    # sparse parameter-server wire tier (sparse.pserver / sparse.client):
    # only written inside pserver processes and RemoteSparseTable rounds —
    # the tier is lazy-import gated, so in-process training never loads it
    ("pserver/requests", "counter",
     "wire requests served by pserver shards (one per batched frame)"),
    ("pserver/pull_rows", "counter",
     "rows pulled through the pserver wire path (server-side count)"),
    ("pserver/push_rows", "counter",
     "rows updated by pserver-side optimizer pushes"),
    ("pserver/pull_rows_per_sec", "gauge",
     "server-side kernel throughput of the most recent batched pull"),
    ("pserver/push_rows_per_sec", "gauge",
     "server-side kernel throughput of the most recent batched push"),
    ("pserver/wire_bytes_in", "counter",
     "bytes received over the pserver binary wire (frames in)"),
    ("pserver/wire_bytes_out", "counter",
     "bytes sent over the pserver binary wire (frames out)"),
    ("pserver/frame_ms", "histogram",
     "server wall time of one batched request frame: decode done to "
     "reply queued (the wire-marshalling + kernel cost per round)"),
    ("pserver/reconnects", "counter",
     "client reconnects to a pserver shard (retry rim re-dials after a "
     "torn frame / refused connection)"),
    ("pserver/replication_lag_ms", "histogram",
     "chain-backup forward round-trip per applied push: apply done to "
     "backup ack (the price of zero-acked-push-loss durability)"),
    ("pserver/backup_pushes", "counter",
     "chain-backup pushes applied on behalf of a predecessor shard"),
    ("pserver/checkpoints", "counter",
     "durable pserver shard checkpoints committed (SIGTERM or op)"),
    # incremental checkpointing (distributed.checkpoint delta chains)
    ("checkpoint/delta_bytes", "counter",
     "bytes written by delta commits (sparse dirty rows + dense chunk "
     "patches) — the wire/disk cost full rebases amortize away"),
    ("checkpoint/delta_rows", "counter",
     "sparse rows serialized into delta commits (dirty rows only)"),
    ("checkpoint/rebase_total", "counter",
     "full commits that terminated a live delta chain (policy rebase "
     "or forced fallback after a chain error)"),
    ("checkpoint/commit_ms", "histogram",
     "writer wall time of one durable commit, serialize to fsync'd "
     "meta (full and delta alike; the trainer only pays this when a "
     "hard barrier drains the queue)"),
    # distributed tracing wire rim (observability.tracing inject/extract):
    # context_rejected is an anomaly counter like fault/* — a malformed
    # context only exists when a peer SENT one, so counting it is never
    # on a zero-overhead-off path
    ("trace/context_rejected", "counter",
     "malformed/truncated/unknown-version trace contexts rejected at a "
     "wire rim (ignored-and-counted: the request still serves)"),
    ("concurrency/order_violations", "counter",
     "lock-acquisition-order cycles detected by lockwatch (each raised "
     "as a deterministic LockOrderViolation instead of deadlocking)"),
    ("concurrency/order_edges", "gauge",
     "distinct lock-class ordering edges in the process-wide lockwatch "
     "acquisition graph"),
    ("concurrency/long_holds", "counter",
     "lock holds exceeding the PADDLE_TPU_LOCKWATCH_HOLD_MS watchdog "
     "threshold"),
    ("concurrency/lock_held_ms", "histogram",
     "watched-lock hold time, acquire to release (lockwatch on only)"),
    # elastic training service (distributed/elastic.py): writes are
    # unconditional cold paths like fault/* — membership churn and
    # resize boundaries are rare events whose history must survive into
    # `stats`; training hot paths never reach these helpers
    ("elastic/workers", "gauge",
     "elastic worker count by state (labels: ready = live process, "
     "done = exited 0 with its shard complete)"),
    ("elastic/heartbeats", "counter",
     "worker heartbeats received through the master's membership layer"),
    ("elastic/drains", "counter",
     "coordinator-commanded worker drains completed at a task boundary"),
    ("elastic/resizes", "counter",
     "committed mesh resize boundaries (drain -> merge -> re-plan -> "
     "relaunch)"),
    ("elastic/resize_ms", "histogram",
     "wall time of one resize boundary: drain start to workers relaunched"),
    # HTTP serving front (paddle_tpu_torch.serving.http): per-request writes
    # are unconditional, same rationale as serving/* — the front IS the
    # instrumented subsystem; training paths never reach these helpers
    ("http/requests", "counter",
     "HTTP inference requests received by the serving front"),
    ("http/rejected", "counter",
     "HTTP requests answered with a typed-rejection status (429/503/504) "
     "or a 4xx protocol error"),
    ("http/auth_failures", "counter",
     "HTTP requests rejected 401/403 by the token -> model gate"),
    ("http/request_ms", "histogram",
     "HTTP request wall time: socket read to last response byte"),
    # serving fleet (paddle_tpu_torch.serving.fleet): router + autoscaler
    # writes are unconditional for the same reason
    ("fleet/requests", "counter",
     "requests routed to a replica by the fleet router"),
    ("fleet/failovers", "counter",
     "admitted requests resubmitted to another replica after their "
     "replica died or closed mid-flight (the zero-drop path)"),
    ("fleet/evictions", "counter",
     "replicas removed from the routable set (breaker open, draining, "
     "dead, or unresponsive health)"),
    ("fleet/relaunches", "counter",
     "dead replicas relaunched through the supervisor's bounded-restart "
     "accounting"),
    ("fleet/router_shed", "counter",
     "requests rejected Overloaded at the FLEET rim (every ready "
     "replica at the backlog limit) — cheaper than a replica-side shed "
     "that pays wire+parse first"),
    ("fleet/scale_outs", "counter",
     "autoscaler scale-out decisions executed (replica added)"),
    ("fleet/scale_ins", "counter",
     "autoscaler scale-in decisions executed (replica drained + removed)"),
    ("fleet/replicas", "gauge",
     "current fleet size by state (labels: ready/warming/draining/dead)"),
    # autotuner (paddle_tpu.tuning): search-time writes are cold paths
    # (a search IS the workload) and replay writes fire once per
    # (call site, process) — the zero-overhead-when-off contract covers
    # untuned training paths, which never reach these helpers
    ("tuning/trials", "counter",
     "autotuner trials executed (ok + failed + timeout)"),
    ("tuning/trial_ms", "histogram",
     "wall time per autotuner trial (all windows incl. warmup)"),
    ("tuning/failures", "counter",
     "autotuner trials recorded failed or timeout (contained, never "
     "crash the search)"),
    ("tuning/winners", "counter",
     "tunables whose candidate cleared the paired-A/B noise gate and "
     "was persisted"),
    ("tuning/refusals", "counter",
     "searches ending in an explicit refusal (noise gate, or no viable "
     "config)"),
    ("tuning/replays", "counter",
     "persisted winners replayed into call sites by tuned() (first "
     "lookup per site per process)"),
    # fleet metrics collector (observability.collector, imported lazily):
    # only written inside collector merges — a fleet-stats run IS the
    # workload
    ("collector/merges", "counter",
     "fleet snapshot merges executed by the metrics collector"),
    ("collector/sources", "gauge",
     "per-process sources folded into the most recent fleet snapshot "
     "(labels: source kind — log/pserver/master/replica)"),
)

# ---------------------------------------------------------------------------
# Frozen framework thread-name prefixes.  (prefix, help) — every thread the
# port starts MUST carry a name beginning with one of these (AST-gated by
# the PT055 concurrency pass, analysis/concurrency.py, which reads this
# literal without importing it), so leak reports and operator tooling can
# attribute any thread to its subsystem by name alone.  The rows are the
# JAX table's for the threads the port starts, and one of the port's own
# (pt-loadgen).
# ---------------------------------------------------------------------------
THREAD_NAME_PREFIXES = (
    ("pt-input-pipeline", "reader pipeline prefetch workers"),
    ("pt-reader", "reader decorator xmap/pipe workers"),
    ("pt-sparse", "sparse session prefetch + async-push workers"),
    ("pt-ckpt", "incremental checkpoint commit writer"),
    ("pt-serving", "serving batcher/dispatcher/stdin threads"),
    ("pt-decode", "continuous-batching decode loop"),
    ("pt-http", "HTTP serving front acceptor"),
    ("pt-fleet", "fleet router/drain/autoscale/replica-io threads"),
    ("pt-elastic", "elastic worker heartbeat daemons"),
    ("pt-master", "distributed master RPC server"),
    ("pt-pserver", "sparse pserver selector/acceptor loops"),
    ("pt-tune", "autotuner trial client threads"),
    ("pt-loadgen", "benchmark load generator's closed-loop client "
     "workers"),
)

_MS_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
               100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0)
_COUNT_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)
_DEPTH_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)

# Fixed bucket boundaries per histogram (upper-inclusive edges; one
# implicit overflow bucket past the last edge).
HISTOGRAM_BUCKETS: Dict[str, Tuple[float, ...]] = {
    "executor/step_time_ms": _MS_BUCKETS,
    "executor/dispatch_steps": _COUNT_BUCKETS,
    "executor/fetch_block_ms": _MS_BUCKETS,
    "executor/stage_put_ms": _MS_BUCKETS,
    "pipeline/queue_depth": _DEPTH_BUCKETS,
    "pipeline/consumer_stall_ms": _MS_BUCKETS,
    "serving/queue_depth": _DEPTH_BUCKETS,
    "serving/batch_size": _COUNT_BUCKETS,
    "serving/request_ms": _MS_BUCKETS,
    "serving/decode_ttft_ms": _MS_BUCKETS,
    "serving/decode_inter_token_ms": _MS_BUCKETS,
    "opprof/op_ms": _MS_BUCKETS,
    "elastic/resize_ms": _MS_BUCKETS,
    "sparse/pull_ms": _MS_BUCKETS,
    "sparse/push_ms": _MS_BUCKETS,
    "sparse/push_flush_ms": _MS_BUCKETS,
    "pserver/frame_ms": _MS_BUCKETS,
    "pserver/replication_lag_ms": _MS_BUCKETS,
    "checkpoint/commit_ms": _MS_BUCKETS,
    "http/request_ms": _MS_BUCKETS,
    "tuning/trial_ms": _MS_BUCKETS,
}
_DEFAULT_BUCKETS = _MS_BUCKETS


class _Counter:
    kind = "counter"
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def snapshot(self):
        return {"kind": "counter", "value": self.value}


class _Gauge:
    kind = "gauge"
    __slots__ = ("values",)

    def __init__(self):
        self.values: Dict[str, float] = {}

    def snapshot(self):
        return {"kind": "gauge", "values": dict(self.values)}


class _Histogram:
    kind = "histogram"
    __slots__ = ("boundaries", "counts", "count", "sum", "min", "max")

    def __init__(self, boundaries: Tuple[float, ...]):
        self.boundaries = tuple(float(b) for b in boundaries)
        self.counts: List[int] = [0] * (len(self.boundaries) + 1)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, value: float):
        self.counts[_bisect.bisect_left(self.boundaries, value)] += 1
        self.count += 1
        self.sum += value
        if self.min is None or value < self.min:
            self.min = value
        if self.max is None or value > self.max:
            self.max = value

    def snapshot(self):
        return {"kind": "histogram", "count": self.count,
                "sum": round(self.sum, 6), "min": self.min, "max": self.max,
                "boundaries": list(self.boundaries),
                "counts": list(self.counts)}


class MetricsRegistry:
    """All metrics from :data:`METRIC_NAMES`, behind ONE lock.

    Writes come from the executor dispatch path, pipeline worker threads
    and the run_pipelined staging thread concurrently; a single lock is
    cheap at the write rates involved (per dispatch / per queue op, not
    per tensor element)."""

    def __init__(self, spec=METRIC_NAMES):
        self._lock = threading.Lock()
        self._spec = spec
        self._metrics: Dict[str, object] = {}
        seen = set()
        for name, kind, _help in spec:
            if name in seen:
                raise ValueError(f"duplicate metric name {name!r} in "
                                 f"METRIC_NAMES")
            seen.add(name)
            if kind == "counter":
                self._metrics[name] = _Counter()
            elif kind == "gauge":
                self._metrics[name] = _Gauge()
            elif kind == "histogram":
                self._metrics[name] = _Histogram(
                    HISTOGRAM_BUCKETS.get(name, _DEFAULT_BUCKETS))
            else:
                raise ValueError(f"metric {name!r}: unknown kind {kind!r}")

    def _get(self, name: str, kind: str):
        m = self._metrics.get(name)
        if m is None:
            raise KeyError(
                f"unknown metric {name!r}; metric names are frozen in "
                f"observability.metrics.METRIC_NAMES — add it there (the "
                f"name gate enforces literal, registered names)")
        if m.kind != kind:
            raise TypeError(f"metric {name!r} is a {m.kind}, not a {kind}")
        return m

    # -- writes ----------------------------------------------------------
    def inc_counter(self, name: str, n: float = 1.0):
        with self._lock:
            self._get(name, "counter").value += n

    def set_gauge(self, name: str, value: float, label: str = ""):
        with self._lock:
            self._get(name, "gauge").values[str(label)] = float(value)

    def observe_hist(self, name: str, value: float):
        with self._lock:
            self._get(name, "histogram").observe(float(value))

    # -- reads -----------------------------------------------------------
    def snapshot(self) -> Dict[str, dict]:
        """{name: snapshot-dict} for every registered metric (zero-valued
        metrics included, so consumers see a stable schema)."""
        with self._lock:
            return {name: m.snapshot() for name, m in self._metrics.items()}

    def report(self) -> str:
        """StatSet-style text block of every non-empty metric."""
        lines = ["======= Metrics ======="]
        for name, snap in sorted(self.snapshot().items()):
            if snap["kind"] == "counter" and snap["value"]:
                lines.append(f"  {name}: {snap['value']:g}")
            elif snap["kind"] == "gauge" and snap["values"]:
                vals = " ".join(f"{k or '-'}={v:g}"
                                for k, v in sorted(snap["values"].items()))
                lines.append(f"  {name}: {vals}")
            elif snap["kind"] == "histogram" and snap["count"]:
                mean = snap["sum"] / snap["count"]
                lines.append(
                    f"  {name}: count={snap['count']} mean={mean:.3f} "
                    f"min={snap['min']:.3f} max={snap['max']:.3f} "
                    f"p50={histogram_quantile(snap, 0.5):.3f} "
                    f"p90={histogram_quantile(snap, 0.9):.3f}")
        return "\n".join(lines)

    def reset(self):
        with self._lock:
            fresh = MetricsRegistry(self._spec)
            self._metrics = fresh._metrics


def histogram_quantile(snap: dict, q: float) -> float:
    """Approximate quantile from a histogram snapshot: the upper edge of
    the bucket containing the q-th observation (max for the overflow
    bucket); 0.0 for an empty histogram."""
    total = snap["count"]
    if not total:
        return 0.0
    rank = q * total
    acc = 0
    for i, c in enumerate(snap["counts"]):
        acc += c
        if acc >= rank and c:
            if i < len(snap["boundaries"]):
                return float(snap["boundaries"][i])
            return float(snap["max"])
    return float(snap["max"])


_registry = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _registry


def enabled() -> bool:
    """The global ``observe`` flag (env ``PADDLE_TPU_TORCH_OBSERVE``).  Per-
    executor ``Executor(observe=...)`` overrides this for its own step
    telemetry; the reader pipeline and trainer reports consult it."""
    return bool(_flags.get_flag("observe"))


# Module-level write helpers — THE gated surface: the name gate of
# tests/test_torch_observability.py requires the name argument at every call site to be a string literal
# registered in METRIC_NAMES.
def inc_counter(name: str, n: float = 1.0):
    _registry.inc_counter(name, n)


def set_gauge(name: str, value: float, label: str = ""):
    _registry.set_gauge(name, value, label)


def observe_hist(name: str, value: float):
    _registry.observe_hist(name, value)
