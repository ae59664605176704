"""Runtime observability (counterpart of
``paddle_tpu/observability/``): the metrics registry, step and pipeline
telemetry, spans, NaN provenance, the per-op profiler and the doctor's
measured budgets.

The v1 reference shipped with built-in telemetry — ``StatSet`` per-layer
timers printed every ``log_period`` (utils/Stat.h, Flags.cpp:62) — and
this package is its successor, one layer for every execution path:

* :mod:`.metrics` — thread-safe typed registry (counters / gauges /
  histograms with fixed buckets) behind the frozen ``METRIC_NAMES`` table;
* :mod:`.export` — JSONL structured event log (flag ``metrics_log``),
  ``metrics_snapshot()``, card-memory sampling, ``log_period`` periodic
  reports, multi-file log merging, summaries and Prometheus text;
* :mod:`.tracing` — structured spans (frozen ``SPAN_NAMES``) across the
  reader -> staging -> dispatch -> fetch and serving request chains,
  with the timeline and critical-path engine;
* :mod:`.attribution` — the doctor's measured budgets (step, serving,
  decode and remote-tier buckets that reconcile with the wall);
* :mod:`.nanprov` — eager per-op bisect of a ``check_nan_inf`` failure;
* :mod:`.opprof` — the eager per-op replay timed with CUDA events, and
  its memory timeline.

``attribution``, ``nanprov`` and ``opprof`` are imported lazily by their
callers.  Producers: ``Executor.run/run_steps/run_pipelined`` (gated by
the ``observe`` flag / ``Executor(observe=...)``), ``reader.pipeline``,
the trainer (periodic reports), ``core.compile_cache`` (through
``metrics_snapshot()['compile']``), the serving runtime, the decode
pool, the sparse tier and the checkpoint writer.
``paddle_tpu_torch.profiler.report()`` renders the merged view.

**Zero overhead when off**: with ``observe`` false the hot paths (the
executor, the reader pipeline, the sparse session and its remote client,
the server and the decode pool) never reach a registry write, build no
span and write no log line, and ``observe`` is not part of a captured
step's key.  The checkpoint writer's commit hooks, the fault events and
the parameter server's per-frame counters (its own process) write
whatever the flag says, as in the JAX package.
"""
from .metrics import (METRIC_NAMES, MetricsRegistry, enabled, inc_counter,
                      observe_hist, registry, set_gauge)
from .export import (emit_event, iter_log_events, log_path,
                     maybe_periodic_report, metrics_snapshot,
                     periodic_report, process_identity,
                     sample_device_memory, set_process_identity,
                     source_label, summarize_log, summarize_logs,
                     to_prometheus)
from . import tracing
from .tracing import SPAN_NAMES

__all__ = [
    "METRIC_NAMES", "MetricsRegistry", "registry", "enabled",
    "inc_counter", "set_gauge", "observe_hist",
    "emit_event", "log_path", "metrics_snapshot", "sample_device_memory",
    "periodic_report", "maybe_periodic_report", "summarize_log",
    "summarize_logs", "iter_log_events", "to_prometheus",
    "set_process_identity", "process_identity", "source_label",
    "tracing", "SPAN_NAMES",
    "report",
]


def report() -> str:
    """StatSet-style text block of the metrics registry."""
    return registry().report()
