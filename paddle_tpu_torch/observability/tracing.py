"""Structured tracing spans (counterpart of
``paddle_tpu/observability/tracing.py``): the causal-timeline half of
observability.  Every unit of work on the reader -> staging -> dispatch
-> fetch chain (and the serving admit -> batch -> dispatch -> reply
chain) emits one **span** record into the JSONL stream::

    {"ts": ..., "kind": "span", "name": "executor/dispatch",
     "trace": "t3f2a-1", "span": "3f2a-4", "parent": "3f2a-2",
     "t0": <unix s>, "dur_ms": 12.4, "labels": {...}, "events": [...]}

* **trace** — one causal tree: a serving request's lifecycle, or one
  ``run_pipelined`` generator run with its staging and dispatch children.
* **span** / **parent** — the tree edges.  Parent linkage is implicit
  (a thread-local stack maintained by :func:`span` / :func:`attach`) or
  explicit (``parent=`` for cross-thread children: the staging worker's
  spans parent to the pipelined root; a serving request's span starts on
  the submitting thread and ends on the dispatcher thread).
* **events** — point-in-time annotations riding inside a span (retry
  attempts at the dispatch rims).

Span names are literal members of the frozen :data:`SPAN_NAMES` table,
whose rows are the JAX package's for every span this package emits,
under the same name gate as ``metrics.METRIC_NAMES``.

Span creation sites are gated by their callers (``Executor._observing()``,
the reader's ``instrument``), never here: with ``observe`` off the hot
paths construct no Span objects.  On the card a span is host time around
a dispatch; a captured step's spans wrap its replay call, never the
captured body (code inside a capture runs once, at capture).

:func:`build_traces` / :func:`span_stats` / :func:`critical_path` are
the library form of the JAX package's ``trace`` command.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from . import export as _export

__all__ = [
    "SPAN_NAMES", "Span", "span", "start_span", "current_span",
    "add_event", "attach", "ROOT",
    "CTX_VERSION", "RemoteParent", "inject", "extract",
    "build_traces", "span_stats", "critical_path", "render_trace",
]

# ---------------------------------------------------------------------------
# Frozen span-name registry.  (name, help) — names passed to span()/
# start_span() MUST appear here as literals (AST-gated in
# tests/test_torch_observability.py; duplicates rejected at import).
# ---------------------------------------------------------------------------
SPAN_NAMES = (
    ("executor/step", "one Executor.run / run_steps call end to end "
     "(dispatch + state writeback + fetch materialization); labels: "
     "path, steps, fingerprint"),
    ("executor/dispatch", "the compiled-step call itself, inside the "
     "fault-tolerance rim (retry attempts attach as span events)"),
    ("executor/fetch_block", "host time materializing fetches to numpy "
     "(the return_numpy conversion barrier)"),
    ("executor/run_pipelined", "root of one pipelined generator run; "
     "staging and dispatch spans are its children"),
    ("pipeline/stage", "staging worker: stack_feeds + device_put for "
     "one dispatch chunk (kind=scan) or one feed (kind=single)"),
    ("reader/pipeline", "root of one prefetch/interleave engine run "
     "(instrumented); per-item worker spans are its children"),
    ("reader/item", "one worker-produced item: the source pull (decode/"
     "feed build) up to the queue offer"),
    ("serving/request", "request lifecycle admit -> terminal completion "
     "(one trace per request; ends with status=ok or the typed error)"),
    ("serving/batch", "one coalesced serving batch: staging pickup -> "
     "dispatch -> reply; labels link member request ids and traces"),
    ("serving/decode_step", "one token step of a decode slot pool: the "
     "batched incremental-decode dispatch advancing every live slot by "
     "one token (retry attempts attach as span events); labels: model, "
     "active, step"),
    ("opprof/op", "one op's measured windows in a per-op profile run "
     "(observability.opprof eager replay); labels: op_type, index"),
    ("sparse/pull", "one batch's pre-dispatch sparse-table pulls "
     "(id dedup + cache-first row fetch + feed injection across all "
     "bound tables); labels: tables"),
    ("sparse/push", "one batch's post-dispatch gradient pushes (host-"
     "side sparse optimizer update across all bound tables, inside the "
     "sparse.push fault-injection/retry rim); labels: tables"),
    ("sparse/prefetch", "root of one pull-ahead prefetch run over a "
     "feed stream (SparseSession.prefetch_feeds): the worker thread's "
     "per-batch sparse/pull spans cross-thread-parent to it; labels: "
     "depth"),
    ("pserver/rpc", "one client round against the pserver fleet: "
     "partition ids by shard -> write every shard's batched frame -> "
     "read every reply (pipelined, so N-shard latency is max not sum); "
     "retry attempts attach as span events; labels: op, table, shards — "
     "and, parented onto the remote caller via the wire ctx field, one "
     "server-side frame (labels: side=server, op, shard, queue_ms, "
     "kernel_ms)"),
)

_REGISTERED = tuple(n for n, _ in SPAN_NAMES)
if len(set(_REGISTERED)) != len(_REGISTERED):      # pragma: no cover
    raise ValueError("duplicate span name in SPAN_NAMES")
_REGISTERED_SET = frozenset(_REGISTERED)

# Sentinel parent: force a NEW root trace even when a thread-local span
# is active (serving requests are one-trace-per-request by contract).
ROOT = object()

_ids = itertools.count(1)
_prefix = f"{os.getpid() & 0xfffff:05x}"
_tls = threading.local()


def _next_id() -> str:
    return f"{_prefix}-{next(_ids):x}"


def current_span() -> Optional["Span"]:
    """Innermost span attached to THIS thread (via :func:`span` /
    :func:`attach`), or None."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


class Span:
    """One timed unit of work.  Construct via :func:`start_span` (or the
    :func:`span` context manager); finish exactly once with :meth:`end`
    — which emits the JSONL record — or discard with :meth:`cancel`."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t0",
                 "labels", "events", "_t0_perf", "_done")

    def __init__(self, name: str, trace_id: str, parent_id: Optional[str],
                 labels: Dict[str, object]):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _next_id()
        self.parent_id = parent_id
        self.t0 = time.time()
        self._t0_perf = time.perf_counter()
        self.labels = labels
        self.events: List[dict] = []
        self._done = False

    def event(self, name: str, **fields):
        """Attach a point-in-time event (retry, breaker transition) to
        this span; rides inside the span's JSONL record."""
        if self._done:
            return
        self.events.append({"name": str(name),
                            "ts": round(time.time(), 6), **fields})

    def end(self, **labels):
        """Finish the span and emit its record (idempotent)."""
        if self._done:
            return
        self._done = True
        if not _export.log_path():
            return                 # no sink: nothing to build
        dur_ms = (time.perf_counter() - self._t0_perf) * 1e3
        if labels:
            self.labels = {**self.labels, **labels}
        payload = {"name": self.name, "trace": self.trace_id,
                   "span": self.span_id, "parent": self.parent_id,
                   "t0": round(self.t0, 6), "dur_ms": round(dur_ms, 3)}
        if self.labels:
            payload["labels"] = self.labels
        if self.events:
            payload["events"] = self.events
        _export.emit_event("span", **payload)

    def cancel(self):
        """Discard without emitting (e.g. the reader's final empty pull)."""
        self._done = True

    def __repr__(self):
        return (f"Span({self.name!r}, trace={self.trace_id}, "
                f"span={self.span_id}, parent={self.parent_id})")


def start_span(name: str, parent=None, **labels) -> Span:
    """Begin a span.  ``parent``: another :class:`Span` (cross-thread
    linkage), :data:`ROOT` (force a new trace), or None (the calling
    thread's current span, else a new trace).  Labels must be
    JSON-serializable."""
    if name not in _REGISTERED_SET:
        raise KeyError(
            f"unknown span name {name!r}; span names are frozen in "
            f"observability.tracing.SPAN_NAMES — add it there (the name "
            f"gate enforces literal, registered names)")
    if parent is None:
        parent = current_span()
    elif parent is ROOT:
        parent = None
    if parent is None:
        trace_id, parent_id = "t" + _next_id(), None
    else:
        trace_id, parent_id = parent.trace_id, parent.span_id
    return Span(name, trace_id, parent_id, labels)


class _SpanContext:
    """``with span(...)``: pushes onto the thread-local stack, ends the
    span on exit.  Also usable around a yield-free region only —
    generators should hold a Span and use :func:`attach` per resume."""

    __slots__ = ("_sp",)

    def __init__(self, sp: Span):
        self._sp = sp

    def __enter__(self) -> Span:
        _tls.__dict__.setdefault("stack", []).append(self._sp)
        return self._sp

    def __exit__(self, *exc):
        stack = getattr(_tls, "stack", None)
        if stack and stack[-1] is self._sp:
            stack.pop()
        self._sp.end()
        return False


def span(name: str, parent=None, **labels) -> _SpanContext:
    """Context manager: start a span, make it the thread's current span,
    end it on exit."""
    return _SpanContext(start_span(name, parent=parent, **labels))


class _AttachContext:
    __slots__ = ("_sp",)

    def __init__(self, sp: Span):
        self._sp = sp

    def __enter__(self) -> Span:
        _tls.__dict__.setdefault("stack", []).append(self._sp)
        return self._sp

    def __exit__(self, *exc):
        stack = getattr(_tls, "stack", None)
        if stack and stack[-1] is self._sp:
            stack.pop()
        return False


def attach(sp: Span) -> _AttachContext:
    """Make ``sp`` the thread's current span for a region WITHOUT ending
    it on exit — how a long-lived root (a pipelined generator) parents
    the spans created inside each resume."""
    return _AttachContext(sp)


def add_event(name: str, **fields):
    """Attach an event to the calling thread's current span (no-op when
    none is active)."""
    sp = current_span()
    if sp is not None:
        sp.event(name, **fields)


# ---------------------------------------------------------------------------
# Cross-process context propagation (the Dapper-style wire rim)
# ---------------------------------------------------------------------------
# Compact versioned encoding "1:<trace>:<span>".  ":" because span ids
# already contain "-" (pid-prefix-counter); a future format bump changes
# the leading version and old receivers reject-and-count, never crash.
CTX_VERSION = 1


class RemoteParent:
    """Parent carrier extracted from a wire context: just the two ids a
    child span needs.  Duck-types the ``parent=`` argument of
    :func:`start_span` (which reads only ``trace_id``/``span_id``), so a
    server-side span parents onto its remote caller exactly like a
    cross-thread one."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self):
        return (f"RemoteParent(trace={self.trace_id}, "
                f"span={self.span_id})")


def inject(sp: Optional[Span] = None) -> Optional[str]:
    """Wire encoding of ``sp`` (default: the calling thread's current
    span); None when there is nothing to propagate — callers add no wire
    field in that case, keeping frames byte-identical when not observing."""
    if sp is None:
        sp = current_span()
    if sp is None:
        return None
    return f"{CTX_VERSION}:{sp.trace_id}:{sp.span_id}"


def _reject_ctx():
    from . import metrics as _metrics
    _metrics.inc_counter("trace/context_rejected")
    return None


def extract(ctx) -> Optional[RemoteParent]:
    """Decode a wire context produced by :func:`inject`.  An ABSENT
    context (None) is normal and returns None silently; a PRESENT but
    malformed/unknown-version one is ignored-and-counted
    (``trace/context_rejected``) — propagation failures degrade to a
    fresh trace, never to a failed request."""
    if ctx is None:
        return None
    if not isinstance(ctx, str):
        return _reject_ctx()
    parts = ctx.split(":")
    if len(parts) != 3 or parts[0] != str(CTX_VERSION) \
            or not parts[1] or not parts[2]:
        return _reject_ctx()
    return RemoteParent(parts[1], parts[2])


# ---------------------------------------------------------------------------
# Trace reconstruction (the JAX package's `trace` engine)
# ---------------------------------------------------------------------------
def build_traces(events) -> List[dict]:
    """Group a log's span events into traces, time-ordered.

    Returns ``[{"trace": id, "t0": s, "dur_ms": span-of-spans wall,
    "spans": [span events sorted by t0], "roots": [...]}, ...]`` sorted
    by first span start.  Span events missing ids are skipped.
    """
    by_trace: Dict[str, List[dict]] = {}
    for e in events:
        if e.get("kind") != "span":
            continue
        tid = e.get("trace")
        if not tid or not e.get("span"):
            continue
        by_trace.setdefault(tid, []).append(e)
    traces = []
    for tid, spans in by_trace.items():
        spans.sort(key=lambda e: (e.get("t0", 0.0), e.get("span", "")))
        ids = {e["span"] for e in spans}
        roots = [e for e in spans
                 if not e.get("parent") or e["parent"] not in ids]
        t0 = min(e.get("t0", 0.0) for e in spans)
        t1 = max(e.get("t0", 0.0) + e.get("dur_ms", 0.0) / 1e3
                 for e in spans)
        traces.append({"trace": tid, "t0": t0,
                       "dur_ms": round((t1 - t0) * 1e3, 3),
                       "spans": spans, "roots": roots})
    traces.sort(key=lambda t: t["t0"])
    return traces


def span_stats(events) -> Dict[str, dict]:
    """Per-span-name latency stats over a log: count, total, p50/p99/max
    of dur_ms."""
    durs: Dict[str, List[float]] = {}
    for e in events:
        if e.get("kind") == "span" and e.get("name"):
            durs.setdefault(e["name"], []).append(float(e.get("dur_ms", 0.0)))
    out = {}
    for name, ds in sorted(durs.items()):
        ds.sort()
        n = len(ds)
        out[name] = {
            "count": n, "total_ms": round(sum(ds), 3),
            "p50_ms": round(ds[n // 2], 3),
            "p99_ms": round(ds[min(n - 1, int(n * 0.99))], 3),
            "max_ms": round(ds[-1], 3),
        }
    return out


def critical_path(trace: dict) -> List[dict]:
    """Longest root→leaf chain by end time: from the latest-ending root,
    repeatedly descend into the child whose end time is latest.  The
    chain names where a trace's wall clock actually went."""
    spans = trace["spans"]
    children: Dict[str, List[dict]] = {}
    for e in spans:
        if e.get("parent"):
            children.setdefault(e["parent"], []).append(e)

    def end(e):
        return e.get("t0", 0.0) + e.get("dur_ms", 0.0) / 1e3

    path = []
    roots = trace["roots"] or spans[:1]
    node = max(roots, key=end, default=None)
    seen = set()
    while node is not None and node["span"] not in seen:
        seen.add(node["span"])
        path.append(node)
        kids = children.get(node["span"], [])
        node = max(kids, key=end, default=None)
    return path


def render_trace(trace: dict, max_spans: int = 40) -> str:
    """Indented timeline of one trace: offset from trace start, name,
    duration, labels; children nest under parents."""
    spans = trace["spans"]
    by_id = {e["span"]: e for e in spans}
    depth: Dict[str, int] = {}

    def d(e):
        sid = e["span"]
        if sid in depth:
            return depth[sid]
        p = e.get("parent")
        depth[sid] = 0 if not p or p not in by_id else d(by_id[p]) + 1
        return depth[sid]

    lines = [f"trace {trace['trace']}  ({len(spans)} span(s), "
             f"{trace['dur_ms']} ms)"]
    for e in spans[:max_spans]:
        off = (e.get("t0", 0.0) - trace["t0"]) * 1e3
        labels = e.get("labels") or {}
        lbl = " ".join(f"{k}={v}" for k, v in sorted(labels.items())
                       if not isinstance(v, (list, dict)))
        evs = "".join(f" !{ev['name']}" for ev in e.get("events", []))
        lines.append(f"  {'  ' * d(e)}[+{off:9.2f} ms] {e['name']} "
                     f"({e.get('dur_ms', 0.0):.2f} ms)"
                     + (f"  {lbl}" if lbl else "") + evs)
    if len(spans) > max_spans:
        lines.append(f"  ... {len(spans) - max_spans} more span(s)")
    return "\n".join(lines)
