"""Export and surfacing (counterpart of
``paddle_tpu/observability/export.py``): the JSONL structured log,
merged snapshots, card-memory sampling, periodic reports, log merging
and summaries, and Prometheus text exposition.

The JSONL log (flag ``metrics_log``, env
``PADDLE_TPU_TORCH_METRICS_LOG``) is an append-only stream of one-line
JSON events, opened by an ``identity`` header::

    {"ts": <unix s>, "kind": "step",     ...per-dispatch telemetry}
    {"ts": <unix s>, "kind": "snapshot", ...metrics_snapshot() payload}
    {"ts": <unix s>, "kind": "nan",      ...NaN-provenance diagnostic}

The event schema is the JAX package's, so either package's summaries
read either package's logs.  :func:`summarize_log` is the library form
of the JAX package's ``stats`` command; the v1 analog is
``Stat::printAllStatus`` driven by ``log_period`` (utils/Stat.h:230,
Flags.cpp:62): here the period lives in the trainer
(:func:`maybe_periodic_report`) and the sink is structured.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional

from .. import flags as _flags
from . import metrics as _metrics
from ..testing import lockwatch as _lw

logger = logging.getLogger("paddle_tpu_torch")

__all__ = [
    "log_path", "emit_event", "metrics_snapshot", "sample_device_memory",
    "periodic_report", "maybe_periodic_report", "summarize_log",
    "summarize_logs", "iter_log_events", "to_prometheus", "prom_name",
    "set_process_identity", "source_label",
]

# Who this process is, stamped into every (re)opened JSONL log as the
# first event the writer appends — multi-file merges then label sources
# "pserver:1" instead of a bare argument index.  Process mains (the
# pserver shard's) set this before their first emit.
_identity = {"role": None, "index": None}


def set_process_identity(role: Optional[str],
                         index: Optional[int] = None):
    """Declare this process's role (``trainer``/``pserver``/``serve``/
    ``fleet``/...) and optional shard/replica index for JSONL identity
    stamping.  ``None`` resets to the default (``main``)."""
    _identity["role"] = None if role is None else str(role)
    _identity["index"] = None if index is None else int(index)


def source_label(f: dict) -> str:
    """Human label for one merged-log source: ``role`` or ``role:index``
    when the log stamped identity, else the bare argument position."""
    role = f.get("role")
    if role:
        idx = f.get("proc_index")
        return f"{role}:{idx}" if idx is not None else str(role)
    return str(f.get("index", "?"))


def log_path() -> str:
    """Active JSONL metrics log path ('' = disabled)."""
    return str(_flags.get_flag("metrics_log") or "")


class _Writer:
    """Lazily-opened, thread-safe, line-buffered JSONL appender that
    follows the ``metrics_log`` flag (a changed path reopens)."""

    def __init__(self):
        self._lock = _lw.make_lock("observability.export")
        self._path: Optional[str] = None
        self._fh = None

    def emit(self, kind: str, payload: dict):
        path = log_path()
        if not path:
            return
        line = json.dumps({"ts": round(time.time(), 6), "kind": kind,
                           **payload}, default=repr)
        with self._lock:
            if self._path != path:
                if self._fh is not None:
                    self._fh.close()
                self._fh, self._path = None, path
                try:
                    self._fh = open(path, "a")
                    # identity header: first line this process appends
                    # to a (re)opened log — role/pid/index label every
                    # event that follows in multi-file merges
                    ident = {"ts": round(time.time(), 6),
                             "kind": "identity",
                             "role": _identity["role"] or "main",
                             "pid": os.getpid()}
                    if _identity["index"] is not None:
                        ident["index"] = _identity["index"]
                    self._fh.write(json.dumps(ident) + "\n")
                    self._fh.flush()
                except OSError as e:
                    logger.warning("metrics log %r unwritable (%s); "
                                   "disabling until the path changes",
                                   path, e)
                    if self._fh is not None:
                        try:
                            self._fh.close()
                        except OSError:
                            pass
                    self._fh = None
            if self._fh is None:       # disabled: an earlier open/write
                return                 # on this path failed
            try:
                self._fh.write(line + "\n")
                self._fh.flush()
            except OSError as e:
                logger.warning("metrics log %r write failed (%s); "
                               "disabling until the path changes", path, e)
                try:
                    self._fh.close()
                except OSError:
                    pass               # already broken; disabling anyway
                self._fh = None        # path unchanged -> stays disabled

    def close(self):
        with self._lock:
            if self._fh is not None:
                self._fh.close()
            self._fh, self._path = None, None


_writer = _Writer()


def emit_event(kind: str, **payload):
    """Append one structured event to the JSONL log (no-op when the
    ``metrics_log`` flag is empty)."""
    _writer.emit(kind, payload)


def _reset_writer():
    """Close the writer (tests; also safe any time — next emit reopens)."""
    _writer.close()


# ---------------------------------------------------------------------------
# Snapshots
# ---------------------------------------------------------------------------
_mem_supported: Optional[bool] = None


def sample_device_memory() -> Dict[str, dict]:
    """Per-card memory counters of the caching allocator
    (``torch.cuda.memory_allocated`` / ``max_memory_allocated`` /
    ``memory_reserved``, host-side reads: no device sync), labelled
    ``cuda:<index>`` with the card's name.  Also mirrors bytes_in_use
    and its peak into the device/* gauges.  Returns {} without a card,
    as the JAX package does for a backend without memory stats, and
    remembers that, so hot-path callers pay one probe."""
    global _mem_supported
    if _mem_supported is False:
        return {}
    import torch
    if not torch.cuda.is_available():
        _mem_supported = False
        return {}
    out: Dict[str, dict] = {}
    for i in range(torch.cuda.device_count()):
        label = f"cuda:{i}"
        ms = {"bytes_in_use": int(torch.cuda.memory_allocated(i)),
              "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(i)),
              "bytes_reserved": int(torch.cuda.memory_reserved(i))}
        _metrics.set_gauge("device/bytes_in_use", ms["bytes_in_use"],
                           label=label)
        _metrics.set_gauge("device/peak_bytes_in_use",
                           ms["peak_bytes_in_use"], label=label)
        out[label] = {"device_name": _device_name(i), **ms}
    _mem_supported = True
    return out


_names: Dict[int, str] = {}


def _device_name(i: int) -> str:
    if i not in _names:
        import torch
        _names[i] = torch.cuda.get_device_name(i)
    return _names[i]


def metrics_snapshot() -> dict:
    """One merged, JSON-serializable view of the whole runtime:

    * ``metrics``  — every registry metric (counters/gauges/histograms),
    * ``compile``  — the captured-step counters of
      ``core/compile_cache.py`` re-keyed ``compile/<name>`` (captures,
      replays, warmups, hits, misses, evictions; ``compile/uncaptured``
      holds the interpreted steps by reason),
    * ``device_memory`` — per-card memory (:func:`sample_device_memory`).
    """
    from ..core import compile_cache
    return {
        "metrics": _metrics.registry().snapshot(),
        "compile": {f"compile/{k}": v
                    for k, v in compile_cache.stats().snapshot().items()},
        "device_memory": sample_device_memory(),
    }


# ---------------------------------------------------------------------------
# Periodic reports (the log_period wiring)
# ---------------------------------------------------------------------------
def periodic_report(step: int):
    """Emit one merged report: StatSet+capture stats+Metrics text at INFO,
    plus a ``snapshot`` event in the JSONL log."""
    from .. import profiler
    _metrics.inc_counter("trainer/reports")
    logger.info("observability report @ step %d\n%s", step,
                profiler.report())
    emit_event("snapshot", step=step, **metrics_snapshot())


def maybe_periodic_report(iters_done: int,
                          observing: Optional[bool] = None) -> bool:
    """Trainer hook: fire :func:`periodic_report` every ``log_period``
    iterations (Flags.cpp:62).  ``observing`` overrides the global flag
    (an ``Executor(observe=True)`` trainer reports even when the
    process-wide flag is off).  Returns whether a
    report fired."""
    if not (_metrics.enabled() if observing is None else observing):
        return False
    try:
        period = int(_flags.get_flag("log_period"))
    except (TypeError, ValueError):
        return False
    if period <= 0 or iters_done <= 0 or iters_done % period:
        return False
    periodic_report(iters_done)
    return True


# ---------------------------------------------------------------------------
# Log reading (shared by the `stats` / `trace` / `doctor` engines)
# ---------------------------------------------------------------------------
def iter_log_events(paths) -> "tuple[List[dict], List[dict]]":
    """Read one or more JSONL logs, merged in time order.

    A supervised run that resumed after SIGTERM/exit-75 produces one log
    per relaunch; summaries should span the whole job, so every CLI
    consumer accepts multiple files.  Returns ``(events, files)`` where
    ``files`` records per-file boundaries (path, first/last ts, event and
    corrupt-line counts) — the restart markers the timeline renders.

    Robustness (the chaos suite's SIGKILL mid-write case): a torn or
    truncated final line — including one cut inside a multi-byte UTF-8
    character — is skipped and counted, never fatal (``errors="replace"``
    keeps the read itself from raising ``UnicodeDecodeError``).  Raises
    OSError only for an unreadable file (the CLI wraps it).
    """
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    events: List[dict] = []
    files: List[dict] = []
    for src, path in enumerate(paths):
        n = corrupt = 0
        t_first = t_last = None
        role = pid = proc_index = None
        with open(path, errors="replace") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                n += 1
                try:
                    ev = json.loads(line)
                    if not isinstance(ev, dict):
                        raise json.JSONDecodeError("not an object", line, 0)
                except json.JSONDecodeError:
                    corrupt += 1
                    continue
                if ev.get("kind") == "identity" and role is None:
                    # the writer's open-time stamp: the FIRST one names
                    # the process this file belongs to (appends from a
                    # relaunch re-stamp, but the role stays the same)
                    role = ev.get("role")
                    pid = ev.get("pid")
                    proc_index = ev.get("index")
                ts = ev.get("ts")
                if isinstance(ts, (int, float)) \
                        and not isinstance(ts, bool):
                    t_first = ts if t_first is None else t_first
                    t_last = ts
                else:
                    # every writer stamps a numeric ts; a foreign/hand-
                    # edited line with a missing or string ts must stay
                    # mergeable (the sort key is numeric), not crash the
                    # summary — coerce to the file position
                    ev = {**ev, "ts": t_last if t_last is not None
                          else 0.0}
                # carry the SOURCE FILE index through the time-ordered
                # merge: relaunch logs interleave by coerced ts only, so
                # without it a rendered row cannot be attributed to the
                # right attempt (the `files` list maps index -> path)
                ev["_src"] = src
                events.append(ev)
        if corrupt:
            logger.warning("metrics log %r: skipped %d corrupt/truncated "
                           "line(s) (torn writes from a killed process "
                           "are expected; the summary continues)",
                           str(path), corrupt)
        files.append({"file": str(path), "index": src, "events": n,
                      "corrupt_lines": corrupt,
                      "t_first": t_first, "t_last": t_last,
                      "role": role, "pid": pid,
                      "proc_index": proc_index})
    if len(files) > 1:
        files.sort(key=lambda f: (f["t_first"] is None,
                                  f["t_first"] or 0.0))
        events.sort(key=lambda e: e.get("ts", 0.0))
    return events, files


# ---------------------------------------------------------------------------
# Log summarization (the JAX package's `stats` engine)
# ---------------------------------------------------------------------------
def summarize_log(path: str) -> dict:
    """Aggregate ONE JSONL metrics log into a run summary dict (see
    :func:`summarize_logs` for the multi-file / resumed-job form)."""
    return summarize_logs([path])


def summarize_logs(paths) -> dict:
    """Aggregate one or more JSONL metrics logs (merged in time order —
    a resumed job's per-relaunch logs summarize as one run) into one
    summary dict.  Tolerates corrupt/torn lines (counted, not fatal);
    raises OSError for an unreadable file (the CLI wraps it)."""
    events, files = iter_log_events(paths)
    steps: List[dict] = []
    nans: List[dict] = []
    faults: List[dict] = []
    servings: List[dict] = []
    tunings: List[dict] = []
    pservers: List[dict] = []
    ckpts: List[dict] = []
    spans = 0
    last_snapshot: Optional[dict] = None
    snapshots = 0
    t_first = t_last = None
    for ev in events:
        ts = ev.get("ts")
        if isinstance(ts, (int, float)):
            t_first = ts if t_first is None else min(t_first, ts)
            t_last = ts if t_last is None else max(t_last, ts)
        kind = ev.get("kind")
        if kind == "step":
            steps.append(ev)
        elif kind == "snapshot":
            snapshots += 1
            last_snapshot = ev
        elif kind == "nan":
            nans.append(ev)
        elif kind == "fault":
            faults.append(ev)
        elif kind == "serving":
            servings.append(ev)
        elif kind == "tuning":
            tunings.append(ev)
        elif kind == "pserver":
            pservers.append(ev)
        elif kind == "ckpt":
            ckpts.append(ev)
        elif kind == "span":
            spans += 1

    total = sum(f["events"] for f in files)
    corrupt = sum(f["corrupt_lines"] for f in files)
    summary: dict = {
        "events": total, "corrupt_lines": corrupt,
        "snapshots": snapshots, "nan_events": len(nans),
        "spans": spans,
        "wall_s": round(t_last - t_first, 3)
        if t_first is not None and t_last is not None else None,
    }
    if len(files) > 1:
        # restart boundaries: where each relaunch's log begins; "source"
        # is the index fault-timeline rows carry (the original argument
        # position, stable across the time-order sort); "role" labels
        # it by process identity when the log stamped one
        summary["restarts"] = [
            {"file": f["file"], "source": f["index"], "ts": f["t_first"],
             "events": f["events"],
             **({"role": source_label(f)} if f.get("role") else {})}
            for f in files]
    if steps:
        n_steps = sum(int(e.get("steps", 1)) for e in steps)
        # cold dispatches (trace/compile happened inside the call) carry
        # step_ms=None by design — compile time must not read as step time
        step_ms = sorted(float(e["step_ms"]) for e in steps
                         if e.get("step_ms") is not None)
        feed_b = sum(float(e.get("feed_bytes", 0)) for e in steps)
        wall_s = sum(float(e.get("wall_ms", 0)) for e in steps) / 1e3
        summary["steps"] = {
            "dispatches": len(steps), "steps": n_steps,
            "cold_dispatches": sum(1 for e in steps
                                   if e.get("cold_compile")),
            "step_ms_mean": round(sum(step_ms) / len(step_ms), 3)
            if step_ms else None,
            "step_ms_p50": round(step_ms[len(step_ms) // 2], 3)
            if step_ms else None,
            "step_ms_p90": round(step_ms[int(len(step_ms) * 0.9)
                                         - (len(step_ms) == 1)], 3)
            if step_ms else None,
            "feed_mb": round(feed_b / 2 ** 20, 3),
            "steps_per_sec": round(n_steps / wall_s, 2) if wall_s else None,
        }
    if last_snapshot is not None:
        hists = {}
        for name, snap in (last_snapshot.get("metrics") or {}).items():
            if snap.get("kind") == "histogram" and snap.get("count"):
                hists[name] = {
                    "count": snap["count"],
                    "mean": round(snap["sum"] / snap["count"], 3),
                    "p50": round(_metrics.histogram_quantile(snap, 0.5), 3),
                    "p90": round(_metrics.histogram_quantile(snap, 0.9), 3),
                    "max": snap["max"],
                }
        counters = {
            name: snap["value"]
            for name, snap in (last_snapshot.get("metrics") or {}).items()
            if snap.get("kind") == "counter" and snap.get("value")}
        busy = counters.get("pipeline/worker_busy_s", 0.0)
        wait = counters.get("pipeline/worker_wait_s", 0.0)
        summary["last_snapshot"] = {
            "histograms": hists, "counters": counters,
            "compile": last_snapshot.get("compile") or {},
            "worker_busy_fraction": round(busy / (busy + wait), 4)
            if busy + wait > 0 else None,
        }
    if nans:
        summary["nan"] = [{k: e.get(k) for k in
                           ("op_index", "op_type", "var", "phase")}
                          for e in nans[:5]]
    if faults:
        by_event: Dict[str, int] = {}
        for e in faults:
            key = str(e.get("event", "unknown"))
            by_event[key] = by_event.get(key, 0) + 1
        multi = len(files) > 1
        roles = {f["index"]: source_label(f) for f in files
                 if f.get("role")}

        def _fault_row(e):
            row = {k: e.get(k) for k in
                   ("event", "site", "index", "action", "step",
                    "attempt", "error", "delay_s")
                   if e.get(k) is not None}
            if multi:
                # a merged timeline interleaves relaunch logs by ts
                # only; the source-file index makes each row
                # attributable to the right attempt (plus the role
                # label when that file stamped identity)
                row["source"] = e.get("_src")
                if e.get("_src") in roles:
                    row["role"] = roles[e["_src"]]
            return row

        summary["faults"] = {
            "events": len(faults), "by_event": by_event,
            # first few, enough to see a run's failure story at a glance
            "timeline": [_fault_row(e) for e in faults[:10]],
        }
    if servings:
        by_event: Dict[str, int] = {}
        models = set()
        batches = [e for e in servings if e.get("event") == "batch"]
        for e in servings:
            key = str(e.get("event", "unknown"))
            by_event[key] = by_event.get(key, 0) + 1
            if e.get("model"):
                models.add(str(e["model"]))
        served = sum(int(e.get("size", 0)) for e in batches)
        sizes = [int(e.get("size", 0)) for e in batches]
        dms = sorted(float(e["dispatch_ms"]) for e in batches
                     if e.get("dispatch_ms") is not None)
        summary["serving"] = {
            "events": len(servings), "by_event": by_event,
            "models": sorted(models),
            "batches": len(batches), "requests_served": served,
            "batch_size_mean": round(sum(sizes) / len(sizes), 2)
            if sizes else None,
            "dispatch_ms_p50": round(dms[len(dms) // 2], 3)
            if dms else None,
            "shed": by_event.get("shed", 0),
            "deadline_expired": by_event.get("deadline_expired", 0),
            "breaker_opens": by_event.get("breaker_open", 0),
            "states": [str(e.get("state")) for e in servings
                       if e.get("event") == "state"],
        }
        dec_steps = [e for e in servings if e.get("event") == "decode_step"]
        dec_done = [e for e in servings if e.get("event") == "decode_done"]
        if dec_steps or dec_done:
            active = [int(e.get("active", 0)) for e in dec_steps]
            sdms = sorted(float(e["dispatch_ms"]) for e in dec_steps
                          if e.get("dispatch_ms") is not None)
            ttfts = sorted(float(e["ttft_ms"]) for e in servings
                           if e.get("event") == "decode_admit"
                           and e.get("ttft_ms") is not None)
            summary["decode"] = {
                "steps": len(dec_steps),
                "sequences_done": len(dec_done),
                "tokens": sum(int(e.get("tokens", 0)) for e in dec_done),
                "active_mean": round(sum(active) / len(active), 2)
                if active else None,
                "step_ms_p50": round(sdms[len(sdms) // 2], 3)
                if sdms else None,
                "ttft_ms_p50": round(ttfts[len(ttfts) // 2], 3)
                if ttfts else None,
                "by_finish": {
                    f: sum(1 for e in dec_done if e.get("finish") == f)
                    for f in sorted({str(e.get("finish"))
                                     for e in dec_done})},
            }
    if tunings:
        by_event: Dict[str, int] = {}
        for e in tunings:
            key = str(e.get("event", "unknown"))
            by_event[key] = by_event.get(key, 0) + 1
        summary["tuning"] = {
            "events": len(tunings), "by_event": by_event,
            "trials": by_event.get("trial", 0),
            "winners": [{"tunable": e.get("tunable"),
                         "config": e.get("config"),
                         "speedup": e.get("speedup")}
                        for e in tunings if e.get("event") == "winner"],
            "refusals": [{"tunable": e.get("tunable"),
                          "reason": e.get("reason"),
                          "speedup": e.get("speedup")}
                         for e in tunings if e.get("event") == "refusal"],
            "replays": [{"tunable": e.get("tunable"),
                         "config": e.get("config")}
                        for e in tunings if e.get("event") == "replay"],
        }
    if pservers:
        by_event: Dict[str, int] = {}
        shards = set()
        for e in pservers:
            key = str(e.get("event", "unknown"))
            by_event[key] = by_event.get(key, 0) + 1
            if e.get("shard") is not None:
                shards.add(int(e["shard"]))
        shut = [e for e in pservers if e.get("event") == "shutdown"]
        summary["pserver"] = {
            "events": len(pservers), "by_event": by_event,
            "shards": sorted(shards),
            "checkpoints": by_event.get("checkpoint", 0),
            "restores": [{"shard": e.get("shard"),
                          "source": e.get("source"),
                          "pushes_applied": e.get("pushes_applied")}
                         for e in pservers
                         if e.get("event") == "restore"],
            "pulls": sum(int(e.get("pulls", 0)) for e in shut),
            "pushes": sum(int(e.get("pushes", 0)) for e in shut),
            "wire_mb_in": round(sum(
                float(e.get("wire_bytes_in", 0)) for e in shut) / 2 ** 20,
                3),
            "wire_mb_out": round(sum(
                float(e.get("wire_bytes_out", 0))
                for e in shut) / 2 ** 20, 3),
        }
    if ckpts:
        commits = [e for e in ckpts if e.get("event") == "commit"]
        fulls = [e for e in commits if e.get("commit_kind") == "full"]
        deltas = [e for e in commits if e.get("commit_kind") == "delta"]
        cms = sorted(float(e["ms"]) for e in commits
                     if e.get("ms") is not None)
        summary["checkpoint"] = {
            "events": len(ckpts), "commits": len(commits),
            "full": len(fulls), "delta": len(deltas),
            "rebases": sum(1 for e in commits if e.get("rebase")),
            "delta_mb": round(sum(float(e.get("bytes", 0))
                                  for e in deltas) / 2 ** 20, 3),
            "delta_rows": sum(int(e.get("rows", 0)) for e in deltas),
            "full_mb": round(sum(float(e.get("bytes", 0))
                                 for e in fulls) / 2 ** 20, 3),
            "commit_ms_p50": round(cms[len(cms) // 2], 3) if cms else None,
            "max_chain_len": max((int(e.get("chain_len", 0))
                                  for e in commits), default=0),
        }
    if last_snapshot is not None:
        # lock-order watchdog (testing.lockwatch): only populated when
        # the run had PADDLE_TPU_LOCKWATCH on — absent metrics mean the
        # watchdog was off, and the section is omitted entirely
        m = last_snapshot.get("metrics") or {}
        held = m.get("concurrency/lock_held_ms") or {}
        edges = ((m.get("concurrency/order_edges") or {})
                 .get("values") or {})
        if held.get("count"):
            summary["lockwatch"] = {
                "holds": held.get("count", 0),
                "held_ms_max": held.get("max"),
                "order_edges": int(edges.get("", 0)),
                "order_violations": int(
                    (m.get("concurrency/order_violations") or {})
                    .get("value", 0)),
                "long_holds": int(
                    (m.get("concurrency/long_holds") or {})
                    .get("value", 0)),
            }
    return summary


def render_summary(summary: dict) -> str:
    """Human-readable rendering of :func:`summarize_log` output."""
    lines = [f"events={summary['events']} "
             f"snapshots={summary['snapshots']} "
             f"nan_events={summary['nan_events']} "
             f"spans={summary.get('spans', 0)} "
             f"corrupt_lines={summary['corrupt_lines']}"
             + (f" wall_s={summary['wall_s']}"
                if summary.get("wall_s") is not None else "")]
    for r in summary.get("restarts", []):
        tag = r.get("role") or r.get("source", "?")
        lines.append(f"  restart boundary: [{tag}] "
                     f"{r['file']} "
                     f"({r['events']} event(s), from ts={r['ts']})")
    st = summary.get("steps")
    if st:
        lines.append(
            f"steps: {st['steps']} in {st['dispatches']} dispatches, "
            f"step_ms mean={st['step_ms_mean']} p50={st['step_ms_p50']} "
            f"p90={st['step_ms_p90']}, feed={st['feed_mb']} MB"
            + (f", {st['steps_per_sec']} steps/s"
               if st.get("steps_per_sec") else ""))
    snap = summary.get("last_snapshot")
    if snap:
        for name, h in sorted(snap["histograms"].items()):
            lines.append(f"  {name}: count={h['count']} mean={h['mean']} "
                         f"p50={h['p50']} p90={h['p90']} max={h['max']}")
        for name, v in sorted(snap["counters"].items()):
            lines.append(f"  {name}: {v:g}")
        if snap.get("worker_busy_fraction") is not None:
            lines.append(
                f"  pipeline worker busy fraction: "
                f"{snap['worker_busy_fraction']}")
    for n in summary.get("nan", []):
        lines.append(f"  NaN: op #{n.get('op_index')} {n.get('op_type')!r} "
                     f"-> {n.get('var')!r} ({n.get('phase')})")
    fl = summary.get("faults")
    if fl:
        kinds = " ".join(f"{k}={v}" for k, v in sorted(
            fl["by_event"].items()))
        lines.append(f"faults: {fl['events']} event(s): {kinds}")
        for e in fl["timeline"]:
            lines.append("  fault: " + " ".join(
                f"{k}={e[k]}" for k in ("role", "source", "event",
                                        "site", "index", "action",
                                        "step", "attempt", "delay_s",
                                        "error") if k in e))
    sv = summary.get("serving")
    if sv:
        lines.append(
            f"serving: {sv['requests_served']} request(s) in "
            f"{sv['batches']} batch(es)"
            + (f", mean batch {sv['batch_size_mean']}"
               if sv.get("batch_size_mean") is not None else "")
            + (f", dispatch p50 {sv['dispatch_ms_p50']} ms"
               if sv.get("dispatch_ms_p50") is not None else "")
            + f" [models: {', '.join(sv['models'])}]")
        lines.append(
            f"  shed={sv['shed']} deadline_expired={sv['deadline_expired']}"
            f" breaker_opens={sv['breaker_opens']}"
            + (f" states={'→'.join(sv['states'])}" if sv["states"] else ""))
    dc = summary.get("decode")
    if dc:
        lines.append(
            f"decode: {dc['tokens']} token(s) across "
            f"{dc['sequences_done']} sequence(s) in {dc['steps']} "
            f"step(s)"
            + (f", mean active {dc['active_mean']}"
               if dc.get("active_mean") is not None else "")
            + (f", step p50 {dc['step_ms_p50']} ms"
               if dc.get("step_ms_p50") is not None else "")
            + (f", ttft p50 {dc['ttft_ms_p50']} ms"
               if dc.get("ttft_ms_p50") is not None else ""))
        if dc.get("by_finish"):
            lines.append("  finish: " + " ".join(
                f"{k}={v}" for k, v in sorted(dc["by_finish"].items())))
    tu = summary.get("tuning")
    if tu:
        kinds = " ".join(f"{k}={v}" for k, v in sorted(
            tu["by_event"].items()))
        lines.append(f"tuning: {tu['events']} event(s): {kinds}")
        for w in tu["winners"]:
            lines.append(f"  winner: {w['tunable']} -> {w['config']} "
                         f"({w['speedup']}x)")
        for r in tu["refusals"]:
            lines.append(f"  refusal: {r['tunable']} — {r['reason']}")
        for r in tu["replays"]:
            lines.append(f"  replay: {r['tunable']} -> {r['config']}")
    ps = summary.get("pserver")
    if ps:
        kinds = " ".join(f"{k}={v}" for k, v in sorted(
            ps["by_event"].items()))
        lines.append(
            f"pserver: {ps['events']} event(s) across shard(s) "
            f"{ps['shards']}: {kinds}")
        if ps["pulls"] or ps["pushes"]:
            lines.append(
                f"  served: {ps['pulls']} pull(s) {ps['pushes']} "
                f"push(es), wire {ps['wire_mb_in']} MB in / "
                f"{ps['wire_mb_out']} MB out")
        for r in ps["restores"]:
            lines.append(
                f"  restore: shard {r['shard']} from {r['source']} "
                f"(pushes_applied={r['pushes_applied']})")
    ck = summary.get("checkpoint")
    if ck:
        lines.append(
            f"checkpoint: {ck['commits']} commit(s): {ck['full']} full "
            f"({ck['full_mb']} MB) + {ck['delta']} delta "
            f"({ck['delta_mb']} MB, {ck['delta_rows']} sparse row(s)), "
            f"{ck['rebases']} rebase(s), max chain {ck['max_chain_len']}"
            + (f", commit p50 {ck['commit_ms_p50']} ms"
               if ck.get("commit_ms_p50") is not None else ""))
    lk = summary.get("lockwatch")
    if lk:
        lines.append(
            f"lockwatch: {lk['holds']} watched hold(s), "
            f"{lk['order_edges']} order edge(s), "
            f"{lk['order_violations']} violation(s), "
            f"{lk['long_holds']} long hold(s)"
            + (f", longest {lk['held_ms_max']} ms"
               if lk.get("held_ms_max") is not None else ""))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Prometheus text exposition (scrape without a new dependency)
# ---------------------------------------------------------------------------
_PROM_PREFIX = "paddle_tpu_"


def prom_name(name: str) -> str:
    """``executor/step_time_ms`` -> ``paddle_tpu_executor_step_time_ms``
    (the JAX package's names)."""
    return _PROM_PREFIX + name.replace("/", "_")


def _prom_escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


def _prom_num(v: float) -> str:
    """Full-precision sample formatting: ``%g``'s 6 significant digits
    would quantize large counters (feed_bytes at 3.2e9 stops moving
    between scrapes and rate() reads zero)."""
    f = float(v)
    if f.is_integer() and abs(f) < 2 ** 63:
        return str(int(f))
    return f"{f:.17g}"


def to_prometheus(snapshot: Optional[dict] = None) -> str:
    """Prometheus text exposition of a metrics snapshot.

    ``snapshot``: a :func:`metrics_snapshot` dict (its ``compile``
    counters are exposed as gauges too), a bare registry snapshot
    (``{name: metric-snap}``), or None for the live registry.  Names
    keep the JAX package's ``paddle_tpu_`` prefix, so one scrape
    configuration reads both packages.  Counters gain the conventional ``_total`` suffix;
    histograms expose cumulative ``_bucket``/``_sum``/``_count``.
    """
    compile_counters: Dict[str, float] = {}
    if snapshot is None:
        metrics = _metrics.registry().snapshot()
    elif "metrics" in snapshot and isinstance(snapshot["metrics"], dict):
        metrics = snapshot["metrics"]
        for k, v in (snapshot.get("compile") or {}).items():
            # "compile/hits" -> paddle_tpu_compile_hits (gauge)
            if isinstance(v, (int, float)):
                compile_counters[k] = float(v)
    else:
        metrics = snapshot
    helps = {n: h for n, _k, h in _metrics.METRIC_NAMES}
    lines: List[str] = []
    for name, snap in sorted(metrics.items()):
        base = prom_name(name)
        help_ = helps.get(name, "")
        kind = snap.get("kind")
        if kind == "counter":
            # HELP/TYPE on the _total name: in the classic text format
            # only histograms/summaries get suffix grace, so metadata on
            # the bare base would orphan the sample's family.  Don't
            # double the suffix when the metric name already carries it.
            ctr = base if base.endswith("_total") else base + "_total"
            lines.append(f"# HELP {ctr} {_prom_escape(help_)}")
            lines.append(f"# TYPE {ctr} counter")
            lines.append(f"{ctr} {_prom_num(snap['value'])}")
        elif kind == "gauge":
            if not snap["values"]:
                continue
            lines.append(f"# HELP {base} {_prom_escape(help_)}")
            lines.append(f"# TYPE {base} gauge")
            for label, v in sorted(snap["values"].items()):
                sel = f'{{label="{_prom_escape(label)}"}}' if label else ""
                lines.append(f"{base}{sel} {_prom_num(v)}")
        elif kind == "histogram":
            lines.append(f"# HELP {base} {_prom_escape(help_)}")
            lines.append(f"# TYPE {base} histogram")
            acc = 0
            for edge, c in zip(snap["boundaries"], snap["counts"]):
                acc += c
                lines.append(f'{base}_bucket{{le="{edge:g}"}} {acc}')
            lines.append(f'{base}_bucket{{le="+Inf"}} {snap["count"]}')
            lines.append(f"{base}_sum {_prom_num(snap['sum'])}")
            lines.append(f"{base}_count {snap['count']}")
    for k, v in sorted(compile_counters.items()):
        base = prom_name(k)
        lines.append(f"# TYPE {base} gauge")
        lines.append(f"{base} {_prom_num(v)}")
    return "\n".join(lines) + "\n"
