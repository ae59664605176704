"""Perf attribution: the doctor's measured budgets (counterpart of
``paddle_tpu/observability/attribution.py``).

Reads the JSONL log (``step`` events and ``span`` records) into budgets
that explain where the wall clock went:

* **training** (:func:`step_budget`) — the measured wall between the
  first dispatch start and the last dispatch end split into ``compute``
  (warm dispatch wall minus fetch block), ``fetch`` (the host waiting for
  the fetches: on the card this bucket also absorbs the device finishing
  its queued steps), ``compile`` (cold dispatches; on the card, the
  warm-up and capture of a new key), ``staging`` (stage-span time not
  overlapped with a dispatch) and ``host_other`` (the gaps);
* **serving** (:func:`serving_budget`) — queue+batch wait vs dispatch;
* **decode** (:func:`decode_budget`) — token-step dispatch vs scheduler;
* **remote** (:func:`remote_budget`) — the pserver rounds' client wire
  vs the shards' queue and kernel time.

Components sum to the measured wall by construction;
:data:`BUDGET_TOLERANCE` pins the acceptance check.  The arithmetic is
the JAX package's, so both packages' budgets over one log agree.

The modeled side: :func:`calibration_row` sets the static cost model's
predicted step time (``analysis.cost_model``, H100 constants) against a
measured one; :func:`save_calibration` and
:func:`save_op_class_calibration` merge per-program and per-op-class rows
(``opprof.op_class_rows``) into one JSON table, and
:func:`load_op_class_ratios` reads the per-op-type ratios the planner
takes (``analysis.planner.plan(op_class_ratios=)``).  The cost model is
imported only inside those calls.  :func:`executable_facts` reads a
step built ahead (``Executor.compile``): a captured CUDA graph exposes
its memory (pool bytes, a bound on the capture's peak) but no FLOP
facts, so a row's ``model`` is ``"static"``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

__all__ = [
    "BUDGET_TOLERANCE", "step_budget",
    "serving_budget", "decode_budget", "remote_budget",
    "executable_facts", "calibration_row", "save_calibration",
    "save_op_class_calibration", "load_op_class_ratios",
    "doctor_report", "render_doctor",
]

# Budget components must reconcile with the measured wall within this
# fraction — the pinned acceptance tolerance (tests + the doctor CLI).
BUDGET_TOLERANCE = 0.15


# ---------------------------------------------------------------------------
# interval arithmetic (seconds, absolute unix time)
# ---------------------------------------------------------------------------
def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(i for i in intervals if i[1] > i[0]):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _total(intervals: List[Tuple[float, float]]) -> float:
    return sum(b - a for a, b in intervals)


def _subtract(keep: List[Tuple[float, float]],
              cut: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Portions of ``keep`` not covered by ``cut`` (both pre-merged)."""
    out: List[Tuple[float, float]] = []
    for a, b in keep:
        cur = a
        for c, d in cut:
            if d <= cur or c >= b:
                continue
            if c > cur:
                out.append((cur, c))
            cur = max(cur, d)
            if cur >= b:
                break
        if cur < b:
            out.append((cur, b))
    return out


# ---------------------------------------------------------------------------
# step-time budget (training / pipelined path)
# ---------------------------------------------------------------------------
def step_budget(events) -> Optional[dict]:
    """Step-time budget over a log's ``step`` events + ``pipeline/stage``
    spans.  None when the log carries no dispatches.

    The measured window is [first dispatch start, last dispatch end]:
    what happens before the first dispatch (imports, model build,
    startup program) is startup, not step time."""
    steps = [e for e in events if e.get("kind") == "step"
             and isinstance(e.get("wall_ms"), (int, float))]
    if not steps:
        return None
    disp = _merge([(e["ts"] - e["wall_ms"] / 1e3, e["ts"]) for e in steps])
    t0, t1 = disp[0][0], max(b for _, b in disp)
    wall_ms = (t1 - t0) * 1e3

    cold_ms = sum(e["wall_ms"] for e in steps if e.get("cold_compile"))
    warm = [e for e in steps if not e.get("cold_compile")]
    warm_ms = sum(e["wall_ms"] for e in warm)
    fetch_ms = sum(float(e.get("fetch_block_ms") or 0.0) for e in warm)
    compute_ms = max(0.0, warm_ms - fetch_ms)

    stage_spans = [e for e in events if e.get("kind") == "span"
                   and e.get("name") == "pipeline/stage"]
    stage = _merge([(e["t0"], e["t0"] + e.get("dur_ms", 0.0) / 1e3)
                    for e in stage_spans])
    # clip staging to the measured window, then split by dispatch overlap
    stage = _subtract(stage, [(-1e18, t0), (t1, 1e18)])
    stage_total_ms = _total(stage) * 1e3
    stage_unoverlapped = _subtract(stage, disp)
    staging_ms = _total(stage_unoverlapped) * 1e3

    gap_ms = max(0.0, wall_ms - cold_ms - warm_ms)
    host_other_ms = max(0.0, gap_ms - staging_ms)
    budget = {
        "compute_ms": round(compute_ms, 3),
        "fetch_ms": round(fetch_ms, 3),
        "compile_ms": round(cold_ms, 3),
        "staging_ms": round(staging_ms, 3),
        "host_other_ms": round(host_other_ms, 3),
    }
    total = sum(budget.values())
    n_steps = sum(int(e.get("steps", 1)) for e in steps)
    warm_steps = sum(int(e.get("steps", 1)) for e in warm)
    out = {
        "measured_wall_ms": round(wall_ms, 3),
        "budget": budget,
        "budget_sum_ms": round(total, 3),
        "budget_gap_frac": round(abs(total - wall_ms) / wall_ms, 4)
        if wall_ms else 0.0,
        "within_tolerance": bool(
            wall_ms and abs(total - wall_ms) <= BUDGET_TOLERANCE * wall_ms),
        "shares": {k: round(v / wall_ms, 4) if wall_ms else 0.0
                   for k, v in budget.items()},
        "dispatches": len(steps), "steps": n_steps,
        "step_ms_warm_mean": round(warm_ms / warm_steps, 3)
        if warm_steps else None,
        "staging_overlapped_ms": round(
            max(0.0, stage_total_ms - staging_ms), 3),
    }
    out["top"], out["hints"] = _hints(out)
    return out


_HINTS = {
    "host_other_ms": "host-stall {pct}%: the card waits on the host "
                     "between dispatches — raise prefetch workers/depth "
                     "or move feed building into the reader pipeline "
                     "(Executor.run_pipelined)",
    "staging_ms": "staging {pct}%: the host-to-card copies are not hidden "
                  "behind compute — raise prefetch_depth / "
                  "steps_per_dispatch of run_pipelined",
    "fetch_ms": "fetch-block {pct}%: the host blocks materializing "
                "fetches — steps run asynchronously on the card, so this "
                "bucket also absorbs device compute finishing under the "
                "materialization; trim fetch_list, fetch less often, or "
                "pass return_numpy=False and materialize lazily",
    "compile_ms": "compile {pct}%: new capture keys (warm-up + CUDA graph "
                  "capture) — keep feed shapes fixed so steps replay",
    "compute_ms": "compute-bound {pct}%: the card is the bottleneck — "
                  "profile it op by op (observability.opprof)",
}


def _hints(report: dict, table: Optional[Dict[str, str]] = None):
    shares = report["shares"]
    table = table if table is not None else _HINTS
    top = max(shares, key=lambda k: shares[k])
    hints = []
    for k, share in sorted(shares.items(), key=lambda kv: -kv[1]):
        if share >= 0.15 or k == top:
            hints.append(table[k].format(pct=round(share * 100)))
    return top, hints


# ---------------------------------------------------------------------------
# request-time budget (serving path)
# ---------------------------------------------------------------------------
def serving_budget(events) -> Optional[dict]:
    """Per-request budget over ``serving/request`` + ``serving/batch``
    spans: queue+batch wait vs model dispatch.  None when the log has no
    completed request spans."""
    reqs = [e for e in events if e.get("kind") == "span"
            and e.get("name") == "serving/request"]
    if not reqs:
        return None
    batches = [e for e in events if e.get("kind") == "span"
               and e.get("name") == "serving/batch"]
    dispatch_by_req: Dict[object, float] = {}
    for b in batches:
        labels = b.get("labels") or {}
        dms = labels.get("dispatch_ms")
        if dms is None:
            continue
        for rid in labels.get("requests") or []:
            dispatch_by_req[rid] = float(dms)
    served = [e for e in reqs
              if (e.get("labels") or {}).get("status") == "ok"]
    # latency percentiles over SERVED requests only: under overload most
    # spans are sub-ms admission rejections, and folding those in would
    # report a tiny p50 for exactly the incident being diagnosed
    durs = sorted(float(e.get("dur_ms", 0.0))
                  for e in (served or reqs))
    n = len(durs)
    waits, disps = [], []
    for e in served:
        total = float(e.get("dur_ms", 0.0))
        rid = (e.get("labels") or {}).get("id")
        d = min(dispatch_by_req.get(rid, 0.0), total)
        disps.append(d)
        waits.append(total - d)
    mean = lambda xs: sum(xs) / len(xs) if xs else None   # noqa: E731
    out = {
        "requests": len(reqs), "served": len(served),
        "rejected": sum(1 for e in reqs
                        if (e.get("labels") or {}).get("status")
                        not in (None, "ok")),
        "request_ms_p50": round(durs[n // 2], 3),
        "request_ms_p99": round(durs[min(n - 1, int(n * 0.99))], 3),
        "budget": {
            "queue_wait_ms_mean": round(mean(waits), 3) if waits else None,
            "dispatch_ms_mean": round(mean(disps), 3) if disps else None,
        },
        "request_ms_mean": round(mean(
            [float(e.get("dur_ms", 0.0)) for e in served]), 3)
        if served else None,
        "batches": len(batches),
    }
    if served and out["budget"]["dispatch_ms_mean"] is not None:
        total = out["budget"]["queue_wait_ms_mean"] + \
            out["budget"]["dispatch_ms_mean"]
        mean_req = out["request_ms_mean"] or 0.0
        out["budget_sum_ms"] = round(total, 3)
        out["within_tolerance"] = bool(
            mean_req and abs(total - mean_req)
            <= BUDGET_TOLERANCE * mean_req)
        wait_share = (out["budget"]["queue_wait_ms_mean"] / mean_req
                      if mean_req else 0.0)
        out["top"] = ("queue_wait" if wait_share >= 0.5 else "dispatch")
        out["hints"] = [
            "queue wait {p}%: requests spend most of their latency "
            "waiting — raise max_batch / lower max_wait_ms, add "
            "capacity, or lower queue_capacity to shed earlier".format(
                p=round(wait_share * 100))
        ] if out["top"] == "queue_wait" else [
            "dispatch {p}%: the model itself dominates — profile it op "
            "by op (observability.opprof)".format(
                p=round(100 - wait_share * 100))
        ]
    return out


# ---------------------------------------------------------------------------
# token-step budget (incremental decode path)
# ---------------------------------------------------------------------------
def decode_budget(events) -> Optional[dict]:
    """Decode slot-pool budget over ``serving/decode_step`` spans: the
    batched token-step dispatch vs the scheduler gap around it, slot
    occupancy, and token throughput.  None when the log has no decode
    steps."""
    steps = [e for e in events if e.get("kind") == "span"
             and e.get("name") == "serving/decode_step"]
    if not steps:
        return None
    durs = sorted(float(e.get("dur_ms", 0.0)) for e in steps)
    n = len(durs)
    actives = [int((e.get("labels") or {}).get("active", 0))
               for e in steps]
    disps = [float((e.get("labels") or {}).get("dispatch_ms"))
             for e in steps
             if (e.get("labels") or {}).get("dispatch_ms") is not None]
    tokens = sum(actives)
    ts = [float(e["ts"]) for e in steps
          if isinstance(e.get("ts"), (int, float))]
    wall_s = (max(ts) - min(ts)) if len(ts) > 1 else 0.0
    mean = lambda xs: sum(xs) / len(xs) if xs else None   # noqa: E731
    out = {
        "steps": n, "tokens": tokens,
        "active_mean": round(mean(actives), 2),
        "step_ms_p50": round(durs[n // 2], 3),
        "step_ms_p99": round(durs[min(n - 1, int(n * 0.99))], 3),
        "dispatch_ms_mean": round(mean(disps), 3) if disps else None,
        "tokens_per_s": round(tokens / wall_s, 1) if wall_s > 0 else None,
    }
    if out["dispatch_ms_mean"] is not None and out["step_ms_p50"]:
        dispatch_share = min(1.0, out["dispatch_ms_mean"]
                             / max(mean(durs), 1e-9))
        out["top"] = ("dispatch" if dispatch_share >= 0.5 else "scheduler")
        out["hints"] = [
            "dispatch {p}%: the per-token-step model call dominates — "
            "more slots amortize it over more live sequences".format(
                p=round(dispatch_share * 100))
        ] if out["top"] == "dispatch" else [
            "scheduler {p}%: host-side admit/evict around the dispatch "
            "dominates — lower step_wait_ms or batch admissions".format(
                p=round(100 - dispatch_share * 100))
        ]
    return out


# ---------------------------------------------------------------------------
# remote sparse budget (pserver wire path)
# ---------------------------------------------------------------------------
_REMOTE_HINTS = {
    "client_wire_ms": "client-wire {pct}%: serialization + network + "
                      "pipelining dominate the remote sparse rounds — "
                      "batch more ids per round (dedup, bigger batches), "
                      "keep wire_mode='binary', and overlap rounds with "
                      "compute (SparseSession prefetch)",
    "server_queue_ms": "server-queue {pct}%: requests wait in a shard's "
                       "single-threaded serve loop before dispatch — the "
                       "shard is saturated: add pserver shards "
                       "(re-shard the id space) or split hot tables "
                       "across fleets",
    "server_kernel_ms": "server-kernel {pct}%: the shard's pull/push "
                        "kernels dominate — shrink the embedding dim, "
                        "use a cheaper optimizer slot layout, or spread "
                        "rows over more shards so each kernel touches "
                        "fewer",
}


def remote_budget(events) -> Optional[dict]:
    """Remote sparse pull/push budget over the client-side
    ``pserver/rpc`` spans: splits the measured client wall into
    **client-wire** (serialize + network + pipelined wait), **server-
    queue** (time a frame sat in a shard's serve loop before dispatch)
    and **server-kernel** (the shard's pull/push kernel), using the
    server timings each reply piggybacks (``srv_queue_ms`` /
    ``srv_kernel_ms`` labels — the slowest shard of the pipelined
    round, which is what the client actually waited on).  Components
    sum to the measured wall by construction (wire is the residual);
    None when the log carries no client rpc spans.

    Works from the TRAINER's log alone — the piggyback travels in the
    reply, so no shard log is needed for the split."""
    rpcs = [e for e in events if e.get("kind") == "span"
            and e.get("name") == "pserver/rpc"]
    client = [e for e in rpcs
              if (e.get("labels") or {}).get("side") != "server"]
    if not client:
        return None
    wall_ms = sum(float(e.get("dur_ms") or 0.0) for e in client)
    queue_ms = kernel_ms = 0.0
    attributed = 0
    by_op: Dict[str, int] = {}
    for e in client:
        labels = e.get("labels") or {}
        op = str(labels.get("op", "?"))
        by_op[op] = by_op.get(op, 0) + 1
        q, k = labels.get("srv_queue_ms"), labels.get("srv_kernel_ms")
        if q is None and k is None:
            continue
        attributed += 1
        queue_ms += float(q or 0.0)
        kernel_ms += float(k or 0.0)
    budget = {
        "client_wire_ms": round(max(0.0, wall_ms - queue_ms - kernel_ms),
                                3),
        "server_queue_ms": round(queue_ms, 3),
        "server_kernel_ms": round(kernel_ms, 3),
    }
    total = sum(budget.values())
    out = {
        "measured_wall_ms": round(wall_ms, 3),
        "budget": budget,
        "budget_sum_ms": round(total, 3),
        "budget_gap_frac": round(abs(total - wall_ms) / wall_ms, 4)
        if wall_ms else 0.0,
        "within_tolerance": bool(
            wall_ms and abs(total - wall_ms) <= BUDGET_TOLERANCE * wall_ms),
        "shares": {k: round(v / wall_ms, 4) if wall_ms else 0.0
                   for k, v in budget.items()},
        "rounds": len(client),
        "attributed_rounds": attributed,
        "by_op": by_op,
    }
    out["top"], out["hints"] = _hints(out, table=_REMOTE_HINTS)
    return out


# ---------------------------------------------------------------------------
# compiled-executable facts + static-model calibration
# ---------------------------------------------------------------------------
def executable_facts(step) -> Optional[dict]:
    """What a step built ahead of its first call exposes: accepts a
    ``CompiledProgram`` or a ``CachedStep``.  A captured CUDA graph has
    no FLOP or byte analysis, as XLA's executables do in the JAX package;
    it has its memory: ``pool_bytes`` (the graph's private pool) and
    ``capture_peak_bytes`` (a bound on the allocator's peak during the
    capture: what it held as the capture began, the static buffers and
    the pool), with the capture's kernel launches and the step listing's
    routes.  None where nothing was captured (the CPU)."""
    cached = getattr(step, "step", step)
    facts = getattr(cached, "facts", None)
    if not facts or getattr(cached, "captured", None) is None:
        return None
    routes: Dict[str, int] = {}
    for r in facts.get("listing") or []:
        routes[r["route"]] = routes.get(r["route"], 0) + 1
    return {"source": "cuda_graph",
            "pool_bytes": int(facts.get("pool_bytes") or 0),
            "capture_peak_bytes": facts.get("capture_peak_bytes"),
            "launches": facts.get("launches") or {},
            "routes": routes}


def calibration_row(program, measured_step_ms: float,
                    mesh_axes: Optional[Dict[str, int]] = None,
                    assume_batch: int = 64,
                    facts: Optional[dict] = None) -> dict:
    """One calibration-table row: the static cost model's predicted step
    time against a measured one, and their ratio, which the planner can
    fold into its constants.

    ``ratio > 1``: the model is optimistic for this program (real steps
    are slower than the proxy); ``< 1``: pessimistic.  Rows are keyed by
    the program's content digest, so re-doctoring the same program
    overwrites its row instead of accumulating duplicates."""
    from ..analysis.cost_model import estimate_cost
    from ..core import compile_cache
    report = estimate_cost(program, mesh_axes or {},
                           assume_batch=assume_batch)
    predicted_ms = report.step_time_proxy_s * 1e3
    digest = compile_cache.fingerprint_hex(
        compile_cache.program_content_digest(program))[:16]
    row = {
        "program": digest,
        "assume_batch": int(assume_batch),
        "mesh_axes": dict(mesh_axes or {}),
        "predicted_ms": round(predicted_ms, 6),
        "measured_ms": round(float(measured_step_ms), 6),
        "ratio": round(float(measured_step_ms) / predicted_ms, 4)
        if predicted_ms > 0 else None,
        "model": "static" if facts is None else "static+cost_analysis",
    }
    if facts:
        row["executable"] = facts
    return row


def _read_calibration_doc(path: str) -> dict:
    """Existing table -> {"programs": {...}, "op_classes": {...}}
    (tolerates the format-1 layout and a bare programs map)."""
    import json
    programs: Dict[str, dict] = {}
    op_classes: Dict[str, dict] = {}
    try:
        with open(path) as f:
            prev = json.load(f)
        if isinstance(prev, dict):
            p = prev.get("programs", prev)
            if isinstance(p, dict):
                programs.update(p)
            if isinstance(prev.get("op_classes"), dict):
                op_classes.update(prev["op_classes"])
    except (OSError, ValueError):
        pass   # first write, or an unreadable table: start fresh
    return {"programs": programs, "op_classes": op_classes}


def _write_calibration_doc(doc: dict, path: str) -> dict:
    import json
    import os
    out = {"format": 2, "programs": doc["programs"]}
    if doc.get("op_classes"):
        out["op_classes"] = doc["op_classes"]
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return out


def save_calibration(rows: List[dict], path: str) -> dict:
    """Merge per-program calibration rows into a JSON table keyed by
    program digest (atomic rewrite, op-class rows preserved); returns
    the merged table."""
    doc = _read_calibration_doc(path)
    for row in rows:
        doc["programs"][row["program"]] = row
    return _write_calibration_doc(doc, path)


def save_op_class_calibration(rows: List[dict], path: str) -> dict:
    """Merge per-op-CLASS rows (``opprof.op_class_rows`` output — the
    calibration_row schema extended with ``op_type``) into the same
    table under ``op_classes``, keyed ``<digest>:<op_type>`` so
    re-profiling a program overwrites its classes.  The per-program rows
    are preserved — one file carries both granularities for the
    planner."""
    doc = _read_calibration_doc(path)
    for row in rows:
        doc["op_classes"][f"{row['program']}:{row['op_type']}"] = row
    return _write_calibration_doc(doc, path)


def load_op_class_ratios(table) -> Dict[str, float]:
    """Per-op-TYPE correction ratios for the planner
    (``analysis.planner.plan(op_class_ratios=...)``): the MEDIAN
    measured/predicted ratio per op type across every program in the
    table's ``op_classes`` section.  ``table`` is a path or an
    already-loaded dict; {} when the table has no op-class rows (the
    planner then ranks on the constants alone)."""
    import json
    import statistics
    if isinstance(table, (str, bytes)) or hasattr(table, "__fspath__"):
        with open(table) as f:
            table = json.load(f)
    if not isinstance(table, dict):
        raise ValueError("calibration table must be a JSON object")
    by_type: Dict[str, List[float]] = {}
    for row in (table.get("op_classes") or {}).values():
        if not isinstance(row, dict) or "op_type" not in row:
            continue   # foreign/hand-edited rows must not crash the load
        r = row.get("ratio")
        if isinstance(r, (int, float)) and r > 0:
            by_type.setdefault(str(row["op_type"]), []).append(float(r))
    return {t: float(statistics.median(rs))
            for t, rs in sorted(by_type.items())}


# ---------------------------------------------------------------------------
# the doctor report
# ---------------------------------------------------------------------------
def doctor_report(paths, program=None, assume_batch: int = 64,
                  mesh_axes: Optional[Dict[str, int]] = None) -> dict:
    """Full doctor document for one (possibly multi-file) log: training
    step budget, serving request budget, span latency stats, and — when
    a program is supplied — the cost-model calibration row."""
    from . import tracing
    from .export import iter_log_events
    events, files = iter_log_events(paths)
    out: dict = {"files": files}
    tb = step_budget(events)
    if tb is not None:
        out["training"] = tb
    sb = serving_budget(events)
    if sb is not None:
        out["serving"] = sb
    db = decode_budget(events)
    if db is not None:
        out["decode"] = db
    rb = remote_budget(events)
    if rb is not None:
        out["remote"] = rb
    stats = tracing.span_stats(events)
    if stats:
        out["span_stats"] = stats
    if program is not None and tb is not None \
            and tb.get("step_ms_warm_mean"):
        out["calibration"] = calibration_row(
            program, tb["step_ms_warm_mean"], mesh_axes=mesh_axes,
            assume_batch=assume_batch)
    tops = [s.get("top") for s in (out.get("training"),
                                   out.get("serving"),
                                   out.get("remote")) if s]
    if tops:
        out["top_bottleneck"] = tops[0]
    return out


def render_doctor(report: dict) -> str:
    """Human-readable doctor rendering."""
    from .export import source_label
    lines: List[str] = []
    files = report.get("files") or []
    if len(files) > 1:
        # a merged fleet log: name which process each file came from
        for f in files:
            lines.append(f"source [{source_label(f)}]: {f['file']} "
                         f"({f['events']} event(s))")
    tb = report.get("training")
    if tb:
        lines.append(
            f"training: {tb['steps']} step(s) in {tb['dispatches']} "
            f"dispatch(es), measured wall {tb['measured_wall_ms']} ms "
            f"(budget sum {tb['budget_sum_ms']} ms, "
            f"gap {round(tb['budget_gap_frac'] * 100, 2)}%"
            + ("" if tb["within_tolerance"] else " — OVER TOLERANCE")
            + ")")
        for k, v in sorted(tb["budget"].items(),
                           key=lambda kv: -kv[1]):
            lines.append(f"  {k[:-3]:>12}: {v:12.3f} ms  "
                         f"({round(tb['shares'][k] * 100, 1)}%)")
        if tb.get("staging_overlapped_ms"):
            lines.append(f"  (+ {tb['staging_overlapped_ms']} ms staging "
                         f"overlapped with compute — already free)")
        for h in tb["hints"]:
            lines.append(f"  hint: {h}")
    sb = report.get("serving")
    if sb:
        lines.append(
            f"serving: {sb['served']}/{sb['requests']} request(s) "
            f"served, p50 {sb['request_ms_p50']} ms, "
            f"p99 {sb['request_ms_p99']} ms")
        b = sb["budget"]
        if b.get("dispatch_ms_mean") is not None:
            lines.append(f"  queue+batch wait mean: "
                         f"{b['queue_wait_ms_mean']} ms; model dispatch "
                         f"mean: {b['dispatch_ms_mean']} ms")
        for h in sb.get("hints", []):
            lines.append(f"  hint: {h}")
    db = report.get("decode")
    if db:
        lines.append(
            f"decode: {db['tokens']} token(s) in {db['steps']} "
            f"step(s), mean active {db['active_mean']}, step p50 "
            f"{db['step_ms_p50']} ms, p99 {db['step_ms_p99']} ms"
            + (f", {db['tokens_per_s']} tokens/s"
               if db.get("tokens_per_s") is not None else ""))
        if db.get("dispatch_ms_mean") is not None:
            lines.append(f"  step dispatch mean: "
                         f"{db['dispatch_ms_mean']} ms")
        for h in db.get("hints", []):
            lines.append(f"  hint: {h}")
    rb = report.get("remote")
    if rb:
        lines.append(
            f"remote sparse: {rb['rounds']} rpc round(s) "
            f"({rb['attributed_rounds']} with server timings), measured "
            f"wall {rb['measured_wall_ms']} ms (budget sum "
            f"{rb['budget_sum_ms']} ms, gap "
            f"{round(rb['budget_gap_frac'] * 100, 2)}%"
            + ("" if rb["within_tolerance"] else " — OVER TOLERANCE")
            + ")")
        for k, v in sorted(rb["budget"].items(), key=lambda kv: -kv[1]):
            lines.append(f"  {k[:-3]:>16}: {v:12.3f} ms  "
                         f"({round(rb['shares'][k] * 100, 1)}%)")
        for h in rb["hints"]:
            lines.append(f"  hint: {h}")
    cal = report.get("calibration")
    if cal:
        lines.append(
            f"calibration: program {cal['program']} predicted "
            f"{cal['predicted_ms']} ms vs measured {cal['measured_ms']} "
            f"ms -> ratio {cal['ratio']} (static-model correction "
            f"factor; stored per program digest)")
    if not any(report.get(k) for k in
               ("training", "serving", "decode", "remote", "calibration")):
        lines.append("doctor: no step events or request spans in this "
                     "log — run with observe on and a metrics_log set")
    elif report.get("top_bottleneck"):
        lines.insert(0, f"top bottleneck: {report['top_bottleneck']}")
    return "\n".join(lines)
