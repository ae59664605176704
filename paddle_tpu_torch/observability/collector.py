"""Fleet-wide metrics aggregation: merge per-process
``metrics_snapshot()`` dicts into ONE labeled fleet snapshot
(counterpart of ``paddle_tpu/observability/collector.py``: the same
merge, frontends, rendering and command line).

A distributed job runs as many processes — trainers, pserver shards,
serve replicas, a fleet router, a master — each with its own in-process
metrics registry.  This module is the read side: it gathers one
snapshot per process over whichever channel that process already
exposes, then merges them:

* **JSONL logs** (:func:`collect_logs`) — the last ``snapshot`` event of
  each per-process metrics log, labeled by the file's identity header
  (``pserver:1``, ``serve:0``, ...);
* **pserver endpoints** (:func:`collect_endpoints`) — one ``stats`` op
  per shard with the opt-in ``metrics`` field over the port's
  ``sparse.wire`` (the default stats reply stays byte-stable;
  sparse/pserver.py);
* **a master** (:func:`collect_master`) — the opt-in ``metrics``
  heartbeat piggyback of the port's ``MasterClient``
  (distributed/master.py);
* **a live fleet router** (:func:`collect_router`) —
  ``FleetRouter.metrics_snapshots()``, which piggybacks on the replica
  health poll (serving/fleet.py).

Merge semantics (:func:`merge_snapshots`): counters SUM across sources
(fleet totals), gauges keep one sample per source (the label is
prefixed ``<source>:`` — a gauge is a per-process level, summing it
lies), histograms merge bucket-wise when boundaries match (they do
within one release; a skewed source is skipped and named), compile
counters sum, device memory keys get the source prefix.

``python -m paddle_tpu_torch fleet-stats <dir-or-logs-or-endpoints>``
(:func:`fleet_stats_main`) is the CLI form; ``--prom`` renders the
merged snapshot in Prometheus text exposition.

Imported LAZILY by design, like ``attribution``: collecting can dial
sockets and pull the sparse wire stack — importing
``paddle_tpu_torch.observability`` must stay cheap and socket-free.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import socket
from typing import Dict, List, Optional, Sequence

from . import metrics as _metrics
from .export import iter_log_events, to_prometheus

logger = logging.getLogger("paddle_tpu_torch")

__all__ = [
    "merge_snapshots", "collect_logs", "collect_endpoints",
    "collect_master", "collect_router", "render_fleet",
    "fleet_stats_main",
]


def _source_name(identity: Optional[dict], fallback: str) -> str:
    """``pserver:1`` / ``serve`` from a piggybacked identity dict, else
    the fallback (file basename, endpoint address)."""
    if isinstance(identity, dict) and identity.get("role"):
        idx = identity.get("index")
        return (f"{identity['role']}:{idx}" if idx is not None
                else str(identity["role"]))
    return str(fallback)


def _unique(existing, name: str) -> str:
    """Two trainers both named ``main`` must not silently overwrite each
    other in the sources dict."""
    if name not in existing:
        return name
    i = 2
    while f"{name}#{i}" in existing:
        i += 1
    return f"{name}#{i}"


# ---------------------------------------------------------------------------
# The merge
# ---------------------------------------------------------------------------
def merge_snapshots(sources: Dict[str, dict]) -> dict:
    """Merge per-process snapshots into one fleet view.

    ``sources``: ``{source_name: {"metrics": <metrics_snapshot() dict>,
    "identity": {...}|None}}`` — the shape every ``collect_*`` frontend
    returns (``"metrics"`` may also be a bare registry snapshot).

    Returns ``{"sources", "metrics", "compile", "device_memory"
    [, "skipped"]}`` where ``metrics`` is registry-snapshot shaped, so
    :func:`.export.to_prometheus` renders it unchanged.
    """
    merged: Dict[str, dict] = {}
    compile_: Dict[str, float] = {}
    device_memory: Dict[str, dict] = {}
    identities: Dict[str, Optional[dict]] = {}
    skipped: List[str] = []
    for src in sorted(sources):
        entry = sources[src] or {}
        identities[src] = entry.get("identity")
        snap = entry.get("metrics")
        if not isinstance(snap, dict):
            skipped.append(f"{src} (no snapshot)")
            continue
        registry = snap.get("metrics", snap)
        if not isinstance(registry, dict):
            registry = {}
        for name, m in registry.items():
            if not isinstance(m, dict):
                continue
            kind = m.get("kind")
            have = merged.get(name)
            if kind == "counter":
                if have is None:
                    have = merged[name] = {"kind": "counter", "value": 0.0}
                have["value"] += float(m.get("value") or 0.0)
            elif kind == "gauge":
                if have is None:
                    have = merged[name] = {"kind": "gauge", "values": {}}
                for label, v in (m.get("values") or {}).items():
                    key = f"{src}:{label}" if label else src
                    have["values"][key] = v
            elif kind == "histogram":
                bounds = list(m.get("boundaries") or ())
                if have is None:
                    have = merged[name] = {
                        "kind": "histogram", "count": 0, "sum": 0.0,
                        "min": None, "max": None, "boundaries": bounds,
                        "counts": [0] * len(bounds)}
                if bounds != have["boundaries"]:
                    # bucket skew (a mixed-release fleet): adding counts
                    # across different edges fabricates a distribution —
                    # name the source instead of lying
                    skipped.append(f"{src}:{name} (bucket mismatch)")
                    continue
                have["count"] += int(m.get("count") or 0)
                have["sum"] = round(have["sum"]
                                    + float(m.get("sum") or 0.0), 6)
                have["counts"] = [a + b for a, b in
                                  zip(have["counts"],
                                      m.get("counts") or [0] * len(bounds))]
                for agg, pick in (("min", min), ("max", max)):
                    v = m.get(agg)
                    if v is not None:
                        have[agg] = v if have[agg] is None \
                            else pick(have[agg], v)
        for k, v in (snap.get("compile") or {}).items():
            if isinstance(v, (int, float)):
                compile_[k] = compile_.get(k, 0.0) + float(v)
        for dev, stats in (snap.get("device_memory") or {}).items():
            device_memory[f"{src}:{dev}"] = stats
    _metrics.inc_counter("collector/merges")
    _metrics.set_gauge("collector/sources", len(sources))
    out = {"sources": identities, "metrics": merged,
           "compile": compile_, "device_memory": device_memory}
    if skipped:
        out["skipped"] = skipped
    return out


# ---------------------------------------------------------------------------
# Collection frontends (one per channel a process already exposes)
# ---------------------------------------------------------------------------
def collect_logs(paths: Sequence) -> Dict[str, dict]:
    """Last ``snapshot`` event of each JSONL metrics log, labeled by the
    file's identity header.  Files without a snapshot are skipped with a
    warning (a log from an observe-off run has none)."""
    sources: Dict[str, dict] = {}
    for path in paths:
        try:
            events, files = iter_log_events(path)
        except OSError as e:
            logger.warning("fleet collector: cannot read %r: %s", path, e)
            continue
        snap = next((e for e in reversed(events)
                     if e.get("kind") == "snapshot"), None)
        if snap is None:
            logger.warning("fleet collector: %r has no snapshot events "
                           "(observe off, or no periodic_report)", path)
            continue
        f = files[0]
        identity = None
        if f.get("role"):
            identity = {"role": f["role"], "pid": f.get("pid")}
            if f.get("proc_index") is not None:
                identity["index"] = f["proc_index"]
        name = _unique(sources, _source_name(
            identity, os.path.basename(str(path))))
        sources[name] = {
            "metrics": {k: snap.get(k)
                        for k in ("metrics", "compile", "device_memory")},
            "identity": identity}
    return sources


def collect_endpoints(addrs: Sequence[str],
                      timeout_s: float = 5.0) -> Dict[str, dict]:
    """Poll live pserver shards: one short-lived connection per
    ``host:port``, a ``stats`` op with the opt-in ``metrics`` field.
    Unreachable shards are skipped with a warning — a fleet snapshot
    that names what answered beats an exception that names nothing."""
    from ..sparse import wire  # lazy: the socket wire stack

    sources: Dict[str, dict] = {}
    for a in addrs:
        host, _, port = str(a).rpartition(":")
        try:
            with socket.create_connection((host, int(port)),
                                          timeout=timeout_s) as s:
                s.settimeout(timeout_s)
                wire.write_frame(s, {"op": "hello"})
                hello, _ = wire.read_frame(s)
                wire.write_frame(s, {"op": "stats", "metrics": True})
                reply, _ = wire.read_frame(s)
        except (OSError, ValueError, wire.WireError) as e:
            logger.warning("fleet collector: pserver %s unreachable: %s",
                           a, e)
            continue
        if not reply.get("ok") or not isinstance(reply.get("metrics"),
                                                 dict):
            logger.warning("fleet collector: pserver %s did not piggyback "
                           "metrics (reply keys: %s)", a,
                           sorted(reply))
            continue
        identity = reply.get("identity")
        if not isinstance(identity, dict):
            identity = {"role": "pserver", "index": hello.get("shard")}
        name = _unique(sources, _source_name(identity, str(a)))
        sources[name] = {"metrics": reply["metrics"],
                         "identity": identity}
    return sources


def collect_master(target, slot: int = -1) -> Dict[str, dict]:
    """One ``metrics=True`` heartbeat against a master — ``target`` is a
    ``MasterClient`` or a ``host:port`` string.  The poll heartbeats as
    ``slot`` (default -1, a slot no worker uses, so the collector's
    lease refresh never masks a real worker's staleness)."""
    if isinstance(target, str):
        from ..distributed.master import MasterClient  # lazy: socket stub
        target = MasterClient(target)
    reply = target.heartbeat(slot, metrics=True)
    if not isinstance(reply.get("metrics"), dict):
        logger.warning("fleet collector: master did not piggyback "
                       "metrics (reply keys: %s)", sorted(reply))
        return {}
    identity = reply.get("identity")
    return {_source_name(identity, "master"):
            {"metrics": reply["metrics"], "identity": identity}}


def collect_router(router, timeout_s: float = 2.0) -> Dict[str, dict]:
    """Snapshot a live in-process ``FleetRouter``'s replicas (the
    health-poll piggyback; serving/fleet.py) into source form."""
    out: Dict[str, dict] = {}
    for rep_name, entry in router.metrics_snapshots(
            timeout_s=timeout_s).items():
        identity = entry.get("identity")
        name = _unique(out, _source_name(identity, rep_name))
        out[name] = {"metrics": entry.get("metrics"),
                     "identity": identity}
    return out


# ---------------------------------------------------------------------------
# Rendering + CLI
# ---------------------------------------------------------------------------
def render_fleet(merged: dict) -> str:
    """Human-readable rendering of :func:`merge_snapshots` output."""
    idents = merged.get("sources") or {}
    lines = [f"fleet snapshot: {len(idents)} source(s)"]
    for src in sorted(idents):
        ident = idents[src]
        pid = ident.get("pid") if isinstance(ident, dict) else None
        lines.append(f"  source {src}"
                     + (f" (pid {pid})" if pid is not None else ""))
    for name, m in sorted((merged.get("metrics") or {}).items()):
        kind = m.get("kind")
        if kind == "counter" and m.get("value"):
            lines.append(f"  {name}: {m['value']:g}")
        elif kind == "gauge" and m.get("values"):
            vals = " ".join(f"{k}={v:g}" for k, v in
                            sorted(m["values"].items()))
            lines.append(f"  {name}: {vals}")
        elif kind == "histogram" and m.get("count"):
            mean = m["sum"] / m["count"]
            lines.append(
                f"  {name}: count={m['count']} mean={mean:.3f} "
                f"p50={_metrics.histogram_quantile(m, 0.5):.3f} "
                f"p90={_metrics.histogram_quantile(m, 0.9):.3f} "
                f"max={m['max']}")
    comp = merged.get("compile") or {}
    if any(comp.values()):
        lines.append("  compile: " + " ".join(
            f"{k.partition('/')[2]}={v:g}" for k, v in sorted(comp.items())
            if v))
    for s in merged.get("skipped") or ():
        lines.append(f"  skipped: {s}")
    return "\n".join(lines)


def fleet_stats_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch fleet-stats",
        description="merge per-process metrics snapshots into one "
                    "labeled fleet snapshot (paddle_tpu_torch."
                    "observability.collector): sources are JSONL metrics logs (files "
                    "or a directory of them — each file's LAST snapshot "
                    "event, labeled by its identity header) and/or live "
                    "pserver shard endpoints (host:port — a stats op "
                    "with the opt-in metrics piggyback).  Counters sum "
                    "across sources; gauges stay per-source; histograms "
                    "merge bucket-wise.  --prom renders Prometheus text "
                    "exposition for scraping.")
    ap.add_argument("source", nargs="+",
                    help="JSONL log file, a directory of *.jsonl logs, "
                         "or a pserver host:port endpoint (mixable)")
    ap.add_argument("--master", default=None, metavar="HOST:PORT",
                    help="also poll a distributed master's heartbeat "
                         "metrics piggyback")
    ap.add_argument("--slot", type=int, default=-1,
                    help="slot the master poll heartbeats as (default "
                         "-1: no real worker's lease is touched)")
    ap.add_argument("--timeout-s", type=float, default=5.0,
                    help="per-endpoint dial/reply timeout (default 5)")
    ap.add_argument("--json", action="store_true",
                    help="print the merged snapshot as ONE JSON object "
                         "only")
    ap.add_argument("--prom", action="store_true",
                    help="print the merged snapshot in Prometheus text "
                         "exposition format and exit")
    args = ap.parse_args(argv)

    logs: List[str] = []
    endpoints: List[str] = []
    for src in args.source:
        if os.path.isdir(src):
            found = sorted(
                os.path.join(src, f) for f in os.listdir(src)
                if f.endswith(".jsonl"))
            if not found:
                raise SystemExit(f"fleet-stats: no *.jsonl logs in "
                                 f"directory {src!r}")
            logs.extend(found)
        elif os.path.exists(src):
            logs.append(src)
        else:
            host, sep, port = src.rpartition(":")
            if sep and host and port.isdigit():
                endpoints.append(src)
            else:
                raise SystemExit(
                    f"fleet-stats: {src!r} is neither an existing "
                    f"log/directory nor a host:port endpoint")

    sources: Dict[str, dict] = {}
    for name, entry in collect_logs(logs).items():
        sources[_unique(sources, name)] = entry
    for name, entry in collect_endpoints(
            endpoints, timeout_s=args.timeout_s).items():
        sources[_unique(sources, name)] = entry
    if args.master:
        try:
            polled = collect_master(args.master, slot=args.slot)
        except (OSError, ConnectionError) as e:
            logger.warning("fleet collector: master %s unreachable: %s",
                           args.master, e)
            polled = {}
        for name, entry in polled.items():
            sources[_unique(sources, name)] = entry
    if not sources:
        raise SystemExit(
            "fleet-stats: no snapshots collected — logs need snapshot "
            "events (observe on + periodic_report/log_period) and "
            "endpoints must be reachable pserver shards")
    merged = merge_snapshots(sources)
    if args.prom:
        print(to_prometheus({"metrics": merged["metrics"],
                             "compile": merged["compile"]}),
              end="", flush=True)
        return 0
    if not args.json:
        print(render_fleet(merged), flush=True)
    print(json.dumps(merged, default=repr), flush=True)
    return 0
