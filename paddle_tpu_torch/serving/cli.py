"""``python -m paddle_tpu_torch serve`` — the process form of the serving
runtime, speaking newline-delimited JSON over stdio (counterpart of
``paddle_tpu/serving/cli.py``, the same protocol field for field).

Why stdio and not a socket: the contract under test is the *runtime*
(batching, deadlines, shedding, breakers, drain), and a pipe protocol
makes every degradation path deterministic for the chaos suite while
staying trivially bridgeable (an HTTP front can own the socket and pipe
to this process; ``serving/fleet.py``'s router does exactly that).

Protocol (one JSON object per line):

  stdin  →  {"id": <any>, "model": "<name>"?, "feeds": {name: nested
            list}, "deadline_ms": <float|null>?, "ctx": "<trace ctx>"?}
         |  {"cmd": "health", "id": <any>?, "metrics": true?}
  stdout ←  {"id":..., "model":..., "outputs": [[...], ...], "ms": ...,
            "dispatch_ms": ...}
         |  {"id":..., "error": "<TypeName>", "message": "..."}
         |  {"id":..., "health": {"state":..., "models": {...}}
            [, "metrics": {...}, "identity": {...}]}
         |  {"event": "state", "state": "warming|ready|draining|stopped"}
         |  {"event": "stopped", "admitted": N, "models": {...}}

``model`` may be omitted with a single tenant.  ``deadline_ms`` omitted
means the server default; ``null`` disables the deadline.

Lifecycle: models load on ``--device`` (default the card) and warm
(``state: warming`` → ``ready``), requests stream until stdin EOF or
SIGTERM/SIGINT.  On SIGTERM: admission stops (late lines get
``ServerClosed`` errors), in-flight batches complete, ``state:
draining`` then ``stopped`` are emitted, and the process exits 0 — a
supervisor relaunching the identical command returns to ``ready`` and
serves again.  ``--http PORT`` serves the HTTP front
(``serving/http.py``) instead of the stdio loop.

``--autotune`` resolves the omitted batcher knobs (``--max-batch``,
``--max-wait-ms``) from the persisted ``serving/batcher`` winner
(``paddle_tpu_torch.tuning``; search with ``python -m paddle_tpu_torch
tune serving/batcher``).
"""
from __future__ import annotations

import argparse
import json
import os
import queue as _queue_mod
import signal
import sys
import threading
import time
from typing import Dict, Optional

from .. import faults as _faults
from ..observability import (metrics_snapshot, process_identity,
                             set_process_identity, tracing as _tracing)
from ..testing import lockwatch as _lw
from .model import Model
from .server import Server

__all__ = ["serve_main"]


class _Emitter:
    """Line-atomic JSON writer shared by the reader loop and the
    completion callbacks (which fire on dispatcher threads).  A broken
    pipe (the consuming parent — e.g. a fleet router — died) disables
    the writer instead of crashing the drain path: the following stdin
    EOF drains the server and exits 0."""

    def __init__(self, fh):
        self._fh = fh
        self._lock = _lw.make_lock("serving.cli.emitter")
        self._dead = False

    def emit(self, obj: dict):
        line = json.dumps(obj, default=repr)
        with self._lock:
            if self._dead:
                return
            try:
                self._fh.write(line + "\n")
                self._fh.flush()
            except BrokenPipeError:
                self._dead = True


def _response_cb(emitter: _Emitter):
    def cb(pending):
        if pending.error is not None:
            emitter.emit({"id": pending.id, "model": pending.model,
                          "error": type(pending.error).__name__,
                          "message": str(pending.error)})
        else:
            # ms: admit -> complete server-side; dispatch_ms: the model
            # call of the serving batch.  Their difference is the
            # queue/batch wait — the fleet autoscaler's signal.
            emitter.emit({"id": pending.id, "model": pending.model,
                          "outputs": [None if o is None else o.tolist()
                                      for o in pending.outputs],
                          "ms": round((time.monotonic()
                                       - pending.t_admit) * 1e3, 3),
                          "dispatch_ms": None if pending.dispatch_ms is None
                          else round(pending.dispatch_ms, 3)})
    return cb


def _parse_models(entries):
    """--model DIR or --model name=DIR -> [(name|None, dir), ...]."""
    out = []
    for e in entries:
        name, sep, path = e.partition("=")
        out.append((name, path) if sep else (None, e))
    return out


def _parse_tokens(entries):
    """--token TOKEN[=MODEL] ... -> {token: model|None}, None if none."""
    if not entries:
        return None
    tokens = {}
    for t in entries:
        tok, sep, model = t.partition("=")
        tokens[tok] = model if sep else None
    return tokens


def serve_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch serve",
        description="multi-tenant inference server over exported "
                    "artifacts (paddle_tpu_torch.serving): dynamic "
                    "batching with admission control, per-request "
                    "deadlines, load shedding, per-model circuit "
                    "breaking, and graceful SIGTERM drain.  Speaks one "
                    "JSON object per line on stdin/stdout (see "
                    "paddle_tpu_torch/serving/cli.py).")
    ap.add_argument("--model", action="append", required=True,
                    metavar="[NAME=]DIR",
                    help="export_compiled_model directory to serve "
                         "(repeat for multiple tenants; NAME defaults to "
                         "the directory basename)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the artifacts load and run (default the "
                         "card; an artifact runs only on the device it "
                         "was exported for)")
    ap.add_argument("--max-batch", type=int, default=None,
                    help="max requests coalesced per dispatch (default "
                         "32, or the persisted serving/batcher winner "
                         "under --autotune)")
    ap.add_argument("--max-wait-ms", type=float, default=None,
                    help="max batching wait after the first request "
                         "(default 5, or the persisted winner under "
                         "--autotune)")
    ap.add_argument("--autotune", action="store_true",
                    help="resolve omitted batcher knobs from the "
                         "persisted autotuner winners "
                         "(paddle_tpu_torch.tuning; search with `python "
                         "-m paddle_tpu_torch tune serving/batcher`)")
    ap.add_argument("--deadline-ms", type=float, default=100.0,
                    help="default per-request deadline; <= 0 disables "
                         "(default 100)")
    ap.add_argument("--queue", type=int, default=256,
                    help="admission queue capacity per model; 0 = "
                         "unbounded (default 256)")
    ap.add_argument("--no-shed", action="store_true",
                    help="disable oldest-deadline-first load shedding "
                         "(full queue then rejects newcomers)")
    ap.add_argument("--breaker-threshold", type=int, default=3,
                    help="consecutive failed batches that open a model's "
                         "circuit breaker (default 3)")
    ap.add_argument("--breaker-cooldown-s", type=float, default=30.0,
                    help="seconds an open breaker waits before a probe "
                         "(default 30)")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip warmup dispatches (first requests pay the "
                         "kernel builds and graph captures)")
    ap.add_argument("--warmup-all", action="store_true",
                    help="warm EVERY batch bucket before ready (not "
                         "just smallest+largest): steady-state "
                         "benchmarks/fleets never pay a mid-window "
                         "warm-up")
    ap.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="serve HTTP on PORT instead of the stdio "
                         "protocol (serving/http.py; 0 = ephemeral, "
                         "printed on the ready line)")
    ap.add_argument("--http-host", default="127.0.0.1")
    ap.add_argument("--token", action="append", metavar="TOKEN[=MODEL]",
                    help="HTTP auth token, optionally bound to one "
                         "model (repeatable; only with --http)")
    ap.add_argument("--replica-index", type=int, default=None,
                    help="this replica's index in a fleet (stamps the "
                         "JSONL identity line so multi-file merges "
                         "label events serve:<index>)")
    args = ap.parse_args(argv)

    set_process_identity("serve", args.replica_index)

    srv = Server(
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        deadline_ms=(None if args.deadline_ms is not None
                     and args.deadline_ms <= 0 else args.deadline_ms),
        queue_capacity=(None if args.queue == 0 else args.queue),
        shed=not args.no_shed, breaker_threshold=args.breaker_threshold,
        breaker_cooldown_s=args.breaker_cooldown_s,
        warmup=not args.no_warmup,
        autotune=True if args.autotune else None)
    if args.warmup_all:
        srv.warmup_buckets = list(srv.buckets)

    emitter = _Emitter(sys.stdout)

    # Handlers FIRST: a supervisor's SIGTERM during model load or the
    # warm-up window (kernel builds and graph captures) must still end in
    # the documented drain-and-exit-0, not a default-disposition kill.
    # Warm-up itself is not interruptible — the flag is checked after it.
    drain = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: drain.set())

    for name, path in _parse_models(args.model):
        emitter.emit({"event": "loading", "model": name
                      or os.path.basename(os.path.normpath(path)),
                      "path": path})
        srv.add_model(Model.from_artifact(path, name=name,
                                          device=args.device))

    emitter.emit({"event": "state", "state": "warming"})
    srv.start()

    if args.http is not None:
        # HTTP front instead of the stdio loop (lazy: only --http pays
        # for serving/http.py)
        from .http import HttpFront

        front = HttpFront(srv, host=args.http_host, port=args.http,
                          tokens=_parse_tokens(args.token)).start()
        host, port = front.address
        emitter.emit({"event": "state", "state": "ready",
                      "host": host, "port": port,
                      "models": sorted(srv.health()["models"])})
        while not drain.is_set():
            drain.wait(0.1)
        # admission closes first: late HTTP requests get typed 503 +
        # Connection: close while admitted work completes
        srv.begin_drain()
        emitter.emit({"event": "state", "state": "draining"})
        srv.shutdown(drain=True)
        front.stop()
        h = srv.health()
        emitter.emit({"event": "state", "state": "stopped"})
        emitter.emit({"event": "stopped", "models": h["models"]})
        return 0

    emitter.emit({"event": "state", "state": "ready",
                  "models": sorted(srv.health()["models"])})

    # A dedicated blocking reader thread feeds a line queue: selecting on
    # a BUFFERED stdin is a classic stall (readline slurps every pending
    # line into Python's buffer, then select sees an empty pipe while
    # lines sit unread).  The daemon thread dies with the process; on
    # drain, lines it already queued still get typed rejections.
    lines: _queue_mod.Queue = _queue_mod.Queue()
    _EOF = object()

    def _read_stdin():
        for raw in sys.stdin:
            lines.put(raw)
        lines.put(_EOF)

    threading.Thread(target=_read_stdin, name="pt-serving-stdin",
                     daemon=True).start()

    cb = _response_cb(emitter)
    served = 0
    eof = False
    while not drain.is_set() and not eof:
        try:
            item = lines.get(timeout=0.05)
        except _queue_mod.Empty:
            continue
        if item is _EOF:        # EOF: client closed; drain what we have
            eof = True
            break
        line = item.strip()
        if not line:
            continue
        served += _handle_line(srv, emitter, cb, line)

    # graceful drain: stop admission FIRST (late writers get typed
    # ServerClosed rejections while in-flight batches complete), then
    # wait out every admitted request
    srv.begin_drain()
    emitter.emit({"event": "state", "state": "draining"})
    if not eof:
        # answer lines already on the pipe with the typed rejection
        # instead of silently dropping them (admission is closed, so
        # submit fails fast)
        deadline = time.monotonic() + 0.2
        while time.monotonic() < deadline:
            try:
                item = lines.get(timeout=0.05)
            except _queue_mod.Empty:
                continue
            if item is _EOF:
                break
            line = item.strip()
            if line:
                _handle_line(srv, emitter, cb, line)
    srv.shutdown(drain=True)
    h = srv.health()
    emitter.emit({"event": "state", "state": "stopped"})
    emitter.emit({"event": "stopped", "admitted": served,
                  "models": h["models"]})
    return 0


def _handle_line(srv: Server, emitter: _Emitter, cb, line: str) -> int:
    """Parse + submit one request line; returns 1 if admitted."""
    try:
        msg = json.loads(line)
        if isinstance(msg, dict) and msg.get("cmd") == "health":
            # control-plane poll (the fleet router's routing signal):
            # answered inline on the reader loop — queue depth must stay
            # fresh even when every dispatcher is saturated
            reply = {"id": msg.get("id"), "health": srv.health()}
            if msg.get("metrics"):
                # opt-in fleet-collector piggyback: the default health
                # reply stays byte-stable
                reply["metrics"] = metrics_snapshot()
                reply["identity"] = process_identity()
            emitter.emit(reply)
            return 0
        if not isinstance(msg, dict) or "feeds" not in msg:
            raise ValueError("want {'id', 'feeds': {...}} or "
                             "{'cmd': 'health'}")
    except (json.JSONDecodeError, ValueError) as e:
        emitter.emit({"id": None, "error": "BadRequest", "message": str(e)})
        return 0
    req_id = msg.get("id")
    deadline_ms: Optional[float] = msg.get("deadline_ms", -1.0)
    feeds: Dict[str, object] = msg["feeds"]
    try:
        pending = srv.submit(feeds, model=msg.get("model"),
                             deadline_ms=deadline_ms, req_id=req_id,
                             trace_parent=(_tracing.extract(msg["ctx"])
                                           if "ctx" in msg else None))
    except (_faults.Overloaded, _faults.ServerClosed,
            _faults.ModelUnavailable, ConnectionError, ValueError) as e:
        emitter.emit({"id": req_id, "error": type(e).__name__,
                      "message": str(e)})
        return 0
    except Exception as e:      # malformed feeds etc.
        emitter.emit({"id": req_id, "error": "BadRequest",
                      "message": f"{type(e).__name__}: {e}"})
        return 0
    pending.add_done_callback(cb)
    return 1
