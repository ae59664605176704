"""Sparse parameter-server shard process (counterpart of
``paddle_tpu/sparse/pserver.py``).

One :class:`PServer` hosts one shard of the id space (``id % n_shards ==
shard``) as a server-side :class:`~.table.SparseTable`
(``num_shards=1``), so every pull and push runs the vectorized table
code on the server, bit-identical to the in-process path.  Requests
arrive as single batched binary frames (:mod:`.wire`, the JAX package's
frames); the accept loop is single-threaded over ``selectors`` (the
reference's epoll pserver shape: one event loop, no thread pool, no
locks on the hot path).  A shard server runs on the host only: it never
touches a card, and importing the package that holds it creates no CUDA
context.

Process contract (``python -m paddle_tpu_torch pserver --shard k/N``):

* prints one ready line of JSON (``{"pserver": {"port": ..., ...}}``)
  once listening; supervisors and tests parse it;
* SIGTERM -> finish the in-flight request -> durable shard checkpoint
  into ``--dir`` -> exit :data:`~paddle_tpu_torch.faults.EXIT_PREEMPTED`
  (75), so ``distributed.supervisor`` relaunches it like a preempted
  trainer;
* on start, recovery prefers the **chain backup** over the local
  checkpoint: the backup holds every acked push, the checkpoint only
  those up to its commit; rows that were only ever pull-initialized
  re-materialize bit-identically from the per-(seed, id) Philox init.

Chain-backup replication: with ``--backup host:port`` (shard k points
at shard k+1 mod N), every applied push is forwarded to the backup and
acked to the client only after the backup acks, so a SIGKILL loses no
acked push.  Dedup state (per-client push seq) replicates with the
rows, so a client retrying a push that was applied but not acked gets a
duplicate-ack instead of a second apply.

Fault-injection sites: ``pserver.rpc`` fires per request received
(hit-count indexed; ``drop`` closes the connection mid-exchange,
``transient`` answers a typed retryable error), and ``pserver.shard``
fires per applied push with the global applied-push counter as its
index (persisted in checkpoint and backup, so a ``kill`` fired in one
life never fires again after a relaunch).

Observability, as in the JAX server: the ``pserver/*`` metrics,
``pserver`` events (start, checkpoint, restore, shutdown) and a final
snapshot in the JSONL log, and, for a request whose header carries a
trace context (``ctx``, sent by an observing client), a server-side
``pserver/rpc`` span parented onto the caller and the shard's queue and
kernel times piggybacked on the reply (``srv``).  A request without
``ctx`` gets a reply byte-identical to an untraced wire.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import select as _select
import selectors
import signal
import socket
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..faults import EXIT_PREEMPTED, TransientError, classify
from ..observability import (emit_event, inc_counter, metrics_snapshot,
                             observe_hist, set_gauge,
                             set_process_identity)
from ..observability import tracing as _tracing
from ..testing import faultinject
from . import wire
from .table import SparseTable, _STATE_PREFIX

__all__ = ["PServer", "pserver_main", "cuda_initialized"]

# Initializer specs a table created over the wire may carry: the tuple
# forms are pure data; callable/dense initializers cannot cross a
# socket and stay an in-process-table feature.
_WIRE_INITS = ("uniform", "constant")


def cuda_initialized() -> bool:
    """Whether this process made a CUDA context (a shard server must
    not: it runs on the host, beside trainers that own the cards)."""
    torch = sys.modules.get("torch")
    return bool(torch is not None and torch.cuda.is_initialized())


def _spec_of(header_spec: Dict) -> Dict:
    """Validated, normalized table spec from a ``create`` header."""
    spec = {
        "name": str(header_spec["name"]),
        "vocab_size": int(header_spec["vocab_size"]),
        "dim": int(header_spec["dim"]),
        "dtype": str(header_spec.get("dtype", "float32")),
        "optimizer": str(header_spec.get("optimizer", "sgd")),
        "learning_rate": float(header_spec.get("learning_rate", 0.01)),
        "epsilon": float(header_spec.get("epsilon", 1e-6)),
        "seed": int(header_spec.get("seed", 0)),
        "init": list(header_spec.get("init") or ["uniform", -0.05, 0.05]),
    }
    if spec["init"][0] not in _WIRE_INITS:
        raise ValueError(
            f"pserver table {spec['name']!r}: initializer kind "
            f"{spec['init'][0]!r} cannot cross the wire (supported: "
            f"{_WIRE_INITS}; callable/dense initializers are in-process "
            f"features)")
    return spec


def _table_from_spec(spec: Dict) -> SparseTable:
    init = spec["init"]
    initializer = (init[0], *init[1:]) if init[0] == "uniform" \
        else ("constant", init[1])
    return SparseTable(
        spec["name"], spec["vocab_size"], spec["dim"],
        dtype=spec["dtype"], num_shards=1, optimizer=spec["optimizer"],
        learning_rate=spec["learning_rate"], epsilon=spec["epsilon"],
        seed=spec["seed"], initializer=initializer, impl="vectorized")


class PServer:
    """One sparse parameter-server shard (see module docstring).

    In-process form for tests/benchmarks::

        srv = PServer(shard=0, n_shards=1)
        port = srv.start()            # bind; returns the chosen port
        t = threading.Thread(target=srv.serve_forever, daemon=True,
                             name="pt-pserver-serve")
        ...
        srv.stop(); t.join()
    """

    def __init__(self, shard: int, n_shards: int, *,
                 host: str = "127.0.0.1", port: int = 0,
                 dir: Optional[str] = None,
                 backup_addr: Optional[Tuple[str, int]] = None,
                 io_timeout_s: float = 30.0):
        if not 0 <= shard < n_shards:
            raise ValueError(
                f"pserver: shard must be in [0, {n_shards}), got {shard}")
        self.shard = int(shard)
        self.n_shards = int(n_shards)
        self.host = host
        self.port = int(port)
        self.dir = dir
        self.backup_addr = backup_addr
        self.io_timeout_s = float(io_timeout_s)
        self._tables: Dict[str, SparseTable] = {}
        self._specs: Dict[str, Dict] = {}
        # chain-backup copies this server holds FOR its predecessor:
        # (origin_shard, table_name) -> SparseTable
        self._backups: Dict[Tuple[int, str], SparseTable] = {}
        self._backup_specs: Dict[Tuple[int, str], Dict] = {}
        self._backup_seq: Dict[int, Dict[str, int]] = {}
        self._backup_pushes: Dict[int, int] = {}
        # dedup state for THIS shard's primaries: "cid|table" -> last seq
        self._applied_seq: Dict[str, int] = {}
        self.pushes_applied = 0          # the pserver.shard site index
        self.requests = 0
        self._totals = {"pulls": 0, "pushes": 0, "pull_rows": 0,
                        "push_rows": 0, "wire_bytes_in": 0,
                        "wire_bytes_out": 0, "backup_pushes": 0}
        self._backup_sock = None
        # lazy shard-local CheckpointManager (delta-chain manifest form);
        # stays None until the first checkpoint()/recovery so dir-less
        # servers never touch the checkpoint machinery
        self._ckpt_manager = None
        self._listen: Optional[socket.socket] = None
        self._sel: Optional[selectors.DefaultSelector] = None
        self._stop = False
        self._sigterm = False
        # client pushes read while awaiting our own backup ack (see
        # _await_backup_ack): finished at the top of serve_forever so
        # forwards never nest
        self._deferred: "collections.deque" = collections.deque()
        self._final_snapshot = False
        self._last_kernel_ms = 0.0

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> int:
        """Bind + listen; returns the (possibly ephemeral) port."""
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self.host, self.port))
        s.listen(32)
        s.setblocking(False)
        self._listen = s
        self.port = s.getsockname()[1]
        self._sel = selectors.DefaultSelector()
        self._sel.register(s, selectors.EVENT_READ, "accept")
        self._recover()
        emit_event("pserver", event="start", shard=self.shard,
                   n_shards=self.n_shards, port=self.port,
                   pushes_applied=self.pushes_applied)
        return self.port

    def stop(self):
        self._stop = True

    def request_sigterm(self, *_args):
        """Signal-handler hook: checkpoint + exit 75 at the next
        request boundary (the in-flight request finishes first)."""
        self._sigterm = True

    def serve_forever(self):
        assert self._sel is not None, "call start() first"
        while not self._stop:
            if self._sigterm:
                self._graceful_exit()
            while self._deferred:
                conn, header, arrays = self._deferred.popleft()
                self._finish_request(conn, header, arrays)
            for key, _ in self._sel.select(timeout=0.2):
                if key.data == "accept":
                    self._accept()
                else:
                    self._serve_one(key.fileobj)
                if self._stop or self._sigterm:
                    break
        self._close_all()

    def _graceful_exit(self):
        self.checkpoint()
        emit_event("pserver", event="shutdown", shard=self.shard,
                   reason="sigterm", **self._totals)
        self._close_all()
        sys.exit(EXIT_PREEMPTED)

    def _close_all(self):
        # a final metrics snapshot, so a dead shard's log still holds
        # its counters (emit_event is a no-op without a log); both exit
        # paths come here, the flag keeps it to one
        if not self._final_snapshot:
            self._final_snapshot = True
            emit_event("snapshot", **metrics_snapshot())
        if self._sel is not None:
            for key in list(self._sel.get_map().values()):
                try:
                    self._sel.unregister(key.fileobj)
                    key.fileobj.close()
                except OSError:
                    pass
        if self._backup_sock is not None:
            try:
                self._backup_sock.close()
            except OSError:
                pass
            self._backup_sock = None
        self._listen = None

    def _accept(self):
        try:
            conn, _addr = self._listen.accept()
        except BlockingIOError:
            # stale readiness: a nested ack-wait (_await_backup_ack)
            # selects on this same selector and may have accepted this
            # connection before the outer batch got here
            return
        conn.setblocking(True)
        conn.settimeout(self.io_timeout_s)
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sel.register(conn, selectors.EVENT_READ, "conn")

    def _drop_conn(self, conn):
        try:
            self._sel.unregister(conn)
        except (KeyError, ValueError):
            pass
        try:
            conn.close()
        except OSError:
            pass

    # -- request dispatch ---------------------------------------------------
    def _serve_one(self, conn, *, defer_pushes=False):
        try:
            if not _select.select([conn], [], [], 0)[0]:
                return               # stale event, frame already consumed
            got = wire.read_frame(conn, eof_ok=True)
        except (wire.WireError, OSError, ValueError):
            self._drop_conn(conn)        # half-dead / already-closed peer
            return
        if got is None:
            self._drop_conn(conn)
            return
        header, arrays = got
        # receipt stamp: queue wait = dispatch start - this instant (it
        # survives a deferral, so a parked push reports its real wait)
        header["_t_recv"] = time.perf_counter()
        self.requests += 1
        self._totals["wire_bytes_in"] += header.get("_wire_nbytes", 0)
        inc_counter("pserver/requests")
        inc_counter("pserver/wire_bytes_in", header.get("_wire_nbytes", 0))
        if faultinject.ENABLED:
            action = faultinject.check("pserver.rpc")
            if action == "drop":
                self._drop_conn(conn)    # the client sees a torn frame
                return
            if action == "transient":
                self._reply_error(conn, header, RuntimeError(
                    "injected transient fault at pserver.rpc"),
                    retryable=True)
                return
            if action is not None:
                faultinject.raise_for(action, "pserver.rpc")
        if defer_pushes and header.get("op") == "push":
            # we are mid-push ourselves, awaiting our backup's ack: a
            # client push served here would nest a second forward on the
            # same backup socket and cross the ack correlation — park it
            # for the top of serve_forever instead
            self._deferred.append((conn, header, arrays))
            return
        self._finish_request(conn, header, arrays)

    def _finish_request(self, conn, header, arrays):
        t0 = time.perf_counter()
        # a ctx is the caller's observe bit: no ctx, no server span and
        # no srv piggyback; a malformed one is counted and ignored
        parent = _tracing.extract(header.get("ctx")) \
            if "ctx" in header else None
        sp = None
        queue_ms = 0.0
        if parent is not None:
            queue_ms = (t0 - header.get("_t_recv", t0)) * 1e3
            sp = _tracing.start_span(
                "pserver/rpc", parent=parent, side="server",
                op=header.get("op"), shard=self.shard)
        self._last_kernel_ms = 0.0
        try:
            reply, reply_arrays = self._dispatch(header, arrays)
        except Exception as e:           # a typed reply, never dead air
            if sp is not None:
                sp.end(queue_ms=round(queue_ms, 3),
                       kernel_ms=round(self._last_kernel_ms, 3),
                       error=type(e).__name__)
            self._reply_error(conn, header, e,
                              retryable=classify(e) == "retryable")
            return
        observe_hist("pserver/frame_ms", (time.perf_counter() - t0) * 1e3)
        reply["ok"] = True
        if sp is not None:
            srv = {"queue_ms": round(queue_ms, 3),
                   "kernel_ms": round(self._last_kernel_ms, 3)}
            reply["srv"] = srv
            sp.end(**srv)
        self._reply(conn, header, reply, reply_arrays)

    def _reply(self, conn, req_header, reply, arrays):
        try:
            if req_header.get("json_arrays") is not None:
                # answer a naive-encoded request in kind: the control
                # arm pays the JSON cost on both directions
                n = wire.write_frame_json(conn, reply, arrays)
            else:
                n = wire.write_frame(conn, reply, arrays)
            self._totals["wire_bytes_out"] += n
            inc_counter("pserver/wire_bytes_out", n)
        except (wire.WireError, OSError):
            self._drop_conn(conn)

    def _reply_error(self, conn, req_header, exc, *, retryable):
        self._reply(conn, req_header,
                    {"ok": False, "error": str(exc),
                     "etype": type(exc).__name__,
                     "retryable": bool(retryable)}, ())

    def _dispatch(self, header, arrays):
        if header.get("json_arrays") is not None:
            arrays = wire.decode_json_arrays(header)
        op = header.get("op")
        fn = getattr(self, f"_op_{op}", None)
        if fn is None:
            raise ValueError(f"pserver: unknown op {op!r}")
        return fn(header, arrays)

    def _table(self, header) -> SparseTable:
        name = header.get("table")
        t = self._tables.get(name)
        if t is None:
            raise ValueError(
                f"pserver shard {self.shard}: no table {name!r} — send "
                f"a create op first (tables: {sorted(self._tables)})")
        return t

    def _stats_of(self, t: SparseTable) -> Dict:
        last = t.last_init
        return {"live_rows": t.live_rows,
                "rows_initialized": t.rows_initialized,
                "last_init": list(last) if last else None}

    # -- ops ----------------------------------------------------------------
    def _op_hello(self, header, arrays):
        return {"shard": self.shard, "n_shards": self.n_shards,
                "wire_version": wire.WIRE_VERSION,
                "pushes_applied": self.pushes_applied}, ()

    def _op_create(self, header, arrays):
        spec = _spec_of(header["spec"])
        name = spec["name"]
        have = self._specs.get(name)
        if have is not None:
            if have != spec:
                raise ValueError(
                    f"pserver shard {self.shard}: table {name!r} exists "
                    f"with a different spec (have {have}, got {spec})")
            return {"created": False}, ()
        self._tables[name] = _table_from_spec(spec)
        self._specs[name] = spec
        return {"created": True}, ()

    def _op_pull(self, header, arrays):
        t = self._table(header)
        (ids,) = arrays
        t0 = time.perf_counter()
        rows = t.pull(np.asarray(ids, np.int64))
        dt = time.perf_counter() - t0
        self._last_kernel_ms = dt * 1e3
        self._totals["pulls"] += 1
        self._totals["pull_rows"] += len(rows)
        inc_counter("pserver/pull_rows", len(rows))
        if dt > 0:
            set_gauge("pserver/pull_rows_per_sec", len(rows) / dt)
        return {"stats": self._stats_of(t)}, (rows,)

    def _op_pull_slot(self, header, arrays):
        t = self._table(header)
        (ids,) = arrays
        rows = t.pull_slot(str(header["slot"]), np.asarray(ids, np.int64))
        return {"stats": self._stats_of(t)}, (rows,)

    def _op_push(self, header, arrays):
        t = self._table(header)
        ids, grads = arrays
        ids = np.asarray(ids, np.int64)
        cid, seq = header.get("cid"), header.get("seq")
        lr = header.get("lr")
        key = f"{cid}|{header['table']}"
        if cid is not None and seq is not None \
                and seq <= self._applied_seq.get(key, -1):
            # retry of an applied-but-unacked push: ack, do not re-apply
            return {"updated": 0, "dup": True,
                    "stats": self._stats_of(t)}, ()
        # chain order: backup FIRST (dedup'd there by the same seq),
        # local apply second.  Whatever instant a kill lands, primary ∪
        # backup holds each acked push exactly once: a kill before the
        # local apply leaves the push in the backup, and the relaunch
        # restores from the backup before serving the retry (which then
        # dup-acks off the restored seq map).  Forward-after-apply would
        # open a hole — a failed forward after a successful apply could
        # neither re-apply (double) nor dup-ack (unreplicated).
        self._forward_backup(header, ids, grads, lr)
        t0 = time.perf_counter()
        updated = t.push(ids, grads, learning_rate=lr)
        dt = time.perf_counter() - t0
        self._last_kernel_ms = dt * 1e3
        if cid is not None and seq is not None:
            self._applied_seq[key] = int(seq)
        self.pushes_applied += 1
        self._totals["pushes"] += 1
        self._totals["push_rows"] += updated
        inc_counter("pserver/push_rows", updated)
        if dt > 0:
            set_gauge("pserver/push_rows_per_sec", updated / dt)
        if faultinject.ENABLED:
            # AFTER apply+backup, BEFORE the ack: the counter is durable
            # in the chain, so a kill here never re-fires after relaunch
            action = faultinject.check("pserver.shard",
                                       index=self.pushes_applied)
            if action == "kill":
                os.kill(os.getpid(), signal.SIGKILL)
            elif action is not None:
                faultinject.raise_for(action, "pserver.shard",
                                      index=self.pushes_applied)
        return {"updated": updated, "stats": self._stats_of(t)}, ()

    def _forward_backup(self, header, ids, grads, lr):
        """Chain replication: forward the applied push (plus the dedup
        seq and the applied-push counter) to shard k+1 and wait for its
        ack — only then may the client be acked."""
        if self.backup_addr is None:
            return
        t0 = time.perf_counter()
        fwd = {"op": "backup_push", "table": header["table"],
               "origin": self.shard, "cid": header.get("cid"),
               "seq": header.get("seq"), "lr": lr,
               # the counter this push becomes once applied locally —
               # a restore after a kill must not re-fire a counter-
               # matched chaos site for a push the backup already holds
               "pushes_applied": self.pushes_applied + 1,
               "spec": self._specs[header["table"]]}
        last: Optional[BaseException] = None
        for attempt in (0, 1):           # one reconnect on a stale socket
            try:
                sock = self._backup_conn()
                wire.write_frame(sock, fwd, (ids, grads))
                reply = self._await_backup_ack(sock)
                if not reply.get("ok"):
                    raise RuntimeError(
                        f"backup push rejected: {reply.get('error')}")
                observe_hist("pserver/replication_lag_ms",
                             (time.perf_counter() - t0) * 1e3)
                return
            except (wire.WireError, OSError) as e:
                last = e
                self._close_backup_conn()
        # TransientError: the client must see a RETRYABLE refusal — it
        # backs off and replays (dedup'd) until the backup relaunches,
        # rather than failing the training run over a peer restart
        raise TransientError(
            f"pserver shard {self.shard}: backup {self.backup_addr} "
            f"unreachable — refusing to ack an unreplicated push "
            f"({last})")

    def _await_backup_ack(self, sock):
        """Wait for the backup's ack WITHOUT going deaf.

        With pipelined client rounds every shard in the fleet can be
        mid-push at once, each blocked on its successor's ack — on a
        chain that closes into a cycle (it always does: k+1 mod N) a
        shard that stops serving while it waits is a deadlock.  So keep
        draining our own selector here: the peer's ``backup_push``
        frames (and pulls, exports, ...) are served inline; only client
        *pushes* are deferred (see :meth:`_serve_one`) so forwards never
        nest on the one backup socket.
        """
        if self._sel is None:            # not serving (direct API use)
            reply, _ = wire.read_frame(sock)
            return reply
        self._sel.register(sock, selectors.EVENT_READ, "backup_ack")
        deadline = time.monotonic() + self.io_timeout_s
        try:
            while True:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise socket.timeout(
                        f"pserver shard {self.shard}: no backup ack "
                        f"within {self.io_timeout_s}s")
                for key, _ in self._sel.select(timeout=min(left, 0.2)):
                    if key.data == "backup_ack":
                        reply, _ = wire.read_frame(sock)
                        return reply
                    if key.data == "accept":
                        self._accept()
                    else:
                        self._serve_one(key.fileobj, defer_pushes=True)
        finally:
            try:
                self._sel.unregister(sock)
            except (KeyError, ValueError):
                pass

    def _backup_conn(self):
        if self._backup_sock is None:
            s = socket.create_connection(self.backup_addr,
                                         timeout=self.io_timeout_s)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._backup_sock = s
        return self._backup_sock

    def _close_backup_conn(self):
        if self._backup_sock is not None:
            try:
                self._backup_sock.close()
            except OSError:
                pass
            self._backup_sock = None

    def _op_backup_push(self, header, arrays):
        ids, grads = arrays
        origin = int(header["origin"])
        name = str(header["table"])
        key = (origin, name)
        cid, seq = header.get("cid"), header.get("seq")
        seqs = self._backup_seq.setdefault(origin, {})
        if cid is not None and seq is not None \
                and seq <= seqs.get(f"{cid}|{name}", -1):
            # the primary is replaying a forward that already landed
            # (it died between our ack and its local apply): ack again,
            # do not double-apply
            return {"dup": True}, ()
        bt = self._backups.get(key)
        if bt is None:
            spec = _spec_of(header["spec"])
            bt = _table_from_spec(spec)
            self._backups[key] = bt
            self._backup_specs[key] = spec
        bt.push(np.asarray(ids, np.int64), grads,
                learning_rate=header.get("lr"))
        if cid is not None and seq is not None:
            seqs[f"{cid}|{name}"] = int(seq)
        self._backup_pushes[origin] = max(
            self._backup_pushes.get(origin, 0),
            int(header.get("pushes_applied", 0)))
        self._totals["backup_pushes"] += 1
        inc_counter("pserver/backup_pushes")
        return {}, ()

    def _op_backup_fetch(self, header, arrays):
        """Hand the predecessor its replicated state back (relaunch
        recovery).  One table per call; ``backup_list`` enumerates."""
        origin = int(header["origin"])
        name = str(header["table"])
        bt = self._backups.get((origin, name))
        if bt is None:
            return {"found": False}, ()
        state = bt.export_state_vars()
        keys = sorted(k for k in state if not k.endswith("/meta"))
        return {"found": True, "keys": keys,
                "spec": self._backup_specs[(origin, name)],
                "applied_seq": self._backup_seq.get(origin, {}),
                "pushes_applied": self._backup_pushes.get(origin, 0),
                }, tuple(state[k] for k in keys)

    def _op_backup_list(self, header, arrays):
        origin = int(header["origin"])
        return {"tables": sorted(n for o, n in self._backups
                                 if o == origin)}, ()

    def _op_export(self, header, arrays):
        t = self._table(header)
        state = t.export_state_vars()
        keys = sorted(k for k in state if not k.endswith("/meta"))
        return {"keys": keys}, tuple(state[k] for k in keys)

    def _op_restore(self, header, arrays):
        """Replace this shard's rows for one table with the supplied
        (ids, rows, slot...) arrays — the client has already partitioned
        a spec-agnostic checkpoint down to this shard's id subset."""
        t = self._table(header)
        slots = list(header.get("slots", ()))
        ids = np.asarray(arrays[0], np.int64)
        rows = np.asarray(arrays[1], t.dtype).reshape(len(ids), t.dim)
        prefix = f"{_STATE_PREFIX}/{t.name}"
        state = {f"{prefix}/meta": np.frombuffer(
            json.dumps(t._meta(), sort_keys=True).encode("utf-8"),
            dtype=np.uint8).copy(),
            f"{prefix}/shard0/ids": ids,
            f"{prefix}/shard0/rows": rows}
        for j, s in enumerate(slots):
            state[f"{prefix}/shard0/slot/{s}"] = np.asarray(
                arrays[2 + j], t.dtype).reshape(len(ids), t.dim)
        t.restore_state_vars(state)
        return {"restored_rows": int(len(ids)),
                "stats": self._stats_of(t)}, ()

    def _op_stats(self, header, arrays):
        out = {"tables": {n: {**self._stats_of(t),
                              "host_bytes": t.host_bytes()}
                          for n, t in self._tables.items()},
               "requests": self.requests,
               "pushes_applied": self.pushes_applied,
               "totals": dict(self._totals),
               "cuda_initialized": cuda_initialized()}
        return out, ()

    def _op_checkpoint(self, header, arrays):
        path = self.checkpoint()
        return {"saved": path}, ()

    # -- durability ---------------------------------------------------------
    def _ckpt_dir(self) -> Optional[str]:
        if not self.dir:
            return None
        return os.path.join(self.dir, f"shard{self.shard}")

    # shard-local delta-chain policy (the Checkpointer's defaults): a
    # restore replays at most _DELTA_MAX_CHAIN links, and cumulative
    # delta bytes past half the base force a rebase
    _DELTA_MAX_CHAIN = 8
    _DELTA_REBASE_FRACTION = 0.5

    def _manager(self):
        root = self._ckpt_dir()
        if root is None:
            return None
        if self._ckpt_manager is None:
            os.makedirs(root, exist_ok=True)
            from ..distributed.checkpoint import CheckpointManager
            # device="cpu": a shard server never touches a card
            self._ckpt_manager = CheckpointManager(
                root, max_to_keep=3, async_save=False, device="cpu",
                process_index=0, process_count=1)
        return self._ckpt_manager

    def _ckpt_snapshot(self, kind: str):
        """One commit's scope + dirty-set tokens: every table's rows
        (full or dirty-only) plus the dedup/counter state as a synthetic
        var, so counters and rows commit ATOMICALLY."""
        from ..core.scope import Scope
        scope = Scope()
        tokens: Dict[str, int] = {}
        for name, t in sorted(self._tables.items()):
            tok, sv = (t.export_delta() if kind == "delta"
                       else t.export_full())
            tokens[name] = tok
            for k, v in sv.items():
                scope.set(k, v)
        meta = {"shard": self.shard, "n_shards": self.n_shards,
                "tables": sorted(self._tables),
                "specs": self._specs,
                "applied_seq": self._applied_seq,
                "pushes_applied": self.pushes_applied}
        scope.set("__pserver__/state", np.frombuffer(
            json.dumps(meta, sort_keys=True).encode("utf-8"),
            dtype=np.uint8).copy())
        return scope, tokens

    def checkpoint(self) -> Optional[str]:
        """Durable shard checkpoint on the delta-chain manifest
        (``distributed/checkpoint.py``): a full base when no chain is
        live (or the rebase thresholds trip), a dirty-rows-only delta
        otherwise — the SIGTERM grace window costs what the shard
        CHANGED, not what it holds.  Commits are blocking (this is the
        shard's durability barrier); dirty sets clear only on the
        durable ack and re-dirty on failure."""
        cm = self._manager()
        if cm is None:
            return None
        from ..distributed.checkpoint import DeltaChainError
        st = cm.chain_stats()
        kind = "delta" if (
            st["alive"] and st["len"] < self._DELTA_MAX_CHAIN
            and (st["base_bytes"] <= 0
                 or st["bytes"] < self._DELTA_REBASE_FRACTION
                 * st["base_bytes"])) else "full"
        step = (cm.latest_step() or 0) + 1
        scope, tokens = self._ckpt_snapshot(kind)

        def _ack(tk, commit):
            for name, tok in tk.items():
                t = self._tables.get(name)
                if t is not None:
                    (t.commit_delta if commit else t.retract_delta)(tok)

        try:
            cm.save(step, scope, blocking=True, kind=kind,
                    on_commit=lambda info, tk=tokens: _ack(tk, True),
                    on_fail=lambda exc, tk=tokens: _ack(tk, False))
        except DeltaChainError:
            # chain invalidated under us (e.g. a table created since the
            # parent commit changed the sparse layout): rebase full
            _ack(tokens, False)
            kind = "full"
            scope, tokens = self._ckpt_snapshot(kind)
            cm.save(step, scope, blocking=True, kind=kind,
                    on_commit=lambda info, tk=tokens: _ack(tk, True),
                    on_fail=lambda exc, tk=tokens: _ack(tk, False))
        root = self._ckpt_dir()
        inc_counter("pserver/checkpoints")
        emit_event("pserver", event="checkpoint", shard=self.shard,
                   dir=root, commit_kind=kind, **self._totals)
        return root

    def _recover(self):
        """Relaunch recovery: chain backup first (holds every acked
        push), local checkpoint otherwise.  First boot finds neither."""
        if self.backup_addr is not None and self._recover_from_backup():
            return
        self._recover_from_checkpoint()

    def _recover_from_backup(self) -> bool:
        try:
            sock = socket.create_connection(self.backup_addr,
                                            timeout=self.io_timeout_s)
        except OSError:
            return False                  # fleet cold start: peer not up
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            wire.write_frame(sock, {"op": "backup_list",
                                    "origin": self.shard})
            reply, _ = wire.read_frame(sock)
            names = reply.get("tables") or []
            if not names:
                return False
            for name in names:
                wire.write_frame(sock, {"op": "backup_fetch",
                                        "origin": self.shard,
                                        "table": name})
                r, arrs = wire.read_frame(sock)
                if not r.get("found"):
                    continue
                spec = _spec_of(r["spec"])
                t = _table_from_spec(spec)
                state = dict(zip(r["keys"], arrs))
                prefix = f"{_STATE_PREFIX}/{name}"
                state[f"{prefix}/meta"] = np.frombuffer(
                    json.dumps(t._meta(), sort_keys=True).encode(
                        "utf-8"), dtype=np.uint8).copy()
                t.restore_state_vars(state)
                self._tables[name] = t
                self._specs[name] = spec
                for k, v in (r.get("applied_seq") or {}).items():
                    self._applied_seq[k] = max(
                        self._applied_seq.get(k, -1), int(v))
                self.pushes_applied = max(
                    self.pushes_applied, int(r.get("pushes_applied", 0)))
            emit_event("pserver", event="restore", shard=self.shard,
                       source="backup", tables=sorted(self._tables),
                       pushes_applied=self.pushes_applied)
            return True
        except (wire.WireError, OSError):
            return False
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _recover_from_checkpoint(self) -> bool:
        root = self._ckpt_dir()
        if root is None or not os.path.isdir(root):
            return False
        cm = self._manager()
        if cm.all_steps():
            from ..core.scope import Scope
            scope = Scope()
            try:
                # replays the delta chain base->tip; a torn tip (kill
                # mid-chain) falls back inside restore() to the last
                # durable prefix
                cm.restore(scope=scope)
            except FileNotFoundError:
                return False
            if not scope.has("__pserver__/state"):
                return False
            meta = json.loads(bytes(scope.numpy("__pserver__/state")
                                    .astype(np.uint8)).decode("utf-8"))
            state = {k: scope.numpy(k) for k in scope.keys()
                     if k.startswith(_STATE_PREFIX)}
            for name in meta.get("tables", []):
                spec = dict(meta["specs"][name])
                spec["init"] = list(spec["init"])
                t = _table_from_spec(spec)
                t.restore_state_vars(state)
                self._tables[name] = t
                self._specs[name] = spec
            self._applied_seq = {k: int(v) for k, v in
                                 meta.get("applied_seq", {}).items()}
            self.pushes_applied = int(meta.get("pushes_applied", 0))
            emit_event("pserver", event="restore", shard=self.shard,
                       source="checkpoint", tables=sorted(self._tables),
                       pushes_applied=self.pushes_applied)
            return True
        return False


def _parse_shard(text: str) -> Tuple[int, int]:
    try:
        k, n = text.split("/")
        return int(k), int(n)
    except ValueError:
        raise SystemExit(
            f"pserver: --shard wants k/N (e.g. 0/2), got {text!r}")


def _parse_addr(text: str) -> Tuple[str, int]:
    host, _, port = text.rpartition(":")
    try:
        return host or "127.0.0.1", int(port)
    except ValueError:
        raise SystemExit(
            f"pserver: address wants host:port, got {text!r}")


def pserver_main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch pserver",
        description="One sparse parameter-server shard: hosts the "
                    "id%%N==k slice of every remote SparseTable behind "
                    "the batched binary wire protocol; SIGTERM "
                    "checkpoints and exits 75 (supervisor-relaunchable)"
    )
    ap.add_argument("--shard", required=True, metavar="k/N",
                    help="this shard's index and the fleet width")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="listen port (0 = ephemeral; the ready line "
                         "prints the choice)")
    ap.add_argument("--dir", default=None,
                    help="durable shard-checkpoint directory")
    ap.add_argument("--backup", default=None, metavar="HOST:PORT",
                    help="chain-backup successor (shard k+1 mod N): "
                         "every acked push is replicated there before "
                         "the ack")
    args = ap.parse_args(argv)
    shard, n_shards = _parse_shard(args.shard)
    # a shard's table ops are small (a batch's rows): one thread, so a
    # fleet of shards on a trainer's host does not oversubscribe its cores
    import torch
    torch.set_num_threads(1)
    set_process_identity("pserver", shard)
    srv = PServer(shard, n_shards, host=args.host, port=args.port,
                  dir=args.dir,
                  backup_addr=_parse_addr(args.backup)
                  if args.backup else None)
    signal.signal(signal.SIGTERM, srv.request_sigterm)
    signal.signal(signal.SIGINT, srv.request_sigterm)
    port = srv.start()
    print(json.dumps({"pserver": {
        "shard": shard, "n_shards": n_shards, "host": args.host,
        "port": port, "pid": os.getpid(), "dir": args.dir,
        "backup": args.backup,
        "cuda_initialized": cuda_initialized()}}), flush=True)
    srv.serve_forever()
    return 0
