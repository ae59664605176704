"""RemoteSparseTable: the client half of the sparse parameter-server
wire tier (counterpart of ``paddle_tpu/sparse/client.py``).

Duck-types the :class:`~.table.SparseTable` surface
(``pull``/``push``/``pull_slot``/``export_state_vars``/
``restore_state_vars``/``live_rows``/...), so a
:class:`~.session.SparseSession` binds one anywhere it takes an
in-process table.  The id space is client-sharded across the fleet as
the in-process table shards internally (``id % n_shards``, the
reference's Go-pserver client-side sharding), which makes a remote run
bit-identical to ``SparseTable(num_shards=N)`` on one host: per shard,
the same sorted-id export, the same per-(seed, id) Philox lazy init,
the same update arithmetic, executed in shard processes.  The frames
are the JAX package's, so this client also drives the JAX package's
shard servers (and then their update arithmetic).

Round shape: each ``pull``/``push`` costs one partition pass over the
batch and at most one batched frame per shard; frames to every shard
are written before any reply is read (pipelined), so N-shard latency is
the max of the shard times, not the sum.  Replies piggyback table
stats, so ``live_rows`` / ``rows_initialized`` / ``last_init`` stay
fresh without extra rounds.

Fault rim: every round runs under ``faults.RetryPolicy``: a torn frame
(:class:`~.wire.WireTruncatedError`), a refused/reset connection or a
typed retryable server reply closes the affected shard sockets and
replays the whole round against fresh connections.  Replay is safe end
to end: pulls are idempotent, and pushes carry a per-client
``(cid, seq)`` the shard dedups on (an applied-but-unacked push is
acked on retry, never applied twice).  Server errors marked
non-retryable re-raise at once as :class:`RemoteTableError`.

The ``wire_mode="naive"`` arm keeps the deliberately slow control
encoding (one JSON frame per row, values boxed in the header); it is
never the served hot path.

Observability: with ``observe`` (default: the ``observe`` flag) each
fleet round runs in a ``pserver/rpc`` client span whose trace context
rides the frame header (``ctx``); a shard that sees it parents its
server-side span onto the caller and piggybacks its queue and kernel
times on the reply, which label the client span
(``attribution.remote_budget`` splits the wall with them).  Without it
the frames carry no ``ctx``, byte-identical to an untraced wire.
"""
from __future__ import annotations

import itertools
import json
import os
import socket
import uuid
from contextlib import nullcontext
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import faults as _faults
from .. import observability as obs
from ..observability import tracing as _tracing
from ..testing import lockwatch as _lw
from . import wire
from .table import PAD_ID, _OPTIMIZER_SLOTS, _STATE_PREFIX, _STATE_VERSION

__all__ = ["RemoteSparseTable", "RemoteTableError"]

_CID_COUNTER = itertools.count()


class RemoteTableError(RuntimeError):
    """A pserver shard answered with a non-retryable typed error (bad
    op/spec mismatch/unknown table): retrying reproduces it, so the
    client re-raises instead of burning the retry budget."""


class _RemoteTransient(_faults.TransientError):
    """A shard answered with a typed retryable error (injected
    transient, backup unreachable): the round replays under the
    retry policy."""


def _addr_of(a) -> Tuple[str, int]:
    if isinstance(a, str):
        host, _, port = a.rpartition(":")
        return host or "127.0.0.1", int(port)
    host, port = a
    return str(host), int(port)


class RemoteSparseTable:
    """Client-side view of one sparse table sharded over a pserver
    fleet (see module docstring).

    ``addrs`` lists the shard processes in shard order (``addrs[k]``
    hosts ``id % len(addrs) == k``) as ``"host:port"`` strings or
    ``(host, port)`` tuples.  The constructor is lazy: nothing is
    dialed until the first round, so a table can be built before its
    fleet finishes binding.  ``create`` is idempotent server-side —
    any number of clients may declare the same spec.
    """

    def __init__(self, name: str, vocab_size: int, dim: int, *,
                 addrs: Sequence, dtype="float32",
                 optimizer: str = "sgd", learning_rate: float = 0.01,
                 epsilon: float = 1e-6, initializer=None,
                 init_scale: float = 0.05, seed: int = 0,
                 wire_mode: str = "binary",
                 retry: Optional[_faults.RetryPolicy] = None,
                 io_timeout_s: float = 30.0,
                 observe: Optional[bool] = None):
        if not addrs:
            raise ValueError(
                f"RemoteSparseTable {name!r}: addrs must name at least "
                f"one pserver shard")
        if wire_mode not in ("binary", "naive"):
            raise ValueError(
                f"RemoteSparseTable {name!r}: wire_mode must be "
                f"'binary' or 'naive', got {wire_mode!r}")
        if optimizer not in _OPTIMIZER_SLOTS:
            raise ValueError(
                f"RemoteSparseTable {name!r}: optimizer must be one of "
                f"{sorted(_OPTIMIZER_SLOTS)}, got {optimizer!r}")
        self.name = str(name)
        self.vocab_size = int(vocab_size)
        self.dim = int(dim)
        self.dtype = np.dtype(dtype)
        self.optimizer = optimizer
        self.learning_rate = float(learning_rate)
        self.epsilon = float(epsilon)
        self.seed = int(seed)
        self.slot_names = _OPTIMIZER_SLOTS[optimizer]
        self.addrs = [_addr_of(a) for a in addrs]
        self.n_shards = len(self.addrs)
        # the duck-typed surface the session reads: num_shards means
        # "how the id space splits", which here is the fleet width
        self.num_shards = self.n_shards
        self.wire_mode = wire_mode
        self.retry = retry if retry is not None else _faults.RetryPolicy()
        self.io_timeout_s = float(io_timeout_s)
        self._observe = obs.enabled() if observe is None else bool(observe)
        init = self._wire_init(initializer, init_scale)
        self._spec = {
            "name": self.name, "vocab_size": self.vocab_size,
            "dim": self.dim, "dtype": self.dtype.name,
            "optimizer": self.optimizer,
            "learning_rate": self.learning_rate,
            "epsilon": self.epsilon, "seed": self.seed, "init": init,
        }
        # cid must be globally unique across the whole trainer fleet:
        # shards dedup pushes on (cid, seq), and a pid-only cid collides
        # across hosts (containers reuse low pids), silently dup-acking
        # the second client's pushes.  hostname + pid + random covers
        # hosts, processes, and pid reuse within a host.
        self._cid = (f"{socket.gethostname()}.{os.getpid()}."
                     f"{uuid.uuid4().hex[:8]}.{next(_CID_COUNTER)}")
        self._seq = 0
        self._socks: List[Optional[socket.socket]] = [None] * self.n_shards
        self._dials = [0] * self.n_shards
        self._lock = _lw.make_rlock("sparse.client")
        # stats mirrors, refreshed from every reply's piggyback
        self._shard_stats: Dict[int, Dict] = {}
        self.rows_initialized = 0
        self.last_init = None

    # -- spec ---------------------------------------------------------------
    @staticmethod
    def _wire_init(initializer, init_scale) -> List:
        """Initializer spec in wire form.  Only the pure-data kinds can
        cross a socket; callable/dense stay in-process features."""
        if initializer is None:
            return ["uniform", -float(init_scale), float(init_scale)]
        if isinstance(initializer, (tuple, list)):
            kind = initializer[0]
            if kind == "uniform":
                return ["uniform", float(initializer[1]),
                        float(initializer[2])]
            if kind == "constant":
                return ["constant", float(initializer[1])]
        raise ValueError(
            f"RemoteSparseTable: initializer {initializer!r} cannot "
            f"cross the wire — only ('uniform', low, high) and "
            f"('constant', c) specs are pure data (callable/dense "
            f"initializers are in-process SparseTable features)")

    # -- connections --------------------------------------------------------
    def _conn(self, k: int) -> socket.socket:
        s = self._socks[k]
        if s is not None:
            return s
        s = socket.create_connection(self.addrs[k],
                                     timeout=self.io_timeout_s)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._dials[k] += 1
        if self._dials[k] > 1 and self._observe:
            obs.inc_counter("pserver/reconnects")
        try:
            wire.write_frame(s, {"op": "hello"})
            hello, _ = wire.read_frame(s)
            self._check_handshake(k, "hello", hello)
            if hello.get("n_shards") != self.n_shards \
                    or hello.get("shard") != k:
                raise RemoteTableError(
                    f"RemoteSparseTable {self.name!r}: shard {k} at "
                    f"{self.addrs[k]} identifies as "
                    f"{hello.get('shard')}/{hello.get('n_shards')} — "
                    f"fleet wiring mismatch")
            wire.write_frame(s, {"op": "create", "spec": self._spec})
            created, _ = wire.read_frame(s)
            self._check_handshake(k, "create", created)
        except BaseException:
            try:
                s.close()
            except OSError:
                pass
            raise
        self._socks[k] = s
        return s

    def _check_handshake(self, k: int, op: str, reply: Dict):
        """A handshake reply that is an error frame is read as the
        round reads one: ``retryable`` (an injected or real transient
        on the shard) raises ``_RemoteTransient`` for the retry rim,
        anything else ``RemoteTableError``.  Only an ``ok`` hello is an
        identity to hold against the fleet's wiring."""
        if reply.get("ok"):
            return
        msg = (f"RemoteSparseTable {self.name!r}: shard {k} at "
               f"{self.addrs[k]} {op} failed: [{reply.get('etype')}] "
               f"{reply.get('error')}")
        if reply.get("retryable"):
            raise _RemoteTransient(msg)
        if op == "create":
            raise RemoteTableError(
                f"RemoteSparseTable {self.name!r}: shard {k} rejected "
                f"the table spec: {reply.get('error')}")
        raise RemoteTableError(msg)

    def _drop_conn(self, k: int):
        s = self._socks[k]
        if s is not None:
            try:
                s.close()
            except OSError:
                pass
            self._socks[k] = None

    def close(self):
        with self._lock:
            for k in range(self.n_shards):
                self._drop_conn(k)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- spans --------------------------------------------------------------
    def _span(self, op: str, **labels):
        """Client span around one fleet round, gated here: an observe-off
        client builds no span (and its rounds carry no ctx)."""
        if not self._observe:
            return nullcontext()
        return _tracing.span("pserver/rpc", op=op, table=self.name,
                             **labels)

    # -- the round ----------------------------------------------------------
    def _round(self, per_shard: Dict[int, Tuple[Dict, tuple]], *,
               what: str) -> Dict[int, Tuple[Dict, List[np.ndarray]]]:
        """ONE pipelined exchange: write every shard's batched frame,
        then read every reply (N-shard latency = max, not sum), inside
        the retry rim.  Returns {shard: (reply_header, arrays)}."""
        shards = sorted(per_shard)
        # the trace context rides the header only when observing; its
        # presence is what asks the shard for a span and timings
        ctx = _tracing.inject() if self._observe else None

        def attempt():
            try:
                for k in shards:
                    header, arrays = per_shard[k]
                    if ctx is not None:
                        header = dict(header, ctx=ctx)
                    if self.wire_mode == "naive":
                        wire.write_frame_json(self._conn(k), header,
                                              arrays)
                    else:
                        wire.write_frame(self._conn(k), header, arrays)
                out = {}
                for k in shards:
                    reply, arrays = wire.read_frame(self._socks[k])
                    if self.wire_mode == "naive":
                        arrays = wire.decode_json_arrays(reply)
                    if not reply.get("ok"):
                        msg = (f"pserver shard {k} "
                               f"({self.addrs[k][0]}:{self.addrs[k][1]})"
                               f" {what} failed: [{reply.get('etype')}] "
                               f"{reply.get('error')}")
                        if reply.get("retryable"):
                            raise _RemoteTransient(msg)
                        raise RemoteTableError(msg)
                    out[k] = (reply, arrays)
                return out
            except Exception:
                # torn stream, half-dead peer, OR a typed error reply
                # read mid-round: either way unread replies may still
                # sit queued on this round's sockets, and reusing them
                # would offset every later round by one reply — drop
                # them all; the replay dials fresh ones (create is
                # idempotent, pushes dedup by (cid, seq))
                for k in shards:
                    self._drop_conn(k)
                raise

        def on_retry(i, e, d):
            if self._observe:
                obs.inc_counter("fault/retries")
                obs.emit_event("fault", event="retry", site="pserver.rpc",
                               attempt=i + 1, delay_s=round(d, 4),
                               error=f"{type(e).__name__}: {e}")

        with self._lock:
            replies = _faults.retry_call(
                attempt, self.retry, what=f"pserver {what} {self.name}",
                on_retry=on_retry)
        self._absorb_stats(replies)
        if ctx is not None:
            self._absorb_srv(replies)
        return replies

    def _absorb_srv(self, replies: Dict[int, Tuple[Dict, list]]):
        """Reply-piggybacked server-side timings -> labels on the
        enclosing ``pserver/rpc`` client span.  The round is pipelined
        (waits on the slowest shard), so the shard with the largest
        queue+kernel total is the one that bounded the wall — its
        timings label the span; ``doctor`` subtracts them from span
        wall to get the client-wire residual."""
        best = None
        for reply, _ in replies.values():
            srv = reply.get("srv")
            if isinstance(srv, dict):
                tot = (float(srv.get("queue_ms", 0.0))
                       + float(srv.get("kernel_ms", 0.0)))
                if best is None or tot > best[0]:
                    best = (tot, srv)
        if best is None:
            return
        sp = _tracing.current_span()
        if sp is not None and sp.name == "pserver/rpc":
            sp.labels["srv_queue_ms"] = round(
                float(best[1].get("queue_ms", 0.0)), 3)
            sp.labels["srv_kernel_ms"] = round(
                float(best[1].get("kernel_ms", 0.0)), 3)

    def _absorb_stats(self, replies: Dict[int, Tuple[Dict, list]]):
        for k, (reply, _) in replies.items():
            st = reply.get("stats")
            if st:
                self._shard_stats[k] = st
                if st.get("last_init"):
                    self.last_init = tuple(st["last_init"])
        self.rows_initialized = sum(
            s.get("rows_initialized", 0)
            for s in self._shard_stats.values())

    # -- SparseTable surface ------------------------------------------------
    @property
    def live_rows(self) -> int:
        return sum(s.get("live_rows", 0)
                   for s in self._shard_stats.values())

    def host_bytes(self) -> int:
        """Fleet-resident bytes (client view, from piggybacked stats)."""
        per_row = self.dim * self.dtype.itemsize * \
            (1 + len(self.slot_names))
        return self.live_rows * per_row

    def dense_bytes(self) -> int:
        return self.vocab_size * self.dim * self.dtype.itemsize

    def _partition(self, live: np.ndarray):
        """The ONE partition pass per batch: shard index per id, then a
        (sel, ids) slice per shard that holds any."""
        shard_of = live % self.n_shards
        for k in range(self.n_shards):
            sel = np.nonzero(shard_of == k)[0]
            if sel.size:
                yield k, sel, live[sel]

    def pull(self, ids) -> np.ndarray:
        """Rows for ``ids`` — one batched frame per shard holding any
        of them; ``PAD_ID`` slots come back zero (same contract as the
        in-process table)."""
        ids = np.asarray(ids, np.int64).ravel()
        out = np.zeros((len(ids), self.dim), self.dtype)
        live_sel = np.nonzero(ids != PAD_ID)[0]
        if not live_sel.size:
            return out
        live = ids[live_sel]
        if self.wire_mode == "naive":
            self._naive_pull(out, live_sel, live)
            return out
        parts = list(self._partition(live))
        per_shard = {k: ({"op": "pull", "table": self.name}, (sids,))
                     for k, _sel, sids in parts}
        sels = {k: sel for k, sel, _ in parts}
        with self._span("pull", shards=len(per_shard)):
            replies = self._round(per_shard, what="pull")
        for k, (_reply, arrays) in replies.items():
            out[live_sel[sels[k]]] = arrays[0].astype(self.dtype,
                                                      copy=False)
        return out

    def _naive_pull(self, out, live_sel, live):
        """The control arm: one JSON frame per ROW (the per-row RPC
        cost shape the batched path is benchmarked against)."""
        with self._span("pull", shards=self.n_shards, mode="naive"):
            for j, i in zip(live_sel.tolist(), live.tolist()):
                k = i % self.n_shards
                replies = self._round(
                    {k: ({"op": "pull", "table": self.name},
                         (np.asarray([i], np.int64),))},
                    what="pull")
                out[j] = replies[k][1][0][0].astype(self.dtype,
                                                    copy=False)

    def pull_slot(self, slot: str, ids) -> np.ndarray:
        ids = np.asarray(ids, np.int64).ravel()
        out = np.zeros((len(ids), self.dim), self.dtype)
        live_sel = np.nonzero(ids != PAD_ID)[0]
        if not live_sel.size:
            return out
        live = ids[live_sel]
        parts = list(self._partition(live))
        per_shard = {
            k: ({"op": "pull_slot", "table": self.name, "slot": slot},
                (sids,))
            for k, _sel, sids in parts}
        sels = {k: sel for k, sel, _ in parts}
        with self._span("pull_slot", shards=len(per_shard)):
            replies = self._round(per_shard, what="pull_slot")
        for k, (_reply, arrays) in replies.items():
            out[live_sel[sels[k]]] = arrays[0].astype(self.dtype,
                                                      copy=False)
        return out

    def push(self, ids, grad_rows, *,
             learning_rate: Optional[float] = None) -> int:
        """Apply one batch of gradient rows — one frame per shard, all
        stamped with the same ``(cid, seq)`` so a replayed round
        dedups per shard (exactly-once end to end)."""
        ids = np.asarray(ids, np.int64).ravel()
        grad_rows = np.asarray(grad_rows).reshape(len(ids), self.dim)
        live_sel = np.nonzero(ids != PAD_ID)[0]
        if not live_sel.size:
            return 0
        live = ids[live_sel]
        grads = np.ascontiguousarray(
            grad_rows[live_sel].astype(self.dtype, copy=False))
        if self.wire_mode == "naive":
            return self._naive_push(live, grads, learning_rate)
        # seq allocation and the round share ONE lock hold (the RLock
        # makes _round's own acquisition nest): if a concurrent pusher
        # could complete seq N+1's round before seq N's started, the
        # shard would see N <= applied N+1 and dedup-drop a never-
        # applied push.
        with self._lock:
            seq = self._seq
            self._seq += 1
            per_shard = {
                k: ({"op": "push", "table": self.name, "cid": self._cid,
                     "seq": seq, "lr": learning_rate},
                    (sids, grads[sel]))
                for k, sel, sids in self._partition(live)}
            with self._span("push", shards=len(per_shard)):
                replies = self._round(per_shard, what="push")
        return sum(reply.get("updated", 0)
                   for reply, _ in replies.values())

    def _naive_push(self, live, grads, learning_rate) -> int:
        updated = 0
        with self._span("push", shards=self.n_shards, mode="naive"):
            for j, i in enumerate(live.tolist()):
                k = i % self.n_shards
                # same single lock hold over seq + round as push()
                with self._lock:
                    seq = self._seq
                    self._seq += 1
                    replies = self._round(
                        {k: ({"op": "push", "table": self.name,
                              "cid": self._cid, "seq": seq,
                              "lr": learning_rate},
                             (np.asarray([i], np.int64),
                              grads[j:j + 1]))},
                        what="push")
                updated += replies[k][0].get("updated", 0)
        return updated

    # -- checkpoint surface -------------------------------------------------
    def _meta(self) -> dict:
        """Byte-for-byte the in-process table's meta for the same spec
        and ``num_shards=n_shards`` — what pins remote-vs-local export
        identity."""
        return {"version": _STATE_VERSION, "name": self.name,
                "vocab_size": self.vocab_size, "dim": self.dim,
                "dtype": self.dtype.name, "optimizer": self.optimizer,
                "learning_rate": self.learning_rate,
                "epsilon": self.epsilon, "seed": self.seed,
                "num_shards_at_save": self.n_shards,
                "slots": list(self.slot_names)}

    def export_state_vars(self) -> Dict[str, np.ndarray]:
        """Spec-agnostic export: shard k's server-side ``shard0`` keys
        remap to this fleet's ``shard{k}`` — byte-identical to the
        export of ``SparseTable(num_shards=n_shards)`` holding the
        same rows."""
        prefix = f"{_STATE_PREFIX}/{self.name}"
        out: Dict[str, np.ndarray] = {
            f"{prefix}/meta": np.frombuffer(
                json.dumps(self._meta(), sort_keys=True).encode("utf-8"),
                dtype=np.uint8).copy()}
        per_shard = {k: ({"op": "export", "table": self.name}, ())
                     for k in range(self.n_shards)}
        with self._span("export", shards=self.n_shards):
            replies = self._round(per_shard, what="export")
        for k in range(self.n_shards):
            reply, arrays = replies[k]
            for key, a in zip(reply["keys"], arrays):
                out[key.replace("/shard0/", f"/shard{k}/")] = \
                    np.array(a)       # own the buffer past the socket
        return out

    def restore_state_vars(self, state: Dict[str, np.ndarray]):
        """Restore from ANY export of this table (any shard/process
        count): concatenate the saved shards, re-partition by
        ``id % n_shards``, and hand each server its slice."""
        prefix = f"{_STATE_PREFIX}/{self.name}"
        meta_key = f"{prefix}/meta"
        if meta_key not in state:
            raise ValueError(
                f"RemoteSparseTable {self.name!r}: checkpoint carries "
                f"no state for this table (keys: "
                f"{sorted(k for k in state if k.startswith(_STATE_PREFIX))}"
                f")")
        meta = json.loads(bytes(np.asarray(state[meta_key],
                                            np.uint8)).decode("utf-8"))
        if int(meta.get("version", 0)) > _STATE_VERSION:
            raise ValueError(
                f"RemoteSparseTable {self.name!r}: checkpoint state "
                f"version {meta['version']} is newer than this runtime "
                f"({_STATE_VERSION})")
        for field in ("dim", "optimizer"):
            if meta.get(field) != getattr(self, field):
                raise ValueError(
                    f"RemoteSparseTable {self.name!r}: checkpoint "
                    f"{field} {meta.get(field)!r} != declared "
                    f"{getattr(self, field)!r}")
        saved_shards = int(meta.get("num_shards_at_save", 1))
        ids_parts, rows_parts = [], []
        slot_parts = {s: [] for s in self.slot_names}
        for k in range(saved_shards):
            ids_key = f"{prefix}/shard{k}/ids"
            if ids_key not in state:
                raise ValueError(
                    f"RemoteSparseTable {self.name!r}: checkpoint "
                    f"missing {ids_key} (meta says {saved_shards} "
                    f"shards)")
            sids = np.asarray(state[ids_key], np.int64)
            ids_parts.append(sids)
            rows_parts.append(np.asarray(
                state[f"{prefix}/shard{k}/rows"],
                self.dtype).reshape(len(sids), self.dim))
            for s in self.slot_names:
                slot_parts[s].append(np.asarray(
                    state[f"{prefix}/shard{k}/slot/{s}"],
                    self.dtype).reshape(len(sids), self.dim))
        ids = np.concatenate(ids_parts) if ids_parts else \
            np.empty(0, np.int64)
        rows = np.concatenate(rows_parts) if rows_parts else \
            np.empty((0, self.dim), self.dtype)
        slots = {s: (np.concatenate(p) if p else
                     np.empty((0, self.dim), self.dtype))
                 for s, p in slot_parts.items()}
        shard_of = ids % self.n_shards
        per_shard = {}
        for k in range(self.n_shards):   # EVERY shard: empty slice clears
            sel = np.nonzero(shard_of == k)[0]
            arrays = (ids[sel], rows[sel]) + tuple(
                slots[s][sel] for s in self.slot_names)
            per_shard[k] = ({"op": "restore", "table": self.name,
                             "slots": list(self.slot_names)}, arrays)
        with self._span("restore", shards=self.n_shards):
            self._round(per_shard, what="restore")

    # -- fleet ops ----------------------------------------------------------
    def checkpoint(self) -> List[Optional[str]]:
        """Ask every shard to commit a durable checkpoint now."""
        per_shard = {k: ({"op": "checkpoint"}, ())
                     for k in range(self.n_shards)}
        with self._span("checkpoint", shards=self.n_shards):
            replies = self._round(per_shard, what="checkpoint")
        return [replies[k][0].get("saved") for k in range(self.n_shards)]

    def fleet_stats(self) -> Dict[int, Dict]:
        """Per-shard server stats (tables, request/push counters)."""
        per_shard = {k: ({"op": "stats"}, ())
                     for k in range(self.n_shards)}
        replies = self._round(per_shard, what="stats")
        return {k: replies[k][0] for k in range(self.n_shards)}

    def __repr__(self):
        return (f"RemoteSparseTable({self.name!r}, "
                f"vocab={self.vocab_size}, dim={self.dim}, "
                f"opt={self.optimizer}, shards={self.n_shards}, "
                f"wire={self.wire_mode!r})")
