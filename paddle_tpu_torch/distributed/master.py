"""Task-queue master: dataset sharding with fault tolerance (counterpart
of ``paddle_tpu/distributed/master.py``; reference: go/master/service.go).

The dataset's chunks partition into tasks (service.go:106) over todo,
pending and done queues (:89-106); ``get_task`` (:368) hands one out
with a timeout, ``task_finished`` (:411) retires it, ``task_failed``
(:455) re-queues it within a per-task failure budget (failureMax :140),
and the queue state snapshots (:207).

``Master`` is the thread-safe queue object; ``MasterServer`` serves it
over TCP (newline-framed JSON-RPC, the Go master's net/rpc role) so
trainers in other processes or hosts consume tasks through
``MasterClient``, which duck-types the in-process API.  A trainer that
dies mid-task stops renewing: the task's deadline lapses and the chunk
re-queues for a survivor.  The wire format is the JAX package's byte for
byte, so either package's client talks to either package's server.
Host only: nothing here touches the card.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import socket
import socketserver
import threading
import time
from typing import Callable, List, Optional

from ..faults import RetryPolicy, classify
from ..observability import tracing as _tracing
from ..testing import faultinject as _fi
from ..testing import lockwatch as _lw

logger = logging.getLogger("paddle_tpu_torch")


@dataclasses.dataclass
class Task:
    task_id: int
    chunks: List            # opaque work units (e.g. file shards)
    epoch: int = 0
    num_failures: int = 0


class Master:
    """``world=None`` is the classic racy-pull queue (any trainer takes
    the next task).  ``world=K`` turns on **slot-sharded serving** — the
    elastic training service's data plane: worker slot ``w`` of ``K`` is
    served only tasks with ``task_id % K == w``, lowest id first, so
    each slot's stream is a DETERMINISTIC function of (dataset, slot,
    world) and a killed-and-relaunched worker replays bit-identically.
    Exactly-once is anchored to the worker's *committed* state: a slot
    re-registers with the cursor its checkpoint carries and the master
    reconciles its shard to that cursor (tasks committed stay done,
    uncommitted leases re-serve in order).

    The membership layer (``register_worker``/``heartbeat``/``members``)
    is the etcd-membership analog: lease-style staleness against
    ``heartbeat_lease_s``, a per-slot command channel (the coordinator's
    drain signal rides on heartbeat replies), all serialized in
    :meth:`state_dict` so membership survives a coordinator restart."""

    def __init__(self, chunks_per_task: int = 1, timeout_s: float = 60.0,
                 failure_max: int = 3, snapshot_path: Optional[str] = None,
                 num_epochs: int = 1, world: Optional[int] = None,
                 heartbeat_lease_s: float = 10.0):
        self.chunks_per_task = chunks_per_task
        self.timeout_s = timeout_s
        self.failure_max = failure_max
        self.snapshot_path = snapshot_path
        self.num_epochs = num_epochs
        if world is not None and world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        self.world = world
        self.heartbeat_lease_s = float(heartbeat_lease_s)
        self._lock = _lw.make_lock("master.queue")
        self.todo: List[Task] = []
        self.pending = {}           # task_id -> (Task, deadline, slot)
        self.done: List[Task] = []
        self.epoch = 0
        self._next_id = 0
        self._saving_trainer = ""
        self._saving_until = 0.0
        self._members: dict = {}    # slot -> {last_heartbeat, cursor, pid}
        self._commands: dict = {}   # slot -> pending command string

    # -- dataset -----------------------------------------------------------
    def set_dataset(self, chunks: List):
        """Partition chunks into tasks (service.go partition :106)."""
        with self._lock:
            self._set_dataset_locked(chunks)

    def _set_dataset_locked(self, chunks: List):
        self.todo = []
        for i in range(0, len(chunks), self.chunks_per_task):
            self.todo.append(Task(self._next_id,
                                  chunks[i:i + self.chunks_per_task],
                                  self.epoch))
            self._next_id += 1
        self.done = []
        self.pending = {}

    # -- trainer RPCs ------------------------------------------------------
    def get_task(self, slot: Optional[int] = None) -> Optional[Task]:
        with self._lock:
            self._requeue_timeouts()
            if self.world is not None:
                # sharded serving: deterministic per-slot stream (lowest
                # remaining id of this slot's shard); no epoch recycle —
                # an epoch barrier across slots belongs to the
                # coordinator, not a racy per-slot recycle
                if slot is None:
                    raise ValueError(
                        "this master serves slot-sharded streams "
                        f"(world={self.world}); call get_task(slot=...)")
                slot = int(slot)
                mine = [t for t in self.todo
                        if t.task_id % self.world == slot]
                if not mine:
                    return None
                t = min(mine, key=lambda t: t.task_id)
                self.todo.remove(t)
                self.pending[t.task_id] = (t, time.time() + self.timeout_s,
                                           slot)
                return t
            if not self.todo:
                if not self.pending and self.done \
                        and self.epoch + 1 < self.num_epochs:
                    # epoch finished: recycle for the next pass
                    self.epoch += 1
                    for t in self.done:
                        t.epoch = self.epoch
                        t.num_failures = 0
                    self.todo, self.done = self.done, []
                else:
                    return None
            t = self.todo.pop(0)
            self.pending[t.task_id] = (t, time.time() + self.timeout_s,
                                       slot)
            return t

    def task_finished(self, task_id: int):
        with self._lock:
            ent = self.pending.pop(task_id, None)
            if ent:
                self.done.append(ent[0])
            self._snapshot()

    def stats(self) -> dict:
        """Queue counters (the Go master's /debug status view)."""
        with self._lock:
            return {"todo": len(self.todo), "pending": len(self.pending),
                    "done": len(self.done), "epoch": self.epoch}

    def task_failed(self, task_id: int):
        """Re-queue unless failure budget exhausted (service.go:455-472)."""
        with self._lock:
            ent = self.pending.pop(task_id, None)
            if not ent:
                return
            t = ent[0]
            t.num_failures += 1
            if t.num_failures >= self.failure_max:
                self.done.append(t)     # dropped from training this pass
            else:
                self.todo.append(t)

    def task_returned(self, task_id: int):
        """Politely hand an in-flight task back (a reader stopped early,
        not a crash): requeue WITHOUT burning the failure budget."""
        with self._lock:
            ent = self.pending.pop(task_id, None)
            if ent:
                self.todo.append(ent[0])

    def set_dataset_if_empty(self, chunks: List) -> bool:
        """Atomic queue priming for concurrent trainers: the first caller
        partitions the dataset, later callers no-op (a client-side
        stats-then-set would race and re-issue in-flight tasks)."""
        with self._lock:
            if self.todo or self.pending or self.done:
                return False
            self._set_dataset_locked(chunks)
            return True

    def request_save_model(self, trainer_id: str,
                           block_dur_s: float = 60.0) -> bool:
        """Elect ONE trainer to checkpoint the model (service.go:481
        RequestSaveModel): the first requester within a window wins and
        re-asking by the winner stays true; everyone else gets False until
        ``block_dur_s`` elapses.  Prevents N trainers racing on the same
        checkpoint directory."""
        if not trainer_id:
            raise ValueError("trainer id is empty")
        with self._lock:
            now = time.time()
            if now >= self._saving_until:
                self._saving_trainer = ""
            need = (self._saving_trainer == "" or
                    self._saving_trainer == trainer_id)
            if need:
                self._saving_trainer = trainer_id
                self._saving_until = now + block_dur_s
            return need

    # -- membership (the etcd-membership analog) ---------------------------
    def register_worker(self, slot: int, cursor: Optional[int] = None,
                        pid: Optional[int] = None) -> dict:
        """(Re-)join the membership as ``slot``.  ``cursor`` is the count
        of this slot's shard tasks the worker's COMMITTED checkpoint
        covers: the shard is reconciled to it — the first ``cursor``
        tasks (ascending id) are forced done, and any lease the slot's
        previous incarnation still holds returns to todo so the stream
        re-serves in deterministic order.  Exactly-once is therefore
        anchored to committed state, not to the wire."""
        slot = int(slot)
        with self._lock:
            now = time.time()
            self._members[slot] = {"registered_at": now,
                                   "last_heartbeat": now,
                                   "cursor": cursor, "pid": pid}
            shard_done = None
            if self.world is not None:
                self._release_slot_leases(slot)
                if cursor is not None:
                    self._reconcile_cursor_locked(slot, int(cursor))
                # the authoritative committed count for this shard: the
                # worker adopts it as its cursor (post-resize there is no
                # per-worker cursor to carry — the re-shard rebased it).
                # Failure-budget drops are EXCLUDED: the worker's cursor
                # counts tasks it was served and committed, and a
                # dropped task was never part of that stream.
                shard_done = sum(1 for t in self.done
                                 if t.task_id % self.world == slot
                                 and not self._is_dropped(t))
            return {"ok": True, "world": self.world, "slot": slot,
                    "shard_done": shard_done}

    def heartbeat(self, slot: int, metrics: bool = False) -> dict:
        """Refresh ``slot``'s lease; the reply carries the coordinator's
        pending command for this slot (the drain channel).  With
        ``metrics=True`` the reply piggybacks this process's metrics
        snapshot + identity for the fleet collector (opt-in per call:
        the default reply stays byte-stable)."""
        slot = int(slot)
        with self._lock:
            m = self._members.get(slot)
            if m is None:          # heartbeat from a never-registered slot
                now = time.time()
                m = {"registered_at": now, "last_heartbeat": now,
                     "cursor": None, "pid": None}
                self._members[slot] = m
            m["last_heartbeat"] = time.time()
            cmd = self._commands.get(slot)
        from ..observability import inc_counter
        inc_counter("elastic/heartbeats")
        out = {"ok": True, "cmd": cmd}
        if metrics:
            from ..observability import metrics_snapshot
            out["metrics"] = metrics_snapshot()
            out["identity"] = {"role": "master", "pid": os.getpid()}
        return out

    def members(self) -> dict:
        """{slot: {age_s, stale, cursor, pid}} — staleness is lease-style
        against ``heartbeat_lease_s``."""
        with self._lock:
            now = time.time()
            out = {}
            for slot, m in self._members.items():
                age = now - m["last_heartbeat"]
                out[int(slot)] = {"age_s": round(age, 3),
                                  "stale": age > self.heartbeat_lease_s,
                                  "cursor": m.get("cursor"),
                                  "pid": m.get("pid")}
            return out

    def deregister_worker(self, slot: int):
        """Remove ``slot`` from membership and return its leases."""
        slot = int(slot)
        with self._lock:
            self._members.pop(slot, None)
            self._commands.pop(slot, None)
            if self.world is not None:
                self._release_slot_leases(slot)

    def set_command(self, cmd: Optional[str], slot: Optional[int] = None):
        """Queue a command for one slot (or every registered slot) to be
        delivered on its next heartbeat; ``cmd=None`` clears."""
        with self._lock:
            slots = [int(slot)] if slot is not None \
                else list(self._members)
            for s in slots:
                if cmd is None:
                    self._commands.pop(s, None)
                else:
                    self._commands[s] = str(cmd)

    def resize(self, world: int):
        """Re-shard the remaining work for a new world size (the mesh
        RESIZE boundary): every lease returns to todo, membership and
        commands reset — the relaunched workers re-register against the
        new shards.  ``done`` is global (task ids), so committed work
        stays committed across the re-shard."""
        world = int(world)
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        with self._lock:
            self.world = world
            for tid in list(self.pending):
                t, _deadline, _slot = self.pending.pop(tid)
                self.todo.append(t)
            self._members.clear()
            self._commands.clear()

    def _release_slot_leases(self, slot: int):
        """(locked) return every lease held by ``slot`` to todo."""
        for tid in list(self.pending):
            t, _deadline, holder = self.pending[tid]
            if holder == slot:
                del self.pending[tid]
                self.todo.append(t)

    def _is_dropped(self, t: Task) -> bool:
        """A task retired by the FAILURE BUDGET, not by training — it
        lives in done but was never committed by anyone, so cursor
        arithmetic must not count it."""
        return t.num_failures >= self.failure_max

    def _reconcile_cursor_locked(self, slot: int, cursor: int):
        """(locked) force the first ``cursor`` tasks of ``slot``'s shard
        (ascending id, EXCLUDING failure-budget drops — the worker was
        never served those, so its cursor doesn't count them) done;
        anything later that is marked done but NOT covered by the
        committed cursor goes back to todo (it finished on the wire but
        its model update was never committed)."""
        shard = sorted(
            t.task_id
            for t in self.todo + self.done +
            [e[0] for e in self.pending.values()]
            if t.task_id % self.world == slot
            and not self._is_dropped(t))
        committed = set(shard[:cursor])
        keep_todo = []
        for t in self.todo:
            if t.task_id in committed:
                self.done.append(t)
            else:
                keep_todo.append(t)
        self.todo = keep_todo
        keep_done = []
        for t in self.done:
            if t.task_id % self.world == slot \
                    and t.task_id not in committed \
                    and not self._is_dropped(t):
                self.todo.append(t)
            else:
                keep_done.append(t)
        self.done = keep_done
        for tid in list(self.pending):
            t, _deadline, _holder = self.pending[tid]
            if t.task_id in committed:
                del self.pending[tid]
                self.done.append(t)

    def _requeue_timeouts(self):
        now = time.time()
        for tid in list(self.pending):
            t, deadline, slot = self.pending[tid]
            if now > deadline and self.world is not None \
                    and slot is not None:
                # sharded mode: the task deadline is subordinate to the
                # MEMBERSHIP lease — a live (heartbeating) holder is
                # still training it, and re-serving the same task to
                # the same slot would double-train it and corrupt the
                # committed-cursor accounting.  Only a stale/absent
                # holder forfeits the lease.
                m = self._members.get(slot)
                if m is not None and \
                        now - m["last_heartbeat"] <= self.heartbeat_lease_s:
                    self.pending[tid] = (t, now + self.timeout_s, slot)
                    continue
            if now > deadline:
                del self.pending[tid]
                t.num_failures += 1
                if t.num_failures < self.failure_max:
                    self.todo.append(t)
                else:
                    self.done.append(t)

    def snapshot(self):
        """Write the queue state to ``snapshot_path`` NOW (public, locked
        form of the per-``task_finished`` snapshot — the etcd snapshot of
        go/master/service.go:207)."""
        with self._lock:
            self._snapshot()

    def state_dict(self) -> dict:
        """JSON-serializable queue state (locked).  The trainer embeds
        this in its checkpoint's TrainState so the queue position commits
        ATOMICALLY with the model (a separate snapshot file can be
        durably newer than the checkpoint it belongs to — restoring it
        would mark chunks done that the restored model never trained on).
        Pending tasks serialize into todo: a lease held at snapshot time
        must be re-served after a restore."""
        with self._lock:
            return self._state_dict_locked()

    def _state_dict_locked(self) -> dict:
        return {"epoch": self.epoch,
                "todo": [dataclasses.asdict(t) for t in self.todo],
                "pending": [dataclasses.asdict(t)
                            for t, _, _ in self.pending.values()],
                "done": [dataclasses.asdict(t) for t in self.done],
                "world": self.world,
                # membership rides along so a restarted coordinator
                # still knows its fleet (ages computed lazily, so a
                # long outage reads as every member stale — correct)
                "membership": {str(s): dict(m) for s, m in
                               self._members.items()}}

    def load_state_dict(self, state: dict):
        """Restore queue state captured by :meth:`state_dict` (locked)."""
        with self._lock:
            self.epoch = state["epoch"]
            self.todo = [Task(**t) for t in
                         state["todo"] + state["pending"]]
            self.pending = {}
            self.done = [Task(**t) for t in state["done"]]
            self._next_id = max(
                [t.task_id for t in self.todo + self.done] + [-1]) + 1
            if state.get("world") is not None:
                self.world = int(state["world"])
            # JSON round-trips dict keys as strings; slots are ints
            self._members = {int(s): dict(m) for s, m in
                             state.get("membership", {}).items()}
            self._commands = {}

    def _snapshot(self):
        if not self.snapshot_path:
            return
        # the state_dict body, verbatim (copy-paste drift here once lost
        # the world/membership fields on the snapshot path)
        with open(self.snapshot_path, "w") as f:
            json.dump(self._state_dict_locked(), f)

    def restore_snapshot(self):
        if not self.snapshot_path:
            return
        with open(self.snapshot_path) as f:
            state = json.load(f)
        self.load_state_dict(state)


class MasterServer:
    """Serve a Master over TCP (go/master RPC server analog).

    Wire protocol: one JSON object per line, ``{"method": m, "params": {...}}``
    -> ``{"result": ...}`` or ``{"error": "..."}``.  Threaded: each trainer
    connection gets its own handler thread; Master methods are internally
    locked.
    """

    METHODS = ("get_task", "task_finished", "task_failed", "task_returned",
               "set_dataset", "set_dataset_if_empty", "stats", "ping",
               "request_save_model", "register_worker", "heartbeat",
               "members", "deregister_worker", "state_dict")

    def __init__(self, master: Master, host: str = "127.0.0.1",
                 port: int = 0):
        self.master = master
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                for line in self.rfile:
                    try:
                        req = json.loads(line)
                        # ctx rides the envelope only when the caller
                        # observes; malformed ctx is rejected-and-counted
                        # in extract() and the call still serves
                        parent = _tracing.extract(req.get("ctx")) \
                            if "ctx" in req else None
                        if parent is not None:
                            with _tracing.span("master/rpc", parent=parent,
                                               method=req.get("method")):
                                result = outer._dispatch(
                                    req.get("method"),
                                    req.get("params") or {})
                        else:
                            result = outer._dispatch(
                                req.get("method"), req.get("params") or {})
                        payload = json.dumps({"result": result})
                    except Exception as e:  # noqa: BLE001 — report to client
                        # includes result-serialization failures (chunks
                        # must be JSON-encodable: paths/ids, not payloads)
                        payload = json.dumps(
                            {"error": f"{type(e).__name__}: {e}"})
                    self.wfile.write((payload + "\n").encode())
                    self.wfile.flush()

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server((host, port), Handler)
        self.host, self.port = self._server.server_address
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="pt-master-rpc", daemon=True)

    def _dispatch(self, method, params):
        if method not in self.METHODS:
            raise ValueError(f"unknown method {method!r}")
        if method == "ping":
            return "pong"
        if method == "get_task":
            t = self.master.get_task(slot=params.get("slot"))
            return dataclasses.asdict(t) if t is not None else None
        if method == "register_worker":
            return self.master.register_worker(
                params["slot"], cursor=params.get("cursor"),
                pid=params.get("pid"))
        if method == "heartbeat":
            return self.master.heartbeat(
                params["slot"], metrics=bool(params.get("metrics")))
        if method == "members":
            return self.master.members()
        if method == "deregister_worker":
            return self.master.deregister_worker(params["slot"])
        if method == "state_dict":
            return self.master.state_dict()
        if method == "set_dataset":
            return self.master.set_dataset(params["chunks"])
        if method == "set_dataset_if_empty":
            return self.master.set_dataset_if_empty(params["chunks"])
        if method == "stats":
            return self.master.stats()
        if method == "request_save_model":
            return self.master.request_save_model(
                params["trainer_id"], params.get("block_dur_s", 60.0))
        return getattr(self.master, method)(params["task_id"])

    def start(self) -> "MasterServer":
        self._thread.start()
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()

    @property
    def address(self):
        return f"{self.host}:{self.port}"


class MasterClient:
    """Trainer-side RPC stub with the Master's duck-typed API, so
    ``TaskQueueClient`` works unchanged against a remote master (the Go
    master_client / v2 master.client analog)."""

    def __init__(self, address: str, timeout_s: float = 30.0,
                 retries: int = 3, retry_wait_s: float = 0.5,
                 retry_policy: Optional[RetryPolicy] = None):
        host, port = address.rsplit(":", 1)
        self._addr = (host, int(port))
        self._timeout = timeout_s
        # exponential backoff + deterministic jitter between reconnect
        # attempts (a flat retry_wait hammers a restarting master); the
        # default derives from the legacy knobs so existing callers keep
        # their first-retry latency.  An explicit policy owns BOTH the
        # delays and the attempt count.
        self._retry_policy = retry_policy or RetryPolicy(
            max_attempts=max(retries, 1), backoff_base_s=retry_wait_s,
            backoff_max_s=8.0, jitter=0.1, seed=0)
        self._retries = self._retry_policy.max_attempts
        self._sock = None
        self._file = None
        self._lock = _lw.make_lock("master.client")
        # observe resolved ONCE at construction:
        # off -> no ctx key ever enters the envelope, the wire is
        # byte-identical to the pre-tracing protocol
        from ..observability import enabled as _obs_enabled
        self._observe = _obs_enabled()

    def _connect(self, timeout=None):
        self._sock = socket.create_connection(
            self._addr, timeout=self._timeout if timeout is None
            else timeout)
        self._file = self._sock.makefile("rwb")

    def _call(self, method, _retries=None, _timeout=None,
              _sock_deadline=None, **params):
        retries = self._retries if _retries is None else _retries
        with self._lock:
            # The socket deadline is mutated (and restored) only while the
            # lock is held, so a concurrent RPC can never observe the
            # shortened timeout mid-read.
            sock, old = self._sock, None
            if _sock_deadline is not None and sock is not None:
                try:               # bound reads on the live socket too
                    old = sock.gettimeout()
                    sock.settimeout(_sock_deadline)
                except OSError:
                    pass
            try:
                last = None
                for attempt in range(retries):
                    try:
                        if _fi.ENABLED:
                            action = _fi.check("master.call")
                            if action == "drop":
                                self.close()   # the wire really went away
                            if action is not None:
                                _fi.raise_for(action, "master.call")
                        if self._file is None:
                            self._connect(_timeout)
                        req = {"method": method, "params": params}
                        if self._observe:
                            ctx = _tracing.inject()
                            if ctx is not None:
                                req["ctx"] = ctx
                        self._file.write((json.dumps(req) +
                                          "\n").encode())
                        self._file.flush()
                        line = self._file.readline()
                        if not line:
                            raise ConnectionError("master closed connection")
                        resp = json.loads(line)
                        if "error" in resp:
                            raise RuntimeError(f"master: {resp['error']}")
                        return resp["result"]
                    except (OSError, ConnectionError,
                            json.JSONDecodeError) as e:
                        last = e
                        self.close()
                        if attempt + 1 < retries:
                            d = self._retry_policy.delay(attempt)
                            from ..observability import (emit_event,
                                                         inc_counter)
                            inc_counter("fault/retries")
                            emit_event(
                                "fault", event="retry", site="master.call",
                                attempt=attempt + 1,
                                delay_s=round(d, 4),
                                error=f"{type(e).__name__}: {e}")
                            time.sleep(d)
                raise ConnectionError(
                    f"master at {self._addr} unreachable: {last}")
            finally:
                # restore the configured deadline on whatever socket is
                # live afterwards — the original, or a short-deadline
                # reconnect — so later RPCs don't inherit it
                if _sock_deadline is not None:
                    cur = self._sock
                    if cur is not None:
                        try:
                            cur.settimeout(
                                old if (cur is sock and old is not None)
                                else self._timeout)
                        except OSError:
                            pass

    # -- Master duck-type --------------------------------------------------
    def get_task(self, slot: Optional[int] = None) -> Optional[Task]:
        params = {} if slot is None else {"slot": int(slot)}
        d = self._call("get_task", **params)
        return Task(**d) if d is not None else None

    def register_worker(self, slot: int, cursor: Optional[int] = None,
                        pid: Optional[int] = None) -> dict:
        return self._call("register_worker", slot=int(slot), cursor=cursor,
                          pid=pid)

    def heartbeat(self, slot: int, metrics: bool = False) -> dict:
        """Single-attempt, <=2 s best-effort lease refresh: a heartbeat
        that cannot reach the master is LOST, not retried — the
        coordinator reads the resulting staleness, which is the signal
        heartbeats exist to carry.  ``metrics=True`` asks the master to
        piggyback its metrics snapshot on the reply (fleet collector)."""
        params = {"slot": int(slot)}
        if metrics:
            params["metrics"] = True
        return self._call("heartbeat", _retries=1, _timeout=2.0,
                          _sock_deadline=2.0, **params)

    def members(self) -> dict:
        m = self._call("members")
        return {int(k): v for k, v in m.items()}

    def deregister_worker(self, slot: int):
        return self._call("deregister_worker", slot=int(slot))

    def state_dict(self) -> dict:
        """Remote form of ``Master.state_dict`` so a worker's
        ``train(master=client)`` checkpoint embedding works unchanged
        against a served master."""
        return self._call("state_dict")

    def task_finished(self, task_id: int):
        return self._call("task_finished", task_id=task_id)

    def task_failed(self, task_id: int):
        return self._call("task_failed", task_id=task_id)

    def task_returned(self, task_id: int):
        return self._call("task_returned", task_id=task_id)

    def task_returned_nowait(self, task_id: int):
        """Single-attempt, <=2 s best-effort ``task_returned`` for
        generator-close paths: the default retry loop (3 x 30 s connect
        timeout) can stall a ``cloud_reader`` close ~90 s when the
        master is dead, and the caller is about to discard the result
        anyway — the task's lease times out and requeues regardless."""
        return self._call("task_returned", _retries=1, _timeout=2.0,
                          _sock_deadline=2.0, task_id=task_id)

    def set_dataset(self, chunks: List):
        return self._call("set_dataset", chunks=chunks)

    def set_dataset_if_empty(self, chunks: List) -> bool:
        return self._call("set_dataset_if_empty", chunks=chunks)

    def stats(self) -> dict:
        return self._call("stats")

    def ping(self) -> str:
        return self._call("ping")

    def request_save_model(self, trainer_id: str,
                           block_dur_s: float = 60.0) -> bool:
        return self._call("request_save_model", trainer_id=trainer_id,
                          block_dur_s=block_dur_s)

    def close(self):
        try:
            if self._sock is not None:
                self._sock.close()
        except OSError:
            pass
        self._sock = None
        self._file = None


class TaskQueueClient:
    """Trainer-side helper (go/master client + v2 master.client analog):
    iterate data via master tasks with automatic finish/fail reporting."""

    def __init__(self, master: Master, chunk_reader: Callable):
        self.master = master
        self.chunk_reader = chunk_reader

    def reader(self):
        return task_loop_reader(self.master, self.chunk_reader,
                                swallow_failures=True)


def task_loop_reader(client, chunk_reader: Callable,
                     swallow_failures: bool = False):
    """The shared task-pull loop (go/master client semantics) used by
    both in-process ``TaskQueueClient`` and ``reader.creator.cloud_reader``:
    finish on success; FAIL (budget-burning) on real exceptions; RETURN
    without burning the budget on polite early-stop (GeneratorExit from
    ``firstn``/loop breaks — the task requeues immediately for peers).
    ``swallow_failures`` keeps iterating past bad chunks (the elastic
    in-process behavior) instead of re-raising."""

    def _r():
        from ..observability import inc_counter

        # ONE budget-free return per task (the documented exactly-once
        # contract): the first retryable failure hands the task back
        # without burning budget; any further failure of the same task
        # burns real failure budget (and drops it at failure_max) — a
        # chunk that fails every time can never ping-pong through todo
        # forever.  `fails` counts every retryable failure per task and
        # drives the escalating swallow-mode backoff.
        free_returns = {}
        fails = {}

        while True:
            task = client.get_task()
            if task is None:
                return
            try:
                for chunk in task.chunks:
                    yield from chunk_reader(chunk)
            except GeneratorExit:
                # best-effort: finalization must not raise or stall hard
                # if the master died (the task times out and requeues
                # anyway, at the cost of one budget tick).  Remote clients
                # take the single-attempt <=2 s path — the default retry
                # loop would hold the closing generator ~90 s.
                ret = getattr(client, "task_returned_nowait",
                              client.task_returned)
                try:
                    ret(task.task_id)
                    inc_counter("fault/tasks_returned")
                except Exception:
                    pass
                raise
            except Exception as e:
                n = free_returns.get(task.task_id, 0)
                nf = fails.get(task.task_id, 0)
                if classify(e) == "retryable":
                    fails[task.task_id] = nf + 1
                if classify(e) == "retryable" and n < 1:
                    # Transient failure mid-chunk: the work is NOT
                    # idempotent from here (records already yielded), so
                    # the task goes back to the master EXACTLY ONCE —
                    # budget-free — before anyone retries it; re-serving
                    # from the top is the retry.
                    free_returns[task.task_id] = n + 1
                    try:
                        client.task_returned(task.task_id)
                        inc_counter("fault/tasks_returned")
                    except Exception as re:  # noqa: BLE001
                        logger.warning(
                            "could not return task %s after transient "
                            "failure (%s); its lease will lapse",
                            task.task_id, re)
                    if swallow_failures:
                        time.sleep(0.05 * (2 ** min(nf, 4)))   # escalate
                        continue
                    raise
                client.task_failed(task.task_id)
                if swallow_failures:
                    if classify(e) == "retryable":
                        time.sleep(0.05 * (2 ** min(nf, 4)))
                    continue
                raise
            client.task_finished(task.task_id)

    return _r
