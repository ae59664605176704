"""Elastic multi-worker training service: die/rejoin workers over
exactly-once streams, with checkpointed resize (counterpart of
``paddle_tpu/distributed/elastic.py``).

The service composes the runtime's fault-tolerance pieces: the
slot-sharded exactly-once :class:`~.master.Master` and its
membership/heartbeat layer, :class:`~.supervisor.Supervisor`'s bounded
relaunch, checkpoints with the :class:`TrainState` inside, and the
``analysis.planner`` re-plan, into one job runner:

* **Worker** (:class:`ElasticWorker` + ``trainer.SGD.train(elastic=)``):
  a training process that streams its deterministic shard of the
  dataset from the coordinator's master (worker ``w`` of ``K`` sees the
  tasks with ``task_id % K == w``, lowest id first), commits a
  checkpoint at every task boundary, and reports ``task_finished`` only
  after that commit is durable: exactly-once anchored to committed
  model state, not to the wire.  The position (task cursor and
  within-task batch offset) rides in ``TrainState.elastic``, so a
  SIGKILLed worker relaunched by the coordinator replays bit for bit:
  the master re-serves its uncommitted lease, the stream skips to the
  committed offset.  Heartbeats double as the control channel: the
  coordinator's ``drain`` command rides back on the reply.  On the card
  a worker runs its steps with cuDNN's deterministic algorithms
  (:func:`worker_main`), so a replayed step computes what the first run
  computed.

* **Coordinator** (:class:`ElasticJob`): spawns K worker subprocesses,
  watches exits and heartbeat staleness, relaunches dead workers through
  ``Supervisor.relaunch_gate`` (bounded), and on a membership change
  (a worker lost for good, or a scale request) performs a **resize**:
  drain every worker to a task boundary, merge the per-slot replicas
  (elementwise parameter mean, the local-SGD synchronization point),
  re-plan with ``analysis.planner`` for the new world size (checked
  against the PT030/PT031 sharding lints), re-shard the remaining work
  (``Master.resize``), seed every new slot from the merged base, commit
  a durable record (``records.jsonl`` in the job root, an ``elastic``
  JSONL event, an ``elastic/resize`` span, the base checkpoint's
  ``TrainState.elastic``) and relaunch.  A coordinator SIGTERM drains
  the fleet, commits the same record and exits ``EXIT_PREEMPTED``;
  rerunning the same command resumes the job from the record.  The
  coordinator is host work: it never touches the card (the merge
  restores onto the CPU); only its workers do.

Nothing imports this module at the package's top level: ``python -m
paddle_tpu_torch elastic`` and callers load it on use.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import signal as _signal
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..faults import EXIT_PREEMPTED
from ..observability import emit_event, inc_counter, observe_hist, set_gauge
from ..observability.tracing import start_span
from ..testing import faultinject as _fi
from ..train_state import TRAIN_STATE_VAR, TrainState
from .checkpoint import CheckpointManager
from .master import Master, MasterClient, MasterServer
from .supervisor import Supervisor

logger = logging.getLogger("paddle_tpu_torch")

__all__ = ["ElasticWorker", "ElasticConfig", "ElasticJob", "WorkerSpec",
           "merge_checkpoints", "plan_for_world", "elastic_main",
           "worker_main", "worker_place", "prebuild_kernels"]


# ---------------------------------------------------------------------------
# Worker side
# ---------------------------------------------------------------------------
class ElasticWorker:
    """The ``Trainer.train(elastic=...)`` hook + the sharded stream.

    Usage (normally assembled by ``elastic_main --worker``)::

        worker = ElasticWorker(address, slot=w, batch_size=B)
        trainer.train(worker.reader, num_passes=1, elastic=worker,
                      checkpoint_dir=slot_dir, resume=True)

    The commit protocol per task ``T`` of this slot's shard:

    1. every batch of ``T`` trains (each batch is a dispatch boundary);
    2. at the task boundary the stream requests a BLOCKING checkpoint
       (``Checkpointer.request_save``) whose ``TrainState.elastic``
       carries ``cursor = tasks committed`` / ``offset = 0``;
    3. only after that commit lands does the hook report
       ``task_finished(T)`` to the master.

    A crash at any point resumes exactly: the relaunched worker
    re-registers with its COMMITTED cursor, the master reconciles its
    shard to it (committed stays done, uncommitted leases re-serve in
    order), and the stream skips ``offset`` batches of the re-served
    task: the replayed fetches are bit-identical to the uninterrupted
    run's.
    """

    def __init__(self, address: str, slot: int, batch_size: int,
                 heartbeat_interval_s: float = 0.5,
                 world: Optional[int] = None, resize_epoch: int = 0,
                 client: Optional[MasterClient] = None,
                 drop_last: bool = False):
        self.address = address
        self.slot = int(slot)
        self.batch_size = int(batch_size)
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.world = world
        self.resize_epoch = int(resize_epoch)
        self.drop_last = drop_last
        self._client = client or MasterClient(address)
        self.cursor = 0            # committed tasks of this slot's shard
        self.offset = 0            # batches of the CURRENT task trained
        self._resume_offset = 0
        # task ids trained but not yet reported finished (a LIST: two
        # consecutive zero-batch tasks — empty part files — must both
        # commit, not overwrite each other)
        self._pending_commit: List[int] = []
        self._drain = False
        self.drained = False
        self._ckpt = None
        self._last_hb = float("-inf")
        self._hb_stop: Optional[object] = None   # threading.Event

    @property
    def emitted(self) -> int:
        """Batches completed across relaunches (the Checkpointer's
        restored counter) — the stable per-slot stream index the chaos
        suite keys its bit-identity merges on."""
        return self._ckpt.emitted if self._ckpt is not None else 0

    # -- train() hook surface (duck-typed; trainer never imports us) -------
    def state(self) -> dict:
        """Rides in every checkpoint's ``TrainState.elastic``."""
        return {"slot": self.slot, "cursor": self.cursor,
                "offset": self.offset, "world": self.world,
                "resize_epoch": self.resize_epoch}

    def bind(self, ckpt, ts: Optional[TrainState]):
        """Called by ``train()`` after restore: register with the
        membership layer, reconcile the master's shard to the COMMITTED
        cursor, and arm the within-task offset skip."""
        self._ckpt = ckpt
        cursor = None
        self._resume_offset = 0
        if ts is not None and ts.elastic:
            e = ts.elastic
            # position transfers only within a membership generation; a
            # merged resize base deliberately carries cursor=None (the
            # master's reconciled done-set is authoritative there)
            cursor = e.get("cursor")
            if cursor is not None:
                self._resume_offset = int(e.get("offset") or 0)
        resp = self._client.register_worker(self.slot, cursor=cursor,
                                            pid=os.getpid())
        self.cursor = int(resp.get("shard_done") or 0)
        if resp.get("world") is not None:
            self.world = int(resp["world"])
        self.offset = 0
        self._last_hb = float("-inf")   # heartbeat on the first batch
        self._start_heartbeat_thread()

    def _start_heartbeat_thread(self):
        """Membership liveness must not depend on batch cadence: a
        single batch (or a first step's warm-up and capture) longer
        than the coordinator's lease would otherwise read as a dead worker and get this
        process SIGKILLed mid-step.  A daemon thread keeps the lease
        fresh on wall-clock time; MasterClient serializes concurrent
        RPCs internally."""
        import threading
        if self.heartbeat_interval_s <= 0 or self._hb_stop is not None:
            return
        stop = threading.Event()
        self._hb_stop = stop

        def loop():
            while not stop.wait(self.heartbeat_interval_s):
                self._maybe_heartbeat(force=True)

        threading.Thread(target=loop, daemon=True,
                         name=f"pt-elastic-hb-{self.slot}").start()

    def after_batch(self):
        """Per completed batch (after ``Checkpointer.on_batch_done``):
        injection sites, post-commit ``task_finished``, heartbeat."""
        idx = self._ckpt.emitted if self._ckpt is not None else 0
        if _fi.ENABLED:
            action = _fi.check("elastic.worker", index=idx)
            if action == "kill":
                # REAL SIGKILL: no handler, no emergency checkpoint —
                # the supervisor sees signal death and relaunches
                os.kill(os.getpid(), _signal.SIGKILL)
            elif action == "preempt":
                if self._ckpt is not None:
                    self._ckpt.request_preempt()
            elif action is not None:
                _fi.raise_for(action, "elastic.worker", idx)
        self._commit_if_saved()
        self._maybe_heartbeat()

    def on_complete(self):
        """After the trainer's final save: the last task's state is
        durable — report it and leave the membership."""
        if self._hb_stop is not None:
            self._hb_stop.set()
            self._hb_stop = None
        self._commit_if_saved()
        try:
            self._client.deregister_worker(self.slot)
        except (ConnectionError, OSError):
            pass                    # master gone: nothing left to leave
        self._client.close()

    # -- stream -------------------------------------------------------------
    def reader(self):
        """Batches of this slot's shard, task by task (batches never
        straddle a task — the commit protocol's unit of replay)."""
        from ..reader.creator import _read_part

        while True:
            if self._drain:
                # coordinator-commanded drain lands at a TASK boundary:
                # the stream simply ends; train() commits the final
                # state, and worker_main exits EXIT_PREEMPTED
                self.drained = True
                inc_counter("elastic/drains")
                return
            task = self._client.get_task(slot=self.slot)
            if task is None:
                return
            skip = self._resume_offset
            self._resume_offset = 0
            n = 0
            batch = []
            try:
                for chunk in task.chunks:
                    for rec in _read_part(chunk):
                        batch.append(rec)
                        if len(batch) == self.batch_size:
                            n += 1
                            if n > skip:
                                self.offset = n
                                yield batch
                            batch = []
                if batch and not self.drop_last:
                    n += 1
                    if n > skip:
                        self.offset = n
                        yield batch
            except GeneratorExit:
                # polite early close (preemption mid-task): hand the
                # lease back so the re-serve needs no timeout lapse;
                # best-effort — re-registration releases it anyway
                try:
                    self._client.task_returned_nowait(task.task_id)
                    inc_counter("fault/tasks_returned")
                except (ConnectionError, OSError, RuntimeError):
                    pass     # master gone/unhappy: re-register releases it
                raise
            # task boundary: advance the committed position, ask for a
            # blocking checkpoint, and only then (see after_batch /
            # on_complete) report the task finished
            self.cursor += 1
            self.offset = 0
            self._pending_commit.append(task.task_id)
            if self._ckpt is not None:
                self._ckpt.request_save()

    # -- internals ----------------------------------------------------------
    def _commit_if_saved(self):
        if not self._pending_commit:
            return
        if self._ckpt is not None and self._ckpt.save_pending:
            return                  # the commit has not landed yet
        while self._pending_commit:
            self._client.task_finished(self._pending_commit[0])
            self._pending_commit.pop(0)

    def _maybe_heartbeat(self, force: bool = False):
        now = time.monotonic()
        if not force and now - self._last_hb < self.heartbeat_interval_s:
            return
        self._last_hb = now
        try:
            if _fi.ENABLED:
                action = _fi.check("master.heartbeat")
                if action is not None:
                    _fi.raise_for(action, "master.heartbeat")
            resp = self._client.heartbeat(self.slot)
        except (ConnectionError, OSError):
            return                  # lost heartbeat: staleness IS the signal
        if (resp or {}).get("cmd") == "drain":
            self._drain = True


# ---------------------------------------------------------------------------
# Planner integration
# ---------------------------------------------------------------------------
def plan_for_world(program, world: int, assume_batch: int = 64) -> dict:
    """Re-plan the job's program for a new world size and re-validate
    against the sharding lints.  Returns the resize record's ``plan``
    payload: the serialized plan + the (empty, by contract) PT030/PT031
    finding list — the proof each resize boundary carries."""
    from ..analysis import ValidationReport
    from ..analysis.lints import run_sharding_lints
    from ..analysis import planner

    mesh = {"dp": int(world)}
    p = planner.plan(program, mesh, assume_batch=assume_batch)
    report = ValidationReport()
    run_sharding_lints(program, mesh, report, param_specs=p.param_specs,
                       feed_specs=p.feed_specs)
    findings = [str(d) for d in report
                if d.code in ("PT030", "PT031")]
    return {"mesh": mesh, "candidate": p.candidate,
            "plan": p.to_dict(), "lint_findings": findings}


# ---------------------------------------------------------------------------
# Replica merge (the resize synchronization point)
# ---------------------------------------------------------------------------
def merge_checkpoints(slot_dirs: Sequence[str], out_dir: str, *,
                      world: int, resize_epoch: int) -> dict:
    """Average the newest intact checkpoint of every slot into one base
    checkpoint under ``out_dir`` (local-SGD synchronization): floating
    vars merge as the elementwise mean of the replicas, computed in
    float32 as the JAX merge computes it (bfloat16 widens to float32 and
    rounds back); everything else (int counters, mismatched shapes)
    takes the chief's value, the chief being the replica with the most
    emitted batches.  The base's TrainState restarts the pass loop
    (``pass_id=0``) and carries the resize lineage in its ``elastic``
    field with ``cursor=None`` (the master's reconciled done-set is
    authoritative across a re-shard).  Restores go to the CPU: the merge
    is host work and makes no CUDA context."""
    import torch

    from ..core.scope import Scope, to_numpy

    replicas = []
    for d in slot_dirs:
        mgr = CheckpointManager(d, async_save=False, device="cpu")
        if not mgr.all_steps():
            continue
        sc = Scope()
        try:
            mgr.restore(scope=sc)
        except FileNotFoundError:
            continue
        ts = None
        if sc.has(TRAIN_STATE_VAR):
            ts = TrainState.from_array(sc.get(TRAIN_STATE_VAR))
            sc.delete(TRAIN_STATE_VAR)
        replicas.append((d, sc, ts))
    if not replicas:
        raise FileNotFoundError(
            f"resize merge: no intact slot checkpoint among {slot_dirs}")
    chief_dir, chief, chief_ts = max(
        replicas, key=lambda r: (r[2].emitted if r[2] else -1))
    merged = Scope()
    for name in chief.keys():
        value = chief.get(name)
        if isinstance(value, torch.Tensor) and value.is_floating_point():
            base = to_numpy(value)
            vals = [base]
            for _, sc, _ in replicas:
                if sc is chief or not sc.has(name):
                    continue
                v = sc.get(name)
                if isinstance(v, torch.Tensor) and v.dtype == value.dtype \
                        and tuple(v.shape) == tuple(value.shape):
                    vals.append(to_numpy(v))
            if len(vals) > 1:
                mean = np.mean(np.stack(vals), axis=0).astype(base.dtype)
                value = torch.from_numpy(mean).to(value.dtype)
        merged.set(name, value)
    ts = chief_ts or TrainState()
    ts = dataclasses.replace(
        ts, pass_id=0, batch_id=0, emergency=False, master=None,
        elastic={"slot": None, "cursor": None, "offset": 0,
                 "world": int(world), "resize_epoch": int(resize_epoch)})
    merged.set(TRAIN_STATE_VAR, ts.to_array())
    out = CheckpointManager(out_dir, async_save=False, max_to_keep=1,
                            device="cpu")
    out.save(ts.emitted, merged, blocking=True)
    return {"merged_from": [d for d, _, _ in replicas],
            "chief": chief_dir, "emitted": ts.emitted,
            "exe_step": ts.exe_step}


# ---------------------------------------------------------------------------
# Coordinator
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class WorkerSpec:
    """Everything a worker subprocess needs to join the job."""
    slot: int
    world: int
    resize_epoch: int
    address: str
    ckpt_dir: str


@dataclasses.dataclass
class ElasticConfig:
    workers: int
    data: List[str]                    # chunk paths (part files)
    root: str                          # job root: checkpoints + records
    worker_cmd: Callable[[WorkerSpec], List[str]]
    program: Optional[object] = None   # Program for the resize re-plans
    chunks_per_task: int = 1
    task_timeout_s: float = 60.0
    heartbeat_lease_s: float = 5.0
    drain_timeout_s: float = 120.0
    max_restarts: int = 3
    # consecutive resize boundaries with ZERO new committed tasks before
    # the job gives up (a fleet that deterministically dies before its
    # first commit would otherwise resize forever)
    max_stalled_resizes: int = 3
    assume_batch: int = 64
    poll_s: float = 0.25
    host: str = "127.0.0.1"
    port: int = 0
    env: Optional[dict] = None         # worker subprocess environment


class ElasticJob:
    """The coordinator: membership, bounded relaunch, and RESIZE."""

    def __init__(self, config: ElasticConfig):
        self.cfg = config
        if config.workers < 1:
            raise ValueError(f"workers must be >= 1, got {config.workers}")
        self.world = int(config.workers)
        self.resize_epoch = 0
        self.master: Optional[Master] = None
        self.server: Optional[MasterServer] = None
        self._procs: Dict[int, subprocess.Popen] = {}
        self._spawned_at: Dict[int, float] = {}
        self._sups: Dict[int, Supervisor] = {}
        self._done_slots: set = set()
        # plain attributes, deliberately lock-free: request_stop runs in
        # a SIGNAL HANDLER on the main thread — taking a lock there can
        # deadlock against the run loop holding it; single-word
        # reads/writes are GIL-atomic, which is all these flags need
        self._target: Optional[int] = None
        self._stop = False
        self.resizes: List[dict] = []
        self.completed = False
        self._stalled_resizes = 0
        self._done_at_last_resize = 0

    # -- paths --------------------------------------------------------------
    def _gen_dir(self, epoch: Optional[int] = None) -> str:
        e = self.resize_epoch if epoch is None else epoch
        return os.path.join(self.cfg.root, f"gen-{e}")

    def _slot_dir(self, slot: int, epoch: Optional[int] = None) -> str:
        return os.path.join(self._gen_dir(epoch), f"slot-{slot}")

    def _base_dir(self, epoch: Optional[int] = None) -> str:
        return os.path.join(self._gen_dir(epoch), "base")

    @property
    def _job_path(self) -> str:
        return os.path.join(self.cfg.root, "job.json")

    @property
    def _records_path(self) -> str:
        return os.path.join(self.cfg.root, "records.jsonl")

    @property
    def address(self) -> str:
        return self.server.address

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        os.makedirs(self.cfg.root, exist_ok=True)
        resumed = self._load_job_state()
        self.master = self._build_master(resumed)
        self.server = MasterServer(self.master, host=self.cfg.host,
                                   port=self.cfg.port).start()
        if not resumed:
            self._commit_record("start", plan=self._replan())
        os.makedirs(self._gen_dir(), exist_ok=True)
        for slot in range(self.world):
            self._spawn(slot)
        self._set_workers_gauge()
        return self

    def _build_master(self, resumed: bool) -> Master:
        m = Master(chunks_per_task=self.cfg.chunks_per_task,
                   timeout_s=self.cfg.task_timeout_s,
                   world=self.world,
                   heartbeat_lease_s=self.cfg.heartbeat_lease_s)
        if resumed:
            with open(self._job_path) as f:
                state = json.load(f)
            m.load_state_dict(state["master"])
            # the pre-outage membership is forensic only: every entry's
            # heartbeat predates the outage, and letting it ride would
            # make _poll_workers stale-kill the FRESH workers we are
            # about to spawn before they can register.  resize() to the
            # same world clears membership/commands and returns any
            # stray leases to todo (idempotent re-shard).
            m.resize(self.world)
        else:
            m.set_dataset(list(self.cfg.data))
        return m

    def _load_job_state(self) -> bool:
        """True when an unfinished job record exists (idempotent resume:
        the coordinator was SIGTERMed or crashed mid-job)."""
        if not os.path.exists(self._job_path):
            return False
        with open(self._job_path) as f:
            state = json.load(f)
        if state.get("completed"):
            return False
        self.world = int(state["world"])
        self.resize_epoch = int(state["resize_epoch"])
        logger.warning(
            "elastic: resuming job from %s (world=%d, resize_epoch=%d)",
            self._job_path, self.world, self.resize_epoch)
        return True

    def _save_job_state(self, completed: bool = False):
        state = {"world": self.world, "resize_epoch": self.resize_epoch,
                 "completed": completed,
                 "master": self.master.state_dict()}
        tmp = self._job_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, self._job_path)

    def _commit_record(self, event: str, **fields):
        """Durable job-boundary record: one line in the job root's
        ``records.jsonl`` (always) + an ``elastic`` JSONL event on the
        observability stream (when a metrics_log is set) + the job-state
        snapshot the idempotent resume reads."""
        rec = {"ts": round(time.time(), 6), "event": event,
               "world": self.world, "resize_epoch": self.resize_epoch,
               **fields}
        with open(self._records_path, "a") as f:
            f.write(json.dumps(rec, default=repr) + "\n")
        emit_event("elastic", **rec)
        self._save_job_state(completed=(event == "complete"))
        return rec

    def _replan(self) -> Optional[dict]:
        if self.cfg.program is None:
            return None
        payload = plan_for_world(self.cfg.program, self.world,
                                 assume_batch=self.cfg.assume_batch)
        if payload["lint_findings"]:       # pragma: no cover - plan() bug
            raise RuntimeError(
                f"resize re-plan failed the sharding lints: "
                f"{payload['lint_findings']}")
        return payload

    # -- workers ------------------------------------------------------------
    def _spec(self, slot: int) -> WorkerSpec:
        return WorkerSpec(slot=slot, world=self.world,
                          resize_epoch=self.resize_epoch,
                          address=self.server.address,
                          ckpt_dir=self._slot_dir(slot))

    def _spawn(self, slot: int):
        os.makedirs(self._slot_dir(slot), exist_ok=True)
        argv = self.cfg.worker_cmd(self._spec(slot))
        env = dict(os.environ)
        if self.cfg.env:
            env.update(self.cfg.env)
        self._procs[slot] = subprocess.Popen(list(argv), env=env)
        self._spawned_at[slot] = time.monotonic()
        self._sups.setdefault(slot, Supervisor(
            max_restarts=self.cfg.max_restarts, backoff_base_s=0.2,
            backoff_max_s=5.0, seed=slot))

    def _kill_slot(self, slot: int, sig=_signal.SIGKILL):
        proc = self._procs.get(slot)
        if proc is not None and proc.poll() is None:
            try:
                proc.send_signal(sig)
            except (ProcessLookupError, OSError):
                pass

    def _set_workers_gauge(self):
        live = sum(1 for p in self._procs.values() if p.poll() is None)
        set_gauge("elastic/workers", live, label="ready")
        set_gauge("elastic/workers", len(self._done_slots), label="done")

    # -- control ------------------------------------------------------------
    def request_scale(self, world: int):
        """Thread-safe: ask the run loop to resize to ``world`` at the
        next boundary (regrow on rejoin, shrink on command)."""
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        self._target = int(world)

    def request_stop(self):
        self._stop = True

    def install_signal_handlers(self):
        """SIGTERM/SIGINT -> drain the fleet, commit the job record,
        exit EXIT_PREEMPTED (relaunch-the-same-command resumes)."""
        for sig in (_signal.SIGTERM, _signal.SIGINT):
            _signal.signal(sig, lambda *_a: self.request_stop())

    # -- run loop -----------------------------------------------------------
    def run(self) -> dict:
        """Drive the job to completion (or to a preemption stop).
        Returns the job summary; raises nothing for worker churn — that
        is the service's whole point."""
        if self.server is None:
            self.start()
        try:
            while True:
                stop, target = self._stop, self._target
                self._target = None
                if stop:
                    self._preempt_stop()
                    return self.summary(preempted=True)
                if target is not None and target != self.world:
                    self._resize(target, reason="scale request")
                    continue
                shrink = self._poll_workers()
                if shrink is not None:
                    self._resize(shrink, reason="worker lost")
                    continue
                if len(self._done_slots) == self.world:
                    self._finalize()
                    return self.summary()
                time.sleep(self.cfg.poll_s)
        finally:
            if self.server is not None:
                self.server.stop()

    def _poll_workers(self) -> Optional[int]:
        """Reap exits, kill stale members, relaunch bounded.  Returns a
        new (smaller) world size when a slot is permanently lost."""
        members = self.master.members()
        for slot in list(self._procs):
            proc = self._procs[slot]
            rc = proc.poll()
            if rc is None:
                # spawn grace: a fresh worker spends seconds importing
                # torch and reaching the card before it can register, and after a
                # relaunch the DEAD incarnation's membership entry is
                # still the one going stale — killing the live process
                # for its predecessor's silence would loop forever
                grace = max(2 * self.cfg.heartbeat_lease_s, 30.0)
                young = time.monotonic() - self._spawned_at.get(
                    slot, 0.0) < grace
                m = members.get(slot)
                if m is not None and m["stale"] and not young:
                    logger.warning(
                        "elastic: slot %d heartbeat stale (%.1fs); "
                        "killing for relaunch", slot, m["age_s"])
                    self._kill_slot(slot)
                    self.master.deregister_worker(slot)
                continue
            if slot in self._done_slots:
                continue
            if rc == 0:
                self._done_slots.add(slot)
                self._set_workers_gauge()
                continue
            # preemption exit or signal death: bounded relaunch; any
            # other exit status is a worker bug — also relaunched (the
            # supervisor convention treats only exit 0 as done here,
            # since a poisoned shard already drops via the failure
            # budget), still bounded by the same gate
            sup = self._sups[slot]
            if sup.relaunch_gate(f"elastic worker slot {slot}",
                                 f"exit status {rc}"):
                logger.warning("elastic: relaunching slot %d (exit %s)",
                               slot, rc)
                self._spawn(slot)
            else:
                logger.warning(
                    "elastic: slot %d lost permanently (exit %s, "
                    "restarts exhausted) — shrinking", slot, rc)
                self._procs.pop(slot, None)
                self.master.deregister_worker(slot)
                return max(1, self.world - 1)
        return None

    # -- resize --------------------------------------------------------------
    def _drain_all(self):
        """Command every live worker to drain at its next task boundary
        and wait (bounded) for the fleet to exit; stragglers get a real
        SIGTERM (the emergency-checkpoint path), then SIGKILL."""
        deadline = time.time() + self.cfg.drain_timeout_s
        while time.time() < deadline:
            # re-issue each poll: slots that (re-)register inside the
            # drain window must see the command too
            self.master.set_command("drain")
            if all(p.poll() is not None for p in self._procs.values()):
                return
            time.sleep(self.cfg.poll_s)
        for slot, proc in self._procs.items():
            if proc.poll() is None:
                logger.warning(
                    "elastic: slot %d ignored drain for %.0fs; SIGTERM",
                    slot, self.cfg.drain_timeout_s)
                self._kill_slot(slot, _signal.SIGTERM)
        deadline = time.time() + 30.0
        while time.time() < deadline and any(
                p.poll() is None for p in self._procs.values()):
            time.sleep(self.cfg.poll_s)
        for slot, proc in self._procs.items():
            if proc.poll() is None:
                self._kill_slot(slot, _signal.SIGKILL)
                proc.wait()

    def _resize(self, new_world: int, reason: str):
        """The tentpole: drain -> merge -> re-plan -> re-shard -> seed ->
        relaunch, committed as one durable boundary."""
        done_now = self.master.stats()["done"]
        if done_now <= self._done_at_last_resize:
            self._stalled_resizes += 1
            if self._stalled_resizes > self.cfg.max_stalled_resizes:
                # give up CLEANLY: no orphaned training processes, and
                # a durable 'failed' record so a rerun knows this was
                # not a mere preemption
                for slot in list(self._procs):
                    self._kill_slot(slot)
                for proc in self._procs.values():
                    if proc.poll() is None:
                        proc.wait()
                self._commit_record("failed",
                                    stalled_resizes=self._stalled_resizes)
                raise RuntimeError(
                    f"elastic: {self._stalled_resizes} consecutive "
                    f"resize boundaries with zero newly committed tasks "
                    f"(done={done_now}) — the fleet is dying before it "
                    f"can commit; giving up instead of churning")
        else:
            self._stalled_resizes = 0
        self._done_at_last_resize = done_now
        t0 = time.perf_counter()
        span = start_span("elastic/resize", parent=None,
                          from_world=self.world, to_world=new_world,
                          reason=reason)
        old_epoch = self.resize_epoch
        self._drain_all()
        span.event("drained", world=self.world)
        old_gen = self._gen_dir(old_epoch)
        slot_dirs = sorted(
            os.path.join(old_gen, d) for d in os.listdir(old_gen)
            if d.startswith("slot-"))
        self.resize_epoch += 1
        self.world = int(new_world)
        base = self._base_dir()
        try:
            merged = merge_checkpoints(slot_dirs, base, world=self.world,
                                       resize_epoch=self.resize_epoch)
        except FileNotFoundError:
            # membership changed before ANY slot committed a checkpoint
            # (e.g. the whole fleet hard-died inside its first task):
            # nothing was trained durably, so the new generation starts
            # fresh — the master still holds every uncommitted task
            merged = None
        span.event("merged", replicas=len(merged["merged_from"])
                   if merged else 0)
        plan_payload = self._replan()
        span.event("planned",
                   candidate=(plan_payload or {}).get("candidate"))
        self.master.resize(self.world)
        # seed every new slot from the merged base: restore-under-the-
        # new-plan is spec-agnostic — the same files serve any world
        # (no base = fresh start; resume=True on an empty dir is the
        # documented start-fresh path)
        for slot in range(self.world):
            d = self._slot_dir(slot)
            if os.path.isdir(d):
                shutil.rmtree(d)
            if merged is not None:
                shutil.copytree(base, d)
        rec = self._commit_record(
            "resize", reason=reason, merged=merged, plan=plan_payload,
            from_world=(len(slot_dirs)), base=base)
        self.resizes.append(rec)
        self._procs.clear()
        self._sups.clear()
        self._done_slots.clear()
        for slot in range(self.world):
            self._spawn(slot)
        inc_counter("elastic/resizes")
        dur_ms = (time.perf_counter() - t0) * 1e3
        observe_hist("elastic/resize_ms", dur_ms)
        self._set_workers_gauge()
        span.end(dur_ms_total=round(dur_ms, 3))
        logger.warning(
            "elastic: resize committed (%s): world %d -> %d in %.0fms",
            reason, len(slot_dirs), self.world, dur_ms)

    def _finalize(self):
        base = os.path.join(self.cfg.root, "final")
        slot_dirs = [self._slot_dir(s) for s in range(self.world)]
        merged = merge_checkpoints(
            [d for d in slot_dirs if os.path.isdir(d)], base,
            world=self.world, resize_epoch=self.resize_epoch)
        self.completed = True
        self._commit_record("complete", merged=merged, final=base)

    def _preempt_stop(self):
        """Coordinator preemption: drain, commit, leave a resumable
        record.  The caller exits EXIT_PREEMPTED; rerunning the same
        command resumes idempotently."""
        self._drain_all()
        self._commit_record("preempted")
        logger.warning(
            "elastic: coordinator preempted; job state committed in %r "
            "(exit %d resumes)", self._job_path, EXIT_PREEMPTED)

    def summary(self, preempted: bool = False) -> dict:
        stats = self.master.stats() if self.master is not None else {}
        return {"completed": self.completed, "preempted": preempted,
                "world": self.world, "resize_epoch": self.resize_epoch,
                "resizes": len(self.resizes), "task_stats": stats,
                "final": os.path.join(self.cfg.root, "final")
                if self.completed else None}


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def prebuild_kernels(program, batch_size: int) -> bool:
    """Build the 1x1-convolution kernel library in this process before
    any worker starts, where ``program`` routes a conv to it at
    ``batch_size``: K workers that start on an empty ``build/`` would
    each run nvcc.  Runs nvcc only (no CUDA context); True when it
    built."""
    from ..ops import conv1x1
    gb = program.global_block()
    for op in gb.ops:
        if op.type != "conv2d" or op.attrs.get("use_pallas") is False:
            continue
        x = gb.var(op.input("Input")[0])
        w = gb.var(op.input("Filter")[0])
        if conv1x1.conv1x1_eligible(
                (batch_size,) + tuple(x.shape[1:]), w.shape,
                tuple(op.attrs["strides"]), tuple(op.attrs["paddings"]),
                tuple(op.attrs["dilations"]), op.attrs["groups"]):
            conv1x1.build()
            return True
    return False


def _worker_argv_for_config(config_path: str, batch_size: int,
                            config_args: Optional[str] = None,
                            events_dir: Optional[str] = None,
                            heartbeat_interval_s: float = 0.5,
                            device: str = "cuda"):
    """worker_cmd builder for v1-config jobs: workers rebuild the model
    from the same config file, on ``device``."""
    def cmd(spec: WorkerSpec) -> List[str]:
        argv = [sys.executable, "-m", "paddle_tpu_torch", "elastic",
                "--worker",
                "--config", config_path, "--coordinator", spec.address,
                "--slot", str(spec.slot), "--world", str(spec.world),
                "--resize-epoch", str(spec.resize_epoch),
                "--ckpt-dir", spec.ckpt_dir,
                "--heartbeat-interval", str(heartbeat_interval_s),
                "--batch-size", str(batch_size), "--device", device]
        if config_args:
            argv += ["--config_args", config_args]
        if events_dir:
            argv += ["--events",
                     os.path.join(events_dir, f"slot-{spec.slot}.jsonl")]
        return argv
    return cmd


def worker_place(device: str):
    """The executor place of a worker on ``device`` (``cuda`` or
    ``cpu``).  On ``cuda`` the card must be there (no quiet fall back to
    the CPU), and the worker's steps use cuDNN's deterministic
    algorithms with TF32 off: a relaunched worker replays its stream's
    batches and must compute what the first incarnation computed, bit
    for bit, which the default (autotuned, possibly non-deterministic)
    convolution algorithms do not promise."""
    from ..core.executor import CPUPlace, CUDAPlace
    if device == "cpu":
        return CPUPlace()
    if device != "cuda":
        raise ValueError(f"elastic worker: device must be 'cuda' or "
                         f"'cpu', got {device!r}")
    import torch
    place = CUDAPlace(0)
    place.device()                 # raises without a card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return place


def worker_main(args) -> int:
    """``python -m paddle_tpu_torch elastic --worker``: one elastic
    trainer, in fp32, on ``args.device`` (:func:`worker_place` says what
    a worker on the card guarantees)."""
    from ..cli import _parse_config_args
    from ..core.program import program_guard
    from ..trainer import SGD, events
    from ..trainer_config_helpers import load_v1_config

    place = worker_place(getattr(args, "device", "cuda"))
    cfg = load_v1_config(args.config, **_parse_config_args(args.config_args))
    worker = ElasticWorker(args.coordinator, slot=args.slot,
                           batch_size=args.batch_size, world=args.world,
                           resize_epoch=args.resize_epoch,
                           heartbeat_interval_s=args.heartbeat_interval)
    out = open(args.events, "a", buffering=1) if args.events else None

    def handler(e):
        if out is not None and isinstance(e, events.EndIteration):
            # key by the slot's global stream index (worker.emitted is
            # pre-increment while the handler runs): replayed batches
            # after a hard kill land on the same key as the first run's,
            # so the chaos merge can assert bit-identity
            out.write(json.dumps(
                {"slot": args.slot, "e": worker.emitted + 1,
                 "epoch": args.resize_epoch,
                 "c": float(e.cost).hex()}) + "\n")

    with program_guard(cfg.main_program, cfg.startup_program):
        opt = cfg.make_optimizer()
        tr = SGD(cost=cfg.outputs[0], update_equation=opt, place=place)
        tr.train(worker.reader, num_passes=1, event_handler=handler,
                 elastic=worker, checkpoint_dir=args.ckpt_dir,
                 resume=True)
    if out is not None:
        out.close()
    return EXIT_PREEMPTED if worker.drained else 0


def elastic_main(argv=None) -> int:
    """``python -m paddle_tpu_torch elastic``: run an elastic training
    job (coordinator), or one worker with ``--worker`` (spawned by the
    coordinator, not normally typed by hand)."""
    import argparse
    import glob as _glob

    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch elastic",
        description="elastic multi-worker training service "
                    "(paddle_tpu_torch.distributed.elastic): K supervised "
                    "worker processes train data-parallel over the "
                    "master's slot-sharded exactly-once streams; workers "
                    "die and rejoin with bit-identical resume, and on "
                    "membership change the job RESIZES: drain to a "
                    "checkpoint boundary, merge replicas, re-plan with "
                    "the auto-sharding planner for the new world size, "
                    "re-shard the remaining work, relaunch.  A "
                    "coordinator SIGTERM drains and commits a resumable "
                    "record (exit 75); rerun the same command to "
                    "resume.")
    ap.add_argument("--config", required=True, help="v1 config file")
    ap.add_argument("--config_args", default=None)
    ap.add_argument("--data", default=None,
                    help="glob of chunk part files "
                         "(dataset.common.split output); coordinator "
                         "mode only")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--root", default=None,
                    help="job root directory (checkpoints + records)")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--chunks-per-task", type=int, default=1)
    ap.add_argument("--task-timeout", type=float, default=60.0)
    ap.add_argument("--lease", type=float, default=5.0,
                    help="heartbeat staleness lease seconds")
    ap.add_argument("--drain-timeout", type=float, default=120.0)
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--events-dir", default=None,
                    help="write per-worker EndIteration JSONL here")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the workers train (the coordinator "
                         "passes it on to every worker; it never "
                         "touches the card itself)")
    # worker mode (spawned by the coordinator)
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--slot", type=int, default=0)
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--resize-epoch", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--events", default=None)
    ap.add_argument("--heartbeat-interval", type=float, default=0.5)
    args = ap.parse_args(argv)

    if args.worker:
        if not (args.coordinator and args.ckpt_dir):
            ap.error("--worker needs --coordinator and --ckpt-dir")
        return worker_main(args)

    if not (args.data and args.root):
        ap.error("coordinator mode needs --data and --root")
    chunks = sorted(_glob.glob(args.data))
    if not chunks:
        raise SystemExit(f"elastic: no files match {args.data!r}")
    from ..cli import _parse_config_args
    from ..trainer_config_helpers import load_v1_config
    cfg = load_v1_config(args.config,
                         **_parse_config_args(args.config_args))
    if args.device == "cuda":
        prebuild_kernels(cfg.main_program, args.batch_size)
    job = ElasticJob(ElasticConfig(
        workers=args.workers, data=chunks, root=args.root,
        worker_cmd=_worker_argv_for_config(
            args.config, args.batch_size, config_args=args.config_args,
            events_dir=args.events_dir, device=args.device),
        program=cfg.main_program, chunks_per_task=args.chunks_per_task,
        task_timeout_s=args.task_timeout,
        heartbeat_lease_s=args.lease,
        drain_timeout_s=args.drain_timeout,
        max_restarts=args.max_restarts, assume_batch=args.batch_size))
    job.install_signal_handlers()
    summary = job.run()
    print(json.dumps(summary, default=repr), flush=True)
    return 0 if summary["completed"] else (
        EXIT_PREEMPTED if summary["preempted"] else 1)
