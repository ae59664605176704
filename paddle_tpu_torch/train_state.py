"""Versioned training-loop state for checkpoint and bit-identical resume
(counterpart of ``paddle_tpu/train_state.py``).

The scope (parameters, optimizer moments, batch-norm statistics, the
schedules' ``@STEP_COUNTER@``) is not all a resume needs: the loop's
own counters decide which batch comes next, and the executor's step
counter places every random op's stream (``ExecContext.generator``:
the Philox offset on a card, the seed on the CPU), so it is the random
state.  :class:`TrainState` holds that remainder and rides inside the
checkpoint as a uint8 var (:data:`TRAIN_STATE_VAR`) that never stays in
the scope, so it shares the commit's atomic rename, md5s and fallback:
a checkpoint holds a consistent (vars, TrainState) pair or is skipped.

:class:`Checkpointer` is the trainer's side: periodic saves at dispatch
boundaries (the only points where the scope reflects exactly the
batches emitted), SIGTERM/SIGINT handling (finish the dispatch in
flight, commit an emergency checkpoint, exit
:data:`~paddle_tpu_torch.faults.EXIT_PREEMPTED`), and restore with
fallback on resume.  The sparse tables' rows ride in the same commit
as ``__sparse__/`` vars (a ``sparse`` session's full export, or its
deltas of the rows pushed since the last commit).  The master's task
queue and the elastic position that the JAX Checkpointer carries come
with ROADMAP Queue A item 8.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import signal
import threading
import time
from typing import Optional

import numpy as np

from .core.scope import Scope, to_numpy
from .observability import emit_event, inc_counter
from .distributed.checkpoint import (DEFAULT_CHUNK_BYTES,
                                     CheckpointManager, DeltaChainError)
from .faults import EXIT_PREEMPTED, Preempted  # noqa: F401  (re-export)

logger = logging.getLogger("paddle_tpu_torch")

__all__ = ["TRAIN_STATE_VERSION", "TRAIN_STATE_VAR", "TrainState",
           "Checkpointer", "DeltaPolicy"]

TRAIN_STATE_VERSION = 1
# the var the loop state rides in (never a program var, so it never
# enters a step)
TRAIN_STATE_VAR = "__train_state__"


@dataclasses.dataclass
class TrainState:
    """What the training loop needs beyond the scope to continue as if
    never interrupted (the JAX package's fields, so either package reads
    the other's).

    ``exe_step`` is ``Executor._step`` at the boundary: restoring it
    restores every random op's stream.  ``pass_id``/``batch_id`` name
    the next batch; ``emitted`` counts the batches completed across
    passes (the step the checkpoint is labelled with); ``iters_done``
    is the report cursor; ``optimizer`` a fingerprint of the
    optimizer's configuration checked on resume.  ``master`` and
    ``elastic`` stay None in the port."""

    version: int = TRAIN_STATE_VERSION
    exe_step: int = 0
    pass_id: int = 0
    batch_id: int = 0
    emitted: int = 0
    iters_done: int = 0
    random_seed: int = 0
    optimizer: dict = dataclasses.field(default_factory=dict)
    emergency: bool = False
    master: Optional[dict] = None
    elastic: Optional[dict] = None

    def to_array(self) -> np.ndarray:
        payload = json.dumps(dataclasses.asdict(self), sort_keys=True)
        return np.frombuffer(payload.encode("utf-8"), dtype=np.uint8)

    @classmethod
    def from_array(cls, arr) -> "TrainState":
        d = json.loads(bytes(np.asarray(to_numpy(arr), dtype=np.uint8))
                       .decode("utf-8"))
        version = int(d.get("version", 0))
        if version > TRAIN_STATE_VERSION:
            raise ValueError(
                f"checkpoint TrainState version {version} is newer than "
                f"this runtime supports ({TRAIN_STATE_VERSION})")
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass
class DeltaPolicy:
    """When the Checkpointer commits a delta (the changed chunks of each
    var since the previous commit, chained to it by content hash) and
    when a full rebase: after ``max_chain`` deltas, or once the chain's
    delta bytes reach ``rebase_fraction`` of the base's.  Deltas are
    single-process; ``enabled=False`` commits full checkpoints only.
    Dense training changes every chunk of its weights each step, so
    there a delta writes as much as a base (and the policy alternates
    full and delta commits)."""

    enabled: bool = True
    max_chain: int = 8
    rebase_fraction: float = 0.5
    chunk_bytes: int = DEFAULT_CHUNK_BYTES


class Checkpointer:
    """Checkpoints and preemption for one ``train(checkpoint_dir=...)``
    call.

    The trainer reports each completed batch through
    :meth:`on_batch_done`; the coordinator finds dispatch boundaries by
    comparing the executor's step counter with the batches emitted,
    saves every ``save_every_n_steps`` completed batches and, once a
    SIGTERM/SIGINT arrived (or :meth:`request_preempt`), commits a
    blocking emergency checkpoint and raises
    :class:`~paddle_tpu_torch.faults.Preempted`.

    ``sparse`` (a sparse session) puts its tables' state in every commit
    as vars that leave the scope after it.  Where it ``supports_delta``,
    its ``export_delta``/``export_full`` return ``(tokens, state)`` and
    snapshot the dirty rows with the export, ``commit_delta(tokens)``
    runs after the durable write and ``retract_delta(tokens)`` if it
    fails, so a row pushed while the writer works stays dirty for the
    next commit.  Otherwise (a remote table) every commit holds its
    ``export_state_vars()``: fresh copies, since the writer may
    serialize them after the save returns.

    ``saves`` lists each save's ``{"step", "emergency", "snapshot_ms",
    "bytes"}`` (the snapshot on the training thread; the writer's
    commits are in ``manager.commits``)."""

    def __init__(self, checkpoint_dir: str, exe,
                 save_every_n_steps: Optional[int] = None,
                 max_to_keep: int = 3, handle_signals: bool = True,
                 delta: Optional[DeltaPolicy] = None, sparse=None):
        if save_every_n_steps is not None and save_every_n_steps < 1:
            raise ValueError(f"save_every_n_steps must be >= 1, got "
                             f"{save_every_n_steps}")
        self.dir = checkpoint_dir
        self.exe = exe
        self.save_every = save_every_n_steps
        self.delta = DeltaPolicy() if delta is None else delta
        self.manager = CheckpointManager(
            checkpoint_dir, max_to_keep=max_to_keep,
            chunk_bytes=self.delta.chunk_bytes,
            device=getattr(exe, "device", None))
        self.handle_signals = handle_signals
        self._sparse = sparse
        self._delta_source = sparse if (
            sparse is not None
            and getattr(sparse, "supports_delta", False)) else None
        self._old_handlers: dict = {}
        self._preempt_sig: Optional[int] = None
        self._save_requested = False
        self._base_step: Optional[int] = None
        self.emitted = 0
        self.iters_done = 0
        self.last_saved = 0
        self.saves: list = []
        self._scope: Optional[Scope] = None

    # -- lifecycle -----------------------------------------------------------
    def restore(self, scope: Scope,
                expect_seed: Optional[int] = None,
                expect_optimizer: Optional[dict] = None
                ) -> Optional[TrainState]:
        """Restore the newest intact checkpoint into ``scope`` and return
        its :class:`TrainState`; None when the directory holds none (a
        resume on an empty directory starts fresh, so a supervised
        command can always pass ``resume=True``)."""
        if not self.manager.all_steps():
            return None
        step = self.manager.restore(scope=scope)
        if not scope.has(TRAIN_STATE_VAR):
            raise ValueError(
                f"checkpoint ckpt-{step} in {self.dir!r} carries no "
                f"TrainState: it was not written by "
                f"train(checkpoint_dir=...); restore it with "
                f"CheckpointManager.restore instead of resume=True")
        ts = TrainState.from_array(scope.get(TRAIN_STATE_VAR))
        scope.delete(TRAIN_STATE_VAR)
        if expect_seed is not None and ts.random_seed != expect_seed:
            logger.warning(
                "resume: checkpoint was written with program seed %s but "
                "this program uses %s; the random streams will not be "
                "bit-identical to the original run", ts.random_seed,
                expect_seed)
        if expect_optimizer is not None and ts.optimizer and \
                ts.optimizer != expect_optimizer:
            logger.warning(
                "resume: optimizer config changed across restarts "
                "(checkpoint %s vs current %s)", ts.optimizer,
                expect_optimizer)
        inc_counter("fault/checkpoint_restores")
        emit_event("fault", event="checkpoint_restore", step=ts.emitted,
                   index=step)
        return ts

    def begin(self, scope: Scope, state: Optional[TrainState],
              random_seed: int, optimizer_fp: dict):
        """Arm at the loop's entry: the boundary base, the resumed
        counters, the signal handlers."""
        self._scope = scope
        self._seed = int(random_seed)
        self._opt_fp = dict(optimizer_fp)
        self._restored = state
        if state is not None:
            self.emitted = state.emitted
            self.iters_done = state.iters_done
            self.last_saved = state.emitted
        # boundary invariant: exe._step - base == emitted exactly when
        # the scope reflects every emitted batch
        self._base_step = self.exe._step - self.emitted
        if self.handle_signals:
            self._install_signals()

    def close(self):
        """Flush pending saves and restore the signal handlers.  A write
        failure here is logged, not raised: raising would mask the
        exception in flight (a ``Preempted`` turned fatal would stop the
        supervisor from relaunching)."""
        try:
            self.manager.wait()
        except Exception as e:  # noqa: BLE001
            logger.error(
                "pending checkpoint write failed during shutdown "
                "(%s: %s); the latest checkpoint on disk is older than "
                "the counters suggest", type(e).__name__, e)
        finally:
            for sig, old in self._old_handlers.items():
                try:
                    signal.signal(sig, old)
                except (ValueError, OSError):
                    pass
            self._old_handlers.clear()

    def _install_signals(self):
        if threading.current_thread() is not threading.main_thread():
            logger.warning("checkpointer: not on the main thread; "
                           "SIGTERM/SIGINT preemption handling disabled")
            return
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._old_handlers[sig] = signal.signal(
                    sig, self._on_signal)
            except (ValueError, OSError):
                logger.warning("checkpointer: cannot install handler for "
                               "signal %s", sig)

    def _on_signal(self, signum, frame):
        # only set the flag: the loop finishes the dispatch in flight and
        # saves at the next boundary.  A repeat of the same signal
        # escalates to the previous handler; another signal while one is
        # pending is absorbed (Ctrl-C then the scheduler's SIGTERM must
        # not kill the process in the grace window)
        if self._preempt_sig == signum:
            old = self._old_handlers.get(signum)
            if callable(old):
                old(signum, frame)
            elif old == signal.SIG_DFL:
                signal.signal(signum, signal.SIG_DFL)
                os.kill(os.getpid(), signum)
            return
        if self._preempt_sig is None:
            self._preempt_sig = signum

    def resync(self):
        """Re-anchor the boundary base at a quiescent point (a pass's
        start): an event handler that runs executor work mid-pass
        advances the step counter past the loop's own dispatches, which
        hides boundaries until this point; the cadence then degrades to
        at least once a pass, never to zero."""
        self._base_step = self.exe._step - self.emitted

    def request_preempt(self, signum: int = signal.SIGTERM):
        """Preempt as if ``signum`` had arrived."""
        if self._preempt_sig is None:
            self._preempt_sig = signum

    @property
    def preempt_requested(self) -> bool:
        return self._preempt_sig is not None

    def request_save(self):
        """A blocking checkpoint at the next dispatch boundary, beside
        the periodic cadence."""
        self._save_requested = True

    @property
    def save_pending(self) -> bool:
        return self._save_requested

    # -- per batch -----------------------------------------------------------
    def on_batch_done(self, pass_id: int, batch_id: int,
                      step_now: Optional[int] = None):
        """Count one completed batch; at a dispatch boundary, honour a
        pending preemption (emergency save, then ``Preempted``), a
        requested save or the periodic cadence.  ``step_now``: the
        executor's step counter before this batch's event handler ran."""
        self.emitted += 1
        self.iters_done += 1
        if step_now is None:
            step_now = self.exe._step
        if step_now - self._base_step != self.emitted:
            return                       # mid-chunk: the scope is ahead
        if self._preempt_sig is not None:
            self._save(pass_id, batch_id + 1, emergency=True,
                       blocking=True)
            inc_counter("fault/preemptions")
            emit_event("fault", event="preemption", step=self.emitted,
                       action=f"signal {self._preempt_sig}")
            logger.warning(
                "preempted (signal %s): emergency checkpoint ckpt-%d "
                "committed in %r; exiting %d for the supervisor",
                self._preempt_sig, self.emitted, self.dir, EXIT_PREEMPTED)
            raise Preempted(self.emitted, self.dir)
        if self._save_requested:
            self._save(pass_id, batch_id + 1, blocking=True)
            self._save_requested = False
            return
        if self.save_every is not None and \
                self.emitted - self.last_saved >= self.save_every:
            self._save(pass_id, batch_id + 1)

    def final_save(self, num_passes: int):
        """Commit the end of training (pass_id == num_passes), so a
        relaunch resumes into an empty pass range and exits at once; a
        relaunch that restored a final state and ran no batch does not
        commit it again."""
        r = getattr(self, "_restored", None)
        if r is not None and r.pass_id >= num_passes \
                and self.emitted == r.emitted \
                and not self._save_requested:
            return
        self._save(num_passes, 0, blocking=True)
        self._save_requested = False

    # -- save ----------------------------------------------------------------
    def _save(self, next_pass: int, next_batch: int,
              emergency: bool = False, blocking: bool = False):
        ts = TrainState(
            exe_step=self.exe._step, pass_id=next_pass,
            batch_id=next_batch, emitted=self.emitted,
            iters_done=self.iters_done, random_seed=self._seed,
            optimizer=self._opt_fp, emergency=emergency)
        scope = self._scope
        scope.set(TRAIN_STATE_VAR, ts.to_array())
        # a delta while the chain is alive and under both rebase
        # thresholds, else a full rebase (emergency saves alike)
        kind = "full"
        if self.delta.enabled and self.manager.delta_supported():
            st = self.manager.chain_stats()
            if st["alive"] and st["len"] < self.delta.max_chain and \
                    (st["base_bytes"] <= 0
                     or st["bytes"] < self.delta.rebase_fraction
                     * st["base_bytes"]):
                kind = "delta"
        src = self._delta_source
        rider_keys: list = []

        def set_riders(state):
            for k, v in state.items():
                scope.set(k, v)
                if k not in rider_keys:
                    rider_keys.append(k)

        tokens = None
        t0 = time.perf_counter()
        if src is not None:
            # the dirty rows snapshot with the export, before the writer
            # sees them
            tokens, sv = (src.export_delta() if kind == "delta"
                          else src.export_full())
            set_riders(sv)
        elif self._sparse is not None:
            set_riders(self._sparse.export_state_vars())

        def attempt(k, tk):
            on_commit = on_fail = None
            if src is not None:
                on_commit = lambda info, t=tk: src.commit_delta(t)  # noqa: E731
                on_fail = lambda exc, t=tk: src.retract_delta(t)    # noqa: E731
            self.manager.save(self.emitted, scope, blocking=blocking,
                              kind=k, on_commit=on_commit, on_fail=on_fail)

        try:
            try:
                attempt(kind, tokens)
            except DeltaChainError:
                # the chain died between the check and the commit (a
                # failed async write, a changed sparse layout), or this
                # re-save replaces its parent: rebase
                kind = "full"
                if src is not None:
                    src.retract_delta(tokens)
                    tokens, sv = src.export_full()
                    set_riders(sv)
                attempt(kind, tokens)
        except BaseException:
            # nothing durable holds this snapshot: re-dirty it (the
            # token pops once, so the job's own on_fail is harmless)
            if src is not None and tokens is not None:
                src.retract_delta(tokens)
            raise
        finally:
            scope.delete(TRAIN_STATE_VAR)
            for k in rider_keys:
                scope.delete(k)
        snap = self.manager.last_snapshot or {}
        self.saves.append({"step": self.emitted, "emergency": emergency,
                           "kind": kind, "blocking": blocking,
                           "snapshot_ms": snap.get("ms"),
                           "bytes": snap.get("bytes"),
                           "call_ms": (time.perf_counter() - t0) * 1e3})
        self.last_saved = self.emitted
        inc_counter("fault/checkpoint_saves")
        emit_event("fault", event="checkpoint_save", step=self.emitted,
                   action="emergency" if emergency else "periodic")
