"""Process supervisor: the bounded relaunch of preempted or transiently
failed training runs (counterpart of
``paddle_tpu/distributed/supervisor.py``).

A preempted trainer (``trainer.SGD.train(checkpoint_dir=...)`` after
SIGTERM) finishes its dispatch, commits an emergency checkpoint and
exits :data:`~paddle_tpu_torch.faults.EXIT_PREEMPTED`; the supervisor
starts it again:

* :meth:`Supervisor.run` supervises a callable: a retryable exception
  (``faults.classify``) or :class:`~paddle_tpu_torch.faults.Preempted`
  restarts it with exponential backoff and seeded jitter, up to
  ``max_restarts`` times; a fatal one propagates.
* :meth:`Supervisor.run_command` supervises a subprocess: exit 0 is
  done; ``EXIT_PREEMPTED`` and a death by signal (negative returncode:
  a SIGKILL that no handler saw) relaunch; any other status gives up.
  The command is the same each time, so the script must resume
  idempotently, which ``train(resume=True)`` does.

``python -m paddle_tpu_torch.distributed.supervisor [--max-restarts N]
-- <cmd> [args]`` runs a command so; SIGTERM or SIGINT to the
supervisor is forwarded to the child, which is then not relaunched.
"""
from __future__ import annotations

import logging
import os
import signal as _signal
import subprocess
import sys
import time
from typing import Callable, Optional, Sequence

from ..faults import EXIT_PREEMPTED, Preempted, RetryPolicy
from ..observability import emit_event, inc_counter
from ..testing import lockwatch as _lw

logger = logging.getLogger("paddle_tpu_torch")

__all__ = ["Supervisor", "SupervisorGaveUp"]


class SupervisorGaveUp(RuntimeError):
    """The supervised run kept dying retryably past ``max_restarts``, or
    exited with a status that is not retryable."""

    def __init__(self, what: str, restarts: int, last):
        super().__init__(
            f"{what}: gave up after {restarts} restart(s); last outcome: "
            f"{last}")
        self.restarts = restarts
        self.last = last


class Supervisor:
    """A bounded-restart loop with exponential backoff and deterministic
    jitter.  ``max_restarts`` counts relaunches; ``sleep`` is injectable
    so tests read the backoff schedule instead of waiting it out.
    ``restarts`` and ``outcomes`` (each attempt's exit status or
    exception) describe the last run."""

    def __init__(self, max_restarts: int = 3, backoff_base_s: float = 0.5,
                 backoff_max_s: float = 30.0, jitter: float = 0.1,
                 seed: int = 0, sleep: Callable[[float], None] = time.sleep):
        if max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got {max_restarts}")
        self.max_restarts = int(max_restarts)
        self._policy = RetryPolicy(
            max_attempts=self.max_restarts + 1, backoff_base_s=backoff_base_s,
            backoff_max_s=backoff_max_s, jitter=jitter, seed=seed)
        self._sleep = sleep
        self.restarts = 0
        self.outcomes: list = []
        # the live child of run_command(), for terminate(); an RLock, as
        # terminate() may run in a signal handler on the thread that
        # holds it inside run_command
        self._child: Optional[subprocess.Popen] = None
        self._child_lock = _lw.make_rlock("supervisor.child")
        self._terminated = False   # a deliberate stop: no relaunch

    def _note_restart(self, what: str, outcome: str, delay_s: float):
        """Restart accounting shared by run() and run_command()."""
        self.restarts += 1
        inc_counter("fault/restarts")
        emit_event("fault", event="restart", site=what,
                   attempt=self.restarts, delay_s=round(delay_s, 4),
                   error=outcome)

    def _backoff(self, what: str, outcome: str):
        d = self._policy.delay(self.restarts)
        self._note_restart(what, outcome, d)
        logger.warning("supervisor: %s ended with %s; relaunch %d in "
                       "%.3f s", what, outcome, self.restarts, d)
        if d > 0:
            self._sleep(d)

    # -- in-process ----------------------------------------------------------
    def run(self, fn: Callable, what: str = "supervised run"):
        """Call ``fn()``; relaunch on :class:`Preempted` or a retryable
        exception, up to ``max_restarts`` times; a fatal error
        propagates; gives up with :class:`SupervisorGaveUp`."""
        from ..faults import RetriesExhausted, retry_call

        self.restarts = 0
        self.outcomes = []

        def on_retry(i, e, d):
            self.outcomes.append(f"{type(e).__name__}: {e}")
            self._note_restart(what, self.outcomes[-1], d)

        try:
            return retry_call(fn, self._policy, what=what,
                              retryable_extra=(Preempted,),
                              on_retry=on_retry, sleep=self._sleep)
        except RetriesExhausted as e:
            raise SupervisorGaveUp(what, self.restarts, e.last) from e

    # -- subprocess ----------------------------------------------------------
    def terminate(self, sig: int = _signal.SIGTERM,
                  kill_timeout_s: float = 10.0, *,
                  _in_signal_handler: bool = False) -> None:
        """Forward ``sig`` to the live :meth:`run_command` child, wait up
        to ``kill_timeout_s`` for it to exit, then SIGKILL it.  The
        child's death is then a deliberate stop: :meth:`run_command`
        returns its status without relaunching."""
        with self._child_lock:
            self._terminated = True
            child = self._child
        if child is None or child.poll() is not None:
            return
        try:
            child.send_signal(sig)
        except (ProcessLookupError, OSError):
            return
        if self._reap_bounded(child, kill_timeout_s, _in_signal_handler):
            return
        logger.warning(
            "supervisor: child %d ignored signal %d for %.1fs; "
            "escalating to SIGKILL", child.pid, sig, kill_timeout_s)
        try:
            child.kill()
        except (ProcessLookupError, OSError):
            pass

    @staticmethod
    def _reap_bounded(child: subprocess.Popen, timeout_s: float,
                      in_signal_handler: bool) -> bool:
        """True if ``child`` exited within ``timeout_s``.  In a signal
        handler the interrupted frame may be suspended inside
        ``child.wait()``, holding its lock, so ``poll()`` never sees the
        exit: ``waitpid(WNOHANG)`` instead."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if child.poll() is not None:
                return True
            if in_signal_handler:
                try:
                    pid, sts = os.waitpid(child.pid, os.WNOHANG)
                except (ChildProcessError, OSError):
                    return True
                if pid == child.pid:
                    child.returncode = os.waitstatus_to_exitcode(sts)
                    return True
            time.sleep(0.02)
        return child.poll() is not None

    def install_signal_handlers(self,
                                signals=(_signal.SIGTERM, _signal.SIGINT),
                                kill_timeout_s: float = 10.0):
        """Route SIGTERM/SIGINT to :meth:`terminate` (main thread only).
        Returns the previous handlers."""
        prev = {}
        for sig in signals:
            prev[sig] = _signal.signal(
                sig, lambda *_a, _s=sig: self.terminate(
                    _s, kill_timeout_s=kill_timeout_s,
                    _in_signal_handler=True))
        return prev

    def run_command(self, argv: Sequence[str], what: Optional[str] = None,
                    retryable_codes: Sequence[int] = (EXIT_PREEMPTED,),
                    check: bool = True, **popen_kw) -> int:
        """Run ``argv`` to completion, relaunching while it exits with a
        retryable status (``retryable_codes`` or a death by signal).
        Exit 0 returns 0; another status raises
        :class:`SupervisorGaveUp` under ``check``, else returns it.  A
        death after :meth:`terminate` returns its status as it is."""
        what = what or f"command {argv[0]!r}"
        self.restarts = 0
        self.outcomes = []
        timeout = popen_kw.pop("timeout", None)
        with self._child_lock:
            self._terminated = False
        while True:
            proc = subprocess.Popen(list(argv), **popen_kw)
            with self._child_lock:
                if self._terminated:
                    # terminate() raced the launch
                    self._child = None
                    proc.terminate()
                else:
                    self._child = proc
            try:
                rc = proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                with self._child_lock:
                    self._child = None
                proc.kill()
                proc.wait()
                raise
            self.outcomes.append(rc)
            with self._child_lock:
                self._child = None
                terminated = self._terminated
            if terminated:
                return rc
            if rc == 0:
                return 0
            retryable = rc in tuple(retryable_codes) or rc < 0
            if not retryable or self.restarts >= self.max_restarts:
                if check:
                    raise SupervisorGaveUp(what, self.restarts,
                                           f"exit status {rc}")
                return rc
            self._backoff(what, f"exit status {rc}")


def main(argv=None):
    """``python -m paddle_tpu_torch.distributed.supervisor
    [--max-restarts N] -- cmd args...``"""
    import argparse
    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.supervisor",
        description="relaunch a training command on preemption "
                    f"(exit {EXIT_PREEMPTED}) or signal death, with "
                    "bounded exponential backoff")
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--backoff-base-s", type=float, default=0.5)
    ap.add_argument("--backoff-max-s", type=float, default=30.0)
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="command to supervise (prefix with --)")
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    if not cmd:
        ap.error("no command given")
    sup = Supervisor(max_restarts=args.max_restarts,
                     backoff_base_s=args.backoff_base_s,
                     backoff_max_s=args.backoff_max_s)
    sup.install_signal_handlers()
    try:
        rc = sup.run_command(cmd)
    except SupervisorGaveUp as e:
        print(f"supervisor: {e}", file=sys.stderr)
        return 1
    print(f"supervisor: done after {sup.restarts} relaunch(es); exit "
          f"statuses {sup.outcomes}", file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
