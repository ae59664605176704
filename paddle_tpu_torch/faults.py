"""Fault taxonomy, retry policy and the preemption protocol (counterpart
of ``paddle_tpu/faults.py``).

* :func:`classify` splits exceptions into ``retryable`` (transient
  errors, the wire's errors) and ``fatal`` (everything else: shape and
  type errors, out of memory, NaN trips; retrying deterministic math
  reproduces the failure);
* :class:`RetryPolicy` and :func:`retry_call`: bounded retries with
  exponential backoff and seeded jitter, used at the executor's dispatch
  rim and by the process supervisor (``distributed/supervisor.py``);
* :data:`EXIT_PREEMPTED` and :class:`Preempted` (a ``SystemExit``
  carrying it): the exit of a training process that finished its
  in-flight dispatch after SIGTERM/SIGINT and committed an emergency
  checkpoint, which the supervisor relaunches instead of giving up;
* the serving runtime's typed rejections, which live here so a client
  can catch them without importing the server.
"""
from __future__ import annotations

import errno as _errno
import random
import socket as _socket
import time
from typing import Callable, Optional, Sequence

__all__ = [
    "TransientError", "TransientDispatchError", "InjectedFault",
    "RetriesExhausted", "Preempted", "EXIT_PREEMPTED",
    "classify", "RetryPolicy", "retry_call",
    "Overloaded", "DeadlineExceeded", "ServerClosed", "ModelUnavailable",
]

# Exit status of a training process that was preempted (SIGTERM/SIGINT),
# finished its in-flight step and committed an emergency checkpoint:
# EX_TEMPFAIL of sysexits.h, "temporary failure, retry later".  Apart
# from 0 (done), 1 (fatal) and 128+signum (killed before the handler
# could checkpoint).
EXIT_PREEMPTED = 75


class TransientError(RuntimeError):
    """Base class for errors that are safe to retry: the operation is
    expected to succeed on a later attempt without any state repair."""


class TransientDispatchError(TransientError):
    """A step's dispatch failed transiently (a runtime hiccup, or an
    injected fault) before producing results."""


class InjectedFault(RuntimeError):
    """A deterministic fault fired by :mod:`paddle_tpu_torch.testing
    .faultinject` (action ``error``).  Not transient: a spec that wants
    a retryable failure uses action ``transient``."""


class RetriesExhausted(RuntimeError):
    """A retryable operation kept failing past
    ``RetryPolicy.max_attempts``; ``last`` is the final exception."""

    def __init__(self, what: str, attempts: int, last: BaseException):
        super().__init__(
            f"{what}: still failing after {attempts} attempt(s): "
            f"{type(last).__name__}: {last}")
        self.attempts = attempts
        self.last = last


class Preempted(SystemExit):
    """Raised by the trainer after a SIGTERM/SIGINT emergency checkpoint;
    unhandled, the process exits :data:`EXIT_PREEMPTED`, so a supervisor
    relaunches it with ``resume=True``."""

    def __init__(self, step: int, checkpoint_dir: Optional[str] = None):
        super().__init__(EXIT_PREEMPTED)
        self.step = step
        self.checkpoint_dir = checkpoint_dir

    def __str__(self):
        return (f"training preempted at step {self.step}; emergency "
                f"checkpoint in {self.checkpoint_dir!r} (exit "
                f"{EXIT_PREEMPTED})")


# ---------------------------------------------------------------------------
# Serving rejections
# ---------------------------------------------------------------------------
class Overloaded(TransientError):
    """Admission control rejected the request: the bounded queue was full
    and load shedding chose it (oldest-deadline-first).  Backing off and
    retrying is the contract."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline expired before results could be produced;
    expired requests are rejected before dispatch, never computed."""


class ServerClosed(RuntimeError):
    """The server is draining or stopped: admission is closed.  Admitted
    requests still complete."""


class ModelUnavailable(RuntimeError):
    """The per-model circuit breaker is open after repeated fatal
    dispatch errors: requests to this model fail fast."""


# ---------------------------------------------------------------------------
# Classification
# ---------------------------------------------------------------------------
# OSError errnos that describe the wire, not the host: a retry is
# expected to succeed once the peer or the network recovers
_TRANSIENT_ERRNOS = frozenset(
    getattr(_errno, n) for n in (
        "ECONNREFUSED", "ECONNRESET", "ECONNABORTED", "EPIPE", "ETIMEDOUT",
        "EHOSTUNREACH", "EHOSTDOWN", "ENETUNREACH", "ENETDOWN", "ENETRESET",
        "EAGAIN", "EINTR") if hasattr(_errno, n))


def classify(exc: BaseException) -> str:
    """``"retryable"`` or ``"fatal"`` for one exception.

    Retryable: :class:`TransientError`, the connection and timeout
    families, and an ``OSError`` with a wire errno (or none).  Fatal:
    everything else; when in doubt, failing loudly beats retrying a
    poisoned step.  (The JAX package also reads XLA runtime statuses;
    the port has none.)"""
    if isinstance(exc, TransientError):
        return "retryable"
    if isinstance(exc, (FloatingPointError, MemoryError)):
        return "fatal"
    if isinstance(exc, (ConnectionError, TimeoutError, BrokenPipeError)):
        return "retryable"
    if isinstance(exc, _socket.gaierror):
        return "retryable"
    # a plain OSError is retryable only for the network flavours: a full
    # disk or an I/O error must fail loudly, not spin a supervisor
    if isinstance(exc, OSError) and not isinstance(
            exc, (PermissionError, FileNotFoundError, IsADirectoryError)):
        if exc.errno is None or exc.errno in _TRANSIENT_ERRNOS:
            return "retryable"
        return "fatal"
    return "fatal"


# ---------------------------------------------------------------------------
# Retry policy
# ---------------------------------------------------------------------------
class RetryPolicy:
    """Bounded retry with exponential backoff and deterministic jitter.

    ``delay(i)`` for failure ``i`` (0-based) is
    ``min(backoff_max_s, backoff_base_s * 2**i) * (1 + U(-jitter,
    jitter))``, ``U`` drawn from a :class:`random.Random` seeded at
    construction: two policies built alike give the same schedule."""

    def __init__(self, max_attempts: int = 3, backoff_base_s: float = 0.1,
                 backoff_max_s: float = 30.0, jitter: float = 0.1,
                 seed: int = 0):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        self.max_attempts = int(max_attempts)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.jitter = float(jitter)
        self.seed = int(seed)
        self._rng = random.Random(seed)

    def delay(self, failure_index: int) -> float:
        base = min(self.backoff_max_s,
                   self.backoff_base_s * (2.0 ** failure_index))
        if not self.jitter:
            return base
        return base * (1.0 + self._rng.uniform(-self.jitter, self.jitter))

    def __repr__(self):
        return (f"RetryPolicy(max_attempts={self.max_attempts}, "
                f"backoff_base_s={self.backoff_base_s}, "
                f"backoff_max_s={self.backoff_max_s}, "
                f"jitter={self.jitter}, seed={self.seed})")


def retry_call(fn: Callable, policy: RetryPolicy, what: str = "operation",
               classify_fn: Callable[[BaseException], str] = classify,
               on_retry: Optional[Callable] = None,
               sleep: Callable[[float], None] = time.sleep,
               retryable_extra: Sequence[type] = ()):
    """Call ``fn()`` under ``policy``: a fatal error re-raises at once; a
    retryable one backs off and retries, up to ``policy.max_attempts``
    attempts in all, then :class:`RetriesExhausted`.
    ``on_retry(failure_index, exc, delay_s)`` runs before each backoff
    sleep; ``sleep`` is injectable for tests."""
    last: Optional[BaseException] = None
    for i in range(policy.max_attempts):
        try:
            return fn()
        except BaseException as e:  # noqa: BLE001 — classified, re-raised
            if not (classify_fn(e) == "retryable"
                    or isinstance(e, tuple(retryable_extra))):
                raise
            last = e
            if i + 1 >= policy.max_attempts:
                break
            d = policy.delay(i)
            if on_retry is not None:
                on_retry(i, e, d)
            if d > 0:
                sleep(d)
    raise RetriesExhausted(what, policy.max_attempts, last) from last
