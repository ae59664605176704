"""Typed serving rejections (counterpart of the serving taxonomy in
``paddle_tpu/faults.py``).  They live outside the serving package so a
client can catch them without importing the server."""
from __future__ import annotations


class TransientError(RuntimeError):
    """Base class for errors that are safe to retry."""


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
