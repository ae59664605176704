"""Serving runtime (counterpart of ``paddle_tpu/serving``): a
:class:`Model` (a live program, or an exported artifact) behind the
dynamic-batching :class:`Server`."""
from ..faults import (DeadlineExceeded, ModelUnavailable, Overloaded,
                      ServerClosed)
from .model import Model
from .server import ModelError, PendingResponse, Server

__all__ = [
    "Model", "Server", "PendingResponse", "ModelError",
    "Overloaded", "DeadlineExceeded", "ServerClosed", "ModelUnavailable",
]
