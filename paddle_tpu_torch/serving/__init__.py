"""Serving runtime (counterpart of ``paddle_tpu/serving``): a
:class:`Model` (a live program, or an exported artifact) behind the
dynamic-batching :class:`Server`, and continuous-batching decode pools
(``serving.decode``: ``DecodeEngine``, ``DecodeRuntime``) mounted with
``Server.add_decode_model``.

``serving.cli`` (``python -m paddle_tpu_torch serve``), ``serving.http``
(``HttpFront``) and ``serving.fleet`` (``FleetRouter``) are imported
lazily by their callers: importing this package loads none of them."""
from ..faults import (DeadlineExceeded, ModelUnavailable, Overloaded,
                      ServerClosed)
from .model import Model
from .server import ModelError, PendingResponse, Server

__all__ = [
    "Model", "Server", "PendingResponse", "ModelError",
    "Overloaded", "DeadlineExceeded", "ServerClosed", "ModelUnavailable",
]
