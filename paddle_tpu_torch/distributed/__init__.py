"""Distributed services of the training runtime (counterpart of
``paddle_tpu/distributed``): ``checkpoint`` (commits with integrity
metadata, an async writer and delta chains), ``supervisor`` (the
bounded relaunch of preempted runs), ``master`` (dataset task queues
with timeouts and a failure budget, served over TCP) and ``elastic``
(the elastic training service: die/rejoin workers over the master's
exactly-once streams, with checkpointed resize).  The launcher and the
transpiler come with ROADMAP Queue A item 7.

``Master``, ``Task`` and ``TaskQueueClient`` are exported as the JAX
package exports them, but resolved on first use: importing this
package loads neither ``master`` nor ``elastic``.
"""
from .checkpoint import (CheckpointManager, CheckpointTimeoutError,
                         DeltaChainError, save_checkpoint, load_checkpoint)
from .supervisor import Supervisor, SupervisorGaveUp

__all__ = [
    "CheckpointManager", "CheckpointTimeoutError", "DeltaChainError",
    "save_checkpoint", "load_checkpoint", "Master", "Task",
    "TaskQueueClient", "Supervisor", "SupervisorGaveUp",
]

_LAZY = {"Master": "master", "Task": "master", "TaskQueueClient": "master"}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f".{mod}", __name__), name)
