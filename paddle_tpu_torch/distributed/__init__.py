"""Distributed services of the training runtime (counterpart of
``paddle_tpu/distributed``): ``launch`` (the process bootstrap: a
``torch.distributed`` world through a coordinator's ``TCPStore``),
``checkpoint`` (commits with integrity metadata, an async writer, delta
chains, and each rank's pieces of a sharded var), ``supervisor`` (the
bounded relaunch of preempted runs), ``master`` (dataset task queues
with timeouts and a failure budget, served over TCP), ``elastic`` (the
elastic training service: die/rejoin workers over the master's
exactly-once streams, with checkpointed resize) and ``transpiler`` (the
DistributeTranspiler shim).

``Master``, ``Task`` and ``TaskQueueClient`` are exported as the JAX
package exports them, but resolved on first use: importing this
package loads neither ``master`` nor ``elastic``.
"""
from .checkpoint import (CheckpointManager, CheckpointTimeoutError,
                         DeltaChainError, save_checkpoint, load_checkpoint)
from .launch import (CoordinatorTimeoutError, init_distributed,
                     is_initialized, process_count, process_index)
from .supervisor import Supervisor, SupervisorGaveUp
from .transpiler import DistributeTranspiler

__all__ = [
    "init_distributed", "is_initialized", "process_index", "process_count",
    "CoordinatorTimeoutError", "DistributeTranspiler", "CheckpointManager", "CheckpointTimeoutError", "DeltaChainError",
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
