"""Distributed services of the training runtime (counterpart of
``paddle_tpu/distributed``): ``checkpoint`` (commits with integrity
metadata, an async writer and delta chains) and ``supervisor`` (the
bounded relaunch of preempted runs).  The launcher, the task-queue
master, the elastic service and the transpiler come with ROADMAP Queue A
items 7 and 8."""
from .checkpoint import (CheckpointManager, CheckpointTimeoutError,
                         DeltaChainError, save_checkpoint, load_checkpoint)
from .supervisor import Supervisor, SupervisorGaveUp

__all__ = [
    "CheckpointManager", "CheckpointTimeoutError", "DeltaChainError",
    "save_checkpoint", "load_checkpoint", "Supervisor", "SupervisorGaveUp",
]
