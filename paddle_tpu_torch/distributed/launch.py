"""Multi-process bootstrap (counterpart of
``paddle_tpu/distributed/launch.py``; the role of the reference's
cluster_train fabric launcher and its trainer_id / num_gradient_servers
flags).

Every rank is a process that runs the same script.
:func:`init_distributed` joins them into one ``torch.distributed`` world
through a ``TCPStore`` at the coordinator's address (rank 0 hosts it).
The backend follows the device the caller asks for: ``nccl`` for the
card (the default), ``gloo`` for ``device="cpu"``.  There is no fallback
from one to the other: a card world that cannot start NCCL raises.

Hardening, as in the JAX package: a cold cluster's coordinator is
routinely the last process up, so the join is wrapped in the retry
policy (``faults.retry_call``: exponential backoff with seeded jitter);
once the budget (``timeout_s`` / ``PADDLE_TPU_COORDINATOR_TIMEOUT_S``,
default :data:`DEFAULT_COORDINATOR_TIMEOUT_S`) is spent, a typed
:class:`CoordinatorTimeoutError` names the coordinator and the budget.

``init_distributed(init_method="file://...")`` joins through a
``FileStore`` instead of a coordinator (the CPU tests' worlds).
"""
from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch

from ..faults import RetriesExhausted, RetryPolicy, retry_call

logger = logging.getLogger("paddle_tpu_torch")

_initialized = False

DEFAULT_COORDINATOR_TIMEOUT_S = 60.0

#: the store's connection failures (RuntimeErrors to the retry policy's
#: classifier, but a coordinator not up yet)
_NETWORK_ERRORS = tuple(e for e in (
    getattr(torch.distributed, "DistNetworkError", None),
    getattr(torch.distributed, "DistStoreError", None)) if e is not None)

#: the backend of each device type: the card's collectives are NCCL's,
#: the host's gloo's
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


class CoordinatorTimeoutError(TimeoutError):
    """Multi-process init could not reach the coordinator within the
    retry budget.  Carries ``address`` and ``timeout_s`` so a supervisor
    can report WHICH endpoint never answered."""

    def __init__(self, address: Optional[str], timeout_s: float,
                 last: Optional[BaseException] = None):
        super().__init__(
            f"torch.distributed.init_process_group: coordinator "
            f"{address or '<unset>'} unreachable within {timeout_s:g}s: "
            f"{type(last).__name__ if last else '?'}: {last}")
        self.address = address
        self.timeout_s = timeout_s
        self.last = last


def _coordinator_timeout_s(timeout_s: Optional[float]) -> float:
    if timeout_s is not None:
        return float(timeout_s)
    env = os.environ.get("PADDLE_TPU_COORDINATOR_TIMEOUT_S")
    return float(env) if env else DEFAULT_COORDINATOR_TIMEOUT_S


def _retry_policy(timeout_s: float) -> RetryPolicy:
    """A seeded backoff schedule whose total sleep stays within the
    budget: 1s base doubling to an 8s cap gives attempts at roughly
    t=0, 1, 3, 7, 15, 23, ... — max_attempts is the count that fits."""
    attempts, acc, delay = 1, 0.0, 1.0
    while acc + delay <= timeout_s:
        acc += delay
        delay = min(delay * 2.0, 8.0)
        attempts += 1
    return RetryPolicy(max_attempts=max(attempts, 1), backoff_base_s=1.0,
                       backoff_max_s=8.0, jitter=0.1, seed=0)


def backend_for(device: str) -> str:
    """The collective backend of ``device`` (``"cuda"`` or ``"cpu"``)."""
    kind = torch.device(device).type
    if kind not in BACKENDS:
        raise ValueError(f"init_distributed: no collective backend for "
                         f"device {device!r} (have {sorted(BACKENDS)})")
    return BACKENDS[kind]


def _store(address: str, world: int, rank: int, timeout_s: float):
    host, _, port = address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"init_distributed: coordinator address must be "
                         f"host:port, got {address!r}")
    return torch.distributed.TCPStore(
        host, int(port), world, is_master=rank == 0,
        timeout=datetime.timedelta(seconds=timeout_s), wait_for_workers=True)


def init_distributed(coordinator_address: str = None,
                     num_processes: int = None, process_id: int = None,
                     timeout_s: Optional[float] = None,
                     device: str = "cuda",
                     init_method: Optional[str] = None):
    """Join this process into the world.  No-op when single-process (the
    common dev case) or already initialized.

    ``coordinator_address`` (``host:port``) falls back to
    ``PADDLE_TPU_COORDINATOR``; with neither set, no ``init_method`` and
    no explicit ``num_processes`` this is single-process mode.  Rank 0
    hosts the ``TCPStore``; the others connect to it.  ``device`` picks
    the backend (``nccl`` for ``"cuda"``, ``gloo`` for ``"cpu"``); on the
    card each rank takes card ``process_id % device_count`` unless the
    caller already chose one.  Attempts retry with seeded exponential
    backoff until the ``timeout_s`` / ``PADDLE_TPU_COORDINATOR_TIMEOUT_S``
    budget lapses, then raise :class:`CoordinatorTimeoutError`."""
    global _initialized
    if _initialized:
        return
    coordinator_address = coordinator_address or os.environ.get(
        "PADDLE_TPU_COORDINATOR")
    if coordinator_address is None and num_processes is None \
            and init_method is None:
        _initialized = True   # single-process mode
        return
    if num_processes is None or process_id is None:
        raise ValueError("init_distributed: a multi-process world needs "
                         "num_processes and process_id")
    world, rank = int(num_processes), int(process_id)
    backend = backend_for(device)
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_distributed(device='cuda'): no CUDA device is "
                "available; pass device='cpu' for a gloo world")
        if not torch.cuda.is_initialized() or \
                torch.cuda.current_device() == 0:
            torch.cuda.set_device(rank % torch.cuda.device_count())
    budget = _coordinator_timeout_s(timeout_s)
    policy = _retry_policy(budget)

    def _attempt():
        kw = dict(backend=backend, world_size=world, rank=rank,
                  timeout=datetime.timedelta(seconds=max(budget, 1.0)))
        if init_method is not None:
            kw["init_method"] = init_method
        else:
            kw["store"] = _store(coordinator_address, world, rank, budget)
        torch.distributed.init_process_group(**kw)

    def _on_retry(i, e, d):
        logger.warning(
            "init_distributed: coordinator %s attempt %d failed "
            "(%s: %s); retrying in %.1fs",
            coordinator_address or init_method, i + 1, type(e).__name__,
            e, d)

    try:
        retry_call(_attempt, policy, what="init_process_group",
                   on_retry=_on_retry, retryable_extra=_NETWORK_ERRORS)
    except RetriesExhausted as e:
        raise CoordinatorTimeoutError(coordinator_address or init_method,
                                      budget, e.last) from e
    _initialized = True


def shutdown():
    """Leave the world (destroy the default process group) and forget
    that :func:`init_distributed` ran."""
    global _initialized
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    _initialized = False


def reset_distributed_state():
    """Testing hook: forget that :func:`init_distributed` ran so the
    no-op/env-var paths can be exercised repeatedly in one process.
    Does NOT tear down a live process group (:func:`shutdown` does)."""
    global _initialized
    _initialized = False


def is_initialized() -> bool:
    return _initialized


def _world():
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return torch.distributed.get_rank() if _world() else 0


def process_count() -> int:
    return torch.distributed.get_world_size() if _world() else 1
