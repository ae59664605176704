"""Persistent autotuner: searched and stored configs for the port's host
knobs and the card's kernel launches (counterpart of
``paddle_tpu/tuning``).

Three layers:

* :mod:`.tunables` — the registry view.  A subsystem declares its knobs
  beside its code through ``core.registry.register_tunable``: dispatch
  chunking in ``core/executor.py``, reader prefetch in
  ``reader/pipeline.py``, the serving batcher in ``serving/server.py``,
  the decode slot pool in ``serving/decode.py``, the sparse session's
  knobs in ``sparse/session.py``, K1's launch plan in ``ops/conv1x1.py``
  and K2-K4's ring depths in ``ops/flash_attention.py``.  Declaring
  never imports this package.
* :mod:`.search` — grid and successive-halving searches over timed
  windows (a discarded warm-up, the median of the rest, on the host's
  clock around the card's synchronize), the paired alternating A/B whose
  noise gate refuses a winner inside the jitter, and per-trial fault
  containment (a raising or overrunning config is a ``failed`` or
  ``timeout`` trial, never a crashed search).
* :mod:`.store` — winners as JSON under ``<cache_dir>/tuning/``, keyed
  by the tunable's schema digest, the card and the torch, CUDA and port
  versions; ``tuned(name, default)`` replays them with no search, and
  returns the default object itself when no record exists.

Entry points: ``python -m paddle_tpu_torch tune <target>``, the replay
opt-ins (``Executor(autotune=True)``, ``trainer.SGD.train(autotune=
True)``, ``Server(autotune=True)``, ``DecodeEngine``/``DecodeRuntime(
autotune=True)``, ``serve --autotune``, the ``autotune`` flag),
:mod:`.targets` (the built-in workloads), and the drivers
``benchmark.autotune``, ``benchmark.conv_kernel`` and
``benchmark.longctx --sweep``.

Outside this package and those drivers the package is imported lazily,
inside the function that opts in, so ``import paddle_tpu_torch`` never
loads it (``tests/test_torch_imports.py``).
"""
from .search import (SearchResult, Trial, grid_search,  # noqa: F401
                     paired_ab, pending_stub, successive_halving,
                     time_windows, tune)
from .store import (TUNING_FORMAT, clear_memo, list_records,  # noqa: F401
                    load_record, record_fingerprint, save_record, tuned)
from .tunables import (get_tunable, grid_configs,  # noqa: F401
                       has_tunable, register_tunable,
                       registered_tunables, space_digest, validate_config)

__all__ = [
    "register_tunable", "get_tunable", "has_tunable",
    "registered_tunables", "grid_configs", "space_digest",
    "validate_config",
    "Trial", "SearchResult", "time_windows", "grid_search",
    "successive_halving", "paired_ab", "tune", "pending_stub",
    "TUNING_FORMAT", "tuned", "save_record", "load_record",
    "record_fingerprint", "list_records", "clear_memo",
]
