"""Unique name generator (counterpart of ``paddle_tpu/core/unique_name.py``).

Both packages count the same keys in the same order, so a program built
by either names its variables identically; ``weights.load_numpy_state``
relies on that."""
from __future__ import annotations

import collections
import threading

_local = threading.local()


def _counters():
    if not hasattr(_local, "counters"):
        _local.counters = collections.defaultdict(int)
    return _local.counters


def generate(key: str) -> str:
    c = _counters()
    name = f"{key}_{c[key]}"
    c[key] += 1
    return name


def reset():
    _local.counters = collections.defaultdict(int)
