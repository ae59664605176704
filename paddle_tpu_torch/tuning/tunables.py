"""The autotuner's view of the tunable registry (counterpart of
``paddle_tpu/tuning/tunables.py``).

The registry itself is :mod:`paddle_tpu_torch.core.registry`
(``register_tunable``, beside ``register_shape_fn`` and
``register_shard_fn``), so a subsystem declares its knobs beside its code
without importing this package.  Here:

* :func:`grid_configs` — every config of a tunable's space in a fixed
  order, today's default first (the searches' candidates);
* :func:`validate_config` — a (deserialized) config against the declared
  space, so a persisted record whose schema drifted falls back to the
  default instead of injecting a foreign value;
* :func:`space_digest` — a hash of the declared space, default and side:
  the schema part of every record's fingerprint, so an edited
  declaration orphans its stored winners.
"""
from __future__ import annotations

import hashlib
import itertools
from typing import Dict, Iterator, List

from ..core.registry import (get_tunable, has_tunable,  # noqa: F401
                             register_tunable, registered_tunables)

__all__ = [
    "register_tunable", "get_tunable", "has_tunable",
    "registered_tunables", "grid_configs", "space_size",
    "validate_config", "space_digest", "describe",
]


def space_size(entry: dict) -> int:
    n = 1
    for values in entry["space"].values():
        n *= len(values)
    return n


def grid_configs(entry: dict) -> Iterator[Dict[str, object]]:
    """Every config of the declared space (sorted param names, each axis
    in its declared order), the default first: a budget-capped search
    always measures today's config."""
    params = sorted(entry["space"])
    default = entry["default"]
    yield dict(default)
    for combo in itertools.product(*(entry["space"][p] for p in params)):
        cfg = dict(zip(params, combo))
        if cfg != default:
            yield cfg


def validate_config(entry: dict, config: Dict[str, object]) -> List[str]:
    """The problems of ``config`` against the declared space ([] when it
    is valid)."""
    problems = []
    for param in entry["space"]:
        if param not in config:
            problems.append(f"missing param {param!r}")
    for param, value in config.items():
        axis = entry["space"].get(param)
        if axis is None:
            problems.append(f"unknown param {param!r}")
        elif value not in axis:
            problems.append(f"{param}={value!r} not in declared axis "
                            f"{axis}")
    return problems


def space_digest(entry: dict) -> str:
    """Schema digest of a declaration: its name, side, axes and default
    (the JAX package's payload, so a knob declared alike in both packages
    has one digest)."""
    payload = repr((entry["name"], entry["side"],
                    tuple(sorted((p, tuple(v))
                          for p, v in entry["space"].items())),
                    tuple(sorted(entry["default"].items()))))
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def describe(name: str) -> str:
    """One block of the command line's registry listing."""
    e = get_tunable(name)
    lines = [f"{e['name']}  [{e['side']}]"
             + ("  (pending hardware)" if e["pending_hardware"] else "")]
    if e["description"]:
        lines.append(f"  {e['description']}")
    for p in sorted(e["space"]):
        lines.append(f"  {p}: {list(e['space'][p])} (default "
                     f"{e['default'][p]!r})")
    if e["decision_rule"]:
        lines.append(f"  decision rule: {e['decision_rule']}")
    return "\n".join(lines)
