"""Operator implementation registry (counterpart of
``paddle_tpu/core/registry.py``: ``register_op`` and ``get_op_impl``, the
static-analysis companions ``register_shape_fn`` and
``register_shard_fn``, and the autotuner's ``register_tunable`` with its
call-site replay ``resolve_tuned``).

An op implementation is an eager PyTorch function with the same contract
as the JAX lowerings::

    @register_op("elementwise_add")
    def _add(ctx, ins, attrs):
        return {"Out": ins["X"][0] + ins["Y"][0]}

* ``ins``  — dict slot -> list of input tensors.
* return   — dict slot -> tensor or list of tensors.
* ``ctx``  — ``core.executor.ExecContext``: device, test mode, generators.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

_OP_IMPLS: Dict[str, Callable] = {}
_SHAPE_FNS: Dict[str, Callable] = {}
_SHARD_FNS: Dict[str, Callable] = {}
_TUNABLES: Dict[str, dict] = {}


def register_op(*names: str):
    """Register an implementation for one or more op type names."""

    def deco(fn):
        for n in names:
            if n in _OP_IMPLS:
                raise ValueError(f"op {n!r} registered twice")
            _OP_IMPLS[n] = fn
        return fn

    return deco


def get_op_impl(name: str) -> Callable:
    try:
        return _OP_IMPLS[name]
    except KeyError:
        raise NotImplementedError(
            f"No implementation registered for op type {name!r} in "
            f"paddle_tpu_torch. Registered: {sorted(_OP_IMPLS)}") from None


def has_op(name: str) -> bool:
    return name in _OP_IMPLS


def registered_ops():
    return sorted(_OP_IMPLS)


def _register_into(table: Dict[str, Callable], what: str, names):
    def deco(fn):
        for n in names:
            if n in table:
                raise ValueError(f"{what} for op {n!r} registered twice")
            table[n] = fn
        return fn

    return deco


def register_shape_fn(*names: str):
    """Register a static shape/dtype inference rule for one or more op
    type names — the build-time companion of :func:`register_op` and the
    analog of the reference's per-op ``InferShape``.

    A rule has the signature ``fn(op, ins, attrs) -> {slot: VarInfo|...}``
    where ``ins`` maps input slot -> list of
    :class:`paddle_tpu_torch.analysis.shape_infer.VarInfo`; it raises
    :class:`paddle_tpu_torch.analysis.shape_infer.ShapeError` when the
    inputs are statically incompatible.  Rules run at validation time
    only, never inside a captured step.  Ops without a rule are listed in
    ``analysis.shape_infer.SHAPE_INFER_ALLOWLIST``; tier-1 holds every
    registered op to exactly one of the two."""
    return _register_into(_SHAPE_FNS, "shape fn", names)


def get_shape_fn(name: str) -> Optional[Callable]:
    return _SHAPE_FNS.get(name)


def has_shape_fn(name: str) -> bool:
    return name in _SHAPE_FNS


def registered_shape_fns():
    return sorted(_SHAPE_FNS)


def register_shard_fn(*names: str):
    """Register a sharding-propagation rule for one or more op type names
    — the distributed companion of :func:`register_shape_fn`, read by
    ``analysis.shard_prop`` and the planner.

    A rule has the signature ``fn(op, ins, attrs) -> {out_slot: spec}``
    where ``ins`` maps input slot -> list of
    :class:`paddle_tpu_torch.analysis.shard_prop.ShardInfo` and each spec
    is a tuple with one entry per output dim (``None`` = replicated, an
    axis name, or a tuple of axis names).  Rules raise
    ``analysis.shard_prop.ShardConflict`` where the inputs' shardings
    cannot meet without a reshard (PT041); a ``.backward`` attribute, if
    any, drives the reverse sweep.  Ops without a rule are propagation
    blind spots (PT042)."""
    return _register_into(_SHARD_FNS, "shard fn", names)


def get_shard_fn(name: str) -> Optional[Callable]:
    return _SHARD_FNS.get(name)


def has_shard_fn(name: str) -> bool:
    return name in _SHARD_FNS


def registered_shard_fns():
    return sorted(_SHARD_FNS)


def register_tunable(name: str, *, side: str, space: Dict[str, tuple],
                     default: Dict[str, object], description: str = "",
                     pending_hardware: bool = False,
                     decision_rule: str = "") -> dict:
    """Declare a named performance knob with a finite search space, beside
    the code whose behaviour it controls; ``paddle_tpu_torch.tuning``
    enumerates, searches and persists it.

    * ``name`` — ``<subsystem>/<knob>``, a string literal at the call
      site (``tests/test_torch_imports.py`` scans for duplicates); the
      persistence key and the ``tuned(name, default)`` lookup key.
    * ``side`` — ``"host"`` (searchable anywhere: dispatch chunking,
      reader workers, the serving batcher) or ``"device"`` (needs the
      card: a kernel's launch plan).
    * ``space`` — ``{param: (candidate, ...)}``; the searches enumerate
      the product of the axes.
    * ``default`` — today's config, one member of each axis:
      ``tuned(name, default)`` returns exactly this object when no
      persisted winner exists.
    * ``pending_hardware`` — a device knob whose search has not run on a
      card yet; it must carry a ``decision_rule`` written before the
      measurement.

    Declaring imports nothing of the tuning package."""
    if name in _TUNABLES:
        raise ValueError(f"tunable {name!r} registered twice")
    if "/" not in name:
        raise ValueError(f"tunable {name!r} is not namespaced (sub/name)")
    if side not in ("host", "device"):
        raise ValueError(f"tunable {name!r}: side must be 'host' or "
                         f"'device', got {side!r}")
    if not space:
        raise ValueError(f"tunable {name!r}: empty search space")
    if set(default) != set(space):
        raise ValueError(
            f"tunable {name!r}: default keys {sorted(default)} != space "
            f"axes {sorted(space)}")
    norm = {}
    for param, values in space.items():
        values = tuple(values)
        if not values:
            raise ValueError(f"tunable {name!r}: axis {param!r} is empty")
        if len(set(values)) != len(values):
            raise ValueError(
                f"tunable {name!r}: axis {param!r} has duplicate values")
        if default[param] not in values:
            raise ValueError(
                f"tunable {name!r}: default {param}={default[param]!r} is "
                f"not in its axis {values}: the search must be able to "
                f"re-select today's config")
        norm[param] = values
    if pending_hardware and not decision_rule:
        raise ValueError(
            f"tunable {name!r}: pending_hardware entries must pre-register "
            f"a decision_rule (the threshold is written down before the "
            f"measurement exists)")
    entry = {"name": name, "side": side, "space": norm,
             "default": dict(default), "description": description,
             "pending_hardware": bool(pending_hardware),
             "decision_rule": decision_rule}
    _TUNABLES[name] = entry
    return entry


def get_tunable(name: str) -> dict:
    try:
        return _TUNABLES[name]
    except KeyError:
        raise KeyError(
            f"no tunable registered under {name!r}; registered: "
            f"{sorted(_TUNABLES)}") from None


def has_tunable(name: str) -> bool:
    return name in _TUNABLES


def registered_tunables():
    return sorted(_TUNABLES)


def resolve_tuned(name: str, default: Dict[str, object],
                  autotune: Optional[bool] = None) -> Dict[str, object]:
    """A call site's config: ``default`` itself (the same object,
    untouched) unless autotuning is on, and then the persisted winner for
    ``name`` merged over it.  ``autotune=None`` reads the ``autotune``
    flag; a bool overrides it (the per-instance opt-ins).  The tuning
    package is imported here, and only when autotuning is on."""
    if autotune is None:
        from .. import flags
        autotune = bool(flags.get_flag("autotune"))
    if not autotune:
        return default
    from ..tuning.store import tuned
    return tuned(name, default)
