"""Operator implementation registry (counterpart of
``paddle_tpu/core/registry.py``: ``register_op`` and ``get_op_impl``, and
the static-analysis companions ``register_shape_fn`` and
``register_shard_fn``).

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
