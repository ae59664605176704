"""Operator implementation registry (counterpart of
``paddle_tpu/core/registry.py``: ``register_op`` and ``get_op_impl``).

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

from typing import Callable, Dict

_OP_IMPLS: Dict[str, Callable] = {}


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
