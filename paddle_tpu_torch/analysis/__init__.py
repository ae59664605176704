"""Static program verification for the Program IR (counterpart of
``paddle_tpu/analysis``).

The build-time analog of the reference's C++ desc-layer validation
(InferShape in op_desc.cc/operator.h, OpDesc attr checking against the
OpInfoMap, PADDLE_ENFORCE context in enforce.h) — run over the
model-as-data ``Program`` *before* the executor interprets or captures
it, so a malformed graph fails with a stable ``PT0xx`` diagnostic naming
the op, not a torch error from inside ``Executor.run``.

Four passes (each its own module), the same as the JAX package's:

1. :mod:`.verifier` — well-formedness: dangling/undefined inputs,
   def-after-use cycles, unregistered op types, duplicate writers,
   orphaned ``@GRAD``/``@LEN`` companions (PT001-PT007).
2. :mod:`.shape_infer` — shape & dtype inference through per-op rules
   registered beside the implementations (``register_shape_fn``), with
   ``-1``-batch symbolic dims (PT010-PT012).
3. :mod:`.lints` — dead ops, retrace hazards, sharding-spec consistency
   (PT020-PT022, PT030-PT031, PT040).
4. :mod:`.diagnostics` — the stable code registry and report rendering.

Above them: :mod:`.shard_prop` propagates per-dim sharding annotations
through per-op ``register_shard_fn`` rules (PT041/PT042), :mod:`.cost_model`
prices a plan statically (FLOPs/bytes/collectives/peak memory, H100
constants) and :mod:`.planner` enumerates, scores and validates candidate
``param_specs``/``feed_specs`` for a mesh.  :mod:`.concurrency` is the
PT05x pass over the port's own host source.

Entry points: :func:`validate_program` here, ``Program.validate()``,
``Executor(validate=True)`` / the ``validate`` flag
(``PADDLE_TPU_TORCH_VALIDATE=1``) and ``trainer.SGD.train(validate=)``.
The Executor validates before it takes a step's capture key, so an
invalid program is never captured, and memoizes per (program version,
fetches), so validation never runs inside a captured replay.

The ops modules import :mod:`.shape_infer` and :mod:`.shard_prop` for
their rules; everything else here loads on first use (the names below
resolve lazily), so ``import paddle_tpu_torch`` never loads the verifier,
the lints, the cost model or the planner.
"""
from __future__ import annotations

import importlib
from typing import Dict, Optional, Sequence

from .diagnostics import (CODES, Diagnostic, ProgramVerificationError,
                          ValidationReport, diag)

__all__ = [
    "CODES", "Diagnostic", "ProgramVerificationError", "ValidationReport",
    "ShapeError", "VarInfo", "SHAPE_INFER_ALLOWLIST", "coverage",
    "validate_program", "diag", "propagate_sharding", "PropagationResult",
    "ShardConflict", "ShardInfo",
]

# name -> submodule, resolved on first attribute access
_LAZY = {
    "mesh_axes_of": "lints", "run_dead_op_lint": "lints",
    "run_retrace_lints": "lints", "run_sharding_lints": "lints",
    "SHAPE_INFER_ALLOWLIST": "shape_infer", "ShapeError": "shape_infer",
    "VarInfo": "shape_infer", "coverage": "shape_infer",
    "run_shape_inference": "shape_infer",
    "PropagationResult": "shard_prop", "ShardConflict": "shard_prop",
    "ShardInfo": "shard_prop", "propagate_sharding": "shard_prop",
    "run_verifier": "verifier",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return getattr(importlib.import_module(f".{mod}", __name__), name)


def validate_program(program,
                     fetch_list: Optional[Sequence] = None,
                     mesh=None,
                     param_specs: Optional[Dict] = None,
                     feed_specs: Optional[Dict] = None) -> ValidationReport:
    """Run all static verification passes over ``program``.

    ``fetch_list`` (Variables or names) enables the dead-op lint — without
    targets deadness is undefined, so PT020 is skipped.  ``mesh`` (an
    axis->size dict) enables the sharding checks, with optional
    ``param_specs``/``feed_specs`` overrides.

    Returns a :class:`ValidationReport`; call ``.raise_on_error()`` to turn
    error-severity findings into :class:`ProgramVerificationError`.  Each
    invocation bumps the ``validations`` counter of
    ``core.compile_cache.stats()`` — what the once-per-signature tests
    read.
    """
    from ..core import compile_cache
    from .lints import (mesh_axes_of, run_dead_op_lint, run_retrace_lints,
                        run_sharding_lints)
    from .shape_infer import run_shape_inference
    from .verifier import run_verifier
    compile_cache.stats().bump("validations")

    report = ValidationReport()
    run_verifier(program, report)
    run_shape_inference(program, report)
    if fetch_list is not None:
        fetch_names = [getattr(v, "name", None) or str(v)
                       for v in fetch_list]
        run_dead_op_lint(program, fetch_names, report)
    run_retrace_lints(program, report)
    run_sharding_lints(program, mesh_axes_of(mesh), report,
                       param_specs=param_specs, feed_specs=feed_specs)
    return report
