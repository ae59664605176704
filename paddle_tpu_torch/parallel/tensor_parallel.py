"""Tensor (model) parallelism: parameter specs (counterpart of
``paddle_tpu/parallel/tensor_parallel.py``; the reference's per-layer
device placement, ParallelNeuralNetwork).

fc and embedding weights take Megatron-style column/row specs on the
``tp`` axis; the sharded executor slices them and issues the matching
collectives (a row-parallel product's all-reduce, a vocab-sharded
lookup's sum).
"""
from __future__ import annotations

from typing import Dict, Optional

from ..core.program import Program
from ..core.scope import Scope
from .mesh import Mesh, P

__all__ = ["column_parallel_spec", "row_parallel_spec",
           "embedding_parallel_spec", "shard_params"]


def column_parallel_spec():
    """fc weight [in, out] sharded on out: activations stay sharded on
    ``tp``."""
    return P(None, "tp")


def row_parallel_spec():
    """fc weight [in, out] sharded on in: outputs sum over ``tp``."""
    return P("tp", None)


def embedding_parallel_spec():
    """A vocab-sharded embedding [V, D] (the SelectedRows/CTR table
    analog: a masked partial lookup and one sum)."""
    return P("tp", None)


def shard_params(program: Program, scope: Scope, mesh: Mesh,
                 overrides: Optional[Dict[str, P]] = None):
    """Slice each parameter the scope holds whole into this rank's piece
    by its ``Parameter.sharding`` (``ParamAttr(sharding=...)``) or an
    override, recording its layout in ``scope.layouts``; unannotated
    parameters replicate.  A sharded executor's runs keep the layouts
    (give it the same overrides as ``param_specs``)."""
    from .sharded import place
    place(program, scope, mesh, dict(overrides or {}))
