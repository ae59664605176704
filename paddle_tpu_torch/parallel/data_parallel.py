"""Data parallelism over the mesh (counterpart of
``paddle_tpu/parallel/data_parallel.py``; the reference's
MultiGradientMachine ring reduce, the pserver's sync-SGD round trip and
fluid's NCCLAllReduce ops).

:class:`DataParallel` runs a program with its feeds sharded on the batch
axis and its state replicated, through a :class:`ShardedExecutor`: each
rank runs its slice of the batch and the gradients are summed over the
batch axis before the update.  No parameter server, no gradient queue.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..core.program import Program
from ..core.scope import Scope, global_scope
from .mesh import Mesh, get_mesh

__all__ = ["shard_batch", "DataParallel"]


def shard_batch(arrays: Dict[str, object], mesh: Mesh, axis="dp"):
    """This rank's slice of each batch (dim 0 over ``axis``); scalars
    and a mesh without ``axis`` pass through whole."""
    from .sharded import _Step
    n = int(mesh.shape.get(axis, 1))
    st = None
    out = {}
    for name, arr in arrays.items():
        if np.ndim(arr) < 1 or axis not in mesh.shape:
            out[name] = arr
            continue
        b = np.shape(arr)[0]
        if b % n:
            raise ValueError(f"feed {name!r} batch {b} not divisible by "
                             f"{axis}={n}")
        st = st or _Step(mesh)
        lo = st.index((axis,)) * (b // n)
        out[name] = arr.narrow(0, lo, b // n) if isinstance(
            arr, torch.Tensor) else np.asarray(arr)[lo:lo + b // n]
    return out


class DataParallel:
    """Wrap an executor's runs in dp sharding::

        mesh = make_mesh(MeshConfig(dp=world_size()))
        dp = DataParallel(ShardedExecutor(mesh=mesh), mesh)
        dp.run(program, feed=global_batch, fetch_list=[...])

    The global batch must divide the dp axis size.  Parameters and
    optimizer state stay replicated (the reference has no ZeRO-style
    sharding).  ``executor`` defaults to a ``ShardedExecutor`` over
    ``mesh`` with ``batch_axis``; one given must be a
    ``ShardedExecutor``."""

    def __init__(self, executor=None, mesh: Optional[Mesh] = None,
                 batch_axis: str = "dp"):
        from .sharded import ShardedExecutor
        self.mesh = mesh or (executor.mesh if executor is not None
                             and hasattr(executor, "mesh") else get_mesh())
        self.batch_axis = batch_axis
        if executor is None:
            executor = ShardedExecutor(mesh=self.mesh, batch_axis=batch_axis)
        if not isinstance(executor, ShardedExecutor):
            raise TypeError(
                "DataParallel needs a ShardedExecutor (each rank runs its "
                "slice of the batch and the gradients are summed over the "
                f"batch axis); got {type(executor).__name__}")
        self.executor = executor

    def run(self, program: Program, feed=None, fetch_list=None,
            scope: Optional[Scope] = None, **kw):
        feed = feed or {}
        scope = global_scope() if scope is None else scope
        n = int(self.mesh.shape.get(self.batch_axis, 1))
        for name, arr in feed.items():
            if np.ndim(arr) >= 1 and np.shape(arr)[0] % n != 0:
                raise ValueError(
                    f"feed {name!r} batch {np.shape(arr)[0]} not divisible "
                    f"by dp={n}")
        return self.executor.run(program, feed=feed, fetch_list=fetch_list,
                                 scope=scope, **kw)
