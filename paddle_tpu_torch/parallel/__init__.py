"""Parallelism over a mesh of ranks (counterpart of
``paddle_tpu/parallel``; the reference's four communication backends:
the v1 pserver, the Go pserver/master, fluid's gRPC send/recv and the
NCCL ops).

Every rank is a process (``distributed.launch.init_distributed``), and
the collectives are ``torch.distributed``'s (NCCL on the card, gloo on
the CPU) over the process groups of the mesh's axes:

* data parallel — :class:`ShardedExecutor` / :class:`DataParallel`: the
  feeds sharded on the batch axis, each parameter's partial gradient
  summed over it before the update, batch statistics made global.
* tensor parallel — Megatron column/row specs on ``tp``
  (``tensor_parallel``), vocab-sharded tables (``sharded_lookup``).
* ``moe`` — the one-card mixture-of-experts routing.

Pipeline, sequence and expert parallelism (``ring_attention``,
``pipeline``, ``moe_ffn``, ``make_local_sgd_step``) wait for ROADMAP
Queue A item 7b: those names raise.
"""
from . import collective, embedding, moe
from .collective import (all_gather, all_reduce, all_to_all, barrier,
                         broadcast, ppermute, psum, reduce_scatter, spmd)
from .data_parallel import DataParallel, shard_batch
from .embedding import sharded_lookup, sharded_lookup_grad_rows
from .mesh import (Mesh, MeshConfig, NamedSharding, P, PartitionSpec,
                   get_mesh, make_hybrid_mesh, make_mesh, mesh_for_axes,
                   mesh_guard, named_sharding)
from .sharded import ShardedExecutor
from .tensor_parallel import (column_parallel_spec, embedding_parallel_spec,
                              row_parallel_spec, shard_params)

__all__ = [
    "MeshConfig", "Mesh", "P", "PartitionSpec", "NamedSharding",
    "get_mesh", "make_mesh", "make_hybrid_mesh", "mesh_for_axes",
    "mesh_guard", "named_sharding", "all_gather", "all_reduce",
    "all_to_all", "broadcast", "psum", "reduce_scatter", "ppermute",
    "barrier", "spmd", "DataParallel", "shard_batch",
    "column_parallel_spec", "row_parallel_spec", "embedding_parallel_spec",
    "shard_params", "ShardedExecutor", "sharded_lookup",
    "sharded_lookup_grad_rows", "embedding", "collective", "moe",
]

#: the names of ROADMAP Queue A item 7b, which raise until it lands
ITEM_7B = ("ring_attention", "pipeline", "pipeline_program", "moe_ffn",
           "local_sgd", "make_local_sgd_step")


def __getattr__(name):
    if name in ITEM_7B:
        raise NotImplementedError(
            f"paddle_tpu_torch.parallel.{name} is not ported yet: it comes "
            f"with ROADMAP Queue A item 7b (ring attention, pipeline, "
            f"expert and local-SGD parallelism)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
