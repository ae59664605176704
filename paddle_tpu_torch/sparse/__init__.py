"""Sparse parameter server: host-resident giant-embedding tables
(counterpart of ``paddle_tpu/sparse/``).

The reference's pserver sparse-row path (``SparseRowCpuMatrix`` +
``SparseRemoteParameterUpdater``: pull only the rows a batch touches,
push only their gradients, apply the sparse optimizer update on the
server) around the port's captured step:

* :mod:`.table`: :class:`SparseTable`, a vocab-sharded host row store
  (numpy or mmap shards) with lazy per-row Philox init and per-row
  SGD/Adagrad slot state; spec-agnostic sharded checkpoint export.
* :mod:`.session`: :class:`SparseSession`, the executor rim (per-batch
  dedup -> cache-first pull -> rows and inverse-index feeds ->
  ``<rows>@GRAD`` fetch -> push), hot-rows cache, read-only inference
  mode, serving attachment.

The wire tier serves a table from shard processes and is loaded only
by ``python -m paddle_tpu_torch pserver`` and an explicit
``from paddle_tpu_torch.sparse.client import RemoteSparseTable``:

* :mod:`.wire`: length-prefixed binary frames (one batched frame per
  request) and the naive per-row JSON control arm, byte-compatible with
  the JAX package's;
* :mod:`.pserver`: the shard server process (``--shard k/N``); SIGTERM
  checkpoints and exits 75; chain-backup push replication;
* :mod:`.client`: :class:`~.client.RemoteSparseTable`, client-side
  ``id % N`` sharding, pipelined per-shard frames, retry and reconnect;
  it duck-types :class:`SparseTable`, so a session binds it unchanged.

Declare a host table with ``layers.embedding(..., sparse=True)``; the
trainer runs the rim with ``train(sparse_tables=session)``.  Nothing of
this package is imported by ``import paddle_tpu_torch``.
"""
from .session import (HotRowCache, SparseBinding, SparseSession,
                      table_specs, tables_for_program)
from .table import PAD_ID, SparseTable

__all__ = ["SparseTable", "PAD_ID", "SparseSession", "SparseBinding",
           "HotRowCache", "table_specs", "tables_for_program"]
