"""Embedding ops (counterpart of ``lookup_table`` and
``lookup_table_sparse`` in ``paddle_tpu/ops/embedding_ops.py:16-53``).
The gather's gradient is autograd's scatter-add (an accumulating
``index_put_``): into a dense [V, D] gradient for ``lookup_table``
(``is_sparse`` changes nothing), into the [bucket, D] rows feed for
``lookup_table_sparse``."""
from __future__ import annotations

import torch

from ..core.registry import register_op


@register_op("lookup_table")
def _lookup_table(ctx, ins, attrs):
    """W [V, D]; Ids [..., 1] or [...] of ints -> Out [..., D]; the rows
    of ids equal to ``padding_idx`` (when >= 0) are zeros."""
    w, ids = ins["W"][0], ins["Ids"][0].long()
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    pad = attrs.get("padding_idx", None)
    if pad is None or pad < 0:
        return {"Out": w[ids]}
    is_pad = ids == pad
    out = w[torch.where(is_pad, 0, ids)]
    return {"Out": out.masked_fill(is_pad[..., None], 0)}


@register_op("lookup_table_sparse")
def _lookup_table_sparse(ctx, ins, attrs):
    """A host-resident table's gather (``paddle_tpu_torch.sparse``): the
    ``SparseSession`` rim feeds ``Rows``, the dense [bucket, D] rows the
    batch touches, and ``Inverse``, each id position's slot in them, so
    the op is a gather of rows.  The gradient of ``Rows`` is fetched as
    ``<rows>@GRAD`` and pushed back to the host table.  ``Ids`` is an
    input for the graph's data dependency only (the session derives
    ``Inverse`` from it on the host)."""
    rows, inv = ins["Rows"][0], ins["Inverse"][0]
    return {"Out": rows[inv.long()]}


# ---------------------------------------------------------------------------
# Static shape/dtype rules (analysis.shape_infer).
# ---------------------------------------------------------------------------
from ..analysis.shape_infer import (ShapeError, VarInfo, first,  # noqa: E402
                                    squeeze_ids)
from ..core.registry import register_shape_fn  # noqa: E402


@register_shape_fn("lookup_table")
def _lookup_table_shape(op, ins, attrs):
    w, ids = first(ins, "W"), first(ins, "Ids")
    if ids.dtype is not None and ids.dtype.kind == "f":
        raise ShapeError(
            f"lookup_table: Ids must be integral, got {ids.dtype.name}")
    s = squeeze_ids(ids)
    if s is None or w.shape is None:
        return {"Out": VarInfo(None, w.dtype)}
    return {"Out": VarInfo(s + (w.shape[-1],), w.dtype)}


@register_shape_fn("lookup_table_sparse")
def _lookup_table_sparse_shape(op, ins, attrs):
    rows, inv = first(ins, "Rows"), first(ins, "Inverse")
    if inv.dtype is not None and inv.dtype.kind == "f":
        raise ShapeError(
            f"lookup_table_sparse: Inverse must be integral, got "
            f"{inv.dtype.name}")
    dim = int(attrs.get("dim", rows.shape[-1] if rows.shape else -1))
    if inv.shape is None:
        return {"Out": VarInfo(None, rows.dtype)}
    return {"Out": VarInfo(tuple(inv.shape) + (dim,), rows.dtype)}


# ---------------------------------------------------------------------------
# Sharding-propagation rules (analysis.shard_prop).  A vocab-sharded table
# is a masked partial gather + all-reduce; the output rides the Ids'
# batch sharding either way, with the emb dim following the table's
# column split.
# ---------------------------------------------------------------------------
from ..analysis.shard_prop import first_in, squeeze_spec_ids  # noqa: E402
from ..core.registry import register_shard_fn  # noqa: E402


@register_shard_fn("lookup_table")
def _lookup_table_shard(op, ins, attrs):
    w, ids = first_in(ins, "W"), first_in(ins, "Ids")
    if w.spec is None and ids.spec is None:
        return {}
    lead = squeeze_spec_ids(ids)
    return {"Out": lead + (w.entry(-1),)}


@register_shard_fn("lookup_table_sparse")
def _lookup_table_sparse_shard(op, ins, attrs):
    # The table is HOST-side; the planner sees only the dense gathered
    # rows as a device tensor.  Out follows the inverse index's (batch)
    # sharding with the emb dim riding the rows feed's column split
    # (normally replicated — the rows feed is host-built per batch).
    rows, inv = first_in(ins, "Rows"), first_in(ins, "Inverse")
    if rows.spec is None and inv.spec is None:
        return {}
    lead = tuple(inv.spec) if inv.spec is not None else (None,)
    return {"Out": lead + (rows.entry(-1),)}
