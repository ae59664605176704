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
