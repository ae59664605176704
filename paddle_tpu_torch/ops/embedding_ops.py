"""Embedding ops (counterpart of the dense ``lookup_table`` in
``paddle_tpu/ops/embedding_ops.py:16-36``).  The gather's gradient is
autograd's scatter-add into a dense [V, D] gradient; the sparse-row
paths (``is_sparse``, ``lookup_table_sparse``) come with the sparse
slice."""
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
