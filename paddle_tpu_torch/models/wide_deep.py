"""Wide & Deep CTR model (counterpart of ``paddle_tpu/models/wide_deep.py``).

Every sparse feature is an embedding lookup; ``is_sparse=True`` stays a
recorded attr on a dense ``lookup_table``, whose gradient is autograd's
scatter-add into the dense table (the sparse-row path comes with the
sparse tables).
"""
from __future__ import annotations

from .. import layers


def wide_deep(sparse_ids, dense_feat, vocab_sizes, emb_dim=16,
              deep_hidden=(64, 32)):
    """``sparse_ids``: list of int id tensors [B, 1]; ``dense_feat``:
    [B, D] float tensor; returns the sigmoid CTR prediction [B, 1]."""
    # deep: concat embeddings + dense -> MLP
    embs = [layers.embedding(ids, size=[vs, emb_dim], is_sparse=True)
            for ids, vs in zip(sparse_ids, vocab_sizes)]
    deep = layers.concat(embs + [dense_feat], axis=1)
    for h in deep_hidden:
        deep = layers.fc(deep, size=h, act="relu")
    # wide: one scalar weight per sparse id (linear part) + dense linear
    wides = [layers.embedding(ids, size=[vs, 1], is_sparse=True)
             for ids, vs in zip(sparse_ids, vocab_sizes)]
    wide = layers.concat(wides + [dense_feat], axis=1)
    wide = layers.fc(wide, size=1)
    logit = layers.elementwise_add(layers.fc(deep, size=1), wide)
    return layers.sigmoid(logit)
