"""Composite network blocks (counterpart of ``paddle_tpu/nets.py``): only
``scaled_dot_product_attention`` so far."""
from __future__ import annotations

from . import layers

__all__ = ["scaled_dot_product_attention"]


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0, sequence_parallel=True):
    """Attention block (``nets.py:58-78``).  3-D [B, T, D] inputs without
    dropout go through ``layers.flash_attention`` (the CUDA kernels);
    4-D inputs, which this entry point has always read as [B, H, T, D],
    and attention-weight dropout go through scale, matmul, softmax and
    dropout."""
    if dropout_rate == 0.0 and len(queries.shape) == 3:
        return layers.flash_attention(queries, keys, values,
                                      sequence_parallel=sequence_parallel)
    d = queries.shape[-1]
    scaled_q = layers.scale(queries, scale=float(d) ** -0.5)
    logits = layers.matmul(scaled_q, keys, transpose_y=True)
    weights = layers.softmax(logits)
    if dropout_rate > 0.0:
        weights = layers.dropout(weights, dropout_rate)
    return layers.matmul(weights, values)
