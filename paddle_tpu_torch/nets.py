"""Composite network blocks (counterpart of ``paddle_tpu/nets.py``):
``simple_img_conv_pool``, ``img_conv_group``, ``sequence_conv_pool``,
``glu`` and ``scaled_dot_product_attention``."""
from __future__ import annotations

from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group", "sequence_conv_pool",
           "glu", "scaled_dot_product_attention"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, act=None, pool_type="max",
                         param_attr=None):
    """conv2d then pool2d (``nets.py:12-18``)."""
    conv_out = layers.conv2d(input, num_filters, filter_size,
                             param_attr=param_attr, act=act)
    return layers.pool2d(conv_out, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", pool_ceil_mode=False):
    """A run of 3x3 convolutions, each optionally followed by batch norm
    (which then takes the activation) and dropout, then one pool2d
    (``nets.py:21-43``).  Padding, batch norm and drop rate may be given
    per convolution."""
    n = len(conv_num_filter)

    def per_conv(v):
        return list(v) if isinstance(v, (list, tuple)) else [v] * n

    conv_padding = per_conv(conv_padding)
    conv_with_batchnorm = per_conv(conv_with_batchnorm)
    conv_batchnorm_drop_rate = per_conv(conv_batchnorm_drop_rate)
    tmp = input
    for i, nf in enumerate(conv_num_filter):
        local_act = conv_act if not conv_with_batchnorm[i] else None
        tmp = layers.conv2d(tmp, nf, conv_filter_size,
                            padding=conv_padding[i], act=local_act,
                            param_attr=param_attr)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(tmp, act=conv_act)
            if conv_batchnorm_drop_rate[i] > 0:
                tmp = layers.dropout(tmp, conv_batchnorm_drop_rate[i])
    return layers.pool2d(tmp, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride, ceil_mode=pool_ceil_mode)


def sequence_conv_pool(input, num_filters, filter_size, act="sigmoid",
                       pool_type="max", param_attr=None):
    """sequence_conv then sequence_pool (``nets.py:46-50``)."""
    conv_out = layers.sequence_conv(input, num_filters, filter_size,
                                    param_attr=param_attr, act=act)
    return layers.sequence_pool(conv_out, pool_type)


def glu(input, dim=-1):
    """Gated linear unit: the first half of ``input`` along ``dim``
    times the sigmoid of the second (``nets.py:53-55``)."""
    a, b = layers.split(input, 2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


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
