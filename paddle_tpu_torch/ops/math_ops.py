"""Math ops on the ResNet path (counterpart of ``elementwise_add`` and
``mul`` in ``paddle_tpu/ops/math_ops.py``)."""
from __future__ import annotations

import torch

from ..core.registry import register_op


def _bcast(x, y, axis: int):
    """fluid trailing-axis broadcast: Y's shape matches a contiguous run
    of X's dims starting at ``axis``."""
    if x.shape == y.shape or axis in (-1, None):
        return x, y
    if y.dim() > x.dim():
        raise ValueError(f"elementwise: y rank {y.dim()} > x rank {x.dim()}")
    trailing = x.dim() - axis - y.dim()
    if trailing < 0:
        raise ValueError(f"elementwise: bad axis {axis} for shapes "
                         f"{tuple(x.shape)} {tuple(y.shape)}")
    return x, y.reshape(tuple(y.shape) + (1,) * trailing)


@register_op("elementwise_add")
def _elementwise_add(ctx, ins, attrs):
    x, y = _bcast(ins["X"][0], ins["Y"][0], attrs.get("axis", -1))
    return {"Out": x + y}


def _prod(t):
    p = 1
    for v in t:
        p *= v
    return p


@register_op("mul")
def _mul(ctx, ins, attrs):
    """fluid mul_op: flatten x/y to 2-D, then a matrix product (the FC
    primitive; a plain product outside any ported kernel)."""
    x, y = ins["X"][0], ins["Y"][0]
    xn = attrs.get("x_num_col_dims", 1)
    yn = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(_prod(xs[:xn]), _prod(xs[xn:]))
    y2 = y.reshape(_prod(ys[:yn]), _prod(ys[yn:]))
    return {"Out": torch.matmul(x2, y2).reshape(xs[:xn] + ys[yn:])}
