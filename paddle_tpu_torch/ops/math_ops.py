"""Math ops of the ported paths (counterpart of the elementwise family,
``mul``, ``matmul``, ``mean``, ``scale``, ``increment``, ``sum``,
``sign``, ``clip``, ``clip_by_norm`` in ``paddle_tpu/ops/math_ops.py``
and ``squared_l2_norm`` in ``paddle_tpu/ops/loss_ops.py``)."""
from __future__ import annotations

import torch

from ..core.registry import register_op


def _bcast(x, y, axis: int):
    """fluid trailing-axis broadcast: Y's shape matches a contiguous run
    of X's dims starting at ``axis``.  Decided on ranks and ``axis``
    alone, never on sizes: comparing sizes would fix a symbolic batch
    under ``torch.export``."""
    if axis in (-1, None) or y.dim() == x.dim():
        return x, y
    if y.dim() > x.dim():
        raise ValueError(f"elementwise: y rank {y.dim()} > x rank {x.dim()}")
    trailing = x.dim() - axis - y.dim()
    if trailing < 0:
        raise ValueError(f"elementwise: bad axis {axis} for shapes "
                         f"{tuple(x.shape)} {tuple(y.shape)}")
    return x, y.reshape(tuple(y.shape) + (1,) * trailing)


def _elementwise(fn):
    def impl(ctx, ins, attrs):
        x, y = _bcast(ins["X"][0], ins["Y"][0], attrs.get("axis", -1))
        return {"Out": fn(x, y)}
    return impl


register_op("elementwise_add")(_elementwise(torch.add))
register_op("elementwise_sub")(_elementwise(torch.sub))
register_op("elementwise_mul")(_elementwise(torch.mul))
register_op("elementwise_div")(_elementwise(torch.div))
register_op("elementwise_max")(_elementwise(torch.maximum))
register_op("elementwise_min")(_elementwise(torch.minimum))


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


@register_op("matmul")
def _matmul(ctx, ins, attrs):
    """matmul_op semantics (``math_ops.py:76-89``): optional transposes of
    the last two dims, batched stacks, ``alpha``; a plain product, as
    XLA did it."""
    x, y = ins["X"][0], ins["Y"][0]
    if attrs.get("transpose_X", False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False) and y.dim() > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": out}


@register_op("sum")
def _sum(ctx, ins, attrs):
    """sum_op: add N tensors."""
    xs = ins["X"]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": out}


@register_op("mean")
def _mean(ctx, ins, attrs):
    """mean_op: full reduction to a scalar (loss averaging)."""
    return {"Out": ins["X"][0].mean()}


@register_op("scale")
def _scale(ctx, ins, attrs):
    x = ins["X"][0]
    s = attrs.get("scale", 1.0)
    b = attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        return {"Out": x * s + b}
    return {"Out": (x + b) * s}


@register_op("increment")
def _increment(ctx, ins, attrs):
    x = ins["X"][0]
    # a device fill, not a host-to-device copy (capturable); in x's
    # dtype, integer counters too
    step = torch.full((), attrs.get("step", 1.0), dtype=x.dtype,
                      device=x.device)
    return {"Out": x + step}


@register_op("sign")
def _sign(ctx, ins, attrs):
    return {"Out": torch.sign(ins["X"][0])}


@register_op("clip")
def _clip(ctx, ins, attrs):
    return {"Out": torch.clamp(ins["X"][0], attrs["min"], attrs["max"])}


@register_op("clip_by_norm")
def _clip_by_norm(ctx, ins, attrs):
    x = ins["X"][0]
    max_norm = attrs["max_norm"]
    norm = torch.sqrt(torch.sum(x * x))
    scale = torch.where(norm > max_norm,
                        max_norm / torch.clamp_min(norm, 1e-12),
                        torch.ones_like(norm))
    return {"Out": x * scale.to(x.dtype)}


@register_op("squared_l2_norm")
def _squared_l2_norm(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": torch.sum(x * x).reshape(1)}
