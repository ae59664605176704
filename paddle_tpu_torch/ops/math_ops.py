"""Math ops (counterpart of every lowering in
``paddle_tpu/ops/math_ops.py``: the elementwise family with ``pow`` and
``mod``, ``mul``, ``matmul``, ``sum``, ``mean``, ``scale``, ``minus``,
``cast``, ``clip``, ``clip_by_norm``, ``sign``, ``pow``, ``increment``,
the comparisons and logical ops, the ``reduce_*`` family,
``abs_diff``/``squared_difference``, ``cumsum``, ``isfinite``,
``l2_normalize``/``norm``, and the v1 attention and CTR ops
``conv_shift``, ``interpolation``, ``outer_prod``,
``factorization_machine``, ``scale_sub_region``; and
``squared_l2_norm`` of ``paddle_tpu/ops/loss_ops.py``).

``abs_diff`` squares the difference, as the JAX package's does (one
lowering for both names; ROADMAP Queue C)."""
from __future__ import annotations

import torch

from ..core.registry import register_op
from ..core.types import to_torch_dtype


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
register_op("elementwise_pow")(_elementwise(torch.pow))
# jnp.mod is a floor modulo (the result takes the divisor's sign)
register_op("elementwise_mod")(_elementwise(torch.remainder))


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


@register_op("cast")
def _cast(ctx, ins, attrs):
    dt = to_torch_dtype(attrs.get("out_dtype", attrs.get("dtype",
                                                          "float32")))
    return {"Out": ins["X"][0].to(dt)}


@register_op("pow")
def _pow(ctx, ins, attrs):
    return {"Out": torch.pow(ins["X"][0], attrs.get("factor", 1.0))}


@register_op("minus")
def _minus(ctx, ins, attrs):
    return {"Out": ins["X"][0] - ins["Y"][0]}


def _compare(fn):
    def impl(ctx, ins, attrs):
        x, y = _bcast(ins["X"][0], ins["Y"][0], attrs.get("axis", -1))
        return {"Out": fn(x, y)}
    return impl


register_op("equal")(_compare(torch.eq))
register_op("not_equal")(_compare(torch.ne))
register_op("less_than")(_compare(torch.lt))
register_op("less_equal")(_compare(torch.le))
register_op("greater_than")(_compare(torch.gt))
register_op("greater_equal")(_compare(torch.ge))


def _logical(fn, unary=False):
    def impl(ctx, ins, attrs):
        if unary:
            return {"Out": fn(ins["X"][0].bool())}
        return {"Out": fn(ins["X"][0].bool(), ins["Y"][0].bool())}
    return impl


register_op("logical_and")(_logical(torch.logical_and))
register_op("logical_or")(_logical(torch.logical_or))
register_op("logical_xor")(_logical(torch.logical_xor))
register_op("logical_not")(_logical(torch.logical_not, unary=True))


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



@register_op("abs_diff", "squared_difference")
def _sq_diff(ctx, ins, attrs):
    d = ins["X"][0] - ins["Y"][0]
    return {"Out": d * d}


@register_op("cumsum")
def _cumsum(ctx, ins, attrs):
    """The running sum along ``axis`` (default the last); an integer sum
    keeps X's dtype, as ``jnp.cumsum``'s does."""
    x = ins["X"][0]
    dt = None if x.is_floating_point() or x.dtype == torch.bool else x.dtype
    return {"Out": torch.cumsum(x, dim=attrs.get("axis", -1), dtype=dt)}


@register_op("isfinite")
def _isfinite(ctx, ins, attrs):
    """One bool: every element of X is finite (kept on the device)."""
    return {"Out": torch.isfinite(ins["X"][0]).all()}


@register_op("l2_normalize", "norm")
def _l2_normalize(ctx, ins, attrs):
    """X over its L2 norm along ``axis``, the norm floored at
    ``epsilon``."""
    x = ins["X"][0]
    norm = torch.sqrt(torch.sum(x * x, dim=attrs.get("axis", -1),
                                keepdim=True))
    return {"Out": x / torch.clamp_min(norm, attrs.get("epsilon", 1e-12))}


@register_op("conv_shift")
def _conv_shift(ctx, ins, attrs):
    """Circular correlation (ConvShiftLayer, an NTM attention shift):
    X [B, M], Y [B, N] with N odd, Out[b, i] = sum_j
    X[b, (i + j - N // 2) % M] * Y[b, j], summed in j's order."""
    x, y = ins["X"][0], ins["Y"][0]
    n = y.shape[1]
    out = 0
    for j in range(n):
        out = out + torch.roll(x, n // 2 - j, dims=1) * y[:, j:j + 1]
    return {"Out": out}


@register_op("interpolation")
def _interpolation(ctx, ins, attrs):
    """W * X + (1 - W) * Y with one weight a row, W [B, 1]."""
    w, x, y = ins["W"][0], ins["X"][0], ins["Y"][0]
    w = w.reshape((-1,) + (1,) * (x.dim() - 1))
    return {"Out": w * x + (1.0 - w) * y}


@register_op("outer_prod")
def _outer_prod(ctx, ins, attrs):
    """Each row's outer product X[b] Y[b]^T, flattened to [B, M * N]."""
    x, y = ins["X"][0], ins["Y"][0]
    return {"Out": (x[:, :, None] * y[:, None, :]).reshape(x.shape[0], -1)}


@register_op("factorization_machine")
def _factorization_machine(ctx, ins, attrs):
    """The second-order term of a factorization machine
    (FactorizationMachineLayer): 0.5 * sum_k((X V)_k^2 - (X^2 V^2)_k),
    [B, 1]."""
    x, v = ins["X"][0], ins["V"][0]
    xv = x @ v
    return {"Out": 0.5 * torch.sum(xv * xv - (x * x) @ (v * v), dim=1,
                                   keepdim=True)}


@register_op("scale_sub_region")
def _scale_sub_region(ctx, ins, attrs):
    """X [B, C, H, W] times ``value`` inside each sample's box, Indices
    [B, 6] = (c1, c2, h1, h2, w1, w2), 1-based and inclusive."""
    x, idx = ins["X"][0], ins["Indices"][0].to(torch.int64)
    B, C, H, W = x.shape
    i = idx.reshape(B, 6, 1, 1, 1) - 1

    def within(n, lo, hi, shape):
        r = torch.arange(n, device=x.device).reshape(shape)
        return (r >= i[:, lo]) & (r <= i[:, hi])

    mask = within(C, 0, 1, (1, C, 1, 1)) & within(H, 2, 3, (1, 1, H, 1)) \
        & within(W, 4, 5, (1, 1, 1, W))
    return {"Out": torch.where(mask, x * attrs.get("value", 1.0), x)}


# -- reductions (reduce_op.cc: dim/keep_dim/reduce_all attrs) ---------------
def _reduce(fn):
    def impl(ctx, ins, attrs):
        x = ins["X"][0]
        if attrs.get("reduce_all", False):
            axis = tuple(range(x.dim()))
        else:
            dim = attrs.get("dim", [0])
            axis = tuple(dim) if isinstance(dim, (list, tuple)) \
                else (int(dim),)
            axis = tuple(d % x.dim() for d in axis)
        return {"Out": fn(x, axis, attrs.get("keep_dim", False))}
    return impl


def _reduce_sum(x, axis, keep):
    # an integer sum keeps its dtype, as jnp.sum's does
    out = torch.sum(x, dim=axis, keepdim=keep)
    return out if x.is_floating_point() else out.to(x.dtype)


def _reduce_mean(x, axis, keep):
    # jnp.mean of integers is fp32
    if not x.is_floating_point():
        x = x.to(torch.float32)
    return torch.mean(x, dim=axis, keepdim=keep)


def _reduce_prod(x, axis, keep):
    out = x
    for d in sorted(axis, reverse=True):
        out = torch.prod(out, dim=d, keepdim=keep)
    return out if x.is_floating_point() else out.to(x.dtype)


# max and min spread a gradient evenly over tied maxima, as jnp's do
register_op("reduce_sum")(_reduce(_reduce_sum))
register_op("reduce_mean")(_reduce(_reduce_mean))
register_op("reduce_max")(_reduce(
    lambda x, axis, keep: torch.amax(x, dim=axis, keepdim=keep)))
register_op("reduce_min")(_reduce(
    lambda x, axis, keep: torch.amin(x, dim=axis, keepdim=keep)))
register_op("reduce_prod")(_reduce(_reduce_prod))

# ---------------------------------------------------------------------------
# Static shape/dtype rules (analysis.shape_infer) — the InferShape analogs
# of elementwise_op.h / mul_op.cc / matmul_op.cc / squared_l2_norm_op.cc.
# ---------------------------------------------------------------------------
from ..analysis.shape_infer import (ShapeError, VarInfo, dim_ok,  # noqa: E402
                                    elementwise, first, prod_dims,
                                    reduce_rule, same_as, shapes_compatible,
                                    unify_dim)
from ..core.registry import register_shape_fn  # noqa: E402

register_shape_fn(
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_pow", "elementwise_max",
    "elementwise_min", "elementwise_mod",
)(elementwise())
register_shape_fn(
    "equal", "not_equal", "less_than", "less_equal", "greater_than",
    "greater_equal",
)(elementwise(dtype="bool"))
register_shape_fn("logical_and", "logical_or", "logical_xor")(
    elementwise(dtype="bool"))
register_shape_fn("logical_not")(same_as("X", dtype="bool"))
register_shape_fn(
    "scale", "minus", "clip", "clip_by_norm", "sign", "pow", "increment",
    "cumsum", "l2_normalize", "norm", "interpolation", "scale_sub_region",
)(same_as("X"))
register_shape_fn("abs_diff", "squared_difference")(elementwise())
register_shape_fn("reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
                  "reduce_prod")(reduce_rule())


@register_shape_fn("mul")
def _mul_shape(op, ins, attrs):
    """mul_op.cc InferShape: flatten to 2-D at the num_col_dims splits and
    check the contraction."""
    x, y = first(ins, "X"), first(ins, "Y")
    if x.shape is None or y.shape is None:
        return {"Out": VarInfo(None, x.dtype)}
    xn = attrs.get("x_num_col_dims", 1)
    yn = attrs.get("y_num_col_dims", 1)
    if not 0 < xn < len(x.shape) + 1 or not 0 < yn < len(y.shape) + 1:
        raise ShapeError(
            f"mul: num_col_dims ({xn}, {yn}) out of range for ranks "
            f"{len(x.shape)}, {len(y.shape)}")
    k1, k2 = prod_dims(x.shape[xn:]), prod_dims(y.shape[:yn])
    if not dim_ok(k1, k2):
        raise ShapeError(
            f"mul: contraction mismatch {list(x.shape)}[{xn}:] ({k1}) vs "
            f"{list(y.shape)}[:{yn}] ({k2})")
    return {"Out": VarInfo(x.shape[:xn] + y.shape[yn:], x.dtype)}


@register_shape_fn("matmul")
def _matmul_shape(op, ins, attrs):
    x, y = first(ins, "X"), first(ins, "Y")
    if x.shape is None or y.shape is None:
        return {"Out": VarInfo(None, x.dtype)}
    xs, ys = list(x.shape), list(y.shape)
    if len(xs) < 1 or len(ys) < 1:
        raise ShapeError("matmul: operands must have rank >= 1")
    if attrs.get("transpose_X", False) and len(xs) > 1:
        xs[-1], xs[-2] = xs[-2], xs[-1]
    if attrs.get("transpose_Y", False) and len(ys) > 1:
        ys[-1], ys[-2] = ys[-2], ys[-1]
    if len(xs) == 1:
        xs = [1] + xs
    if len(ys) == 1:
        ys = ys + [1]
    if not dim_ok(xs[-1], ys[-2]):
        raise ShapeError(
            f"matmul: contraction mismatch {list(x.shape)} @ "
            f"{list(y.shape)} ({xs[-1]} vs {ys[-2]})")
    batch = []
    for i in range(2, max(len(xs), len(ys)))[::-1]:
        bx = xs[-i - 1] if i < len(xs) else None
        by = ys[-i - 1] if i < len(ys) else None
        if bx is not None and by is not None:
            if not (dim_ok(bx, by) or bx == 1 or by == 1):
                raise ShapeError(
                    f"matmul: batch dims mismatch {list(x.shape)} vs "
                    f"{list(y.shape)}")
            # broadcast with -1-safe semantics: a 1 yields the other
            # side verbatim (even if unknown); -1 never collapses to 1
            if bx == 1:
                batch.append(by)
            elif by == 1:
                batch.append(bx)
            else:
                batch.append(unify_dim(bx, by))
        else:
            batch.append(bx if bx is not None else by)
    shape = tuple(batch) + (xs[-2], ys[-1])
    if x.ndim == 1:
        shape = shape[:-2] + (shape[-1],)
    elif y.ndim == 1:
        shape = shape[:-1]
    return {"Out": VarInfo(shape, x.dtype)}


@register_shape_fn("sum")
def _sum_shape(op, ins, attrs):
    """sum_op: every input must carry the same shape."""
    xs = ins.get("X", [])
    out = xs[0] if xs else None
    for x in xs[1:]:
        if not shapes_compatible(out.shape, x.shape):
            raise ShapeError(
                f"sum: operand shapes differ: {list(out.shape)} vs "
                f"{list(x.shape)}")
    return {"Out": out}


@register_shape_fn("mean")
def _mean_shape(op, ins, attrs):
    x = first(ins, "X")
    return {"Out": x.with_shape(())}


@register_shape_fn("cast")
def _cast_shape(op, ins, attrs):
    x = first(ins, "X")
    return {"Out": x.with_dtype(
        attrs.get("out_dtype", attrs.get("dtype", "float32")))}


@register_shape_fn("squared_l2_norm")
def _squared_l2_norm_shape(op, ins, attrs):
    return {"Out": VarInfo((1,), first(ins, "X").dtype)}


@register_shape_fn("isfinite")
def _isfinite_shape(op, ins, attrs):
    return {"Out": VarInfo((), "bool")}


@register_shape_fn("conv_shift")
def _conv_shift_shape(op, ins, attrs):
    x, y = first(ins, "X"), first(ins, "Y")
    if x.shape is not None and y.shape is not None and \
            len(y.shape) == 2 and y.shape[1] >= 0 and y.shape[1] % 2 == 0:
        raise ShapeError(f"conv_shift: Y width must be odd, got "
                         f"{y.shape[1]}")
    return {"Out": x}


@register_shape_fn("outer_prod")
def _outer_prod_shape(op, ins, attrs):
    x, y = first(ins, "X"), first(ins, "Y")
    if x.shape is None or y.shape is None:
        return {"Out": VarInfo(None, x.dtype)}
    if len(x.shape) != 2 or len(y.shape) != 2:
        raise ShapeError("outer_prod: X and Y must be rank-2")
    m, n = x.shape[1], y.shape[1]
    return {"Out": VarInfo((x.shape[0], -1 if m < 0 or n < 0 else m * n),
                           x.dtype)}


@register_shape_fn("factorization_machine")
def _fm_shape(op, ins, attrs):
    x, v = first(ins, "X"), first(ins, "V")
    if x.shape is not None and v.shape is not None and \
            not dim_ok(x.shape[-1], v.shape[0]):
        raise ShapeError(
            f"factorization_machine: X feature dim {x.shape[-1]} vs V rows "
            f"{v.shape[0]}")
    b = x.shape[0] if x.shape is not None else -1
    return {"Out": VarInfo((b, 1), x.dtype)}


# ---------------------------------------------------------------------------
# Sharding-propagation rules (analysis.shard_prop).  mul carries the
# Megatron contract: row dims follow X, col dims follow Y, and a sharded
# contraction must match on both sides (the row-parallel all-reduce).
# ---------------------------------------------------------------------------
from ..analysis.shard_prop import (merge_specs,  # noqa: E402
                                   shard_elementwise, shard_matmul,
                                   shard_mul, shard_reduce,
                                   shard_replicated, shard_same_as)
from ..core.registry import register_shard_fn  # noqa: E402

register_shard_fn(
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_pow", "elementwise_max",
    "elementwise_min", "elementwise_mod", "equal", "not_equal",
    "less_than", "less_equal", "greater_than", "greater_equal",
    "logical_and", "logical_or", "logical_xor", "abs_diff",
    "squared_difference",
)(shard_elementwise())
register_shard_fn(
    "logical_not", "scale", "minus", "clip", "clip_by_norm", "sign",
    "pow", "increment", "cumsum", "l2_normalize", "norm",
    "interpolation", "scale_sub_region", "cast",
)(shard_same_as("X"))
register_shard_fn("mul")(shard_mul())
register_shard_fn("matmul")(shard_matmul())
register_shard_fn("mean", "squared_l2_norm",
                  "isfinite")(shard_replicated("Out"))
register_shard_fn("reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
                  "reduce_prod")(shard_reduce())


@register_shard_fn("sum")
def _sum_shard(op, ins, attrs):
    spec = None
    for x in ins.get("X", []):
        spec = merge_specs(spec, x.spec, "sum operands")
    return {} if spec is None else {"Out": spec}
