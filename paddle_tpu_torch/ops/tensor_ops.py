"""Tensor ops (counterpart of the ``fill_constant``,
``fill_constant_batch_size_like``, ``uniform_random``,
``gaussian_random``, ``reshape``, ``squeeze``, ``unsqueeze``,
``transpose``, ``concat``, ``split``, ``gather``, ``top_k``,
``argmax`` (``arg_max``, ``max_ids``) and ``one_hot`` lowerings in
``paddle_tpu/ops/tensor_ops.py``).
Random ops draw from a ``torch.Generator`` the executor keeps per op
and places at each step (``ExecContext.generator``); the numbers differ
from JAX's, the distributions do not."""
from __future__ import annotations

import torch

from ..core.registry import register_op
from ..core.types import to_torch_dtype


@register_op("fill_constant")
def _fill_constant(ctx, ins, attrs):
    dt = to_torch_dtype(attrs.get("dtype", "float32"))
    shape = tuple(attrs.get("shape", []))
    return {"Out": torch.full(shape, attrs.get("value", 0.0), dtype=dt,
                              device=ctx.device)}


@register_op("fill_constant_batch_size_like")
def _fill_cbsl(ctx, ins, attrs):
    """The ``shape`` attr with dim ``output_dim_idx`` taken from dim
    ``input_dim_idx`` of Input (a StaticRNN memory's zero start)."""
    ref = ins["Input"][0]
    shape = list(attrs.get("shape", []))
    shape[attrs.get("output_dim_idx", 0)] = \
        ref.shape[attrs.get("input_dim_idx", 0)]
    return {"Out": torch.full(tuple(shape), attrs.get("value", 0.0),
                              dtype=to_torch_dtype(attrs.get("dtype",
                                                             "float32")),
                              device=ref.device)}


@register_op("gaussian_random")
def _gaussian_random(ctx, ins, attrs):
    dt = to_torch_dtype(attrs.get("dtype", "float32"))
    shape = tuple(attrs.get("shape", []))
    out = torch.randn(shape, generator=ctx.generator(), device=ctx.device,
                      dtype=torch.float32)
    out = out * attrs.get("std", 1.0) + attrs.get("mean", 0.0)
    return {"Out": out.to(dt)}


@register_op("uniform_random")
def _uniform_random(ctx, ins, attrs):
    dt = to_torch_dtype(attrs.get("dtype", "float32"))
    shape = tuple(attrs.get("shape", []))
    out = torch.empty(shape, device=ctx.device, dtype=torch.float32)
    out.uniform_(attrs.get("min", -1.0), attrs.get("max", 1.0),
                 generator=ctx.generator())
    return {"Out": out.to(dt)}


@register_op("reshape")
def _reshape(ctx, ins, attrs):
    """fluid reshape: a 0 in ``shape`` copies the input's dim, one -1 is
    inferred.  The layer's ``actual_shape`` is not an input of the op
    (as in the JAX package)."""
    x = ins["X"][0]
    shape = [x.shape[i] if s == 0 else s
             for i, s in enumerate(attrs["shape"])]
    return {"Out": x.reshape(shape)}


@register_op("squeeze")
def _squeeze(ctx, ins, attrs):
    """Drop the size-1 ``axes`` (every size-1 dim when none are given)."""
    x = ins["X"][0]
    axes = attrs.get("axes")
    if not axes:
        return {"Out": x.squeeze()}
    axes = {a % x.dim() for a in axes}
    if any(x.shape[a] != 1 for a in axes):
        raise ValueError(f"squeeze: axes {sorted(axes)} of shape "
                         f"{tuple(x.shape)} are not all of size 1")
    return {"Out": x.reshape([s for i, s in enumerate(x.shape)
                              if i not in axes])}


@register_op("unsqueeze")
def _unsqueeze(ctx, ins, attrs):
    """Insert size-1 dims at ``axes``, positions in the output's rank
    (``jnp.expand_dims``)."""
    x = ins["X"][0]
    rank = x.dim() + len(attrs["axes"])
    axes = sorted(a % rank for a in attrs["axes"])
    shape = list(x.shape)
    for a in axes:
        shape.insert(a, 1)
    return {"Out": x.reshape(shape)}


@register_op("concat")
def _concat(ctx, ins, attrs):
    return {"Out": torch.cat(ins["X"], dim=attrs.get("axis", 0))}


@register_op("split")
def _split(ctx, ins, attrs):
    """Split X along ``axis`` into ``num`` equal parts or into parts of
    the lengths in ``sections`` (``tensor_ops.py:137-150``)."""
    x = ins["X"][0]
    axis = attrs.get("axis", 0)
    sections = attrs.get("sections")
    if sections:
        return {"Out": list(torch.split(x, list(sections), dim=axis))}
    num = attrs["num"]
    if x.shape[axis] % num:
        raise ValueError(f"split: dim {axis} of shape {tuple(x.shape)} "
                         f"does not divide into {num} equal parts")
    return {"Out": list(torch.split(x, x.shape[axis] // num, dim=axis))}


@register_op("gather")
def _gather(ctx, ins, attrs):
    """gather_op: ``jnp.take(X, Index, axis)``, the rows (along ``axis``)
    of X at Index."""
    x, idx = ins["X"][0], ins["Index"][0]
    axis = attrs.get("axis", 0) % x.dim()
    out = torch.index_select(x, axis, idx.reshape(-1).long())
    return {"Out": out.reshape(tuple(x.shape[:axis]) + tuple(idx.shape)
                               + tuple(x.shape[axis + 1:]))}



@register_op("transpose")
def _transpose(ctx, ins, attrs):
    return {"Out": ins["X"][0].permute(*attrs["axis"])}


@register_op("top_k")
def _top_k(ctx, ins, attrs):
    """The k largest along the last dim, descending, with their int64
    indices."""
    vals, idx = torch.topk(ins["X"][0], attrs["k"], dim=-1, largest=True,
                           sorted=True)
    return {"Out": vals, "Indices": idx.to(torch.int64)}


@register_op("argmax", "arg_max", "max_ids")
def _argmax(ctx, ins, attrs):
    """The first maximum's index along ``axis`` (default the last),
    int64."""
    return {"Out": torch.argmax(ins["X"][0], dim=attrs.get("axis", -1))
            .to(torch.int64)}


@register_op("one_hot")
def _one_hot(ctx, ins, attrs):
    """fp32 one-hot rows of ``depth`` for int ids [...] or [..., 1]; an
    id outside [0, depth) gives a zero row, as ``jax.nn.one_hot`` does
    (and no host check, so a captured step can hold it)."""
    x = ins["X"][0]
    if x.dim() >= 2 and x.shape[-1] == 1:
        x = x.squeeze(-1)
    classes = torch.arange(attrs["depth"], device=x.device)
    return {"Out": (x.to(torch.int64).unsqueeze(-1) == classes)
            .to(torch.float32)}

# ---------------------------------------------------------------------------
# Static shape/dtype rules (analysis.shape_infer) — reshape/concat/split etc.
# InferShape analogs of the reference's data-movement ops.
# ---------------------------------------------------------------------------
from ..analysis.shape_infer import (ShapeError, VarInfo,  # noqa: E402
                                    dim_ok, filled_from_attrs, first,
                                    prod_dims, squeeze_ids, unify_dim)
from ..core.registry import register_shape_fn  # noqa: E402

register_shape_fn("fill_constant", "gaussian_random",
                  "uniform_random")(filled_from_attrs())


@register_shape_fn("fill_constant_batch_size_like")
def _fill_cbsl_shape(op, ins, attrs):
    ref = first(ins, "Input")
    shape = list(attrs.get("shape", []))
    in_idx = attrs.get("input_dim_idx", 0)
    out_idx = attrs.get("output_dim_idx", 0)
    if not shape:
        return {"Out": VarInfo(None, attrs.get("dtype", "float32"))}
    if ref.shape is not None:
        if in_idx >= len(ref.shape) or out_idx >= len(shape):
            raise ShapeError(
                f"fill_constant_batch_size_like: dim idx ({in_idx}, "
                f"{out_idx}) out of range for {list(ref.shape)} -> {shape}")
        shape[out_idx] = ref.shape[in_idx]
    else:
        shape[out_idx] = -1
    return {"Out": VarInfo(shape, attrs.get("dtype", "float32"))}


@register_shape_fn("reshape")
def _reshape_shape(op, ins, attrs):
    x = first(ins, "X")
    shape = list(attrs.get("shape", []))
    if x.shape is None or not shape:
        return {"Out": VarInfo(None, x.dtype)}
    for i, s in enumerate(shape):
        if s == 0:
            if i >= len(x.shape):
                raise ShapeError(
                    f"reshape: dim {i} copies input dim but input rank is "
                    f"{len(x.shape)}")
            shape[i] = x.shape[i]
    neg = [i for i, s in enumerate(shape) if s == -1]
    if len(neg) > 1:
        raise ShapeError(f"reshape: more than one -1 in {shape}")
    total = prod_dims(x.shape)
    known = prod_dims([s for i, s in enumerate(shape) if i not in neg])
    if total >= 0 and known >= 0:
        if neg:
            if known == 0 or total % known:
                raise ShapeError(
                    f"reshape: cannot infer -1: {list(x.shape)} "
                    f"({total} elems) -> {shape}")
            shape[neg[0]] = total // known
        elif known != total:
            raise ShapeError(
                f"reshape: element count mismatch: {list(x.shape)} "
                f"({total}) -> {shape} ({known})")
    elif neg:
        shape[neg[0]] = -1
    return {"Out": VarInfo(shape, x.dtype)}


@register_shape_fn("squeeze")
def _squeeze_shape(op, ins, attrs):
    x = first(ins, "X")
    if x.shape is None:
        return {"Out": x}
    axes = attrs.get("axes", None)
    nd = len(x.shape)
    if axes:
        axes = {a % nd for a in axes}
        for a in axes:
            if x.shape[a] not in (-1, 1):
                raise ShapeError(
                    f"squeeze: axis {a} has size {x.shape[a]} != 1 in "
                    f"{list(x.shape)}")
        shape = tuple(d for i, d in enumerate(x.shape) if i not in axes)
    else:
        shape = tuple(d for d in x.shape if d != 1)
    return {"Out": x.with_shape(shape)}


@register_shape_fn("unsqueeze")
def _unsqueeze_shape(op, ins, attrs):
    x = first(ins, "X")
    if x.shape is None:
        return {"Out": x}
    shape = list(x.shape)
    for a in sorted(attrs.get("axes", [])):
        shape.insert(a if a >= 0 else a + len(shape) + 1, 1)
    return {"Out": x.with_shape(shape)}


@register_shape_fn("concat")
def _concat_shape(op, ins, attrs):
    xs = [v for v in ins.get("X", []) if v is not None]
    known = [v for v in xs if v.shape is not None]
    if not known:
        return {"Out": VarInfo(None, xs[0].dtype if xs else None)}
    nd = len(known[0].shape)
    axis = attrs.get("axis", 0) % nd
    shape = list(known[0].shape)
    for v in known[1:]:
        if len(v.shape) != nd:
            raise ShapeError(
                f"concat: rank mismatch {list(known[0].shape)} vs "
                f"{list(v.shape)}")
        for i in range(nd):
            if i != axis and not dim_ok(shape[i], v.shape[i]):
                raise ShapeError(
                    f"concat: non-axis dim {i} differs: "
                    f"{list(known[0].shape)} vs {list(v.shape)}")
            shape[i] = unify_dim(shape[i], v.shape[i]) if i != axis \
                else shape[i]
    if len(known) == len(xs):
        cat = 0
        for v in known:
            if v.shape[axis] < 0:
                cat = -1
                break
            cat += v.shape[axis]
    else:
        cat = -1
    shape[axis] = cat
    return {"Out": VarInfo(shape, known[0].dtype)}


@register_shape_fn("split")
def _split_shape(op, ins, attrs):
    x = first(ins, "X")
    names = op.outputs.get("Out", [])
    if x.shape is None:
        return {"Out": [VarInfo(None, x.dtype)] * len(names)}
    axis = attrs.get("axis", 0) % len(x.shape)
    sections = attrs.get("sections")
    if sections:
        if len(sections) != len(names):
            raise ShapeError(
                f"split: {len(sections)} sections for {len(names)} outputs")
        if x.shape[axis] >= 0 and sum(sections) != x.shape[axis]:
            raise ShapeError(
                f"split: sections {list(sections)} do not sum to dim "
                f"{x.shape[axis]}")
        return {"Out": [x.with_shape(x.shape[:axis] + (s,)
                                     + x.shape[axis + 1:])
                        for s in sections]}
    num = attrs.get("num", len(names))
    if x.shape[axis] >= 0 and num and x.shape[axis] % num:
        raise ShapeError(
            f"split: dim {x.shape[axis]} not divisible into {num} parts")
    part = -1 if x.shape[axis] < 0 else x.shape[axis] // num
    return {"Out": [x.with_shape(x.shape[:axis] + (part,)
                                 + x.shape[axis + 1:])] * len(names)}


@register_shape_fn("gather")
def _gather_shape(op, ins, attrs):
    x, idx = first(ins, "X"), first(ins, "Index")
    if x.shape is None or idx.shape is None:
        return {"Out": VarInfo(None, x.dtype)}
    axis = attrs.get("axis", 0) % len(x.shape)
    # no [N,1]->[N] squeeze: the implementation keeps the index's shape,
    # so a 2-D index really does produce (..., N, 1, ...)
    return {"Out": VarInfo(x.shape[:axis] + idx.shape
                           + x.shape[axis + 1:], x.dtype)}



@register_shape_fn("transpose")
def _transpose_shape(op, ins, attrs):
    x = first(ins, "X")
    perm = attrs.get("axis")
    if x.shape is None or perm is None:
        return {"Out": x}
    if sorted(a % len(x.shape) for a in perm) != list(range(len(x.shape))):
        raise ShapeError(
            f"transpose: axis {list(perm)} is not a permutation of rank "
            f"{len(x.shape)}")
    return {"Out": x.with_shape(tuple(x.shape[a] for a in perm))}


@register_shape_fn("top_k")
def _top_k_shape(op, ins, attrs):
    x = first(ins, "X")
    k = attrs.get("k", 1)
    if x.shape is None:
        return {"Out": x, "Indices": VarInfo(None, "int64")}
    if x.shape[-1] >= 0 and k > x.shape[-1]:
        raise ShapeError(f"top_k: k={k} > last dim {x.shape[-1]}")
    shape = x.shape[:-1] + (k,)
    return {"Out": x.with_shape(shape),
            "Indices": VarInfo(shape, "int64")}


@register_shape_fn("argmax", "arg_max", "max_ids")
def _argmax_shape(op, ins, attrs):
    x = first(ins, "X")
    if x.shape is None:
        return {"Out": VarInfo(None, "int64")}
    axis = attrs.get("axis", -1) % len(x.shape)
    return {"Out": VarInfo(x.shape[:axis] + x.shape[axis + 1:], "int64")}


@register_shape_fn("one_hot")
def _one_hot_shape(op, ins, attrs):
    s = squeeze_ids(first(ins, "X"))
    if s is None:
        return {"Out": VarInfo(None, "float32")}
    return {"Out": VarInfo(s + (attrs["depth"],), "float32")}

# ---------------------------------------------------------------------------
# Sharding-propagation rules (analysis.shard_prop).  reshape keeps the
# batch sharding only when the batch dim survives the reshape; concat
# replicates its concat axis (a sharded concat dim would interleave
# shards).  fill_constant_batch_size_like and split have no rule (blind
# spots, as in the JAX package).
# ---------------------------------------------------------------------------
from ..analysis.shard_prop import (first_in, merge_entry,  # noqa: E402
                                   shard_batch_only, shard_replicated)
from ..core.registry import register_shard_fn  # noqa: E402

register_shard_fn("fill_constant", "gaussian_random",
                  "uniform_random")(shard_replicated("Out"))


@register_shard_fn("reshape")
def _reshape_shard(op, ins, attrs):
    x = first_in(ins, "X")
    if x.spec is None:
        return {}
    new_shape = list(attrs.get("shape", []))
    if not new_shape:
        return {}
    keep_batch = new_shape[0] in (-1, 0) or \
        (x.shape is not None and new_shape[0] == x.shape[0])
    return {"Out": ((x.entry(0),) if keep_batch else (None,))
            + (None,) * (len(new_shape) - 1)}


@register_shard_fn("concat")
def _concat_shard(op, ins, attrs):
    xs = ins.get("X", [])
    if not any(x.spec is not None for x in xs):
        return {}
    nd = next((x.ndim for x in xs if x.ndim is not None), None)
    if nd is None:
        return {}
    axis = attrs.get("axis", 0) % nd
    entries = []
    for i in range(nd):
        if i == axis:
            entries.append(None)
            continue
        e = None
        for x in xs:
            e = merge_entry(e, x.entry(i), f"concat operands dim {i}")
        entries.append(e)
    return {"Out": tuple(entries)}


@register_shard_fn("squeeze", "unsqueeze")
def _rank_change_shard(op, ins, attrs):
    # conservatively keep only the batch-dim sharding (dim 0 survives
    # both ops for the axes>=1 cases the layers emit)
    x = first_in(ins, "X")
    if x.spec is None:
        return {}
    return {"Out": (x.entry(0),)}


@register_shard_fn("transpose")
def _transpose_shard(op, ins, attrs):
    x = first_in(ins, "X")
    perm = attrs.get("axis")
    if x.spec is None or perm is None:
        return {}
    n = len(x.spec)
    return {"Out": tuple(x.entry(a % n) for a in perm)}


# index/selection: batch dim follows X, everything else replicates
# (indices are tiny; the gathered layout is data-driven)
register_shard_fn("gather", "one_hot", "top_k", "argmax", "arg_max",
                  "max_ids")(
    shard_batch_only("X", fallbacks=("Ids",), also=("Indices",)))
