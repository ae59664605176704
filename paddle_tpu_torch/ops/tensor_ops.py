"""Tensor ops (counterpart of the lowerings in
``paddle_tpu/ops/tensor_ops.py``: the creation ops ``fill_constant``,
``fill_constant_batch_size_like``, ``fill_zeros_like``,
``fill_any_like``, ``assign``, ``assign_value``, ``shape``, ``range``,
the random ops ``uniform_random``, ``gaussian_random``,
``truncated_gaussian_random``, ``sampling_id``, ``shuffle``, the layout
ops ``reshape``, ``squeeze``, ``unsqueeze``, ``transpose``, ``concat``,
``split``, ``pad``, ``crop``, ``expand``, ``tile``, ``slice``,
``flatten``, ``stack``, ``unstack``, ``reverse``, and the index ops
``gather``, ``scatter``, ``multiplex``, ``top_k``, ``argmax``
(``arg_max``, ``max_ids``), ``argsort``, ``one_hot``, ``where``
(``select``), ``is_empty``, with ``feed``/``fetch``).

Random ops draw from a ``torch.Generator`` the executor keeps per op
and places at each step (``ExecContext.generator``); the numbers differ
from JAX's, the distributions do not.  They are built from draws a CUDA
graph can hold (``uniform_``, ``rand``): ``sampling_id`` is a Gumbel-max
draw, as ``jax.random.categorical``, and ``shuffle`` sorts random keys,
in place of ``torch.multinomial`` and ``torch.randperm``.

No op reads a tensor back to the host, and none copies host memory
inside a captured step: ``shape`` and ``assign_value`` take their
constants from :func:`_constant`, copied to the card once by a step that
is not captured; ``is_empty`` is a fill."""
from __future__ import annotations

import math
import weakref

import torch

from ..core.registry import register_op
from ..core.types import to_torch_dtype
from .generation_ops import top_k as _tie_exact_top_k


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
    """The k largest along the last dim, descending, equal values in
    ascending index order as ``lax.top_k`` puts them, with their int64
    indices.  fp32, bf16 and fp16 rank by ``generation_ops.top_k``'s
    tie-exact key (the half types widened to fp32, which is exact);
    other dtypes by a stable descending sort.  The values are gathered
    from X in its own dtype."""
    x, k = ins["X"][0], attrs["k"]
    if x.dtype in (torch.float32, torch.bfloat16, torch.float16):
        _, idx = _tie_exact_top_k(x.float(), k)
    else:
        idx = torch.sort(x, dim=-1, descending=True,
                         stable=True).indices[..., :k]
    return {"Out": torch.gather(x, -1, idx), "Indices": idx}


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


@register_op("feed", "fetch")
def _feed_fetch(ctx, ins, attrs):
    """Kept for program parity: the executor feeds and fetches by name,
    so these pass X through (or do nothing)."""
    if ins.get("X"):
        return {"Out": ins["X"][0]}
    return {}


@register_op("assign")
def _assign(ctx, ins, attrs):
    return {"Out": ins["X"][0]}


@register_op("fill_zeros_like")
def _fill_zeros_like(ctx, ins, attrs):
    return {"Out": torch.zeros_like(ins["X"][0])}


@register_op("fill_any_like")
def _fill_any_like(ctx, ins, attrs):
    """X's shape and dtype filled with ``value``."""
    return {"Out": torch.full_like(ins["X"][0], attrs.get("value", 0.0))}


# the constants of shape and assign_value on a card, by op: a step that is
# not captured copies them from the host once; a captured step clones them
# (a copy from pageable host memory cannot be captured)
_CONSTANTS = weakref.WeakKeyDictionary()


def _constant(ctx, values, dtype, device):
    """A fresh tensor of the host ``values`` on ``device``, with no copy
    from the host inside a capture."""
    if device.type != "cuda":
        return torch.tensor(values, dtype=dtype, device=device)
    key = (str(device), dtype, repr(values))
    made = _CONSTANTS.setdefault(ctx.op, {}) if ctx.op is not None else {}
    t = made.get(key)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"paddle_tpu_torch: the constant {values!r} of op "
                f"{getattr(ctx.op, 'type', None)!r} was not made before "
                f"the capture (a step runs uncaptured first)")
        t = made[key] = torch.tensor(values, dtype=dtype).to(device)
    return t.clone()


@register_op("shape")
def _shape(ctx, ins, attrs):
    """X's dims as an int64 vector (int32 in the JAX package, which has
    no int64 without x64)."""
    x = ins["X"][0]
    return {"Out": _constant(ctx, list(x.shape), torch.int64, x.device)}


@register_op("assign_value")
def _assign_value(ctx, ins, attrs):
    """The ``values`` attr as a tensor of ``dtype``, reshaped to
    ``shape`` if given."""
    out = _constant(ctx, attrs["values"],
                    to_torch_dtype(attrs.get("dtype", "float32")),
                    ctx.device)
    if attrs.get("shape"):
        out = out.reshape(tuple(attrs["shape"]))
    return {"Out": out}


@register_op("range")
def _range(ctx, ins, attrs):
    """``jnp.arange(start, end, step)`` in ``dtype`` (int64 by default)."""
    return {"Out": torch.arange(attrs["start"], attrs["end"],
                                attrs.get("step", 1),
                                dtype=to_torch_dtype(attrs.get("dtype",
                                                               "int64")),
                                device=ctx.device)}


# jax.random.truncated_normal(key, -2, 2): a uniform draw between the
# normal CDF's values at the cut points, mapped through the inverse CDF,
# clipped inside the cut
_TRUNC = 2.0
_ERF_CUT = math.erf(_TRUNC / math.sqrt(2.0))


@register_op("truncated_gaussian_random")
def _truncated_gaussian_random(ctx, ins, attrs):
    """A normal of ``mean`` and ``std`` cut at 2 std, drawn by the
    inverse CDF of a uniform draw."""
    dt = to_torch_dtype(attrs.get("dtype", "float32"))
    shape = tuple(attrs.get("shape", []))
    u = torch.empty(shape, device=ctx.device, dtype=torch.float32)
    u.uniform_(-_ERF_CUT, _ERF_CUT, generator=ctx.generator())
    edge = math.nextafter(_TRUNC, 0.0)
    z = torch.clamp(math.sqrt(2.0) * torch.erfinv(u), -edge, edge)
    return {"Out": (z * attrs.get("std", 1.0) + attrs.get("mean", 0.0))
            .to(dt)}


@register_op("sampling_id")
def _sampling_id(ctx, ins, attrs):
    """One int64 id a row of the [B, V] probabilities X, drawn from
    log(clip(X, 1e-20)) by Gumbel-max (``jax.random.categorical``'s
    draw): argmax of the log-probabilities plus -log(-log(u)), u uniform
    in [tiny, 1)."""
    logp = torch.log(torch.clamp_min(ins["X"][0].float(), 1e-20))
    u = torch.empty_like(logp)
    u.uniform_(torch.finfo(torch.float32).tiny, 1.0,
               generator=ctx.generator())
    return {"Out": torch.argmax(logp - torch.log(-torch.log(u)), dim=-1)}


@register_op("shuffle")
def _shuffle(ctx, ins, attrs):
    """X's rows (axis 0) in a random order: the order that sorts fp64
    uniform keys, one a row."""
    x = ins["X"][0]
    keys = torch.rand(x.shape[0], generator=ctx.generator(),
                      dtype=torch.float64, device=x.device)
    return {"Out": x.index_select(0, torch.argsort(keys))}


@register_op("pad")
def _pad(ctx, ins, attrs):
    """Constant padding; ``paddings`` = [before0, after0, before1, ...]
    in dim order."""
    x, p = ins["X"][0], attrs["paddings"]
    pads = []
    for i in reversed(range(x.dim())):
        pads += [p[2 * i], p[2 * i + 1]]
    return {"Out": torch.nn.functional.pad(
        x, pads, value=attrs.get("pad_value", 0.0))}


@register_op("crop")
def _crop(ctx, ins, attrs):
    """The window at ``offsets`` of size ``shape``; a negative size is a
    symbolic dim (a batch of -1) and keeps the axis to its end."""
    x = ins["X"][0]
    return {"Out": x[tuple(slice(o, o + s if s >= 0 else None)
                           for o, s in zip(attrs["offsets"],
                                           attrs["shape"]))]}


def _tile(x, times):
    """``jnp.tile``: fewer reps than dims tile the trailing dims, more
    reps than dims add leading dims."""
    times = [1] * (x.dim() - len(times)) + list(times)
    return x.repeat(times)


@register_op("expand")
def _expand(ctx, ins, attrs):
    """Each dim tiled ``expand_times`` times (``jnp.tile``: copies, not a
    broadcast view)."""
    return {"Out": _tile(ins["X"][0], attrs["expand_times"])}


@register_op("tile")
def _tile_op(ctx, ins, attrs):
    return {"Out": _tile(ins["X"][0], attrs["repeat_times"])}


@register_op("slice")
def _slice(ctx, ins, attrs):
    """Static [start, end) ranges along ``axes``, Python's clamping; the
    input slot is ``Input`` (fluid's) or ``X``."""
    x = (ins.get("Input") or ins.get("X"))[0]
    sl = [slice(None)] * x.dim()
    for ax, st, en in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        sl[ax] = slice(st, en)
    return {"Out": x[tuple(sl)]}


@register_op("scatter")
def _scatter(ctx, ins, attrs):
    """Rows of X at ``Ids`` replaced by the rows of ``Updates``
    (``overwrite``, the default; of two updates of one row the later
    wins, as the JAX package's run does) or added to them.  Both ways are
    deterministic on a card: an overwrite gathers each row's last update,
    an accumulation is ``index_put_``'s sorted sum."""
    x = ins["X"][0]
    upd = ins["Updates"][0].to(x.dtype)
    ids = ins["Ids"][0].reshape(-1).to(torch.int64)
    if not attrs.get("overwrite", True):
        return {"Out": x.index_put((ids,), upd, accumulate=True)}
    pos = torch.arange(ids.numel(), device=x.device)
    last = torch.full((x.shape[0],), -1, dtype=torch.int64,
                      device=x.device).scatter_reduce(0, ids, pos, "amax")
    hit = (last >= 0).reshape((-1,) + (1,) * (x.dim() - 1))
    return {"Out": torch.where(hit, upd.index_select(0, last.clamp_min(0)),
                               x)}


@register_op("multiplex")
def _multiplex(ctx, ins, attrs):
    """Row i of candidate ``Ids[i]`` of the X list."""
    ids = ins["Ids"][0].reshape(-1).to(torch.int64)
    stack = torch.stack(ins["X"], dim=0)
    return {"Out": stack[ids, torch.arange(stack.shape[1],
                                           device=stack.device)]}


@register_op("argsort")
def _argsort(ctx, ins, attrs):
    """A stable sort along ``axis``: equal values keep their index order,
    ascending or ``descending`` (as ``jnp.argsort``); int64 Indices."""
    out, idx = torch.sort(ins["X"][0], dim=attrs.get("axis", -1),
                          descending=attrs.get("descending", False),
                          stable=True)
    return {"Out": out, "Indices": idx}


@register_op("flatten")
def _flatten(ctx, ins, attrs):
    """[prod(dims[:axis]), prod(dims[axis:])]."""
    x = ins["X"][0]
    return {"Out": x.reshape(math.prod(x.shape[:attrs.get("axis", 1)]), -1)}


@register_op("stack")
def _stack(ctx, ins, attrs):
    return {"Out": torch.stack(ins["X"], dim=attrs.get("axis", 0))}


@register_op("unstack")
def _unstack(ctx, ins, attrs):
    return {"Y": list(torch.unbind(ins["X"][0], dim=attrs.get("axis", 0)))}


@register_op("where", "select")
def _where(ctx, ins, attrs):
    """X where Condition holds, else Y (the three broadcast)."""
    return {"Out": torch.where(ins["Condition"][0].bool(), ins["X"][0],
                               ins["Y"][0])}


@register_op("is_empty")
def _is_empty(ctx, ins, attrs):
    """A bool scalar: X has no elements (known from its shape)."""
    x = ins["X"][0]
    return {"Out": torch.full((), x.numel() == 0, dtype=torch.bool,
                              device=x.device)}


@register_op("reverse")
def _reverse(ctx, ins, attrs):
    axes = attrs.get("axis", [0])
    if not isinstance(axes, (list, tuple)):
        axes = [axes]
    return {"Out": torch.flip(ins["X"][0], dims=list(axes))}

# ---------------------------------------------------------------------------
# Static shape/dtype rules (analysis.shape_infer) — reshape/concat/split etc.
# InferShape analogs of the reference's data-movement ops.
# ---------------------------------------------------------------------------
from ..analysis.shape_infer import (ShapeError, VarInfo,  # noqa: E402
                                    dim_ok, filled_from_attrs, first,
                                    numpy_broadcast, passthrough,
                                    prod_dims, same_as, shapes_compatible,
                                    squeeze_ids, unify_dim)
from ..core.registry import register_shape_fn  # noqa: E402

register_shape_fn("feed", "fetch")(passthrough("X"))
register_shape_fn("assign", "fill_zeros_like", "fill_any_like", "shuffle",
                  "reverse", "scatter")(same_as("X"))
register_shape_fn("fill_constant", "gaussian_random", "uniform_random",
                  "truncated_gaussian_random")(filled_from_attrs())


@register_shape_fn("where", "select")
def _where_shape(op, ins, attrs):
    # the three operands broadcast
    cond, x, y = first(ins, "Condition"), first(ins, "X"), first(ins, "Y")
    if x.shape is None or y.shape is None or cond.shape is None:
        return {"Out": VarInfo(None, x.dtype)}
    shape = numpy_broadcast(numpy_broadcast(cond.shape, x.shape,
                                            "where Condition/X"),
                            y.shape, "where X/Y")
    return {"Out": VarInfo(shape, x.dtype)}


@register_shape_fn("shape")
def _shape_shape(op, ins, attrs):
    x = first(ins, "X")
    nd = -1 if x.shape is None else len(x.shape)
    return {"Out": VarInfo((nd,), "int64")}


@register_shape_fn("assign_value")
def _assign_value_shape(op, ins, attrs):
    import numpy as _np
    dt = attrs.get("dtype", "float32")
    if attrs.get("shape"):
        return {"Out": VarInfo(tuple(attrs["shape"]), dt)}
    vals = attrs.get("values")
    if vals is None:
        return {"Out": VarInfo(None, dt)}
    return {"Out": VarInfo(_np.shape(vals), dt)}


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


@register_shape_fn("pad")
def _pad_shape(op, ins, attrs):
    x = first(ins, "X")
    p = attrs.get("paddings")
    if x.shape is None or p is None:
        return {"Out": x}
    if len(p) != 2 * len(x.shape):
        raise ShapeError(
            f"pad: {len(p)} padding entries for rank {len(x.shape)}")
    shape = tuple(d if d < 0 else d + p[2 * i] + p[2 * i + 1]
                  for i, d in enumerate(x.shape))
    return {"Out": x.with_shape(shape)}


@register_shape_fn("crop")
def _crop_shape(op, ins, attrs):
    x = first(ins, "X")
    shape = attrs.get("shape")
    if shape is None:
        return {"Out": VarInfo(None, x.dtype)}
    offsets = attrs.get("offsets") or (0,) * len(shape)
    if x.shape is not None:
        # a negative size keeps to the end: the dim is input minus offset
        # (symbolic when the input's is)
        out = tuple(
            (x.shape[i] - offsets[i] if x.shape[i] >= 0 else -1)
            if s < 0 else s
            for i, s in enumerate(shape))
    else:
        out = tuple(s if s >= 0 else -1 for s in shape)
    return {"Out": VarInfo(out, x.dtype)}


@register_shape_fn("expand")
def _expand_shape(op, ins, attrs):
    return _tile_like(first(ins, "X"), attrs.get("expand_times"))


@register_shape_fn("tile")
def _tile_shape(op, ins, attrs):
    return _tile_like(first(ins, "X"), attrs.get("repeat_times"))


def _tile_like(x, times):
    if x.shape is None or times is None:
        return {"Out": VarInfo(None, x.dtype)}
    times = list(times)
    if len(times) < len(x.shape):
        times = [1] * (len(x.shape) - len(times)) + times
    shape = [1] * (len(times) - len(x.shape)) + list(x.shape)
    out = tuple(d if d < 0 else d * t for d, t in zip(shape, times))
    return {"Out": VarInfo(out, x.dtype)}


@register_shape_fn("slice")
def _slice_shape(op, ins, attrs):
    x = first(ins, "Input") if ins.get("Input") else first(ins, "X")
    if x.shape is None:
        return {"Out": x}
    shape = list(x.shape)
    for ax, st, en in zip(attrs.get("axes", []), attrs.get("starts", []),
                          attrs.get("ends", [])):
        ax = ax % len(shape)
        d = shape[ax]
        if d < 0:
            continue
        lo = max(st + d, 0) if st < 0 else min(st, d)
        hi = max(en + d, 0) if en < 0 else min(en, d)
        shape[ax] = max(hi - lo, 0)
    return {"Out": x.with_shape(shape)}


@register_shape_fn("multiplex")
def _multiplex_shape(op, ins, attrs):
    return {"Out": first(ins, "X")}


@register_shape_fn("sampling_id")
def _sampling_id_shape(op, ins, attrs):
    x = first(ins, "X")
    b = x.shape[0] if x.shape is not None else -1
    return {"Out": VarInfo((b,), "int64")}


@register_shape_fn("argsort")
def _argsort_shape(op, ins, attrs):
    x = first(ins, "X")
    return {"Out": x, "Indices": VarInfo(x.shape, "int64")}


@register_shape_fn("range")
def _range_shape(op, ins, attrs):
    start, end = attrs.get("start"), attrs.get("end")
    step = attrs.get("step", 1)
    dt = attrs.get("dtype", "int64")
    try:
        n = max(0, int(-(-(end - start) // step)))
    except (TypeError, ZeroDivisionError):
        n = -1
    return {"Out": VarInfo((n,), dt)}


@register_shape_fn("flatten")
def _flatten_shape(op, ins, attrs):
    x = first(ins, "X")
    if x.shape is None:
        return {"Out": x}
    ax = attrs.get("axis", 1)
    return {"Out": x.with_shape((prod_dims(x.shape[:ax]),
                                 prod_dims(x.shape[ax:])))}


@register_shape_fn("stack")
def _stack_shape(op, ins, attrs):
    xs = [v for v in ins.get("X", []) if v is not None]
    base = next((v for v in xs if v.shape is not None), None)
    if base is None:
        return {"Out": VarInfo(None, xs[0].dtype if xs else None)}
    for v in xs:
        if not shapes_compatible(v.shape, base.shape):
            raise ShapeError(
                f"stack: operand shapes differ: {list(base.shape)} vs "
                f"{list(v.shape)}")
    axis = attrs.get("axis", 0) % (len(base.shape) + 1)
    shape = base.shape[:axis] + (len(xs),) + base.shape[axis:]
    return {"Out": VarInfo(shape, base.dtype)}


@register_shape_fn("unstack")
def _unstack_shape(op, ins, attrs):
    x = first(ins, "X")
    names = op.outputs.get("Y", [])
    if x.shape is None:
        return {"Y": [VarInfo(None, x.dtype)] * len(names)}
    axis = attrs.get("axis", 0) % len(x.shape)
    if x.shape[axis] >= 0 and len(names) not in (0, x.shape[axis]):
        raise ShapeError(
            f"unstack: {len(names)} outputs for dim {x.shape[axis]}")
    part = x.shape[:axis] + x.shape[axis + 1:]
    return {"Y": [x.with_shape(part)] * len(names)}


@register_shape_fn("is_empty")
def _is_empty_shape(op, ins, attrs):
    return {"Out": VarInfo((), "bool")}

# ---------------------------------------------------------------------------
# Sharding-propagation rules (analysis.shard_prop).  reshape keeps the
# batch sharding only when the batch dim survives the reshape; concat
# replicates its concat axis (a sharded concat dim would interleave
# shards).  fill_constant_batch_size_like, split, pad, crop, expand,
# tile, slice, multiplex, stack, unstack and where have no rule (blind
# spots, as in the JAX package).
# ---------------------------------------------------------------------------
from ..analysis.shard_prop import (first_in, merge_entry,  # noqa: E402
                                   shard_batch_only, shard_noop,
                                   shard_replicated, shard_same_as)
from ..core.registry import register_shard_fn  # noqa: E402

register_shard_fn("feed", "fetch", "assign", "fill_zeros_like",
                  "fill_any_like", "shuffle", "scatter",
                  "reverse")(shard_same_as("X"))
register_shard_fn("fill_constant", "gaussian_random", "uniform_random",
                  "truncated_gaussian_random", "range", "assign_value",
                  "shape")(shard_replicated("Out"))
register_shard_fn("is_empty")(shard_noop())


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


@register_shard_fn("squeeze", "unsqueeze", "flatten")
def _rank_change_shard(op, ins, attrs):
    # conservatively keep only the batch-dim sharding (dim 0 survives
    # the three ops for the axes>=1 cases the layers emit)
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
                  "argsort", "sampling_id", "max_ids")(
    shard_batch_only("X", fallbacks=("Ids",), also=("Indices",)))
