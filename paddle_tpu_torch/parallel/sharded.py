"""ShardedExecutor: the multi-card training path (counterpart of
``paddle_tpu/parallel/sharded.py``).

The JAX package compiles one global program and lets GSPMD split it and
insert the collectives.  Here every rank is a process that runs the same
script (``distributed.launch``) and interprets the same program on its
own slice of the data, and the collectives GSPMD would insert are issued
by hand, at the places the shard rules (``analysis/shard_prop.py``)
mark:

* ``run(program, feed=global_batch)`` keeps the JAX API: every rank gets
  the global feed and keeps its slice by the feed's spec (default: dim 0
  over ``batch_axis``).  Every fetch is the global value, as a JAX global
  array is: a sharded fetch is gathered.
* The scope holds each rank's local pieces: a persistable with a sharded
  spec (``param_specs``, ``Parameter.sharding``, or an optimizer
  accumulator of such a parameter) is sliced on first use
  (:meth:`ShardedExecutor.place_state`), and ``Scope.layouts`` records
  its global shape and this rank's window (what a checkpoint writes).
* Each op runs on local operands (``_Step.call``): an elementwise op
  after its operands are resharded to one layout; a row-wise op (conv,
  pool, softmax, a loss head...) on batch-sharded rows; a contraction
  over a sharded dim (``mul``, the Megatron row-parallel product) is
  all-reduced; a reduction over the batch (``mean``, ``reduce_*``,
  ``accuracy``'s counts, ``batch_norm``'s statistics) is made global; a
  vocab-sharded ``lookup_table`` is the masked partial lookup plus one
  all-reduce (``embedding.sharded_lookup``).  Any other op with a
  sharded operand gathers its operands and runs replicated, so every
  reduction over a sharded dim is global, as under GSPMD.
* The backward (``_Step.grads``) seeds the replicated loss with
  ``1 / mesh size`` on every rank, and sums each parameter's partial
  gradient over the mesh axes it is replicated on (one bucketed
  all-reduce per dtype and axis set) before the optimizer ops run
  (``collective.py`` states the convention).

On the card the sharded step is captured as one CUDA graph like any
other: the key's warm-up step creates the NCCL communicators and warms
every collective, the next step captures them.  A gloo world (the CPU)
runs its steps uncaptured, counted under ``gloo``.  A mesh with ``pp``,
``sp`` or ``ep`` above 1 waits for ROADMAP item 7b.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..analysis.shard_prop import normalize_spec
from ..core.executor import CUDAPlace, Env, Executor, uncaptured_op
from ..core.program import Program, _sub_block_indices, grad_var_name
from ..core.scope import Scope, global_scope
from . import collective
from .mesh import Mesh, get_mesh

__all__ = ["ShardedExecutor"]

Spec = Tuple[Optional[Tuple[str, ...]], ...]

_ITEM_7B = ("ROADMAP Queue A item 7b (pipeline, sequence and expert "
            "parallelism)")

# every output element depends on the same element of each operand
# (after broadcasting)
ELEMENTWISE = frozenset((
    "sigmoid", "logsigmoid", "tanh", "relu", "relu6", "abs", "sqrt",
    "rsqrt", "square", "exp", "log", "floor", "ceil", "round",
    "reciprocal", "softsign", "softplus", "softrelu", "sin", "cos",
    "gelu", "silu", "swish", "brelu", "leaky_relu", "elu", "stanh",
    "hard_shrink", "soft_shrink", "softshrink", "thresholded_relu",
    "hard_sigmoid", "elementwise_add", "elementwise_sub",
    "elementwise_mul", "elementwise_div", "elementwise_pow",
    "elementwise_max", "elementwise_min", "elementwise_mod", "equal",
    "not_equal", "less_than", "less_equal", "greater_than",
    "greater_equal", "logical_and", "logical_or", "logical_xor",
    "abs_diff", "squared_difference", "logical_not", "scale", "minus",
    "clip", "sign", "pow", "cast", "dropout", "assign", "sum",
    "log_loss", "sigmoid_cross_entropy_with_logits", "hinge_loss",
))
# the elementwise ops whose Y aligns with X at the ``axis`` attr
_AXIS_OPS = frozenset(o for o in ELEMENTWISE if o.startswith(
    ("elementwise_", "equal", "not_equal", "less_", "greater_",
     "logical_and", "logical_or", "logical_xor")))

# rows (dim 0) are independent: the batch slots' operands shard dim 0,
# every other operand is replicated, every output shards dim 0
ROWWISE = {
    "conv2d": ("Input",), "depthwise_conv2d": ("Input",),
    "pool2d": ("X",), "max_pool2d_with_index": ("X",),
    "pool2d_with_index": ("X",), "softmax": ("X",),
    "log_softmax": ("X",), "lrn": ("X",),
    "cross_entropy": ("X", "Label"),
    "softmax_with_cross_entropy": ("Logits", "Label"),
    "top_k": ("X",), "one_hot": ("X",), "lookup_table": ("Ids",),
    "smooth_l1_loss": ("X", "Y", "InsideWeight", "OutsideWeight"),
    "squared_l2_distance": ("X", "Y"), "cos_sim": ("X", "Y"),
    "layer_norm": ("X",),
}

# reductions over the batch made global, by how the local results combine
_REDUCE_COMBINE = {"reduce_sum": "sum", "reduce_mean": "mean"}


def _norm(spec, ndim: Optional[int] = None) -> Optional[Spec]:
    """A canonical spec (one entry a dim), or None when nothing is
    sharded."""
    if spec is None:
        return None
    s = normalize_spec(spec, ndim)
    return s if any(s) else None


def _axes(spec: Optional[Spec]) -> List[str]:
    out = []
    for e in spec or ():
        out.extend(e or ())
    return out


def _entry(spec: Optional[Spec], i: int):
    if spec is None or not (-len(spec) <= i < len(spec)):
        return None
    return spec[i]


def _specs_sig(specs: Dict[str, Spec]) -> tuple:
    return tuple(sorted((k, repr(v)) for k, v in specs.items()))


def _is_tensor(v) -> bool:
    return isinstance(v, torch.Tensor)


class _Step:
    """One step's sharding state on one rank: the spec of every value it
    has bound (by var name; None: replicated), and the collectives."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.coords = mesh.coords()
        self.specs: Dict[str, Spec] = {}

    # -- layouts --------------------------------------------------------------
    def extent(self, entry) -> int:
        return self.mesh.extent(entry or ())

    def global_shape(self, t: torch.Tensor, spec) -> Tuple[int, ...]:
        shape = list(t.shape)
        for i, e in enumerate(spec or ()):
            if i < len(shape):
                shape[i] *= self.extent(e)
        return tuple(shape)

    def index(self, entry) -> int:
        """This rank's block index along a dim sharded by ``entry``."""
        idx = 0
        for a in entry or ():
            idx = idx * int(self.mesh.shape[a]) + self.coords[a]
        return idx

    def slice(self, t: torch.Tensor, dim: int, entry) -> torch.Tensor:
        n = self.extent(entry)
        if t.shape[dim] % n:
            raise ValueError(
                f"sharded executor: dim {dim} of size {t.shape[dim]} does "
                f"not divide by the extent {n} of {list(entry)} on "
                f"{self.mesh!r}")
        size = t.shape[dim] // n
        return t.narrow(dim, self.index(entry) * size, size)

    def gather(self, t: torch.Tensor, dim: int, entry) -> torch.Tensor:
        # the first axis of an entry is the major one: gather the inner
        # axes first
        for a in reversed(entry or ()):
            t = collective.all_gather(t, a, axis=dim)
        return t

    def reshard(self, t, have, want):
        """``t`` (laid out by ``have``) laid out by ``want``: a dim
        sharded in ``have`` and not in ``want`` is gathered, one sharded
        in ``want`` and not in ``have`` is sliced (no communication)."""
        if not _is_tensor(t) or have == want:
            return t
        nd = t.dim()
        h, w = normalize_spec(have or (), nd), normalize_spec(want or (), nd)
        for i in range(nd):
            if h[i] and h[i] != w[i]:
                t = self.gather(t, i, h[i])
        for i in range(nd):
            if w[i] and h[i] != w[i]:
                t = self.slice(t, i, w[i])
        return t

    def bind(self, names, spec):
        for n in names:
            if spec is None:
                self.specs.pop(n, None)
            else:
                self.specs[n] = spec

    def to_global(self, name: str, t):
        """A fetch as the global value."""
        spec = self.specs.get(name)
        return self.reshard(t, spec, None) if spec else t

    # -- ops ------------------------------------------------------------------
    def call(self, op, impl, ctx, ins):
        """Run ``op`` on local operands with the collectives its sharding
        needs, and record the specs of its outputs."""
        in_specs = {slot: [self.specs.get(n) for n in op.inputs[slot]]
                    for slot in ins}
        sharded = any(s for ss in in_specs.values() for s in ss)
        if not sharded:
            result = impl(ctx, ins, op.attrs)
            self._bind_all(op, None)
            return result
        if _sub_block_indices(op):
            return self._replicated(op, impl, ctx, ins, in_specs,
                                    whole_env=True)
        handler = _HANDLERS.get(op.type)
        if handler is not None:
            return handler(self, op, impl, ctx, ins, in_specs)
        if "Param" in ins and "Grad" in ins:
            return self._optimizer(op, impl, ctx, ins, in_specs)
        if op.type in ELEMENTWISE:
            return self._elementwise(op, impl, ctx, ins, in_specs)
        if op.type in ROWWISE:
            return self._rowwise(op, impl, ctx, ins, in_specs,
                                 ROWWISE[op.type])
        return self._replicated(op, impl, ctx, ins, in_specs)

    def _bind_all(self, op, spec):
        for names in op.outputs.values():
            self.bind(names, spec)

    def _replicated(self, op, impl, ctx, ins, in_specs, whole_env=False):
        """Gather every sharded operand and run ``op`` replicated (its
        outputs replicated).  An op with a sub-block reads its parent's
        env, so the whole env is gathered first; ``@LEN`` companions of
        gathered operands are gathered beside them."""
        env = ctx.env
        if whole_env:
            e = env
            while e is not None:
                for k in list(e.local):
                    spec = self.specs.get(k)
                    if spec and _is_tensor(e.local[k]):
                        e.local[k] = self.reshard(e.local[k], spec, None)
                        self.specs.pop(k, None)
                e = e.parent
            ins = {slot: [env.get(n) for n in op.inputs[slot]]
                   for slot in ins}
            result = impl(ctx, ins, op.attrs)
            self._bind_all(op, None)
            return result
        full = {slot: [self.reshard(v, s, None) for v, s in zip(vals, ss)]
                for (slot, vals), ss in zip(ins.items(), in_specs.values())}
        overlay = Env(env.block, parent=env)
        for slot, names in op.inputs.items():
            for n in names:
                for suffix in ("@LEN", "@LEN2"):
                    ln = n + suffix
                    if self.specs.get(ln) and env.has(ln):
                        overlay.local[ln] = self.reshard(
                            env.get(ln), self.specs[ln], None)
        ctx.env = overlay
        try:
            result = impl(ctx, full, op.attrs)
        finally:
            ctx.env = env
        for k, v in overlay.local.items():
            if k.endswith("@LEN") or k.endswith("@LEN2"):
                env.local[k] = v
                self.specs.pop(k, None)
        self._bind_all(op, None)
        return result

    def _elementwise(self, op, impl, ctx, ins, in_specs):
        """Operands resharded to the output's layout: a dim sharded in
        any operand stays sharded (two different shardings of one dim:
        replicated instead), size-1 (broadcast) dims replicate."""
        flat = [(slot, i, v, s) for (slot, vals), ss in
                zip(ins.items(), in_specs.values())
                for i, (v, s) in enumerate(zip(vals, ss)) if _is_tensor(v)]
        ref = max(flat, key=lambda f: f[2].dim())
        nd = ref[2].dim()
        axis = op.attrs.get("axis", -1) if op.type in _AXIS_OPS else -1

        def dims_of(slot, v):
            """Output dim of each of ``v``'s dims."""
            k = v.dim()
            if axis not in (-1, None) and slot == "Y" and k < nd:
                return [axis + j for j in range(k)]
            return [nd - k + j for j in range(k)]

        out = [None] * nd
        for slot, _, v, s in flat:
            g = self.global_shape(v, s)
            for j, d in enumerate(dims_of(slot, v)):
                e = _entry(s, j)
                if e is None or g[j] == 1:
                    continue
                if out[d] not in (None, e):
                    return self._replicated(op, impl, ctx, ins, in_specs)
                out[d] = e
        booked = [a for e in out for a in (e or ())]
        if len(booked) != len(set(booked)):
            return self._replicated(op, impl, ctx, ins, in_specs)
        new = {slot: list(vals) for slot, vals in ins.items()}
        for slot, i, v, s in flat:
            g = self.global_shape(v, s)
            want = tuple(out[d] if g[j] != 1 else None
                         for j, d in enumerate(dims_of(slot, v)))
            new[slot][i] = self.reshard(v, s, _norm(want))
        result = impl(ctx, new, op.attrs)
        self._bind_all(op, _norm(tuple(out)))
        return result

    def _batch_entry(self, ins, in_specs, slots):
        for slot in slots:
            for s in in_specs.get(slot, ()):
                if _entry(s, 0):
                    return _entry(s, 0)
        return None

    def _rowwise(self, op, impl, ctx, ins, in_specs, slots):
        """Batch slots' operands sharded on dim 0 only, the others
        replicated; every output sharded on dim 0."""
        b = self._batch_entry(ins, in_specs, slots)
        if b is None:
            return self._replicated(op, impl, ctx, ins, in_specs)
        new = {}
        for (slot, vals), ss in zip(ins.items(), in_specs.values()):
            if slot in slots:
                new[slot] = [self.reshard(v, s, (b,)) for v, s in
                             zip(vals, ss)]
            else:
                new[slot] = [self.reshard(v, s, None) for v, s in
                             zip(vals, ss)]
        result = impl(ctx, new, op.attrs)
        self._bind_all(op, (b,))
        return result

    def _optimizer(self, op, impl, ctx, ins, in_specs):
        """An update op: every operand of the parameter's global shape
        takes the parameter's layout (the gradient already has it),
        scalars replicate; outputs of the parameter's shape keep it."""
        p = ins["Param"][0]
        ps = in_specs["Param"][0]
        gp = self.global_shape(p, ps)
        new = {}
        for (slot, vals), ss in zip(ins.items(), in_specs.values()):
            new[slot] = [self.reshard(
                v, s, ps if _is_tensor(v)
                and self.global_shape(v, s) == gp else None)
                for v, s in zip(vals, ss)]
        result = impl(ctx, new, op.attrs)
        local = tuple(new["Param"][0].shape)
        from ..core.executor import _normalize_outputs
        outs = _normalize_outputs(op, result)
        for slot, names in op.outputs.items():
            vals = outs.get(slot) or []
            for n, v in zip(names, vals):
                self.bind([n], ps if _is_tensor(v)
                          and tuple(v.shape) == local else None)
        return result

    # -- the backward ---------------------------------------------------------
    def grads(self, loss, leaves, wrt_names):
        """d(loss)/d(leaves) on this rank under the partial-gradient
        convention: the loss (replicated over the mesh) seeded with
        ``1 / mesh size``; then each parameter's gradient summed over the
        mesh axes its layout replicates, bucketed by dtype and axes."""
        seed = torch.full_like(loss, 1.0 / self.mesh.size)
        grads = list(torch.autograd.grad(loss, leaves, grad_outputs=seed,
                                         allow_unused=True))
        buckets = collections.OrderedDict()
        for i, (n, leaf, g) in enumerate(zip(wrt_names, leaves, grads)):
            if g is None:
                grads[i] = g = torch.zeros_like(leaf)
            spec = self.specs.get(n)
            axes = tuple(a for a in self.mesh.axis_names
                         if a not in _axes(spec))
            self.bind([grad_var_name(n)], spec)
            if axes:
                buckets.setdefault((g.dtype, axes), []).append(i)
        for (_, axes), idx in buckets.items():
            flat = torch.cat([grads[i].reshape(-1) for i in idx])
            for a in axes:
                flat = collective.psum(flat, a)
            off = 0
            for i in idx:
                n = grads[i].numel()
                grads[i] = flat[off:off + n].view_as(grads[i])
                off += n
        return grads


# ---------------------------------------------------------------------------
# Ops with a sharded form of their own
# ---------------------------------------------------------------------------
def _h_mean(st, op, impl, ctx, ins, in_specs):
    s = in_specs["X"][0]
    out = impl(ctx, ins, op.attrs)
    v = out["Out"] if isinstance(out, dict) else out
    for a in _axes(s):
        v = collective.all_reduce(v, a, "mean")
    st._bind_all(op, None)
    return {"Out": v}


def _h_reduce(st, op, impl, ctx, ins, in_specs):
    x, s = ins["X"][0], in_specs["X"][0]
    nd = x.dim()
    if op.attrs.get("reduce_all", False):
        dims = set(range(nd))
    else:
        dim = op.attrs.get("dim", [0])
        dims = {d % nd for d in (dim if isinstance(dim, (list, tuple))
                                 else [dim])}
    lost = [a for i in sorted(dims) for a in (_entry(s, i) or ())]
    out = impl(ctx, ins, op.attrs)
    v = out["Out"] if isinstance(out, dict) else out
    for a in lost:
        v = collective.all_reduce(v, a, _REDUCE_COMBINE[op.type])
    if op.attrs.get("reduce_all", False):
        keep = None
    elif op.attrs.get("keep_dim", False):
        keep = tuple(None if i in dims else _entry(s, i) for i in range(nd))
    else:
        keep = tuple(_entry(s, i) for i in range(nd) if i not in dims)
    st._bind_all(op, _norm(keep))
    return {"Out": v}


def _h_squared_l2_norm(st, op, impl, ctx, ins, in_specs):
    s = in_specs["X"][0]
    out = impl(ctx, ins, op.attrs)
    v = out["Out"] if isinstance(out, dict) else out
    for a in _axes(s):
        v = collective.psum(v, a)
    st._bind_all(op, None)
    return {"Out": v}


def _h_accuracy(st, op, impl, ctx, ins, in_specs):
    """Counts over the local rows, summed over the batch's axes."""
    b = st._batch_entry(ins, in_specs, ("Indices", "Label", "Out"))
    if b is None:
        return st._replicated(op, impl, ctx, ins, in_specs)
    local = {slot: [st.reshard(v, s, (b,)) for v, s in zip(vals, ss)]
             for (slot, vals), ss in zip(ins.items(), in_specs.values())}
    out = impl(ctx, local, op.attrs)
    counts = torch.stack([out["Correct"].reshape(()).to(torch.float32),
                          out["Total"].reshape(()).to(torch.float32)])
    for a in b:
        counts = collective.psum(counts, a)
    correct, total = counts[0], counts[1]
    st._bind_all(op, None)
    return {"Accuracy": (correct / total).reshape(1),
            "Correct": correct.to(torch.int32).reshape(1),
            "Total": total.to(torch.int32).reshape(1)}


def _h_batch_norm(st, op, impl, ctx, ins, in_specs):
    """The batch statistics over the global batch: the rows' moments
    summed over the batch axes (one all-reduce of [sum, sum of squares]
    a layer), the rest of the op as on one card."""
    from ..ops import nn_ops
    xs = in_specs["X"][0]
    b = _entry(xs, 0)
    others = [(slot, v, s) for (slot, vals), ss in
              zip(ins.items(), in_specs.values()) if slot != "X"
              for v, s in zip(vals, ss)]
    if b is None or any(_entry(xs, i) for i in range(1, len(xs))) or \
            any(s for _, _, s in others):
        return st._replicated(op, impl, ctx, ins, in_specs)
    n = st.extent(b)

    def moments(xf, axes):
        count = 1
        for i in axes:
            count *= xf.shape[i]
        sums = torch.stack([xf.sum(axes), (xf * xf).sum(axes)])
        for a in b:
            sums = collective.psum(sums, a)
        return sums[0] / (count * n), sums[1] / (count * n)

    out = nn_ops.batch_norm_with(ctx, ins, op.attrs, moments=moments)
    st._bind_all(op, None)
    st.bind(op.outputs.get("Y", []), (b,))
    return out


def _h_mul(st, op, impl, ctx, ins, in_specs):
    """``mul`` (the fc product): rows follow X, columns follow Y; a
    contraction sharded on one side is sliced on the other (a Megatron
    row-parallel weight meets a replicated activation), and the partial
    products are summed over the contraction's axes."""
    x, y = ins["X"][0], ins["Y"][0]
    xs, ys = in_specs["X"][0], in_specs["Y"][0]
    xn = op.attrs.get("x_num_col_dims", 1)
    yn = op.attrs.get("y_num_col_dims", 1)
    xk = [_entry(xs, i) for i in range(xn, x.dim())]
    yk = [_entry(ys, i) for i in range(yn)]
    kx = [e for e in xk if e]
    ky = [e for e in yk if e]
    if (kx or ky) and (len(xk) != 1 or len(yk) != 1 or
                       (kx and ky and kx != ky)):
        return st._replicated(op, impl, ctx, ins, in_specs)
    k = (kx or ky or [None])[0]
    rows = tuple(_entry(xs, i) for i in range(xn))
    cols = tuple(_entry(ys, i) for i in range(yn, y.dim()))
    want_x = _norm(rows + ((k,) if k else (None,) * len(xk)))
    want_y = _norm(((k,) if k else (None,) * len(yk)) + cols)
    booked = _axes(want_x) + [a for e in cols for a in (e or ())]
    if len(booked) != len(set(booked)):
        return st._replicated(op, impl, ctx, ins, in_specs)
    new = dict(ins)
    new["X"] = [st.reshard(x, xs, want_x)]
    new["Y"] = [st.reshard(y, ys, want_y)]
    out = impl(ctx, new, op.attrs)
    v = out["Out"] if isinstance(out, dict) else out
    for a in k or ():
        v = collective.psum(v, a)
    st._bind_all(op, _norm(rows + cols))
    return {"Out": v}


def _h_lookup_table(st, op, impl, ctx, ins, in_specs):
    """A vocab-sharded table: this rank's rows looked up where the id
    falls in its window, zeros elsewhere, summed over the vocab axes."""
    from .embedding import sharded_lookup
    ws = in_specs["W"][0]
    if not _entry(ws, 0) or _entry(ws, 1):
        return st._rowwise(op, impl, ctx, ins, in_specs, ("Ids",))
    ids, ids_s = ins["Ids"][0], in_specs["Ids"][0]
    b = _entry(ids_s, 0)
    vocab_axes = _entry(ws, 0)
    if any(_entry(ids_s, i) for i in range(1, ids.dim())) or \
            set(b or ()) & set(vocab_axes):
        ids = st.reshard(ids, ids_s, None)
        b = None
    out = sharded_lookup(ins["W"][0], ids, axis_name=vocab_axes,
                         padding_idx=op.attrs.get("padding_idx"),
                         offset=st.index(vocab_axes) * ins["W"][0].shape[0])
    st._bind_all(op, _norm((b,)))
    return {"Out": out}


def _h_transpose(st, op, impl, ctx, ins, in_specs):
    s = in_specs["X"][0]
    perm = list(op.attrs.get("axis", op.attrs.get("perm", [])))
    out = impl(ctx, ins, op.attrs)
    st._bind_all(op, _norm(tuple(_entry(s, p) for p in perm)))
    return out


def _h_concat(st, op, impl, ctx, ins, in_specs):
    """Operands in one layout with the concatenated dim whole."""
    xs = ins["X"]
    nd = xs[0].dim()
    axis = op.attrs.get("axis", 0) % nd
    out = [None] * nd
    for s in in_specs["X"]:
        for i in range(nd):
            e = _entry(s, i)
            if i == axis or e is None:
                continue
            if out[i] not in (None, e):
                return st._replicated(op, impl, ctx, ins, in_specs)
            out[i] = e
    want = _norm(tuple(out))
    new = {"X": [st.reshard(v, s, want) for v, s in
                 zip(xs, in_specs["X"])]}
    result = impl(ctx, new, op.attrs)
    st._bind_all(op, want)
    return result


def _h_split(st, op, impl, ctx, ins, in_specs):
    x, s = ins["X"][0], in_specs["X"][0]
    axis = op.attrs.get("axis", 0) % x.dim()
    if _entry(s, axis):
        return st._replicated(op, impl, ctx, ins, in_specs)
    result = impl(ctx, ins, op.attrs)
    st._bind_all(op, s)
    return result


def _h_reshape(st, op, impl, ctx, ins, in_specs):
    """A reshape that keeps the batch dim (dim 0 in and out, sharded
    there only) runs on the local rows with the batch size of the
    ``shape`` attr made local; any other reshape runs replicated."""
    x, s = ins["X"][0], in_specs["X"][0]
    b = _entry(s, 0)
    shape = list(op.attrs.get("shape", []))
    if b is None or any(_entry(s, i) for i in range(1, x.dim())) or \
            not shape:
        return st._replicated(op, impl, ctx, ins, in_specs)
    g = st.global_shape(x, s)
    rest = int(np.prod(g[1:])) if len(g) > 1 else 1
    tail = [g[i] if d == 0 else d for i, d in enumerate(shape)][1:]
    known = int(np.prod([d for d in tail if d != -1])) if tail else 1
    head = shape[0]
    keeps = (head in (0, -1, g[0])) and (
        (-1 not in tail and known == rest) or
        (head != -1 and tail.count(-1) == 1 and rest % known == 0))
    if not keeps:
        return st._replicated(op, impl, ctx, ins, in_specs)
    attrs = dict(op.attrs)
    attrs["shape"] = [x.shape[0] if head == g[0] else head] + \
        list(shape[1:])
    out = impl(ctx, ins, attrs)
    st._bind_all(op, (b,))
    return out


def _h_fill_batch_like(st, op, impl, ctx, ins, in_specs):
    s = in_specs["Input"][0]
    i = op.attrs.get("input_dim_idx", 0)
    o = op.attrs.get("output_dim_idx", 0)
    e = _entry(s, i)
    result = impl(ctx, ins, op.attrs)
    st._bind_all(op, _norm(tuple(e if d == o else None
                                 for d in range(o + 1))))
    return result


def _h_matmul(st, op, impl, ctx, ins, in_specs):
    """Row-wise over a batch dim the transposes leave alone: a batched X
    (with Y batched alike, or a replicated weight), or a 2-D X that is
    not transposed."""
    x, y = ins["X"][0], ins["Y"][0]
    if x.dim() >= 3:
        slots = ("X", "Y") if y.dim() == x.dim() else ("X",)
    elif not op.attrs.get("transpose_X", False) and y.dim() <= 2:
        slots = ("X",)
    else:
        return st._replicated(op, impl, ctx, ins, in_specs)
    return st._rowwise(op, impl, ctx, ins, in_specs, slots)


_HANDLERS = {
    "mean": _h_mean, "reduce_sum": _h_reduce, "reduce_mean": _h_reduce,
    "squared_l2_norm": _h_squared_l2_norm, "accuracy": _h_accuracy,
    "batch_norm": _h_batch_norm, "mul": _h_mul,
    "lookup_table": _h_lookup_table, "transpose": _h_transpose,
    "transpose2": _h_transpose, "concat": _h_concat, "split": _h_split,
    "reshape": _h_reshape, "reshape2": _h_reshape,
    "fill_constant_batch_size_like": _h_fill_batch_like,
    "matmul": _h_matmul,
}


# ---------------------------------------------------------------------------
# State layouts
# ---------------------------------------------------------------------------
def _find_var(program: Program, name: str):
    for b in program.blocks:
        if name in b.vars:
            return b.vars[name]
    return None


def state_specs(program: Program, param_specs: Dict) -> Dict[str, Spec]:
    """The spec of every sharded persistable of ``program``: its
    ``param_specs`` override or ``Parameter.sharding``, and for an update
    op's operands of the parameter's shape (velocities, moments), the
    parameter's.  Memoized per program version and overrides."""
    from ..core.executor import _memo

    def compute():
        specs = {}
        for b in program.blocks:
            for name, v in b.vars.items():
                if not v.persistable:
                    continue
                spec = param_specs.get(name)
                if spec is None and getattr(v, "sharding", None):
                    spec = v.sharding
                spec = _norm(spec, len(v.shape or ()))
                if spec:
                    specs[name] = spec
        for op in program.global_block().ops:
            params = op.inputs.get("Param") or []
            if not params or params[0] not in specs:
                continue
            pv = _find_var(program, params[0])
            for names in op.inputs.values():
                for n in names:
                    v = _find_var(program, n)
                    if v is not None and v.persistable and n not in specs \
                            and list(v.shape or ()) == list(pv.shape or ()):
                        specs[n] = specs[params[0]]
        return specs
    return _memo(program, ("state_specs", _specs_sig(
        {k: _norm(v) for k, v in param_specs.items()})), compute)


def _writer(mesh: Mesh, spec: Spec) -> bool:
    """Whether this rank writes its piece into a checkpoint: the replicas
    of a piece along the axes its spec leaves out sit at index 0 there."""
    coords = mesh.coords()
    used = set(_axes(spec))
    return all(coords[a] == 0 for a in mesh.axis_names if a not in used)


def place(program: Program, scope: Scope, mesh: Mesh, param_specs: Dict):
    """Slice every persistable with a sharded spec that ``scope`` holds
    whole (its declared global shape) into this rank's piece, and record
    the piece's layout in ``scope.layouts``."""
    st = _Step(mesh)
    for name, spec in state_specs(program, param_specs).items():
        if not scope.has(name):
            continue
        t = scope.get(name)
        gshape = tuple(int(d) for d in (_find_var(program, name).shape
                                        or ()))
        if not isinstance(t, torch.Tensor) or tuple(t.shape) != gshape \
                or any(d < 0 for d in gshape):
            continue
        index = []
        for i, d in enumerate(gshape):
            e = _entry(spec, i)
            size = d // st.extent(e)
            lo = st.index(e) * size if e else 0
            index.append([lo, lo + size])
            if e:
                t = st.slice(t, i, e)
        if tuple(t.shape) == gshape:
            continue
        scope.set(name, t.contiguous().clone())
        scope.layouts[name] = {"shape": list(gshape), "index": index,
                               "writer": _writer(mesh, spec)}


# ---------------------------------------------------------------------------
# The executor
# ---------------------------------------------------------------------------
class ShardedExecutor(Executor):
    """Executor whose steps run sharded over a mesh of ranks.

    ``feed_specs``: ``{feed_name: spec}`` overrides; by default a feed's
    dim 0 is sharded on ``batch_axis`` (``@LEN`` companions too).
    ``param_specs``: ``{var: spec}`` overrides of ``Parameter.sharding``;
    unannotated state replicates (an optimizer accumulator takes its
    parameter's spec).  ``auto_shard=True`` with both dicts omitted: the
    planner (``analysis.planner``) proposes them from the first fed
    program.  ``place`` defaults to this rank's card; the world's backend
    must be the place's (``nccl`` for a card, ``gloo`` for the CPU).
    """

    def __init__(self, mesh: Optional[Mesh] = None, batch_axis: str = "dp",
                 feed_specs: Optional[Dict] = None,
                 param_specs: Optional[Dict] = None,
                 num_microbatches: Optional[int] = None,
                 auto_shard: bool = False, **kw):
        self.mesh = mesh or get_mesh()
        for ax in ("pp", "sp", "ep"):
            if int(self.mesh.shape.get(ax, 1)) > 1:
                raise NotImplementedError(
                    f"ShardedExecutor: a mesh with {ax}="
                    f"{self.mesh.shape[ax]} waits for {_ITEM_7B}")
        if "place" not in kw or kw["place"] is None:
            if torch.cuda.is_available():
                kw["place"] = CUDAPlace(torch.cuda.current_device())
        super().__init__(**kw)
        backend = self.mesh.backend()
        want = "nccl" if self.device.type == "cuda" else "gloo"
        if backend is not None and backend != want:
            raise RuntimeError(
                f"ShardedExecutor: the world's backend is {backend!r} but "
                f"the executor runs on {self.device}, whose collectives "
                f"are {want!r}'s: start the world with "
                f"init_distributed(device={self.device.type!r})")
        self.batch_axis = batch_axis
        self.feed_specs = {k: _norm(v) for k, v in (feed_specs or {}).items()}
        self.param_specs = {k: _norm(v) for k, v in
                            (param_specs or {}).items()}
        self.num_microbatches = num_microbatches
        self.auto_shard = auto_shard
        self.auto_plan = None

    # -- planning -------------------------------------------------------------
    def _ensure_auto_plan(self, program: Optional[Program]):
        """Plan once, on the first fed program (the startup program has
        no feeds and carries nothing the planner wants)."""
        if not self.auto_shard or self.auto_plan is not None:
            return
        if program is None:
            from ..core.program import default_main_program
            program = default_main_program()
        if self.param_specs or self.feed_specs:
            # explicit specs win: auto_shard only fills an omission
            self.auto_plan = False
            return
        if not any(v.is_data for b in program.blocks
                   for v in b.vars.values()):
            return
        from ..analysis import planner
        plan = planner.plan(program, self._mesh_axes(),
                            batch_axis=self.batch_axis)
        self.param_specs.update({k: _norm(v) for k, v in
                                 plan.param_specs.items() if _norm(v)})
        # a feed the plan leaves whole keeps the default (the batch axis,
        # whose collectives run at every size)
        self.feed_specs.update({k: _norm(v) for k, v in
                                plan.feed_specs.items() if _norm(v)})
        self.auto_plan = plan

    def _mesh_axes(self) -> Dict[str, int]:
        return {str(a): int(n) for a, n in self.mesh.shape.items()}

    def _check_program(self, program: Program):
        if self.num_microbatches is not None and any(
                "pipeline_stage" in op.attrs for b in program.blocks
                for op in b.ops):
            raise NotImplementedError(
                f"ShardedExecutor(num_microbatches=...) over a "
                f"pipeline_stage program waits for {_ITEM_7B}")

    def _validation_context(self):
        return (self._mesh_axes(), dict(self.param_specs) or None,
                dict(self.feed_specs) or None)

    def _observe_label(self) -> str:
        axes = [f"{a}{n}" for a, n in self.mesh.shape.items() if n > 1]
        return "mesh=" + (",".join(axes) or "1")

    def _fingerprint_extras(self, program: Program) -> tuple:
        return ("mesh", self.mesh.axis_names,
                tuple(int(n) for n in self.mesh.shape.values()),
                tuple(int(r) for r in self.mesh.devices.ravel()),
                self.batch_axis, self.num_microbatches,
                _specs_sig(self.feed_specs), _specs_sig(self.param_specs))

    def _uncaptured_reason(self, program: Program,
                           is_test: bool) -> Optional[str]:
        if uncaptured_op(program) is None and self.mesh.backend() == "gloo":
            return "gloo"
        return super()._uncaptured_reason(program, is_test)

    # -- specs ----------------------------------------------------------------
    def _feed_spec(self, program: Program, name: str, ndim: int):
        if name in self.feed_specs:
            return _norm(self.feed_specs[name], ndim)
        if ndim == 0 or self.batch_axis not in self.mesh.shape:
            return None
        return _norm(((self.batch_axis,),), ndim)

    def state_specs(self, program: Program) -> Dict[str, Spec]:
        """The spec of every sharded persistable of ``program``
        (:func:`state_specs`)."""
        return state_specs(program, self.param_specs)

    def place_state(self, program: Program, scope: Optional[Scope] = None):
        """Slice every persistable with a sharded spec that the scope
        holds whole into this rank's piece (:func:`place`); call after
        the startup program ran (each run does it too)."""
        place(program, global_scope() if scope is None else scope,
              self.mesh, self.param_specs)

    def global_state(self, program: Program, scope: Optional[Scope] = None,
                     names=None) -> Dict[str, np.ndarray]:
        """{name: global numpy array} of ``names`` (default every sharded
        persistable the scope holds), each rank's pieces gathered (a
        collective: every rank calls it)."""
        scope = global_scope() if scope is None else scope
        specs = self.state_specs(program)
        names = [n for n in (names if names is not None else specs)
                 if scope.has(n)]
        out = {}
        st = _Step(self.mesh)
        with collective.spmd(self.mesh), torch.no_grad():
            for n in names:
                t = scope.get(n)
                spec = specs.get(n)
                if spec and n in scope.layouts and \
                        list(t.shape) != scope.layouts[n]["shape"]:
                    t = st.reshard(t, spec, None)
                out[n] = t.detach().float().cpu().numpy() \
                    if t.dtype == torch.bfloat16 else t.detach().cpu().numpy()
        return out

    # -- feeds ----------------------------------------------------------------
    def _local_feeds(self, program: Program, feed, lead: int = 0):
        """Each rank's slice of the global feed, by the feed's spec (a
        stacked feed's leading steps axis stays whole)."""
        st = _Step(self.mesh)
        out = {}
        for name, val in (feed or {}).items():
            shape = tuple(np.shape(val)) if not isinstance(
                val, torch.Tensor) else tuple(val.shape)
            spec = self._feed_spec(program, name, len(shape) - lead)
            if not spec:
                out[name] = val
                continue
            for i, e in enumerate(spec):
                if not e:
                    continue
                d = i + lead
                n = st.extent(e)
                if shape[d] % n:
                    raise ValueError(
                        f"feed {name!r} dim {i} of size {shape[d]} is not "
                        f"divisible by {'x'.join(e)}={n}")
                size = shape[d] // n
                lo = st.index(e) * size
                if isinstance(val, torch.Tensor):
                    val = val.narrow(d, lo, size)
                else:
                    val = np.asarray(val)[(slice(None),) * d
                                          + (slice(lo, lo + size),)]
            out[name] = val
        return out

    def _local_spec_feeds(self, program: Program, feed, lead):
        """compile's feeds made local: an example sliced, a ``(shape,
        dtype)`` spec or a meta tensor divided along its sharded dims."""
        out = {}
        for name, val in (feed or {}).items():
            if isinstance(val, torch.Tensor) and val.device.type == "meta":
                shape = self._local_shape(program, name, val.shape, lead)
                out[name] = torch.empty(shape, dtype=val.dtype,
                                        device="meta")
            elif isinstance(val, tuple) and len(val) == 2 and \
                    isinstance(val[0], (tuple, list)):
                out[name] = (self._local_shape(program, name, val[0], lead),
                             val[1])
            else:
                out.update(self._local_feeds(program, {name: val}, lead))
        return out

    def _local_shape(self, program, name, shape, lead):
        shape = [int(d) for d in shape]
        spec = self._feed_spec(program, name, len(shape) - lead) or ()
        st = _Step(self.mesh)
        for i, e in enumerate(spec):
            if e:
                shape[i + lead] //= st.extent(e)
        return tuple(shape)

    # -- the step -------------------------------------------------------------
    def _context(self, program: Program, is_test: bool):
        ctx = super()._context(program, is_test)
        ctx.shard = _Step(self.mesh)
        return ctx

    def _interpret_step(self, program: Program, ctx, state, feeds,
                        fetch_names):
        st = ctx.shard
        specs = self.state_specs(program)
        st.specs = {k: specs[k] for k in state if k in specs}
        for name, t in feeds.items():
            spec = self._feed_spec(program, name, t.dim())
            if spec:
                st.specs[name] = spec
        with collective.spmd(self.mesh):
            fetches, writes, finite = super()._interpret_step(
                program, ctx, state, feeds, fetch_names)
            fetches = [st.to_global(n, f) if f is not None else None
                       for n, f in zip(fetch_names, fetches)]
            writes = {k: st.reshard(v, st.specs.get(k), specs.get(k))
                      for k, v in writes.items()}
        return fetches, writes, finite

    # -- entry points ---------------------------------------------------------
    def _prepare(self, program: Optional[Program], scope, fetch_list):
        """The plan, the refusals, the validation (before a spec slices
        anything) and the placement of the state, ahead of a step."""
        from ..core.executor import _fetch_names
        from ..core.program import default_main_program
        program = program or default_main_program()
        self._ensure_auto_plan(program)
        self._check_program(program)
        self._maybe_validate(program, _fetch_names(fetch_list))
        self.place_state(program, scope)
        return program

    def run(self, program: Optional[Program] = None, feed=None,
            fetch_list=None, scope: Optional[Scope] = None, **kw):
        program = self._prepare(program, scope, fetch_list)
        return super().run(program, feed=self._local_feeds(program, feed),
                           fetch_list=fetch_list, scope=scope, **kw)

    def run_steps(self, num_steps, program: Optional[Program] = None,
                  feed=None, fetch_list=None, scope: Optional[Scope] = None,
                  feeds_stacked: bool = False, **kw):
        program = self._prepare(program, scope, fetch_list)
        feed = self._local_feeds(program, feed, 1 if feeds_stacked else 0)
        return super().run_steps(num_steps, program, feed=feed,
                                 fetch_list=fetch_list, scope=scope,
                                 feeds_stacked=feeds_stacked, **kw)

    def compile(self, program: Optional[Program] = None, feed=None,
                fetch_list=None, scope: Optional[Scope] = None,
                is_test: bool = False, num_steps: Optional[int] = None,
                feeds_stacked: bool = False):
        program = self._prepare(program, scope, fetch_list)
        feed = self._local_spec_feeds(program, feed,
                                      1 if feeds_stacked else 0)
        return super().compile(program, feed=feed, fetch_list=fetch_list,
                               scope=scope, is_test=is_test,
                               num_steps=num_steps,
                               feeds_stacked=feeds_stacked)

