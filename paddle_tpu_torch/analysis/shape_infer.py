"""Static shape & dtype inference over the Program IR (counterpart of
``paddle_tpu/analysis/shape_infer.py``: the same rules, the same
``PT010``-``PT012`` findings).

The reference runs per-op ``InferShape`` inside its C++ desc layer the moment
an OpDesc is appended (op_desc.cc InferShape hooks, operator.h
InferShapeContext) — a malformed graph fails at *build* time with the op
named.  The port's executor interprets a program op by op on torch
tensors and captures each step as a CUDA graph, so without this pass a
shape bug surfaces as a torch error deep inside ``Executor.run`` (or in
the middle of a capture).

* :class:`VarInfo` is the abstract value — a shape tuple whose dims may be
  ``-1`` (symbolic: the batch dim of feeds, or anything unknown), a
  :class:`DType`, and the declared lod level.  ``None`` shape means fully
  unknown; unknowns propagate silently so partial programs never
  false-positive.
* Per-op rules are registered next to the implementations via
  ``core.registry.register_shape_fn`` (rule helpers below keep them one-
  liners for the common families); ops whose outputs are bound by a
  sub-block or by decode-time trace-back are enumerated in
  :data:`SHAPE_INFER_ALLOWLIST` — the explicit, tier-1-enforced remainder.
* :func:`run_shape_inference` walks each block in program order, applies
  rules, and reports (codes in analysis.diagnostics):

  - **PT010** the rule itself rejects the inputs (e.g. matmul contraction
    mismatch, elementwise broadcast impossibility);
  - **PT011** the inferred dtype contradicts the declared dtype (different
    numeric *kind*: float vs int vs bool — width-only drift is tolerated
    because AMP computes a float32 program in bfloat16);
  - **PT012** the inferred shape contradicts the declared shape (a dim
    conflicts where both sides are concrete; ``-1`` matches anything).

Numpy has no bfloat16, so a dtype here is a :class:`DType` over the
port's canonical dtype names (``core/types.py``) with numpy's
``name``/``kind``/``itemsize`` — what the rules and the cost model read.
This module imports only numpy and ``core.types``: the ops modules load
it with their rules.  Inference runs at validation time only — never
inside a captured step (the executor memoizes per (program version,
fetches)).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.types import convert_dtype
from .diagnostics import ValidationReport, diag

# canonical name -> (numpy kind, itemsize); bfloat16 is numpy's kind "f"
# and 2 bytes, as the ml_dtypes type the JAX package uses
_DTYPE_FACTS = {
    "bool": ("b", 1), "int8": ("i", 1), "uint8": ("u", 1),
    "int16": ("i", 2), "int32": ("i", 4), "int64": ("i", 8),
    "float16": ("f", 2), "bfloat16": ("f", 2), "float32": ("f", 4),
    "float64": ("f", 8),
}


class DType:
    """A dtype by canonical name, with numpy's ``name``, ``kind`` and
    ``itemsize``; equal to another DType or any spelling
    ``core.types.convert_dtype`` accepts of the same name."""

    __slots__ = ("name",)

    def __init__(self, dtype):
        self.name = dtype.name if isinstance(dtype, DType) \
            else convert_dtype(dtype)

    def _facts(self):
        f = _DTYPE_FACTS.get(self.name)
        if f is None:
            d = np.dtype(self.name)
            f = (d.kind, d.itemsize)
        return f

    @property
    def kind(self) -> str:
        return self._facts()[0]

    @property
    def itemsize(self) -> int:
        return self._facts()[1]

    def __eq__(self, other):
        if isinstance(other, DType):
            return self.name == other.name
        try:
            return self.name == convert_dtype(other)
        except (TypeError, KeyError, ValueError):
            return False

    def __hash__(self):
        return hash(self.name)

    def __repr__(self):
        return f"DType({self.name!r})"

    def __str__(self):
        return self.name


# ---------------------------------------------------------------------------
# Abstract values
# ---------------------------------------------------------------------------


class ShapeError(ValueError):
    """Raised by a shape rule when the op's inputs are statically
    incompatible (reported as PT010 at the op's graph location)."""


class VarInfo:
    """Abstract (shape, dtype, lod_level) of one variable.

    ``shape`` is ``None`` (unknown) or a tuple of ints where ``-1`` marks a
    symbolic/unknown dim; ``dtype`` is ``None`` or a :class:`DType`.
    """

    __slots__ = ("shape", "dtype", "lod_level")

    def __init__(self, shape=None, dtype=None, lod_level: int = 0):
        self.shape = tuple(int(s) for s in shape) if shape is not None \
            else None
        self.dtype = DType(dtype) if dtype is not None else None
        self.lod_level = int(lod_level)

    @property
    def known(self) -> bool:
        return self.shape is not None

    @property
    def ndim(self) -> Optional[int]:
        return None if self.shape is None else len(self.shape)

    def with_shape(self, shape) -> "VarInfo":
        return VarInfo(shape, self.dtype, self.lod_level)

    def with_dtype(self, dtype) -> "VarInfo":
        return VarInfo(self.shape, dtype, self.lod_level)

    def __repr__(self):
        dt = self.dtype.name if self.dtype is not None else "?"
        return f"VarInfo({list(self.shape) if self.known else '?'}, {dt})"


def UNKNOWN() -> VarInfo:
    return VarInfo(None, None)


# ---------------------------------------------------------------------------
# Dim / shape algebra (-1 = unknown, matches anything)
# ---------------------------------------------------------------------------
def dim_ok(a: int, b: int) -> bool:
    return a < 0 or b < 0 or a == b


def unify_dim(a: int, b: int) -> int:
    """Prefer the concrete dim; two concrete dims must already agree."""
    return b if a < 0 else a


def shapes_compatible(a, b) -> bool:
    """Used for declared-vs-inferred comparison.  Ranks must agree (with a
    size-1 escape hatch: () vs (1,) style scalars compare equal — the
    reductions produce rank-0 where the reference declares [1]) and every
    concrete dim pair must match."""
    if a is None or b is None:
        return True
    if len(a) != len(b):
        return _all_ones(a) and _all_ones(b)
    return all(dim_ok(x, y) for x, y in zip(a, b))


def _all_ones(s) -> bool:
    return all(d == 1 for d in s)


def numpy_broadcast(a, b, what: str = "operands"):
    """NumPy-style trailing broadcast of two shapes; raises ShapeError."""
    if a is None or b is None:
        return None
    out = []
    for i in range(1, max(len(a), len(b)) + 1):
        da = a[-i] if i <= len(a) else 1
        db = b[-i] if i <= len(b) else 1
        # a -1 against a 1 stays UNKNOWN (the runtime result is whatever
        # the -1 turns out to be), never collapses to the 1
        if da == 1:
            out.append(db)
        elif db == 1:
            out.append(da)
        elif dim_ok(da, db):
            out.append(unify_dim(da, db))
        else:
            raise ShapeError(
                f"cannot broadcast {what}: {list(a)} vs {list(b)}")
    return tuple(reversed(out))


def prod_dims(dims: Sequence[int]) -> int:
    p = 1
    for d in dims:
        if d < 0:
            return -1
        p *= d
    return p


def conv_out_dim(size: int, k: int, pad: int, stride: int,
                 dilation: int = 1, ceil_mode: bool = False) -> int:
    if size < 0:
        return -1
    eff = dilation * (k - 1) + 1
    num = size + 2 * pad - eff
    if num < 0:
        raise ShapeError(
            f"window (k={k}, dilation={dilation}) larger than padded input "
            f"dim {size}+2*{pad}")
    if ceil_mode:
        return -(-num // stride) + 1
    return num // stride + 1


def first(ins: Dict[str, List[VarInfo]], slot: str) -> VarInfo:
    vals = ins.get(slot)
    return vals[0] if vals else UNKNOWN()


# ---------------------------------------------------------------------------
# Rule helper factories (imported by ops/*.py next to the lowerings)
# ---------------------------------------------------------------------------
def same_as(slot: str = "X", out: str = "Out", dtype=None,
            also: Tuple[str, ...] = ()):
    """Output(s) copy the first input of ``slot``'s shape; optional dtype
    override; ``also`` lists extra output slots with the same info."""

    def rule(op, ins, attrs):
        x = first(ins, slot)
        o = x if dtype is None else x.with_dtype(dtype)
        res = {out: o}
        for extra in also:
            res[extra] = o
        return res

    return rule


def elementwise(out: str = "Out", dtype=None):
    """Describes the ``math_ops._bcast`` lowering exactly: equal shapes
    short-circuit before any axis check; axis -1/None is FULL numpy
    broadcasting of X and Y (Y rank may exceed X's); an explicit axis
    right-pads Y with 1s so it matches a contiguous run of X's dims
    starting at ``axis``, then numpy-broadcasts.  Out shape is the
    broadcast result (not necessarily X's: X dims of 1 widen)."""

    def rule(op, ins, attrs):
        x, y = first(ins, "X"), first(ins, "Y")
        axis = attrs.get("axis", -1)
        out_shape = None
        if x.shape is not None and y.shape is not None:
            if axis in (-1, None) or tuple(x.shape) == tuple(y.shape):
                out_shape = numpy_broadcast(x.shape, y.shape,
                                            f"{op.type} X/Y")
            else:
                trailing = len(x.shape) - axis - len(y.shape)
                if len(y.shape) > len(x.shape) or trailing < 0:
                    raise ShapeError(
                        f"elementwise: bad axis {axis} for shapes "
                        f"{list(x.shape)} {list(y.shape)}")
                y_padded = (1,) * axis + tuple(y.shape) + (1,) * trailing
                out_shape = numpy_broadcast(
                    x.shape, y_padded,
                    f"{op.type} X/Y at axis {axis}")
        o = x if dtype is None else x.with_dtype(dtype)
        if out_shape is not None:
            o = o.with_shape(out_shape)
        return {out: o}

    return rule


def reduce_rule(out: str = "Out"):
    """reduce_op.cc semantics: dim/keep_dim/reduce_all attrs."""

    def rule(op, ins, attrs):
        x = first(ins, "X")
        if x.shape is None:
            return {out: x}
        keep = attrs.get("keep_dim", False)
        if attrs.get("reduce_all", False):
            shape = (1,) * len(x.shape) if keep else ()
            return {out: x.with_shape(shape)}
        dim = attrs.get("dim", [0])
        axes = tuple(dim) if isinstance(dim, (list, tuple)) else (int(dim),)
        nd = len(x.shape)
        for a in axes:
            if not -nd <= a < nd:
                raise ShapeError(
                    f"reduce axis {a} out of range for rank {nd}")
        axes = {a % nd for a in axes}
        if keep:
            shape = tuple(1 if i in axes else d
                          for i, d in enumerate(x.shape))
        else:
            shape = tuple(d for i, d in enumerate(x.shape)
                          if i not in axes)
        return {out: x.with_shape(shape)}

    return rule


def mirror(mapping: Dict[str, str]):
    """Each output slot copies the info of a named input slot — the
    optimizer-op family (ParamOut <- Param, MomentOut <- Moment, ...)."""

    def rule(op, ins, attrs):
        res = {}
        for out_slot, in_slot in mapping.items():
            if op.outputs.get(out_slot):
                res[out_slot] = first(ins, in_slot)
        return res

    return rule


def filled_from_attrs(out: str = "Out", default_dtype="float32"):
    """fill_constant / *_random family: shape + dtype attrs."""

    def rule(op, ins, attrs):
        shape = tuple(int(s) for s in attrs.get("shape", ()))
        dt = attrs.get("dtype", default_dtype)
        return {out: VarInfo(shape, dt)}

    return rule


def passthrough(*slots, out: str = "Out"):
    """First present input slot forwards to ``out`` (feed/fetch)."""

    def rule(op, ins, attrs):
        for s in slots:
            if ins.get(s):
                return {out: ins[s][0]}
        return {}

    return rule


def no_outputs():
    """Side-effect-only ops (save/load/assert): nothing to infer."""

    def rule(op, ins, attrs):
        return {}

    return rule


def squeeze_ids(ids: VarInfo) -> Optional[Tuple[int, ...]]:
    """The id-tensor convention: [..., 1] squeezes its trailing 1
    (lookup_table, one_hot)."""
    if ids.shape is None:
        return None
    s = ids.shape
    if len(s) >= 2 and s[-1] == 1:
        s = s[:-1]
    return s


# ---------------------------------------------------------------------------
# Explicit remainder: the port's ops with NO static rule, the JAX list's
# entries for the ops the port registers.  Every entry is here for a
# reason; tier-1 asserts registered_ops() == rules ∪ this list exactly.
# (The executor runs ``backward`` itself — it is no registered op here —
# and binds its Grads outputs from their declarations, as a rule-less op.)
# ---------------------------------------------------------------------------
SHAPE_INFER_ALLOWLIST = frozenset({
    # control flow: outputs are whatever the sub-block carries bind
    "while", "conditional_block", "rnn", "recurrent",
    # tensor-array writes allocate their buffer from runtime env state
    "write_to_array",
    # beam search: output layout depends on decode-time trace-back
    "beam_search", "beam_search_decode",
})


# ---------------------------------------------------------------------------
# The inference pass
# ---------------------------------------------------------------------------
def _declared_info(block, name: str) -> Optional[VarInfo]:
    v = block._find_var_recursive(name)
    if v is None:
        return None
    return VarInfo(v.shape, v.dtype, v.lod_level)


def _kind(dt: DType) -> str:
    # bool is its own kind; (u)int collapse; float16/bf16/32/64 collapse
    if dt.name == "bool":
        return "b"
    return "f" if dt.kind == "f" else "iu"


def _sub_block_op(op) -> bool:
    from ..core.program import _sub_block_indices
    return bool(_sub_block_indices(op))


def run_shape_inference(program, report: ValidationReport) -> Dict[int, Dict[str, VarInfo]]:
    """Infer shapes/dtypes per block; append PT010/PT011/PT012 findings.

    Returns {block_idx: {var name: VarInfo}} (inspectable by tests).
    Sub-blocks are walked leniently: their binder vars (loop carries, step
    inputs) are seeded from declarations, and unknowns stay silent.
    """
    from ..core.registry import get_shape_fn
    all_known: Dict[int, Dict[str, VarInfo]] = {}
    for block in program.blocks:
        known: Dict[str, VarInfo] = {}
        all_known[block.idx] = known

        def lookup(name: str, _known=known, _block=block) -> VarInfo:
            if name in _known:
                return _known[name]
            # parent block values inferred earlier in program order
            b = _block.parent_block
            while b is not None:
                parent_known = all_known.get(b.idx)
                if parent_known and name in parent_known:
                    return parent_known[name]
                b = b.parent_block
            dec = _declared_info(_block, name)
            return dec if dec is not None else UNKNOWN()

        for op_idx, op in enumerate(block.ops):
            rule = get_shape_fn(op.type)
            outs: Dict[str, List[VarInfo]] = {}
            if rule is not None and not _sub_block_op(op):
                ins = {slot: [lookup(n) for n in names]
                       for slot, names in op.inputs.items() if names}
                try:
                    res = rule(op, ins, op.attrs) or {}
                except ShapeError as e:
                    report.add(diag(
                        "PT010",
                        f"op {op.type!r}: {e}", op=(block.idx, op_idx,
                                                    op.type)))
                    res = {}
                except Exception as e:  # noqa: BLE001 — malformed programs
                    # are exactly the input under validation: a rule that
                    # unpacks a wrong-rank shape or indexes a missing attr
                    # must degrade to a diagnostic, never crash the
                    # verifier with the opaque trace it exists to replace
                    report.add(diag(
                        "PT010",
                        f"op {op.type!r}: shape rule failed on its inputs "
                        f"({type(e).__name__}: {e})",
                        op=(block.idx, op_idx, op.type)))
                    res = {}
                for slot, val in res.items():
                    outs[slot] = val if isinstance(val, list) else [val]
            # bind outputs: inferred info wins; declarations fill the gaps
            for slot, names in op.outputs.items():
                vals = outs.get(slot, [])
                for i, name in enumerate(names):
                    inferred = vals[i] if i < len(vals) else None
                    dec = _declared_info(block, name)
                    if inferred is None or not (inferred.known or
                                                inferred.dtype is not None):
                        known[name] = dec if dec is not None else UNKNOWN()
                        continue
                    if dec is not None:
                        _check_against_declared(
                            report, block, op_idx, op, name, inferred, dec)
                        # lod level is declaration-owned metadata
                        inferred = VarInfo(inferred.shape, inferred.dtype,
                                           dec.lod_level)
                    known[name] = inferred
    return all_known


def _check_against_declared(report, block, op_idx, op, name,
                            inferred: VarInfo, dec: VarInfo):
    loc = (block.idx, op_idx, op.type)
    if inferred.dtype is not None and dec.dtype is not None and \
            _kind(inferred.dtype) != _kind(dec.dtype):
        report.add(diag(
            "PT011",
            f"op {op.type!r} produces dtype {inferred.dtype.name} for "
            f"var {name!r} declared {dec.dtype.name}", op=loc, var=name))
    if inferred.known and dec.known and \
            not shapes_compatible(inferred.shape, dec.shape):
        report.add(diag(
            "PT012",
            f"op {op.type!r} produces shape {list(inferred.shape)} for "
            f"var {name!r} declared {list(dec.shape)}", op=loc, var=name))


def coverage() -> Tuple[int, int]:
    """(ops with a rule, total registered ops)."""
    from ..core.registry import registered_ops, registered_shape_fns
    total = registered_ops()
    return len(registered_shape_fns()), len(total)
