"""Sharding propagation over the Program IR (counterpart of
``paddle_tpu/analysis/shard_prop.py``: the same spec algebra, helper
factories, PT040-PT042 and the forward/backward sweeps).

The reference framework distributes by *infrastructure*: a transpiler
rewrites the program into pserver/trainer halves and hand-placed
collectives.  The JAX package instead annotates inputs and lets the
compiler propagate; this pass recovers that propagation statically, over
the same Program IR the shape verifier walks, so the planner
(:mod:`.planner`) can reason about a candidate spec set without running
anything.  The port runs on one card until ROADMAP item 7 brings a
multi-card executor; its plans and diagnostics are what that executor
will read.

* The abstract value is a **per-dim sharding spec**: a tuple with one entry
  per tensor dim — ``None`` (replicated) or a tuple of mesh axis names.
  Unknown vars carry no spec; specs only ever *refine* (``None`` entries
  may gain axes).
* Per-op propagation rules are registered next to the implementations via
  ``core.registry.register_shard_fn`` — the distributed companion of
  ``register_shape_fn``, with the same ``fn(op, ins, attrs)`` shape; the
  helper factories below keep the common families one-liners and attach a
  ``.backward`` sweep direction so annotations flow both ways (a sharded
  loss constraint reaches its producers, a sharded feed reaches consumers).
* Conflicts are *diagnostics*, not crashes (codes in analysis.diagnostics):

  - **PT041** (warning) two shardings meet at an op in a way its rule
    cannot realize without data movement — a reshard (all-gather /
    all-to-all) is needed there; the cost model charges for it.
  - **PT042** (warning) a sharded value flows into an op with no shard
    rule: a propagation blind spot — downstream is treated replicated
    (the planner sees a pessimistic bound).
  - **PT040** (error, emitted by the spec lints) one mesh axis sharding
    two dims of the same tensor.

Propagation runs at planning/validation time only, never in a captured
step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from .diagnostics import ValidationReport, diag

#: normalized per-dim entry: None (replicated) or a tuple of axis names
Entry = Optional[Tuple[str, ...]]
#: normalized spec: one Entry per dim
Spec = Tuple[Entry, ...]


class ShardConflict(ValueError):
    """Raised by a shard rule when input shardings cannot meet at this op
    without a reshard (reported as PT041 at the op's graph location)."""


# ---------------------------------------------------------------------------
# Spec algebra
# ---------------------------------------------------------------------------
def _entry(e) -> Entry:
    if e is None:
        return None
    if isinstance(e, (list, tuple)):
        t = tuple(str(a) for a in e)
        return t or None
    return (str(e),)


def normalize_spec(spec, ndim: Optional[int] = None) -> Optional[Spec]:
    """Spec tuple / list -> canonical per-dim entries, padded or
    truncated to ``ndim`` when the rank is known."""
    if spec is None:
        return None
    entries = tuple(_entry(e) for e in list(spec))
    if ndim is not None:
        entries = entries[:ndim] + (None,) * max(0, ndim - len(entries))
    return entries


def merge_entry(a: Entry, b: Entry, what: str) -> Entry:
    """The merge rule: replicated yields to sharded; two different
    shardings on one dim cannot meet without a reshard."""
    if a is None:
        return b
    if b is None:
        return a
    if a == b:
        return a
    raise ShardConflict(f"{what}: {list(a)} vs {list(b)}")


def merge_specs(a: Optional[Spec], b: Optional[Spec], what: str
                ) -> Optional[Spec]:
    if a is None:
        return b
    if b is None:
        return a
    n = max(len(a), len(b))
    ea = a + (None,) * (n - len(a))
    eb = b + (None,) * (n - len(b))
    return tuple(merge_entry(x, y, f"{what} dim {i}")
                 for i, (x, y) in enumerate(zip(ea, eb)))


def spec_extent(spec: Optional[Spec], mesh_axes: Dict[str, int],
                dim: Optional[int] = None) -> int:
    """Product of mesh-axis sizes sharding ``spec`` (or one dim of it)."""
    if spec is None:
        return 1
    entries = spec if dim is None else spec[dim:dim + 1]
    ext = 1
    for e in entries:
        for ax in (e or ()):
            ext *= int(mesh_axes.get(ax, 1))
    return ext


def is_sharded(spec: Optional[Spec]) -> bool:
    return spec is not None and any(e for e in spec)


class ShardInfo:
    """Abstract (sharding spec, static shape) of one variable, as shard
    rules see their inputs.  ``spec`` is None while unknown; ``shape`` comes
    from the shape-inference pass (dims may be -1)."""

    __slots__ = ("spec", "shape")

    def __init__(self, spec: Optional[Spec] = None, shape=None):
        self.spec = spec
        self.shape = tuple(shape) if shape is not None else None

    @property
    def ndim(self) -> Optional[int]:
        if self.shape is not None:
            return len(self.shape)
        return None if self.spec is None else len(self.spec)

    def entry(self, i: int) -> Entry:
        """Entry for dim ``i`` (negative ok); None when unknown/oob."""
        if self.spec is None:
            return None
        n = len(self.spec)
        if -n <= i < n:
            return self.spec[i]
        return None

    def dim(self, i: int) -> int:
        if self.shape is None:
            return -1
        n = len(self.shape)
        return self.shape[i] if -n <= i < n else -1

    def __repr__(self):
        return f"ShardInfo({self.spec}, shape={self.shape})"


def first_in(ins: Dict[str, List[ShardInfo]], slot: str) -> ShardInfo:
    vals = ins.get(slot)
    return vals[0] if vals else ShardInfo()


#: rule return value meaning "replicated, rank taken from the declared
#: shape" — normalize_spec pads it with None entries
REPLICATED: Spec = ()


def squeeze_spec_ids(ids: ShardInfo) -> Spec:
    """The id-tensor convention mirrored from shape_infer.squeeze_ids:
    ``[..., 1]`` drops its trailing entry (lookup_table, one_hot)."""
    if ids.spec is None:
        return (None,)
    if ids.shape is not None and len(ids.shape) >= 2 and \
            ids.shape[-1] == 1:
        return ids.spec[:-1]
    return ids.spec


# ---------------------------------------------------------------------------
# Rule helper factories (imported by ops/*.py next to the lowerings)
# ---------------------------------------------------------------------------
def shard_same_as(slot: str = "X", out: str = "Out",
                  also: Tuple[str, ...] = ()):
    """Output(s) carry the input's sharding dim-for-dim (elementwise /
    shape-preserving ops); backward flows the output spec to the input."""

    def rule(op, ins, attrs):
        x = first_in(ins, slot)
        res = {out: x.spec}
        for extra in also:
            res[extra] = x.spec
        return res

    def backward(op, outs, ins, attrs):
        return {slot: first_in(outs, out).spec}

    rule.backward = backward
    return rule


def shard_elementwise(out: str = "Out"):
    """Broadcast-aware merge of X and Y: aligned dims must agree (size-1
    dims yield to the other side); honors the explicit ``axis`` attr the
    same way the lowering does."""

    def _align(x: ShardInfo, y: ShardInfo, attrs):
        nx, ny = x.ndim, y.ndim
        if nx is None or ny is None:
            return None
        n = max(nx, ny)
        axis = attrs.get("axis", -1)
        # explicit axis: y's dims map onto x's [axis, axis+ny); otherwise
        # numpy trailing alignment for BOTH operands
        explicit = axis not in (-1, None) and ny < nx
        entries: List[Entry] = []
        for i in range(n):
            jx = i if explicit else i - (n - nx)
            jy = (i - axis) if explicit else i - (n - ny)
            ex = x.entry(jx) if 0 <= jx < nx else None
            ey = y.entry(jy) if 0 <= jy < ny else None
            dx = x.dim(jx) if 0 <= jx < nx else 1
            dy = y.dim(jy) if 0 <= jy < ny else 1
            if dy == 1:
                entries.append(ex)
            elif dx == 1:
                entries.append(ey)
            else:
                entries.append(merge_entry(
                    ex, ey, f"elementwise operands dim {i}"))
        return tuple(entries)

    def rule(op, ins, attrs):
        x, y = first_in(ins, "X"), first_in(ins, "Y")
        if x.spec is None and y.spec is None:
            return {}
        spec = _align(x, y, attrs)
        return {} if spec is None else {out: spec}

    def backward(op, outs, ins, attrs):
        o = first_in(outs, out)
        if o.spec is None:
            return {}
        res = {}
        for slot in ("X", "Y"):
            v = first_in(ins, slot)
            n = v.ndim
            if n is None:
                continue
            # trailing alignment; broadcast (size-1) dims stay replicated
            spec = tuple(
                o.entry(len(o.spec) - n + i)
                if v.dim(i) != 1 and len(o.spec) - n + i >= 0 else None
                for i in range(n)) if o.spec else None
            res[slot] = spec
        return res

    rule.backward = backward
    return rule


def shard_reduce(out: str = "Out"):
    """reduce_op semantics on specs: reduced dims drop their sharding (the
    partial results all-reduce, charged by the cost model)."""

    def rule(op, ins, attrs):
        x = first_in(ins, "X")
        if x.spec is None:
            return {}
        if attrs.get("reduce_all", False):
            keep = attrs.get("keep_dim", False)
            return {out: (None,) * len(x.spec) if keep else REPLICATED}
        dim = attrs.get("dim", [0])
        axes = tuple(dim) if isinstance(dim, (list, tuple)) else (int(dim),)
        nd = len(x.spec)
        axes = {a % nd for a in axes if -nd <= a < nd}
        if attrs.get("keep_dim", False):
            spec = tuple(None if i in axes else e
                         for i, e in enumerate(x.spec))
        else:
            spec = tuple(e for i, e in enumerate(x.spec) if i not in axes)
        return {out: spec}

    return rule


def shard_mirror(mapping: Dict[str, str], check_grad: bool = False):
    """Each output slot carries its named input slot's sharding — the
    optimizer-op family.  ``check_grad`` also merges Param vs Grad (a
    dp-reduced grad arrives with the param's layout; a mismatch means a
    reshard in the update step)."""

    def rule(op, ins, attrs):
        if check_grad:
            p, g = first_in(ins, "Param"), first_in(ins, "Grad")
            merge_specs(p.spec, g.spec, "Param vs Grad sharding")
        res = {}
        for out_slot, in_slot in mapping.items():
            if op.outputs.get(out_slot):
                res[out_slot] = first_in(ins, in_slot).spec
        return res

    def backward(op, outs, ins, attrs):
        res = {}
        for out_slot, in_slot in mapping.items():
            o = first_in(outs, out_slot)
            if o.spec is not None:
                res[in_slot] = o.spec
        return res

    rule.backward = backward
    return rule


def shard_replicated(*out_slots: str):
    """Outputs are replicated regardless of inputs (scalar reductions,
    side-effect ops, shape probes)."""
    slots = out_slots or ("Out",)

    def rule(op, ins, attrs):
        return {s: REPLICATED for s in slots}

    return rule


def shard_batch_only(slot: str = "X", out: str = "Out",
                     fallbacks: Tuple[str, ...] = (),
                     also: Tuple[str, ...] = ()):
    """Outputs follow the batch (dim 0) sharding of the first input slot
    that carries one; other dims replicate.  Covers loss heads
    ([B, ...] -> [B, 1]) and the whole batch-preserving reduction family
    (detection heads, NCE, CRF, index/selection ops) — ``fallbacks``
    lists further input slots to probe, ``also`` extra output slots
    (slots absent on a given op are ignored by the pass)."""

    def probe(ins):
        for s in (slot,) + tuple(fallbacks):
            x = first_in(ins, s)
            if x.spec is not None:
                return x
        return None

    def rule(op, ins, attrs):
        x = probe(ins)
        if x is None:
            return {}
        return {s: (x.entry(0),) for s in (out,) + tuple(also)}

    def backward(op, outs, ins, attrs):
        o = first_in(outs, out)
        if o.spec is None:
            return {}
        return {slot: (o.entry(0),)}

    rule.backward = backward
    return rule


def shard_noop():
    """Op is sharding-transparent or data-dependent: claim nothing about
    its outputs, but do not flag it as a blind spot (registering the noop
    IS the statement that replication is the intended treatment)."""

    def rule(op, ins, attrs):
        return {}

    return rule


def shard_mul():
    """``mul`` (the fc matmul): X flattened at x_num_col_dims, Y at
    y_num_col_dims.  Row dims follow X, col dims follow Y; the contraction
    dims must carry the SAME sharding on both sides (Megatron row-parallel:
    col-sharded activations meet row-sharded weights and one all-reduce
    sums the partial products) — one-sided contraction sharding is a
    reshard."""

    def rule(op, ins, attrs):
        x, y = first_in(ins, "X"), first_in(ins, "Y")
        if x.spec is None and y.spec is None:
            return {}
        xn = attrs.get("x_num_col_dims", 1)
        yn = attrs.get("y_num_col_dims", 1)
        cx = tuple((x.entry(i) for i in range(xn, len(x.spec)))) \
            if x.spec is not None else (None,)
        cy = tuple((y.entry(i) for i in range(yn))) \
            if y.spec is not None else (None,)
        kx = next((e for e in cx if e), None)
        ky = next((e for e in cy if e), None)
        if kx != ky:
            raise ShardConflict(
                f"mul contraction sharding mismatch: X[{xn}:] carries "
                f"{kx and list(kx)} vs Y[:{yn}] {ky and list(ky)}")
        rows = tuple(x.entry(i) for i in range(xn)) if x.spec is not None \
            else (None,) * xn
        cols = tuple(y.entry(i) for i in range(yn, len(y.spec))) \
            if y.spec is not None else (None,)
        return {"Out": rows + cols}

    def backward(op, outs, ins, attrs):
        o = first_in(outs, "Out")
        if o.spec is None:
            return {}
        xn = attrs.get("x_num_col_dims", 1)
        res = {}
        x, y = first_in(ins, "X"), first_in(ins, "Y")
        if x.ndim is not None:
            res["X"] = tuple(o.entry(i) if i < xn else None
                             for i in range(x.ndim))
        if y.ndim is not None:
            yn = attrs.get("y_num_col_dims", 1)
            res["Y"] = tuple(
                None if i < yn else o.entry(xn + (i - yn))
                for i in range(y.ndim))
        return res

    rule.backward = backward
    return rule


def shard_matmul():
    """matmul: batch dims merge elementwise; the contraction pair must
    agree (transpose attrs honored); Out last two dims follow X row / Y
    col."""

    def rule(op, ins, attrs):
        x, y = first_in(ins, "X"), first_in(ins, "Y")
        if x.spec is None and y.spec is None:
            return {}
        nx, ny = x.ndim, y.ndim
        if nx is None or ny is None or nx < 2 or ny < 2:
            return {}
        tx = attrs.get("transpose_X", False)
        ty = attrs.get("transpose_Y", False)
        x_row, x_k = (-1, -2) if tx else (-2, -1)
        y_k, y_col = (-1, -2) if ty else (-2, -1)
        kx, ky = x.entry(x_k), y.entry(y_k)
        if kx != ky and (kx or ky):
            raise ShardConflict(
                f"matmul contraction sharding mismatch: "
                f"{kx and list(kx)} vs {ky and list(ky)}")
        nb = max(nx, ny) - 2
        batch = []
        for i in range(nb):
            ex = x.entry(i - (nb - (nx - 2))) if i >= nb - (nx - 2) else None
            ey = y.entry(i - (nb - (ny - 2))) if i >= nb - (ny - 2) else None
            batch.append(merge_entry(ex, ey, f"matmul batch dim {i}"))
        return {"Out": tuple(batch) + (x.entry(x_row), y.entry(y_col))}

    return rule


def shard_conv2d(in_slot: str = "Input", filt_slot: str = "Filter",
                 out: str = "Output"):
    """conv2d family: Out batch follows Input batch, Out channels follow
    Filter dim 0; spatial sharding is a halo exchange this model does not
    attempt (conflict -> reshard); the channel contraction (Input C vs
    Filter I) must agree like mul's."""

    def rule(op, ins, attrs):
        x, w = first_in(ins, in_slot), first_in(ins, filt_slot)
        if x.spec is None and w.spec is None:
            return {}
        if x.spec is not None and any(x.entry(i) for i in (2, 3)):
            raise ShardConflict(
                "conv2d input spatially sharded: halo exchange required")
        kx, kw = x.entry(1), w.entry(1)
        if kx != kw and (kx or kw):
            raise ShardConflict(
                f"conv2d channel contraction sharding mismatch: "
                f"{kx and list(kx)} vs {kw and list(kw)}")
        return {out: (x.entry(0), w.entry(0), None, None)}

    def backward(op, outs, ins, attrs):
        o = first_in(outs, out)
        if o.spec is None:
            return {}
        res = {}
        x, w = first_in(ins, in_slot), first_in(ins, filt_slot)
        if x.ndim is not None:
            res[in_slot] = (o.entry(0),) + (None,) * (x.ndim - 1)
        if w.ndim is not None:
            res[filt_slot] = (o.entry(1),) + (None,) * (w.ndim - 1)
        return res

    rule.backward = backward
    return rule


# ---------------------------------------------------------------------------
# The propagation pass
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class PropagationResult:
    """Outcome of :func:`propagate_sharding`.

    ``specs`` maps var name -> normalized Spec for every var the sweeps
    reached; ``report`` carries PT041/PT042 findings; ``resharded`` lists
    (block_idx, op_idx, op_type, note) conflict sites for the cost model;
    ``blind_spots`` lists (block_idx, op_idx, op_type) uncovered ops a
    sharded value reached.
    """

    specs: Dict[str, Spec]
    report: ValidationReport
    resharded: List[Tuple[int, int, str, str]]
    blind_spots: List[Tuple[int, int, str]]


def _shapes_of(program, shapes):
    if shapes is not None:
        return shapes
    from .shape_infer import run_shape_inference
    return run_shape_inference(program, ValidationReport())


def propagate_sharding(program, seeds: Dict[str, Sequence],
                       report: Optional[ValidationReport] = None,
                       shapes=None, max_sweeps: int = 4
                       ) -> PropagationResult:
    """Propagate per-dim sharding annotations to a fixpoint.

    ``seeds`` maps var name -> spec (a tuple of entries) —
    typically the planner's candidate ``param_specs`` + ``feed_specs`` plus
    any ``Parameter.sharding`` annotations.  Seeded entries are pinned: a
    sweep refining a seed's non-None entry to something else is a PT041
    conflict, and the seed wins.  ``shapes`` may pass a precomputed
    ``run_shape_inference`` result.

    Sub-block ops are skipped (their carries stay at their seeded specs);
    the single ``backward`` pseudo-op is special-cased — each declared
    ``<param>@GRAD`` carries its parameter's sharding, which is what a
    data-parallel backward produces.
    """
    from ..core.program import _sub_block_indices
    from ..core.registry import get_shard_fn

    report = report if report is not None else ValidationReport()
    all_shapes = _shapes_of(program, shapes)

    def var_shape(block_idx: int, name: str):
        info = all_shapes.get(block_idx, {}).get(name)
        if info is not None and info.shape is not None:
            return info.shape
        for b in program.blocks:
            v = b.vars.get(name)
            if v is not None:
                return v.shape
        return None

    def ndim_of(block_idx: int, name: str):
        s = var_shape(block_idx, name)
        return None if s is None else len(s)

    specs: Dict[str, Spec] = {}
    pinned: Dict[str, Spec] = {}
    for name, spec in (seeds or {}).items():
        nd = ndim_of(0, name)
        norm = normalize_spec(spec, nd)
        if norm is not None:
            specs[name] = norm
            pinned[name] = norm
    for b in program.blocks:
        for v in b.vars.values():
            sh = getattr(v, "sharding", None)
            if sh and v.name not in specs:
                norm = normalize_spec(sh, ndim_of(b.idx, v.name))
                specs[v.name] = norm
                pinned[v.name] = norm

    conflicts: Dict[Tuple[int, int, str, str], None] = {}
    blind: Dict[Tuple[int, int, str], None] = {}

    def info_for(block_idx: int, name: str) -> ShardInfo:
        return ShardInfo(specs.get(name), var_shape(block_idx, name))

    def bind(loc, names_specs) -> bool:
        """Merge new specs into the state; returns True on change."""
        changed = False
        for name, spec, nd in names_specs:
            norm = normalize_spec(spec, nd)
            if norm is None:
                continue
            old = specs.get(name)
            try:
                merged = merge_specs(old, norm, f"var {name!r}")
                # an axis landing on two dims of one var (e.g. two
                # differently-sharded operands merging elementwise) is a
                # reshard, not a legal spec — keep the first booking
                booked: Dict[str, int] = {}
                fixed = []
                for i, e in enumerate(merged):
                    kept = []
                    for ax in (e or ()):
                        if ax in booked:
                            raise ShardConflict(
                                f"var {name!r}: axis {ax!r} would shard "
                                f"both dim {booked[ax]} and dim {i}")
                        booked[ax] = i
                        kept.append(ax)
                    fixed.append(tuple(kept) or None)
                merged = tuple(fixed)
            except ShardConflict as e:
                conflicts.setdefault(loc + (str(e),))
                continue
            if name in pinned and merged != pinned[name]:
                try:
                    merged = merge_specs(pinned[name], merged, name)
                except ShardConflict as e:
                    conflicts.setdefault(loc + (str(e),))
                    merged = pinned[name]
            if merged != old:
                specs[name] = merged
                changed = True
        return changed

    def run_rule(block, op_idx, op, direction: str) -> bool:
        loc = (block.idx, op_idx, op.type)
        if op.type == "backward":
            params = op.attrs.get("params", [])
            grads = op.outputs.get("Grads", [])
            updates = []
            for p, g in zip(params, grads):
                if p in specs:
                    updates.append((g, specs[p], ndim_of(block.idx, g)))
            return bind(loc, updates)
        rule = get_shard_fn(op.type)
        ins = {slot: [info_for(block.idx, n) for n in names]
               for slot, names in op.inputs.items() if names}
        if rule is None:
            if any(is_sharded(i.spec) for vs in ins.values() for i in vs):
                blind.setdefault((block.idx, op_idx, op.type))
            return False
        outs = {slot: [info_for(block.idx, n) for n in names]
                for slot, names in op.outputs.items() if names}
        try:
            if direction == "forward":
                res = rule(op, ins, op.attrs) or {}
                slot_names = op.outputs
            else:
                bwd = getattr(rule, "backward", None)
                if bwd is None:
                    return False
                res = bwd(op, outs, ins, op.attrs) or {}
                slot_names = op.inputs
        except ShardConflict as e:
            conflicts.setdefault(loc + (str(e),))
            return False
        except Exception as e:  # noqa: BLE001 — a rule crashing on a
            # malformed program must degrade like shape rules do, not
            # take down the planner
            conflicts.setdefault(
                loc + (f"shard rule failed ({type(e).__name__}: {e})",))
            return False
        updates = []
        for slot, val in res.items():
            vals = val if isinstance(val, list) else [val]
            names = slot_names.get(slot, [])
            for i, name in enumerate(names):
                if i < len(vals) and vals[i] is not None:
                    updates.append((name, vals[i],
                                    ndim_of(block.idx, name)))
        return bind(loc, updates)

    for _ in range(max_sweeps):
        changed = False
        for block in program.blocks:
            for op_idx, op in enumerate(block.ops):
                if _sub_block_indices(op):
                    continue
                changed |= run_rule(block, op_idx, op, "forward")
        for block in reversed(program.blocks):
            for op_idx in range(len(block.ops) - 1, -1, -1):
                op = block.ops[op_idx]
                if _sub_block_indices(op):
                    continue
                changed |= run_rule(block, op_idx, op, "backward")
        if not changed:
            break

    resharded = []
    for (bi, oi, typ, note) in conflicts:
        resharded.append((bi, oi, typ, note))
        report.add(diag(
            "PT041",
            f"op {typ!r}: sharding conflict — {note}; a reshard "
            f"(all-gather/all-to-all) is needed here", op=(bi, oi, typ)))
    blind_spots = []
    for (bi, oi, typ) in blind:
        blind_spots.append((bi, oi, typ))
        report.add(diag(
            "PT042",
            f"op {typ!r} has no register_shard_fn rule but receives a "
            f"sharded input — propagation treats its outputs as "
            f"replicated (planner blind spot)", op=(bi, oi, typ)))
    return PropagationResult(specs=specs, report=report,
                             resharded=resharded, blind_spots=blind_spots)
