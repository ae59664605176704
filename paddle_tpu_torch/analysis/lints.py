"""Graph lints: dead code, retrace hazards, sharding-spec consistency
(counterpart of ``paddle_tpu/analysis/lints.py``: the same rules).

These are the checks the reference scattered across its runtime — pruning
(framework/prune.cc:51) implicitly defined deadness, re-capture never
existed (per-op kernels), and sharding had no analog at all.  In the
port each has a build-time answer:

* **PT020** (warning) *dead op*: unreachable from any fetch target, any
  persistable-state write, and any side-effect op.  A dead op still runs
  in every interpreted step and inside every captured CUDA graph — the
  executor does not prune — so it costs device time each replay; it is
  graph noise the author should see.  Runs only when fetch targets are
  known (``Program.validate(fetch_list=...)`` or the Executor paths).
* **PT021** (warning) *feed-signature instability*: a feed (``is_data``)
  var whose declared shape cannot pin a stable step key — no static
  shape at all, or symbolic ``-1`` dims beyond the batch/sequence prefix
  the feeder controls.  Each novel concrete shape is a new key of the
  captured-step cache: an interpreted warm-up step, a new CUDA-graph
  capture and a private memory pool before it replays (``Executor``'s
  docstring; ROADMAP item 1's note on shape-changing traffic).  The JAX
  package's retrace + recompile is the same hazard.
* **PT022** (warning) *persistable rebound*: an op overwrites persistable
  state without reading it.  State written per step from fresh values
  changes the captured step's state signature when its shape or dtype
  drifts (a new key, a new capture) — the reference had no such hazard
  because scope vars were host objects.  Input-less writers are exempt:
  that is the normal startup-program initializer pattern.
* **PT030/PT031** (error) *sharding-spec consistency*: every axis a
  ``Parameter.sharding`` spec (or a ``param_specs``/``feed_specs``
  override) names must exist on the mesh, and every sharded dim must
  divide by the product of its axis sizes.  The port has no multi-card
  executor yet (ROADMAP item 7), so the mesh is an axis->size dict; the
  lints and the planner read the same specs the reference's
  ``ShardedExecutor`` takes.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set

from ..core.program import LEN2_SUFFIX, LEN_SUFFIX, _sub_block_indices
from .diagnostics import ValidationReport, diag
from .verifier import SIDE_EFFECT_OPS

# feeds may carry -1 in the batch dim plus one dynamic dim per lod level
# (the padded time dims the DataFeeder buckets); anything else retraces
_DYNAMIC_PREFIX_BASE = 1


# ---------------------------------------------------------------------------
# PT020: dead ops
# ---------------------------------------------------------------------------
def run_dead_op_lint(program, fetch_names: Sequence[str],
                     report: ValidationReport):
    """Backward reachability from fetches + persistable writes + side
    effects.  Deliberately NOT shared with ``Program.prune``'s walk
    (core/program.py): prune computes the minimal fetch slice, while this
    lint's liveness is broader — state updates stay live (an optimizer op
    IS the point of a train program) and so do side-effect ops — so the
    two would disagree by design."""
    block = program.global_block()
    persistable: Set[str] = {
        v.name for b in program.blocks for v in b.vars.values()
        if v.persistable}

    needed: Set[str] = set(fetch_names)
    # length companions ride with their base fetch — in both directions:
    # fetching a base keeps its @LEN/@LEN2 alive, and fetching a companion
    # alone (a supported executor pattern) must reach the base's producer,
    # whose output_names contain only the base
    for n in list(needed):
        needed.add(n + LEN_SUFFIX)
        needed.add(n + LEN2_SUFFIX)
        while n.endswith(LEN_SUFFIX) or n.endswith(LEN2_SUFFIX):
            n = n[:-len(LEN2_SUFFIX)] if n.endswith(LEN2_SUFFIX) \
                else n[:-len(LEN_SUFFIX)]
            needed.add(n)
    live: List[bool] = [False] * len(block.ops)
    for idx in range(len(block.ops) - 1, -1, -1):
        op = block.ops[idx]
        out_names = set(op.output_names)
        is_live = (
            bool(out_names & needed)
            or op.type in SIDE_EFFECT_OPS
            or bool(out_names & persistable)
        )
        if not is_live:
            continue
        live[idx] = True
        needed.update(op.input_names)
        for n in op.input_names:
            needed.add(n + LEN_SUFFIX)
            needed.add(n + LEN2_SUFFIX)
        # a live op keeps everything its sub-blocks read live too —
        # TRANSITIVELY, so a doubly-nested body (rnn inside rnn) still
        # pins its global-block producers
        stack = list(_sub_block_indices(op))
        seen: Set[int] = set()
        while stack:
            bi = stack.pop()
            if bi in seen or bi >= len(program.blocks):
                continue
            seen.add(bi)
            for sop in program.blocks[bi].ops:
                needed.update(sop.input_names)
                stack.extend(_sub_block_indices(sop))
    for idx, op in enumerate(block.ops):
        if not live[idx]:
            report.add(diag(
                "PT020",
                f"op {op.type!r} (outputs {sorted(op.output_names)}) is "
                f"unreachable from fetch targets "
                f"{sorted(set(fetch_names))}, state writes and side "
                f"effects — dead code", op=(0, idx, op.type)))


# ---------------------------------------------------------------------------
# PT021 / PT022: retrace hazards
# ---------------------------------------------------------------------------
def run_retrace_lints(program, report: ValidationReport):
    for b in program.blocks:
        for v in b.vars.values():
            if not v.is_data:
                continue
            if v.shape is None:
                report.add(diag(
                    "PT021",
                    f"feed var {v.name!r} declares no static shape: every "
                    f"novel feed shape compiles a new step variant",
                    var=v.name))
                continue
            allowed_prefix = _DYNAMIC_PREFIX_BASE + v.lod_level
            bad = [i for i, d in enumerate(v.shape)
                   if d == -1 and i >= allowed_prefix]
            if bad:
                report.add(diag(
                    "PT021",
                    f"feed var {v.name!r} shape {list(v.shape)} has "
                    f"symbolic dims at position(s) {bad} beyond the "
                    f"batch/sequence prefix — each distinct concrete "
                    f"shape retraces and recompiles", var=v.name))

    persistable: Set[str] = {
        v.name for b in program.blocks for v in b.vars.values()
        if v.persistable}
    block = program.global_block()
    for idx, op in enumerate(block.ops):
        if not op.inputs or not any(op.input_names):
            continue        # initializer pattern (startup program)
        if _sub_block_indices(op):
            continue        # loop carries legitimately rebind
        in_names = set(op.input_names)
        for name in op.output_names:
            if name in persistable and name not in in_names:
                report.add(diag(
                    "PT022",
                    f"op rebinds persistable var {name!r} without reading "
                    f"it — per-step state rebinding defeats donation and "
                    f"risks signature drift (retrace per step)",
                    op=(0, idx, op.type), var=name))


# ---------------------------------------------------------------------------
# PT030 / PT031: sharding-spec consistency
# ---------------------------------------------------------------------------
def _axes_of(entry) -> List[str]:
    if entry is None:
        return []
    if isinstance(entry, (list, tuple)):
        return [str(a) for a in entry]
    return [str(entry)]


def _spec_entries(spec) -> List:
    """Spec tuple / list -> list of per-dim entries."""
    return list(spec)


def run_sharding_lints(program, mesh_axes: Optional[Dict[str, int]],
                       report: ValidationReport,
                       param_specs: Optional[Dict] = None,
                       feed_specs: Optional[Dict] = None):
    """Validate every sharding spec against the mesh.  ``mesh_axes`` maps
    axis name -> size; None skips the pass (no mesh context)."""
    if mesh_axes is None:
        return
    specs: Dict[str, tuple] = {}
    for b in program.blocks:
        for v in b.vars.values():
            sh = getattr(v, "sharding", None)
            if sh:
                specs[v.name] = ("parameter", sh, v.shape)
    for name, spec in (param_specs or {}).items():
        v = None
        for b in program.blocks:
            if name in b.vars:
                v = b.vars[name]
                break
        specs[name] = ("param_specs override", spec,
                       v.shape if v is not None else None)
    for name, spec in (feed_specs or {}).items():
        # feeds shard the batch dim (-1): only axis names are checkable
        specs[name] = ("feed_specs override", spec, None)

    for name, (origin, spec, shape) in sorted(specs.items()):
        entries = _spec_entries(spec)
        booked: Dict[str, int] = {}
        for dim_idx, entry in enumerate(entries):
            for ax in _axes_of(entry):
                if ax in booked:
                    # a spec may not use one mesh axis to shard two
                    # different dims of the same tensor
                    report.add(diag(
                        "PT040",
                        f"{origin} for {name!r}: mesh axis {ax!r} shards "
                        f"both dim {booked[ax]} and dim {dim_idx} — an "
                        f"axis can partition at most one dim", var=name))
                else:
                    booked[ax] = dim_idx
        if shape is not None and len(entries) > len(shape):
            report.add(diag(
                "PT031",
                f"{origin} for {name!r}: spec {entries} has more entries "
                f"than the var has dims ({list(shape)})", var=name))
        for dim_idx, entry in enumerate(entries):
            axes = _axes_of(entry)
            size = 1
            for ax in axes:
                if ax not in mesh_axes:
                    report.add(diag(
                        "PT030",
                        f"{origin} for {name!r}: axis {ax!r} is not a "
                        f"mesh axis (mesh has "
                        f"{sorted(mesh_axes)})", var=name))
                else:
                    size *= int(mesh_axes[ax])
            if size <= 1 or shape is None or dim_idx >= len(shape):
                continue
            d = shape[dim_idx]
            if d >= 0 and d % size != 0:
                report.add(diag(
                    "PT031",
                    f"{origin} for {name!r}: dim {dim_idx} (size {d}) is "
                    f"not divisible by the sharding extent {size} "
                    f"({_axes_of(entry)})", var=name))


def mesh_axes_of(mesh) -> Optional[Dict[str, int]]:
    """Normalize an axis->size dict / None into {axis: size}.  (The port
    has no mesh object before ROADMAP item 7.)"""
    if mesh is None:
        return None
    if isinstance(mesh, dict):
        return {str(k): int(v) for k, v in mesh.items()}
    raise TypeError(
        f"mesh must be an axis->size dict, got {type(mesh).__name__}")
