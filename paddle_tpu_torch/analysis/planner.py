"""Sharding planner: propose and statically validate sharding specs
(counterpart of ``paddle_tpu/analysis/planner.py``: the same candidates,
scoring and JSON form, ranked with the H100 cost constants).

It reads the Program IR, enumerates candidate annotation sets for a
given mesh (an axis->size dict), scores them with the static cost model,
checks each with the sharding propagation pass and the PT030/PT031 spec
lints, and returns the winner as plain ``param_specs``/``feed_specs``.
Pure static analysis: nothing runs on a card.  The executor that will
take a plan (``ShardedExecutor(auto_shard=)``) waits for ROADMAP item 7,
and the ``plan`` command line for item 9e.

Candidate enumeration (deliberately small — plans, not a search):

1. **dp** — data parallel only: every feed's batch dim on the batch axis,
   parameters replicated.  Always valid; always the fallback.
2. **megatron** — dp plus Megatron-style tensor splits over the ``tp``
   axis: along each fc chain the first eligible weight splits by columns
   ``(None, 'tp')`` and a consumer weight fed by the col-sharded
   activation splits by rows ``('tp', None)`` (the matched contraction
   one all-reduce sums); lstm/gru gate projections split on the gate dim,
   embedding tables split on the vocab dim.  A dim is eligible only when
   divisible by **128** and by the axis size: 128 is the tile of the
   port's 1x1-conv/GEMM kernel (``kBM = kBN = 128``,
   ``csrc/conv1x1_mm.cu``), so every shard keeps whole tiles.
3. **column** — dp plus every eligible weight column-split (no row pairs:
   each activation all-gathers instead).  Kept as ranking pressure — the
   cost model should prefer megatron when chains exist.

A plan must pass ``run_sharding_lints`` with zero findings before it is
returned; candidates whose propagation reports PT040-class errors are
discarded.  Plans serialize to JSON (``Plan.to_dict``/``from_dict``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

from .diagnostics import ValidationReport
from .cost_model import CostReport, estimate_cost
from .lints import run_sharding_lints
from .shard_prop import (PropagationResult, Spec, normalize_spec,
                         propagate_sharding)

#: the 1x1-conv/GEMM kernel's tile (``kBM = kBN = 128``,
#: ``csrc/conv1x1_mm.cu``): tensor-split dims must divide by this (and by
#: the axis size) so every shard keeps whole tiles
SPLIT_ALIGN = 128


@dataclasses.dataclass
class Plan:
    """One concrete sharding assignment for (program, mesh)."""

    mesh_axes: Dict[str, int]
    batch_axis: str
    param_specs: Dict[str, Spec]
    feed_specs: Dict[str, Spec]
    candidate: str
    cost: Optional[CostReport] = None
    diagnostics: List[str] = dataclasses.field(default_factory=list)

    # -- serialization ------------------------------------------------------
    @staticmethod
    def _encode_spec(spec: Spec):
        return [list(e) if e else None for e in spec]

    @staticmethod
    def _decode_spec(entries) -> Spec:
        # reject null/garbage spec values here, not deep inside the
        # sharding lints
        if not isinstance(entries, (list, tuple)):
            raise TypeError(
                f"plan spec must be a list of per-dim entries, got "
                f"{type(entries).__name__}")
        return normalize_spec(entries)

    def to_dict(self) -> dict:
        d = {
            "version": 1,
            "mesh": dict(self.mesh_axes),
            "batch_axis": self.batch_axis,
            "candidate": self.candidate,
            "param_specs": {k: self._encode_spec(v)
                            for k, v in sorted(self.param_specs.items())},
            "feed_specs": {k: self._encode_spec(v)
                           for k, v in sorted(self.feed_specs.items())},
            "diagnostics": list(self.diagnostics),
        }
        if self.cost is not None:
            d["cost"] = self.cost.to_dict()
            d["per_device_peak_hbm_bytes"] = \
                self.cost.peak_hbm_bytes_per_device
        return d

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @staticmethod
    def from_dict(d: dict) -> "Plan":
        return Plan(
            mesh_axes={str(k): int(v) for k, v in d["mesh"].items()},
            batch_axis=d.get("batch_axis", "dp"),
            param_specs={k: Plan._decode_spec(v)
                         for k, v in d.get("param_specs", {}).items()},
            feed_specs={k: Plan._decode_spec(v)
                        for k, v in d.get("feed_specs", {}).items()},
            candidate=d.get("candidate", "?"),
            diagnostics=list(d.get("diagnostics", [])))

    @staticmethod
    def from_json(s: str) -> "Plan":
        return Plan.from_dict(json.loads(s))

    def render(self) -> str:
        lines = [f"plan [{self.candidate}] over mesh "
                 f"{{{', '.join(f'{a}={s}' for a, s in self.mesh_axes.items())}}}"]
        lines.append("  feed_specs:")
        for k, v in sorted(self.feed_specs.items()):
            lines.append(f"    {k}: {self._encode_spec(v)}")
        lines.append("  param_specs:" if self.param_specs
                     else "  param_specs: (all replicated)")
        for k, v in sorted(self.param_specs.items()):
            lines.append(f"    {k}: {self._encode_spec(v)}")
        if self.cost is not None:
            c = self.cost
            lines.append(
                f"  cost: {c.flops_per_device / 1e9:.2f} GFLOP/device, "
                f"{c.hbm_bytes_per_device / 1e6:.2f} MB HBM traffic, "
                f"{(c.collective_bytes + c.reshard_bytes) / 1e6:.2f} MB "
                f"collectives, proxy {c.step_time_proxy_s * 1e3:.3f} ms")
            lines.append(
                f"  per-device peak HBM estimate: "
                f"{c.peak_hbm_bytes_per_device / 1e6:.2f} MB")
        for dmsg in self.diagnostics:
            lines.append(f"  note: {dmsg}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Candidate enumeration
# ---------------------------------------------------------------------------
def _feed_vars(program):
    out = []
    for b in program.blocks:
        for v in b.vars.values():
            if v.is_data and not v.name.endswith("@LEN") \
                    and not v.name.endswith("@LEN2"):
                out.append(v)
    return out


def _params(program):
    from ..core.program import Parameter
    return [v for v in program.global_block().vars.values()
            if isinstance(v, Parameter)]


def _splittable(dim: int, size: int) -> bool:
    return dim > 0 and dim % SPLIT_ALIGN == 0 and dim % size == 0


def _feed_specs_for(program, mesh_axes, batch_axis) -> Dict[str, Spec]:
    specs: Dict[str, Spec] = {}
    use_dp = int(mesh_axes.get(batch_axis, 1)) > 1
    for v in _feed_vars(program):
        if v.shape is None or len(v.shape) == 0:
            continue
        entries = ((batch_axis,) if use_dp else None,) + \
            (None,) * (len(v.shape) - 1)
        specs[v.name] = entries
    return specs


def _tensor_split_specs(program, mesh_axes, tp_axis: str,
                        megatron: bool) -> Dict[str, Spec]:
    """Megatron assignment over the global block, in program order.

    Tracks which activations are column-sharded: a ``mul`` whose X input
    derives from a col-split product gets its weight row-split (matched
    contraction -> one all-reduce); otherwise an eligible weight starts a
    new column split.  ``megatron=False`` gives the all-column variant.
    """
    size = int(mesh_axes.get(tp_axis, 1))
    if size <= 1:
        return {}
    param_names = {p.name for p in _params(program)}
    specs: Dict[str, Spec] = {}
    col_sharded: set = set()
    gb = program.global_block()
    for op in gb.ops:
        if op.type == "mul":
            ys = op.inputs.get("Y", [])
            xs = op.inputs.get("X", [])
            if ys and ys[0] in specs:
                # reused (tied) weight: its assigned split decides the
                # product — a column split keeps the chain col-sharded,
                # a row split consumes it
                if specs[ys[0]] == (None, (tp_axis,)):
                    col_sharded.update(op.output_names)
                continue
            if ys and ys[0] in param_names:
                w = gb._find_var_recursive(ys[0])
                if w is not None and w.shape is not None \
                        and len(w.shape) == 2:
                    rows, cols = w.shape
                    x_col = bool(xs) and xs[0] in col_sharded
                    if megatron and x_col and _splittable(rows, size):
                        # row-parallel consumer: contraction matches the
                        # col-sharded activation, out is unsharded again
                        specs[ys[0]] = ((tp_axis,), None)
                        continue
                    if not x_col and _splittable(cols, size):
                        specs[ys[0]] = (None, (tp_axis,))
                        col_sharded.update(op.output_names)
                        continue
            # ineligible weight (or non-param operand): the contraction
            # consumes any col-sharded activation, the chain ends here
            continue
        elif op.type == "lstm" or op.type == "gru":
            ws = op.inputs.get("Weight", [])
            if ws and ws[0] in param_names and ws[0] not in specs:
                w = gb._find_var_recursive(ws[0])
                if w is not None and w.shape is not None \
                        and len(w.shape) == 2 \
                        and _splittable(w.shape[1], size):
                    # gate-dim split rides with a col-split input
                    # projection (the fc producing [B,T,4H])
                    specs[ws[0]] = (None, (tp_axis,))
            continue
        elif op.type == "lookup_table":
            ws = op.inputs.get("W", [])
            if ws and ws[0] in param_names and ws[0] not in specs:
                w = gb._find_var_recursive(ws[0])
                if w is not None and w.shape is not None \
                        and len(w.shape) == 2 \
                        and _splittable(w.shape[0], size):
                    # vocab-parallel embedding (the SelectedRows/CTR
                    # analog): a masked partial lookup + all-reduce
                    specs[ws[0]] = ((tp_axis,), None)
            continue
        # col-shardedness flows through shape-preserving glue so the next
        # mul in the chain can see it
        if op.type in ("elementwise_add", "scale", "relu", "tanh",
                       "sigmoid", "gelu", "silu", "swish", "dropout",
                       "softmax", "layer_norm", "brelu", "leaky_relu"):
            ins = op.input_names
            if any(n in col_sharded for n in ins):
                col_sharded.update(op.output_names)
    return specs


def enumerate_candidates(program, mesh_axes: Dict[str, int],
                         batch_axis: str = "dp", tp_axis: str = "tp"
                         ) -> List[Tuple[str, Dict[str, Spec],
                                         Dict[str, Spec]]]:
    """[(name, param_specs, feed_specs)] — dp first, then tensor splits."""
    feeds = _feed_specs_for(program, mesh_axes, batch_axis)
    cands = [("dp", {}, feeds)]
    mega = _tensor_split_specs(program, mesh_axes, tp_axis, megatron=True)
    if mega:
        cands.append(("megatron", mega, feeds))
        col = _tensor_split_specs(program, mesh_axes, tp_axis,
                                  megatron=False)
        if col and col != mega:
            cands.append(("column", col, feeds))
    return cands


# ---------------------------------------------------------------------------
# Planning
# ---------------------------------------------------------------------------
def _score_candidates(program, mesh_axes: Dict[str, int],
                      batch_axis: str, tp_axis: str, assume_batch: int,
                      op_class_ratios: Optional[Dict[str, float]] = None):
    """Propagate + cost every candidate; returns the sorted scored list
    ``[(proxy_s, order, name, param_specs, feed_specs, prop, cost)]``
    best-first."""
    from .shape_infer import run_shape_inference

    shapes = run_shape_inference(program, ValidationReport())
    scored = []
    for name, param_specs, feed_specs in enumerate_candidates(
            program, mesh_axes, batch_axis, tp_axis):
        seeds = dict(param_specs)
        seeds.update(feed_specs)
        prop = propagate_sharding(program, seeds, shapes=shapes)
        cost = estimate_cost(program, mesh_axes, prop, shapes=shapes,
                             assume_batch=assume_batch,
                             batch_axis=batch_axis,
                             op_class_ratios=op_class_ratios)
        scored.append((cost.step_time_proxy_s, len(scored), name,
                       param_specs, feed_specs, prop, cost))
    scored.sort(key=lambda t: (t[0], t[1]))
    return scored


def rank_candidates(program, mesh_axes: Dict[str, int], *,
                    batch_axis: str = "dp", tp_axis: str = "tp",
                    assume_batch: int = 64,
                    op_class_ratios: Optional[Dict[str, float]] = None
                    ) -> List[Tuple[str, float]]:
    """``[(candidate_name, step_time_proxy_s)]`` best-first — exactly the
    scoring :func:`plan` ranks on, exposed so calibration effects
    (``op_class_ratios`` from the opprof table) are inspectable and
    testable: a class correction that flips the ranking here flips the
    shipped plan."""
    mesh_axes = {str(k): int(v) for k, v in (mesh_axes or {}).items()}
    return [(name, proxy) for proxy, _, name, *_ in _score_candidates(
        program, mesh_axes, batch_axis, tp_axis, assume_batch,
        op_class_ratios)]


def plan(program, mesh_axes: Dict[str, int], *, batch_axis: str = "dp",
         tp_axis: str = "tp", assume_batch: int = 64,
         op_class_ratios: Optional[Dict[str, float]] = None) -> Plan:
    """Propose the cheapest statically-valid sharding plan.

    Every candidate is (1) propagated through the IR (PT041/PT042 sites
    feed the cost model's reshard terms), (2) scored by the static cost
    model — with ``op_class_ratios`` (the opprof per-op-class
    calibration, ``attribution.load_op_class_ratios``) folded in when
    given, so measured op-class corrections rank plans instead of the
    data-sheet constants alone — and (3) the winner is re-checked against
    the PT030/PT031 spec lints — a plan that fails them is discarded and
    the next-best is taken, so the returned plan always validates clean
    (the ``dp`` fallback cannot fail: batch dims are symbolic).
    """
    mesh_axes = {str(k): int(v) for k, v in (mesh_axes or {}).items()}
    scored = _score_candidates(program, mesh_axes, batch_axis, tp_axis,
                               assume_batch, op_class_ratios)

    last_err = None
    for _, _, name, param_specs, feed_specs, prop, cost in scored:
        report = ValidationReport()
        run_sharding_lints(program, mesh_axes, report,
                           param_specs=param_specs, feed_specs=feed_specs)
        if report.errors:
            last_err = report
            continue
        notes = [str(d) for d in prop.report]
        if op_class_ratios:
            notes.append(
                f"ranked with op-class calibration "
                f"({len(op_class_ratios)} class(es): "
                f"{', '.join(sorted(op_class_ratios))})")
        return Plan(mesh_axes=mesh_axes, batch_axis=batch_axis,
                    param_specs=dict(param_specs),
                    feed_specs=dict(feed_specs), candidate=name,
                    cost=cost, diagnostics=notes)
    raise ValueError(
        "auto-sharding planner: no candidate passed the sharding lints"
        + ("\n" + last_err.render() if last_err else ""))
