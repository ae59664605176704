"""Static cost & memory model over the Program IR (counterpart of
``paddle_tpu/analysis/cost_model.py``: the same FLOP, byte, collective
and peak-memory arithmetic, with one H100's constants).

Ranks candidate sharding plans *analytically* — nothing runs.  Per op:

* **FLOPs** from the shapes the verifier already infers
  (analysis.shape_infer): matmul-family ops count ``2*M*K*N``, convs count
  ``2 * out_elems * Cin * kh * kw`` (for a 1x1 conv the ``2*P*C*M`` of
  the hand-written 1x1-conv kernel's matrix view), recurrences unroll over
  T, everything else falls back to one op per output element —
  ``flash_attention`` included, so its modeled time is far below its
  measured one and its calibration ratio large.
* **Bytes**: inputs read + outputs written, each divided by its sharding
  extent (a dp8-sharded activation moves 1/8 of its bytes per device).
* **Collectives**: the dp gradient all-reduce (``2*(E-1)/E * bytes`` per
  ring all-reduce), the row-parallel partial-sum all-reduce where a
  matched sharded contraction meets (Megatron's f/g), and a reshard charge
  for every PT041 conflict site the propagation pass reported.
* **Peak device memory** per device: persistable state + a liveness walk
  over the global block (a var is live from its producer to its last
  consumer; with a ``backward`` pseudo-op every forward intermediate is
  pinned live until the backward — autograd holds activations for it).

The constants are one H100 SXM's, from NVIDIA's data sheet — the ones
``chip_smoke.py``'s kernel bounds use: ``PEAK_FLOPS`` the bf16 dense
tensor-core peak, ``HBM_GBPS`` the HBM3 rate, ``ICI_GBPS`` NVLink 4's
rate per direction (unused on one card, where every collective is 0;
ROADMAP item 7 measures it).  As in the reference, one peak serves every
dtype: fp32 work on CUDA cores runs at a fraction of it, and the
measured/predicted calibration ratios (``observability.attribution``,
``observability.opprof``) absorb that per program and per op class.  A
caller-supplied batch stands in for symbolic ``-1`` dims (every
symbolic dim, not only the batch's — the documented caveat).  The
quantities that do not depend on the constants (FLOPs, bytes,
collective bytes, peak memory) equal the reference's exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .diagnostics import ValidationReport
from .shard_prop import PropagationResult, spec_extent

# one H100 SXM, NVIDIA data sheet: bf16 dense tensor-core peak (FLOP/s),
# HBM3 bytes/s, NVLink 4 bytes/s per direction
PEAK_FLOPS = 989e12
HBM_GBPS = 3.35e12
ICI_GBPS = 450e9


def _numel(shape, assume: int) -> int:
    if shape is None:
        return 0
    n = 1
    for d in shape:
        n *= assume if d < 0 else int(d)
    return n


def _itemsize(info) -> int:
    if info is None or info.dtype is None:
        return 4
    return int(info.dtype.itemsize)


@dataclasses.dataclass
class OpCost:
    loc: Tuple[int, int, str]
    flops: float
    bytes: float
    collective_bytes: float = 0.0


@dataclasses.dataclass
class CostReport:
    """Per-device static cost of one (program, plan) pair."""

    mesh_axes: Dict[str, int]
    flops_total: float = 0.0
    flops_per_device: float = 0.0
    hbm_bytes_per_device: float = 0.0
    collective_bytes: float = 0.0          # structural (all-reduces)
    reshard_bytes: float = 0.0             # PT041 conflict charges
    peak_hbm_bytes_per_device: float = 0.0
    op_costs: List[OpCost] = dataclasses.field(default_factory=list)
    # per-op-CLASS calibrated proxy (measured/predicted ratios from the
    # opprof profiler applied per op type); None = the constants only
    calibrated_step_time_s: Optional[float] = None

    @property
    def step_time_proxy_s(self) -> float:
        if self.calibrated_step_time_s is not None:
            return self.calibrated_step_time_s
        return (self.flops_per_device / PEAK_FLOPS
                + self.hbm_bytes_per_device / HBM_GBPS
                + (self.collective_bytes + self.reshard_bytes) / ICI_GBPS)

    def to_dict(self) -> dict:
        return {
            "mesh_axes": dict(self.mesh_axes),
            "flops_total": self.flops_total,
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "collective_bytes": self.collective_bytes,
            "reshard_bytes": self.reshard_bytes,
            "peak_hbm_bytes_per_device": self.peak_hbm_bytes_per_device,
            "step_time_proxy_s": self.step_time_proxy_s,
            "calibrated": self.calibrated_step_time_s is not None,
            "top_ops": [
                {"op": t, "block": b, "index": i,
                 "flops": c.flops, "bytes": c.bytes}
                for c in sorted(self.op_costs, key=lambda c: -c.flops)[:8]
                for (b, i, t) in [c.loc]],
        }


# ---------------------------------------------------------------------------
# Per-op FLOPs (full, unsharded; sharding divides afterwards)
# ---------------------------------------------------------------------------
def _mul_flops(op, shp, attrs, assume):
    x, y = shp("X"), shp("Y")
    if x is None or y is None:
        return 0.0
    xn = attrs.get("x_num_col_dims", 1)
    yn = attrs.get("y_num_col_dims", 1)
    m = _numel(x[:xn], assume)
    k = _numel(x[xn:], assume)
    n = _numel(y[yn:], assume)
    return 2.0 * m * k * n


def _matmul_flops(op, shp, attrs, assume):
    x, y = shp("X"), shp("Y")
    if x is None or y is None or len(x) < 2 or len(y) < 2:
        return 0.0
    xs, ys = list(x), list(y)
    if attrs.get("transpose_X", False):
        xs[-1], xs[-2] = xs[-2], xs[-1]
    if attrs.get("transpose_Y", False):
        ys[-1], ys[-2] = ys[-2], ys[-1]
    batch = _numel(xs[:-2], assume) or 1
    return 2.0 * batch * _numel([xs[-2], xs[-1], ys[-1]], assume)


def _conv2d_flops(op, shp, attrs, assume):
    x, w = shp("Input"), shp("Filter")
    out = shp.out("Output")
    if x is None or w is None or out is None or len(w) < 4:
        return 0.0
    return 2.0 * _numel(out, assume) * _numel(w[1:], assume)


def _lstm_flops(op, shp, attrs, assume):
    x = shp("Input")
    if x is None or len(x) != 3:
        return 0.0
    b, t, h4 = x
    h = max(1, (assume if h4 < 0 else h4) // 4)
    return 2.0 * _numel([b, t], assume) * h * (4 * h)


def _gru_flops(op, shp, attrs, assume):
    x = shp("Input")
    if x is None or len(x) != 3:
        return 0.0
    b, t, h3 = x
    h = max(1, (assume if h3 < 0 else h3) // 3)
    return 2.0 * _numel([b, t], assume) * h * (3 * h)


_FLOPS = {
    "mul": _mul_flops,
    "matmul": _matmul_flops,
    "conv2d": _conv2d_flops,
    "depthwise_conv2d": _conv2d_flops,
    "conv2d_transpose": _conv2d_flops,
    "lstm": _lstm_flops,
    "gru": _gru_flops,
}


class _ShapeView:
    """shp("X") -> first input shape of slot X; shp.out("Out") likewise."""

    def __init__(self, op, lookup):
        self.op = op
        self.lookup = lookup

    def _get(self, names):
        if not names:
            return None
        info = self.lookup(names[0])
        return None if info is None else info.shape

    def __call__(self, slot):
        return self._get(self.op.inputs.get(slot, []))

    def out(self, slot):
        return self._get(self.op.outputs.get(slot, []))


def estimate_cost(program, mesh_axes: Dict[str, int],
                  prop: Optional[PropagationResult] = None,
                  shapes=None, assume_batch: int = 64,
                  batch_axis: str = "dp",
                  op_class_ratios: Optional[Dict[str, float]] = None
                  ) -> CostReport:
    """Static per-device cost of one training/inference step under the
    sharding assignment in ``prop`` (replicated everywhere when None).

    ``op_class_ratios`` — measured/predicted correction factors per op
    TYPE (the opprof calibration table,
    ``observability.attribution.load_op_class_ratios``): when given, a
    calibrated proxy replaces the nominal one — each op's compute+HBM
    term scales by its class ratio (default 1.0), collective/reshard
    terms stay physical (the ICI model is not what the eager profile
    measured)."""
    from .shape_infer import run_shape_inference

    mesh_axes = {k: int(v) for k, v in (mesh_axes or {}).items()}
    if shapes is None:
        shapes = run_shape_inference(program, ValidationReport())
    specs = prop.specs if prop is not None else {}
    gb = program.global_block()
    block_shapes = shapes.get(0, {})

    def lookup(name):
        info = block_shapes.get(name)
        if info is not None and info.shape is not None:
            return info
        v = gb._find_var_recursive(name)
        if v is None:
            return None
        from .shape_infer import VarInfo
        return VarInfo(v.shape, v.dtype)

    def var_bytes(name, per_device=True) -> float:
        info = lookup(name)
        if info is None or info.shape is None:
            return 0.0
        b = _numel(info.shape, assume_batch) * _itemsize(info)
        if per_device:
            b /= max(1, spec_extent(specs.get(name), mesh_axes))
        return float(b)

    def out_extent(op) -> int:
        exts = [spec_extent(specs.get(n), mesh_axes)
                for n in op.output_names if n in specs]
        return max(exts) if exts else 1

    dp_ext = int(mesh_axes.get(batch_axis, 1))
    # the batch axis only costs/saves anything when some value actually
    # shards over it (prop carries the candidate's feed seeds forward)
    dp_active = any(
        any(batch_axis in (e or ()) for e in sp)
        for sp in specs.values())
    report = CostReport(mesh_axes=mesh_axes)
    fwd_flops = 0.0
    fwd_flops_per_dev = 0.0
    for op_idx, op in enumerate(gb.ops):
        shp = _ShapeView(op, lookup)
        coll = 0.0
        if op.type == "backward":
            # the VJP replays the forward under the same sharding
            flops = 2.0 * fwd_flops
            per_dev_flops = 2.0 * fwd_flops_per_dev
            # the dp gradient all-reduce: every param grad not itself
            # sharded over the batch axis rides a ring all-reduce
            if dp_ext > 1 and dp_active:
                grad_bytes = sum(
                    var_bytes(p) for p in op.attrs.get("params", []))
                coll += 2.0 * (dp_ext - 1) / dp_ext * grad_bytes
        else:
            fn = _FLOPS.get(op.type)
            if fn is not None:
                flops = fn(op, shp, op.attrs, assume_batch)
            else:
                flops = float(sum(
                    _numel(getattr(lookup(n), "shape", None), assume_batch)
                    for n in op.output_names))
            fwd_flops += flops
            # contraction extent: a matched sharded contraction (Megatron
            # row-parallel) computes 1/ext of the work per device, then
            # all-reduces the partial outputs
            ext = out_extent(op)
            k_ext = 1
            if op.type in ("mul", "matmul"):
                y = op.inputs.get("Y", [])
                if y and y[0] in specs:
                    sp = specs[y[0]]
                    if op.type == "mul":
                        k_entries = sp[:op.attrs.get("y_num_col_dims", 1)]
                    elif op.attrs.get("transpose_Y", False):
                        # transposed Y contracts on its LAST dim — mirror
                        # shard_matmul's axis selection
                        k_entries = sp[-1:]
                    else:
                        k_entries = sp[-2:-1]
                    k_ext = max(1, spec_extent(tuple(k_entries), mesh_axes))
                    if k_ext > 1:
                        out_b = sum(var_bytes(n) for n in op.output_names)
                        coll += 2.0 * (k_ext - 1) / k_ext * out_b
            per_dev_flops = flops / max(1, ext * k_ext)
            fwd_flops_per_dev += per_dev_flops
        byts = sum(var_bytes(n) for n in op.input_names) + \
            sum(var_bytes(n) for n in op.output_names)
        report.op_costs.append(OpCost(
            loc=(0, op_idx, op.type), flops=per_dev_flops, bytes=byts,
            collective_bytes=coll))
        report.flops_total += flops
        report.flops_per_device += per_dev_flops
        report.hbm_bytes_per_device += byts
        report.collective_bytes += coll

    # reshard charges from the propagation conflict sites: the moved
    # tensor is the op's largest input
    for (bi, oi, typ, _note) in (prop.resharded if prop else []):
        if bi != 0 or oi >= len(gb.ops):
            continue
        op = gb.ops[oi]
        moved = max((var_bytes(n, per_device=False)
                     for n in op.input_names), default=0.0)
        report.reshard_bytes += moved

    if op_class_ratios:
        t = 0.0
        for c in report.op_costs:
            ratio = float(op_class_ratios.get(c.loc[2], 1.0))
            t += ratio * (c.flops / PEAK_FLOPS + c.bytes / HBM_GBPS) \
                + c.collective_bytes / ICI_GBPS
        t += report.reshard_bytes / ICI_GBPS
        report.calibrated_step_time_s = t

    report.peak_hbm_bytes_per_device = _peak_hbm(
        program, lookup, specs, mesh_axes, assume_batch)
    return report


def _peak_hbm(program, lookup, specs, mesh_axes, assume_batch) -> float:
    """Persistable state + activation liveness over the global block."""
    gb = program.global_block()
    persistable = {v.name for b in program.blocks
                   for v in b.vars.values() if v.persistable}

    def vb(name) -> float:
        info = lookup(name)
        if info is None or info.shape is None:
            return 0.0
        return (_numel(info.shape, assume_batch) * _itemsize(info)
                / max(1, spec_extent(specs.get(name), mesh_axes)))

    state_bytes = sum(vb(n) for n in persistable)

    backward_idx = next((i for i, op in enumerate(gb.ops)
                         if op.type == "backward"), None)
    last_use: Dict[str, int] = {}
    for i, op in enumerate(gb.ops):
        for n in op.input_names:
            last_use[n] = i
    produced_at: Dict[str, int] = {}
    for i, op in enumerate(gb.ops):
        for n in op.output_names:
            produced_at.setdefault(n, i)
    if backward_idx is not None:
        # autograd keeps forward activations alive for the backward
        for n, born in produced_at.items():
            if born < backward_idx and n not in persistable:
                last_use[n] = max(last_use.get(n, born), backward_idx)

    live: Dict[str, float] = {}
    peak = 0.0
    for i, op in enumerate(gb.ops):
        for n in op.output_names:
            if n not in persistable and n not in live:
                live[n] = vb(n)
        peak = max(peak, sum(live.values()))
        dead = [n for n in live if last_use.get(n, i) <= i]
        for n in dead:
            del live[n]
    return state_bytes + peak
