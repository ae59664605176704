"""Per-op runtime profiler, modeled join and memory timeline
(counterpart of ``paddle_tpu/observability/opprof.py``): which op a
step's time goes to, and how far each is from the static cost model.

* **Measured** — an eager per-op replay of one step through
  ``core.executor.run_op`` in execution order — the forward slice, the
  ``backward`` pseudo-op as one unit (one autograd pass producing every
  ``@GRAD``), then the update ops — with the step's own input coercion
  (``nanprov.make_eager_context``), so every op times at the precision
  the step computes at.  Each op is timed over warm-up-discarded
  windows (:func:`time_windows`); on the card a window's time is a pair
  of CUDA events on the current stream around the op, read after the
  window's end event, and on the CPU the host clock.  Each window places
  the random ops' streams at the step again, so every window draws the
  step's masks.  The kernel wrappers count the replay's launches like
  any others.
* **Modeled** (``modeled=True``) — each measured op joined against the
  static cost model's per-op FLOPs and bytes (``analysis.cost_model``,
  the H100 constants): predicted-vs-measured ratios, a roofline verdict
  per op (compute-bound vs memory-bound under those constants), the
  arithmetic intensity, a per-op-TYPE calibration table
  (:func:`op_class_rows`, the ``calibration_row`` schema keyed by program
  digest and op type — what ``analysis.planner.plan(op_class_ratios=)``
  reads through ``attribution.load_op_class_ratios``) and the ranked
  where-the-time-goes report by op class (:func:`xla_loses_here`, under
  the JAX package's name) naming :data:`PALLAS_CANDIDATES`' classes.
  The join is best-effort, as in the JAX package: a program the model
  cannot walk profiles measured-only, with a warning.
* **Memory timeline** — the liveness walk's per-op live-bytes curve from
  the measured tensor sizes of the replay, beside the cost model's peak
  estimate when modeled.

Profiling is an offline tool: it never touches the executor's captured
steps or its step counter.  ``python -m
paddle_tpu_torch.benchmark.opprof`` is its driver.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import metrics as _metrics
from . import tracing as _tracing

logger = logging.getLogger("paddle_tpu_torch")

__all__ = [
    "TOLERANCE", "PALLAS_CANDIDATES", "synth_feeds", "synth_state",
    "time_windows", "cuda_time_windows", "profile_program",
    "render_profile", "op_class_rows", "xla_loses_here",
]

# The per-op table must sum to the eager-replay total within this
# fraction (the JAX package's value, equal to
# attribution.BUDGET_TOLERANCE).
TOLERANCE = 0.15

# The JAX package's expansion candidates: op classes whose domination in
# a measured profile names a candidate kernel (a fused optimizer update
# over all parameters; gather/scatter over padded sequence layouts).
# Names only: the decision rules and hardware flags the JAX package
# attaches from its tunables wait for the port's tuning (ROADMAP item 9d).
_OPTIMIZER_OPS = frozenset((
    "sgd", "momentum", "adam", "adamax", "adagrad", "adadelta",
    "decayed_adagrad", "rmsprop", "ftrl", "proximal_gd",
    "proximal_adagrad"))
_LOD_SEQUENCE_OPS = frozenset((
    "sequence_pool", "sequence_softmax", "sequence_expand",
    "sequence_expand_as", "sequence_concat", "sequence_slice",
    "sequence_pad", "sequence_unpad", "sequence_reshape",
    "sequence_reverse", "lod_reset", "sub_nested_seq"))
PALLAS_CANDIDATES: Dict[str, str] = {
    **{t: "pallas/fused_optimizer_update" for t in _OPTIMIZER_OPS},
    **{t: "pallas/lod_gather_scatter" for t in _LOD_SEQUENCE_OPS},
}


# ---------------------------------------------------------------------------
# Feed/state synthesis (profiling a serialized prog.json needs values)
# ---------------------------------------------------------------------------
def _data_vars(program):
    out = []
    for b in program.blocks:
        for v in b.vars.values():
            if getattr(v, "is_data", False):
                out.append(v)
    return out


def _int_feed_bounds(program) -> Dict[str, int]:
    """Upper bounds for synthesized integer feeds, from their direct
    consumers: lookup_table ids must stay under the table's rows,
    cross_entropy labels under the logit width.  Anything else gets the
    conservative default (2)."""
    gb = program.global_block()
    bounds: Dict[str, int] = {}

    def dim(name, idx):
        v = gb._find_var_recursive(name)
        if v is None or v.shape is None or len(v.shape) <= idx:
            return None
        d = v.shape[idx]
        return int(d) if d and d > 0 else None

    for b in program.blocks:
        for op in b.ops:
            if op.type == "lookup_table":
                ws = op.inputs.get("W", [])
                vocab = dim(ws[0], 0) if ws else None
                if vocab:
                    for n in op.inputs.get("Ids", []):
                        bounds[n] = min(bounds.get(n, vocab), vocab)
            elif op.type in ("cross_entropy", "one_hot"):
                xs = op.inputs.get("X", [])
                classes = dim(xs[0], -1) if xs else None
                if classes:
                    for n in op.inputs.get("Label", []):
                        bounds[n] = min(bounds.get(n, classes), classes)
    return bounds


def synth_feeds(program, batch: int = 64, seq_len: int = 8,
                seed: int = 0) -> Dict[str, object]:
    """Seeded random feeds shaped from the program's data vars (the
    fake-data-provider role, for profiling a serialized program without
    its reader): floats ~ U[0,1), ints bounded by their consumers
    (:func:`_int_feed_bounds`), ``-1`` dims resolved to ``batch``
    (leading) / ``seq_len`` (sequence dims), with ``@LEN`` companions
    for ``lod_level`` > 0 vars."""
    rng = np.random.RandomState(seed)
    bounds = _int_feed_bounds(program)
    feeds: Dict[str, object] = {}
    for v in _data_vars(program):
        shape = list(v.shape if v.shape is not None else (-1,))
        dims = []
        for i, d in enumerate(shape):
            if d is None or int(d) < 0:
                dims.append(batch if i == 0 else seq_len)
            else:
                dims.append(int(d))
        if not dims:
            dims = [batch]
        dt = np.dtype(v.dtype) if v.dtype is not None else np.dtype("f4")
        if dt.kind in "iu":
            hi = max(2, int(bounds.get(v.name, 2)))
            feeds[v.name] = rng.randint(0, hi, size=dims).astype(dt)
        elif dt.kind == "b":
            feeds[v.name] = np.zeros(dims, dtype=dt)
        else:
            feeds[v.name] = rng.rand(*dims).astype(dt)
        lod = int(getattr(v, "lod_level", 0) or 0)
        if lod >= 1:
            t = dims[1] if len(dims) > 1 else seq_len
            feeds[v.name + "@LEN"] = np.full((dims[0],), t, dtype="int64")
        if lod >= 2 and len(dims) > 2:
            feeds[v.name + "@LEN2"] = np.full(
                (dims[0], dims[1]), dims[2], dtype="int64")
    return feeds


def synth_state(program, scope=None, batch: int = 64,
                seed: int = 0) -> Dict[str, object]:
    """Values for every persistable var the program references: the live
    ``scope`` value when present (a startup-initialized run profiles its
    real parameters), else a seeded synthetic — small positive uniforms,
    so learning rates / beta-pow accumulators stay in a sane range."""
    rng = np.random.RandomState(seed + 1)
    referenced = set()
    for b in program.blocks:
        for op in b.ops:
            referenced.update(op.input_names)
            referenced.update(op.output_names)
            referenced.update(op.attrs.get("params", ())
                              if op.type == "backward" else ())
    out: Dict[str, object] = {}
    for b in program.blocks:
        for v in b.vars.values():
            if not v.persistable or v.name in out \
                    or v.name not in referenced:
                continue
            if scope is not None and scope.has(v.name):
                out[v.name] = scope.get(v.name)
                continue
            shape = tuple(batch if (d is None or int(d) < 0) else int(d)
                          for d in (v.shape if v.shape is not None
                                    else (1,)))
            dt = np.dtype(v.dtype) if v.dtype is not None \
                else np.dtype("f4")
            if dt.kind == "f":
                out[v.name] = rng.uniform(0.01, 0.1, shape).astype(dt)
            else:
                out[v.name] = np.zeros(shape, dtype=dt)
    return out


# ---------------------------------------------------------------------------
# The measured walk
# ---------------------------------------------------------------------------
def time_windows(call: Callable[[], object], *, reps: int = 3,
                 warmup: int = 1, unit: int = 1) -> dict:
    """Time ``call`` (which must block until its work is done) over
    ``reps`` windows after ``warmup`` discarded ones, on the host clock.
    Returns median seconds per ``unit`` plus the raw windows and the
    (max-min)/median spread in percent (the JAX package's
    ``tuning.search.time_windows``)."""
    for _ in range(max(0, warmup)):
        call()
    times = []
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
    return _window_stats(times, unit)


def cuda_time_windows(call: Callable[[], object], *, reps: int = 3,
                      warmup: int = 1, unit: int = 1) -> dict:
    """:func:`time_windows` on the card: each window is the time between
    two CUDA events recorded on the current stream around ``call``
    (which launches and does not wait), read once the end event is
    done."""
    for _ in range(max(0, warmup)):
        call()
    times = []
    for _ in range(max(1, reps)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return _window_stats(times, unit)


def _window_stats(times: List[float], unit: int) -> dict:
    med = float(np.median(times))
    return {
        "seconds": med / max(1, unit),
        "windows": [round(t, 6) for t in times],
        "spread_pct": round(100.0 * (max(times) - min(times)) / med, 2)
        if med > 0 else 0.0,
    }


# ---------------------------------------------------------------------------
# Modeled join
# ---------------------------------------------------------------------------
def _join_modeled(program, rows, mesh_axes, assume_batch):
    from ..analysis.cost_model import (HBM_GBPS, ICI_GBPS, PEAK_FLOPS,
                                       estimate_cost)
    try:
        cost = estimate_cost(program, mesh_axes or {},
                             assume_batch=assume_batch)
    except Exception as e:  # noqa: BLE001 — the join is best-effort
        # a program the static model cannot walk still profiles
        # measured-only
        logger.warning("opprof: static cost model failed (%s: %s); "
                       "measured-only profile", type(e).__name__, e)
        return None
    by_idx = {c.loc[1]: c for c in cost.op_costs if c.loc[0] == 0}
    for row in rows:
        c = by_idx.get(row["index"])
        if c is None:
            continue
        compute_s = c.flops / PEAK_FLOPS
        hbm_s = c.bytes / HBM_GBPS
        pred_ms = (compute_s + hbm_s
                   + c.collective_bytes / ICI_GBPS) * 1e3
        row["modeled"] = {
            "flops": c.flops, "hbm_bytes": c.bytes,
            "predicted_ms": round(pred_ms, 9),
            "roofline": ("compute-bound" if compute_s >= hbm_s
                         else "memory-bound"),
            "arithmetic_intensity": round(c.flops / c.bytes, 4)
            if c.bytes else None,
        }
        row["ratio"] = round(row["wall_ms"] / pred_ms, 4) \
            if pred_ms > 0 else None
    return cost


def _agg_by_type(rows) -> Dict[str, dict]:
    """Per op TYPE: measured time and count over all rows, and the
    measured/predicted pair over the modeled rows (only those can
    calibrate)."""
    agg: Dict[str, dict] = {}
    for row in rows:
        a = agg.setdefault(row["op_type"], {
            "measured_ms": 0.0, "count": 0, "modeled_measured_ms": 0.0,
            "modeled_predicted_ms": 0.0, "modeled_count": 0})
        a["measured_ms"] += row["wall_ms"]
        a["count"] += 1
        m = row.get("modeled")
        if m and m.get("predicted_ms"):
            a["modeled_measured_ms"] += row["wall_ms"]
            a["modeled_predicted_ms"] += m["predicted_ms"]
            a["modeled_count"] += 1
    return agg


def op_class_rows(rows, digest: str, assume_batch: int,
                  mesh_axes: Optional[Dict[str, int]] = None) -> List[dict]:
    """One calibration row per op TYPE from a modeled profile's rows —
    the ``attribution.calibration_row`` schema with the op class key,
    merged into the table by ``attribution.save_op_class_calibration``
    and read by ``analysis.planner.plan(op_class_ratios=...)``."""
    agg = _agg_by_type(rows)
    out = []
    for op_type in sorted(agg):
        a = agg[op_type]
        if not a["modeled_count"]:
            continue
        out.append({
            "program": digest, "op_type": op_type,
            "predicted_ms": round(a["modeled_predicted_ms"], 6),
            "measured_ms": round(a["modeled_measured_ms"], 6),
            "ratio": round(a["modeled_measured_ms"]
                           / a["modeled_predicted_ms"], 4)
            if a["modeled_predicted_ms"] > 0 else None,
            "count": a["modeled_count"],
            "assume_batch": int(assume_batch),
            "mesh_axes": dict(mesh_axes or {}),
            "model": "static-per-op",
        })
    return out


def xla_loses_here(rows, total_ms: float, top: int) -> List[dict]:
    """Where the time goes, by op class, ranked by measured time, with
    the modeled ratio; a class in :data:`PALLAS_CANDIDATES` names its
    candidate kernel.  (The JAX package's name, kept so both packages'
    reports read alike: here the compiler is the op implementation.)"""
    agg = {t: {"measured_ms": a["measured_ms"], "count": a["count"],
               "predicted_ms": a["modeled_predicted_ms"]}
           for t, a in _agg_by_type(rows).items()}
    ranked = []
    for op_type, a in sorted(agg.items(),
                             key=lambda kv: -kv[1]["measured_ms"]):
        entry = {
            "op_type": op_type, "count": a["count"],
            "measured_ms": round(a["measured_ms"], 6),
            "share": round(a["measured_ms"] / total_ms, 4)
            if total_ms > 0 else 0.0,
            "predicted_ms": round(a["predicted_ms"], 6),
            "ratio": round(a["measured_ms"] / a["predicted_ms"], 4)
            if a["predicted_ms"] > 0 else None,
        }
        cand = PALLAS_CANDIDATES.get(op_type)
        if cand:
            entry["pallas_candidate"] = cand
        ranked.append(entry)
    return ranked[:max(1, top)]


def _bw_out_names(op) -> List[str]:
    from ..core.program import grad_var_name
    names = [grad_var_name(p) for p in op.attrs.get("params", ())]
    loss = op.attrs.get("loss")
    if loss:
        names.append(loss)
    return names


def profile_program(program, *, executor=None, feed=None, state=None,
                    scope=None, batch: int = 64, seq_len: int = 8,
                    step: int = 0, is_test: bool = False, reps: int = 2,
                    warmup: int = 1, top: int = 10, fetch_list=None,
                    measure=None, modeled: bool = False,
                    mesh_axes: Optional[Dict[str, int]] = None) -> dict:
    """Profile one step of ``program`` op by op on ``executor``'s device
    (default ``Executor()``, the card); returns the measured and memory
    report (JSON-serializable except an optional ``fetches`` entry when
    ``fetch_list`` names vars to materialize).

    ``measure(call, reps=, warmup=)`` must run ``call`` at least once and
    return the :func:`time_windows` dict (default: :func:`cuda_time_windows`
    on the card, :func:`time_windows` on the CPU) — injectable so a test's
    fake timer exercises the walk deterministically.  The call order is
    the JAX package's: one measurement per op in execution order, then
    one of the full replay (the eager total the per-op table must sum to
    within :data:`TOLERANCE`).  ``modeled=True`` adds the static cost
    model's join (``batch`` stands in for symbolic dims, ``mesh_axes``
    for the plan's mesh): a ``modeled`` entry and a ``ratio`` on each
    row, the ``op_classes`` calibration rows, the ``xla_loses_here``
    ranking, and the model's peak beside the memory timeline's; the
    measured fields stay as they are."""
    from ..core import compile_cache
    from ..core.executor import Env, _run_backward, _to_bf16, run_op
    from .nanprov import dtype_name, make_eager_context

    if executor is None:
        from ..core.executor import Executor
        executor = Executor()
    if scope is None:
        from ..core.scope import global_scope
        scope = global_scope()
    on_card = executor.device.type == "cuda"
    if measure is None:
        measure = cuda_time_windows if on_card else time_windows

    gb = program.global_block()
    host_feed = dict(feed) if feed is not None \
        else synth_feeds(program, batch=batch, seq_len=seq_len)
    feeds = {k: executor._feed_tensor(gb, k, v)
             for k, v in host_feed.items()}
    if state is None:
        state = synth_state(program, scope=scope, batch=batch)
    state = {k: v if isinstance(v, torch.Tensor)
             else executor._feed_tensor(gb, k, v)
             for k, v in state.items()}

    with torch.no_grad():
        env, ctx, bw_idx = make_eager_context(executor, program, feeds,
                                              state, step, is_test)
    initial = dict(env.local)
    # AMP training: the step runs its forward ops in bf16 inside the
    # autograd pass, so the walk times them against a bf16 shadow env
    # while the backward and update ops keep the fp32 master env
    amp_train = bool(executor.amp) and bw_idx is not None
    fwd_env = None
    if amp_train:
        fwd_env = Env(gb)
        fwd_env.local.update({k: _to_bf16(v) for k, v in initial.items()})
    _metrics.inc_counter("opprof/runs")

    ops = gb.ops
    op_out_names: List[List[str]] = [
        _bw_out_names(op) if i == bw_idx
        else [n for names in op.outputs.values() for n in names]
        for i, op in enumerate(ops)]

    rows: List[dict] = []
    sizes: Dict[str, int] = {n: _nbytes(v) for n, v in env.local.items()}
    for idx, op in enumerate(ops):
        is_bw = idx == bw_idx
        tenv = fwd_env if (fwd_env is not None and idx < bw_idx) else env
        out_names = op_out_names[idx]
        aliases: Dict[str, object] = {}
        if not is_bw:
            for n in set(op.input_names) & set(op.output_names):
                if tenv.has(n):
                    aliases[n] = tenv.get(n)
        in_names = list(op.attrs.get("params", ())) if is_bw \
            else list(op.input_names)
        in_bytes = sum(_nbytes(tenv.get(n)) for n in in_names
                       if tenv.has(n))

        def call(op=op, aliases=aliases, is_bw=is_bw, tenv=tenv):
            # every window from the step's stream positions, and from the
            # op's own inputs (an update op rebinds its Param)
            ctx._placed.clear()
            for n, val in aliases.items():
                tenv.set(n, val)
            if is_bw:
                _run_backward(ops[:bw_idx], op, env, ctx)
            else:
                with torch.no_grad():
                    run_op(op, tenv, ctx)

        with _tracing.span("opprof/op", op_type=op.type, index=idx):
            w = measure(call, reps=reps, warmup=warmup)
        wall_ms = float(w["seconds"]) * 1e3
        _metrics.inc_counter("opprof/ops")
        _metrics.observe_hist("opprof/op_ms", wall_ms)
        out_bytes = 0
        out_shapes, out_dtypes = [], []
        for n in out_names:
            if not tenv.has(n):
                continue
            v = tenv.get(n)
            sizes[n] = _nbytes(v)
            out_bytes += sizes[n]
            out_shapes.append(list(getattr(v, "shape", ())))
            out_dtypes.append(dtype_name(v))
        phase = ("backward" if is_bw else
                 "forward" if bw_idx is None or idx < bw_idx else
                 "update")
        rows.append({
            "index": idx, "op_type": op.type, "phase": phase,
            "wall_ms": round(wall_ms, 6),
            "windows_ms": [round(t * 1e3, 6) for t in w.get("windows", ())],
            "spread_pct": w.get("spread_pct", 0.0),
            "bytes": int(in_bytes + out_bytes),
            "out_shapes": out_shapes, "out_dtypes": out_dtypes,
        })

    # -- eager total: one full replay measured end to end, with the same
    #    per-op env discipline, so the per-op table can sum to it
    def total_call():
        env2 = Env(gb)
        env2.local.update(initial)
        fenv2 = None
        if amp_train:
            fenv2 = Env(gb)
            fenv2.local.update(
                {k: _to_bf16(v) for k, v in initial.items()})
        ctx._placed.clear()
        for i, op in enumerate(ops):
            tenv2 = fenv2 if (fenv2 is not None and i < bw_idx) else env2
            if i == bw_idx:
                ctx._placed.clear()
                _run_backward(ops[:bw_idx], op, env2, ctx)
            else:
                with torch.no_grad():
                    run_op(op, tenv2, ctx)

    tw = measure(total_call, reps=reps, warmup=warmup)
    eager_total_ms = float(tw["seconds"]) * 1e3
    per_op_sum_ms = sum(r["wall_ms"] for r in rows)
    gap = (abs(per_op_sum_ms - eager_total_ms) / eager_total_ms
           if eager_total_ms > 0 else 0.0)

    digest = compile_cache.fingerprint_hex(
        compile_cache.program_content_digest(program))[:16]
    report: dict = {
        "program": digest, "batch": int(batch),
        "device": str(executor.device),
        "reps": int(reps), "warmup": int(warmup),
        "ops": len(rows),
        "eager_total_ms": round(eager_total_ms, 6),
        "per_op_sum_ms": round(per_op_sum_ms, 6),
        "sum_gap_frac": round(gap, 4),
        "within_tolerance": bool(gap <= TOLERANCE),
        "tolerance": TOLERANCE,
        "rows": rows,
        "top": sorted(rows, key=lambda r: -r["wall_ms"])[:max(1, top)],
    }
    cost = None
    if modeled:
        cost = _join_modeled(program, rows, mesh_axes, batch)
        report["mesh_axes"] = dict(mesh_axes or {})
        report["op_classes"] = op_class_rows(rows, digest, batch,
                                             mesh_axes)
        report["xla_loses_here"] = xla_loses_here(rows, per_op_sum_ms,
                                                  top)
    report["memory"] = _memory_view(program, sizes, bw_idx, cost=cost)
    if fetch_list:
        report["fetches"] = {
            str(n): env.get(str(n)).float().cpu().numpy()
            for n in fetch_list if env.has(str(n))}
    return report


def _nbytes(v) -> int:
    return int(v.nbytes) if isinstance(v, torch.Tensor) else 0


# ---------------------------------------------------------------------------
# Memory timeline
# ---------------------------------------------------------------------------
def _memory_view(program, sizes: Dict[str, int], bw_idx,
                 cost=None) -> dict:
    """Per-op live-bytes curve from the measured tensor sizes, with the
    JAX package's liveness rules: a var lives from its producer to its
    last consumer, and forward activations live until the backward
    (autograd holds them for it).  ``modeled_peak_bytes`` is the static
    model's per-device peak from ``cost`` (the modeled join's
    CostReport); None when not modeled or the model could not walk the
    program."""
    gb = program.global_block()
    persistable = {v.name for b in program.blocks
                   for v in b.vars.values() if v.persistable}
    state_bytes = sum(sizes.get(n, 0) for n in persistable)

    def outs(i, op):
        if i == bw_idx:
            return _bw_out_names(op)
        return [n for names in op.outputs.values() for n in names]

    last_use: Dict[str, int] = {}
    produced_at: Dict[str, int] = {}
    for i, op in enumerate(gb.ops):
        for n in op.input_names:
            last_use[n] = i
        if i == bw_idx:
            for n in op.attrs.get("params", ()):
                last_use[n] = max(last_use.get(n, i), i)
    for i, op in enumerate(gb.ops):
        for n in outs(i, op):
            produced_at.setdefault(n, i)
    if bw_idx is not None:
        for n, born in produced_at.items():
            if born < bw_idx and n not in persistable:
                last_use[n] = max(last_use.get(n, born), bw_idx)

    live: Dict[str, int] = {}
    curve: List[dict] = []
    peak, peak_idx = 0, 0
    for i, op in enumerate(gb.ops):
        for n in outs(i, op):
            if n not in persistable and n not in live:
                live[n] = sizes.get(n, 0)
        cur = state_bytes + sum(live.values())
        if cur > peak:
            peak, peak_idx = cur, i
        curve.append({"index": i, "op_type": op.type,
                      "live_bytes": int(cur)})
        for n in [n for n in live if last_use.get(n, i) <= i]:
            del live[n]

    modeled = cost.peak_hbm_bytes_per_device if cost is not None else None
    out = {
        "timeline": curve,
        "state_bytes": int(state_bytes),
        "peak_bytes": int(peak), "peak_index": peak_idx,
        "peak_op": gb.ops[peak_idx].type if gb.ops else None,
        "modeled_peak_bytes": round(modeled, 1)
        if modeled is not None else None,
    }
    if modeled:
        out["peak_ratio"] = round(peak / modeled, 4)
    return out


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------
def render_profile(report: dict, top: int = 10) -> str:
    """Human-readable profile rendering."""
    lines = [
        f"per-op profile: {report['ops']} op(s), eager total "
        f"{report['eager_total_ms']:.3f} ms, per-op sum "
        f"{report['per_op_sum_ms']:.3f} ms (gap "
        f"{round(report['sum_gap_frac'] * 100, 2)}%"
        + ("" if report["within_tolerance"] else " — OVER TOLERANCE")
        + ")"]
    lines.append("top ops by measured time:")
    for r in report["top"][:top]:
        m = r.get("modeled") or {}
        share = (r["wall_ms"] / report["per_op_sum_ms"] * 100
                 if report["per_op_sum_ms"] else 0.0)
        extra = ""
        if m:
            extra = (f"  pred {m['predicted_ms']:.6f} ms"
                     + (f"  ratio {r['ratio']}x"
                        if r.get("ratio") is not None else "")
                     + f"  {m['roofline']}")
        lines.append(f"  #{r['index']:>3} {r['op_type']:<22} "
                     f"{r['wall_ms']:10.3f} ms ({share:4.1f}%)"
                     f" [{r['phase']}]{extra}")
    xl = report.get("xla_loses_here") or []
    if xl:
        lines.append("where the time goes (by op class):")
        for e in xl[:top]:
            lines.append(
                f"  {e['op_type']} (x{e['count']}): "
                f"{e['measured_ms']:.3f} ms "
                f"({round(e['share'] * 100, 1)}%)"
                + (f", ratio {e['ratio']}x" if e.get("ratio") else "")
                + (f" -> {e['pallas_candidate']}"
                   if e.get("pallas_candidate") else ""))
    mem = report.get("memory") or {}
    if mem:
        line = (f"memory: measured peak "
                f"{mem['peak_bytes'] / 1e6:.3f} MB at op "
                f"#{mem['peak_index']} ({mem['peak_op']})")
        if mem.get("modeled_peak_bytes"):
            line += (f"; modeled {mem['modeled_peak_bytes'] / 1e6:.3f} MB"
                     + (f" (ratio {mem['peak_ratio']})"
                        if mem.get("peak_ratio") else ""))
        lines.append(line)
    return "\n".join(lines)
