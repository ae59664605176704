"""NaN/Inf provenance (counterpart of
``paddle_tpu/observability/nanprov.py``): eagerly bisect a failing step
to the op that first produced a non-finite value.

``Executor(check_nan_inf=True)`` detects non-finites with in-step finite
flags (``Executor._nan_localize``, executor.cc:116-124's analog), which
names a producer by program order.  On the failure path this module
re-runs the failing step eagerly — same feeds, same pre-step state, the
random ops' streams placed at the same step — one ``run_op`` at a time,
checking every produced value on the host, so the diagnosis carries the
first non-finite producer in execution order with its shape and NaN/Inf
element counts.  For a program with a ``backward`` op the forward slice
is walked first (forward producers bisect exactly); if it stays finite,
the gradient pass runs whole and each ``<p>@GRAD`` is checked by name.

One-shot and failure-path only: the bisect costs one extra eager step,
paid once, after a step already failed.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional

import torch

logger = logging.getLogger("paddle_tpu_torch")

__all__ = ["bisect_step", "format_diagnosis", "make_eager_context"]


def make_eager_context(executor, program, feeds, state, step: int,
                       is_test: bool = False):
    """``(env, ctx, bw_idx)`` for an eager per-op replay of one step of
    ``executor``, with the step's own input coercion (``compute_dtype``
    upcast first, then pure-inference AMP bf16) and a fresh stream table,
    whose generators ``ExecContext.generator`` places at ``step``: the
    replay draws the masks the step drew.  Shared by the NaN bisect here
    and the per-op profiler (``observability.opprof``)."""
    from ..core.executor import Env, ExecContext, _to_bf16, _upcast

    gb = program.global_block()
    bw_idx = next((i for i, op in enumerate(gb.ops)
                   if op.type == "backward"), None)
    env = Env(gb)
    env.local.update(state)
    env.local.update(feeds)
    cd = executor._compute_dtype()
    env.local = _upcast(env.local, cd)
    if executor.amp and bw_idx is None:
        env.local = {k: _to_bf16(v) for k, v in env.local.items()}
    ctx = ExecContext(program, executor.device, step, is_test=is_test,
                      conv1x1_pallas=executor.conv1x1_pallas,
                      amp=executor.amp, streams={}, compute_dtype=cd)
    return env, ctx, bw_idx


def dtype_name(value) -> str:
    """``float32`` for a tensor's dtype (the JAX package's spelling)."""
    return str(getattr(value, "dtype", "?")).replace("torch.", "")


def _nonfinite(value) -> Optional[Dict[str, int]]:
    """{'nan': n, 'inf': n} when ``value`` holds non-finite floats."""
    if not (isinstance(value, torch.Tensor) and value.is_floating_point()):
        return None
    if bool(torch.isfinite(value).all()):
        return None
    return {"nan": int(torch.isnan(value).sum()),
            "inf": int(torch.isinf(value).sum())}


def _row(op_index, op_type, name, slot, phase, value, bad) -> dict:
    return {"op_index": op_index, "op_type": op_type, "var": name,
            "slot": slot, "phase": phase,
            "shape": list(getattr(value, "shape", ())),
            "dtype": dtype_name(value),
            "nan_count": bad["nan"], "inf_count": bad["inf"]}


def _check_outputs(op, op_index, env, phase) -> Optional[dict]:
    for slot, names in op.outputs.items():
        for name in names:
            if not env.has(name):
                continue
            bad = _nonfinite(env.get(name))
            if bad is not None:
                return _row(op_index, op.type, name, slot, phase,
                            env.get(name), bad)
    return None


def bisect_step(executor, program, feeds, state, step: int,
                is_test: bool = False) -> Optional[dict]:
    """Eagerly re-run one step and return a provenance dict for the first
    non-finite producer, or None when the re-run stays finite (or the
    bisect itself fails — it must never mask the original error).
    ``state`` must be the pre-step values (``Executor.run`` keeps a copy
    under ``check_nan_inf``)."""
    try:
        with torch.no_grad():
            return _bisect(executor, program, feeds, state, step, is_test)
    except Exception as e:
        logger.warning("NaN-provenance bisect failed (%s: %s); reporting "
                       "the in-step localization only",
                       type(e).__name__, e)
        return None


def _bisect(executor, program, feeds, state, step, is_test):
    from ..core.executor import _run_backward, grad_var_name, run_op

    ops = program.global_block().ops
    env, ctx, bw_idx = make_eager_context(executor, program, feeds, state,
                                          step, is_test)
    # a poisoned input is not an op's fault: report the feed/state, as
    # the step consumed it (after the casts)
    for name, value in env.local.items():
        bad = _nonfinite(value)
        if bad is not None:
            return _row(-1, None, name, None,
                        "feed" if name in feeds else "state", value, bad)

    for idx, op in enumerate(ops):
        if idx == bw_idx:
            # the forward slice already ran, checked op by op; the
            # gradient pass runs whole, its forward from the streams'
            # step start again (the step ran its forward once)
            ctx._placed.clear()
            _run_backward(ops[:bw_idx], op, env, ctx)
            for pname in op.attrs.get("params", ()):
                gname = grad_var_name(pname)
                if not env.has(gname):
                    continue
                bad = _nonfinite(env.get(gname))
                if bad is not None:
                    return _row(idx, "backward", gname, None, "backward",
                                env.get(gname), bad)
            continue
        run_op(op, env, ctx)
        phase = "forward" if bw_idx is None or idx < bw_idx else "update"
        found = _check_outputs(op, idx, env, phase)
        if found is not None:
            return found
    return None


def format_diagnosis(diag: dict) -> str:
    """One-line human rendering of a provenance dict."""
    where = (f"op #{diag['op_index']} {diag['op_type']!r}"
             if diag.get("op_type") else diag["phase"])
    return (f"first non-finite value produced by {where} -> var "
            f"{diag['var']!r} (phase {diag['phase']}, shape "
            f"{diag['shape']}, dtype {diag['dtype']}, "
            f"{diag['nan_count']} NaN / {diag['inf_count']} Inf elements)")
