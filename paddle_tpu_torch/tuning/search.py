"""Search engine: the measurement harness, grid and successive-halving
searches, and the paired A/B whose noise gate decides whether a winner is
real (counterpart of ``paddle_tpu/tuning/search.py``).

Measurement discipline:

* every score is the median of ``reps`` timed windows, after ``warmup``
  untimed ones (builds, captures, cache warming);
* the candidate-against-default verdict comes from :func:`paired_ab`:
  alternating default/candidate windows whose headline is the median of
  the per-pair ratios, so a slow stretch of a shared host falls on both
  arms;
* the noise gate: a winner is declared only when the median pair ratio
  reaches ``min_speedup`` and at least ``min_winning_fraction`` of the
  pairs favour the candidate.  Anything less is a refusal, recorded with
  its raw windows.

On a card every window is timed on the host's clock around
``torch.cuda.synchronize()``, so the work a window queued is in its
time; a target's ``measure`` ends on the card's completion as well.

Fault containment: each trial runs in :func:`run_trial`.  A config
whose measurement raises is a ``failed`` trial, one that overruns
``trial_timeout_s`` a ``timeout`` trial, and neither stops the search
(the ``tuning.trial`` fault site makes both paths deterministic for the
tests).  A device tunable is searched on the card and answered with the
pending-hardware stub (:func:`pending_stub`) only where
``torch.cuda.is_available()`` is false.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import observability as obs
from ..testing import faultinject as _fi
from . import store as _store
from . import tunables as _tn

__all__ = [
    "Trial", "SearchResult", "time_windows", "run_trial", "grid_search",
    "successive_halving", "paired_ab", "tune", "pending_stub",
]


def _card_sync() -> Callable[[], None]:
    """The window's completion barrier: ``torch.cuda.synchronize`` where
    a card is present, else nothing."""
    return torch.cuda.synchronize if torch.cuda.is_available() \
        else (lambda: None)


# ---------------------------------------------------------------------------
# Measurement harness (shared with the benchmark drivers and opprof)
# ---------------------------------------------------------------------------
def time_windows(call: Callable[[], object], *, reps: int = 3,
                 warmup: int = 1, unit: int = 1) -> dict:
    """Time ``call`` over ``reps`` windows after ``warmup`` discarded
    ones, on the host's clock (around a card's synchronize).  Returns
    the median seconds per ``unit``, the raw windows and the
    (max - min) / median spread in percent."""
    sync = _card_sync()
    for _ in range(max(0, warmup)):
        call()
    sync()
    times = []
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        call()
        sync()
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    return {
        "seconds": med / max(1, unit),
        "windows": [round(t, 6) for t in times],
        "spread_pct": round(100.0 * (max(times) - min(times)) / med, 2)
        if med > 0 else 0.0,
    }


# ---------------------------------------------------------------------------
# Trials
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Trial:
    config: Dict[str, object]
    status: str                      # ok | failed | timeout
    seconds: Optional[float] = None  # median s a window (ok trials only)
    windows: List[float] = dataclasses.field(default_factory=list)
    spread_pct: float = 0.0
    error: Optional[str] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class _InjectedTimeout(Exception):
    """A trial's timeout: overrun, or the ``tuning.trial`` site's
    ``timeout`` action (which exercises the path without hanging)."""


def run_trial(measure: Callable[[dict], object], config: Dict[str, object],
              *, reps: int = 3, warmup: int = 1,
              trial_timeout_s: float = 120.0) -> Trial:
    """One contained trial of ``config``: ``measure(config)`` runs one
    window.  A raising config records ``failed``; one whose wall time
    passes ``trial_timeout_s`` records ``timeout`` (soft: the window in
    flight finishes, its score is dropped).  Neither propagates."""
    sync = _card_sync()
    t_start = time.perf_counter()
    windows: List[float] = []
    status, err = "ok", None
    try:
        if _fi.ENABLED:
            action = _fi.check("tuning.trial")
            if action == "fail":
                raise _fi.InjectedFault("injected trial failure at "
                                        "tuning.trial")
            if action == "timeout":
                raise _InjectedTimeout("injected trial timeout at "
                                       "tuning.trial")
            if action is not None:
                _fi.raise_for(action, "tuning.trial")
        for _ in range(max(0, warmup)):
            measure(dict(config))
            sync()
            if time.perf_counter() - t_start > trial_timeout_s:
                raise _InjectedTimeout(
                    f"trial exceeded {trial_timeout_s}s during warmup")
        for _ in range(max(1, reps)):
            t0 = time.perf_counter()
            measure(dict(config))
            sync()
            windows.append(time.perf_counter() - t0)
            if time.perf_counter() - t_start > trial_timeout_s:
                raise _InjectedTimeout(
                    f"trial exceeded {trial_timeout_s}s")
    except _InjectedTimeout as e:
        status, err = "timeout", str(e)
    except Exception as e:          # noqa: BLE001 — containment is the point
        status, err = "failed", f"{type(e).__name__}: {e}"
    wall_ms = (time.perf_counter() - t_start) * 1e3
    obs.inc_counter("tuning/trials")
    obs.observe_hist("tuning/trial_ms", wall_ms)
    if status != "ok":
        obs.inc_counter("tuning/failures")
    obs.emit_event("tuning", event="trial", config=dict(config),
                   status=status, wall_ms=round(wall_ms, 3),
                   error=err)
    if status != "ok":
        return Trial(dict(config), status, error=err, windows=windows)
    med = float(np.median(windows))
    return Trial(dict(config), "ok", seconds=med,
                 windows=[round(w, 6) for w in windows],
                 spread_pct=round(100.0 * (max(windows) - min(windows))
                                  / med, 2) if med > 0 else 0.0)


# ---------------------------------------------------------------------------
# Search algorithms
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SearchResult:
    tunable: str
    algo: str
    trials: List[Trial]
    best: Optional[Dict[str, object]]      # lowest-median ok config
    default: Dict[str, object]
    truncated: int = 0                     # grid configs cut by the budget

    def to_dict(self) -> dict:
        return {"tunable": self.tunable, "algo": self.algo,
                "trials": [t.to_dict() for t in self.trials],
                "best": self.best, "default": dict(self.default),
                "truncated": self.truncated}


def _candidates(entry: dict, budget: Optional[int]):
    configs = list(_tn.grid_configs(entry))
    if budget is not None and budget < len(configs):
        # the default comes first, so a capped search still measures it
        return configs[:max(1, budget)], len(configs) - max(1, budget)
    return configs, 0


def grid_search(name: str, measure, *, budget: Optional[int] = None,
                reps: int = 3, warmup: int = 1,
                trial_timeout_s: float = 120.0,
                on_trial=None) -> SearchResult:
    """Every config (up to ``budget``) at full ``reps``."""
    entry = _tn.get_tunable(name)
    configs, truncated = _candidates(entry, budget)
    trials = []
    for cfg in configs:
        t = run_trial(measure, cfg, reps=reps, warmup=warmup,
                      trial_timeout_s=trial_timeout_s)
        trials.append(t)
        if on_trial is not None:
            on_trial(t)
    ok = [t for t in trials if t.status == "ok"]
    best = min(ok, key=lambda t: t.seconds).config if ok else None
    return SearchResult(name, "grid", trials, best, entry["default"],
                        truncated)


def successive_halving(name: str, measure, *, budget: Optional[int] = None,
                       eta: int = 3, reps: int = 3, warmup: int = 1,
                       trial_timeout_s: float = 120.0,
                       on_trial=None) -> SearchResult:
    """Every candidate gets one window; the best ``1 / eta`` advance to
    the next rung with ``eta`` times the windows, until at most ``eta``
    survivors run at full ``reps``.  Failed and timed-out configs drop
    at their rung; the winner comes from the last rung's trials only."""
    entry = _tn.get_tunable(name)
    configs, truncated = _candidates(entry, budget)
    trials: List[Trial] = []
    alive = list(configs)
    rung_reps = 1
    while alive:
        rung: List[Trial] = []
        for cfg in alive:
            # a warm-up at every rung: a first window that includes a
            # config's build would cull it on build time
            t = run_trial(measure, cfg, reps=rung_reps, warmup=warmup,
                          trial_timeout_s=trial_timeout_s)
            rung.append(t)
            trials.append(t)
            if on_trial is not None:
                on_trial(t)
        ok = sorted([t for t in rung if t.status == "ok"],
                    key=lambda t: t.seconds)
        if not ok:
            break
        if len(ok) <= max(2, eta) and rung_reps >= reps:
            break
        keep = max(1, len(ok) // eta)
        alive = [t.config for t in ok[:keep]]
        if rung_reps >= reps:
            break
        rung_reps = min(reps, rung_reps * eta)
    finals: Dict[str, Trial] = {}
    for t in trials:
        if t.status == "ok":
            finals[repr(sorted(t.config.items()))] = t
    ok = list(finals.values())
    best = None
    if ok:
        evidence = max(len(t.windows) for t in ok)
        finalists = [t for t in ok if len(t.windows) == evidence]
        best = min(finalists, key=lambda t: t.seconds).config
    return SearchResult(name, "halving", trials, best, entry["default"],
                        truncated)


# ---------------------------------------------------------------------------
# Paired A/B + noise gate
# ---------------------------------------------------------------------------
def paired_ab(measure, default_config: Dict[str, object],
              candidate_config: Dict[str, object], *, pairs: int = 5,
              warmup: int = 1, min_speedup: float = 1.10,
              min_winning_fraction: float = 0.75) -> dict:
    """``warmup`` untimed pairs, then ``max(2, pairs)`` timed pairs of
    ``measure(config)``, the default first in each.  The verdict is the
    median of the default / candidate ratios with the noise gate (module
    docstring); the raw windows ride along, so a refusal carries its
    evidence."""
    sync = _card_sync()
    for _ in range(max(0, warmup)):
        measure(dict(default_config))
        measure(dict(candidate_config))
    sync()
    d_windows, c_windows = [], []
    for _ in range(max(2, pairs)):
        t0 = time.perf_counter()
        measure(dict(default_config))
        sync()
        d_windows.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        measure(dict(candidate_config))
        sync()
        c_windows.append(time.perf_counter() - t0)
    ratios = [d / c for d, c in zip(d_windows, c_windows)]
    med = float(np.median(ratios))
    winning = sum(1 for r in ratios if r > 1.0) / len(ratios)
    accepted = med >= min_speedup and winning >= min_winning_fraction
    if accepted:
        reason = None
    elif med < min_speedup:
        reason = (f"median pair ratio {med:.3f} < min_speedup "
                  f"{min_speedup} — inside the noise band")
    else:
        reason = (f"only {winning:.0%} of pairs favor the candidate "
                  f"(< {min_winning_fraction:.0%}) — not robust to "
                  f"window-scale jitter")
    return {
        "speedup": round(med, 4),
        "pair_ratios": [round(r, 4) for r in ratios],
        "default_windows": [round(w, 6) for w in d_windows],
        "candidate_windows": [round(w, 6) for w in c_windows],
        "min_speedup": min_speedup,
        "min_winning_fraction": min_winning_fraction,
        "accepted": bool(accepted),
        "refusal_reason": reason,
    }


# ---------------------------------------------------------------------------
# Orchestration
# ---------------------------------------------------------------------------
def pending_stub(name: str) -> dict:
    """The result document of a device tunable where no card is present:
    its decision rule, and no rows."""
    entry = _tn.get_tunable(name)
    return {
        "tunable": name, "status": "pending_hardware",
        "backend": "cpu",
        "side": entry["side"],
        "decision_rule": entry["decision_rule"],
        "note": "device-side search target; run `python -m "
                "paddle_tpu_torch tune " + name + "` on a host with a "
                "CUDA card: the decision rule above governs enabling the "
                "winner",
    }


def tune(name: str, measure, *, algo: str = "grid",
         budget: Optional[int] = None, reps: int = 3, warmup: int = 1,
         pairs: int = 5, min_speedup: float = 1.10,
         trial_timeout_s: float = 120.0, context: str = "",
         save: bool = True, base: Optional[str] = None,
         on_trial=None) -> dict:
    """One tunable's tuning run: search its space, hold the best
    candidate against the default through the paired A/B's noise gate,
    and (the gate willing) persist the winner for replay.

    Returns a JSON-serializable document: the trial table, the A/B with
    its raw windows, and the record's path when a winner was stored.  A
    device tunable where ``torch.cuda.is_available()`` is false returns
    the pending-hardware stub without searching."""
    entry = _tn.get_tunable(name)
    if entry["side"] == "device" and not torch.cuda.is_available():
        doc = pending_stub(name)
        obs.emit_event("tuning", event="pending", tunable=name,
                       backend=doc["backend"])
        return doc
    search_fn = {"grid": grid_search,
                 "halving": successive_halving}.get(algo)
    if search_fn is None:
        raise ValueError(f"tune: unknown algo {algo!r} (grid|halving)")
    result = search_fn(name, measure, budget=budget, reps=reps,
                       warmup=warmup, trial_timeout_s=trial_timeout_s,
                       on_trial=on_trial)
    doc = {
        "tunable": name, "status": "searched", "context": str(context),
        "search": result.to_dict(),
    }
    if result.best is None:
        doc["status"] = "no_viable_config"
        obs.inc_counter("tuning/refusals")
        obs.emit_event("tuning", event="refusal", tunable=name,
                       reason="no config measured ok")
        return doc
    if result.best == dict(entry["default"]):
        doc["status"] = "default_is_best"
        obs.emit_event("tuning", event="default_best", tunable=name)
        return doc
    verdict = paired_ab(measure, entry["default"], result.best,
                        pairs=pairs, warmup=warmup,
                        min_speedup=min_speedup)
    doc["ab"] = verdict
    doc["winner"] = result.best if verdict["accepted"] else None
    if verdict["accepted"]:
        doc["status"] = "winner"
        obs.inc_counter("tuning/winners")
        obs.emit_event("tuning", event="winner", tunable=name,
                       config=result.best,
                       speedup=verdict["speedup"])
        if save:
            doc["record_path"] = _store.save_record(
                name, result.best, context=context, base=base,
                score=min(t.seconds for t in result.trials
                          if t.status == "ok"),
                speedup=verdict["speedup"], algo=result.algo,
                pair_ratios=verdict["pair_ratios"],
                default_windows=verdict["default_windows"],
                candidate_windows=verdict["candidate_windows"])
    else:
        doc["status"] = "noise_gate_refusal"
        obs.inc_counter("tuning/refusals")
        obs.emit_event("tuning", event="refusal", tunable=name,
                       reason=verdict["refusal_reason"],
                       speedup=verdict["speedup"])
    return doc
