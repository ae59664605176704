"""``python -m paddle_tpu_torch tune`` (counterpart of the JAX command
line's ``job_tune``, ``paddle_tpu/cli.py:495-620``): search one
registered tunable's space on its built-in target and persist the winner
for replay.

::

    python -m paddle_tpu_torch tune --list
    python -m paddle_tpu_torch tune <tunable> [--algo grid|halving]
        [--budget N] [--reps N] [--pairs N] [--min-speedup X]
        [--trial-timeout-s S] [--smoke] [--cache-dir DIR] [--no-save]
        [--out FILE]

One JSON line per trial, then a summary object on the last line (the
full document, trial table and A/B windows, goes to ``--out``).  A
search that would persist refuses to start without a store
(``--cache-dir``, the ``cache_dir`` flag or
``PADDLE_TPU_TORCH_CACHE_DIR``).  A device tunable where
``torch.cuda.is_available()`` is false prints its pending-hardware stub
and decision rule instead of searching.
"""
from __future__ import annotations

import argparse
import json

import torch

__all__ = ["tune_main"]


def tune_main(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch tune",
        description="persistent autotuner (paddle_tpu_torch.tuning): "
                    "search a registered tunable's declared space on its "
                    "built-in target (grid or successive halving, the "
                    "paired-A/B noise gate) and persist the winner under "
                    "<cache_dir>/tuning/ for replay through the autotune "
                    "opt-ins (Executor(autotune=True), "
                    "trainer.SGD.train(autotune=True), "
                    "PADDLE_TPU_TORCH_AUTOTUNE=1).  A device tunable with "
                    "no card prints its pending-hardware stub and decision "
                    "rule instead of searching.")
    ap.add_argument("target", nargs="?", default=None,
                    help="tunable name (e.g. executor/run_pipelined); "
                         "omit with --list to enumerate")
    ap.add_argument("--list", action="store_true",
                    help="list registered tunables (spaces, defaults, "
                         "decision rules) and exit")
    ap.add_argument("--algo", default="grid", choices=["grid", "halving"],
                    help="search algorithm (default grid; halving for "
                         "large spaces under a tight budget)")
    ap.add_argument("--budget", type=int, default=None,
                    help="max configs evaluated (default: the full grid; "
                         "the default config is always included)")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed windows a trial (median scores; default 3)")
    ap.add_argument("--pairs", type=int, default=5,
                    help="alternating default/candidate pairs in the "
                         "final A/B (median of per-pair ratios; default 5)")
    ap.add_argument("--min-speedup", type=float, default=1.10,
                    help="noise-gate threshold on the median pair ratio "
                         "(default 1.10)")
    ap.add_argument("--trial-timeout-s", type=float, default=120.0,
                    help="soft per-trial budget; overruns record "
                         "'timeout' and the search goes on (default 120)")
    ap.add_argument("--smoke", action="store_true",
                    help="seconds-fast target sizes (a path check; a "
                         "smoke winner is still persisted: use --no-save)")
    ap.add_argument("--cache-dir", default=None,
                    help="winner store root (default: the cache_dir flag "
                         "/ PADDLE_TPU_TORCH_CACHE_DIR; records go under "
                         "<dir>/tuning/)")
    ap.add_argument("--no-save", action="store_true",
                    help="search and report only; persist no winner")
    ap.add_argument("--out", default=None,
                    help="also write the whole result document (trial "
                         "table, A/B windows, verdict) to this JSON file")
    args = ap.parse_args(argv)

    from ..core.registry import get_tunable, registered_tunables
    from . import search, targets, tunables

    if args.list or args.target is None:
        if not args.list:
            ap.error("give a tunable name, or --list")
        # the lazily imported subsystems' declarations too
        for t in targets.target_names():
            targets.ensure_registered(t)
        for n in registered_tunables():
            print(tunables.describe(n)
                  + ("" if n in targets.TARGETS else
                     "\n  (no built-in target: library use through "
                     "paddle_tpu_torch.tuning.tune)"), flush=True)
            print(flush=True)
        return 0

    name = args.target
    targets.ensure_registered(name)
    try:
        entry = get_tunable(name)
    except KeyError as e:
        raise SystemExit(f"tune: {e}")
    if entry["side"] == "device" and not torch.cuda.is_available():
        doc = search.pending_stub(name)
    else:
        if not args.no_save:
            # fail before the search, not after: an accepted winner with
            # nowhere to go would make search-then-replay a no-op
            from . import store as _store
            if not _store.store_dir(args.cache_dir):
                raise SystemExit(
                    "tune: no winner store configured: set "
                    "PADDLE_TPU_TORCH_CACHE_DIR (or the cache_dir flag), "
                    "pass --cache-dir DIR, or run with --no-save to "
                    "search without persisting")
        try:
            measure = targets.build_target(name, smoke=args.smoke)
        except KeyError as e:
            raise SystemExit(f"tune: {e}")

        def on_trial(t):
            print(json.dumps({"trial": t.config, "status": t.status,
                              "seconds": t.seconds,
                              "spread_pct": t.spread_pct,
                              "error": t.error}), flush=True)

        doc = search.tune(
            name, measure, algo=args.algo, budget=args.budget,
            reps=args.reps, pairs=args.pairs,
            min_speedup=args.min_speedup,
            trial_timeout_s=args.trial_timeout_s,
            context=getattr(measure, "context", ""),
            save=not args.no_save, base=args.cache_dir,
            on_trial=on_trial)
    if args.out:
        try:
            with open(args.out, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
        except OSError as e:
            raise SystemExit(f"tune: cannot write {args.out!r}: {e}")
    summary = {k: doc.get(k) for k in
               ("tunable", "status", "winner", "record_path",
                "decision_rule")
               if doc.get(k) is not None}
    if "ab" in doc:
        summary["speedup"] = doc["ab"]["speedup"]
        summary["pair_ratios"] = doc["ab"]["pair_ratios"]
        if doc["ab"]["refusal_reason"]:
            summary["refusal_reason"] = doc["ab"]["refusal_reason"]
    print(json.dumps(summary, sort_keys=True), flush=True)
    return 0
