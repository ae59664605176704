"""The autotuner's A/B, tuned against default, on every built-in target
(the port's counterpart of the JAX package's ``benchmark/autotune.py``).

For each target of ``paddle_tpu_torch.tuning.targets`` (the seven host
knobs, and on the card K1's launch plan and K2-K4's ring depths) this
driver runs the real search path, ``tuning.search.tune``: the grid over
the declared space, then the paired alternating default-against-best A/B
(the median of per-pair ratios), and writes the outcome as it came: a
winner only where the noise gate accepts it, else the gate's refusal
with its raw windows, or ``default_is_best``.  The tunables with no
target (and the device ones where no card is present) give their
pending-hardware stubs with their decision rules.

Winners are stored under a throwaway directory unless ``--cache-dir``
is given (then ``PADDLE_TPU_TORCH_CACHE_DIR`` or the ``cache_dir`` flag
at that path replays them under the ``autotune`` opt-in).

    python -m paddle_tpu_torch.benchmark.autotune [--smoke]
        [--target NAME] [--cache-dir DIR] [--out PATH]
    python -m paddle_tpu_torch.benchmark.run --model autotune [--smoke]

Results go to ``build/autotune_results.json`` (not with ``--smoke``
unless ``--out`` is given), each row beside the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from ..tuning import search, targets
from ..tuning.tunables import get_tunable, registered_tunables
from .harness import device_label, write_results

MIN_SPEEDUP = 1.10


def run_one(name: str, store_dir: str, smoke: bool, quiet: bool = False):
    """One target through ``tune``: its row (status, default, winner,
    trials, and the A/B's verdict with its raw windows)."""
    targets.ensure_registered(name)
    entry = get_tunable(name)
    if entry["side"] == "device" and not torch.cuda.is_available():
        return {"tunable": name, "smoke": smoke, **search.pending_stub(name)}
    measure = targets.build_target(name, smoke=smoke)

    def on_trial(t):
        if not quiet:
            print(json.dumps({"tunable": name, "trial": t.config,
                              "status": t.status, "seconds": t.seconds}),
                  flush=True)

    doc = search.tune(name, measure,
                      reps=2 if smoke else 3,
                      pairs=3 if smoke else 7,
                      budget=4 if smoke else None,
                      min_speedup=MIN_SPEEDUP,
                      context=getattr(measure, "context", ""),
                      base=store_dir, save=True, on_trial=on_trial)
    trials = doc.get("search", {}).get("trials", [])
    row = {
        "tunable": name,
        "status": doc["status"],
        "default": doc.get("search", {}).get("default"),
        "winner": doc.get("winner"),
        "trials": [{"config": t["config"], "status": t["status"],
                    "seconds": t["seconds"], "error": t["error"]}
                   for t in trials],
        "build_seconds": getattr(measure, "build_seconds", None),
        "smoke": smoke,
    }
    ab = doc.get("ab")
    if ab is not None:
        # the verdict and its evidence: a refusal is a row, not a gap
        row["ab"] = {k: ab[k] for k in
                     ("speedup", "pair_ratios", "default_windows",
                      "candidate_windows", "min_speedup", "accepted",
                      "refusal_reason")}
    if doc.get("record_path"):
        row["record_committed"] = True
    if not quiet:
        print(json.dumps({k: row[k] for k in ("tunable", "status",
                                              "winner")}
                         | ({"speedup": ab["speedup"]} if ab else {})),
              flush=True)
    return row


def run_all(smoke: bool = False, names=None, store_dir=None,
            quiet: bool = False) -> dict:
    """Every target (or ``names``) through :func:`run_one`, and the
    pending stubs of the tunables with no target."""
    names = list(names or targets.target_names())
    tmp = None
    if store_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="pt-autotune-")
        store_dir = tmp.name
    try:
        rows = [run_one(n, store_dir, smoke, quiet) for n in names]
    finally:
        if tmp is not None:
            tmp.cleanup()
    for n in targets.target_names():
        targets.ensure_registered(n)
    pending = [search.pending_stub(n) for n in registered_tunables()
               if n not in targets.TARGETS
               and get_tunable(n)["pending_hardware"]]
    return {"device": device_label(), "cpu_count": os.cpu_count(),
            "min_speedup_gate": MIN_SPEEDUP, "smoke": smoke,
            "rows": rows, "pending_hardware": pending}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--target", default="all",
                    choices=["all"] + targets.target_names())
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes, budget 4; writes a results file only "
                         "with --out")
    ap.add_argument("--cache-dir", default=None,
                    help="store winners here for replay (default: a "
                         "throwaway directory)")
    ap.add_argument("--out", default=None,
                    help="results path (default "
                         "build/autotune_results.json)")
    args = ap.parse_args(argv)
    names = None if args.target == "all" else [args.target]
    doc = run_all(smoke=args.smoke, names=names, store_dir=args.cache_dir)
    write_results(args.out, args.smoke, "autotune_results.json",
                  "autotune_tuned_vs_default", doc)
    return doc


if __name__ == "__main__":
    main()
