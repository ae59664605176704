"""Elastic training service runner: the K = 8 -> 4 -> 8 resize round
(the port's counterpart of the JAX package's ``benchmark/elastic.py``,
with its config and data maker).

One real elastic job runs on this host: a coordinator
(``distributed.elastic.ElasticJob``, host only) and K worker processes
(``python -m paddle_tpu_torch elastic --worker``), each a full training
process of the port on ``--device`` over the master's slot-sharded
exactly-once streams.  The job shrinks to ``shrink_to`` workers once a
sixth of the tasks are committed and grows back once half are.  The
row holds the JAX runner's evidence and acceptance keys:

* a committed resize record per membership change, each with a planner
  re-plan for the new world size with zero PT030/PT031 findings;
* the loss continuing across both boundaries: the first quarter of
  batches after a resize sits below the cold start's first quarter;
* exactly-once task accounting (every task done, none lost);
* the wall time, and each boundary's drain, merge and re-plan ms, beside
  the card's name and power limit.

    python -m paddle_tpu_torch.benchmark.elastic [--smoke] [--device cpu]
        [--out PATH]

FULL is the JAX runner's default (8 -> 4 -> 8 workers, 96 chunks of 64
records, batch 8); SMOKE its ``--smoke`` (2 -> 1, 6 chunks of 16).
Results go to ``build/elastic_results.json`` (not with ``--smoke``
unless ``--out`` is given).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import pickle
import shutil
import sys
import tempfile
import threading
import time

import numpy as np

from .harness import write_results

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CONF = """
settings(batch_size=8, learning_rate=0.1,
         learning_method=MomentumOptimizer(momentum=0.9))
x = data_layer('x', 32)
y = data_layer('label', 5)
h = fc_layer(input=x, size=64, act=ReluActivation())
h2 = fc_layer(input=h, size=64, act=ReluActivation())
out = fc_layer(input=h2, size=5, act=SoftmaxActivation())
outputs(classification_cost(input=out, label=y))
"""

FULL = {"workers": 8, "shrink_to": 4, "chunks": 96, "recs": 64,
        "batch": 8}
SMOKE = {"workers": 2, "shrink_to": 1, "chunks": 6, "recs": 16,
         "batch": 8}


def make_data(root, n_chunks, recs_per_chunk, seed=7):
    """``n_chunks`` part files of a learnable synthetic task (a fixed
    random teacher, so the loss must fall): the JAX runner's data,
    record for record."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    w = rng.rand(32, 5)
    for i in range(n_chunks):
        recs = []
        for _ in range(recs_per_chunk):
            x = rng.rand(32).astype("float32")
            label = np.array([int(np.argmax(x @ w))], dtype="int64")
            recs.append((x, label))
        with open(os.path.join(root, f"part-{i:03d}.pickle"), "wb") as f:
            pickle.dump(recs, f)


def load_events(events_dir):
    """[(resize_epoch, slot, stream_index, cost)] from the workers'
    ``--events`` lines, a replayed batch's line replacing its first
    run's (the key is the slot's stream index)."""
    rows = {}
    for p in sorted(glob.glob(os.path.join(events_dir, "slot-*.jsonl"))):
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    e = json.loads(line)
                except json.JSONDecodeError:
                    continue
                rows[(e["epoch"], e["slot"], e["e"])] = float.fromhex(e["c"])
    return [(k[0], k[1], k[2], v) for k, v in sorted(rows.items())]


def _timed_job(base):
    """``ElasticJob`` with each resize boundary's phases timed: the
    drain, the merge (from the drain's end to the re-plan's start) and
    the re-plan, in ms."""

    class TimedJob(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.boundaries = []
            self._in_resize = None

        def _resize(self, new_world, reason):
            self._in_resize = {"from_world": self.world,
                               "to_world": int(new_world),
                               "reason": reason}
            t0 = time.perf_counter()
            try:
                super()._resize(new_world, reason)
            finally:
                b, self._in_resize = self._in_resize, None
                b["resize_ms"] = (time.perf_counter() - t0) * 1e3
                self.boundaries.append(b)

        def _drain_all(self):
            t0 = time.perf_counter()
            super()._drain_all()
            if self._in_resize is not None:
                now = time.perf_counter()
                self._in_resize["drain_ms"] = (now - t0) * 1e3
                self._in_resize["_drained_at"] = now

        def _replan(self):
            t0 = time.perf_counter()
            out = super()._replan()
            b = self._in_resize
            if b is not None and "_drained_at" in b:
                b["merge_ms"] = (t0 - b.pop("_drained_at")) * 1e3
                b["replan_ms"] = (time.perf_counter() - t0) * 1e3
            return out

    return TimedJob


def card_label(device: str) -> str:
    """The card's name and power limit (``nvidia-smi``, which opens no
    CUDA context in this process), or ``cpu``."""
    if device != "cuda":
        return "cpu"
    from .bandwidth import card_line
    return card_line()


def run(cfg, device="cuda", worker_cmd=None, work=None, quiet=False):
    """One elastic round at ``cfg`` (:data:`FULL` or :data:`SMOKE`) with
    workers on ``device``; returns the result document.  ``worker_cmd(spec,
    argv)`` may wrap each worker's ``_worker_argv_for_config`` argv;
    ``work`` is the scratch directory (a fresh temporary one by default,
    removed after)."""
    from ..distributed.elastic import (ElasticConfig, ElasticJob,
                                       _worker_argv_for_config,
                                       prebuild_kernels)
    from ..trainer_config_helpers import load_v1_config

    own_work = work is None
    work = work or tempfile.mkdtemp(prefix="ptt-elastic-bench-")
    os.makedirs(work, exist_ok=True)
    conf = os.path.join(work, "conf.py")
    with open(conf, "w") as f:
        f.write(CONF)
    data = os.path.join(work, "data")
    make_data(data, cfg["chunks"], cfg["recs"])
    chunks = sorted(glob.glob(os.path.join(data, "part-*.pickle")))
    events_dir = os.path.join(work, "events")
    os.makedirs(events_dir, exist_ok=True)
    root = os.path.join(work, "job")
    batch = cfg["batch"]

    v1 = load_v1_config(conf)
    if device == "cuda":
        prebuild_kernels(v1.main_program, batch)
    wenv = dict(os.environ)
    wenv["PYTHONPATH"] = REPO + os.pathsep + wenv.get("PYTHONPATH", "")
    base_cmd = _worker_argv_for_config(conf, batch, events_dir=events_dir,
                                       heartbeat_interval_s=0.05,
                                       device=device)
    cmd = base_cmd if worker_cmd is None else \
        (lambda spec: worker_cmd(spec, base_cmd(spec)))
    job = _timed_job(ElasticJob)(ElasticConfig(
        workers=cfg["workers"], data=chunks, root=root, worker_cmd=cmd,
        program=v1.main_program, task_timeout_s=120.0,
        heartbeat_lease_s=60.0, drain_timeout_s=300.0,
        assume_batch=batch, poll_s=0.05, env=wenv))
    t0 = time.time()
    job.start()

    n = len(chunks)
    milestones = [max(2, n // 6), max(4, n // 2)]

    def watcher():
        while job.master.stats()["done"] < milestones[0]:
            time.sleep(0.02)
        job.request_scale(cfg["shrink_to"])          # shrink on "loss"
        while job.resize_epoch < 1 or \
                job.master.stats()["done"] < milestones[1]:
            time.sleep(0.02)
        job.request_scale(cfg["workers"])            # regrow on rejoin

    threading.Thread(target=watcher, daemon=True,
                     name="pt-elastic-bench-watch").start()
    summary = job.run()
    wall = time.time() - t0

    events = load_events(events_dir)
    with open(os.path.join(root, "records.jsonl")) as f:
        records = [json.loads(line) for line in f]
    resizes = [r for r in records if r["event"] == "resize"]

    phases = []
    for ep in sorted({e[0] for e in events}):
        losses = [c for e, _s, _i, c in events if e == ep]
        world = next((r["world"] for r in records
                      if r["resize_epoch"] == ep), None)
        q = max(1, len(losses) // 4)
        phases.append({
            "resize_epoch": ep, "world": world, "batches": len(losses),
            "first_losses": losses[:4], "last_losses": losses[-4:],
            "mean_loss_first_quarter": float(np.mean(losses[:q])),
            "mean_loss_last_quarter": float(np.mean(losses[-q:])),
        })
    # the first post-resize quarter must sit below the cold start's
    # first quarter: nothing reset to the cold-start loss
    continuation = [{
        "boundary": f"{a['world']}->{b['world']}",
        "pre_last_quarter": a["mean_loss_last_quarter"],
        "post_first_quarter": b["mean_loss_first_quarter"],
        "cold_start_first_quarter": phases[0]["mean_loss_first_quarter"],
        "continues": b["mean_loss_first_quarter"]
        < phases[0]["mean_loss_first_quarter"],
    } for a, b in zip(phases, phases[1:])]

    card = card_label(device)
    doc = {
        "device": card,
        "host": {"cpu_count": os.cpu_count(),
                 "python": sys.version.split()[0]},
        "config": {"workers": cfg["workers"],
                   "shrink_to": cfg["shrink_to"], "chunks": n,
                   "recs_per_chunk": cfg["recs"], "batch_size": batch,
                   "worker_device": device},
        "summary": summary,
        "wall_s": wall,
        "boundaries": [dict(b, card=card) for b in job.boundaries],
        "resize_rounds": [{
            "reason": r["reason"], "world": r["world"],
            "resize_epoch": r["resize_epoch"],
            "replicas_merged": len((r.get("merged") or {})
                                   .get("merged_from", [])),
            "plan_candidate": (r.get("plan") or {}).get("candidate"),
            "pt030_pt031_findings": (r.get("plan") or {}).get(
                "lint_findings"),
        } for r in resizes],
        "phases": phases,
        "loss_continuation": continuation,
        "exactly_once": {
            "tasks": n, "done": summary["task_stats"]["done"],
            "unique_batches_trained": len(events),
            "expected_batches": n * cfg["recs"] // batch,
        },
        "acceptance": {
            "resize_round": f"{cfg['workers']}->{cfg['shrink_to']}->"
                            f"{cfg['workers']}",
            "all_replans_lint_clean": all(
                not r["plan"]["lint_findings"] for r in resizes
                if r.get("plan")),
            "committed_resize_records": len(resizes),
            "completed": summary["completed"],
            "zero_task_loss": summary["task_stats"]["done"] == n,
            "loss_continues_across_boundaries": all(
                c["continues"] for c in continuation),
        },
    }
    if not quiet:
        print(json.dumps(doc["acceptance"], indent=1))
        print(f"elastic: wall {wall:.2f} s; boundaries "
              f"{json.dumps(doc['boundaries'])}; {card}", flush=True)
    if own_work:
        shutil.rmtree(work, ignore_errors=True)
    return doc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="2 -> 1 workers over 6 chunks of 16 records")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the workers train")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    doc = run(SMOKE if args.smoke else FULL, device=args.device)
    write_results(args.out, args.smoke, "elastic_results.json",
                  "elastic", doc)
    # the JAX runner's verdict: every acceptance key true
    return 0 if all(doc["acceptance"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
