"""Incremental-checkpoint benchmark: a delta of the sparse tables' dirty
rows against a full save (the port's counterpart of the JAX package's
``benchmark/checkpoint.py``), paired alternating windows
(``tuning.search.paired_ab``: median of per-pair ratios, a noise
gate, raw windows kept, refusals recorded).

The commit path is host-side (the tables are host numpy; serialization,
hashes, fsync and rename on the writer), so the card does no work here;
the rows name the host they ran on beside the card's name and power
limit.  Arms:

* ``commit_ab``: a task's delta commit against the full-save control at
  a 2,000,000-row vocab with 2,000 of 400,000 resident rows touched a
  task.  Both arms train the same schedule on tables seeded alike, from
  the same committed base, each commit blocking.  Gates: wall
  ``min_speedup=5.0`` and ``bytes_ratio >= 10`` from the commits'
  manifests.  Both tips are then restored and held bit-equal to each
  other and to the live tables.
* ``restore_chain``: restore wall of a base and ``chain_k`` deltas
  against one full save of the same final state; the restored shas must
  be equal.
* ``elastic_tasks``: the elastic worker's task-boundary loop through
  ``train_state.Checkpointer`` (its ``sparse=`` session, full commits
  against deltas by ``DeltaPolicy``): an async commit a task and a
  durability barrier at each window's edge, tasks/s of each arm.

    python -m paddle_tpu_torch.benchmark.checkpoint [--smoke] [--out PATH]
    python -m paddle_tpu_torch.benchmark.run --model checkpoint [--smoke]

Results go to ``build/checkpoint_results.json`` (not with ``--smoke``
unless ``--out`` is given).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import tempfile
import time

import numpy as np

from .harness import device_label, write_results

FULL = {
    "vocab": 2_000_000,
    "dim": 16,
    "num_shards": 4,
    "resident_rows": 400_000,     # the warm working set (rows on disk)
    "touched_per_task": 2_000,    # 0.5% of the resident rows a task
    "ab_pairs": 4,
    "elastic_tasks_per_window": 3,
    "elastic_pairs": 3,
    "dense_param_floats": 1_000_000,   # the elastic arm's 4 MB dense rider
    "chain_k": 8,
}
SMOKE = {
    "vocab": 50_000,
    "dim": 8,
    "num_shards": 3,
    "resident_rows": 4_000,
    "touched_per_task": 40,
    "ab_pairs": 2,
    "elastic_tasks_per_window": 2,
    "elastic_pairs": 2,
    "dense_param_floats": 20_000,
    "chain_k": 3,
}


def _mk_table(cfg, name="emb"):
    from ..sparse import SparseTable
    return SparseTable(name, cfg["vocab"], cfg["dim"],
                       optimizer="adagrad", learning_rate=0.05,
                       num_shards=cfg["num_shards"], seed=3)


def _warm(cfg, t):
    ids = np.arange(cfg["resident_rows"], dtype=np.int64)
    g = np.random.RandomState(7).standard_normal(
        (len(ids), cfg["dim"])).astype(np.float32)
    t.push(ids, g)


def _feed(cfg, n_tasks, seed):
    """Per task (ids, grads), touching ``touched_per_task`` of the
    resident rows."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_tasks):
        ids = rng.choice(cfg["resident_rows"], size=cfg["touched_per_task"],
                         replace=False).astype(np.int64)
        out.append((ids, rng.standard_normal(
            (len(ids), cfg["dim"])).astype(np.float32)))
    return out


def _scope(state):
    from ..core import Scope
    sc = Scope()
    for k, v in state.items():
        sc.set(k, v)
    return sc


def _manager(root, **kw):
    from ..distributed.checkpoint import CheckpointManager
    return CheckpointManager(root, async_save=False, device="cpu", **kw)


def _sha(state):
    h = hashlib.sha256()
    for k in sorted(state):
        a = np.ascontiguousarray(np.asarray(state[k]))
        h.update(k.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _restore_sha(cfg, root):
    """Restore the newest commit into a fresh table and reduce it to the
    sha of the table's canonical export."""
    from ..core import Scope
    sc = Scope()
    step = _manager(root).restore(scope=sc)
    state = {k: np.asarray(sc.get(k)) for k in sc.keys()
             if k.startswith("__sparse__/")}
    t = _mk_table(cfg)
    t.restore_state_vars(state)
    return step, _sha(t.export_state_vars())


def run_commit_ab(cfg, workdir, quiet=False):
    arms = {}
    for mode in ("full", "delta"):
        t = _mk_table(cfg)
        _warm(cfg, t)
        cm = _manager(os.path.join(workdir, f"ab_{mode}"), max_to_keep=3)
        # both arms start from the same committed base: the delta arm
        # chains onto it, the full arm's windows are steady-state saves
        tok, st = t.export_full()
        cm.save(0, _scope(st), blocking=True, kind="full",
                on_commit=lambda info, tk=tok, tt=t: tt.commit_delta(tk))
        arms[mode] = {"t": t, "cm": cm, "cursor": 0, "step": 0,
                      "bytes": []}
    feeds = _feed(cfg, max(2, cfg["ab_pairs"]) + 1, seed=11)  # + warm-up

    def measure(config):
        kind = config["mode"]
        arm = arms[kind]
        ids, g = feeds[arm["cursor"]]
        arm["cursor"] += 1
        arm["t"].push(ids, g)
        arm["step"] += 1
        tok, st = (arm["t"].export_full() if kind == "full"
                   else arm["t"].export_delta())
        box = {}
        arm["cm"].save(arm["step"], _scope(st), blocking=True, kind=kind,
                       on_commit=lambda info, tk=tok, a=arm:
                           (a["t"].commit_delta(tk), box.update(info)),
                       on_fail=lambda exc, tk=tok, a=arm:
                           a["t"].retract_delta(tk))
        arm["bytes"].append(int(box["bytes"]))

    from ..tuning.search import paired_ab
    ab = paired_ab(measure, {"mode": "full"}, {"mode": "delta"},
                   pairs=cfg["ab_pairs"], warmup=1, min_speedup=5.0)
    # the bytes gate reads the timed windows' manifests (not the warm-up)
    fb = [float(b) for b in arms["full"]["bytes"][1:]]
    db = [float(b) for b in arms["delta"]["bytes"][1:]]
    bytes_ratio = float(np.median(fb) / max(1.0, np.median(db)))
    ab.update({
        "full_bytes_per_commit": fb, "delta_bytes_per_commit": db,
        "bytes_ratio": bytes_ratio, "min_bytes_ratio": 10.0,
        "bytes_accepted": bool(bytes_ratio >= 10.0),
        "touched_fraction":
            cfg["touched_per_task"] / cfg["resident_rows"]})
    # both arms trained the same schedule: the restored delta tip must
    # equal the restored full tip and the live tables
    live = _sha(arms["full"]["t"].export_state_vars())
    if _sha(arms["delta"]["t"].export_state_vars()) != live:
        raise RuntimeError("benchmark.checkpoint: the arms diverged; the "
                           "A/B compared two different runs")
    _, full_sha = _restore_sha(cfg, os.path.join(workdir, "ab_full"))
    _, delta_sha = _restore_sha(cfg, os.path.join(workdir, "ab_delta"))
    ab["restore_bit_identical"] = bool(full_sha == delta_sha == live)
    if not ab["restore_bit_identical"]:
        raise RuntimeError("benchmark.checkpoint: the delta chain's "
                           "restore diverged from the full save's")
    if not quiet:
        print(json.dumps({"arm": "commit_ab", "speedup": ab["speedup"],
                          "accepted": ab["accepted"],
                          "bytes_ratio": ab["bytes_ratio"],
                          "bytes_accepted": ab["bytes_accepted"]}),
              flush=True)
    return ab


def run_elastic_tasks(cfg, workdir, quiet=False):
    """The elastic worker's task-boundary loop through
    ``train_state.Checkpointer``: a commit a task on the async writer
    (the sparse session's rows beside a dense rider) and a durability
    barrier at the window's edge, where the worker's ``task_finished``
    waits; full commits against delta commits."""
    import torch

    from ..core import Scope
    from ..sparse import SparseSession
    from ..train_state import Checkpointer, DeltaPolicy

    class _Exe:
        _step = 0

    arms = {}
    for mode in ("full", "delta"):
        t = _mk_table(cfg)
        _warm(cfg, t)
        scope = Scope()
        scope.set("w", torch.zeros(cfg["dense_param_floats"],
                                   dtype=torch.float32))
        ck = Checkpointer(os.path.join(workdir, f"el_{mode}"), _Exe(),
                          handle_signals=False, sparse=SparseSession(t),
                          delta=DeltaPolicy(enabled=(mode == "delta")))
        ck.begin(scope, None, 0, {})
        arms[mode] = {"t": t, "ck": ck, "cursor": 0}
    per_win = cfg["elastic_tasks_per_window"]
    n_tasks = (max(2, cfg["elastic_pairs"]) + 1) * per_win
    feeds = _feed(cfg, n_tasks, seed=13)

    def measure(config):
        arm = arms[config["mode"]]
        ck = arm["ck"]
        for _ in range(per_win):
            ids, g = feeds[arm["cursor"]]
            arm["cursor"] += 1
            arm["t"].push(ids, g)
            ck.emitted += 1
            ck._save(0, 0)                      # the async commit
        ck.manager.wait()                       # task_finished's barrier

    from ..tuning.search import paired_ab
    ab = paired_ab(measure, {"mode": "full"}, {"mode": "delta"},
                   pairs=cfg["elastic_pairs"], warmup=1)
    ab["tasks_per_window"] = per_win
    ab["tasks_per_s"] = {
        m: per_win / float(np.median(w))
        for m, w in (("full", ab["default_windows"]),
                     ("delta", ab["candidate_windows"]))}
    ab["commit_kinds"] = {m: sorted({s["kind"] for s in a["ck"].saves})
                          for m, a in arms.items()}
    for arm in arms.values():                   # drain before teardown
        arm["ck"].manager.wait()
    if not quiet:
        print(json.dumps({"arm": "elastic_tasks",
                          "speedup": ab["speedup"],
                          "accepted": ab["accepted"],
                          "tasks_per_s": ab["tasks_per_s"]}), flush=True)
    return ab


def run_restore_chain(cfg, workdir, quiet=False):
    t = _mk_table(cfg)
    _warm(cfg, t)
    chain = _manager(os.path.join(workdir, "chain"),
                     max_to_keep=cfg["chain_k"] + 2)
    tok, st = t.export_full()
    chain.save(0, _scope(st), blocking=True, kind="full",
               on_commit=lambda info, tk=tok: t.commit_delta(tk))
    for k, (ids, g) in enumerate(_feed(cfg, cfg["chain_k"], seed=17), 1):
        t.push(ids, g)
        tok, st = t.export_delta()
        chain.save(k, _scope(st), blocking=True, kind="delta",
                   on_commit=lambda info, tk=tok: t.commit_delta(tk))
    # one full save of the same final state is the control
    ctrl = _manager(os.path.join(workdir, "ctrl"))
    tok, st = t.export_full()
    ctrl.save(cfg["chain_k"], _scope(st), blocking=True, kind="full",
              on_commit=lambda info, tk=tok: t.commit_delta(tk))

    t0 = time.perf_counter()
    step_c, sha_c = _restore_sha(cfg, os.path.join(workdir, "chain"))
    chain_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    step_f, sha_f = _restore_sha(cfg, os.path.join(workdir, "ctrl"))
    full_ms = (time.perf_counter() - t0) * 1e3
    if not step_c == step_f == cfg["chain_k"]:
        raise RuntimeError(f"benchmark.checkpoint: restored steps "
                           f"{step_c} and {step_f}, want {cfg['chain_k']}")
    row = {
        "chain_len": cfg["chain_k"],
        "chain_restore_ms": chain_ms,
        "full_restore_ms": full_ms,
        "replay_overhead_x": chain_ms / max(1e-9, full_ms),
        "bit_identical": bool(sha_c == sha_f),
    }
    if not row["bit_identical"]:
        raise RuntimeError("benchmark.checkpoint: the base + k-delta "
                           "replay diverged from the full save")
    if not quiet:
        print(json.dumps({"arm": "restore_chain", **row}), flush=True)
    return row


def run_all(cfg=None, smoke=False, quiet=False):
    """Every arm in a temporary directory."""
    cfg = cfg or (SMOKE if smoke else FULL)
    fns = {"commit_ab": run_commit_ab, "elastic_tasks": run_elastic_tasks,
           "restore_chain": run_restore_chain}
    row = {"config": dict(cfg)}
    with tempfile.TemporaryDirectory(prefix="ptt-ckpt-bench-") as workdir:
        for name, fn in fns.items():
            row[name] = fn(cfg, workdir, quiet=quiet)
    row["device"] = device_label()
    row["smoke"] = bool(smoke)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes; writes a results file only with "
                         "--out")
    ap.add_argument("--out", default=None, help="results path (default "
                    "build/checkpoint_results.json)")
    args = ap.parse_args(argv)
    row = run_all(smoke=args.smoke)
    print(json.dumps(row, indent=1))
    write_results(args.out, args.smoke, "checkpoint_results.json",
                  "incremental_checkpoint", row)
    return row


if __name__ == "__main__":
    main()
