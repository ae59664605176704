"""Giant-embedding CTR benchmark on a CUDA card: host-resident sparse
tables against a dense embedding on the card (the port's counterpart of
the JAX package's ``benchmark/ctr.py``; the reference capability is the
pserver sparse-row path, SparseRemoteParameterUpdater.h:265,
math/SparseRowMatrix.h:206).

The model is the JAX runner's: two embeddings (``ctr_big``, 2,000,000 x
16, and ``ctr_small``, 100,000 x 16) concatenated with 13 dense
features, a 64-wide relu layer and a sigmoid, squared error, Adagrad
0.05; Zipf(1.2) ids, batch 512 (``FULL``; ``SMOKE`` is the JAX runner's
tiny form).  Rows, each beside the card's name and power limit:

* ``sparse``: training examples/s with the tables on the host
  (``SparseSession``, the bucket pinned to the batch: one captured
  step), median of ``windows`` windows of ``window_steps`` steps after
  ``warmup_steps``; per-batch pull latency p50/p99 (all windows, and the
  last window alone), push rows/s, live rows, the host tables' MB;
* ``dense_control``: the same model and feeds with both tables dense on
  the card;
* ``vectorization_ab``: the paired alternating A/B of the host hot path
  (``SparseTable(impl="reference")`` against ``"vectorized"``): the
  training loop (``steady``, gate 1.5x), fresh-table pulls
  (``cold_init``) and the synchronous rim against pull-ahead prefetch
  with async pushes (``overlap``), each the median of per-pair ratios
  with its raw windows (``benchmark.harness.paired_ab``);
* ``cache``: the hot-rows cache's hit rate under read-only Zipf
  traffic (the serving path; host only).

``HBM_EMBEDDING_BUDGET_MB`` is the JAX runner's declared premise (a TPU
slice's share for embeddings), reported beside the dense tables' size;
it is not this card's: an 80 GB H100 holds the dense control many times
over.

* ``doctor``: one extra observed sparse pass after the timed windows
  (its instrumentation never touches them): the step budget
  (``observability.attribution.step_budget``) over its JSONL log, which
  reconciles with the measured wall within ``BUDGET_TOLERANCE``; the
  ``sparse/pull`` and ``sparse/push`` spans ride the same log.

    python -m paddle_tpu_torch.benchmark.ctr [--smoke] [--out PATH]
        [--device cuda|cpu]
    python -m paddle_tpu_torch.benchmark.run --model ctr [--smoke]

runs on the card unless ``--device cpu``; ``run_all(smoke=True,
place=CPUPlace())`` runs it here.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from .harness import device_label, observed, paired_ab, write_results

# The JAX runner's premise: a per-device HBM share budgeted for
# embeddings, which the big table's dense form exceeds.  Not this card's.
HBM_EMBEDDING_BUDGET_MB = 64

FULL = {
    "batch": 512,
    "emb_dim": 16,
    "vocab_big": 2_000_000,
    "vocab_small": 100_000,
    "dense_features": 13,
    "hidden": 64,
    "warmup_steps": 3,
    "window_steps": 10,
    "windows": 3,
    "cache_rows": 65_536,
    "cache_batches": 60,
    "zipf_a": 1.2,
    "ab_pairs": 5,
    "ab_window_steps": 8,
    "cold_rows": 200_000,
    "cold_chunk": 8192,
}
SMOKE = {
    "batch": 64,
    "emb_dim": 8,
    "vocab_big": 20_000,
    "vocab_small": 2_000,
    "dense_features": 4,
    "hidden": 16,
    "warmup_steps": 1,
    "window_steps": 3,
    "windows": 2,
    "cache_rows": 1024,
    "cache_batches": 8,
    "zipf_a": 1.2,
    "ab_pairs": 2,
    "ab_window_steps": 3,
    "cold_rows": 2_000,
    "cold_chunk": 512,
}

LEARNING_RATE = 0.05


def _place(place):
    from ..core import CUDAPlace
    return CUDAPlace(0) if place is None else place


def build_model(cfg, sparse: bool, minimize: bool = True):
    """The CTR program (``benchmark/ctr.py:104-130``) in fresh default
    programs and scope; returns the loss.  ``minimize=False`` leaves the
    optimizer out (for a ``trainer.SGD``, which adds its own)."""
    from .. import core, layers, optimizer, unique_name
    core.reset_default_programs()
    core.reset_global_scope()
    unique_name.reset()
    core.default_main_program().random_seed = 42
    core.default_startup_program().random_seed = 42
    ids_big = layers.data("ids_big", shape=[1], dtype="int64")
    ids_small = layers.data("ids_small", shape=[1], dtype="int64")
    dense = layers.data("dense", shape=[cfg["dense_features"]],
                        dtype="float32")
    label = layers.data("label", shape=[1], dtype="float32")
    kw = {"sparse": True} if sparse else {}
    e_big = layers.embedding(ids_big, size=[cfg["vocab_big"],
                                            cfg["emb_dim"]],
                             name="ctr_big", **kw)
    e_small = layers.embedding(ids_small, size=[cfg["vocab_small"],
                                                cfg["emb_dim"]],
                               name="ctr_small", **kw)
    x = layers.concat([e_big, e_small, dense], axis=1)
    x = layers.fc(x, size=cfg["hidden"], act="relu")
    pred = layers.fc(x, size=1, act="sigmoid")
    loss = layers.mean(layers.square(pred - label))
    if minimize:
        optimizer.Adagrad(learning_rate=LEARNING_RATE).minimize(loss)
    return loss


def zipf_ids(rng, a, vocab, size):
    """Zipfian ids over [0, vocab): a heavy head at small ids."""
    draws = rng.zipf(a, size=size).astype(np.int64)
    return (draws - 1) % vocab


def feed_stream(cfg, n, seed=0):
    """``n`` feeds, the JAX runner's stream for the same seed."""
    rng = np.random.RandomState(seed)
    B = cfg["batch"]
    for _ in range(n):
        yield {
            "ids_big": zipf_ids(rng, cfg["zipf_a"], cfg["vocab_big"],
                                (B, 1)),
            "ids_small": zipf_ids(rng, cfg["zipf_a"], cfg["vocab_small"],
                                  (B, 1)),
            "dense": rng.rand(B, cfg["dense_features"]).astype(
                np.float32),
            "label": (rng.rand(B, 1) < 0.3).astype(np.float32),
        }


def _pctl(xs, q):
    if not xs:
        return None
    return float(np.percentile(np.asarray(xs, np.float64), q))


def sparse_tables(cfg, impl="vectorized", initializer=None):
    """The runner's two host tables (8 and 4 shards, seeds 1 and 2);
    ``initializer``: ``{name: initializer}`` overrides."""
    from ..sparse import SparseTable
    kw = dict(optimizer="adagrad", learning_rate=LEARNING_RATE, impl=impl)
    init = initializer or {}
    return {
        "ctr_big": SparseTable("ctr_big", cfg["vocab_big"], cfg["emb_dim"],
                               num_shards=8, seed=1,
                               initializer=init.get("ctr_big"), **kw),
        "ctr_small": SparseTable("ctr_small", cfg["vocab_small"],
                                 cfg["emb_dim"], num_shards=4, seed=2,
                                 initializer=init.get("ctr_small"), **kw),
    }


def run_sparse_arm(cfg, place=None, quiet=False, feeds=None):
    """Sparse-table training throughput and the rim's host metrics.
    Returns ``(row, session, executor, loss)``; ``feeds`` overrides the
    runner's feed stream."""
    from .. import core
    from ..sparse import SparseSession

    place = _place(place)
    loss = build_model(cfg, sparse=True)
    tables = sparse_tables(cfg)
    # the bucket pinned to the batch: one captured step whatever the
    # batch's unique count
    sess = SparseSession(tables, bucket_floor=cfg["batch"])
    main = core.default_main_program()
    sess.bind(main)
    exe = core.Executor(place)
    exe.run(core.default_startup_program())
    steps = cfg["warmup_steps"] + cfg["windows"] * cfg["window_steps"]
    feeds = feeds if feeds is not None else list(feed_stream(cfg, steps))
    pull_ms, push_rows, push_ms = [], 0, 0.0
    windows, last_window_pulls = [], []
    k = 0
    for w in range(-1, cfg["windows"]):          # window -1: warm-up
        n = cfg["warmup_steps"] if w < 0 else cfg["window_steps"]
        t0 = time.perf_counter()
        for _ in range(n):
            s0 = dict(sess.stats)
            out = sess.run(exe, main, feeds[k], [loss])
            float(out[0])
            k += 1
            if w >= 0:
                dt = sess.stats["pull_ms"] - s0["pull_ms"]
                pull_ms.append(dt)
                if w == cfg["windows"] - 1:
                    last_window_pulls.append(dt)
                push_rows += sess.stats["pushed_rows"] - s0["pushed_rows"]
                push_ms += sess.stats["push_ms"] - s0["push_ms"]
        if w >= 0:
            windows.append(cfg["batch"] * n / (time.perf_counter() - t0))
    row = {
        "examples_per_sec": float(np.median(windows)),
        "examples_per_sec_windows": windows,
        "lookup_latency_ms": {"p50": _pctl(pull_ms, 50),
                              "p99": _pctl(pull_ms, 99)},
        "lookup_latency_warm_ms": {"p50": _pctl(last_window_pulls, 50),
                                   "p99": _pctl(last_window_pulls, 99)},
        "push_rows_per_sec": push_rows / (push_ms / 1e3)
        if push_ms else None,
        "pushed_rows": int(push_rows),
        "live_rows": {n: t.live_rows for n, t in tables.items()},
        "host_table_mb": sum(t.host_bytes() for t in tables.values())
        / 2**20,
        "device": device_label(place),
    }
    if not quiet:
        print(json.dumps({"arm": "sparse", **row}), flush=True)
    return row, sess, exe, loss


def run_dense_control(cfg, place=None, quiet=False, feeds=None):
    """The control: the same model and feeds with both tables dense on
    the card (every step's Adagrad sweeps the whole tables)."""
    from .. import core

    place = _place(place)
    loss = build_model(cfg, sparse=False)
    exe = core.Executor(place)
    exe.run(core.default_startup_program())
    main = core.default_main_program()
    steps = cfg["warmup_steps"] + cfg["windows"] * cfg["window_steps"]
    feeds = feeds if feeds is not None else list(feed_stream(cfg, steps))
    windows, k = [], 0
    for w in range(-1, cfg["windows"]):
        n = cfg["warmup_steps"] if w < 0 else cfg["window_steps"]
        t0 = time.perf_counter()
        for _ in range(n):
            out = exe.run(main, feed=feeds[k], fetch_list=[loss])
            float(out[0])
            k += 1
        if w >= 0:
            windows.append(cfg["batch"] * n / (time.perf_counter() - t0))
    row = {"examples_per_sec": float(np.median(windows)),
           "examples_per_sec_windows": windows,
           "device": device_label(place)}
    if not quiet:
        print(json.dumps({"arm": "dense_control", **row}), flush=True)
    return row, exe, loss


def _train_window(sess, exe, prog, loss_name, feeds, scope):
    """One window: pull (maybe prefetched), step, push for every feed,
    then the flush barrier."""
    it = sess.prefetch_feeds(iter(feeds))
    try:
        for feed in it:
            out = exe.run(prog, feed=feed,
                          fetch_list=[loss_name] + sess.grad_fetch_list,
                          scope=scope)
            float(np.asarray(out[0]).reshape(-1)[0])
            sess.complete(out[1:])
    finally:
        it.close()
    sess.flush()


def _impl_arm(cfg, impl, place, session_kw=None):
    """A training arm of its own (program, scope, executor, tables)
    whose window cursor walks a shared feed schedule."""
    from .. import core
    from ..sparse import SparseSession

    loss = build_model(cfg, sparse=True)
    prog = core.default_main_program()
    scope = core.Scope()
    exe = core.Executor(place)
    exe.run(core.default_startup_program(), feed={}, fetch_list=[],
            scope=scope)
    sess = SparseSession(sparse_tables(cfg, impl=impl),
                         bucket_floor=cfg["batch"], **(session_kw or {}))
    sess.bind(prog)
    return {"sess": sess, "exe": exe, "prog": prog, "scope": scope,
            "loss_name": loss.name, "cursor": 0}


def run_vectorization_ab(cfg, place=None, quiet=False):
    """The scalar-vs-vectorized host A/B (``benchmark/ctr.py:308-391``):
    both arms of a pair consume the same feed windows."""
    place = _place(place)
    W = cfg["ab_window_steps"]
    pairs = cfg["ab_pairs"]
    # paired_ab runs max(2, pairs) measured pairs and 1 warm-up pair
    n_windows = (max(2, pairs) + 1) * W
    feeds = list(feed_stream(cfg, n_windows, seed=11))

    def next_window(arm):
        lo = arm["cursor"]
        arm["cursor"] += W
        window = feeds[lo:lo + W]
        if len(window) != W:
            raise RuntimeError(f"feed schedule exhausted at {lo} (have "
                               f"{len(feeds)})")
        return window

    arms = {"reference": _impl_arm(cfg, "reference", place),
            "vectorized": _impl_arm(cfg, "vectorized", place)}

    def measure_steady(config):
        arm = arms[config["impl"]]
        _train_window(arm["sess"], arm["exe"], arm["prog"],
                      arm["loss_name"], next_window(arm), arm["scope"])

    steady = paired_ab(measure_steady, {"impl": "reference"},
                       {"impl": "vectorized"}, pairs=pairs, warmup=1,
                       min_speedup=1.5)
    steady["examples_per_window"] = cfg["batch"] * W
    # the two arms trained the same run: their tables agree bytewise
    sv = arms["vectorized"]["sess"].export_state_vars()
    sr = arms["reference"]["sess"].export_state_vars()
    steady["arms_bit_identical"] = sorted(sv) == sorted(sr) and all(
        sv[k].tobytes() == sr[k].tobytes() for k in sv)

    rng = np.random.RandomState(5)
    cold_ids = np.unique(rng.randint(
        0, cfg["vocab_big"], int(cfg["cold_rows"] * 1.2)
    ).astype(np.int64))[:cfg["cold_rows"]]

    def measure_cold(config):
        t = sparse_tables(cfg, impl=config["impl"])["ctr_big"]
        for lo in range(0, len(cold_ids), cfg["cold_chunk"]):
            t.pull(cold_ids[lo:lo + cfg["cold_chunk"]])

    cold = paired_ab(measure_cold, {"impl": "reference"},
                     {"impl": "vectorized"}, pairs=pairs, warmup=1)
    cold["rows_per_window"] = int(len(cold_ids))

    over_arm = {
        "sync": _impl_arm(cfg, "vectorized", place),
        "overlap": _impl_arm(cfg, "vectorized", place,
                             {"prefetch_depth": 2, "async_push": 2,
                              "push_flush_batch": 2}),
    }

    def measure_overlap(config):
        arm = over_arm[config["mode"]]
        _train_window(arm["sess"], arm["exe"], arm["prog"],
                      arm["loss_name"], next_window(arm), arm["scope"])

    overlap = paired_ab(measure_overlap, {"mode": "sync"},
                        {"mode": "overlap"}, pairs=pairs, warmup=1)
    stats = over_arm["overlap"]["sess"].stats
    overlap["prefetch_hits"] = stats["prefetch_hits"]
    overlap["prefetch_misses"] = stats["prefetch_misses"]

    row = {"steady": steady, "cold_init": cold, "overlap": overlap,
           "device": device_label(place)}
    if not quiet:
        print(json.dumps({"arm": "vectorization_ab", **{
            k: {"speedup": v["speedup"], "accepted": v["accepted"]}
            for k, v in row.items() if k != "device"},
            "device": row["device"]}), flush=True)
    return row


def run_cache_arm(cfg, quiet=False):
    """Hot-rows cache hit rate under Zipf read-only traffic (the serving
    path: pull-only, cache-first; host only)."""
    from .. import core
    from ..sparse import SparseSession

    build_model(cfg, sparse=True)
    sess = SparseSession(sparse_tables(cfg), cache_rows=cfg["cache_rows"])
    sess.bind(core.default_main_program())
    for feed in feed_stream(cfg, cfg["cache_batches"], seed=7):
        sess.prepare_feed(feed, is_test=True)
    cs = sess.cache_stats()
    row = {"cache_rows": cfg["cache_rows"], "batches": cfg["cache_batches"],
           "zipf_a": cfg["zipf_a"], "hits": cs["hits"],
           "misses": cs["misses"], "hit_rate": cs["hit_rate"]}
    if not quiet:
        print(json.dumps({"arm": "cache", **row}), flush=True)
    return row


def run_doctor_pass(cfg, place=None, quiet=False):
    """One extra observed sparse pass, after the timed windows: its
    steps' budget must reconcile with the measured wall within
    ``BUDGET_TOLERANCE``.  Two unobserved steps go first (a key's
    warm-up and capture belong to start-up, not to the budget)."""
    from .. import core
    from ..observability import attribution
    from ..sparse import SparseSession

    place = _place(place)
    loss = build_model(cfg, sparse=True)
    sess = SparseSession(sparse_tables(cfg), observe=True,
                         bucket_floor=cfg["batch"])
    main = core.default_main_program()
    sess.bind(main)
    exe = core.Executor(place, observe=True)
    exe.run(core.default_startup_program())
    warm = 2
    feeds = list(feed_stream(cfg, cfg["window_steps"] + warm, seed=3))
    for feed in feeds[:warm]:
        float(sess.run(exe, main, feed, [loss])[0])
    with observed("ctr") as log:
        for feed in feeds[warm:]:
            float(sess.run(exe, main, feed, [loss])[0])
    report = attribution.doctor_report([log], program=main,
                                       assume_batch=cfg["batch"])
    row = {"doctor": report.get("training"),
           "calibration": report.get("calibration")}
    if not quiet:
        print(json.dumps({"arm": "doctor", **row}), flush=True)
    return row


def run_all(cfg=None, smoke=False, place=None, quiet=False):
    cfg = cfg or (SMOKE if smoke else FULL)
    place = _place(place)
    dense_mb = (cfg["vocab_big"] + cfg["vocab_small"]) \
        * cfg["emb_dim"] * 4 / 2**20
    sparse_row, _, _, _ = run_sparse_arm(cfg, place, quiet=quiet)
    dense_row, _, _ = run_dense_control(cfg, place, quiet=quiet)
    vect_ab = run_vectorization_ab(cfg, place, quiet=quiet)
    cache_row = run_cache_arm(cfg, quiet=quiet)
    doctor_row = run_doctor_pass(cfg, place, quiet=quiet)
    return {
        "config": {**cfg,
                   "hbm_embedding_budget_mb": HBM_EMBEDDING_BUDGET_MB,
                   "dense_tables_mb": dense_mb,
                   "dense_exceeds_budget":
                       dense_mb > HBM_EMBEDDING_BUDGET_MB},
        "sparse": sparse_row,
        "dense_control": dense_row,
        "sparse_vs_dense_speedup": sparse_row["examples_per_sec"]
        / dense_row["examples_per_sec"],
        "vectorization_ab": vect_ab,
        "cache": cache_row,
        **doctor_row,
        "device": device_label(place),
        "smoke": bool(smoke),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes; writes a results file only with "
                         "--out")
    ap.add_argument("--out", default=None,
                    help="results path (default build/ctr_results.json)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    from ..core import CPUPlace
    row = run_all(smoke=args.smoke,
                  place=CPUPlace() if args.device == "cpu" else None)
    print(json.dumps(row, indent=1))
    write_results(args.out, args.smoke, "ctr_results.json",
                  "ctr_sparse_parameter_server", row)
    return row


if __name__ == "__main__":
    main()
