"""Input-pipeline A/B on a CUDA card: the naive synchronous
``trainer.SGD.train`` loop against the pipelined one (``pipeline=`` ->
``Executor.run_pipelined``), on the ``wide_deep`` workload of the JAX
package's ``benchmark/input_pipeline.py`` (``bench.py``'s
``input_pipeline_wide_deep_train_steps_per_sec``).

``wide_deep``: Criteo-shaped CTR lines ``label,dense...,field:value...``
decoded by split, float parsing and feature hashing into 26 sparse ids
and 13 dense floats (``models.wide_deep``, vocab 1000, emb 8, deep
(32, 16), batch 256, ``SGD(0.05)``), re-decoded on every pass: the decode
is the host work the pipeline overlaps with the device's steps.

Each measurement is a window of ``batches`` training steps, one pass of
``trainer.SGD.train``; the arms alternate naive / pipelined windows
``reps`` times, and the headline speedup is the median of the per-pair
ratios, with each arm's median steps/s and its (max - min) / median
spread.  One warm-up pass of each arm (kernel builds, captures) precedes
the timed ones.

    python -m paddle_tpu_torch.benchmark.input_pipeline [--smoke]
        [--reps N] [--out build/input_pipeline_results.json]

runs on the card; ``run_workload(place=CPUPlace())`` runs it here.
After the timed pairs one extra pipelined pass runs observed into a JSONL
log: the row's ``doctor`` is its step budget
(``attribution.step_budget``: compute, fetch, compile, staging, host
gaps) and ``calibration`` the static cost model's predicted step
against the measured one (``attribution.calibration_row``).  The ``lstm``
workload is not ported.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

NF_DENSE, NF_SPARSE = 13, 26

WORKLOADS = {
    "wide_deep": {
        "full": {"vocab": 1000, "emb": 8, "batch": 256, "batches": 60,
                 "reps": 8, "pipeline": {"steps_per_dispatch": 10,
                                         "num_workers": 1}},
        "smoke": {"vocab": 100, "emb": 8, "batch": 32, "batches": 6,
                  "reps": 1, "pipeline": {"steps_per_dispatch": 3,
                                          "num_workers": 1}},
    },
}


# ---------------------------------------------------------------------------
# synthetic raw data + decoder (the host-side work)
# ---------------------------------------------------------------------------
def make_ctr_lines(n, seed=0):
    """Criteo-shaped raw lines: 'label,i1 .. i13,f0:v f1:v ..' with the
    dense slots carrying raw integer counts, about 45% of them missing,
    and about 25% of the categorical field:value tokens absent."""
    r = np.random.RandomState(seed)
    lines = []
    for _ in range(n):
        label = r.randint(0, 2)
        dense = " ".join("" if r.rand() < 0.45 else "%d"
                         % r.randint(0, 65536) for _ in range(NF_DENSE))
        sparse = " ".join("f%d:%d" % (f, r.randint(0, 100000))
                          for f in range(NF_SPARSE) if r.rand() > 0.25)
        lines.append("%d,%s,%s" % (label, dense, sparse))
    return lines


def make_ctr_decoder(vocab):
    from math import log1p
    from zlib import crc32

    def decode(line):
        # log1p of the integer dense features (missing -> 0); the
        # categorical field:value tokens feature-hashed (crc32, which is
        # the same in every process) into per-field ids (absent -> 0)
        lab, dense_s, sparse_s = line.split(",")
        dense = np.array([log1p(float(t)) if t else 0.0
                          for t in dense_s.split(" ")], np.float32)
        ids = [0] * NF_SPARSE
        for kv in sparse_s.split():
            f, _ = kv.split(":")
            ids[int(f[1:])] = crc32(kv.encode()) % vocab
        return tuple(ids) + (dense, np.float32(int(lab)))
    return decode


# ---------------------------------------------------------------------------
# the workload
# ---------------------------------------------------------------------------
def build_wide_deep(cfg, place=None, update_equation=None):
    """(trainer, feed_list) of the wide_deep workload in the default
    programs: square error on the sigmoid prediction, plain SGD(0.05)
    unless ``update_equation`` names another optimizer."""
    from .. import layers, models, optimizer, trainer
    sparse = [layers.data("s%d" % i, shape=[1], dtype="int64")
              for i in range(NF_SPARSE)]
    dense = layers.data("dense", shape=[NF_DENSE], dtype="float32")
    label = layers.data("label", shape=[1], dtype="float32")
    pred = models.wide_deep(sparse, dense, [cfg["vocab"]] * NF_SPARSE,
                            emb_dim=cfg["emb"], deep_hidden=(32, 16))
    cost = layers.mean(layers.square_error_cost(pred, label))
    sgd = trainer.SGD(cost, update_equation=update_equation
                      or optimizer.SGD(learning_rate=0.05), place=place)
    return sgd, sparse + [dense, label]


def make_reader(cfg, seed=0):
    """Zero-arg batched reader that decodes the raw lines again on every
    pass."""
    from .. import reader as rd
    lines = make_ctr_lines(cfg["batch"] * cfg["batches"], seed)
    decode = make_ctr_decoder(cfg["vocab"])
    return rd.batch(rd.map_readers(decode, lambda: iter(lines)),
                    cfg["batch"], drop_last=True)


def fresh_programs():
    from .. import core, unique_name
    core.reset_default_programs()
    core.reset_global_scope()
    unique_name.reset()


def _steps_delta(before, after):
    """The executor's captured-step counters between two snapshots."""
    out = {k: after[k] - before[k] for k in after if k != "uncaptured"}
    out["uncaptured"] = {k: v - before["uncaptured"].get(k, 0)
                         for k, v in after["uncaptured"].items()
                         if v != before["uncaptured"].get(k, 0)}
    return out


def run_workload(smoke=False, reps=None, place=None, quiet=False,
                 window=None, seed=0):
    """The paired A/B.  Returns its row: each arm's median steps/s and
    spread, the median per-pair speedup and its spread, the pairs, the
    losses' finiteness, and the executor's captured-step counters over
    every pass (``steps_by_path``: replays, captures, steps run
    uncaptured by reason).  ``window(one_pass, pipe_cfg)``, if given, is called once
    after the timed pairs (a profiled pass, say).  ``seed`` draws the
    weights and the raw lines."""
    from ..core import compile_cache
    from ..core.program import default_startup_program
    cfg = dict(WORKLOADS["wide_deep"]["smoke" if smoke else "full"])
    if reps is not None:
        cfg["reps"] = int(reps)
    fresh_programs()
    default_startup_program().random_seed = seed
    sgd, feed_list = build_wide_deep(cfg, place)
    sgd.exe.run(default_startup_program(), feed={}, fetch_list=[])
    sgd._initialized = True
    before = compile_cache.stats().snapshot()
    reader = make_reader(cfg, seed)
    losses = []

    def handler(e):
        from ..trainer import events
        if isinstance(e, events.EndIteration):
            losses.append(e.cost)

    def one_pass(pipeline):
        t0 = time.perf_counter()
        sgd.train(reader, num_passes=1, event_handler=handler,
                  feed_list=feed_list, pipeline=pipeline)
        return cfg["batches"] / (time.perf_counter() - t0)

    pipe_cfg = dict(cfg["pipeline"])
    one_pass(False)                  # warm-up: builds and captures
    one_pass(pipe_cfg)
    naive, pipelined = [], []
    for _ in range(cfg["reps"]):
        naive.append(one_pass(False))
        pipelined.append(one_pass(pipe_cfg))
    if window is not None:
        window(one_pass, pipe_cfg)
    steps = _steps_delta(before, compile_cache.stats().snapshot())

    def stats(xs):
        med = statistics.median(xs)
        return med, (max(xs) - min(xs)) / med if len(xs) > 1 else 0.0

    ratios = [p / n for n, p in zip(naive, pipelined)]
    n_med, n_spread = stats(naive)
    p_med, p_spread = stats(pipelined)
    r_med, r_spread = stats(ratios)
    row = {
        "workload": "wide_deep",
        "batch": cfg["batch"],
        "batches_per_window": cfg["batches"],
        "reps": cfg["reps"],
        "pipeline_config": pipe_cfg,
        "naive_steps_per_s": n_med,
        "naive_spread": n_spread,
        "pipelined_steps_per_s": p_med,
        "pipelined_spread": p_spread,
        "speedup": r_med,
        "speedup_spread": r_spread,
        "speedup_pairs": ratios,
        "naive_windows": naive,
        "pipelined_windows": pipelined,
        "losses_finite": bool(np.isfinite(losses).all()),
        "steps": len(losses),
        "steps_by_path": steps,
        "smoke": smoke,
    }
    if not row["losses_finite"]:
        raise RuntimeError("input_pipeline: non-finite training loss")
    row.update(_doctor_pass(one_pass, pipe_cfg, cfg))
    if not quiet:
        print(json.dumps(row), flush=True)
    return row


def _doctor_pass(one_pass, pipe_cfg, cfg):
    """One extra pipelined pass, observed into a fresh JSONL log, after
    the timed windows (its instrumentation never touches the A/B)."""
    from ..core.program import default_main_program
    from ..observability import attribution
    from .harness import observed
    with observed("input_pipeline") as log:
        one_pass(pipe_cfg)
    report = attribution.doctor_report([log],
                                       program=default_main_program(),
                                       assume_batch=cfg["batch"])
    return {"doctor": report.get("training"),
            "calibration": report.get("calibration")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes, one pair")
    ap.add_argument("--reps", type=int, default=None,
                    help="timed pairs (default 8, bench.py takes 4)")
    ap.add_argument("--out", default=None,
                    help="results path (default build/"
                         "input_pipeline_results.json; --smoke writes "
                         "only when given)")
    args = ap.parse_args(argv)
    row = run_workload(smoke=args.smoke, reps=args.reps)
    out = args.out or (None if args.smoke else os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "build",
        "input_pipeline_results.json"))
    if out:
        import torch
        os.makedirs(os.path.dirname(out), exist_ok=True)
        doc = {"description": "naive trainer.SGD.train loop vs pipeline= "
                              "(Executor.run_pipelined): training steps/s, "
                              "median of paired windows",
               "device": torch.cuda.get_device_name(0),
               "cpu_count": os.cpu_count(), "rows": [row]}
        with open(out, "w") as f:
            json.dump(doc, f, indent=1)
        print(f"# wrote {out}", file=sys.stderr)
    return row


if __name__ == "__main__":
    main()
