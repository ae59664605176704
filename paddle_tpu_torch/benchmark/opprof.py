"""The per-op profiler over real training steps (the port's counterpart
of the JAX package's ``benchmark/opprof.py``).

Each row is one ``observability.opprof.profile_program`` report over one
training step, reduced to its facts: the per-op measured table against
the eager-replay total (they must agree within ``opprof.TOLERANCE``),
the top three ops named with their phase and share, and the memory
timeline's peak with its position.  Models (the JAX driver's three,
fixed shapes, seeded feeds):

* ``wide_deep``: the CTR model (8 sparse fields, vocab 1000, batch 64;
  square error on the sigmoid, Adam);
* ``resnet_block``: one CIFAR basic block and a softmax head (batch 16,
  16 x 16 x 16; Momentum);
* ``lstm``: the LSTM text classifier (batch 16, 24 tokens, vocab 2000;
  Adam).

On the card each op's time is a pair of CUDA events around it (median
of ``--reps`` windows after ``--warmup`` discarded ones).  The JAX
benchmark's modeled columns come with each row: the top ops' roofline
verdicts and measured/predicted ratios against the static cost model
(H100 constants), the by-class ranking (``xla_loses_here``), and the
modeled peak beside the measured one.  The merged per-op-class
calibration table (``attribution.save_op_class_calibration``'s format-2
document) rides under ``"calibration"``:
``attribution.load_op_class_ratios`` reads it directly, and
``analysis.planner.plan(op_class_ratios=)`` takes the ratios.

    python -m paddle_tpu_torch.benchmark.opprof [--smoke] [--out PATH]
        [--device cuda|cpu]

prints one JSON line per model and writes ``build/opprof_results.json``
(not with ``--smoke`` unless ``--out`` is given).
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from .harness import device_label, write_results


def build_wide_deep(rng):
    from .. import layers, models, optimizer
    B, nsparse, vocab, dense_d = 64, 8, 1000, 13
    sparse = [layers.data(f"s{i}", shape=[1], dtype="int64")
              for i in range(nsparse)]
    dense = layers.data("dense", shape=[dense_d], dtype="float32")
    label = layers.data("label", shape=[1], dtype="float32")
    ctr = models.wide_deep(sparse, dense, [vocab] * nsparse)
    loss = layers.mean(layers.square_error_cost(ctr, label))
    optimizer.Adam(1e-3).minimize(loss)
    feeds = {f"s{i}": rng.randint(0, vocab, (B, 1)) for i in range(nsparse)}
    feeds["dense"] = rng.rand(B, dense_d).astype("float32")
    feeds["label"] = rng.randint(0, 2, (B, 1)).astype("float32")
    return feeds, B


def build_resnet_block(rng):
    from .. import layers, optimizer
    from ..models.resnet import basic_block
    B = 16
    img = layers.data("img", shape=[16, 16, 16], dtype="float32")
    label = layers.data("label", shape=[1], dtype="int64")
    block = basic_block(img, 16, 16, 1)
    pool = layers.pool2d(block, pool_type="avg", global_pooling=True)
    pred = layers.fc(pool, size=10, act="softmax")
    loss = layers.mean(layers.cross_entropy(pred, label))
    optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)
    feeds = {"img": rng.rand(B, 16, 16, 16).astype("float32"),
             "label": rng.randint(0, 10, (B, 1))}
    return feeds, B


def build_lstm(rng):
    from .. import layers, models, optimizer
    B, T, vocab = 16, 24, 2000
    words = layers.data("words", shape=[], dtype="int64", lod_level=1)
    label = layers.data("label", shape=[1], dtype="int64")
    pred = models.lstm_text_classification(
        words, vocab_size=vocab, num_classes=2, emb_dim=32,
        hidden_size=64, lstm_num=1)
    loss = layers.mean(layers.cross_entropy(pred, label))
    optimizer.Adam(1e-3).minimize(loss)
    feeds = {"words": rng.randint(0, vocab, (B, T)),
             "words@LEN": np.full(B, T, np.int32),
             "label": rng.randint(0, 2, (B, 1))}
    return feeds, B


MODELS = {"wide_deep": build_wide_deep,
          "resnet_block": build_resnet_block,
          "lstm": build_lstm}


def summarize(name, report, batch):
    """One result row from a profile report."""
    total = report["per_op_sum_ms"]
    mem = report["memory"]
    return {
        "model": name, "program": report["program"], "batch": batch,
        "reps": report["reps"], "warmup": report["warmup"],
        "ops": report["ops"],
        "eager_total_ms": report["eager_total_ms"],
        "per_op_sum_ms": total,
        "sum_gap_frac": report["sum_gap_frac"],
        "tolerance": report["tolerance"],
        "within_tolerance": report["within_tolerance"],
        "top3": [top_row(r, total) for r in report["top"][:3]],
        "xla_loses_here": report["xla_loses_here"][:5],
        "memory": {k: mem[k] for k in
                   ("state_bytes", "peak_bytes", "peak_index", "peak_op",
                    "modeled_peak_bytes", "peak_ratio") if k in mem},
    }


def top_row(r, total):
    """A top op: its measured time and share, and the modeled verdict."""
    out = {"op_type": r["op_type"], "index": r["index"],
           "phase": r["phase"], "wall_ms": r["wall_ms"],
           "share": r["wall_ms"] / total if total else 0.0}
    m = r.get("modeled")
    if m:
        out["roofline"] = m["roofline"]
        out["ratio"] = r.get("ratio")
    return out


def profile_model(name, *, reps, warmup, place=None):
    from .. import core, unique_name
    from ..observability import opprof
    core.reset_default_programs()
    core.reset_global_scope()
    unique_name.reset()
    feeds, batch = MODELS[name](np.random.RandomState(7))
    exe = core.Executor(place)
    exe.run(core.default_startup_program())
    report = opprof.profile_program(
        core.default_main_program(), executor=exe, feed=feeds,
        batch=batch, reps=reps, warmup=warmup, modeled=True)
    return summarize(name, report, batch), report["op_classes"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="reps=1/warmup=1; writes only with --out")
    ap.add_argument("--reps", type=int, default=5,
                    help="timed windows per op (median; default 5)")
    ap.add_argument("--warmup", type=int, default=2,
                    help="discarded windows per op (default 2)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None,
                    help="results path (default build/opprof_results.json)")
    args = ap.parse_args(argv)
    from ..core import CPUPlace, CUDAPlace
    place = CPUPlace() if args.device == "cpu" else CUDAPlace(0)
    reps, warmup = (1, 1) if args.smoke else (args.reps, args.warmup)
    rows, op_classes = [], {}
    for name in MODELS:
        row, classes = profile_model(name, reps=reps, warmup=warmup,
                                     place=place)
        rows.append(row)
        print(json.dumps(row), flush=True)
        for c in classes:
            op_classes[f"{c['program']}:{c['op_type']}"] = c
    doc = {"rows": rows, "device": device_label(place),
           "calibration": {"format": 2, "programs": {},
                           "op_classes": op_classes}}
    write_results(args.out, args.smoke, "opprof_results.json",
                  "opprof_per_op_profile", doc)
    return doc


if __name__ == "__main__":
    main()
