"""Compile-cache A/B: a cold and a warm start of a training step, each in
a fresh process sharing one cache directory (the port's counterpart of
the JAX package's ``benchmark/compile_cache.py``).

Each arm is a new Python process with ``PADDLE_TPU_TORCH_CACHE_DIR``
pointing at one directory: it builds the model, runs the startup
program, compiles the training step ahead of its first call
(``Executor.compile``) and runs ``--steps`` steps.  The cold arm finds
no entry and stores what its compile learned
(``<dir>/ptxc-<fingerprint>.pkl``: phase times, the capture's launches,
the step listing); the warm arm finds it and builds the step as the
cold arm does.  A CUDA graph cannot be serialized, so a warm start
cannot skip the capture, as the JAX warm start skips trace, lower and
compile, and the nvcc builds persist in ``build/`` for both arms; the
ratio is what it is.

Measured per arm, in the child, on its own clock:

* ``engine_s``: the startup run, the compile and the first step (the
  span the cache can shorten); the headline ratio is ``cold.engine_s /
  warm.engine_s``;
* ``total_s``: the process's spawn (the parent's clock, passed in) to
  the first step done: interpreter start and imports included;
* ``first_step_s`` and ``compile_s``, with the compile's phase times
  (``compile_times``) and the phases of the cold compile the warm arm
  did not run (``skipped``);
* ``steps_digest``: sha256 over every fetch of the ``--steps`` steps;
  cold and warm must be bit-identical;
* ``counters``: ``compile_cache.stats()`` (``disk_hits``,
  ``disk_stores``, ``warmups``, ``captures``, ...).

Models: ``wide_deep`` (CTR embeddings and an MLP; square error on the
sigmoid, as in the port's other wide_deep benchmarks, since the port
has no ``log_loss`` op yet), ``resnet`` (CIFAR ResNet-20), ``lstm``
(embedding, lstm, fc), and ``tiny`` for ``--smoke``.  On a card the
children take cuDNN's deterministic algorithms, so the two arms' digests
compare bit for bit.

    python -m paddle_tpu_torch.benchmark.compile_cache [--smoke]
        [--model wide_deep|resnet|lstm|tiny] [--steps 3]
        [--device cuda|cpu] [--out PATH]

runs on the card by default and writes ``build/compile_cache_results.json``
(``--smoke``: the tiny model only, with its checks, and no file unless
``--out`` is given).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

MODELS = ("wide_deep", "resnet", "lstm")
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# ---------------------------------------------------------------------------
# child: one measured arm in a fresh process
# ---------------------------------------------------------------------------
def build_model(model, rng):
    """(loss, feeds) of one model in the default programs: fixed shapes
    and seeded data, so both arms run the same program on the same
    inputs."""
    import numpy as np

    from .. import layers, models, optimizer

    if model == "wide_deep":
        B, nsparse, vocab, dense_d = 32, 8, 1000, 13
        sparse = [layers.data(f"s{i}", shape=[1], dtype="int64")
                  for i in range(nsparse)]
        dense = layers.data("dense", shape=[dense_d], dtype="float32")
        label = layers.data("label", shape=[1], dtype="float32")
        ctr = models.wide_deep(sparse, dense, [vocab] * nsparse)
        loss = layers.mean(layers.square_error_cost(ctr, label))
        optimizer.Adam(1e-3).minimize(loss)
        feeds = {f"s{i}": rng.randint(0, vocab, (B, 1))
                 for i in range(nsparse)}
        feeds["dense"] = rng.rand(B, dense_d).astype("float32")
        feeds["label"] = rng.randint(0, 2, (B, 1)).astype("float32")
    elif model == "resnet":
        B = 8
        img = layers.data("img", shape=[3, 32, 32], dtype="float32")
        label = layers.data("label", shape=[1], dtype="int64")
        pred = models.resnet_cifar(img, num_classes=10, depth=20)
        loss = layers.mean(layers.cross_entropy(pred, label))
        optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)
        feeds = {"img": rng.rand(B, 3, 32, 32).astype("float32"),
                 "label": rng.randint(0, 10, (B, 1))}
    elif model == "lstm":
        B, T, vocab = 16, 32, 2000
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
    elif model == "tiny":
        B = 8
        x = layers.data("x", shape=[16], dtype="float32")
        y = layers.data("y", shape=[1], dtype="int64")
        pred = layers.fc(layers.fc(x, size=32, act="relu"), size=4,
                         act="softmax")
        loss = layers.mean(layers.cross_entropy(pred, y))
        optimizer.SGD(0.1).minimize(loss)
        feeds = {"x": rng.rand(B, 16).astype("float32"),
                 "y": rng.randint(0, 4, (B, 1))}
    else:
        raise ValueError(f"unknown model {model!r}")
    return loss, feeds


def child_main(model: str, steps: int, device: str, spawned_at=None):
    """One arm: build, startup, compile, ``steps`` train steps; prints ONE
    JSON line.  The cache directory comes from the environment the
    parent set; ``spawned_at`` is the parent's ``time.time()`` just
    before it started this process."""
    t_proc = time.perf_counter()
    wall_proc = time.time()
    import hashlib

    import numpy as np
    import torch

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.core import compile_cache

    t_import = time.perf_counter()
    on_card = device == "cuda"
    if on_card:
        torch.backends.cudnn.deterministic = True
    rng = np.random.RandomState(0)
    loss, feeds = build_model(model, rng)
    t_build = time.perf_counter()
    exe = ptt.Executor(ptt.CUDAPlace(0) if on_card else ptt.CPUPlace())
    exe.run(ptt.default_startup_program(), feed={}, fetch_list=[])
    if on_card:
        torch.cuda.synchronize()
    t_startup = time.perf_counter()
    compiled = exe.compile(feed=feeds, fetch_list=[loss])
    t_compiled = time.perf_counter()
    outs = [compiled.run(feed=feeds)]
    t_first = time.perf_counter()
    wall_first = time.time()
    for _ in range(steps - 1):
        outs.append(compiled.run(feed=feeds))
    digest = hashlib.sha256(
        b"".join(np.ascontiguousarray(o[0]).tobytes() for o in outs)
    ).hexdigest()
    step = compiled.step
    times = compiled.compile_times
    # the cold compile's phases this warm one did not run
    skipped = sorted(set(step.facts.get("cold_times", {})) - set(times))
    print(json.dumps({
        "model": model, "device": str(exe.device),
        "start_s": round(wall_proc - spawned_at, 4)
        if spawned_at is not None else None,
        "import_s": round(t_import - t_proc, 4),
        "build_s": round(t_build - t_import, 4),
        "startup_run_s": round(t_startup - t_build, 4),
        "compile_s": round(t_compiled - t_startup, 4),
        "first_step_s": round(t_first - t_compiled, 4),
        "engine_s": round(t_first - t_build, 4),
        "total_s": round(wall_first - (spawned_at if spawned_at
                                       is not None else wall_proc), 4),
        "source": step.source,
        "compile_times": times,
        "launches": step.facts.get("launches", {}),
        "pool_bytes": step.facts.get("pool_bytes", 0),
        "skipped": skipped,
        "first_loss": float(np.asarray(outs[0][0])),
        "steps_digest": digest,
        "counters": {k: v for k, v in compile_cache.stats().snapshot()
                     .items() if k != "uncaptured"},
    }), flush=True)


# ---------------------------------------------------------------------------
# parent: cold/warm pairs
# ---------------------------------------------------------------------------
def _run_arm(model: str, cache_dir: str, steps: int, device: str) -> dict:
    env = dict(os.environ, PADDLE_TPU_TORCH_CACHE_DIR=cache_dir,
               PYTHONPATH=_ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.benchmark.compile_cache",
         "--child", "--model", model, "--steps", str(steps), "--device",
         device, "--spawned-at", repr(time.time())], capture_output=True,
        text=True, env=env, cwd=_ROOT, timeout=900)
    if r.returncode != 0:
        raise RuntimeError(f"compile_cache child ({model}) failed:\n"
                           f"{r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def run_model(model: str, steps: int = 3, device: str = "cuda",
              cache_dir: str = None, quiet: bool = False) -> dict:
    """One cold/warm pair in a fresh cache directory; the result row."""
    d = cache_dir or tempfile.mkdtemp(prefix=f"ptcc_{model}_")
    owns = cache_dir is None
    try:
        cold = _run_arm(model, d, steps, device)
        warm = _run_arm(model, d, steps, device)
    finally:
        if owns:
            shutil.rmtree(d, ignore_errors=True)
    row = {
        "model": model, "device": cold["device"],
        "cold_engine_s": cold["engine_s"], "warm_engine_s": warm["engine_s"],
        "ratio_engine": round(cold["engine_s"] / warm["engine_s"], 4),
        "cold_total_s": cold["total_s"], "warm_total_s": warm["total_s"],
        "ratio_total": round(cold["total_s"] / warm["total_s"], 4),
        "bit_identical": cold["steps_digest"] == warm["steps_digest"],
        "warm_disk_hits": warm["counters"].get("disk_hits", 0),
        "cold_disk_stores": cold["counters"].get("disk_stores", 0),
        "warm_warmups": warm["counters"].get("warmups", 0),
        "warm_skipped": warm["skipped"],
        "cold": cold, "warm": warm,
    }
    if not quiet:
        print(json.dumps({k: v for k, v in row.items()
                          if k not in ("cold", "warm")}), flush=True)
    return row


def run_smoke(steps: int = 3, device: str = "cpu") -> dict:
    """The tiny model's pair with its checks: the warm arm hit the entry
    the cold arm stored, and the fetches are bit-identical.  Times are
    reported, not checked."""
    row = run_model("tiny", steps=steps, device=device, quiet=True)
    if not row["bit_identical"]:
        raise AssertionError(
            f"warm-run fetches differ from the cold run's: cold "
            f"{row['cold']['steps_digest']} warm {row['warm']['steps_digest']}")
    if row["cold_disk_stores"] < 1 or row["warm_disk_hits"] < 1:
        raise AssertionError(
            f"the warm run did not start from the cold run's entry: cold "
            f"{row['cold']['counters']}, warm {row['warm']['counters']}")
    print(json.dumps({"model": "compile_cache_smoke", "ok": True,
                      "ratio_engine": row["ratio_engine"],
                      "warm_counters": row["warm"]["counters"]}),
          flush=True)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--child", action="store_true",
                    help="internal: run one measured arm in this process")
    ap.add_argument("--model", default=None,
                    help=f"one of {MODELS + ('tiny',)} (default: the "
                         f"three)")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--spawned-at", type=float, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--smoke", action="store_true",
                    help="the tiny model and its checks, seconds")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None,
                    help="results JSON (default build/"
                         "compile_cache_results.json; none with --smoke)")
    args = ap.parse_args(argv)
    if args.child:
        child_main(args.model, args.steps, args.device, args.spawned_at)
        return 0
    if args.smoke:
        row = run_smoke(steps=args.steps, device=args.device)
        rows = [row]
    else:
        models = [args.model] if args.model else list(MODELS)
        rows = [run_model(m, steps=args.steps, device=args.device)
                for m in models]
    out = args.out or (None if args.smoke else os.path.join(
        _ROOT, "build", "compile_cache_results.json"))
    if out:
        from .harness import device_label
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump({
                "benchmark": "compile_cache_cold_vs_warm",
                "device": device_label() if args.device == "cuda" else "cpu",
                "note": "two fresh processes sharing one "
                        "PADDLE_TPU_TORCH_CACHE_DIR; engine_s = startup "
                        "run + compile + first train step",
                "rows": [{k: v for k, v in r.items()
                          if k not in ("cold", "warm")} for r in rows],
                "detail": [{"model": r["model"], "cold": r["cold"],
                            "warm": r["warm"]} for r in rows]}, f, indent=1)
            f.write("\n")
        print(f"# wrote {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
