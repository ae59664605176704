"""The model-zoo benchmark on a CUDA card: the port's counterpart of the
JAX package's ``benchmark/run.py`` (the reference's
benchmark/paddle/image/run.sh and benchmark/paddle/rnn/run.sh configs,
plus seq2seq tokens/s).

    python -m paddle_tpu_torch.benchmark.run --model alexnet --batch 128
    python -m paddle_tpu_torch.benchmark.run --all    # every HEADLINE config

Each config trains with the JAX runner's recipe: mean cross entropy,
Momentum(0.01 / batch, 0.9) for the image models, Adam(2e-3) for the
LSTM text classifier, Adam(1e-3) for seq2seq, ``Executor(amp=True)`` by
default; weights from ``--seed``, data from ``np.random.RandomState(0)``.
A window is one ``run_steps`` of 60 steps (the large CNNs) or 300 (the
rest), each step a replay of the captured step; one untimed window, then
the median of ``reps`` timed ones.  One JSON line per config:

    {"model", "batch", "ms_per_batch", "throughput", "unit", "ref",
     "ref_source", "amp", "speedup", "window_spread", "device", ...}

``ref`` is the upstream reference's published figure for the config
(``BASELINE.md``: a Tesla K40m or a 2-socket Xeon Gold 6148 with
MKL-DNN, as ``ref_source`` says) in the same unit, or null; no figure
here is a TPU one.  ``--device cpu`` runs on the CPU (tiny sizes are
``run_config(sizes=...)``'s business).  ``--model input_pipeline`` runs
``benchmark.input_pipeline``, and ``ctr``, ``decode``, ``pserver`` and
``checkpoint`` run the port's runner of that name (``--smoke`` for their
tiny sizes); the JAX runner's ``compile_cache`` and ``autotune``
delegates are not ported.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np

# upstream figures (BASELINE.md): config -> ms a batch on one Tesla K40m
# (benchmark/README.md of the reference)
REF_MS = {
    ("alexnet", 64): 195.0, ("alexnet", 128): 334.0,
    ("alexnet", 256): 602.0, ("alexnet", 512): 1629.0,
    ("googlenet", 64): 613.0, ("googlenet", 128): 1149.0,
    ("googlenet", 256): 2348.0,
    ("smallnet", 64): 10.463,
    ("lstm_h256", 64): 83.0, ("lstm_h512", 64): 184.0,
    ("lstm_h1280", 64): 641.0, ("lstm_h512", 128): 261.0,
    ("lstm_h512", 256): 414.0,
}
# img/s on 2 x Xeon Gold 6148 with MKL-DNN (IntelOptimizedPaddle.md of the
# reference)
REF_IMG_S = {("resnet50", 64): 81.69, ("resnet50", 128): 82.35,
             ("vgg19", 64): 28.46, ("vgg19", 128): 29.83}
REF_SOURCE = {
    "ms": "Tesla K40m, cuDNN 5.1 (reference benchmark/README.md; "
          "BASELINE.md)",
    "img_s": "2 x Xeon Gold 6148, MKL-DNN (reference "
             "benchmark/IntelOptimizedPaddle.md; BASELINE.md)",
}

HEADLINE = [("alexnet", 128), ("googlenet", 128), ("smallnet", 64),
            ("resnet50", 64), ("vgg19", 64),
            ("lstm_h512", 64), ("lstm_h512", 128), ("seq2seq", 64)]
LARGE_CNNS = ("alexnet", "googlenet", "resnet50", "vgg19")

# delegates of the JAX runner that wait for their modules
NOT_PORTED = {
    "compile_cache": "ROADMAP Queue A item 6 (the disk layer of "
                     "core/compile_cache.py)",
    "autotune": "ROADMAP Queue A item 9d (tuning/)",
}


def _build_image(model, batch, size=None, num_classes=None):
    """``benchmark/run.py:45-64``: the image model on ``size`` x ``size``
    (224, smallnet 32), mean cross entropy, Momentum(0.01 / batch, 0.9)."""
    from .. import layers, models, optimizer
    size = size or {"alexnet": 224, "googlenet": 224, "resnet50": 224,
                    "vgg19": 224, "smallnet": 32}[model]
    num_classes = num_classes or (10 if model == "smallnet" else 1000)
    img = layers.data("img", shape=[3, size, size], dtype="float32")
    label = layers.data("label", shape=[1], dtype="int64")
    if model == "smallnet":
        pred = models.vgg_cifar(img, num_classes)
    else:
        pred = getattr(models, model)(img, num_classes)
    loss = layers.mean(layers.cross_entropy(pred, label))
    optimizer.Momentum(learning_rate=0.01 / batch, momentum=0.9) \
        .minimize(loss)
    rng = np.random.RandomState(0)
    feeds = {"img": rng.rand(batch, 3, size, size).astype("float32"),
             "label": rng.randint(0, num_classes, (batch, 1))}
    return loss, feeds, batch


def _build_lstm(hidden, batch, seq_len=100, vocab=30000, emb=128,
                lstm_num=2):
    """``benchmark/run.py:67-85`` (the reference's rnn.py): embedding, N
    stacked LSTMs, the last step, a 2-way softmax; Adam(2e-3)."""
    from .. import layers, models, optimizer
    words = layers.data("words", shape=[], dtype="int64", lod_level=1)
    label = layers.data("label", shape=[1], dtype="int64")
    pred = models.lstm_text_classification(
        words, vocab_size=vocab, num_classes=2, emb_dim=emb,
        hidden_size=hidden, lstm_num=lstm_num)
    loss = layers.mean(layers.cross_entropy(pred, label))
    optimizer.Adam(2e-3).minimize(loss)
    rng = np.random.RandomState(0)
    feeds = {"words": rng.randint(0, vocab, (batch, seq_len)),
             "words@LEN": np.full(batch, seq_len),
             "label": rng.randint(0, 2, (batch, 1))}
    return loss, feeds, batch


def _build_seq2seq(batch, src_len=30, tgt_len=30, vocab=30000, dim=512):
    """``benchmark/run.py:88-112``: seq2seq with attention, Adam(1e-3);
    a batch counts batch x (src_len + tgt_len) tokens."""
    from .. import layers, models, optimizer
    src = layers.data("src", shape=[], dtype="int64", lod_level=1)
    tgt = layers.data("tgt", shape=[], dtype="int64", lod_level=1)
    lbl = layers.data("lbl", shape=[], dtype="int64", lod_level=1)
    probs = models.seq2seq_attention(src, tgt, vocab, vocab, emb_dim=dim,
                                     hidden_dim=dim)
    flat = layers.reshape(probs, [-1, vocab])
    loss = layers.mean(layers.cross_entropy(
        flat, layers.reshape(lbl, [-1, 1])))
    optimizer.Adam(1e-3).minimize(loss)
    rng = np.random.RandomState(0)
    feeds = {"src": rng.randint(0, vocab, (batch, src_len)),
             "src@LEN": np.full(batch, src_len),
             "tgt": rng.randint(0, vocab, (batch, tgt_len)),
             "tgt@LEN": np.full(batch, tgt_len),
             "lbl": rng.randint(0, vocab, (batch, tgt_len)),
             "lbl@LEN": np.full(batch, tgt_len)}
    return loss, feeds, batch * (src_len + tgt_len)


def build_config(name, batch, sizes=None, seed=0):
    """The config's training program in fresh default programs, its
    startup seeded with ``seed``.  ``sizes``: keyword overrides of the
    builder (``size``/``num_classes``; ``hidden``, ``seq_len``,
    ``vocab``, ``emb``, ``lstm_num``; ``src_len``, ``tgt_len``,
    ``vocab``, ``dim``).  Returns (main, startup, loss, host feeds,
    units a batch, unit)."""
    from .. import core, unique_name
    core.reset_default_programs()
    core.reset_global_scope()
    unique_name.reset()
    sizes = dict(sizes or {})
    startup = core.default_startup_program()
    startup.random_seed = seed
    if name.startswith("lstm_h"):
        hidden = sizes.pop("hidden", int(name[len("lstm_h"):]))
        loss, feeds, units = _build_lstm(hidden, batch, **sizes)
        unit = "samples/s"
    elif name == "seq2seq":
        loss, feeds, units = _build_seq2seq(batch, **sizes)
        unit = "tokens/s"
    else:
        loss, feeds, units = _build_image(name, batch, **sizes)
        unit = "img/s"
    return (core.default_main_program(), startup, loss, feeds, units,
            unit)


def reference(name, batch, units):
    """(the upstream figure in the config's unit, its source), or (None,
    None)."""
    if (name, batch) in REF_IMG_S:
        return REF_IMG_S[(name, batch)], REF_SOURCE["img_s"]
    if (name, batch) in REF_MS:
        return units / (REF_MS[(name, batch)] / 1e3), REF_SOURCE["ms"]
    return None, None


def run_config(name, batch, amp=True, iters=None, reps=3,
               conv1x1_pallas=None, device="cuda", use_jit=True,
               sizes=None, seed=0, window=None, quiet=False):
    """Train config ``name`` at ``batch`` and time it as the JAX runner
    does (``benchmark/run.py:115-168``).  ``window(step)``, if given, is
    called after the timed windows with a function that runs one more
    step (a profiled step, say).  Prints and returns the JSON row; on a
    card it also holds the peak allocated memory over the run and the
    captured steps' graph-pool bytes."""
    import torch

    from .. import core
    main, startup, loss, feeds, units, unit = build_config(
        name, batch, sizes, seed)
    on_card = device != "cpu"
    exe = core.Executor(core.CUDAPlace(0) if on_card else core.CPUPlace(),
                        amp=amp, conv1x1_pallas=conv1x1_pallas,
                        use_jit=use_jit)
    scope = core.global_scope()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    exe.run(startup, scope=scope)
    gb = main.global_block()
    feeds = {k: exe._feed_tensor(gb, k, v) for k, v in feeds.items()}
    if iters is None:
        iters = 60 if name in LARGE_CNNS else 300

    def window_of(k):
        (lv,) = exe.run_steps(k, main, feed=feeds, fetch_list=[loss],
                              scope=scope, return_numpy=False)
        last = float(lv[-1])              # waits for the window's steps
        if not np.isfinite(last):
            raise RuntimeError(f"benchmark.run: {name} batch {batch}: "
                               f"non-finite loss {last}")
        return last

    window_of(iters)                      # untimed: warm-up and capture
    rates = []
    for _ in range(reps):
        t0 = time.perf_counter()
        window_of(iters)
        rates.append(units * iters / (time.perf_counter() - t0))
    if window is not None:
        window(lambda: window_of(1))
    thr = statistics.median(rates)
    ref, ref_source = reference(name, batch, units)
    row = {"model": name, "batch": batch,
           "ms_per_batch": units / thr * 1e3,
           "throughput": thr, "unit": unit,
           "ref": ref, "ref_source": ref_source, "amp": amp,
           "speedup": thr / ref if ref else None,
           "window_spread": (max(rates) - min(rates)) / thr,
           "iters": iters, "reps": reps, "use_jit": use_jit,
           "device": torch.cuda.get_device_name(0) if on_card else "cpu"}
    if on_card:
        ids = set(exe.graph_pools())
        row["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
        row["graph_pool_bytes"] = sum(
            seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ())) in ids)
    exe.close()
    if not quiet:
        print(json.dumps(row), flush=True)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default=None,
                    help="model config (alexnet, googlenet, smallnet, "
                         "resnet50, vgg19, lstm_h<hidden>, seq2seq), or "
                         "'input_pipeline' for the naive-vs-pipelined "
                         "wide_deep A/B, or a runner: ctr, decode, "
                         "pserver, checkpoint")
    ap.add_argument("--smoke", action="store_true",
                    help="input_pipeline, ctr, decode, pserver and "
                         "checkpoint only: tiny sizes")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=None,
                    help="steps per timed window (default: 60 for the "
                         "large CNNs, 300 otherwise)")
    ap.add_argument("--amp", action="store_true", default=True)
    ap.add_argument("--no-amp", dest="amp", action="store_false")
    ap.add_argument("--conv1x1-pallas", dest="conv1x1_pallas",
                    action="store_true", default=None,
                    help="route eligible 1x1 convs to the hand-written "
                         "kernel (the port's default)")
    ap.add_argument("--no-conv1x1-pallas", dest="conv1x1_pallas",
                    action="store_false")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)
    if args.model in NOT_PORTED:
        raise NotImplementedError(
            f"benchmark.run --model {args.model} is not ported yet: "
            f"{NOT_PORTED[args.model]}")
    smoke = ["--smoke"] if args.smoke else []
    if args.model == "ctr":
        from .ctr import main as ctr_main
        ctr_main(smoke + ["--device", args.device])
        return 0
    if args.model == "decode":
        from .decode import main as decode_main
        decode_main(smoke + ["--device", args.device])
        return 0
    if args.model == "pserver":
        from .pserver import main as pserver_main
        pserver_main(smoke)
        return 0
    if args.model == "checkpoint":
        from .checkpoint import main as checkpoint_main
        checkpoint_main(smoke)
        return 0
    if args.model == "input_pipeline":
        from .input_pipeline import run_workload
        from ..core import CPUPlace
        run_workload(smoke=args.smoke,
                     place=CPUPlace() if args.device == "cpu" else None)
        return 0
    if not args.all:
        if args.model is None:
            ap.error("give --model or --all")
        run_config(args.model, args.batch, amp=args.amp, iters=args.iters,
                   conv1x1_pallas=args.conv1x1_pallas,
                   device=args.device, seed=args.seed)
        return 0
    failed = 0
    for name, batch in HEADLINE:
        try:
            run_config(name, batch, amp=args.amp, iters=args.iters,
                       conv1x1_pallas=args.conv1x1_pallas,
                       device=args.device, seed=args.seed)
        except Exception as e:     # report the config and go on to the next
            failed += 1
            print(json.dumps({"model": name, "batch": batch,
                              "error": f"{type(e).__name__}: "
                                       f"{str(e)[:200]}"}), flush=True)
        finally:
            if args.device != "cpu":
                import torch
                torch.cuda.empty_cache()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
