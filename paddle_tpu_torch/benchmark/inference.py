"""Inference benchmark on the deploy path: the port's counterpart of the
JAX package's ``benchmark/inference.py:43-295``.

    python -m paddle_tpu_torch.benchmark.inference [resnet50] [seq2seq]
        [--server] [--duration-s 4] [--workers 32] [--max-batch 16]
        [--artifact DIR] [--out build/inference_results.json] [--seed 0]

The models are exported as artifacts (``export_compiled_model``: a
``torch.export`` graph with the weights inside and a symbolic batch) and
loaded fresh with ``load_compiled_model``: no Program and no Scope at
serve time.  On the card each batch size is one captured CUDA graph.

* ``resnet50``: ResNet-50 (224x224, 1000 classes, fp32, random weights
  from ``--seed``) at batch 1, 4, 16, 64 and 128, beside the reference's
  published inference rates at batch 1, 4 and 16 (107.8, 182.7 and 217.7
  img/s on 2 x Xeon Gold 6148 with MKL-DNN, the reference's
  ``benchmark/IntelOptimizedPaddle.md`` as the JAX benchmark quotes it).
* ``seq2seq``: beam-4 decoding at the training benchmark's width (vocab
  30000, dim 512, 30 source tokens, 30 generated) at batch 1, 16 and 64;
  tokens/s counts B x 30 a call.
* ``--server``: the ResNet-50 artifact (or ``--artifact``) behind
  ``serving.Server`` under a closed loop of ``--workers`` threads, every
  response checked against a direct call of the artifact.

Timing.  ``per_call_s``: M calls back to back, the last one's fetch read
(the counterpart of ``_time_pipelined``: the host's dispatch overlaps the
device's work).  ``device_step_s``: K replays of the batch's graph
between two CUDA events, nothing copied in or out between them (the
counterpart of ``_time_device_scan``).  Each row is printed as JSON with
the card's name and power limit; the results go to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .bandwidth import card_line
from .serving_common import (closed_loop, export_program,
                             feeds_from_manifest, load_artifact, percentile,
                             single_example)

BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build")
DEFAULT_OUT = os.path.join(BUILD, "inference_results.json")
RESNET_DIR = os.path.join(BUILD, "artifacts", "resnet50")
S2S_DIR = os.path.join(BUILD, "artifacts", "seq2seq_beam4")
RESNET_BATCHES = (1, 4, 16, 64, 128)
S2S_BATCHES = (1, 16, 64)
S2S_VOCAB, S2S_DIM, S2S_LEN, S2S_BEAM = 30000, 512, 30, 4
# img/s of ResNet-50 inference on 2 x Xeon Gold 6148 with MKL-DNN (the
# reference's benchmark/IntelOptimizedPaddle.md)
PUBLISHED_IMG_S = {1: 107.8, 4: 182.7, 16: 217.7}
PUBLISHED_SOURCE = ("2 x Xeon Gold 6148, MKL-DNN (reference "
                    "benchmark/IntelOptimizedPaddle.md)")


def _force(outs):
    """Read the first element of the first output to the host: the call
    has finished on the device."""
    return float(outs[0].reshape(-1)[:1].float().cpu()[0])


def _staged(run, feeds):
    """The feeds as tensors on the artifact's device, staged once."""
    return {k: torch.as_tensor(np.asarray(v)).to(run.device)
            for k, v in feeds.items()}


def time_pipelined(run, feeds, out_count_per_call, windows=5, target_s=2.0):
    """M calls back to back, the last one's fetch read, median of
    ``windows`` (``_time_pipelined``).  The first two calls of a shape
    warm it up and capture its graph; they are not timed."""
    feeds = _staged(run, feeds)
    for _ in range(2):
        _force(run(feeds))
    t0 = time.perf_counter()
    _force(run(feeds))
    per_call_rt = time.perf_counter() - t0
    M = max(10, int(target_s / max(per_call_rt, 1e-4)))
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(M):
            out = run(feeds)
        _force(out)
        times.append((time.perf_counter() - t0) / M)
    med = float(np.median(times))
    return {"per_call_s": med,
            "throughput_per_s": out_count_per_call / med,
            "latency_roundtrip_s": per_call_rt, "calls_per_window": M,
            "spread_pct": 100.0 * (max(times) - min(times)) / med}


def time_device(run, feeds, out_count_per_call, est_call_s, windows=5,
                target_s=1.0):
    """K replays of the batch's graph between two CUDA events, median of
    ``windows`` (``_time_device_scan``'s counterpart)."""
    k = int(np.clip(target_s / max(est_call_s, 1e-5), 8, 20000))
    run.replay(feeds, 1)
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run.replay(feeds, k)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3 / k)
    med = float(np.median(times))
    return {"device_step_s": med,
            "device_throughput_per_s": out_count_per_call / med, "k": k,
            "device_spread_pct": 100.0 * (max(times) - min(times)) / med}


def export_resnet50(dirname=RESNET_DIR, seed=0, device=None):
    """Export the ResNet-50 inference artifact (JAX ``export_resnet50``,
    ``:133-147``): 224x224, 1000 classes, fp32, weights from ``seed``.
    Returns (dirname, export seconds)."""
    from .. import layers, models

    def build():
        img = layers.data("img", shape=[3, 224, 224], dtype="float32")
        return [models.resnet50(img, num_classes=1000)]
    return export_program(dirname, {"img": ((-1, 3, 224, 224), "float32")},
                          build, seed, device)


def export_seq2seq(dirname=S2S_DIR, seed=0, device=None):
    """Export beam-4 seq2seq decoding at the training benchmark's width
    (JAX ``bench_seq2seq_decode``, ``:164-194``).  Returns (dirname,
    export seconds)."""
    from .. import layers, models

    def build():
        src = layers.data("src", shape=[S2S_LEN], dtype="int64")
        return list(models.seq2seq_infer(
            src, src_vocab_size=S2S_VOCAB, tgt_vocab_size=S2S_VOCAB,
            emb_dim=S2S_DIM, hidden_dim=S2S_DIM, beam_size=S2S_BEAM,
            max_len=S2S_LEN))
    return export_program(dirname, {"src": ((-1, S2S_LEN), "int64")},
                          build, seed, device)


def bench_resnet50(batches=RESNET_BATCHES, dirname=RESNET_DIR, seed=0,
                   device_info=None):
    path, export_s = export_resnet50(dirname, seed)
    run, manifest = load_artifact(path)
    rows = {"export_s": export_s}
    rng = np.random.RandomState(0)
    for b in batches:
        feeds = feeds_from_manifest(manifest, b, rng)
        r = time_pipelined(run, feeds, out_count_per_call=b)
        r.update(time_device(run, feeds, b, r["per_call_s"]))
        if b in PUBLISHED_IMG_S:
            r["published_img_s"] = PUBLISHED_IMG_S[b]
            r["published_source"] = PUBLISHED_SOURCE
            r["ratio_to_published"] = r["throughput_per_s"] / \
                PUBLISHED_IMG_S[b]
        rows[f"bs{b}"] = r
        print(json.dumps({"resnet50_infer": f"bs{b}", **r,
                          "device": device_info}), flush=True)
    return rows


def bench_seq2seq_decode(batches=S2S_BATCHES, dirname=S2S_DIR, seed=0,
                         device_info=None):
    path, export_s = export_seq2seq(dirname, seed)
    run, _ = load_artifact(path)
    rows = {"export_s": export_s}
    rng = np.random.RandomState(0)
    for b in batches:
        feeds = {"src": rng.randint(2, S2S_VOCAB, (b, S2S_LEN)).astype(
            "int64")}
        r = time_pipelined(run, feeds, out_count_per_call=b * S2S_LEN)
        rows[f"bs{b}"] = r
        print(json.dumps({"seq2seq_beam4_decode": f"bs{b}", **r,
                          "device": device_info}), flush=True)
    return rows


def check_response(want, rtol=1e-4, atol=1e-5):
    """A closed-loop check: each output of a response within ``rtol`` /
    ``atol`` of ``want`` (one example's outputs from a direct call)."""
    want = [np.asarray(w) for w in want]

    def check(outs):
        for i, (o, w) in enumerate(zip(outs, want)):
            o = np.asarray(o)
            if o.shape != w.shape or not np.allclose(o, w, rtol=rtol,
                                                     atol=atol):
                raise AssertionError(
                    f"response output {i} differs from the direct call "
                    f"(max |diff| {np.abs(o - w).max()})")
    return check


def bench_server(dirname=RESNET_DIR, duration_s=4.0, workers=32,
                 max_batch=16, max_wait_ms=5.0, model_name="resnet50",
                 seed=0, device_info=None):
    """``--server``: the artifact behind ``serving.Server``, every bucket's
    graph captured before the window (a capture inside it would smear into
    p50/p99), a closed loop of ``workers`` threads, every response held
    against a direct call."""
    from ..core.executor import pad_batch
    from ..serving import Model, Server
    from ..serving.server import _buckets

    if not os.path.exists(os.path.join(dirname, "manifest.json")):
        if model_name != "resnet50":
            raise SystemExit(f"--artifact {dirname!r}: no manifest.json")
        export_resnet50(dirname, seed)
    model = Model.from_artifact(dirname, name=model_name)
    example = single_example({"inputs": model.input_specs},
                             np.random.RandomState(0))
    stacked = {k: v[None] for k, v in example.items()}
    direct = [o[0].float().cpu().numpy() for o in model(stacked)]
    # this thread warms up and captures every bucket's graph; the server's
    # dispatcher thread then replays them
    for b in _buckets(max_batch):
        for _ in range(2):
            model(pad_batch(stacked, b))
    srv = Server(max_batch=max_batch, max_wait_ms=max_wait_ms,
                 deadline_ms=None, queue_capacity=max(256, 4 * workers),
                 warmup_buckets=_buckets(max_batch))
    srv.add_model(model)
    srv.start()
    try:
        lat, loop_row = closed_loop(srv, example, workers=workers,
                                    duration_s=duration_s,
                                    check=check_response(direct))
        health = srv.health()["models"][model_name]
    finally:
        srv.shutdown(drain=True)
    lat_ms = [v * 1e3 for v in lat]
    row = {
        "model": model_name, "artifact": dirname,
        "max_batch": max_batch, "max_wait_ms": max_wait_ms, **loop_row,
        "latency_ms_p50": percentile(lat_ms, 0.50),
        "latency_ms_p99": percentile(lat_ms, 0.99),
        "batches": health["batches"],
        "mean_batch": health["served"] / health["batches"]
        if health["batches"] else None,
        "device": device_info,
    }
    print(json.dumps({"server": row}), flush=True)
    if loop_row["worker_errors"]:
        raise RuntimeError(f"--server: {loop_row['worker_errors']} workers "
                           f"failed; first: {loop_row['first_error']}")
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", nargs="*", default=["resnet50", "seq2seq"],
                    help="benches to run (resnet50, seq2seq)")
    ap.add_argument("--server", action="store_true",
                    help="drive the exported artifact through "
                         "serving.Server instead of direct calls")
    ap.add_argument("--duration-s", type=float, default=4.0)
    ap.add_argument("--workers", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--artifact", default=None,
                    help="serve this exported dir instead of ResNet-50 "
                         "(--server only)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("benchmark.inference measures a CUDA card and none "
                         "is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {"name": torch.cuda.get_device_name(0), "card": card_line()}
    results = {"device": info}
    if args.server:
        kw = {}
        if args.artifact:
            kw = {"dirname": args.artifact,
                  "model_name": os.path.basename(
                      os.path.normpath(args.artifact))}
        results["server"] = bench_server(
            duration_s=args.duration_s, workers=args.workers,
            max_batch=args.max_batch, seed=args.seed, device_info=info,
            **kw)
    else:
        if "resnet50" in args.which:
            results["resnet50"] = bench_resnet50(seed=args.seed,
                                                 device_info=info)
        if "seq2seq" in args.which:
            results["seq2seq_beam4"] = bench_seq2seq_decode(
                seed=args.seed, device_info=info)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {args.out}")
    print(info["card"])


if __name__ == "__main__":
    main()
