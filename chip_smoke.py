#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises on failure (so the script exits non-zero):

1. device  — requires a CUDA card; prints its name and power limit.
2. build   — compiles every kernel of the served path from the sources
             in this checkout (nvcc, sm_90a) and prints the build time.
3. kernels — holds each kernel against its plain PyTorch version on the
             card, at every shape the served path gives it, in fp32 (TF32
             off) and bf16, and times kernel, plain version, the library
             call (torch.matmul, a yardstick the port never calls) and the
             card's bound.
4. slice   — builds full-width ResNet-50 (224x224, 1000 classes, random
             weights from --seed) with the port's layers, serves >= 64
             single-image requests through serving.Server (bf16 inference
             AMP, 1x1 convs on the kernel), checks every response, checks
             that the kernel's launch count rose by the routing gate's
             count per dispatched batch, and compares the served rows with
             a direct Executor.run on the plain path (bf16, and once in
             fp32 with TF32 off).

Before the last line it prints one JSON line describing each kernel, and
the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# Peak rates of one H100 SXM (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of its operations over the peak of their type and
# its bytes (each input read once, each output written once) over HBM.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12          # CUDA cores; TF32 is off for fp32 here
PEAK_HBM_BYTES = 3.35e12

# Tolerances, kernel vs plain version on identical inputs.  fp32: both
# accumulate exact fp32 products, only the summation order differs.
# bf16: both accumulate in fp32 and round once to bf16, so they may
# differ by an ulp of the output (2^-8 relative) where the fp32 sums
# straddle a rounding boundary.
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=1.6e-2, atol=1e-2)}
# Served rows vs a direct run on the plain path (cuDNN/cuBLAS instead of
# the kernel) through all 50 layers: bf16 rounds every layer's output, so
# the two drift by a few bf16 ulps; fp32 (TF32 off) differs only in
# summation order.  With random weights the softmax is near uniform, so
# the logits (the softmax input) are compared too, as max |diff| over
# max |logit|.
SLICE_TOL = {"bf16": dict(rtol=5e-2, atol=2e-3),
             "fp32": dict(rtol=1e-3, atol=1e-6)}
LOGIT_TOL = {"bf16": 5e-2, "fp32": 1e-4}
SUM_TOL_BF16 = 1e-2            # |sum(softmax row) - 1| for bf16 outputs

BATCH = 32
N_REQUESTS = 96
N_CLIENTS = 4


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters=20, warmup=3) -> float:
    """Mean device time of one call, CUDA events around back-to-back
    launches (L2 not flushed)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(P, C, M, dtype):
    """(bound in ms, "bytes" or "operations") of out[P,M] = x[P,C] @ w^T."""
    size = 2 if dtype == torch.bfloat16 else 4
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_ops = 2.0 * P * C * M / peak
    t_bytes = (P * C + M * C + P * M) * size / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                        else "bytes")


# ---------------------------------------------------------------------------
def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        sys.exit(2)
    card = card_line()
    print(f"[device] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; count {torch.cuda.device_count()}")
    return card


def phase_build():
    from paddle_tpu_torch.ops import conv1x1
    t0 = time.perf_counter()
    path = conv1x1.build()
    conv1x1._library()
    print(f"[build] conv1x1_mm.cu (nvcc sm_90a) "
          f"{time.perf_counter() - t0:.2f} s")
    entry = None
    with open(path + ".ptxas.txt") as fh:
        for line in fh:
            m = re.search(r"(mm_bf16_wmma|mm_f32_simt)ILb(\d)ELb(\d)E", line)
            if "Compiling entry" in line and m:
                entry = f"{m.group(1)}<ta={m.group(2)},tb={m.group(3)}>"
            elif "Used" in line and entry:
                print(f"[build] {entry}: {line.split(':', 1)[1].strip()}")


def eligible_1x1_shapes(program, batch):
    """(P, C, M) of every conv2d in ``program`` that the routing gate
    sends to the kernel at this batch size, in program order."""
    from paddle_tpu_torch.ops.conv1x1 import conv1x1_eligible
    gb = program.global_block()
    shapes = []
    for op in gb.ops:
        if op.type != "conv2d" or op.attrs.get("use_pallas") is False:
            continue
        x = gb.var(op.input("Input")[0])
        w = gb.var(op.input("Filter")[0])
        xs = (batch,) + tuple(x.shape[1:])
        st = tuple(op.attrs["strides"])
        if conv1x1_eligible(xs, w.shape, st, tuple(op.attrs["paddings"]),
                            tuple(op.attrs["dilations"]),
                            op.attrs["groups"]):
            P = batch * ((xs[2] - 1) // st[0] + 1) * ((xs[3] - 1) // st[1] + 1)
            shapes.append((P, xs[1], w.shape[0]))
    return shapes


def phase_kernels(shapes, seed):
    """Kernel vs plain version at every served shape; returns per-dtype
    {shape: {...}} rows."""
    from paddle_tpu_torch.ops import conv1x1
    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        for (P, C, M) in sorted(set(shapes)):
            a = torch.randn(P, C, device="cuda", generator=g).to(dtype)
            w = (torch.randn(M, C, device="cuda", generator=g)
                 / C ** 0.5).to(dtype)
            out = conv1x1.mm(a, w, False, True)
            ref = conv1x1.mm_reference(a, w, False, True)
            torch.cuda.synchronize()
            torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
            err = (out.float() - ref.float()).abs().max().item()
            k_ms = time_ms(lambda: conv1x1.mm(a, w, False, True))
            p_ms = time_ms(lambda: conv1x1.mm_reference(a, w, False, True))
            l_ms = time_ms(lambda: torch.matmul(a, w.t()))
            b_ms, b_by = bound_ms(P, C, M, dtype)
            rows[(dtype, (P, C, M))] = dict(err=err, ms=k_ms, plain_ms=p_ms,
                                            library_ms=l_ms, bound_ms=b_ms,
                                            bound_by=b_by)
            print(f"[kernels] {str(dtype)[6:]:8s} P={P:6d} C={C:4d} M={M:4d} "
                  f"max_abs_err={err:.3e} kernel={k_ms:.4f} ms "
                  f"matmul={l_ms:.4f} ms plain={p_ms:.4f} ms "
                  f"bound={b_ms:.4f} ms ({b_by}) "
                  f"bound/kernel={b_ms / k_ms:.3f}")
            del a, w, out, ref
    # all four transpose variants on one served shape
    P, C, M = sorted(set(shapes))[0]
    for dtype in (torch.float32, torch.bfloat16):
        a = torch.randn(P, C, device="cuda", generator=g).to(dtype)
        b = (torch.randn(C, M, device="cuda", generator=g)
             / C ** 0.5).to(dtype)
        for ta in (False, True):
            for tb in (False, True):
                aa = a.t().contiguous() if ta else a
                bb = b.t().contiguous() if tb else b
                out = conv1x1.mm(aa, bb, ta, tb)
                ref = conv1x1.mm_reference(aa, bb, ta, tb)
                torch.cuda.synchronize()
                torch.testing.assert_close(out.float(), ref.float(),
                                           **TOL[dtype])
                print(f"[kernels] {str(dtype)[6:]:8s} ta={int(ta)} "
                      f"tb={int(tb)} P={P} C={C} M={M} max_abs_err="
                      f"{(out.float() - ref.float()).abs().max().item():.3e}")
    # the 1x1 convolution wrapper against its plain version, stride 1 and 2
    for stride in (1, 2):
        x = torch.randn(BATCH, 256, 56, 56, device="cuda",
                        generator=g).to(torch.bfloat16)
        w = (torch.randn(512, 256, 1, 1, device="cuda", generator=g)
             / 16).to(torch.bfloat16)
        out = conv1x1.conv2d_1x1(x, w, (stride, stride))
        ref = conv1x1.conv2d_1x1_reference(x, w, (stride, stride))
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(),
                                   **TOL[torch.bfloat16])
        print(f"[kernels] conv2d_1x1 stride {stride} bf16 {tuple(x.shape)} "
              f"-> {tuple(out.shape)} ok")
    return rows


def build_resnet50(seed):
    import paddle_tpu_torch as ptt
    ptt.unique_name.reset()
    main, startup = ptt.Program(), ptt.Program()
    startup.random_seed = seed
    with ptt.program_guard(main, startup):
        img = ptt.layers.data("img", [3, 224, 224])
        pred = ptt.models.resnet50(img)
    return main.clone(for_test=True), startup, pred


def phase_slice(seed, card):
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import conv1x1
    from paddle_tpu_torch.serving import Model, Server

    infer, startup, pred = build_resnet50(seed)
    gate_count = {b: len(eligible_1x1_shapes(infer, b))
                  for b in (1, 2, 4, 8, 16, 32)}
    print(f"[slice] eligible 1x1 convs per bucket: {gate_count}")
    scope = ptt.Scope()
    exe = ptt.Executor(amp=True, conv1x1_pallas=True)
    exe.run(startup, scope=scope)
    imgs = np.random.RandomState(seed).randn(
        N_REQUESTS, 3, 224, 224).astype(np.float32)
    softmax = [op for op in infer.global_block().ops
               if op.type == "softmax"][-1]
    logits = softmax.input("X")[0]
    fetch = [pred, logits]

    base = Model.from_program(exe, infer, fetch, scope=scope,
                              example={"img": imgs[0]})
    buckets = []

    def serve(feeds):
        buckets.append(int(feeds["img"].shape[0]))
        return base(feeds)

    model = Model("resnet50", serve, output_names=base.output_names,
                  example=base.example)
    srv = Server(max_batch=BATCH, max_wait_ms=200.0, deadline_ms=None)
    srv.add_model(model)
    srv.start()                                 # warmup at buckets 1, 32
    responses = [None] * N_REQUESTS

    def client(k):
        for i in range(k, N_REQUESTS, N_CLIENTS):
            responses[i] = srv.submit({"img": imgs[i]})

    # the main path: counts to 0, serve, read the counts
    buckets.clear()
    conv1x1.mm.launches = 0
    t0 = time.perf_counter()
    clients = [threading.Thread(target=client, args=(k,),
                                name=f"chip-smoke-client-{k}")
               for k in range(N_CLIENTS)]
    for t in clients:
        t.start()
    for t in clients:
        t.join(timeout=120)
        if t.is_alive():
            raise RuntimeError("chip_smoke: a client thread hung")
    outs = [r.result(timeout=300) for r in responses]   # raises on error
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = conv1x1.mm.launches
    srv.shutdown(timeout=60)
    if srv.state != "stopped" or any(
            t.is_alive() for rt in srv._models.values()
            for t in (rt.batcher, rt.dispatcher)):
        raise RuntimeError("chip_smoke: server threads did not stop")

    served = np.stack([o[0] for o in outs])
    served_logits = np.stack([o[1] for o in outs])
    if served.shape != (N_REQUESTS, 1000) or not np.isfinite(served).all():
        raise RuntimeError(f"chip_smoke: bad responses, shape "
                           f"{served.shape}, finite "
                           f"{np.isfinite(served).all()}")
    sums = served.sum(axis=1)
    if np.abs(sums - 1.0).max() > SUM_TOL_BF16:
        raise RuntimeError(f"chip_smoke: softmax rows sum to "
                           f"{sums.min()}..{sums.max()}")
    expected = sum(gate_count[b] for b in buckets)
    print(f"[slice] served {N_REQUESTS} requests from {N_CLIENTS} clients "
          f"in {wall:.3f} s as buckets {buckets}; kernel launches "
          f"{launches}, gate count {expected}")
    if launches != expected:
        raise RuntimeError(f"chip_smoke: conv1x1_mm launched {launches} "
                           f"times, the gate expects {expected}")
    if BATCH not in buckets:
        raise RuntimeError("chip_smoke: no full batch-32 bucket formed")

    # served rows vs a direct run of the same batch on the plain path
    def compare(label, probs, lg, ref_probs, ref_lg):
        rel = np.abs(lg - ref_lg).max() / np.abs(ref_lg).max()
        print(f"[slice] {label}: softmax max_abs_diff "
              f"{np.abs(probs - ref_probs).max():.3e} (max prob "
              f"{ref_probs.max():.3e}); logits max_abs_diff/max_abs "
              f"{rel:.3e} (max |logit| {np.abs(ref_lg).max():.3e}); argmax "
              f"agree {(probs.argmax(1) == ref_probs.argmax(1)).mean():.3f}")
        key = label.split()[0]
        np.testing.assert_allclose(probs, ref_probs, **SLICE_TOL[key])
        if not rel <= LOGIT_TOL[key]:
            raise RuntimeError(f"chip_smoke: {label}: logits differ by "
                               f"{rel:.3e} of their scale (> "
                               f"{LOGIT_TOL[key]})")

    plain = ptt.Executor(amp=True, conv1x1_pallas=False)
    direct, direct_lg = plain.run(infer, feed={"img": imgs[:BATCH]},
                                  fetch_list=fetch, scope=scope, is_test=True)
    compare("bf16 served vs plain-path run", served[:BATCH],
            served_logits[:BATCH], direct, direct_lg)

    # once in fp32, TF32 off, kernel vs plain path
    conv1x1.mm.launches = 0
    k32, k32_lg = ptt.Executor(amp=False, conv1x1_pallas=True).run(
        infer, feed={"img": imgs[:BATCH]}, fetch_list=fetch, scope=scope,
        is_test=True)
    fp32_launches = conv1x1.mm.launches
    p32, p32_lg = ptt.Executor(amp=False, conv1x1_pallas=False).run(
        infer, feed={"img": imgs[:BATCH]}, fetch_list=fetch, scope=scope,
        is_test=True)
    if fp32_launches != gate_count[BATCH]:
        raise RuntimeError(f"chip_smoke: fp32 run launched the kernel "
                           f"{fp32_launches} times, expected "
                           f"{gate_count[BATCH]}")
    compare(f"fp32 kernel path vs plain path ({fp32_launches} launches)",
            k32, k32_lg, p32, p32_lg)

    # throughput of one batch-32 dispatch, kernel path and plain path
    feed = {"img": imgs[:BATCH]}
    rates = {}
    for label, ex in (("kernel", exe), ("plain", plain), ("kernel", exe),
                      ("plain", plain)):
        ex.run(infer, feed=feed, fetch_list=[pred], scope=scope,
               is_test=True)                           # warm
        t0 = time.perf_counter()
        for _ in range(10):
            ex.run(infer, feed=feed, fetch_list=[pred], scope=scope,
                   is_test=True)
        rates.setdefault(label, []).append(
            10 * BATCH / (time.perf_counter() - t0))
    print(f"[slice] ResNet-50 bf16 batch-{BATCH} Executor.run img/s: "
          f"kernel path {rates['kernel']}, plain path {rates['plain']} "
          f"on {card}")
    profile_dispatch(exe, infer, feed, pred, scope)
    return launches, buckets, gate_count


def profile_dispatch(exe, infer, feed, pred, scope, runs=3):
    """Where the time of a batch-32 dispatch goes: device time by kernel
    (torch.profiler) and the device's idle share of the window."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(runs):
            exe.run(infer, feed=feed, fetch_list=[pred], scope=scope,
                    is_test=True)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total", None)
        if dev is None:
            dev = getattr(ev, "self_cuda_time_total", 0)
        if dev > 0 and getattr(ev, "device_type", None) is not None \
                and str(ev.device_type).endswith("CUDA"):
            rows.append((dev / 1e3 / runs, ev.count // runs, ev.key))
    busy = sum(r[0] for r in rows)
    if not rows:
        print("[profile] torch.profiler recorded no device time")
        return
    print(f"[profile] batch-{BATCH} dispatch: wall {wall_ms / runs:.3f} ms, "
          f"device busy {busy:.3f} ms, idle share "
          f"{1 - busy * runs / wall_ms:.3f}")
    kernel = sum(r[0] for r in rows if "mm_bf16_wmma" in r[2]
                 or "mm_f32_simt" in r[2])
    print(f"[profile] conv1x1_mm {kernel:.3f} ms "
          f"({kernel / busy:.3f} of device time)")
    for ms, n, name in sorted(rows, reverse=True)[:15]:
        print(f"[profile] {ms:8.3f} ms {n:5d}x {name[:100]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    card = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    phase_build()
    infer, _, _ = build_resnet50(args.seed)
    shapes = eligible_1x1_shapes(infer, BATCH)
    rows = phase_kernels(shapes, args.seed)
    launches, buckets, gate_count = phase_slice(args.seed, card)

    # one batch-32 forward of the served path (bf16): every launch of it
    per_batch = [rows[(torch.bfloat16, s)] for s in shapes]
    t_bound = sum(r["bound_ms"] for r in per_batch)
    t_ops = sum(r["bound_ms"] for r in per_batch
                if r["bound_by"] == "operations")
    kernel = {
        "name": "conv1x1_mm",
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/conv1x1_mm.cu",
        "replaces": "paddle_tpu/ops/pallas_conv.py:69",
        "launches": launches,
        "max_abs_err": max(r["err"] for r in per_batch),
        "ms": sum(r["ms"] for r in per_batch),
        "plain_ms": sum(r["plain_ms"] for r in per_batch),
        "bound_ms": t_bound,
        "bound_by": "operations" if t_ops > t_bound / 2 else "bytes",
        "library_ms": sum(r["library_ms"] for r in per_batch),
    }
    print(f"[summary] times are the sums over the {len(shapes)} bf16 "
          f"launches of one batch-{BATCH} forward; launches are the served "
          f"run's ({len(buckets)} batches)")
    print(json.dumps({"kernels": [kernel]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
