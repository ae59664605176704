"""Fleet-vs-single saturation + chaos benchmark (the port's copy of the
JAX package's ``benchmark/fleet.py`` runner).

Measures the serving FLEET (N ``python -m paddle_tpu_torch serve``
replica processes behind the queue-depth-aware router,
``paddle_tpu_torch/serving/fleet.py``) against itself at N=1 — same
artifact, same per-replica host resources: each replica is CPU-PINNED to
one of this process's cores (``sched_setaffinity``), and on a card host
every replica serves on the same card.

* ``saturation`` — an escalating-rate open-loop ladder on the full
  fleet finds the saturating offered rate; the fleet-rim backlog shed
  keeps past-saturation arms from thrashing.
* ``capacity`` — fleet-of-1 vs fleet-of-2 as PAIRED ALTERNATING arms on
  the SAME running fleet: the r1 half CORDONS the second replica
  (administratively unroutable, process untouched) so the pair flips
  fleet size in milliseconds and both halves see the same contention
  regime.  Headline = median of per-pair r2/r1 ratios.
* ``overload`` — open-loop at 1x and 2x measured capacity with
  deadlines + fleet-rim shedding: admitted p99 must stay bounded
  FLEET-WIDE.
* ``chaos_sigkill`` — closed-loop load, one replica SIGKILLed mid-run:
  ZERO admitted requests dropped fleet-wide (in-flight work fails over
  to the survivor), and the victim relaunches through the supervisor
  gate back to ready.

The tenant is the JAX runner's MLP 64 -> 2048 x 6 -> 16 (fp32), exported
by the port: each bucket of a replica replays its CUDA graph on the card.

    python -m paddle_tpu_torch.benchmark.fleet [--smoke] [--device cpu]
        [--out PATH] [--duration-s S] [--pairs N] ...

Results go to ``build/fleet_results.json`` (not with ``--smoke`` unless
``--out`` is given).  ``--smoke`` shortens every arm (numbers
meaningless: a path check).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

from .harness import device_label, write_results
from .serving_common import (closed_loop, export_mlp, load_artifact,
                             percentile, single_example)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODEL_DIR = os.path.join(REPO, "build", "artifacts", "fleet_mlp")

FULL = {"duration_s": 5.0, "pairs": 4, "max_batch": 32,
        "max_wait_ms": 10.0, "deadline_ms": 4000.0, "queue": 64,
        "probe_s": 3.0, "start_rate": 150.0, "chaos_s": 5.0}
SMOKE = dict(FULL, duration_s=1.5, pairs=1, probe_s=1.0, chaos_s=4.0)


def _env():
    return dict(os.environ, PYTHONPATH=REPO + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


def host_cores():
    """This process's usable host cores, in order (replica i is pinned to
    ``host_cores()[i % len]``)."""
    if hasattr(os, "sched_getaffinity"):
        return sorted(os.sched_getaffinity(0))
    return list(range(os.cpu_count() or 1))


def host_parallel_probe(duration_s: float = 3.0) -> dict:
    """The host's REAL parallel capacity: GEMM throughput of one
    core-pinned process vs two pinned to different cores — the ceiling
    on any 2-replica speedup of host-bound serving."""
    cores = host_cores()
    code = ("import os,sys,time;import numpy as np;"
            "os.sched_setaffinity(0,{int(sys.argv[1])});"
            "a=np.random.rand(1024,1024).astype('float32');b=a.copy();"
            "n=0;t0=time.perf_counter()\n"
            f"while time.perf_counter()-t0<{duration_s}: a@b; n+=1\n"
            "print(n/(time.perf_counter()-t0))")

    def run_one(core):
        return subprocess.Popen([sys.executable, "-c", code, str(core)],
                                stdout=subprocess.PIPE, text=True)

    p = run_one(cores[0])
    single = float(p.communicate(timeout=duration_s * 10)[0])
    ps = [run_one(cores[0]), run_one(cores[1 % len(cores)])]
    pair = sum(float(q.communicate(timeout=duration_s * 10)[0])
               for q in ps)
    return {"single_gemms_per_s": round(single, 1),
            "pair_gemms_per_s": round(pair, 1),
            "pair_over_single": round(pair / max(1e-9, single), 3)}


def _make_router(model_dir, n, *, deadline_ms, queue, max_batch,
                 max_wait_ms, device, backlog_limit=None):
    from ..serving.fleet import FleetRouter, ProcessReplica, serve_argv

    argv = serve_argv([f"m={model_dir}"], max_batch=max_batch,
                      max_wait_ms=max_wait_ms, deadline_ms=deadline_ms,
                      queue=queue, warmup_all=True, device=device)
    cores = host_cores()

    def factory(i):
        return ProcessReplica(argv, name=f"replica{i}", env=_env(),
                              cpu_affinity=[cores[i % len(cores)]])

    router = FleetRouter(factory, replicas=n, poll_interval_s=0.1,
                         max_restarts=3, backlog_limit=backlog_limit,
                         restart_backoff_base_s=0.1).start(
                             ready_timeout_s=600)
    # start() returns once ONE replica is routable; every arm (and the
    # chaos victim, replica0) wants the whole fleet up
    deadline = time.monotonic() + 600
    while len(router._routable()) < n and time.monotonic() < deadline:
        time.sleep(0.05)
    return router


def open_loop(router, example, *, rate, duration_s, deadline_ms):
    """Fixed-rate submission against a RUNNING fleet; returns the
    admitted-latency row."""
    lock = threading.Lock()
    lat, errors = [], {}
    offered = served = 0
    interval = 1.0 / rate
    t_start = time.monotonic()
    t_last = t_start
    stop = t_start + duration_s
    pendings = []

    def on_done(fp):
        nonlocal served, t_last
        with lock:
            if fp.error is None:
                lat.append((time.monotonic() - fp.t_admit))
                served += 1
                t_last = time.monotonic()
            else:
                k = type(fp.error).__name__
                errors[k] = errors.get(k, 0) + 1

    next_t = time.monotonic()
    while time.monotonic() < stop:
        now = time.monotonic()
        if now < next_t:
            time.sleep(min(interval, next_t - now))
            continue
        next_t += interval
        offered += 1
        try:
            fp = router.submit(example, deadline_ms=deadline_ms)
        except BaseException as e:      # typed admission rejection
            with lock:
                k = type(e).__name__
                errors[k] = errors.get(k, 0) + 1
            continue
        fp.add_done_callback(on_done)
        pendings.append(fp)
    deadline = time.monotonic() + 60
    for fp in pendings:
        if not fp.done() and time.monotonic() < deadline:
            try:
                fp.result(timeout=max(0.1, deadline - time.monotonic()))
            except BaseException:
                pass
    with lock:
        lat.sort()
        # throughput over admit-to-last-completion wall: requests
        # admitted in the window but completed just past it count at
        # their true cost instead of vanishing
        wall = max(duration_s, t_last - t_start)
        row = {"offered_per_s": round(rate, 1), "offered": offered,
               "offered_actual_per_s": round(offered / duration_s, 1),
               "served": served,
               "served_per_s": round(served / wall, 1),
               "errors": dict(errors)}
        if lat:
            row["latency_ms_p50"] = round(percentile(lat, 0.50) * 1e3, 2)
            row["latency_ms_p99"] = round(percentile(lat, 0.99) * 1e3, 2)
        return row


def saturation_ladder(router, example, *, duration_s, deadline_ms,
                      start_rate):
    """Climb open-loop arms until served_per_s stops improving — keep
    climbing while an arm is visibly unsaturated (no rejections, served
    ~= offered) — and return (best_arm, ladder)."""
    best, ladder = None, []
    rate = start_rate
    for _step in range(7):
        arm = open_loop(router, example, rate=rate,
                        duration_s=duration_s, deadline_ms=deadline_ms)
        ladder.append({"offered_per_s": arm["offered_per_s"],
                       "served_per_s": arm["served_per_s"],
                       "shed": arm["errors"].get("Overloaded", 0)})
        unsaturated = (not arm["errors"]
                       and arm["served_per_s"]
                       >= 0.92 * arm["offered_actual_per_s"])
        if best is None or arm["served_per_s"] > \
                best["served_per_s"] * 1.05:
            best = arm
            rate *= 2.0 if unsaturated else 1.5
            continue
        if unsaturated:
            rate *= 2.0                 # not saturated yet: keep going
            continue
        break                           # plateaued: done
    return best, ladder


def paired_capacity(router, example, spare_name, *, pairs, duration_s,
                    deadline_ms, rate, say=print):
    """Fleet-of-1 vs fleet-of-2 as PAIRED ALTERNATING arms on the SAME
    running fleet: the r1 half cordons the second replica so the pair
    flips fleet size in milliseconds and both halves sit in the same
    contention regime.  Headline = median of per-pair r2/r1 ratios."""
    rows = []
    for k in range(pairs):
        router.cordon(spare_name)
        try:
            r1 = open_loop(router, example, rate=rate,
                           duration_s=duration_s,
                           deadline_ms=deadline_ms)
        finally:
            router.cordon(spare_name, cordoned=False)
        r2 = open_loop(router, example, rate=rate,
                       duration_s=duration_s, deadline_ms=deadline_ms)
        rows.append({
            "pair": k,
            "r1_served_per_s": r1["served_per_s"],
            "r2_served_per_s": r2["served_per_s"],
            "ratio": round(r2["served_per_s"]
                           / max(1e-9, r1["served_per_s"]), 3),
            "r1_p99_ms": r1.get("latency_ms_p99"),
            "r2_p99_ms": r2.get("latency_ms_p99"),
        })
        say(json.dumps({"pair": rows[-1]}))
    ratios = sorted(r["ratio"] for r in rows)
    return {
        "pairs": rows,
        "r1_served_per_s_median": sorted(
            r["r1_served_per_s"] for r in rows)[len(rows) // 2],
        "r2_served_per_s_median": sorted(
            r["r2_served_per_s"] for r in rows)[len(rows) // 2],
        "speedup_median_of_pair_ratios": ratios[len(ratios) // 2],
        "pairs_favoring_r2": sum(1 for r in rows if r["ratio"] > 1.0),
    }


def chaos_arm(model_dir, example, *, duration_s, max_batch, max_wait_ms,
              device, workers=8):
    """SIGKILL one of two replicas under closed-loop load: zero admitted
    drops fleet-wide + supervisor relaunch back to ready."""
    from .. import observability as obs

    router = _make_router(model_dir, 2, deadline_ms=0, queue=4096,
                          max_batch=max_batch, max_wait_ms=max_wait_ms,
                          device=device)
    try:
        failovers0 = obs.registry().snapshot()[
            "fleet/failovers"]["value"]
        victim = router.replicas[0]
        kill_at = time.monotonic() + duration_s / 3.0

        def killer():
            time.sleep(max(0.0, kill_at - time.monotonic()))
            victim.kill()

        kt = threading.Thread(target=killer, name="pt-loadgen-killer",
                              daemon=True)
        kt.start()
        lat, row = closed_loop(router, example, workers=workers,
                               duration_s=duration_s, timeout_s=120.0)
        kt.join(timeout=30)
        relaunched = False
        t_kill = time.monotonic()
        deadline = t_kill + 300
        while time.monotonic() < deadline:
            if victim.state == "ready":
                relaunched = True
                break
            time.sleep(0.5)
        failovers = obs.registry().snapshot()[
            "fleet/failovers"]["value"] - failovers0
        return {
            "replicas": 2, "sigkill_at_s": round(duration_s / 3.0, 2),
            "served": row["served"],
            # closed_loop counts every raised error; with shedding and
            # deadlines off any error IS a dropped admitted request
            "dropped": row["worker_errors"],
            "failovers": int(failovers),
            "victim_relaunched_ready": relaunched,
            "victim_restarts": getattr(victim, "restarts", 0),
            "latency_ms_p99": round(percentile(lat, 0.99) * 1e3, 2),
            "zero_admitted_drops": row["worker_errors"] == 0,
        }
    finally:
        router.shutdown(timeout_s=120)


def run(cfg=None, smoke=False, device=None, quiet=False):
    """The whole benchmark at ``cfg`` (:data:`FULL` or :data:`SMOKE`, or a
    variant), replicas on ``device`` (``cuda``/``cpu``; None: the card).
    Returns the result row with its ``acceptance``."""
    from ..export_model import resolve_place
    cfg = dict(cfg or (SMOKE if smoke else FULL))
    device = device or "cuda"

    def say(line):
        if not quiet:
            print(line, flush=True)

    # sized so per-request model work dominates the routing/JSON-wire
    # cost in the JAX package's CPU run; on a card the model is a few
    # graph replays and the wire is the work
    model_dir = export_mlp(MODEL_DIR, in_dim=64, hidden=(2048,) * 6,
                           classes=16, device=device)
    _, manifest = load_artifact(model_dir, device=device)
    example = single_example(manifest, np.random.RandomState(0))
    # pre-serialized wire form: the open-loop scheduler must not pay a
    # tolist() per submission
    example_wire = {k: v.tolist() for k, v in example.items()}
    cores = host_cores()
    result = {
        "engine": "process-replica fleet (paddle_tpu_torch.serving.fleet):"
                  " N `python -m paddle_tpu_torch serve` subprocesses "
                  "behind the queue-depth router",
        "model": "mlp 64->2048x6->16 (fp32 symbolic-batch artifact, ~34 "
                 "MFLOP/request; every bucket one CUDA graph replay on a "
                 "card)",
        "config": cfg, "replica_device": device,
        "host_cores": len(cores),
        "replica_pinning": "sched_setaffinity: replica i -> host core "
                           "i % cores (identical per-replica host "
                           "resources)",
        "note": "router + load generator share the host with the "
                "replicas: fleet capacity is net of routing and the "
                "JSON wire.  On one card both replicas share the card, "
                "each pinned to its own host core, so the r2/r1 ratio "
                "measures how much host work the two processes overlap "
                "around one card, not a second device",
        "device": device_label(resolve_place(device)),
    }
    say(json.dumps({"phase": "host_parallel_probe"}))
    probe = host_parallel_probe(cfg["probe_s"])
    result["host_parallel_probe"] = probe
    say(json.dumps({"host_parallel_probe": probe}))

    router = _make_router(model_dir, 2, deadline_ms=cfg["deadline_ms"],
                          queue=cfg["queue"], max_batch=cfg["max_batch"],
                          max_wait_ms=cfg["max_wait_ms"], device=device,
                          backlog_limit=cfg["queue"])
    try:
        for _ in range(6):              # settle both replicas
            router.infer(example, deadline_ms=None, timeout=120)
        say(json.dumps({"phase": "saturation_ladder"}))
        sat, ladder = saturation_ladder(
            router, example_wire, duration_s=cfg["duration_s"],
            deadline_ms=cfg["deadline_ms"], start_rate=cfg["start_rate"])
        result["saturation"] = {**sat, "ladder": ladder}
        say(json.dumps({"saturation": result["saturation"]}))
        sat_rate = max(sat["served_per_s"] * 1.3, 30.0)

        say(json.dumps({"phase": "paired_capacity",
                        "rate": round(sat_rate, 1)}))
        cap = paired_capacity(
            router, example_wire, "replica1", pairs=cfg["pairs"],
            duration_s=cfg["duration_s"], deadline_ms=cfg["deadline_ms"],
            rate=sat_rate, say=say)
        result["capacity_pairs"] = cap
        result["scaling"] = {
            "replicas": [1, 2],
            "req_per_s_median": [cap["r1_served_per_s_median"],
                                 cap["r2_served_per_s_median"]],
            "speedup": cap["speedup_median_of_pair_ratios"],
        }

        # overload envelope fleet-wide: 1x vs 2x of measured capacity
        cap2 = cap["r2_served_per_s_median"]
        arms = {}
        for factor in (1.0, 2.0):
            say(json.dumps({"phase": f"open_loop_{factor}x"}))
            arms[f"{factor}x"] = open_loop(
                router, example_wire, rate=max(1.0, cap2 * factor),
                duration_s=cfg["duration_s"],
                deadline_ms=cfg["deadline_ms"])
            say(json.dumps({f"{factor}x": arms[f"{factor}x"]}))
        result["overload"] = arms
    finally:
        router.shutdown(timeout_s=120)

    p99_1x = arms["1.0x"].get("latency_ms_p99")
    p99_2x = arms["2.0x"].get("latency_ms_p99")
    speedup = result["scaling"]["speedup"]
    ceiling = probe["pair_over_single"]
    # two ways to pass, as in the JAX row: the absolute claim, or >= 85%
    # of THIS host's measured 2-process ceiling
    result["acceptance"] = {
        "host_parallel_ceiling_2proc": ceiling,
        "fleet_speedup": speedup,
        "fleet_over_ceiling": round(speedup / max(1e-9, ceiling), 3),
        "capacity_scales_with_replicas":
            (speedup > 1.2
             and cap["pairs_favoring_r2"] >= (cfg["pairs"] + 1) // 2)
            or speedup >= 0.85 * ceiling,
        "p99_1x_ms": p99_1x, "p99_2x_ms": p99_2x,
        "p99_ratio_2x_over_1x": (round(p99_2x / p99_1x, 3)
                                 if p99_1x and p99_2x else None),
        "bounded_under_overload": (bool(p99_1x and p99_2x
                                        and p99_2x < 5.0 * p99_1x)),
    }

    say(json.dumps({"phase": "chaos_sigkill"}))
    result["chaos_sigkill"] = chaos_arm(
        model_dir, example, duration_s=max(4.0, cfg["chaos_s"]),
        max_batch=cfg["max_batch"], max_wait_ms=cfg["max_wait_ms"],
        device=device)
    say(json.dumps({"chaos_sigkill": result["chaos_sigkill"]}))
    result["smoke"] = bool(smoke)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="short arms (numbers meaningless); writes a "
                         "results file only with --out")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the replicas serve (default the card)")
    ap.add_argument("--duration-s", type=float, default=None)
    ap.add_argument("--pairs", type=int, default=None)
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--max-wait-ms", type=float, default=None)
    ap.add_argument("--deadline-ms", type=float, default=None)
    ap.add_argument("--queue", type=int, default=None)
    ap.add_argument("--out", default=None, help="results path (default "
                    "build/fleet_results.json)")
    args = ap.parse_args(argv)
    cfg = dict(SMOKE if args.smoke else FULL)
    for key in ("duration_s", "pairs", "max_batch", "max_wait_ms",
                "deadline_ms", "queue"):
        if getattr(args, key) is not None:
            cfg[key] = getattr(args, key)
    row = run(cfg, smoke=args.smoke, device=args.device)
    print(json.dumps({"acceptance": row["acceptance"]}), flush=True)
    write_results(args.out, args.smoke, "fleet_results.json",
                  "serving_fleet", row)
    return row


if __name__ == "__main__":
    main()
