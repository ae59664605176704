"""Sparse parameter-server wire benchmark (the port's counterpart of the
JAX package's ``benchmark/pserver.py``).

The shard servers run as ``python -m paddle_tpu_torch pserver``
processes, each with one torch thread (``pserver_main`` sets it: a
shard's thread pool beside the client's oversubscribes the host), so a
shard's work never shares the timed client's GIL.  Every arm is measured
in paired alternating windows (``benchmark.harness.paired_ab``: median of
per-pair ratios, a noise gate, raw windows kept).  The tier is host-side
(sockets, numpy and the host's torch); the rows name the card's name and
power limit of the machine they ran on.  Arms:

* ``wire_ab``: one batched binary frame a request against the naive
  per-row JSON arm (the reference implementation's RPC shape), same
  server, same schedule, gate ``min_speedup=3.0``; both arms' exported
  rows must be bit-equal (``arms_bit_identical``);
* ``remote_pull_latency``: p50/p99 of warm batched remote pulls beside
  the same pulls from an in-process ``SparseTable`` in the same run;
* ``shard_pipelining_ab``: a 1-shard fleet against a 2-shard fleet
  (the client writes every shard's frame before it reads a reply);
* ``trace_overhead_ab``: the trace context's cost: the same pull/push
  schedule through an observing client (client spans, the context in
  every frame header, a server span and the timing piggyback in every
  reply) against an observe-off one, no metrics log in either arm;
  ``overhead_frac`` (median on/off ratio - 1) is read against the JAX
  runner's declared 5% budget, and stated either way.

The arms take address lists, so they run as well against shards served
on threads of one interpreter (the tests do).

    python -m paddle_tpu_torch.benchmark.pserver [--smoke] [--out PATH]
    python -m paddle_tpu_torch.benchmark.run --model pserver [--smoke]

Results go to ``build/pserver_results.json`` (not with ``--smoke``
unless ``--out`` is given).
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np

from .harness import device_label, paired_ab, write_results

HOST = "127.0.0.1"
READY_TIMEOUT_S = 180

FULL = {
    "vocab": 200_000,
    "dim": 16,
    "warm_rows": 16_384,         # the resident working set, warmed first
    "pull_batch": 1024,          # ids a batched round
    "latency_reps": 200,
    "ab_batch": 256,             # rows a round in the naive-arm A/B
    "ab_rounds": 3,              # rounds a timed window
    "ab_pairs": 4,
    "pipe_batch": 2048,
    "pipe_rounds": 4,
    "pipe_pairs": 4,
    "trace_batch": 256,
    "trace_rounds": 12,
    "trace_pairs": 8,
}
SMOKE = {
    "vocab": 4_000,
    "dim": 8,
    "warm_rows": 512,
    "pull_batch": 128,
    "latency_reps": 20,
    "ab_batch": 32,
    "ab_rounds": 2,
    "ab_pairs": 2,
    "pipe_batch": 256,
    "pipe_rounds": 2,
    "pipe_pairs": 2,
    "trace_batch": 32,
    "trace_rounds": 2,
    "trace_pairs": 2,
}


# -- the fleet -----------------------------------------------------------------
def launch_fleet(n_shards):
    """Start ``n_shards`` shard processes on ephemeral ports, all
    together; returns (processes, addresses) once each printed its ready
    line."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("PADDLE_TPU_FAULT_SPEC", None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "pserver", "--shard",
         f"{k}/{n_shards}", "--host", HOST, "--port", "0"], cwd=root,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for k in range(n_shards)]
    addrs = []
    try:
        for p in procs:
            deadline = time.monotonic() + READY_TIMEOUT_S
            ready = None
            for line in p.stdout:
                if '"pserver"' in line:
                    ready = json.loads(line)["pserver"]
                    break
                if time.monotonic() > deadline:
                    break
            if ready is None:
                raise RuntimeError(f"benchmark.pserver: a shard gave no "
                                   f"ready line (rc {p.poll()})")
            # drain the rest so a shard never blocks on a full pipe
            threading.Thread(target=lambda s=p.stdout: [None for _ in s],
                             daemon=True,
                             name=f"pt-pserver-drain-{len(addrs)}").start()
            addrs.append((HOST, int(ready["port"])))
    except BaseException:
        stop_fleet(procs)
        raise
    return procs, addrs


def stop_fleet(procs):
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    for p in procs:
        try:
            p.wait(timeout=60)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=60)


def _remote(name, cfg, addrs, **kw):
    from ..sparse.client import RemoteSparseTable
    return RemoteSparseTable(name, cfg["vocab"], cfg["dim"], addrs=addrs,
                             optimizer="adagrad", learning_rate=0.05,
                             seed=3, **kw)


def _feed(cfg, rounds, batch, seed):
    """(ids, grads) rounds drawn from the warm working set."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(rounds):
        ids = rng.choice(cfg["warm_rows"], size=batch,
                         replace=False).astype(np.int64)
        out.append((ids, rng.standard_normal(
            (batch, cfg["dim"])).astype(np.float32)))
    return out


def _pctl(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q))


def _rounds_measure(arms, feeds, rounds, key):
    """``measure(config)`` of a pull-and-push window: the next ``rounds``
    of ``feeds`` through the arm ``config[key]`` names."""
    def measure(config):
        arm = arms[config[key]]
        lo = arm["cursor"]
        arm["cursor"] += rounds
        window = feeds[lo:lo + rounds]
        if len(window) != rounds:
            raise RuntimeError("benchmark.pserver: feed schedule exhausted")
        for ids, g in window:
            arm["rt"].pull(ids)
            arm["rt"].push(ids, g)
    return measure


# -- arms --------------------------------------------------------------------
def run_wire_ab(cfg, addrs, quiet=False):
    """Binary frames against the naive per-row JSON arm, on one fleet and
    one schedule, separate tables; gate ``min_speedup=3.0``."""
    arms = {}
    for mode in ("naive", "binary"):
        rt = _remote(f"ab_{mode}", cfg, addrs, wire_mode=mode)
        rt.pull(np.arange(cfg["warm_rows"], dtype=np.int64))  # warm init
        arms[mode] = {"rt": rt, "cursor": 0}
    try:
        feeds = _feed(cfg, (max(2, cfg["ab_pairs"]) + 1) * cfg["ab_rounds"],
                      cfg["ab_batch"], seed=1)
        ab = paired_ab(_rounds_measure(arms, feeds, cfg["ab_rounds"], "wire"),
                       {"wire": "naive"}, {"wire": "binary"},
                       pairs=cfg["ab_pairs"], warmup=1, min_speedup=3.0)
        ab["rows_per_window"] = cfg["ab_batch"] * cfg["ab_rounds"]
        # the same schedule trained both: the naive arm is slow, not wrong
        a = arms["naive"]["rt"].export_state_vars()
        b = arms["binary"]["rt"].export_state_vars()
        ab["arms_bit_identical"] = all(
            a[k.replace("ab_binary", "ab_naive")].tobytes() == b[k].tobytes()
            for k in b if not k.endswith("/meta"))
    finally:
        for arm in arms.values():
            arm["rt"].close()
    if not quiet:
        print(json.dumps({"arm": "wire_ab", "speedup": ab["speedup"],
                          "accepted": ab["accepted"],
                          "arms_bit_identical": ab["arms_bit_identical"]}),
              flush=True)
    return ab


def run_remote_pull_latency(cfg, addrs, quiet=False):
    """p50/p99 of warm batched remote pulls, beside the same pulls from
    an in-process vectorized ``SparseTable``."""
    from ..sparse import SparseTable
    rt = _remote("lat", cfg, addrs)
    local = SparseTable("lat_local", cfg["vocab"], cfg["dim"],
                        optimizer="adagrad", learning_rate=0.05, seed=3,
                        impl="vectorized")
    try:
        warm = np.arange(cfg["warm_rows"], dtype=np.int64)
        rt.pull(warm)
        local.pull(warm)
        rng = np.random.RandomState(2)
        remote_ms, local_ms = [], []
        for _ in range(cfg["latency_reps"]):
            ids = rng.choice(cfg["warm_rows"], size=cfg["pull_batch"],
                             replace=False).astype(np.int64)
            t0 = time.perf_counter()
            got = rt.pull(ids)
            remote_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            want = local.pull(ids)
            local_ms.append((time.perf_counter() - t0) * 1e3)
            if got.tobytes() != want.tobytes():
                raise RuntimeError("benchmark.pserver: a remote pull "
                                   "differs from the in-process table's")
    finally:
        rt.close()
    row = {
        "pull_batch": cfg["pull_batch"],
        "reps": cfg["latency_reps"],
        "remote_ms": {"p50": _pctl(remote_ms, 50),
                      "p99": _pctl(remote_ms, 99)},
        "in_process_ms": {"p50": _pctl(local_ms, 50),
                          "p99": _pctl(local_ms, 99)},
        "wire_overhead_p50_ms":
            _pctl(remote_ms, 50) - _pctl(local_ms, 50),
    }
    if not quiet:
        print(json.dumps({"arm": "remote_pull_latency", **row}),
              flush=True)
    return row


def run_trace_overhead_ab(cfg, addrs, quiet=False):
    """The trace context's cost on the wire: the same schedule through an
    observing client (default arm) and an observe-off one (candidate),
    so the median pair ratio is on/off.  ``paired_ab``'s ``accepted`` is
    not the verdict here; ``overhead_frac`` against the 5% budget is."""
    arms = {}
    try:
        for observe in (True, False):
            rt = _remote(f"trace_{'on' if observe else 'off'}", cfg, addrs,
                         observe=observe)
            rt.pull(np.arange(cfg["warm_rows"], dtype=np.int64))
            arms[observe] = {"rt": rt, "cursor": 0}
        feeds = _feed(cfg, (max(2, cfg["trace_pairs"]) + 1)
                      * cfg["trace_rounds"], cfg["trace_batch"], seed=7)
        ab = paired_ab(_rounds_measure(arms, feeds, cfg["trace_rounds"],
                                       "observe"),
                       {"observe": True}, {"observe": False},
                       pairs=cfg["trace_pairs"], warmup=1)
    finally:
        for arm in arms.values():
            arm["rt"].close()
    overhead = ab["speedup"] - 1.0
    row = {
        "rows_per_window": cfg["trace_batch"] * cfg["trace_rounds"],
        "overhead_frac": overhead,
        "overhead_budget": 0.05,
        "within_budget": bool(overhead <= 0.05),
        "pair_ratios_on_over_off": ab["pair_ratios"],
        "observe_on_windows": ab["default_windows"],
        "observe_off_windows": ab["candidate_windows"],
        "note": ("on-arm = the whole observing client (spans, ctx, the "
                 "server's span and srv piggyback) against observe-off; "
                 "loopback sub-ms rounds make the fixed per-round cost "
                 "dominate"),
    }
    if not quiet:
        print(json.dumps({"arm": "trace_overhead_ab",
                          "overhead_frac": row["overhead_frac"],
                          "within_budget": row["within_budget"]}),
              flush=True)
    return row


def run_shard_pipelining_ab(cfg, fleets=None, quiet=False):
    """A 1-shard fleet against a 2-shard fleet.  ``fleets`` maps the
    shard count to the fleet's addresses; without it both fleets start
    here as shard processes and stop at the end."""
    procs = []
    if fleets is None:
        fleets = {}
        try:
            for n in (1, 2):
                ps, fleets[n] = launch_fleet(n)
                procs += ps
        except BaseException:
            stop_fleet(procs)
            raise
    arms = {}
    try:
        for n in (1, 2):
            rt = _remote("pipe", cfg, fleets[n])
            rt.pull(np.arange(cfg["warm_rows"], dtype=np.int64))
            arms[n] = {"rt": rt, "cursor": 0}
        feeds = _feed(cfg, (max(2, cfg["pipe_pairs"]) + 1)
                      * cfg["pipe_rounds"], cfg["pipe_batch"], seed=4)
        ab = paired_ab(_rounds_measure(arms, feeds, cfg["pipe_rounds"],
                                       "shards"),
                       {"shards": 1}, {"shards": 2},
                       pairs=cfg["pipe_pairs"], warmup=1)
        ab["rows_per_window"] = cfg["pipe_batch"] * cfg["pipe_rounds"]
        ab["effective_cores"] = len(os.sched_getaffinity(0)) \
            if hasattr(os, "sched_getaffinity") else os.cpu_count()
    finally:
        for arm in arms.values():
            arm["rt"].close()
        stop_fleet(procs)
    if not quiet:
        print(json.dumps({"arm": "shard_pipelining_ab",
                          "speedup": ab["speedup"],
                          "accepted": ab["accepted"]}), flush=True)
    return ab


def run_all(cfg=None, smoke=False, quiet=False):
    """Every arm on shard processes started here."""
    cfg = cfg or (SMOKE if smoke else FULL)
    procs, addrs = launch_fleet(1)
    try:
        wire_ab = run_wire_ab(cfg, addrs, quiet=quiet)
        latency = run_remote_pull_latency(cfg, addrs, quiet=quiet)
        trace = run_trace_overhead_ab(cfg, addrs, quiet=quiet)
    finally:
        stop_fleet(procs)
    pipelining = run_shard_pipelining_ab(cfg, quiet=quiet)
    return {"config": dict(cfg), "wire_ab": wire_ab,
            "remote_pull_latency": latency, "trace_overhead_ab": trace,
            "shard_pipelining_ab": pipelining, "device": device_label(),
            "smoke": bool(smoke)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes; writes a results file only with "
                         "--out")
    ap.add_argument("--out", default=None, help="results path (default "
                    "build/pserver_results.json)")
    args = ap.parse_args(argv)
    row = run_all(smoke=args.smoke)
    print(json.dumps(row, indent=1))
    write_results(args.out, args.smoke, "pserver_results.json",
                  "pserver_wire", row)
    return row


if __name__ == "__main__":
    main()
