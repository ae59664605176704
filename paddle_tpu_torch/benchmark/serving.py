"""Serving-runtime load benchmark on a CUDA card: throughput against
latency, shedding against collapse (the port's counterpart of the JAX
package's ``benchmark/serving.py``).

Two load generators drive the in-process
:class:`~paddle_tpu_torch.serving.Server` over an exported MLP artifact
(``serving_common.export_mlp``: 784 -> 2048 x 3 -> 10, fp32, each batch
bucket one CUDA graph replay on a card):

* **closed loop**: C worker threads submit back to back; the saturation
  capacity (req/s) with batching at work;
* **open loop**: a tick generator offers load at a fixed rate, a multiple
  of the measured capacity, as real traffic does (arrivals do not slow
  down because the server is behind).  Each arm's row: offered, admitted
  and served rates, the admitted requests' latency p50/p90/p99, shed and
  deadline-expired counts.

The acceptance pair: at 2x offered overload the shedding arm's admitted
p99 stays within 2x of the 1x arm's (admission control bounds the queue
wait at about queue_capacity / throughput), while the control arm (no
shedding, an unbounded queue, no deadlines) collapses: its queue grows
for the whole run and its p99 reaches seconds.

Every bucket's graph is captured before the first arm, so no arm pays a
capture.  The timed arms run with ``observe`` off: their servers build
no span and write no metric or log line.  After them one extra 1x
shedding arm runs observed, with its own JSONL log, and the top-level
``doctor`` row is the doctor's per-request budget over that log
(``attribution.serving_budget``: queue and batch wait against the
model's dispatch).

    python -m paddle_tpu_torch.benchmark.serving [--smoke] [--out PATH]
        [--device cuda|cpu] [--duration-s S] ...

Results go to ``build/serving_results.json`` (not with ``--smoke`` unless
``--out`` is given).  ``--smoke`` shortens every arm and narrows the MLP
(numbers meaningless: a path check).
"""
from __future__ import annotations

import argparse
import json
import os
import threading
import time

import numpy as np

from .harness import device_label, observed, write_results
from .serving_common import (closed_loop, export_mlp, load_artifact,
                             percentile, single_example)


FULL = {"hidden": (2048, 2048, 2048), "duration_s": 4.0, "max_batch": 32,
        "max_wait_ms": 5.0, "queue": 32, "deadline_ms": 1000.0,
        "workers": 64, "factors": (0.25, 0.5, 1.0, 2.0, 4.0),
        "control_mults": (2.0, 3.0, 4.0)}
SMOKE = {"hidden": (64, 64), "duration_s": 0.5, "max_batch": 8,
         "max_wait_ms": 2.0, "queue": 8, "deadline_ms": 1000.0,
         "workers": 4, "factors": (1.0, 2.0), "control_mults": (2.0,)}


class _Collector:
    """Thread-safe terminal-outcome recorder of an open-loop arm."""

    def __init__(self):
        self.lock = threading.Lock()
        self.latency_ms = []          # admitted and served
        self.errors = {}              # typed error name -> count
        self.shed_at_admission = 0

    def cb(self, pending):
        ms = (time.monotonic() - pending.t_admit) * 1e3
        with self.lock:
            if pending.error is None:
                self.latency_ms.append(ms)
            else:
                name = type(pending.error).__name__
                self.errors[name] = self.errors.get(name, 0) + 1

    def note_admission_reject(self, exc):
        with self.lock:
            name = type(exc).__name__
            self.errors[name] = self.errors.get(name, 0) + 1
            self.shed_at_admission += 1


def prepare_model(model_dir, max_batch, device=None):
    """The artifact as a serving Model, each batch bucket's graph
    captured here (a warm-up call, then the capture), so that no arm's
    dispatcher pays one."""
    from ..core.executor import pad_batch, stack_feeds
    from ..core.scope import to_numpy
    from ..serving import Model
    from ..serving.server import _buckets
    model = Model.from_artifact(model_dir, name="mlp", device=device)
    for b in _buckets(max_batch):
        for _ in range(2):
            for o in model(pad_batch(stack_feeds([model.example]), b)):
                to_numpy(o)
    return model


def make_server(model, cfg, *, shed, queue, deadline_ms):
    from ..serving import Server
    srv = Server(max_batch=cfg["max_batch"],
                 max_wait_ms=cfg["max_wait_ms"], deadline_ms=deadline_ms,
                 queue_capacity=queue, shed=shed, warmup=False)
    srv.add_model(model)
    srv.start()
    return srv


def closed_loop_capacity(model, example, cfg):
    """Saturation req/s: ``workers`` threads of back-to-back infers."""
    srv = make_server(model, cfg, shed=True,
                      queue=max(256, 4 * cfg["workers"]), deadline_ms=None)
    try:
        _lat, row = closed_loop(srv, example, workers=cfg["workers"],
                                duration_s=cfg["duration_s"])
    finally:
        srv.shutdown(drain=True)
    return row


def open_loop_arm(model, example, cfg, *, rate, shed, queue, deadline_ms,
                  tick_s=0.005, label="", sample_queue=False):
    """Offer ``rate`` req/s for ``cfg["duration_s"]``; the arm's row."""
    from .. import faults
    srv = make_server(model, cfg, shed=shed, queue=queue,
                      deadline_ms=deadline_ms)
    col = _Collector()
    offered = 0
    queue_samples = []
    t0 = time.monotonic()
    next_sample = t0
    end = t0 + cfg["duration_s"]
    try:
        while True:
            now = time.monotonic()
            if now >= end:
                break
            # every request whose arrival time has passed (burst ticks:
            # open-loop arrivals never slow down with the server)
            for _ in range(int((now - t0) * rate) - offered):
                offered += 1
                try:
                    pending = srv.submit(example, deadline_ms=deadline_ms)
                except (faults.Overloaded, faults.ServerClosed,
                        faults.ModelUnavailable) as e:
                    col.note_admission_reject(e)
                    continue
                pending.add_done_callback(col.cb)
            if sample_queue and now >= next_sample:
                queue_samples.append(
                    (now - t0, srv.health()["models"]["mlp"]["queue_depth"]))
                next_sample = now + 0.5
            time.sleep(tick_s)
        gen_wall = time.monotonic() - t0
        pending_at_stop = srv.health()["models"]["mlp"]["queue_depth"]
        if sample_queue:
            queue_samples.append((gen_wall, pending_at_stop))
    finally:
        # the control arm's unbounded backlog is aborted, not drained
        # through the model (that would take rate / capacity x duration);
        # the shedding arms drain in bounded time
        srv.shutdown(drain=shed, timeout=60)
    with col.lock:
        lat = sorted(col.latency_ms)
        errors = dict(col.errors)
    row = {
        "label": label, "offered_per_s": rate, "duration_s": gen_wall,
        "offered": offered, "served": len(lat),
        "served_per_s": len(lat) / gen_wall,
        "latency_ms_p50": percentile(lat, 0.50),
        "latency_ms_p90": percentile(lat, 0.90),
        "latency_ms_p99": percentile(lat, 0.99),
        "errors": errors,
        "shed": errors.get("Overloaded", 0),
        "deadline_expired": errors.get("DeadlineExceeded", 0),
        "shed_rate": errors.get("Overloaded", 0) / offered
        if offered else None,
        "config": {"shed": shed, "queue": queue, "deadline_ms": deadline_ms,
                   "max_batch": cfg["max_batch"],
                   "max_wait_ms": cfg["max_wait_ms"]},
    }
    if sample_queue:
        row["queue_depth_samples"] = queue_samples
        row["pending_at_stop"] = pending_at_stop
        row["aborted_at_stop"] = errors.get("ServerClosed", 0)
    return row


def run_doctor_pass(model, example, cfg, rate):
    """One extra observed 1x shedding arm after the timed ones (only its
    server observes): the doctor's per-request budget over the arm's
    log, and whether it reconciles within ``BUDGET_TOLERANCE``."""
    from ..observability import attribution
    with observed("serving") as log:
        arm = open_loop_arm(model, example, cfg, rate=rate, shed=True,
                            queue=cfg["queue"],
                            deadline_ms=cfg["deadline_ms"],
                            label="1x_shed_observed")
    budget = attribution.doctor_report([log]).get("serving")
    return {"arm": arm, "serving": budget,
            "reconciled": bool(budget and budget.get("within_tolerance"))}


def run_all(cfg=None, smoke=False, device=None, model_dir=None,
            quiet=False):
    """Capacity, the open-loop arms at ``cfg["factors"]`` of it with
    shedding, and the control at the first of ``cfg["control_mults"]``
    that overloads it (queue at stop >= 4 x max_batch), on ``device``
    (default the card)."""
    from ..export_model import resolve_place
    cfg = dict(cfg or (SMOKE if smoke else FULL))
    place = resolve_place(device)

    def say(**kw):
        if not quiet:
            print(json.dumps(kw), flush=True)

    model_dir = model_dir or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "build", "artifacts",
        "serving_mlp")
    export_mlp(model_dir, hidden=tuple(cfg["hidden"]), device=device)
    _, manifest = load_artifact(model_dir, device=device)
    example = single_example(manifest, np.random.RandomState(0))
    model = prepare_model(model_dir, cfg["max_batch"], device)

    cap = closed_loop_capacity(model, example, cfg)
    say(closed_loop=cap)
    # the closed loop underestimates capacity (workers wait out their
    # own round trips); saturation under heavy open-loop overload is the
    # other anchor, and the larger of the two is the 1x rate
    sat = open_loop_arm(model, example, cfg,
                        rate=max(1.0, cap["req_per_s"] * 4.0), shed=True,
                        queue=cfg["queue"], deadline_ms=cfg["deadline_ms"],
                        label="saturation_probe")
    say(saturation_probe=sat)
    capacity = max(cap["req_per_s"], sat["served_per_s"])
    arms = []
    for factor in cfg["factors"]:
        row = open_loop_arm(model, example, cfg,
                            rate=max(1.0, capacity * factor), shed=True,
                            queue=cfg["queue"],
                            deadline_ms=cfg["deadline_ms"],
                            label=f"{factor:g}x_shed")
        row["load_factor"] = factor
        arms.append(row)
        say(open_loop=row)
    # the control's anchor is the fastest service rate seen so far; if
    # the queue still does not grow, the offered multiple escalates
    anchor = max([capacity] + [a["served_per_s"] for a in arms])
    control = None
    for mult in cfg["control_mults"]:
        control = open_loop_arm(model, example, cfg,
                                rate=max(1.0, anchor * mult), shed=False,
                                queue=None, deadline_ms=None,
                                label=f"{mult:g}x_control_no_shedding",
                                sample_queue=True)
        control["load_factor"] = mult
        say(open_loop=control)
        if control["pending_at_stop"] >= 4 * cfg["max_batch"]:
            break
    p99 = {a["load_factor"]: a["latency_ms_p99"] for a in arms}
    p99_1x, p99_2x = p99.get(1.0), p99.get(2.0)
    acceptance = {
        "p99_1x_ms": p99_1x, "p99_2x_shed_ms": p99_2x,
        "p99_2x_control_ms": control["latency_ms_p99"],
        "p99_ratio_2x_over_1x": p99_2x / p99_1x
        if p99_1x and p99_2x is not None else None,
        "bounded_under_overload": bool(
            p99_1x and p99_2x is not None and p99_2x <= 2.0 * p99_1x),
        "control_collapse_factor": control["latency_ms_p99"] / p99_1x
        if p99_1x and control["latency_ms_p99"] else None,
    }
    say(acceptance=acceptance)
    doctor = run_doctor_pass(model, example, cfg, max(1.0, capacity))
    return {"engine": f"in-process Server over an exported MLP artifact "
                      f"(784-{'x'.join(map(str, cfg['hidden']))}-10, fp32)",
            "config": cfg, "closed_loop": cap, "saturation_probe": sat,
            "capacity_req_per_s": capacity, "open_loop": arms,
            "control": control, "acceptance": acceptance,
            "doctor": doctor, "device": device_label(place),
            "smoke": bool(smoke)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="short arms and a narrow MLP (numbers "
                         "meaningless); writes a results file only with "
                         "--out")
    ap.add_argument("--duration-s", type=float, default=None)
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--max-wait-ms", type=float, default=None)
    ap.add_argument("--queue", type=int, default=None,
                    help="admission queue capacity (the shedding arms' "
                         "latency bound is about queue / throughput)")
    ap.add_argument("--deadline-ms", type=float, default=None)
    ap.add_argument("--workers", type=int, default=None,
                    help="the closed-loop capacity probe's concurrency")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None, help="results path (default "
                    "build/serving_results.json)")
    args = ap.parse_args(argv)
    cfg = dict(SMOKE if args.smoke else FULL)
    for key in ("duration_s", "max_batch", "max_wait_ms", "queue",
                "deadline_ms", "workers"):
        if getattr(args, key) is not None:
            cfg[key] = getattr(args, key)
    row = run_all(cfg, smoke=args.smoke,
                  device="cpu" if args.device == "cpu" else None)
    print(json.dumps(row, indent=1))
    write_results(args.out, args.smoke, "serving_results.json",
                  "serving_load", row)
    return row


if __name__ == "__main__":
    main()
