"""The command line (counterpart of ``paddle_tpu/cli.py``, the ``paddle
train`` analog; reference: trainer/TrainerMain.cpp, FLAGS_job one of
train/test/checkgrad/time, trainer.init(config) + ParamUtil save/load).

``python -m paddle_tpu_torch --config=conf.py --job=train`` evaluates a v1
config file verbatim (``trainer_config_helpers``), builds the optimizer
from its settings(), and runs the job with the port's executor on
``--device`` (``cuda``, the default, or ``cpu``; with no card and no
``--device cpu`` it raises, as ``CUDAPlace`` does):

  train      steps over feeds, prints per-pass loss, saves params
  test       loads params, evaluates the config outputs on feeds
  time       TrainerMain's timing job: one untimed window (warm-up and
             the step's capture), one timed window ending on the card's
             completion, ms/batch
  checkgrad  central difference against autodiff on the config's cost,
             in float64 (``Executor(compute_dtype="float64")``; float64
             convolutions take the plain route)

The subcommands, each loaded only when named:

  check      the static program verifier (``analysis``) over a
             ``Program.to_json`` file, a ``save_inference_model``
             ``__model__`` meta, a directory holding one, or a v1 config
             (``--config``); ``--mesh``, ``--specs``, ``--strict``,
             ``--concurrency`` (the PT05x pass over the port's host
             source); exit 1 on errors, and on warnings with ``--strict``
  plan       the sharding planner (``analysis.planner``, ranked with the
             H100 cost constants); ``--out plan.json`` for ``check
             --specs``
  stats      summarize JSONL observability logs (``--json``, ``--prom``)
  trace      span timelines and critical paths of those logs
  doctor     where the step or request time went (``--program``,
             ``--per-op`` replays it op by op on ``--device``)
  profile    the per-op profiler (``observability.opprof``) over a
             program or a v1 config's training step on ``--device``;
             ``--compiled-check`` places the step built ahead of its
             first call (``Executor.compile``) beside the memory view
  tune, serve, fleet, fleet-stats, elastic, pserver
             the autotuner, the serving runtime and fleet, the fleet
             collector, the elastic service and a sparse shard

Feeds come from ``--feed-npz`` (named arrays matching the config's data
layers, with ``name@LEN`` companions for sequences) and go to the device
once; without it the jobs synthesize random feeds from the declared
shapes, drawing what the JAX command line draws (the reference's
fake-data provider role).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional

import numpy as np

def _parse_config_args(s: Optional[str]) -> Dict[str, str]:
    """``--config_args k=v,k2=v2`` as a dict."""
    if not s:
        return {}
    out = {}
    for kv in s.split(","):
        k, _, v = kv.partition("=")
        out[k.strip()] = v.strip()
    return out


def _load_feeds(path: Optional[str]):
    if not path:
        return None
    data = np.load(path, allow_pickle=False)
    return {k: data[k] for k in data.files}


def _synth_feeds(cfg, batch: int, seed: int = 0, seq_len: int = 12):
    """Random feeds shaped from the config's data layers (the fake-data
    provider TrainerMain's time job leaned on), in the JAX command
    line's draw order."""
    rng = np.random.RandomState(seed)
    feeds = {}
    for name, v in cfg.data_layers.items():
        if v.dtype == "int64":
            vocab = getattr(v, "v1_size", None) or 2
            if v.lod_level:
                T = seq_len
                feeds[name] = rng.randint(0, vocab, (batch, T))
                feeds[name + "@LEN"] = np.full(batch, T)
            else:
                # label-style: v1 size is the number of classes
                feeds[name] = rng.randint(0, max(vocab, 2), (batch, 1))
        else:
            dims = [int(d) for d in (v.shape or (1,))[1:] if d and d > 0]
            feeds[name] = rng.rand(batch, *dims).astype("float32")
    return feeds


def _used_feed_names(cfg):
    """Data layers actually consumed by ops (a config may declare inputs
    the network never reads, e.g. rnn_crf's 'features')."""
    used = set()
    for op in cfg.main_program.global_block().ops:
        for names in op.inputs.values():
            used.update(names)
    out = set()
    for n in cfg.data_layers:
        if n in used:
            out.add(n)
            out.add(n + "@LEN")
    return out


def _place(device: str):
    from .core.executor import CPUPlace, CUDAPlace
    return CPUPlace() if device == "cpu" else CUDAPlace(0)


def job_train(cfg, exe, feeds, args):
    from . import io

    loss = cfg.minimize_outputs()
    exe.run(cfg.startup_program, feed={}, fetch_list=[])
    if args.init_model_path:
        io.load_persistables(exe, args.init_model_path, cfg.main_program)
    steps = args.steps_per_pass
    # --start_pass resume semantics (Flags.cpp:81, TrainerMain.cpp:25):
    # saved pass dirs keep their true index; num_passes is the TOTAL pass
    # index bound, so resuming past it is a usage error, not a no-op
    if not 0 <= args.start_pass < args.num_passes:
        raise SystemExit(
            f"--start_pass={args.start_pass} must be in [0, "
            f"--num_passes={args.num_passes}) — num_passes is the total "
            f"pass count, not additional passes")
    for p in range(args.start_pass, args.num_passes):
        # one dispatch per pass: on a card, steps replays of the
        # captured step
        (vals,) = exe.run_steps(steps, cfg.main_program, feed=feeds,
                                fetch_list=[loss])
        vals = np.asarray(vals).reshape(-1)
        print(json.dumps({"pass": p, "loss": float(vals[-1]),
                          "mean_loss": float(np.mean(vals))}), flush=True)
        if args.save_dir:
            d = os.path.join(args.save_dir, f"pass-{p:05d}")
            os.makedirs(d, exist_ok=True)
            io.save_persistables(exe, d, cfg.main_program)
    return 0


def job_test(cfg, exe, feeds, args):
    from . import io

    exe.run(cfg.startup_program, feed={}, fetch_list=[])
    if args.init_model_path:
        io.load_persistables(exe, args.init_model_path, cfg.main_program)
    outs = exe.run(cfg.main_program, feed=feeds, fetch_list=cfg.outputs,
                   is_test=True)
    for var, val in zip(cfg.outputs, outs):
        name = getattr(var, "name", str(var))
        print(json.dumps({"output": name,
                          "mean": float(np.mean(val)),
                          "shape": list(np.shape(val))}), flush=True)
    return 0


def job_time(cfg, exe, feeds, args):
    """TrainerMain's timing job by the JAX command line's window method:
    the timed window is ONE ``run_steps`` dispatch, so host dispatch
    latency is out of the measurement, and it ends when the card has
    finished (reading its last loss waits for the device)."""
    cfg.minimize_outputs()
    loss = cfg.outputs[0]
    exe.run(cfg.startup_program, feed={}, fetch_list=[])
    # the untimed window MUST have the timed one's length: it is the
    # warm-up and the capture of the step the timed window replays
    (lv,) = exe.run_steps(args.iters, cfg.main_program, feed=feeds,
                          fetch_list=[loss], return_numpy=False)
    # reading the value is the barrier (an assert would vanish under
    # python -O and the window would time an asynchronous return)
    if not np.isfinite(float(lv[-1])):
        raise FloatingPointError("non-finite loss during warmup window")
    t0 = time.perf_counter()
    (lv,) = exe.run_steps(args.iters, cfg.main_program, feed=feeds,
                          fetch_list=[loss], return_numpy=False)
    last = float(lv[-1])
    dt = (time.perf_counter() - t0) / args.iters
    if not np.isfinite(last):
        raise FloatingPointError("non-finite loss during timed window")
    print(json.dumps({"ms_per_batch": round(dt * 1e3, 3),
                      "batches_per_sec": round(1.0 / dt, 2)}), flush=True)
    return 0


def job_checkgrad(cfg, exe, feeds, args, eps=1e-4, rtol=1e-3):
    """Central difference against autodiff on the config's cost
    (Trainer::checkGradient): perturb a few elements of the first
    parameters.  Backward ONLY (no optimizer ops), so probe runs do not
    move the weights they probe.

    The whole comparison runs in FLOAT64 on ``exe``'s device
    (``Executor(compute_dtype="float64")``): at eps=1e-4 the float64
    central difference is accurate to ~1e-8, so the 1e-3 tolerance tests
    the ops, as the reference's double-precision checkgrad job does.
    Float64 convolutions take the plain route (no kernel takes them)."""
    import torch

    from .backward import append_backward
    from .core.executor import Executor
    from .core.program import grad_var_name, program_guard
    from .core.scope import global_scope

    exe = Executor(exe.place, compute_dtype="float64")
    loss = cfg.outputs[0]
    with program_guard(cfg.main_program, cfg.startup_program):
        append_backward(loss)
    exe.run(cfg.startup_program, feed={}, fetch_list=[])
    scope = global_scope()
    params = [v.name for v in
              cfg.main_program.global_block().vars.values()
              if v.persistable and scope.has(v.name) and
              torch.is_floating_point(scope.get(v.name))][:3]
    if not params:
        print(json.dumps({"checkgrad": "FAIL",
                          "error": "no floating parameters found"}),
              flush=True)
        return 1

    def put(pname, w):
        scope.set(pname, torch.from_numpy(w).to(exe.device))

    failures = 0
    rng = np.random.RandomState(0)
    for pname in params:
        g, = exe.run(cfg.main_program, feed=feeds,
                     fetch_list=[grad_var_name(pname)])
        w0 = scope.numpy(pname).copy()
        flat = w0.ravel()
        for idx in rng.choice(flat.size, size=min(3, flat.size),
                              replace=False):
            for sign, store in ((+1, "hi"), (-1, "lo")):
                w = flat.copy()
                w[idx] += sign * eps
                put(pname, w.reshape(w0.shape))
                val = float(exe.run(cfg.main_program, feed=feeds,
                                    fetch_list=[loss], is_test=False)[0])
                if store == "hi":
                    hi = val
                else:
                    lo = val
            put(pname, w0)
            num = (hi - lo) / (2 * eps)
            ana = float(np.asarray(g).ravel()[idx])
            ok = abs(num - ana) <= rtol * max(1.0, abs(num), abs(ana))
            if not ok:
                failures += 1
            print(json.dumps({"param": pname, "index": int(idx),
                              "numeric": num, "autodiff": ana,
                              "ok": bool(ok)}), flush=True)
    print(json.dumps({"checkgrad": "PASS" if failures == 0 else "FAIL",
                      "failures": failures}), flush=True)
    return 0 if failures == 0 else 1


def _parse_mesh(s: Optional[str]) -> Optional[Dict[str, int]]:
    """'dp=8,mp=2' -> {'dp': 8, 'mp': 2} for the sharding lints."""
    if not s:
        return None
    out: Dict[str, int] = {}
    for kv in s.split(","):
        k, _, v = kv.partition("=")
        try:
            size = int(v)
        except ValueError:
            raise SystemExit(f"--mesh: bad axis entry {kv!r} "
                             f"(want name=size,...)")
        if size < 1:
            # size <= 1 axes are skipped by the divisibility lints, so a
            # typo'd dp=0 would silently validate nothing and PASS
            raise SystemExit(f"--mesh: axis size must be >= 1, got {kv!r}")
        k = k.strip()
        if k in out:
            # dp=8,dp=2 (typo for dp=8,mp=2) would silently lint against
            # the last size only
            raise SystemExit(f"--mesh: duplicate axis {k!r}")
        out[k] = size
    return out


def _load_check_target(path: str):
    """(program, fetch_names) from a program JSON / __model__ meta / dir."""
    from .core.program import Program

    if os.path.isdir(path):
        path = os.path.join(path, "__model__")
    try:
        with open(path) as f:
            d = json.load(f)
    except OSError as e:
        raise SystemExit(f"check: cannot read program {path!r}: {e}")
    except json.JSONDecodeError as e:
        raise SystemExit(f"check: {path!r} is not a program JSON "
                         f"(Program.to_json or save_inference_model "
                         f"__model__): {e}")
    try:
        if "program" in d:     # save_inference_model meta
            return Program.from_dict(d["program"]), d.get("fetch_var_names")
        return Program.from_dict(d), None
    except (KeyError, TypeError, ValueError) as e:
        raise SystemExit(f"check: {path!r} does not deserialize as a "
                         f"Program: {type(e).__name__}: {e}")


def _load_plan_file(path: str):
    """plan.json (analysis.planner.Plan.to_dict output) -> Plan."""
    from .analysis.planner import Plan

    try:
        with open(path) as f:
            d = json.load(f)
    except OSError as e:
        raise SystemExit(f"check: cannot read plan {path!r}: {e}")
    except json.JSONDecodeError as e:
        raise SystemExit(f"check: {path!r} is not a plan JSON "
                         f"(paddle_tpu_torch plan --out output): {e}")
    try:
        return Plan.from_dict(d)
    except (KeyError, TypeError, ValueError) as e:
        raise SystemExit(f"check: {path!r} does not deserialize as a "
                         f"sharding plan: {type(e).__name__}: {e}")


def job_check(argv):
    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch check",
        description="static program verifier: shape/dtype inference, "
                    "well-formedness and graph lints with stable PT0xx "
                    "codes (the desc-layer InferShape analog; see "
                    "paddle_tpu_torch.analysis)")
    ap.add_argument("program", nargs="?", default=None,
                    help="Program.to_json file, save_inference_model "
                         "__model__ meta, or a directory containing one")
    ap.add_argument("--config", default=None,
                    help="verify a v1 config's built programs instead")
    ap.add_argument("--config_args", default=None,
                    help="k=v,... forwarded to get_config_arg")
    ap.add_argument("--mesh", default=None,
                    help="axis=size,... — enables the sharding lints "
                         "(PT030/PT031/PT040) against this mesh")
    ap.add_argument("--specs", default=None,
                    help="plan.json (from `paddle_tpu_torch plan --out`): "
                         "validate its param/feed specs against the "
                         "program — a CI gate for a committed plan; the "
                         "plan's own mesh applies when --mesh is omitted")
    ap.add_argument("--strict", action="store_true",
                    help="exit nonzero on warnings too")
    ap.add_argument("--concurrency", action="store_true",
                    help="run the PT05x lock-discipline pass over the "
                         "paddle_tpu_torch host source tree instead of a "
                         "program (analysis.concurrency): findings "
                         "beyond the frozen baseline fail the check")
    args = ap.parse_args(argv)
    if args.concurrency:
        if args.program is not None or args.config is not None:
            ap.error("--concurrency analyzes the host source tree; "
                     "it takes no program/--config")
        from .analysis import concurrency as _cc
        findings = _cc.analyze_package()
        new, suppressed, stale = _cc.apply_baseline(findings)
        print(_cc.render_report(findings), flush=True)
        warn_new = [f for f in new
                    if _cc.CODES[f.code][0] != "error"]
        err_new = [f for f in new if _cc.CODES[f.code][0] == "error"]
        failed = bool(err_new or stale
                      or (args.strict and warn_new))
        print(json.dumps({"check": "FAIL" if failed else "PASS",
                          "findings": len(findings),
                          "new": len(new), "stale": len(stale),
                          "baselined": sum(suppressed.values())}),
              flush=True)
        return 1 if failed else 0
    if (args.program is None) == (args.config is None):
        ap.error("give exactly one of a program file or --config")

    mesh = _parse_mesh(args.mesh)
    param_specs = feed_specs = None
    if args.specs is not None:
        plan_obj = _load_plan_file(args.specs)
        param_specs = plan_obj.param_specs
        feed_specs = plan_obj.feed_specs
        if mesh is None:
            mesh = plan_obj.mesh_axes
    targets = []                 # (label, program, fetch_list)
    if args.config is not None:
        from .trainer_config_helpers import load_v1_config
        cfg = load_v1_config(args.config,
                             **_parse_config_args(args.config_args))
        targets.append(("main", cfg.main_program, cfg.outputs))
        targets.append(("startup", cfg.startup_program, None))
    else:
        program, fetch_names = _load_check_target(args.program)
        targets.append((args.program, program, fetch_names))

    errors = warnings_ = 0
    for label, program, fetch_list in targets:
        report = program.validate(fetch_list=fetch_list, mesh=mesh,
                                  param_specs=param_specs,
                                  feed_specs=feed_specs)
        errors += len(report.errors)
        warnings_ += len(report.warnings)
        print(f"== {label}: {report.render()}", flush=True)
    print(json.dumps({"check": "FAIL" if errors or
                      (args.strict and warnings_) else "PASS",
                      "errors": errors, "warnings": warnings_}),
          flush=True)
    return 1 if errors or (args.strict and warnings_) else 0


def job_plan(argv):
    """Sharding planner: propose specs for a program and a mesh."""
    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch plan",
        description="static sharding planner "
                    "(paddle_tpu_torch.analysis.planner): propose "
                    "param_specs/feed_specs for a serialized program and "
                    "a mesh, print the cost breakdown (one H100's "
                    "constants) and the per-device peak-memory estimate — "
                    "pure static analysis, no card required.  The "
                    "emitted plan passes the PT030/PT031 sharding lints "
                    "by construction; validate a committed plan later "
                    "with `paddle_tpu_torch check prog.json --specs "
                    "plan.json`.")
    ap.add_argument("program",
                    help="Program.to_json file, save_inference_model "
                         "__model__ meta, or a directory containing one")
    ap.add_argument("--mesh", required=True,
                    help="axis=size,... (e.g. dp=8 or dp=4,tp=2)")
    ap.add_argument("--batch", type=int, default=64,
                    help="batch assumed for symbolic -1 dims in the cost "
                         "model (default 64)")
    ap.add_argument("--batch-axis", default="dp",
                    help="mesh axis feeds shard their batch dim on "
                         "(default dp)")
    ap.add_argument("--json", action="store_true",
                    help="print the plan as ONE JSON object only")
    ap.add_argument("--out", default=None,
                    help="also write the plan JSON to this file")
    ap.add_argument("--calibration", default=None,
                    help="opprof calibration table (doctor/profile "
                         "--calibration-out output): rank candidates "
                         "with its per-op-class measured/predicted "
                         "ratios instead of the nominal constants alone")
    args = ap.parse_args(argv)

    from .analysis import planner

    mesh = _parse_mesh(args.mesh)
    program, _fetch_names = _load_check_target(args.program)
    ratios = None
    if args.calibration:
        from .observability import attribution
        try:
            ratios = attribution.load_op_class_ratios(args.calibration)
        except (OSError, ValueError) as e:
            raise SystemExit(f"plan: cannot load calibration "
                             f"{args.calibration!r}: {e}")
        if not ratios:
            # stderr: --json promises ONE JSON object on stdout
            print("plan: calibration table has no op-class rows; "
                  "ranking on nominal constants", file=sys.stderr,
                  flush=True)
    try:
        plan_obj = planner.plan(program, mesh, batch_axis=args.batch_axis,
                                assume_batch=args.batch,
                                op_class_ratios=ratios)
    except ValueError as e:
        raise SystemExit(f"plan: {e}")
    if args.out:
        try:
            with open(args.out, "w") as f:
                f.write(plan_obj.to_json())
        except OSError as e:
            raise SystemExit(f"plan: cannot write {args.out!r}: {e}")
    if args.json:
        print(json.dumps(plan_obj.to_dict(), sort_keys=True), flush=True)
    else:
        print(plan_obj.render(), flush=True)
        print(json.dumps({"plan": "OK", "candidate": plan_obj.candidate,
                          "params_sharded": len(plan_obj.param_specs),
                          "feeds_sharded": len(plan_obj.feed_specs)}),
              flush=True)
    return 0


def job_stats(argv):
    """Summarize JSONL observability logs (the metrics_log flag)."""
    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch stats",
        description="summarize one or more structured observability "
                    "logs (paddle_tpu_torch.observability, flag "
                    "metrics_log / env PADDLE_TPU_TORCH_METRICS_LOG): "
                    "step-time statistics, pipeline stall/busy numbers, "
                    "last metrics snapshot, NaN events.  Multiple files (a "
                    "supervised run's per-relaunch logs) merge in time "
                    "order with restart boundaries marked.")
    ap.add_argument("log", nargs="+", help="JSONL metrics log file(s)")
    ap.add_argument("--json", action="store_true",
                    help="print the summary as ONE JSON object only")
    ap.add_argument("--prom", action="store_true",
                    help="print the logs' LAST metrics snapshot in "
                         "Prometheus text exposition format and exit")
    args = ap.parse_args(argv)
    from .observability import export
    if args.prom:
        try:
            events, _files = export.iter_log_events(args.log)
        except OSError as e:
            raise SystemExit(f"stats: cannot read log: {e}")
        snap = next((e for e in reversed(events)
                     if e.get("kind") == "snapshot"), None)
        if snap is None:
            raise SystemExit(
                "stats --prom: no snapshot events in the log — run with "
                "observe on and periodic reports (log_period), or call "
                "observability.periodic_report()")
        print(export.to_prometheus(snap), end="", flush=True)
        return 0
    try:
        summary = export.summarize_logs(args.log)
    except OSError as e:
        raise SystemExit(f"stats: cannot read log: {e}")
    if not args.json:
        print(export.render_summary(summary), flush=True)
    print(json.dumps(summary, default=repr), flush=True)
    return 0


def job_trace(argv):
    """Reconstruct per-trace timelines from a span-carrying JSONL log."""
    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch trace",
        description="replay the tracing spans of one or more "
                    "observability logs (paddle_tpu_torch.observability."
                    "tracing): per-trace timelines, the critical path of "
                    "the longest trace, and p50/p99 latency by span "
                    "name.  Multiple files merge in time order (a "
                    "resumed job's logs read as one).")
    ap.add_argument("log", nargs="+", help="JSONL metrics log file(s)")
    ap.add_argument("--json", action="store_true",
                    help="print ONE JSON object only")
    ap.add_argument("--limit", type=int, default=5,
                    help="timelines rendered (largest traces first; "
                         "default 5)")
    args = ap.parse_args(argv)
    from .observability import export, tracing
    try:
        events, files = export.iter_log_events(args.log)
    except OSError as e:
        raise SystemExit(f"trace: cannot read log: {e}")
    traces = tracing.build_traces(events)
    stats = tracing.span_stats(events)
    if args.json:
        print(json.dumps({
            "files": files, "traces": len(traces), "span_stats": stats,
            "critical_path": [
                {"name": s["name"], "dur_ms": s.get("dur_ms")}
                for s in tracing.critical_path(
                    max(traces, key=lambda t: t["dur_ms"]))]
            if traces else [],
        }, default=repr), flush=True)
        return 0
    if not traces:
        print("no spans in this log — run with observe on and a "
              "metrics_log set", flush=True)
        return 0
    print(f"{len(traces)} trace(s), {sum(len(t['spans']) for t in traces)}"
          f" span(s)", flush=True)
    if len(files) > 1:
        for f in files:
            # [role:index] when the log stamped identity: a merged fleet
            # trace names which process each file came from
            print(f"  restart boundary: [{export.source_label(f)}] "
                  f"{f['file']} ({f['events']} event(s), from "
                  f"ts={f['t_first']})", flush=True)
    print("\nby span name:", flush=True)
    for name, s in stats.items():
        print(f"  {name}: count={s['count']} p50={s['p50_ms']}ms "
              f"p99={s['p99_ms']}ms max={s['max_ms']}ms "
              f"total={s['total_ms']}ms", flush=True)
    big = sorted(traces, key=lambda t: -t["dur_ms"])[:args.limit]
    for t in big:
        print("\n" + tracing.render_trace(t), flush=True)
    longest = max(traces, key=lambda t: t["dur_ms"])
    cp = tracing.critical_path(longest)
    print("\ncritical path of the longest trace "
          f"({longest['trace']}):", flush=True)
    for s in cp:
        print(f"  {s['name']} ({s.get('dur_ms', 0.0)} ms)", flush=True)
    return 0


def job_doctor(argv):
    """Measured-vs-modeled step/request budget: where did the time go."""
    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch doctor",
        description="explain where the step (or request) time went: a "
                    "budget decomposing the measured wall into compute / "
                    "fetch / compile / staging / host-stall from the "
                    "log's step events and spans, the top bottleneck "
                    "with actionable hints, and — with --program — a "
                    "cost-model calibration row (predicted vs measured, "
                    "stored ratio for the planner).  Budget components "
                    "reconcile with the measured wall within the pinned "
                    "tolerance or the report says so.")
    ap.add_argument("log", nargs="+", help="JSONL metrics log file(s)")
    ap.add_argument("--program", default=None,
                    help="Program.to_json file / __model__ meta / dir: "
                         "confront the static cost model with this run")
    ap.add_argument("--batch", type=int, default=64,
                    help="batch assumed for symbolic -1 dims in the "
                         "static model (default 64)")
    ap.add_argument("--mesh", default=None,
                    help="axis=size,... the measured run was sharded "
                         "over (folds into the prediction)")
    ap.add_argument("--calibration-out", default=None,
                    help="merge the calibration row into this JSON "
                         "table (keyed by program digest; the planner-"
                         "consumable store).  With --per-op the per-"
                         "op-class rows merge into the same table")
    ap.add_argument("--per-op", action="store_true",
                    help="also run the eager per-op profiler "
                         "(observability.opprof) on --program and join "
                         "its measured/modeled table under the step "
                         "budget")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where --per-op replays the program (default "
                         "cuda)")
    ap.add_argument("--json", action="store_true",
                    help="print ONE JSON object only")
    args = ap.parse_args(argv)
    # lazy: the attribution engine pulls analysis.cost_model; only the
    # doctor pays for it
    from .observability import attribution
    program = None
    if args.program is not None:
        program, _fetch = _load_check_target(args.program)
    if args.per_op and program is None:
        ap.error("--per-op needs --program (the eager profiler replays "
                 "the program op by op)")
    try:
        report = attribution.doctor_report(
            args.log, program=program, assume_batch=args.batch,
            mesh_axes=_parse_mesh(args.mesh))
    except OSError as e:
        raise SystemExit(f"doctor: cannot read log: {e}")
    per_op = None
    if args.per_op:
        from .core.executor import Executor
        from .observability import opprof
        per_op = opprof.profile_program(
            program, executor=Executor(_place(args.device)),
            batch=args.batch, mesh_axes=_parse_mesh(args.mesh),
            modeled=True)
        report["per_op"] = per_op
    if args.calibration_out:
        try:
            if report.get("calibration"):
                attribution.save_calibration([report["calibration"]],
                                             args.calibration_out)
            if per_op is not None and per_op.get("op_classes"):
                attribution.save_op_class_calibration(
                    per_op["op_classes"], args.calibration_out)
        except OSError as e:
            raise SystemExit(
                f"doctor: cannot write {args.calibration_out!r}: {e}")
    if not args.json:
        print(attribution.render_doctor(report), flush=True)
        if per_op is not None:
            from .observability import opprof
            print(opprof.render_profile(per_op), flush=True)
    print(json.dumps(report, default=repr), flush=True)
    return 0


def job_profile(argv):
    """Per-op runtime profiler: measured vs modeled, op by op."""
    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch profile",
        description="eager per-op profiler + memory timeline "
                    "(paddle_tpu_torch.observability.opprof): replay one "
                    "step of a program op by op on --device at the "
                    "captured step's precision (CUDA events on the card), "
                    "join each op against the static cost model's FLOPs "
                    "and bytes (roofline verdict, measured/predicted "
                    "ratio), rank the op classes that lose most against "
                    "the model, and walk the liveness order for the "
                    "measured live-bytes curve against the modeled peak.  "
                    "The per-op table must sum to the eager-replay total "
                    "within the pinned tolerance or the report says so.  "
                    "--calibration-out commits the per-op-class "
                    "calibration table `paddle_tpu_torch plan "
                    "--calibration` consumes.")
    ap.add_argument("program", nargs="?", default=None,
                    help="Program.to_json file, save_inference_model "
                         "__model__ meta, or a directory containing one")
    ap.add_argument("--config", default=None,
                    help="profile a v1 config's TRAINING step instead "
                         "(minimize_outputs + startup-initialized "
                         "parameters)")
    ap.add_argument("--config_args", default=None,
                    help="k=v,... forwarded to get_config_arg")
    ap.add_argument("--batch", type=int, default=64,
                    help="batch for synthesized feeds and the static "
                         "model's symbolic -1 dims (default 64)")
    ap.add_argument("--seq-len", type=int, default=8,
                    help="synthesized sequence length for lod feeds "
                         "(default 8)")
    ap.add_argument("--reps", type=int, default=2,
                    help="timed windows per op (median; default 2)")
    ap.add_argument("--warmup", type=int, default=1,
                    help="discarded warmup windows per op (default 1)")
    ap.add_argument("--top", type=int, default=10,
                    help="rows in the rendered top-ops table "
                         "(default 10)")
    ap.add_argument("--mesh", default=None,
                    help="axis=size,... folded into the static model's "
                         "per-device estimates")
    ap.add_argument("--is-test", action="store_true",
                    help="profile the inference form of the step")
    ap.add_argument("--compiled-check", action="store_true",
                    help="cross-check the memory view against the step "
                         "built ahead of its first call (Executor.compile "
                         "in a throwaway executor): its graph pool bytes "
                         "and the allocator's peak during the capture; "
                         "none on the CPU")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the step replays (default cuda)")
    ap.add_argument("--json", action="store_true",
                    help="print ONE JSON object only")
    ap.add_argument("--calibration-out", default=None,
                    help="merge the per-op-class calibration rows into "
                         "this JSON table (the planner-consumable "
                         "store; `paddle_tpu_torch plan --calibration`)")
    args = ap.parse_args(argv)
    if (args.program is None) == (args.config is None):
        ap.error("give exactly one of a program file or --config")

    # lazy: the per-op profiler pulls analysis.cost_model; only the
    # profiler pays for it
    from .core.executor import Executor
    from .observability import opprof

    kw = dict(batch=args.batch, seq_len=args.seq_len, reps=args.reps,
              warmup=args.warmup, top=args.top, is_test=args.is_test,
              mesh_axes=_parse_mesh(args.mesh), modeled=True,
              compiled_check=args.compiled_check)
    exe = Executor(_place(args.device))
    if args.config is not None:
        from .trainer_config_helpers import load_v1_config
        cfg = load_v1_config(args.config,
                             **_parse_config_args(args.config_args))
        cfg.minimize_outputs()
        exe.run(cfg.startup_program, feed={}, fetch_list=[])
        feeds = _synth_feeds(cfg, args.batch, seq_len=args.seq_len)
        used = _used_feed_names(cfg)
        feeds = {k: v for k, v in feeds.items() if k in used}
        report = opprof.profile_program(cfg.main_program, executor=exe,
                                        feed=feeds, **kw)
    else:
        program, _fetch = _load_check_target(args.program)
        report = opprof.profile_program(program, executor=exe, **kw)
    if args.calibration_out and report.get("op_classes"):
        from .observability import attribution
        try:
            attribution.save_op_class_calibration(
                report["op_classes"], args.calibration_out)
        except OSError as e:
            raise SystemExit(
                f"profile: cannot write {args.calibration_out!r}: {e}")
    if not args.json:
        print(opprof.render_profile(report, top=args.top), flush=True)
    print(json.dumps(report, default=repr), flush=True)
    return 0


_SUBCOMMANDS = ("check", "plan", "stats", "trace", "doctor", "profile",
                "tune", "serve", "fleet", "fleet-stats", "elastic",
                "pserver")


def _subcommand(name, argv):
    """Run subcommand ``name``; each module is imported only here, so
    importing the package never loads the verifier, the attribution
    engine, the profiler, the autotuner, a socket stack, the serving
    fleet or the elastic service."""
    if name == "check":
        return job_check(argv)
    if name == "plan":
        return job_plan(argv)
    if name == "stats":
        return job_stats(argv)
    if name == "trace":
        return job_trace(argv)
    if name == "doctor":
        return job_doctor(argv)
    if name == "profile":
        return job_profile(argv)
    if name == "tune":
        from .tuning.cli import tune_main
        return tune_main(argv)
    if name == "serve":
        from .serving.cli import serve_main
        return serve_main(argv)
    if name == "fleet":
        from .serving.fleet import fleet_main
        return fleet_main(argv)
    if name == "fleet-stats":
        from .observability.collector import fleet_stats_main
        return fleet_stats_main(argv)
    if name == "elastic":
        from .distributed.elastic import elastic_main
        return elastic_main(argv)
    from .sparse.pserver import pserver_main
    return pserver_main(argv)


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    argv = list(argv)
    if argv and argv[0] in _SUBCOMMANDS:
        return _subcommand(argv[0], argv[1:])
    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch",
        description="TrainerMain analog: run a v1 config with the port's "
                    "executor on --device (default cuda).  Subcommands "
                    "also exist: `check prog.json|__model__|dir` runs the "
                    "static program verifier, `plan prog.json --mesh "
                    "dp=8` proposes sharding specs with a static cost "
                    "breakdown, `stats run.jsonl...` summarizes "
                    "observability metrics logs (--prom for Prometheus "
                    "exposition), `fleet-stats <logs|dir|host:port...>` "
                    "merges per-process metrics snapshots, `trace "
                    "run.jsonl...` renders span timelines and critical "
                    "paths, `doctor run.jsonl... [--program prog.json] "
                    "[--per-op]` explains where the step or request time "
                    "went, `profile prog.json|--config conf.py` measures "
                    "every op against the static model, `tune <target>` "
                    "searches and persists autotuner winners, `serve "
                    "--model dir` and `fleet --model dir --replicas N` "
                    "serve exported artifacts, `elastic --config conf.py "
                    "--data 'parts/*' --workers K --root dir` runs the "
                    "elastic training service, and `pserver --shard k/N` "
                    "one sparse parameter-server shard (see "
                    "`paddle_tpu_torch " + "|".join(_SUBCOMMANDS) +
                    " --help`).")
    ap.add_argument("--config", required=True, help="v1 config file")
    ap.add_argument("--job", default="train",
                    choices=["train", "test", "time", "checkgrad"])
    ap.add_argument("--config_args", default=None,
                    help="k=v,... forwarded to get_config_arg")
    ap.add_argument("--feed-npz", default=None,
                    help="npz of named feed arrays (+ name@LEN)")
    ap.add_argument("--batch", type=int, default=None,
                    help="synthetic-feed batch (default: settings batch)")
    ap.add_argument("--num_passes", type=int, default=1)
    ap.add_argument("--start_pass", type=int, default=0,
                    help="resume pass numbering (use with "
                         "--init_model_path)")
    ap.add_argument("--steps_per_pass", type=int, default=10)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seq_len", type=int, default=12,
                    help="synthetic-feed sequence length")
    ap.add_argument("--save_dir", default=None)
    ap.add_argument("--init_model_path", default=None)
    ap.add_argument("--use_amp", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the job runs (default cuda; without a "
                         "card it raises)")
    args = ap.parse_args(argv)

    from .core.executor import Executor
    from .trainer_config_helpers import load_v1_config

    # the executor first: without a card and without --device cpu, the
    # job raises before any work
    exe = Executor(_place(args.device), amp=args.use_amp)
    cfg = load_v1_config(args.config, **_parse_config_args(args.config_args))
    batch = args.batch or cfg.settings.get("batch_size") or 16
    feeds = _load_feeds(args.feed_npz) or _synth_feeds(
        cfg, batch, seq_len=args.seq_len)
    used = _used_feed_names(cfg)
    # on the device ONCE, in each data layer's dtype: re-uploading a big
    # batch every dispatch would dominate job=time's measurement
    gb = cfg.main_program.global_block()
    feeds = {k: exe._feed_tensor(gb, k, v) for k, v in feeds.items()
             if k in used}
    job = {"train": job_train, "test": job_test, "time": job_time,
           "checkgrad": job_checkgrad}[args.job]
    return job(cfg, exe, feeds, args)


if __name__ == "__main__":
    sys.exit(main())
