"""The port's elastic service under chaos, with real worker subprocesses
on the CPU (``--device cpu``): the three rounds of
``tests/test_elastic_chaos.py`` on the port.

* **SIGKILL mid-pass, fixed world**: every worker SIGKILLed once by
  fault injection and relaunched; no task lost; the merged per-slot
  event streams and the final merged checkpoint equal the uninterrupted
  run's, bit for bit.
* **Permanent worker loss, shrink, regrow**: a slot past its restart
  budget shrinks the world with a committed resize record (re-plan
  lint-clean); a scale request regrows it; every task trained once.
* **Coordinator SIGTERM, drain, idempotent resume**: ``python -m
  paddle_tpu_torch elastic`` commits its job record and exits
  ``EXIT_PREEMPTED``; rerunning the same command finishes the job.

And the import guard's counterpart: a fresh interpreter importing
``paddle_tpu_torch`` and ``paddle_tpu_torch.distributed`` loads neither
``distributed.elastic`` nor ``distributed.master``.  Every test starts
processes and is ``@slow``.
"""
import hashlib
import json
import os
import pickle
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from paddle_tpu_torch.faults import EXIT_PREEMPTED

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_TIMEOUT = 420

CONF = """
settings(batch_size=4, learning_rate=0.1,
         learning_method=MomentumOptimizer(momentum=0.9))
x = data_layer('x', 8)
y = data_layer('label', 3)
h = fc_layer(input=x, size=16, act=ReluActivation())
out = fc_layer(input=h, size=3, act=SoftmaxActivation())
outputs(classification_cost(input=out, label=y))
"""


def _setup(tmp_path, n_chunks=6, recs=16):
    conf = tmp_path / "conf.py"
    conf.write_text(CONF)
    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.RandomState(42)
    for i in range(n_chunks):
        out = [(rng.rand(8).astype("float32"),
                rng.randint(0, 3, (1,)).astype("int64"))
               for _ in range(recs)]
        with open(data / f"part-{i:03d}.pickle", "wb") as f:
            pickle.dump(out, f)
    return str(conf), sorted(str(p) for p in data.glob("part-*.pickle"))


def _env(extra=None):
    env = dict(os.environ)
    env.pop("PADDLE_TPU_FAULT_SPEC", None)
    env.pop("PADDLE_TPU_TORCH_METRICS_LOG", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if extra:
        env.update(extra)
    return env


def _job(conf, chunks, root, workers, events_dir, env=None, **kw):
    from paddle_tpu_torch.distributed.elastic import (
        ElasticConfig, ElasticJob, _worker_argv_for_config)
    from paddle_tpu_torch.trainer_config_helpers import load_v1_config
    cfg = load_v1_config(conf)
    kw.setdefault("task_timeout_s", 60.0)
    kw.setdefault("heartbeat_lease_s", 30.0)
    kw.setdefault("drain_timeout_s", 180.0)
    return ElasticJob(ElasticConfig(
        workers=workers, data=list(chunks), root=str(root),
        worker_cmd=_worker_argv_for_config(conf, 4,
                                           events_dir=str(events_dir),
                                           device="cpu"),
        program=cfg.main_program, env=_env(env), **kw))


def _events(events_dir):
    """{slot: {(generation, stream index): cost hex}}; a replayed batch
    (a relaunch after a hard kill) must carry its first run's cost bit
    for bit."""
    out = {}
    for p in sorted(events_dir.glob("slot-*.jsonl")):
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    e = json.loads(line)
                except json.JSONDecodeError:
                    continue          # torn final line from a SIGKILL
                slot = out.setdefault(e["slot"], {})
                key = (e["epoch"], e["e"])
                if key in slot:
                    assert slot[key] == e["c"], \
                        f"replayed batch {(e['slot'],) + key} diverged"
                slot[key] = e["c"]
    return out


def _final_sha(root):
    """sha256 of the job's final merged parameters (the float vars and
    counters; the TrainState is left out)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.train_state import TRAIN_STATE_VAR
    sc = ptt.Scope()
    CheckpointManager(os.path.join(str(root), "final"),
                      device="cpu").restore(scope=sc)
    h = hashlib.sha256()
    for name in sorted(sc.keys()):
        if name == TRAIN_STATE_VAR:
            continue
        h.update(name.encode())
        h.update(sc.numpy(name).tobytes())
    return h.hexdigest()


def _records(root):
    with open(os.path.join(str(root), "records.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.mark.timeout(900)
def test_sigkill_relaunch_bit_identity_fixed_world(tmp_path):
    """At a fixed world, a run where every worker is SIGKILLed once
    mid-pass and relaunched gives the uninterrupted run's fetches and
    final checkpoint bit for bit."""
    conf, chunks = _setup(tmp_path)

    base_ev = tmp_path / "ev-base"
    base_ev.mkdir()
    job = _job(conf, chunks, tmp_path / "job-base", 2, base_ev)
    s = job.run()
    assert s["completed"] and s["resizes"] == 0
    baseline = _events(base_ev)
    base_sha = _final_sha(tmp_path / "job-base")
    assert len(baseline[0]) + len(baseline[1]) == 24   # 6 tasks x 4

    kill_ev = tmp_path / "ev-kill"
    kill_ev.mkdir()
    # every worker hard-dies at its global batch 5 (index-matched on the
    # RESTORED counter, so the relaunch cannot re-fire it)
    job2 = _job(conf, chunks, tmp_path / "job-kill", 2, kill_ev,
                env={"PADDLE_TPU_FAULT_SPEC": "elastic.worker@5=kill"},
                max_restarts=3)
    s2 = job2.run()
    assert s2["completed"] and s2["resizes"] == 0
    killed = _events(kill_ev)
    # merged (replay-deduped inside _events) == baseline, bit-identical
    assert killed == baseline
    assert _final_sha(tmp_path / "job-kill") == base_sha
    assert s2["task_stats"]["done"] == 6               # zero task loss


@pytest.mark.timeout(900)
def test_permanent_loss_shrinks_then_regrows(tmp_path):
    """Worker lost past its restart budget => shrink resize with a
    committed boundary record (plan lint-clean); a scale request
    regrows; the job completes with exactly-once task accounting."""
    conf, chunks = _setup(tmp_path, n_chunks=8)
    ev = tmp_path / "ev"
    ev.mkdir()
    job = _job(conf, chunks, tmp_path / "job", 3, ev, max_restarts=0)
    job.start()
    result = {}

    def run():
        result["summary"] = job.run()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    # murder slot 2 once some work is committed; restarts are exhausted
    # immediately (max_restarts=0) -> shrink to world 2
    deadline = time.time() + RUN_TIMEOUT
    while time.time() < deadline and job.master.stats()["done"] < 2:
        time.sleep(0.2)
    proc = job._procs.get(2)
    if proc is not None and proc.poll() is None:
        proc.send_signal(signal.SIGKILL)
    while time.time() < deadline and job.resize_epoch < 1:
        time.sleep(0.2)
    assert job.resize_epoch >= 1
    # regrow while work remains (idempotent even if it lands late)
    job.request_scale(3)
    t.join(timeout=RUN_TIMEOUT)
    assert not t.is_alive(), "job did not complete"
    s = result["summary"]
    assert s["completed"]
    assert s["task_stats"]["done"] == 8                # exactly once
    recs = _records(tmp_path / "job")
    resizes = [r for r in recs if r["event"] == "resize"]
    assert len(resizes) >= 1
    for r in resizes:
        assert r["plan"]["lint_findings"] == []        # re-plan clean
        assert r["merged"]["merged_from"]              # replicas merged
    assert recs[-1]["event"] == "complete"


@pytest.mark.timeout(900)
def test_coordinator_sigterm_drains_and_resumes_idempotently(tmp_path):
    """SIGTERM to the coordinator: drain -> committed job record ->
    exit EXIT_PREEMPTED; rerunning the identical command resumes and
    completes with exactly-once accounting."""
    conf, chunks = _setup(tmp_path)
    root = tmp_path / "job"
    ev = tmp_path / "ev"
    ev.mkdir()
    argv = [sys.executable, "-m", "paddle_tpu_torch", "elastic",
            "--device", "cpu", "--config", conf, "--data", str(tmp_path / "data" / "part-*"),
            "--workers", "2", "--root", str(root), "--batch-size", "4",
            "--events-dir", str(ev), "--lease", "30",
            "--drain-timeout", "180"]
    proc = subprocess.Popen(argv, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    # wait for demonstrable progress (a worker committed a task), then
    # pull the plug on the COORDINATOR
    deadline = time.time() + RUN_TIMEOUT
    while time.time() < deadline:
        if proc.poll() is not None:
            break
        evs = _events(ev)
        if sum(len(v) for v in evs.values()) >= 4:
            break
        time.sleep(0.3)
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=RUN_TIMEOUT)
    out1 = proc.stdout.read()
    if rc != 0:        # 0 = raced to completion; invariants below hold
        assert rc == EXIT_PREEMPTED, f"exit {rc}:\n{out1[-2000:]}"
        with open(root / "job.json") as f:
            assert not json.load(f)["completed"]
        # the preemption boundary is a durable record
        assert any(r["event"] == "preempted" for r in _records(root))

    r2 = subprocess.run(argv, env=_env(), capture_output=True, text=True,
                        timeout=RUN_TIMEOUT)
    assert r2.returncode == 0, r2.stdout[-2000:] + r2.stderr[-2000:]
    summary = json.loads(r2.stdout.strip().splitlines()[-1])
    assert summary["completed"]
    assert summary["task_stats"]["done"] == 6
    with open(root / "job.json") as f:
        assert json.load(f)["completed"]
    # every batch of every task trained (dedup inside _events), and the
    # final merged model exists
    evs = _events(ev)
    assert sum(len(v) for v in evs.values()) == 24
    assert os.path.isdir(root / "final")


@pytest.mark.timeout(300)
def test_import_paddle_tpu_torch_stays_elastic_free():
    """A fresh interpreter importing paddle_tpu_torch and
    paddle_tpu_torch.distributed loads neither distributed.elastic nor
    distributed.master nor the analysis planner."""
    code = (
        "import sys\n"
        "import paddle_tpu_torch\n"
        "import paddle_tpu_torch.distributed as d\n"
        "bad = [m for m in sys.modules if 'distributed.elastic' in m\n"
        "       or 'distributed.master' in m\n"
        "       or m == 'paddle_tpu_torch.analysis.planner']\n"
        "assert not bad, bad\n"
        "assert d.Master.__module__ == "
        "'paddle_tpu_torch.distributed.master'\n"
        "print('CLEAN')\n")
    r = subprocess.run([sys.executable, "-c", code], env=_env(),
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "CLEAN" in r.stdout


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the workers train on it and "
                    "launch the 1x1-convolution kernel")


@pytest.mark.cuda
@pytest.mark.timeout(900)
def test_narrow_resnet_round_on_the_card_launches_k1_in_each_worker(
        card, tmp_path):
    """Two workers of a narrow ResNet (the v1 layout of ``[elastic]``,
    128-wide so five 1x1 convs pass the kernel's gate at batch 8) run a
    2 -> 1 round on the card through ``chip_smoke.py --elastic-child``:
    the job completes with every task once, and every worker process
    launched K1's forward, dgrad and wgrad once per eligible conv a
    step."""
    import importlib.util
    import torch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from paddle_tpu_torch.distributed.elastic import (
        ElasticConfig, ElasticJob, _worker_argv_for_config,
        prebuild_kernels)
    from paddle_tpu_torch.trainer_config_helpers import load_v1_config
    conf = tmp_path / "resnet.py"
    conf.write_text(cs.resnet_v1_conf(blocks=(2,), widths=(128,), img=32,
                                      classes=10, stem=128, batch=8))
    cfg = load_v1_config(str(conf))
    shapes = cs.eligible_1x1_shapes(cfg.main_program, 8)
    n_gate, n_split = len(shapes), cs.split_wgrads(shapes, torch.float32)
    assert n_gate == 5
    rng = np.random.RandomState(3)
    parts = []
    for i in range(4):
        p = tmp_path / f"part-{i:03d}.pickle"
        with open(p, "wb") as f:
            pickle.dump([(rng.rand(3 * 32 * 32).astype("float32"),
                          np.array([rng.randint(10)], "int64"))
                         for _ in range(8)], f)
        parts.append(str(p))
    ev, stats = tmp_path / "ev", tmp_path / "stats"
    ev.mkdir()
    stats.mkdir()
    prebuild_kernels(cfg.main_program, 8)
    base = _worker_argv_for_config(str(conf), 8, events_dir=str(ev),
                                   device="cuda")
    child = cs.el_child_cmd(str(stats))
    job = ElasticJob(ElasticConfig(
        workers=2, data=parts, root=str(tmp_path / "job"),
        worker_cmd=lambda s: child(s, base(s)), program=cfg.main_program,
        heartbeat_lease_s=60.0, drain_timeout_s=300.0, assume_batch=8,
        poll_s=0.05, env=_env()))
    job.start()

    def watcher():
        while job.master.stats()["done"] < 2:
            time.sleep(0.02)
        job.request_scale(1)
    threading.Thread(target=watcher, daemon=True,
                     name="pt-elastic-test-watch").start()
    s = job.run()
    assert s["completed"] and s["task_stats"]["done"] == 4
    assert s["resizes"] == 1
    assert sum(len(v) for v in _events(ev).values()) == 4
    reports = cs.el_stats(str(stats))
    assert len(reports) >= 3
    cs.el_check_forms("test", reports, n_gate, n_split)
    assert sum(r["forms"].get("forward", 0) for r in reports) == 4 * n_gate


@pytest.mark.timeout(600)
def test_elastic_runner_smoke_on_cpu(tmp_path):
    """``benchmark.elastic`` at SMOKE (2 -> 1 -> 2 workers) on the CPU:
    two committed resize records with lint-clean re-plans, every task
    done, each boundary's phases timed, the results file written."""
    from paddle_tpu_torch.benchmark import elastic
    out = tmp_path / "elastic_results.json"
    assert elastic.main(["--smoke", "--device", "cpu", "--out",
                         str(out)]) in (0, 1)
    with open(out) as f:
        row = json.load(f)["rows"][0]
    acc = row["acceptance"]
    assert acc["resize_round"] == "2->1->2"
    assert acc["committed_resize_records"] == 2
    assert acc["all_replans_lint_clean"] and acc["completed"]
    assert acc["zero_task_loss"]
    assert row["exactly_once"]["unique_batches_trained"] == \
        row["exactly_once"]["expected_batches"]
    assert len(row["boundaries"]) == 2 and row["device"] == "cpu"
    for b in row["boundaries"]:
        assert b["drain_ms"] > 0 and b["merge_ms"] > 0 and \
            b["replan_ms"] > 0
