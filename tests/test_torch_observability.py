"""The port's observability layer (``paddle_tpu_torch/observability/``)
held against the JAX package's on the same inputs.

* Registry and export: the same scripted writes give equal snapshots
  (over the port's names; the JAX package's other rows stay zero) and
  byte-equal Prometheus text; the port's ``METRIC_NAMES``,
  ``HISTOGRAM_BUCKETS`` and ``SPAN_NAMES`` rows are the JAX package's.
* The name gate: every metric and span name the port's code passes is a
  string literal of its tables, and every row of the tables is written
  somewhere (the counterpart of ``tests/test_repo_lint.py``'s gate).
* The executor under ``observe``: a small fc program and a conv program,
  3 steps each of ``run``, ``run_steps`` and ``run_pipelined``, give the
  same event kinds, span names and counting counters in both packages
  (times are not compared).
* ``observe`` off: zero registry deltas, no log, the same captured-step
  key as with it on.
* Logs cross-read: the summaries of a log written by either package are
  equal in both.
* The wiring: the trainer's periodic reports, the serving and decode
  runtimes' metrics and spans, the sparse session's counters, the
  checkpoint writer's and fault injection's events, the profiler's
  merged report, card memory on the CPU, and the drivers' doctor rows.
"""
import ast
import json
import os
import threading

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
import torch_parity as tp
from paddle_tpu import flags as jflags
from paddle_tpu import observability as jobs
from paddle_tpu.observability import export as jexport
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import tracing as jtracing
from paddle_tpu_torch import flags, layers
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.core import compile_cache
from paddle_tpu_torch.observability import export, metrics, tracing

CPU = ptt.CPUPlace()
PORT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "paddle_tpu_torch")


@pytest.fixture(autouse=True)
def clean_observability():
    """Fresh registries, restored flags and closed writers (both
    packages) per test."""
    obs.registry().reset()
    jobs.registry().reset()
    prev = {n: flags.get_flag(n) for n in ("observe", "metrics_log",
                                           "log_period")}
    jprev = {n: jflags.get_flag(n) for n in ("observe", "metrics_log")}
    yield
    for n, v in prev.items():
        flags.set_flag(n, v)
    for n, v in jprev.items():
        jflags.set_flag(n, v)
    export._reset_writer()
    jexport._reset_writer()
    obs.registry().reset()
    jobs.registry().reset()


def _port_names():
    return {n for n, _k, _h in metrics.METRIC_NAMES}


def _port_view(snap):
    return {k: v for k, v in snap.items() if k in _port_names()}


def _read(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------
def test_metric_rows_are_the_jax_packages():
    jrows = {n: (k, h) for n, k, h in jmetrics.METRIC_NAMES}
    assert metrics.METRIC_NAMES, "empty table"
    for name, kind, help_ in metrics.METRIC_NAMES:
        assert name in jrows, f"{name!r} is not a JAX package metric"
        assert jrows[name] == (kind, help_), name
        if kind == "histogram":
            assert metrics.HISTOGRAM_BUCKETS.get(name) == \
                jmetrics.HISTOGRAM_BUCKETS.get(name), name
    names = [n for n, _k, _h in metrics.METRIC_NAMES]
    assert len(names) == len(set(names))


def test_span_rows_are_the_jax_packages():
    jrows = dict(jtracing.SPAN_NAMES)
    for name, help_ in tracing.SPAN_NAMES:
        assert jrows.get(name) == help_, name
    names = [n for n, _h in tracing.SPAN_NAMES]
    assert len(names) == len(set(names))


def _port_sources():
    for root, _dirs, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    yield os.path.relpath(path, PORT), ast.parse(fh.read())


def _literal_calls(helpers, skip):
    """(problems, used names) of every call to a helper in ``helpers``
    across the port, outside the files in ``skip``."""
    problems, used = [], set()
    for rel, tree in _port_sources():
        if rel in skip:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            target = fn.id if isinstance(fn, ast.Name) else (
                fn.attr if isinstance(fn, ast.Attribute) else None)
            if target not in helpers:
                continue
            arg = node.args[0] if node.args else None
            if not (isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)):
                problems.append(f"{rel}:{node.lineno}: {target} needs a "
                                f"string-literal name")
                continue
            used.add(arg.value)
    return problems, used


def test_metric_name_gate():
    """Every metric write names a registered literal, and every row of
    the port's table is written somewhere in the port."""
    problems, used = _literal_calls(
        ("inc_counter", "set_gauge", "observe_hist"),
        skip={os.path.join("observability", "metrics.py")})
    assert not problems, "\n".join(problems)
    registered = _port_names()
    assert used <= registered, sorted(used - registered)
    assert used == registered, f"rows never written: {registered - used}"


def test_span_name_gate():
    problems, used = _literal_calls(
        ("span", "start_span"),
        skip={os.path.join("observability", "tracing.py")})
    assert not problems, "\n".join(problems)
    registered = {n for n, _h in tracing.SPAN_NAMES}
    assert used == registered, (sorted(used - registered),
                                sorted(registered - used))


# ---------------------------------------------------------------------------
# registry and export
# ---------------------------------------------------------------------------
def _script(mod):
    mod.inc_counter("executor/steps", 3)
    mod.inc_counter("executor/steps")
    mod.inc_counter("executor/feed_bytes", 3.2e9)
    mod.inc_counter("checkpoint/rebase_total")
    mod.set_gauge("executor/examples_per_sec", 123.5)
    mod.set_gauge("device/bytes_in_use", 10, label="cuda:0")
    mod.set_gauge("sparse/live_rows", 7, label='a"b\\c')
    rng = np.random.RandomState(0)
    for v in rng.exponential(40.0, 50):
        mod.observe_hist("executor/step_time_ms", float(v))
    for v in (0.0, 1.0, 3.0, 200.0):
        mod.observe_hist("pipeline/queue_depth", v)


def test_same_writes_equal_snapshots_and_prometheus_text():
    _script(obs)
    _script(jobs)
    port, jax = obs.registry().snapshot(), jobs.registry().snapshot()
    assert set(port) == _port_names()
    assert port == _port_view(jax)
    # the JAX package's other rows were not written
    for name, snap in jax.items():
        if name not in port:
            assert snap.get("value", 0) == 0 and not snap.get("values") \
                and not snap.get("count"), name
    assert export.to_prometheus(port) == jexport.to_prometheus(
        _port_view(jax))
    assert obs.report() == jobs.registry().report()


def test_registry_rejects_unknown_names_and_kind_mismatch():
    with pytest.raises(KeyError, match="frozen"):
        obs.inc_counter("executor/step_tmie_ms")
    with pytest.raises(TypeError, match="histogram"):
        obs.inc_counter("executor/step_time_ms")
    with pytest.raises(KeyError):
        obs.inc_counter("fleet/requests")      # a JAX-only row


def test_registry_thread_safety_exact_counts():
    def work():
        for _ in range(500):
            obs.inc_counter("executor/steps")
            obs.observe_hist("pipeline/queue_depth", 1.0)

    ts = [threading.Thread(target=work) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    snap = obs.registry().snapshot()
    assert snap["executor/steps"]["value"] == 4000
    assert snap["pipeline/queue_depth"]["count"] == 4000


def test_snapshot_compile_and_device_memory_on_the_cpu():
    snap = obs.metrics_snapshot()
    stats = compile_cache.stats().snapshot()
    assert snap["compile"] == {f"compile/{k}": v for k, v in stats.items()}
    # no card: what the JAX package returns for a backend without stats
    assert snap["device_memory"] == {} == jexport.sample_device_memory()
    json.dumps(snap)


def test_jsonl_identity_header_and_events(tmp_path):
    log = tmp_path / "x.jsonl"
    flags.set_flag("metrics_log", str(log))
    export.set_process_identity("trainer", 3)
    try:
        obs.emit_event("step", steps=1, wall_ms=1.0)
        obs.emit_event("fault", event="retry")
    finally:
        export.set_process_identity(None)
    evs = _read(log)
    assert evs[0]["kind"] == "identity" and evs[0]["role"] == "trainer"
    assert evs[0]["index"] == 3
    assert [e["kind"] for e in evs[1:]] == ["step", "fault"]
    events, files = obs.iter_log_events([str(log)])
    assert obs.source_label(files[0]) == "trainer:3"


# ---------------------------------------------------------------------------
# the executor under observe, against the JAX executor
# ---------------------------------------------------------------------------
def _fc_net(pkg):
    x = pkg.layers.data("x", shape=[8], dtype="float32")
    y = pkg.layers.data("y", shape=[3], dtype="float32")
    h = pkg.layers.fc(x, size=16, act="relu")
    pred = pkg.layers.fc(h, size=3)
    loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
    pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def _conv_net(pkg):
    x = pkg.layers.data("x", shape=[3, 8, 8], dtype="float32")
    y = pkg.layers.data("y", shape=[4], dtype="float32")
    c = pkg.layers.conv2d(x, num_filters=4, filter_size=3, padding=1,
                          act="relu")
    p = pkg.layers.pool2d(c, pool_size=2, pool_type="max", pool_stride=2)
    pred = pkg.layers.fc(p, size=4)
    loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
    pkg.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return loss


def _feeds(net, n, seed=0):
    rng = np.random.RandomState(seed)
    if net is _fc_net:
        return [{"x": rng.rand(6, 8).astype("f4"),
                 "y": rng.rand(6, 3).astype("f4")} for _ in range(n)]
    return [{"x": rng.rand(2, 3, 8, 8).astype("f4"),
             "y": rng.rand(2, 4).astype("f4")} for _ in range(n)]


def _both(net):
    """The JAX program and its JSON in the port, the JAX startup scope
    carried over."""
    tp.reset_both()
    jm, js = pt.Program(), pt.Program()
    with pt.program_guard(jm, js):
        jl = net(pt)
    jscope = pt.core.Scope()
    pt.Executor(pt.CPUPlace()).run(js, scope=jscope)
    tm = ptt.Program.from_json(jm.to_json())
    tscope = ptt.Scope()
    ptt.load_numpy_state(tscope, tp.jax_state(jscope), "cpu")
    return (jm, jl.name, jscope), (tm, jl.name, tscope)


def _drive(pkg, exe, prog, loss, scope, feeds):
    """3 steps of run, run_steps(3) (stacked) and run_pipelined (K=2:
    one 2-step dispatch and a 1-step leftover)."""
    for f in feeds[:3]:
        exe.run(prog, feed=f, fetch_list=[loss], scope=scope)
    stacked = {k: np.stack([f[k] for f in feeds[3:6]]) for k in feeds[0]}
    exe.run_steps(3, prog, feed=stacked, fetch_list=[loss], scope=scope,
                  feeds_stacked=True)
    outs = list(exe.run_pipelined(iter(feeds[6:9]), prog,
                                  fetch_list=[loss], scope=scope,
                                  steps_per_dispatch=2, prefetch_depth=2))
    assert len(outs) == 3


COUNTING = ("executor/steps", "executor/dispatches",
            "pipeline/fallback_steps", "executor/feed_bytes")
HIST_COUNTS = ("executor/dispatch_steps", "executor/fetch_block_ms",
               "executor/stage_put_ms", "pipeline/queue_depth",
               "pipeline/consumer_stall_ms")


@pytest.mark.parametrize("net", [_fc_net, _conv_net],
                         ids=["fc", "conv"])
def test_executor_observe_matches_the_jax_executor(net, tmp_path):
    (jm, jloss, jscope), (tm, tloss, tscope) = _both(net)
    feeds = _feeds(net, 9)
    logs = {}
    for name, pkg, fl, registry, prog, loss, scope in (
            ("jax", pt, jflags, jobs.registry(), jm, jloss, jscope),
            ("torch", ptt, flags, obs.registry(), tm, tloss, tscope)):
        log = tmp_path / f"{name}.jsonl"
        fl.set_flag("metrics_log", str(log))
        exe = pkg.Executor(pkg.CPUPlace(), observe=True)
        _drive(pkg, exe, prog, loss, scope, feeds)
        fl.set_flag("metrics_log", "")
        logs[name] = (_read(log), registry.snapshot())
    (jev, jsnap), (tev, tsnap) = logs["jax"], logs["torch"]

    def kinds(evs):
        return sorted(e["kind"] for e in evs)

    def spans(evs):
        return sorted(e["name"] for e in evs if e["kind"] == "span")

    assert kinds(tev) == kinds(jev)
    assert spans(tev) == spans(jev)
    for name in COUNTING:
        assert tsnap[name]["value"] == jsnap[name]["value"], name
    for name in HIST_COUNTS:
        assert tsnap[name]["count"] == jsnap[name]["count"], name
    # the step events' structure: path and steps per dispatch
    assert [(e["path"], e["steps"]) for e in tev if e["kind"] == "step"] \
        == [(e["path"], e["steps"]) for e in jev if e["kind"] == "step"]
    # every step event joins its executor/step span
    ids = {e["span"] for e in tev if e.get("name") == "executor/step"}
    assert {e["span"] for e in tev if e["kind"] == "step"} == ids


def test_observe_off_zero_writes_no_log_same_key(tmp_path):
    (_, _, _), (tm, tloss, tscope) = _both(_fc_net)
    log = tmp_path / "off.jsonl"
    flags.set_flag("observe", False)
    flags.set_flag("metrics_log", str(log))
    before = obs.registry().snapshot()
    exe = ptt.Executor(CPU)
    _drive(ptt, exe, tm, tloss, tscope, _feeds(_fc_net, 9))
    assert obs.registry().snapshot() == before
    assert not log.exists()
    # observe is not part of a captured step's key
    feed = {k: exe._feed_tensor(tm.global_block(), k, v)
            for k, v in _feeds(_fc_net, 1)[0].items()}
    keys = {ptt.Executor(CPU, observe=o)._fingerprint(
        tm, feed, [tloss], tscope, False) for o in (None, False, True)}
    assert len(keys) == 1
    # check_nan_inf and compute_dtype are
    assert ptt.Executor(CPU, check_nan_inf=True)._fingerprint(
        tm, feed, [tloss], tscope, False) not in keys
    assert ptt.Executor(CPU, compute_dtype="float64")._fingerprint(
        tm, feed, [tloss], tscope, False) not in keys


def test_observe_flip_keeps_the_math(tmp_path):
    (_, _, _), (tm, tloss, tscope) = _both(_fc_net)
    feeds = _feeds(_fc_net, 4)
    exe = ptt.Executor(CPU, observe=False)
    off = [exe.run(tm, feed=f, fetch_list=[tloss], scope=tscope)[0]
           for f in feeds[:2]]
    exe.observe = True
    on = [exe.run(tm, feed=f, fetch_list=[tloss], scope=tscope)[0]
          for f in feeds[2:]]
    (_, _, _), (tm2, _, tscope2) = _both(_fc_net)
    ref = [ptt.Executor(CPU).run(tm2, feed=f, fetch_list=[tloss],
                                 scope=tscope2)[0] for f in feeds]
    np.testing.assert_array_equal(np.array(off + on), np.array(ref))
    assert obs.registry().snapshot()["executor/steps"]["value"] == 2


def test_logs_cross_read(tmp_path):
    """A log written by either package summarizes equally in both."""
    (jm, jloss, jscope), (tm, tloss, tscope) = _both(_fc_net)
    feeds = _feeds(_fc_net, 9)
    paths = {}
    for name, pkg, fl, prog, loss, scope in (
            ("jax", pt, jflags, jm, jloss, jscope),
            ("torch", ptt, flags, tm, tloss, tscope)):
        paths[name] = str(tmp_path / f"{name}.jsonl")
        fl.set_flag("metrics_log", paths[name])
        _drive(pkg, pkg.Executor(pkg.CPUPlace(), observe=True), prog,
               loss, scope, feeds)
        pkg.observability.emit_event("snapshot",
                                     **pkg.observability.metrics_snapshot())
        fl.set_flag("metrics_log", "")
    jexport._reset_writer()
    export._reset_writer()
    for path in paths.values():
        assert obs.summarize_log(path) == jobs.summarize_log(path)
        assert obs.summarize_logs([path, path]) == \
            jobs.summarize_logs([path, path])
        assert export.render_summary(obs.summarize_log(path)) == \
            jexport.render_summary(jobs.summarize_log(path))


# ---------------------------------------------------------------------------
# the wiring
# ---------------------------------------------------------------------------
def test_trainer_periodic_reports(tmp_path):
    from paddle_tpu_torch import trainer
    log = tmp_path / "train.jsonl"
    flags.set_flag("metrics_log", str(log))
    flags.set_flag("log_period", 2)
    ptt.core.reset_default_programs()
    ptt.core.reset_global_scope()
    x = layers.data("x", shape=[4], dtype="float32")
    y = layers.data("y", shape=[1], dtype="float32")
    cost = layers.mean(layers.square_error_cost(layers.fc(x, size=1), y))
    sgd = trainer.SGD(cost, update_equation=ptt.optimizer.SGD(0.1),
                      place=CPU)
    sgd.exe.observe = True
    rng = np.random.RandomState(0)
    rows = [(rng.rand(4).astype("f4"), rng.rand(1).astype("f4"))
            for _ in range(8)]
    reader = ptt.reader.batch(lambda: iter(rows), 2)
    sgd.train(reader, num_passes=2, feed_list=[x, y])
    snap = obs.registry().snapshot()
    assert snap["trainer/reports"]["value"] == 4     # 8 batches / 2
    evs = _read(log)
    assert sum(e["kind"] == "snapshot" for e in evs) == 4
    # the startup program's dispatch and the 8 batches
    assert sum(e["kind"] == "step" for e in evs) == 9


def _serve(n_fc=10, n_decode=0):
    """A server with an fc model (and a decode tenant when ``n_decode``)
    built under the current ``observe`` flag; ``n_fc`` and ``n_decode``
    requests served and drained.  Returns the completed requests."""
    from paddle_tpu_torch.serving import Model, Server
    from paddle_tpu_torch.serving.decode import DecodeEngine
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start):
        x = layers.data("x", shape=[4], dtype="float32")
        y = layers.fc(x, size=3)
    sc = ptt.Scope()
    exe = ptt.Executor(CPU)
    exe.run(start, scope=sc)
    srv = Server(max_batch=4, max_wait_ms=2.0, deadline_ms=None)
    srv.add_model(Model.from_program(exe, main, [y], name="fc", scope=sc,
                                     example={"x": np.ones(4, "f4")}))
    if n_decode:
        srv.add_decode_model(DecodeEngine(vocab_size=16, hidden_dim=8,
                                          slots=2, max_len=16, place=CPU,
                                          use_jit=False), name="dec")
    srv.start()
    try:
        rs = [srv.submit({"x": np.full(4, i, "f4")}, model="fc")
              for i in range(n_fc)]
        rs += [srv.submit_decode([1, 2], 5, model="dec")
               for _ in range(n_decode)]
        for r in rs:
            r.result(timeout=60)
    finally:
        srv.shutdown(drain=True)
    return rs


def test_serving_metrics_and_spans(tmp_path):
    log = tmp_path / "serve.jsonl"
    flags.set_flag("metrics_log", str(log))
    flags.set_flag("observe", True)
    _serve()
    export._reset_writer()
    snap = obs.registry().snapshot()
    assert snap["serving/requests"]["value"] == 10
    assert snap["serving/request_ms"]["count"] == 10
    assert snap["serving/batch_size"]["sum"] == 10
    evs = _read(log)
    reqs = [e for e in evs if e.get("name") == "serving/request"]
    assert len(reqs) == 10 and all(e["labels"]["status"] == "ok"
                                   for e in reqs)
    batches = [e for e in evs if e.get("name") == "serving/batch"]
    assert sum(e["labels"]["size"] for e in batches) == 10
    assert [e["state"] for e in evs if e.get("event") == "state"] == [
        "warming", "ready", "draining", "stopped"]
    b = obs.summarize_log(str(log))["serving"]
    assert b == jobs.summarize_log(str(log))["serving"]


def test_serving_and_decode_observe_off_write_nothing(tmp_path,
                                                      monkeypatch):
    """With ``observe`` off (the flag, read when the server is built) the
    server and its decode tenant build no span, write no registry entry
    and no log line; the decode tenant takes the server's setting."""
    log = tmp_path / "off.jsonl"
    flags.set_flag("observe", False)
    flags.set_flag("metrics_log", str(log))
    spans = []
    real = tracing.start_span
    monkeypatch.setattr(tracing, "start_span",
                        lambda *a, **k: spans.append(a[0]) or real(*a, **k))
    before = obs.registry().snapshot()
    rs = _serve(n_fc=6, n_decode=3)
    assert all(r.span is None for r in rs)
    assert spans == []
    assert obs.registry().snapshot() == before
    assert not log.exists()
    # the same traffic observed writes both tenants' rows
    flags.set_flag("observe", True)
    flags.set_flag("metrics_log", "")
    _serve(n_fc=6, n_decode=3)
    snap = obs.registry().snapshot()
    assert snap["serving/requests"]["value"] == 9
    assert snap["serving/decode_tokens"]["value"] == 15
    assert spans.count("serving/request") == 9
    assert "serving/batch" in spans and "serving/decode_step" in spans


def test_sparse_session_counters_follow_its_stats():
    from paddle_tpu_torch.sparse import SparseSession, SparseTable
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start):
        ids = layers.data("ids", shape=[1], dtype="int64")
        loss = layers.mean(layers.embedding(ids, size=[50, 4], name="e",
                                            sparse=True))
        ptt.optimizer.SGD(0.1).minimize(loss)
    sc = ptt.Scope()
    exe = ptt.Executor(CPU)
    exe.run(start, scope=sc)
    rng = np.random.RandomState(0)
    feeds = [{"ids": rng.randint(0, 50, (8, 1))} for _ in range(3)]
    quiet = SparseSession(SparseTable("e", 50, 4), observe=False)
    quiet.bind(main)
    for f in feeds:
        quiet.run(exe, main, f, [loss], scope=sc)
    assert obs.registry().snapshot()["sparse/pulls"]["value"] == 0
    sess = SparseSession(SparseTable("e", 50, 4), observe=True,
                         cache_rows=16)
    sess.bind(main)
    for f in sess.prefetch_feeds(iter(feeds), depth=1):
        out = exe.run(main, feed=f, fetch_list=[loss] +
                      sess.grad_fetch_list, scope=sc)
        sess.complete(out[1:])
    snap = obs.registry().snapshot()
    for k in ("pulls", "pulled_rows", "pushes", "pushed_rows"):
        assert snap[f"sparse/{k}"]["value"] == sess.stats[k], k
    assert snap["sparse/prefetch_hits"]["value"] + \
        snap["sparse/prefetch_misses"]["value"] == 3
    assert snap["sparse/live_rows"]["values"]["e"] == \
        sess.tables["e"].live_rows


def test_checkpoint_commit_and_fault_events(tmp_path, monkeypatch):
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.testing import faultinject
    log = tmp_path / "ckpt.jsonl"
    flags.set_flag("metrics_log", str(log))
    sc = ptt.Scope()
    sc.set("w", np.arange(6, dtype="f4"))
    cm = CheckpointManager(str(tmp_path / "ck"), device="cpu")
    cm.save(1, sc, blocking=True)
    cm.save(2, sc, kind="delta", blocking=True)
    monkeypatch.setattr(faultinject, "ENABLED", True)
    faultinject.configure("unit.site@1=error")
    try:
        assert faultinject.check("unit.site") == "error"
    finally:
        faultinject.configure("")
    export._reset_writer()
    snap = obs.registry().snapshot()
    assert snap["checkpoint/commit_ms"]["count"] == 2
    assert snap["fault/injected"]["value"] == 1
    summary = obs.summarize_log(str(log))
    assert summary["checkpoint"]["commits"] == 2
    assert summary["checkpoint"]["full"] == 1
    assert summary["faults"]["by_event"] == {"injected": 1}
    assert summary == jobs.summarize_log(str(log))


def test_profiler_report_and_trace(tmp_path):
    from paddle_tpu_torch import profiler
    obs.inc_counter("executor/steps", 2)
    with profiler.timer("unit"):
        pass
    rep = profiler.report()
    assert "StatSet" in rep and "CaptureStats" in rep
    assert "executor/steps: 2" in rep
    with profiler.profiler(str(tmp_path / "trace")):
        with profiler.profiler(str(tmp_path / "inner")):   # reentrant
            ptt.core.scope.to_numpy(__import__("torch").ones(3) * 2)
    assert (tmp_path / "trace" / "trace.json").exists()
    assert not (tmp_path / "inner").exists()


def test_input_pipeline_doctor_row_reconciles():
    from paddle_tpu_torch.benchmark import input_pipeline
    row = input_pipeline.run_workload(smoke=True, place=CPU, quiet=True)
    doc = row["doctor"]
    assert doc["within_tolerance"] is True
    assert doc["steps"] == row["batches_per_window"]
    # the static cost model's row for the pass's measured warm step
    cal = row["calibration"]
    assert cal["model"] == "static" and cal["predicted_ms"] > 0
    assert cal["measured_ms"] == round(doc["step_ms_warm_mean"], 6)
    assert cal["ratio"] > 0


# ---------------------------------------------------------------------------
# the JAX package's tests of the same surface
# ---------------------------------------------------------------------------
def test_stat_accumulates_reports_and_is_thread_safe():
    import re
    from paddle_tpu_torch import profiler
    st = profiler.Stat()

    def work():
        for _ in range(300):
            with st.timer("x"):
                pass

    ts = [threading.Thread(target=work) for _ in range(6)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    m = re.search(r"x: total=\S+ count=(\d+)", st.report())
    assert m and int(m.group(1)) == 1800
    st.reset()
    assert "x:" not in st.report()


def test_step_timer_warmup_discard():
    from paddle_tpu_torch import profiler
    t = profiler.StepTimer(warmup=2)
    assert t.mean == 0.0
    for _ in range(5):
        t.start()
        t.stop()
    assert len(t.times) == 3 and t.mean >= 0.0
    assert profiler.cuda_profiler is profiler.profiler


def test_record_function_names_the_dispatch(monkeypatch):
    import torch
    names = []
    real = torch.profiler.record_function

    def fake(name, *a, **k):
        names.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", fake)
    (_, _, _), (tm, tloss, tscope) = _both(_fc_net)
    exe = ptt.Executor(CPU, observe=True)
    exe.run(tm, feed=_feeds(_fc_net, 1)[0], fetch_list=[tloss],
            scope=tscope)
    ann = [n for n in names if n.startswith("pt:run:")]
    assert len(ann) == 1 and len(ann[0].split(":")[2]) == 12
    assert ann[0].endswith(":step0")


def test_periodic_report_noop_when_not_observing(tmp_path):
    flags.set_flag("observe", False)
    flags.set_flag("log_period", 1)
    flags.set_flag("metrics_log", str(tmp_path / "off.jsonl"))
    assert obs.maybe_periodic_report(5) is False
    assert not (tmp_path / "off.jsonl").exists()
    assert obs.maybe_periodic_report(5, observing=True) is True
    assert (tmp_path / "off.jsonl").exists()


def test_metrics_log_unwritable_path_disables_quietly(tmp_path):
    flags.set_flag("metrics_log", str(tmp_path / "missing" / "x.jsonl"))
    obs.emit_event("step", steps=1)
    obs.emit_event("step", steps=2)
    assert not (tmp_path / "missing").exists()


def test_worker_busy_counters_visible_mid_run(monkeypatch):
    from paddle_tpu_torch.reader import pipeline as pl
    monkeypatch.setattr(pl, "_FLUSH_EVERY", 1)
    g = pl.prefetch(lambda: iter(range(10 ** 6)), buffer_size=2,
                    num_workers=1, instrument=True)()
    try:
        for _ in range(8):
            next(g)
        assert obs.registry().snapshot()[
            "pipeline/worker_busy_s"]["value"] > 0
    finally:
        g.close()


def test_histogram_quantile_walks_buckets():
    for v in [1.0] * 50 + [30.0] * 50:
        obs.observe_hist("pipeline/queue_depth", v)
    snap = obs.registry().snapshot()["pipeline/queue_depth"]
    assert metrics.histogram_quantile(snap, 0.25) == 1.0
    assert metrics.histogram_quantile(snap, 0.9) == 32.0
    assert metrics.histogram_quantile(snap, 0.9) == \
        jmetrics.histogram_quantile(snap, 0.9)
