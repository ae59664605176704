"""The port's spans (``paddle_tpu_torch/observability/tracing.py``)
against the JAX package's ``tests/test_tracing.py``.

* The span API: nesting, events, cross-thread parents, ``ROOT``,
  ``cancel``, and the wire context (``inject``/``extract``, malformed
  contexts counted).
* ``build_traces``, ``span_stats`` and ``critical_path`` give equal
  results in both packages over a log written by either package.
* The executor's traces: one trace per ``run_pipelined`` run holding its
  staging, reader and dispatch spans, step events joined to their spans,
  a failed dispatch ending its step span with the typed status, a retry
  recorded on the dispatch span.
* The sparse wire: an observing client's rounds parent a server-side
  span on a shard served on a thread, and its reply's timings label the
  client span; an observe-off client's frames carry no context.
"""
import json
import threading

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
import torch_parity as tp
from paddle_tpu import flags as jflags
from paddle_tpu.observability import export as jexport
from paddle_tpu.observability import tracing as jtracing
from paddle_tpu_torch import flags, layers
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.observability import export, tracing

CPU = ptt.CPUPlace()


@pytest.fixture(autouse=True)
def clean():
    obs.registry().reset()
    prev = {n: flags.get_flag(n) for n in ("observe", "metrics_log")}
    jprev = {n: jflags.get_flag(n) for n in ("observe", "metrics_log")}
    yield
    for n, v in prev.items():
        flags.set_flag(n, v)
    for n, v in jprev.items():
        jflags.set_flag(n, v)
    export._reset_writer()
    jexport._reset_writer()
    obs.registry().reset()


def _read(path):
    export._reset_writer()
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _spans(events):
    return [e for e in events if e.get("kind") == "span"]


def _assert_tree_invariants(spans):
    """Unique ids; every parent in its own trace; children start no
    earlier than their parent."""
    by_id = {e["span"]: e for e in spans}
    assert len(by_id) == len(spans)
    for e in spans:
        p = e.get("parent")
        if p and p in by_id:
            assert by_id[p]["trace"] == e["trace"]
            assert e["t0"] >= by_id[p]["t0"] - 1e-3


def test_span_api_nesting_events_and_cross_thread_parent(tmp_path):
    flags.set_flag("metrics_log", str(tmp_path / "api.jsonl"))
    with tracing.span("executor/run_pipelined", steps_per_dispatch=4) as root:
        assert tracing.current_span() is root
        with tracing.span("executor/step", path="run") as child:
            assert child.parent_id == root.span_id
            assert child.trace_id == root.trace_id
            tracing.add_event("retry", attempt=1)
        done = threading.Event()

        def worker():
            sp = tracing.start_span("pipeline/stage", parent=root,
                                    kind="scan")
            sp.end(steps=4)
            done.set()

        threading.Thread(target=worker).start()
        assert done.wait(5)
        iso = tracing.start_span("serving/request", parent=tracing.ROOT,
                                 id=1)
        assert iso.parent_id is None and iso.trace_id != root.trace_id
        iso.cancel()
    assert tracing.current_span() is None
    spans = _spans(_read(tmp_path / "api.jsonl"))
    assert sorted(e["name"] for e in spans) == [
        "executor/run_pipelined", "executor/step", "pipeline/stage"]
    _assert_tree_invariants(spans)
    step = next(e for e in spans if e["name"] == "executor/step")
    assert step["events"][0]["name"] == "retry"
    stage = next(e for e in spans if e["name"] == "pipeline/stage")
    assert stage["labels"] == {"kind": "scan", "steps": 4}


def test_span_names_frozen():
    with pytest.raises(KeyError, match="frozen"):
        tracing.start_span("executor/stpe")
    with pytest.raises(KeyError):
        tracing.start_span("http/request")      # a JAX-only span


def test_wire_context_round_trip_and_rejects():
    with tracing.span("pserver/rpc", op="pull") as sp:
        ctx = tracing.inject()
    assert ctx == jtracing.inject(sp) == f"1:{sp.trace_id}:{sp.span_id}"
    rp = tracing.extract(ctx)
    assert (rp.trace_id, rp.span_id) == (sp.trace_id, sp.span_id)
    assert tracing.inject() is None and tracing.extract(None) is None
    for bad in ("2:t1:s1", "1:t1", "garbage", 17, "1::s"):
        assert tracing.extract(bad) is None
    assert obs.registry().snapshot()["trace/context_rejected"][
        "value"] == 5


def _net(pkg):
    x = pkg.layers.data("x", shape=[8], dtype="float32")
    y = pkg.layers.data("y", shape=[3], dtype="float32")
    pred = pkg.layers.fc(pkg.layers.fc(x, size=16, act="relu"), size=3)
    loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
    pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"x": rng.rand(6, 8).astype("f4"),
             "y": rng.rand(6, 3).astype("f4")} for _ in range(n)]


def _pipelined_log(pkg, fl, path):
    """Startup, then two run_pipelined runs of 10 batches (K=4), logged
    with observe on."""
    tp.reset_both()
    main, start = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, start):
        loss = _net(pkg)
    fl.set_flag("observe", True)
    fl.set_flag("metrics_log", str(path))
    exe = pkg.Executor(pkg.CPUPlace())
    scope = pkg.Scope() if pkg is ptt else pkg.core.Scope()
    exe.run(start, scope=scope)
    for seed in (0, 1):
        list(exe.run_pipelined(iter(_batches(10, seed)), main,
                               fetch_list=[loss], scope=scope,
                               steps_per_dispatch=4, prefetch_depth=2))
    fl.set_flag("metrics_log", "")
    fl.set_flag("observe", False)
    export._reset_writer()
    jexport._reset_writer()
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_pipelined_trace_invariants(tmp_path):
    events = _pipelined_log(ptt, flags, tmp_path / "run.jsonl")
    spans = _spans(events)
    _assert_tree_invariants(spans)
    assert {"executor/run_pipelined", "reader/pipeline", "reader/item",
            "pipeline/stage", "executor/step", "executor/dispatch",
            "executor/fetch_block"} <= {e["name"] for e in spans}
    roots = [e for e in spans if e["name"] == "executor/run_pipelined"]
    assert len(roots) == 2
    for root in roots:
        members = {e["name"] for e in spans if e["trace"] == root["trace"]}
        assert {"pipeline/stage", "executor/step", "reader/item",
                "executor/dispatch"} <= members
    ids = {e["span"] for e in spans}
    for se in (e for e in events if e.get("kind") == "step"):
        assert se["span"] in ids and se["trace"]
    traces = tracing.build_traces(events)
    big = max(traces, key=lambda t: len(t["spans"]))
    assert tracing.critical_path(big)[0]["name"] == "executor/run_pipelined"
    # the startup run and, per run, two 4-step dispatches and 2 leftovers
    assert tracing.span_stats(events)["executor/step"]["count"] == 9
    assert "executor/run_pipelined" in tracing.render_trace(big)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_trace_engine_agrees_over_either_packages_log(writer, tmp_path):
    pkg, fl = (pt, jflags) if writer == "jax" else (ptt, flags)
    events = _pipelined_log(pkg, fl, tmp_path / f"{writer}.jsonl")
    assert tracing.build_traces(events) == jtracing.build_traces(events)
    assert tracing.span_stats(events) == jtracing.span_stats(events)
    for t in tracing.build_traces(events):
        assert tracing.critical_path(t) == jtracing.critical_path(t)
        assert tracing.render_trace(t) == jtracing.render_trace(t)


def test_both_packages_trace_the_same_tree(tmp_path):
    """Each package's own run: the same span names per trace shape."""
    shapes = []
    for name, pkg, fl in (("jax", pt, jflags), ("torch", ptt, flags)):
        events = _pipelined_log(pkg, fl, tmp_path / f"{name}.jsonl")
        shapes.append(sorted(
            tuple(sorted(e["name"] for e in t["spans"]))
            for t in tracing.build_traces(events)))
    assert shapes[0] == shapes[1]


def test_failed_dispatch_still_emits_step_span(tmp_path):
    from paddle_tpu_torch.testing import faultinject
    log = tmp_path / "fail.jsonl"
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start):
        loss = _net(ptt)
    sc = ptt.Scope()
    exe = ptt.Executor(CPU, observe=True)
    exe.run(start, scope=sc)
    flags.set_flag("metrics_log", str(log))
    faultinject.configure("executor.dispatch@*=error")
    try:
        with pytest.raises(Exception, match="injected"):
            exe.run(main, feed=_batches(1)[0], fetch_list=[loss], scope=sc)
    finally:
        faultinject.clear()
    spans = _spans(_read(log))
    assert any(e["name"] == "executor/step"
               and (e.get("labels") or {}).get("status") == "InjectedFault"
               for e in spans)


def test_executor_retry_span_event(tmp_path):
    from paddle_tpu_torch import faults
    from paddle_tpu_torch.testing import faultinject
    log = tmp_path / "retry.jsonl"
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start):
        loss = _net(ptt)
    sc = ptt.Scope()
    exe = ptt.Executor(CPU, observe=True, retry_policy=faults.RetryPolicy(
        max_attempts=2, backoff_base_s=0.0, jitter=0.0))
    exe.run(start, scope=sc)
    flags.set_flag("metrics_log", str(log))
    faultinject.configure("executor.dispatch@1=transient")
    try:
        exe.run(main, feed=_batches(1)[0], fetch_list=[loss], scope=sc)
    finally:
        faultinject.clear()
    evs = _read(log)
    dispatch = [e for e in _spans(evs) if e["name"] == "executor/dispatch"]
    assert any(ev["name"] == "retry" for e in dispatch
               for ev in e.get("events", []))
    assert obs.registry().snapshot()["fault/retries"]["value"] == 1
    assert [e["event"] for e in evs if e["kind"] == "fault"] == [
        "injected", "retry"]


def test_truncated_final_line_counted_not_fatal(tmp_path):
    p = tmp_path / "torn.jsonl"
    good = ('{"ts": 1.0, "kind": "step", "steps": 2, "step_ms": 3.0,'
            ' "wall_ms": 6.0}\n')
    torn = '{"ts": 2.0, "kind": "step", "label": "café'.encode()[:-1]
    p.write_bytes(good.encode() + torn)
    s = obs.summarize_log(str(p))
    assert s["corrupt_lines"] == 1 and s["steps"]["steps"] == 2
    assert s == jexport.summarize_log(str(p))


@pytest.fixture
def shard():
    from paddle_tpu_torch.sparse.pserver import PServer
    srv = PServer(0, 1, host="127.0.0.1", io_timeout_s=10.0)
    srv.start()
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield [("127.0.0.1", srv.port)]
    srv.stop()
    t.join(timeout=5.0)


def test_remote_rounds_carry_the_trace_context(shard, tmp_path):
    from paddle_tpu_torch.observability import attribution
    from paddle_tpu_torch.sparse.client import RemoteSparseTable
    log = tmp_path / "wire.jsonl"
    flags.set_flag("metrics_log", str(log))
    rng = np.random.RandomState(0)
    on = RemoteSparseTable("t_on", 100, 4, addrs=shard, observe=True)
    off = RemoteSparseTable("t_off", 100, 4, addrs=shard, observe=False)
    try:
        for rt in (on, off):
            for _ in range(3):
                ids = rng.choice(100, 16, replace=False).astype(np.int64)
                rt.pull(ids)
                rt.push(ids, rng.rand(16, 4).astype("f4"))
    finally:
        on.close()
        off.close()
    spans = _spans(_read(log))
    client = [e for e in spans if e["name"] == "pserver/rpc"
              and (e.get("labels") or {}).get("side") != "server"]
    server = [e for e in spans if (e.get("labels") or {}).get("side")
              == "server"]
    # the observing client's 6 rounds; the observe-off one adds nothing
    assert len(client) == 6 and {e["labels"]["table"] for e in client} \
        == {"t_on"}
    assert len(server) == 6
    by_id = {e["span"]: e for e in client}
    for s in server:
        assert s["parent"] in by_id
        assert s["trace"] == by_id[s["parent"]]["trace"]
    for c in client:
        assert "srv_queue_ms" in c["labels"]
        assert "srv_kernel_ms" in c["labels"]
    rb = attribution.remote_budget(_read(log))
    assert rb["rounds"] == 6 and rb["attributed_rounds"] == 6
    assert rb["within_tolerance"]
