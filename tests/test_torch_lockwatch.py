"""The port's lock-order watchdog (``paddle_tpu_torch/testing/
lockwatch.py``) against the JAX package's ``tests/test_lockwatch.py``.

* Off (the default): the factories return plain ``threading``
  primitives, and a steady-state executor loop moves no
  ``concurrency/*`` metric and captures no new key.
* On: every acquisition through a watched primitive feeds the
  acquisition-order graph; an inversion raises ``LockOrderViolation``
  before blocking, naming both lock classes with both stacks; a
  non-reentrant self-acquire raises; RLock re-entry does not; a
  Condition round trip works; long holds feed the hold metrics.  The
  same scripted acquisitions give the same graph in both packages.
* The port's threaded subsystems (the request server, the decode pool,
  the sparse session's async push, the checkpoint writer) run clean
  under the watch.
"""
import json
import threading
import time

import numpy as np
import pytest

import paddle_tpu_torch as ptt
from paddle_tpu.testing import lockwatch as jlw
from paddle_tpu_torch import layers
from paddle_tpu_torch.core import compile_cache
from paddle_tpu_torch.observability import export
from paddle_tpu_torch.observability import metrics as obs
from paddle_tpu_torch.testing import lockwatch as lw
from paddle_tpu_torch.testing.lockwatch import LockOrderViolation

CPU = ptt.CPUPlace()


@pytest.fixture
def watch():
    """The port's watch on for one test; its graph isolated."""
    prior = lw.ENABLED
    lw.ENABLED = True
    lw.reset()
    yield lw
    lw.ENABLED = prior
    lw.reset()


@pytest.fixture
def both_watch():
    """Both packages' watches on, graphs isolated."""
    prior = (lw.ENABLED, jlw.ENABLED)
    lw.ENABLED = jlw.ENABLED = True
    lw.reset()
    jlw.reset()
    yield
    lw.ENABLED, jlw.ENABLED = prior
    lw.reset()
    jlw.reset()


def _concurrency_snapshot():
    return {k: v for k, v in obs.registry().snapshot().items()
            if k.startswith("concurrency/")}


def _counter(name):
    return obs.registry().snapshot()[name]["value"]


# ---------------------------------------------------------------------------
# off
# ---------------------------------------------------------------------------
def test_off_factories_return_plain_primitives():
    assert not lw.ENABLED
    assert type(lw.make_lock("t")) is type(threading.Lock())
    assert type(lw.make_rlock("t")) is type(threading.RLock())
    assert type(lw.make_condition("t")) is threading.Condition
    raw = threading.Lock()
    assert type(lw.make_condition("t", raw)) is threading.Condition


def test_off_zero_per_step_work(rng):
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start):
        x = layers.data("x", shape=[4], dtype="float32")
        loss = layers.mean(layers.fc(x, size=3, act="softmax"))
    feed = {"x": rng.rand(8, 4).astype("float32")}
    sc = ptt.Scope()
    exe = ptt.Executor(CPU)
    exe.run(start, scope=sc)
    exe.run(main, feed=feed, fetch_list=[loss], scope=sc)
    before = _concurrency_snapshot()
    c0 = compile_cache.stats().snapshot()
    for _ in range(5):
        exe.run(main, feed=feed, fetch_list=[loss], scope=sc)
    c1 = compile_cache.stats().snapshot()
    assert _concurrency_snapshot() == before
    assert c1["captures"] == c0["captures"]
    assert lw.graph() == {} and lw.violations() == []


# ---------------------------------------------------------------------------
# on
# ---------------------------------------------------------------------------
def test_on_records_acquisition_order_edges(watch):
    a, b = lw.make_lock("fx.a"), lw.make_lock("fx.b")
    for _ in range(2):
        with a:
            with b:
                pass
    assert lw.graph() == {"fx.a": ("fx.b",)}


@pytest.mark.parametrize("script", [
    [("a", "b")],
    [("a", "b"), ("b", "c"), ("a", "c")],
    [("x", "y"), ("x", "z"), ("y", "z"), ("x", "y")],
])
def test_graph_matches_the_jax_watch(both_watch, script):
    """The same nested acquisitions give the same order graph."""
    graphs = []
    for mod in (jlw, lw):
        locks = {}
        for outer, inner in script:
            lo = locks.setdefault(outer, mod.make_lock(f"fx.{outer}"))
            li = locks.setdefault(inner, mod.make_lock(f"fx.{inner}"))
            with lo:
                with li:
                    pass
        graphs.append(mod.graph())
    assert graphs[0] == graphs[1]


def test_on_inversion_raises_before_blocking(watch):
    a, b = lw.make_lock("fx.a"), lw.make_lock("fx.b")
    with a:
        with b:
            pass
    before = _counter("concurrency/order_violations")
    with b:
        with pytest.raises(LockOrderViolation) as ei:
            a.acquire()
    v = ei.value
    assert v.acquiring == "fx.a" and v.holding == "fx.b"
    report = v.report()
    assert "fx.a" in report and "fx.b" in report
    assert v.current_stack.strip() and v.reverse_stack.strip()
    assert [x.path for x in lw.violations()] == [v.path]
    assert _counter("concurrency/order_violations") == before + 1


def test_on_inversion_is_deterministic(watch):
    for _ in range(3):
        lw.reset()
        a, b = lw.make_lock("fx.a"), lw.make_lock("fx.b")
        with a:
            with b:
                pass
        with b:
            with pytest.raises(LockOrderViolation):
                with a:
                    pass


def test_on_rlock_reentry_is_not_a_violation(watch):
    r = lw.make_rlock("fx.r")
    with r:
        with r:
            pass
    assert lw.graph() == {} and lw.violations() == []


def test_on_nonreentrant_self_deadlock_raises(watch):
    m = lw.make_lock("fx.m")
    m.acquire()
    try:
        with pytest.raises(LockOrderViolation):
            m.acquire()
    finally:
        m.release()


def test_on_condition_roundtrip(watch):
    lock = lw.make_lock("fx.box")
    cond = lw.make_condition("fx.box", lock)
    state = {"item": None}

    def produce():
        with cond:
            state["item"] = 42
            cond.notify()

    t = threading.Thread(target=produce, name="pt-reader-fx-producer",
                         daemon=True)
    with cond:
        t.start()
        assert cond.wait_for(lambda: state["item"] is not None,
                             timeout=5.0)
        assert lock.locked()
    t.join(timeout=5.0)
    assert lw.violations() == []


def test_on_hold_metrics(watch, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_LOCKWATCH_HOLD_MS", "1")
    held0 = obs.registry().snapshot()["concurrency/lock_held_ms"]
    long0 = _counter("concurrency/long_holds")
    m = lw.make_lock("fx.slowpoke")
    with m:
        time.sleep(0.01)
    held1 = obs.registry().snapshot()["concurrency/lock_held_ms"]
    assert held1["count"] == held0["count"] + 1
    assert held1["max"] >= 1.0
    assert _counter("concurrency/long_holds") == long0 + 1


def test_summary_lockwatch_section(watch, tmp_path):
    a, b = lw.make_lock("fx.a"), lw.make_lock("fx.b")
    with a:
        with b:
            pass
    snap = export.metrics_snapshot()
    p = tmp_path / "run.jsonl"
    p.write_text(json.dumps({"ts": 1.0, "kind": "snapshot", **snap}) + "\n")
    lk = export.summarize_log(str(p))["lockwatch"]
    assert lk["holds"] >= 2 and lk["order_edges"] >= 1
    assert "lockwatch:" in export.render_summary(export.summarize_log(
        str(p)))


# ---------------------------------------------------------------------------
# the port's threaded subsystems under the watch
# ---------------------------------------------------------------------------
def test_server_and_decode_pool_run_clean_under_the_watch(watch):
    from paddle_tpu_torch.serving import Model, Server
    from paddle_tpu_torch.serving.decode import DecodeEngine
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start):
        x = layers.data("x", shape=[4], dtype="float32")
        y = layers.fc(x, size=3)
    sc = ptt.Scope()
    exe = ptt.Executor(CPU)
    exe.run(start, scope=sc)
    srv = Server(max_batch=4, max_wait_ms=1.0, deadline_ms=None)
    srv.add_model(Model.from_program(exe, main, [y], name="fc", scope=sc,
                                     example={"x": np.ones(4, "f4")}))
    eng = DecodeEngine(vocab_size=16, hidden_dim=8, slots=2, max_len=16,
                       place=CPU, use_jit=False)
    srv.add_decode_model(eng, name="dec")
    held0 = obs.registry().snapshot()["concurrency/lock_held_ms"]["count"]
    srv.start()
    try:
        outs = [srv.submit({"x": np.full(4, i, "f4")}, model="fc")
                for i in range(6)]
        gens = [srv.submit_decode([1, 2, 3], 4, model="dec")
                for _ in range(3)]
        for r in outs + gens:
            r.result(timeout=60)
    finally:
        srv.shutdown(drain=True, timeout=60)
    assert lw.violations() == []
    # the server's and the pool's locks were watched ones
    assert obs.registry().snapshot()["concurrency/lock_held_ms"][
        "count"] > held0


def test_sparse_async_push_and_checkpoint_writer_clean(watch, tmp_path):
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.sparse import SparseSession, SparseTable
    t = SparseTable("emb", 64, 4, optimizer="sgd", learning_rate=0.1)
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start):
        ids = layers.data("ids", shape=[1], dtype="int64")
        emb = layers.embedding(ids, size=[64, 4], name="emb", sparse=True)
        loss = layers.mean(emb)
        ptt.optimizer.SGD(0.1).minimize(loss)
    sess = SparseSession(t, async_push=2)
    sess.bind(main)
    sc = ptt.Scope()
    exe = ptt.Executor(CPU)
    exe.run(start, scope=sc)
    rng = np.random.RandomState(0)
    for _ in range(4):
        sess.run(exe, main, {"ids": rng.randint(0, 64, (8, 1))}, [loss],
                 scope=sc)
    sess.flush()
    cm = CheckpointManager(str(tmp_path), device="cpu")
    cm.save(1, sc, blocking=False)
    cm.wait()
    assert lw.violations() == []
