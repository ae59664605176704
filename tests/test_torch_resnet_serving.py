"""The ResNet serving slice end to end on the CPU: the JAX package's
startup weights carried into the port (``load_numpy_state``), both
forward passes compared, and the port's Server against a direct run and
against the JAX server on the same weights."""
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.serving import Model as JModel, Server as JServer
from paddle_tpu_torch import faults
from paddle_tpu_torch.serving import Model, ModelError, Server
from torch_parity import both, reset_both


@pytest.fixture(autouse=True)
def _fresh():
    reset_both()
    yield


def _imgs(n, hw, seed=3):
    return np.random.RandomState(seed).randn(n, 3, hw, hw).astype("float32")


def test_resnet50_forward_matches_jax_fp32():
    """Full ResNet-50 structure (all widths, 1000 classes) at 32x32,
    batch 2: softmax outputs at rtol 1e-4 / atol 1e-5."""
    m = both("resnet50", [3, 32, 32])
    (jprog, jpred, jscope), (tprog, tpred, tscope) = m["jax"], m["torch"]
    x = _imgs(2, 32)
    jo, = pt.Executor(pt.CPUPlace()).run(
        jprog, feed={"img": x}, fetch_list=[jpred], scope=jscope,
        is_test=True)
    to, = ptt.Executor(ptt.CPUPlace()).run(
        tprog, feed={"img": x}, fetch_list=[tpred], scope=tscope,
        is_test=True)
    assert to.shape == jo.shape == (2, 1000)
    np.testing.assert_allclose(to, jo, rtol=1e-4, atol=1e-5)


def test_resnet_cifar_amp_matches_jax_bf16():
    """Inference AMP (the whole net in bf16) on both sides: bf16
    tolerance 2e-2."""
    m = both("resnet_cifar", [3, 32, 32], depth=8)
    (jprog, jpred, jscope), (tprog, tpred, tscope) = m["jax"], m["torch"]
    x = _imgs(4, 32)
    jo, = pt.Executor(pt.CPUPlace(), amp=True).run(
        jprog, feed={"img": x}, fetch_list=[jpred], scope=jscope,
        is_test=True)
    exe = ptt.Executor(ptt.CPUPlace(), amp=True)
    to, = exe.run(tprog, feed={"img": x}, fetch_list=[tpred], scope=tscope,
                  is_test=True)
    assert to.dtype == np.float32            # bf16 widened on the host
    np.testing.assert_allclose(to, jo, rtol=2e-2, atol=2e-2)
    # the scope keeps its fp32 weights (AMP casts copies)
    w = next(p.name for p in tprog.all_parameters())
    assert tscope.get(w).dtype == torch.float32
    raw, = exe.run(tprog, feed={"img": x}, fetch_list=[tpred],
                   scope=tscope, is_test=True, return_numpy=False)
    assert raw.dtype == torch.bfloat16


def test_startup_runs_in_the_port():
    """The port's own startup program initializes every persistable
    with the declared shape and dtype (its generator differs from JAX's,
    so values are not compared)."""
    from torch_parity import build
    tm, ts, _ = build(ptt, "resnet_cifar", [3, 32, 32], depth=8)
    scope = ptt.Scope()
    ptt.Executor(ptt.CPUPlace()).run(ts, scope=scope)
    for v in tm.list_vars():
        if v.persistable:
            t = scope.get(v.name)
            assert tuple(t.shape) == v.shape and t.dtype == torch.float32
    bn_var = [v.name for v in tm.list_vars()
              if v.persistable and v.name.startswith("batch_norm")
              and ".global_1" in v.name][0]
    np.testing.assert_array_equal(scope.numpy(bn_var), 1.0)


def _served(srv, imgs):
    reqs = [srv.submit({"img": im}) for im in imgs]
    return np.stack([r.result(timeout=120)[0] for r in reqs])


def test_server_matches_direct_run_and_jax_server():
    m = both("resnet_cifar", [3, 32, 32], depth=8)
    (jprog, jpred, jscope), (tprog, tpred, tscope) = m["jax"], m["torch"]
    imgs = _imgs(8, 32, seed=9)
    exe = ptt.Executor(ptt.CPUPlace())
    srv = Server(max_batch=8, max_wait_ms=50, deadline_ms=None)
    srv.add_model(Model.from_program(exe, tprog, [tpred], scope=tscope,
                                     name="cifar",
                                     example={"img": imgs[0]}))
    srv.start()
    try:
        assert srv.ready()
        served = _served(srv, imgs)
        health = srv.health()["models"]["cifar"]
        assert health["served"] == 8 and health["breaker"] == "closed"
    finally:
        srv.shutdown(timeout=30)
    direct, = exe.run(tprog, feed={"img": imgs}, fetch_list=[tpred],
                      scope=tscope, is_test=True)
    np.testing.assert_allclose(served, direct, rtol=1e-5, atol=1e-6)

    jsrv = JServer(max_batch=8, max_wait_ms=50, deadline_ms=None)
    jsrv.add_model(JModel.from_program(pt.Executor(pt.CPUPlace()), jprog,
                                       [jpred], scope=jscope,
                                       example={"img": imgs[0]}))
    jsrv.start()
    try:
        jserved = _served(jsrv, imgs)
    finally:
        jsrv.shutdown(timeout=30)
    np.testing.assert_allclose(served, jserved, rtol=1e-4, atol=1e-5)


def _toy_server(fn=None, **kw):
    """A Server over a row-wise numpy model (doubles its input)."""
    srv = Server(warmup=False, **kw)
    srv.add_model(Model("toy", fn or (lambda f: [f["x"] * 2.0])))
    return srv.start()


def test_server_threads_joined_after_shutdown():
    srv = _toy_server(max_batch=4, max_wait_ms=1)
    names = {t.name for t in threading.enumerate()}
    assert {"pt-serving-batch-toy", "pt-serving-dispatch-toy"} <= names
    out = srv.infer({"x": np.ones(3, "float32")}, timeout=10)
    np.testing.assert_array_equal(out[0], 2.0)
    srv.shutdown(timeout=10)
    assert srv.state == "stopped"
    rt = srv._models["toy"]
    assert not rt.batcher.is_alive() and not rt.dispatcher.is_alive()
    assert not any(t.name.endswith("-toy") and t.is_alive()
                   for t in threading.enumerate())
    with pytest.raises(faults.ServerClosed):
        srv.submit({"x": np.ones(3, "float32")})


def test_server_buckets_pad_and_slice_rows():
    seen = []

    def fn(feeds):
        seen.append(feeds["x"].shape[0])
        return [feeds["x"] + 1.0]

    srv = _toy_server(fn, max_batch=8, max_wait_ms=100, deadline_ms=None)
    try:
        reqs = [srv.submit({"x": np.full(2, i, "float32")})
                for i in range(5)]
        outs = [r.result(timeout=10)[0] for r in reqs]
    finally:
        srv.shutdown(timeout=10)
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o, i + 1.0)
    assert all(b in (1, 2, 4, 8) for b in seen) and sum(seen) >= 5


def test_server_drain_completes_admitted_requests():
    gate = threading.Event()

    def slow(feeds):
        gate.wait(10)
        return [feeds["x"]]

    srv = _toy_server(slow, max_batch=2, max_wait_ms=1, deadline_ms=None)
    reqs = [srv.submit({"x": np.full(1, i, "float32")}) for i in range(6)]
    t = threading.Thread(target=srv.shutdown, kwargs={"timeout": 30})
    t.start()
    time.sleep(0.05)
    gate.set()
    t.join(30)
    assert not t.is_alive()
    assert [float(r.result(timeout=1)[0][0]) for r in reqs] == \
        [float(i) for i in range(6)]


def test_server_deadline_and_overload():
    gate = threading.Event()

    def blocked(feeds):
        gate.wait(10)
        return [feeds["x"]]

    srv = _toy_server(blocked, max_batch=1, max_wait_ms=1,
                      queue_capacity=2, staging_depth=1)
    x = {"x": np.zeros(1, "float32")}
    try:
        first = srv.submit(x, deadline_ms=None)
        time.sleep(0.05)                   # dispatcher now holds `first`
        staged = srv.submit(x, deadline_ms=None)
        time.sleep(0.05)                   # in the one staging slot
        held = srv.submit(x, deadline_ms=None)
        time.sleep(0.05)                   # batcher blocked staging it
        expiring = srv.submit(x, deadline_ms=50.0)
        keep = srv.submit(x, deadline_ms=None)
        assert srv.health()["models"]["toy"]["queue_depth"] == 2
        # queue full: the newcomer has the soonest deadline and is shed
        with pytest.raises(faults.Overloaded):
            srv.submit(x, deadline_ms=1.0)
        time.sleep(0.1)                    # `expiring` is now past due
        gate.set()
        for r in (first, staged, held, keep):
            assert r.result(timeout=10) is not None
        with pytest.raises(faults.DeadlineExceeded):
            expiring.result(timeout=10)
    finally:
        gate.set()
        srv.shutdown(timeout=10)


def test_server_breaker_opens_after_failures():
    def broken(feeds):
        raise ValueError("model is broken")

    srv = _toy_server(broken, max_batch=1, max_wait_ms=1,
                      breaker_threshold=2, breaker_cooldown_s=60)
    try:
        for _ in range(2):
            with pytest.raises(ModelError, match="broken"):
                srv.infer({"x": np.zeros(1, "float32")}, timeout=10)
        assert srv.health()["models"]["toy"]["breaker"] == "open"
        with pytest.raises(faults.ModelUnavailable):
            srv.submit({"x": np.zeros(1, "float32")})
    finally:
        srv.shutdown(timeout=10)


def test_stack_and_pad_match_jax():
    from paddle_tpu.core import pad_batch as jpad, stack_feeds as jstack
    feeds = [{"a": np.full((2, 3), i, "float32"), "b": np.array([i])}
             for i in range(3)]
    t = ptt.pad_batch(ptt.stack_feeds(feeds), 4)
    j = jpad(jstack(feeds), 4)
    assert t.keys() == j.keys()
    for k in t:
        np.testing.assert_array_equal(t[k], j[k])
    with pytest.raises(ValueError):
        ptt.pad_batch(ptt.stack_feeds(feeds), 2)
    with pytest.raises(ValueError):
        ptt.stack_feeds([{"a": 1}, {"b": 2}])
