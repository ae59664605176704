"""The port's serving fleet on the CPU (paddle_tpu_torch/serving/fleet.py),
in-process half: the counterparts of ``tests/test_fleet.py``'s 12 tests
over :class:`LocalReplica` members of fake models (the queue-depth
router, health-state eviction and re-add, breaker eviction, death
failover, the fleet-rim backlog shed, cordon, the autoscaling policy
matrix and an end-to-end scale-out/in round, the fleet behind the HTTP
front), and parity against the JAX package:

* ``AutoscalePolicy.decide`` gives the same decision on the same
  snapshot matrix in both packages;
* an MLP (8 -> 32 -> 4) and a reduced bottleneck ResNet (64 x 64), each
  built in the JAX package with its startup scope carried across and
  exported by each package, served through each package's
  ``FleetRouter`` + ``HttpFront``: the same requests give the same status
  codes, and the outputs agree within ``JAX_TOL``;
* the ``serve`` protocol's reply lines (``serving/cli.py``'s
  ``_handle_line``) for the same request lines agree field for field.

Real multi-process rounds are in tests/test_torch_fleet_chaos.py
(``@slow``)."""
import http.client
import io
import json
import threading
import time

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch import faults
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.serving.fleet import (AutoscalePolicy, FleetRouter,
                                            LocalReplica)
from torch_parity import jax_state, reset_both
from torch_serving_fakes import FakeModel, mk_server, req

# the port's artifact against the JAX package's (XLA on the CPU): fp32,
# another summation order (tests/test_torch_export.py's tolerance)
JAX_TOL = dict(rtol=1e-5, atol=1e-5)


def _counter(name):
    return obs.registry().snapshot()[name]["value"]


class _FleetFixture:
    """N FakeModel-backed LocalReplicas behind a router; keeps handles
    to every fake and server for gating/poisoning."""

    def __init__(self, n=2, policy=None, server_kw=None, **router_kw):
        self.fakes = []
        self.servers = []
        self.server_kw = dict(server_kw or {})

        def factory(i):
            fake = FakeModel()
            srv = mk_server(fake, **self.server_kw)
            self.fakes.append(fake)
            self.servers.append(srv)
            return LocalReplica(srv, name=f"rep{i}")

        router_kw.setdefault("poll_interval_s", 0.02)
        self.router = FleetRouter(factory, replicas=n, autoscale=policy,
                                  **router_kw)
        self.router.start()

    def replica(self, i) -> LocalReplica:
        return self.router.replicas[i]

    def shutdown(self):
        self.router.shutdown(timeout_s=20)


@pytest.fixture
def fleet2():
    f = _FleetFixture(n=2)
    yield f
    f.shutdown()


def test_router_serves_and_health_aggregates(fleet2):
    out = fleet2.router.submit(req(1)).result(timeout=10)
    np.testing.assert_array_equal(out[0], np.full(2, 2.0, "float32"))
    h = fleet2.router.health()
    assert h["ready"] is True and h["state"] == "ready"
    assert sorted(h["replicas"]) == ["rep0", "rep1"]
    assert all(v["routable"] for v in h["replicas"].values())


def test_routes_to_least_loaded_replica():
    f = _FleetFixture(n=2, server_kw={"deadline_ms": None})
    try:
        # build real queue depth on rep0 by gating its model
        f.fakes[0].gate = threading.Event()
        held = [f.servers[0].submit(req(100 + i)) for i in range(4)]
        f.router._poll_all()              # refresh the routing signal
        assert f.replica(0).queue_depth() > 0
        out = f.router.submit(req(5)).result(timeout=10)
        assert out is not None
        assert 5.0 in f.fakes[1].rows     # routed around the deep queue
        assert 5.0 not in f.fakes[0].rows
        f.fakes[0].open_gate_forever()
        for r in held:
            assert r.result(timeout=10) is not None
    finally:
        f.fakes[0].open_gate_forever()
        f.shutdown()


def test_draining_replica_is_evicted(fleet2):
    rep0 = fleet2.replica(0)              # before the reaper drops it
    before = _counter("fleet/evictions")
    rep0.server.begin_drain()
    fleet2.router._poll_all()
    assert not fleet2.router._is_routable(rep0)
    assert _counter("fleet/evictions") >= before + 1
    for i in range(3):
        fleet2.router.submit(req(i)).result(timeout=10)
    assert not fleet2.fakes[0].rows       # all routed to the survivor
    assert len(fleet2.fakes[1].rows) == 3


def test_breaker_open_is_an_eviction_signal_and_readds():
    f = _FleetFixture(n=2, server_kw={"breaker_threshold": 1,
                                      "breaker_cooldown_s": 0.05})
    try:
        f.fakes[0].fail = [RuntimeError("poison")]
        with pytest.raises(Exception):
            f.servers[0].infer(req(1), timeout=10)
        assert f.servers[0].health()["models"]["fake"]["breaker"] == "open"
        f.router._poll_all()
        assert not f.router._is_routable(f.replica(0))   # evicted
        f.router.submit(req(2)).result(timeout=10)
        assert 2.0 in f.fakes[1].rows
        # cooldown passes; a successful probe recloses -> re-added
        time.sleep(0.1)
        f.servers[0].infer(req(3), timeout=10)
        f.router._poll_all()
        assert f.router._is_routable(f.replica(0))
    finally:
        f.shutdown()


def test_replica_death_fails_over_admitted_requests_zero_drop():
    """A replica aborting admitted work (the in-process analog of
    SIGKILL) must not surface to the client: the router resubmits to a
    survivor and the ONE client handle completes with real outputs."""
    f = _FleetFixture(n=2, server_kw={"deadline_ms": None,
                                      "max_batch": 1,
                                      "staging_depth": 1},
                      poll_interval_s=30.0)   # manual polls only
    try:
        rep0, rep1 = f.replica(0), f.replica(1)
        f.fakes[0].gate = threading.Event()
        # park rep1 (stale health = unroutable) so every submit lands on
        # rep0: fp1 dispatching (gated), fp2 staged, fp3 in the blocked
        # batcher's hands, fp4 in the ADMISSION QUEUE
        rep1.last_health_ts = 0.0
        fps = [f.router.submit(req(10 + i)) for i in range(4)]
        time.sleep(0.2)
        rep1.poll_health()                # survivor back in the pool
        before = _counter("fleet/failovers")
        killer = threading.Thread(target=rep0.kill, daemon=True)
        killer.start()                    # aborts fp4 (queued) first
        time.sleep(0.1)
        f.fakes[0].open_gate_forever()    # free the wedged dispatches
        killer.join(timeout=15)
        for fp in fps:
            out = fp.result(timeout=15)   # all complete despite the kill
            assert out is not None
        assert _counter("fleet/failovers") >= before + 1
        served = sorted(set(f.fakes[0].rows + f.fakes[1].rows))
        assert served == [10.0, 11.0, 12.0, 13.0]     # none lost
        assert 13.0 in f.fakes[1].rows    # the aborted one failed over
    finally:
        f.fakes[0].open_gate_forever()
        f.shutdown()


def test_router_backlog_limit_sheds_at_the_fleet_rim():
    """With every ready replica at the backlog limit, the router rejects
    Overloaded WITHOUT paying the replica's wire+parse."""
    f = _FleetFixture(n=1, server_kw={"deadline_ms": None},
                      backlog_limit=2, poll_interval_s=30.0)
    try:
        before = _counter("fleet/router_shed")
        f.fakes[0].gate = threading.Event()
        fp1 = f.router.submit(req(1))    # dispatching (gated)
        fp2 = f.router.submit(req(2))    # backlog 2 = at the limit
        with pytest.raises(faults.Overloaded, match="fleet saturated"):
            f.router.submit(req(3))
        assert _counter("fleet/router_shed") == before + 1
        assert 3.0 not in f.fakes[0].rows      # never hit the replica
        f.fakes[0].open_gate_forever()
        assert fp1.result(timeout=10) is not None
        assert fp2.result(timeout=10) is not None
    finally:
        f.fakes[0].open_gate_forever()
        f.shutdown()


def test_cordon_removes_and_readds_without_touching_the_process(fleet2):
    fleet2.router.cordon("rep0")
    for i in range(3):
        fleet2.router.submit(req(i)).result(timeout=10)
    assert not fleet2.fakes[0].rows       # all routed around the cordon
    assert fleet2.replica(0).alive        # process untouched
    fleet2.router.cordon("rep0", cordoned=False)
    fleet2.replica(1).cordoned = True     # force the other way
    fleet2.router.submit(req(9)).result(timeout=10)
    assert 9.0 in fleet2.fakes[0].rows
    with pytest.raises(ValueError):
        fleet2.router.cordon("ghost")


def test_fleet_draining_rejects_typed(fleet2):
    fleet2.router.begin_drain()
    with pytest.raises(faults.ServerClosed):
        fleet2.router.submit(req(1))
    assert fleet2.router.health()["ready"] is False


def test_no_routable_replica_raises_model_unavailable():
    f = _FleetFixture(n=1)
    try:
        f.replica(0).server.begin_drain()
        f.router._poll_all()
        with pytest.raises(faults.ModelUnavailable):
            f.router.submit(req(1))
    finally:
        f.shutdown()


# ---------------------------------------------------------------------------
# autoscaling policy (pure decision matrix) + e2e apply
# ---------------------------------------------------------------------------
def _snap(**kw):
    base = {"replicas": 2, "p99_ms": 100.0, "wait_share_p99": 0.8,
            "queue_depth": 4, "served_per_s": 50.0, "idle_s": 0.0,
            "since_last_decision_s": 1e9}
    base.update(kw)
    return base


POLICY_KW = dict(wait_share_threshold=0.5, p99_floor_ms=20.0,
                 idle_rate_per_replica=1.0, idle_for_s=5.0,
                 min_replicas=1, max_replicas=4, cooldown_s=2.0)
IDLE = dict(wait_share_p99=0.0, p99_ms=1.0, queue_depth=0,
            served_per_s=0.0, idle_s=10.0)
SNAP_MATRIX = [
    _snap(),                                        # scale-out
    _snap(wait_share_p99=0.2),                      # dispatch-dominated
    _snap(p99_ms=5.0),                              # under the floor
    _snap(p99_ms=None, wait_share_p99=None),        # no window yet
    _snap(replicas=4),                              # at max replicas
    _snap(since_last_decision_s=0.5),               # cooldown
    _snap(**IDLE),                                  # scale-in
    _snap(replicas=1, **IDLE),                      # at min replicas
    _snap(**dict(IDLE, queue_depth=3)),             # queue non-empty
    _snap(**dict(IDLE, idle_s=4.9)),                # not idle long enough
    _snap(**dict(IDLE, served_per_s=1.99)),         # under 1/s a replica
    _snap(**dict(IDLE, served_per_s=2.0)),          # at the rate floor
    _snap(wait_share_p99=0.5, p99_ms=20.0),         # both at threshold
    {},                                             # empty snapshot
]


def test_autoscale_policy_matrix():
    pol = AutoscalePolicy(**POLICY_KW)
    d = pol.decide(_snap())
    assert d and d["action"] == "scale_out"
    assert "queue-wait share" in d["reason"]
    assert pol.decide(_snap(wait_share_p99=0.2)) is None
    assert pol.decide(_snap(p99_ms=5.0)) is None
    assert pol.decide(_snap(p99_ms=None, wait_share_p99=None)) is None
    assert pol.decide(_snap(replicas=4)) is None
    assert pol.decide(_snap(since_last_decision_s=0.5)) is None
    d = pol.decide(_snap(**IDLE))
    assert d and d["action"] == "scale_in"
    assert pol.decide(_snap(replicas=1, **IDLE)) is None
    assert pol.decide(_snap(**dict(IDLE, queue_depth=3))) is None
    with pytest.raises(ValueError):
        AutoscalePolicy(min_replicas=0)
    with pytest.raises(ValueError):
        AutoscalePolicy(min_replicas=3, max_replicas=2)


def test_autoscale_decisions_match_jax():
    """The same policy on the same snapshot matrix: the same decision,
    reason text and rounded figures in both packages."""
    from paddle_tpu.serving.fleet import AutoscalePolicy as JPolicy
    for kw in (POLICY_KW, {}, dict(POLICY_KW, min_replicas=2,
                                   idle_rate_per_replica=0.5)):
        pol, jpol = AutoscalePolicy(**kw), JPolicy(**kw)
        for snap in SNAP_MATRIX:
            assert pol.decide(dict(snap)) == jpol.decide(dict(snap)), snap
    for bad in (dict(min_replicas=0), dict(min_replicas=3, max_replicas=2)):
        with pytest.raises(ValueError) as e:
            AutoscalePolicy(**bad)
        with pytest.raises(ValueError) as je:
            JPolicy(**bad)
        assert str(e.value) == str(je.value)


def test_autoscale_apply_scales_out_then_in():
    # policy held OUTSIDE the router (no timer thread): the test drives
    # snapshot -> decide -> apply deterministically
    pol = AutoscalePolicy(wait_share_threshold=0.5, p99_floor_ms=1.0,
                          idle_rate_per_replica=1.0, idle_for_s=0.0,
                          min_replicas=1, max_replicas=3, cooldown_s=0.0)
    f = _FleetFixture(n=1)
    try:
        with f.router._lock:
            for _ in range(32):
                f.router._window.append((100.0, 5.0))
        outs_before = _counter("fleet/scale_outs")
        snap = f.router.autoscale_snapshot()
        decision = pol.decide(snap)
        assert decision and decision["action"] == "scale_out"
        f.router.apply_decision(decision, snap)
        assert len(f.router.replicas) == 2
        assert _counter("fleet/scale_outs") == outs_before + 1
        f.router._poll_all()
        assert len(f.router._routable()) == 2
        for i in range(4):
            f.router.submit(req(i)).result(timeout=10)
        # now idle: scale back in through graceful drain
        with f.router._lock:
            f.router._window.clear()
        f.router.autoscale_snapshot()     # reset the served-rate window
        time.sleep(0.05)
        f.router._idle_since = time.monotonic() - 60.0
        ins_before = _counter("fleet/scale_ins")
        snap = f.router.autoscale_snapshot()
        snap["idle_s"] = 60.0
        decision = pol.decide(snap)
        assert decision and decision["action"] == "scale_in"
        f.router.apply_decision(decision, snap)
        assert _counter("fleet/scale_ins") == ins_before + 1
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            f.router._poll_all()
            f.router._reap_stopped()
            if len(f.router.replicas) == 1:
                break
            time.sleep(0.05)
        assert len(f.router.replicas) == 1   # drained + reaped
        f.router.submit(req(9)).result(timeout=10)
    finally:
        f.shutdown()


def test_fleet_behind_http_front(fleet2):
    """The router exposes the server surface, so the HTTP front fronts
    a fleet unchanged — including drain -> 503 + Connection: close."""
    from paddle_tpu_torch.serving.http import HttpFront

    front = HttpFront(fleet2.router, port=0).start()
    try:
        host, port = front.address
        conn = http.client.HTTPConnection(host, port, timeout=10)
        conn.request("POST", "/v1/infer",
                     body=json.dumps({"id": 1, "feeds": {"x": [1.0, 2.0]}}))
        resp = conn.getresponse()
        body = json.loads(resp.read())
        assert resp.status == 200 and body["outputs"] == [[2.0, 4.0]]
        conn.close()
        fleet2.router.begin_drain()
        conn = http.client.HTTPConnection(host, port, timeout=10)
        conn.request("POST", "/v1/infer",
                     body=json.dumps({"id": 2, "feeds": {"x": [1.0, 2.0]}}))
        resp = conn.getresponse()
        assert resp.status == 503
        assert resp.getheader("Connection", "").lower() == "close"
        conn.close()
    finally:
        front.stop()


# ---------------------------------------------------------------------------
# parity: the same artifacts served by both packages' fleets
# ---------------------------------------------------------------------------
def _mlp(pkg):
    x = pkg.layers.data("x", shape=[8], dtype="float32")
    h = pkg.layers.fc(x, size=32, act="relu")
    return pkg.layers.fc(h, size=4, act="softmax")


def _resnet(pkg):
    """A reduced bottleneck ResNet at 64 x 64: the stem, two bottleneck
    blocks (128- and 512-wide 1x1 convs, the second strided), global
    pooling and a 10-way head."""
    from importlib import import_module
    R = import_module(pkg.__name__ + ".models.resnet")
    img = pkg.layers.data("img", [3, 64, 64])
    h = R.conv_bn_layer(img, 32, 3, 2, 1)
    h = R.bottleneck_block(h, 32, 128, 1)
    h = R.bottleneck_block(h, 512, 128, 2)
    h = pkg.layers.pool2d(h, pool_type="avg", global_pooling=True)
    return pkg.layers.fc(h, size=10, act="softmax")


def _export_both(build, spec, tmp_path, seed=3):
    """``build`` in both packages, the JAX startup scope carried into the
    port, each package's artifact exported: (jax_dir, port_dir)."""
    reset_both()
    progs = {}
    for pkg in (pt, ptt):
        pkg.unique_name.reset()
        main, startup = pkg.Program(), pkg.Program()
        startup.random_seed = seed
        with pkg.program_guard(main, startup):
            pred = build(pkg)
        progs[pkg] = (main.clone(for_test=True), startup, pred)
    jm, js, jp = progs[pt]
    tm, _ts, tp = progs[ptt]
    jscope = pt.core.Scope()
    pt.Executor(pt.CPUPlace()).run(js, scope=jscope)
    tscope = ptt.Scope()
    ptt.load_numpy_state(tscope, jax_state(jscope), "cpu")
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    pt.export_compiled_model(jdir, spec, [jp], main_program=jm,
                             scope=jscope)
    ptt.export_compiled_model(tdir, spec, [tp], main_program=tm,
                              scope=tscope, device="cpu")
    reset_both()
    return jdir, tdir


def _fleet_and_front(pkg, model_dir, n=2):
    """``pkg``'s FleetRouter of ``n`` LocalReplicas serving the artifact
    as tenant ``m``, behind its HttpFront with a token table."""
    from importlib import import_module
    fleet = import_module(pkg.__name__ + ".serving.fleet")
    httpm = import_module(pkg.__name__ + ".serving.http")
    serving = import_module(pkg.__name__ + ".serving")
    kw = {"device": "cpu"} if pkg is ptt else {}

    def factory(i):
        srv = serving.Server(max_batch=4, max_wait_ms=2.0,
                             deadline_ms=5000.0, warmup=False)
        srv.add_model(serving.Model.from_artifact(model_dir, name="m",
                                                  **kw))
        return fleet.LocalReplica(srv.start(), name=f"rep{i}")

    router = fleet.FleetRouter(factory, replicas=n,
                               poll_interval_s=0.02).start()
    front = httpm.HttpFront(router, port=0,
                            tokens={"tok": "m", "open": None}).start()
    return router, front


def _exchange(front, method, path, body=None, headers=None):
    host, port = front.address
    conn = http.client.HTTPConnection(host, port, timeout=60)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        data = resp.read().decode("utf-8")
    finally:
        conn.close()
    lines = [json.loads(ln) for ln in data.splitlines() if ln.strip()] \
        if path != "/metrics" else data
    return resp.status, lines


def _parity_requests(name, shape, rng):
    """(method, path, body, headers) of the round: good single and
    multi-line requests, the header deadline, auth failures, malformed
    bodies, a mis-shaped feed, an unknown model, health and 404s."""
    def line(i, **kw):
        return json.dumps({"id": i, "feeds": {
            name: rng.rand(*shape).astype("float32").tolist()}, **kw})

    tok = {"X-Paddle-Token": "tok"}
    out = [("POST", "/v1/infer", line(i), tok) for i in range(6)]
    out += [
        ("POST", "/v1/infer", "\n".join(line(10 + i) for i in range(3)),
         tok),
        ("POST", "/v1/infer", line(20, model="m"),
         {"Authorization": "Bearer open"}),
        ("POST", "/v1/infer", line(21, deadline_ms=None),
         dict(tok, **{"X-Paddle-Deadline-Ms": "0.001"})),
        ("POST", "/v1/infer", line(22), None),                    # 401
        ("POST", "/v1/infer", line(23), {"X-Paddle-Token": "bad"}),  # 401
        ("POST", "/v1/infer", line(24, model="other"), tok),      # 403
        ("POST", "/v1/infer", "not json", tok),                   # 400
        ("POST", "/v1/infer", json.dumps({"id": 25}), tok),       # 400
        ("POST", "/v1/infer", json.dumps(
            {"id": 26, "feeds": {name: [0.5]}}), tok),            # 400
        ("POST", "/v1/infer", line(27, model="ghost"),
         {"Authorization": "Bearer open"}),                       # 400
        ("POST", "/nope", "{}", tok),                             # 404
        ("GET", "/healthz", None, None),
        ("GET", "/nope", None, None),
    ]
    return out


@pytest.mark.parametrize("model", ["mlp", "resnet"])
def test_fleet_http_round_matches_jax(model, tmp_path):
    """The same requests through both packages' FleetRouter + HttpFront:
    the same status codes, the same response ids, models and error
    types, and outputs within JAX_TOL (the port's conv and matmul sum in
    another order than XLA)."""
    if model == "mlp":
        name, shape, build = "x", (8,), _mlp
    else:
        name, shape, build = "img", (3, 64, 64), _resnet
    jdir, tdir = _export_both(build, {name: ((-1,) + shape, "float32")},
                              tmp_path)
    got = {}
    for pkg, d in ((pt, jdir), (ptt, tdir)):
        router, front = _fleet_and_front(pkg, d)
        try:
            got[pkg] = [_exchange(front, *r) for r in _parity_requests(
                name, shape, np.random.RandomState(7))]
        finally:
            front.stop()
            router.shutdown(timeout_s=30)
    assert [s for s, _ in got[ptt]] == [s for s, _ in got[pt]]
    assert [s for s, _ in got[ptt]] == [200] * 9 + [401, 401, 403, 400, 400,
                                                400, 400, 404, 200, 404]
    n_out = 0
    for (_, tl), (_, jl) in zip(got[ptt], got[pt]):
        if isinstance(tl, dict) or isinstance(jl, dict):
            tl, jl = [tl], [jl]
        key = (lambda o: -1 if o.get("id") is None else o["id"])
        tl, jl = sorted(tl, key=key), sorted(jl, key=key)
        assert len(tl) == len(jl)
        for t, j in zip(tl, jl):
            if "health" in t or "replicas" in t:
                assert set(t) == set(j)
                assert sorted(t["replicas"]) == sorted(j["replicas"])
                continue
            assert set(t) == set(j), (t, j)
            assert {k: t[k] for k in ("id", "model", "error") if k in t} \
                == {k: j[k] for k in ("id", "model", "error") if k in j}
            if "outputs" in t:
                np.testing.assert_allclose(np.asarray(t["outputs"]),
                                           np.asarray(j["outputs"]),
                                           **JAX_TOL)
                n_out += 1
    assert n_out == 11


def _cli_server(pkg, model_dir):
    from importlib import import_module
    serving = import_module(pkg.__name__ + ".serving")
    kw = {"device": "cpu"} if pkg is ptt else {}
    srv = serving.Server(max_batch=4, max_wait_ms=1.0, deadline_ms=5000.0,
                         warmup=False)
    srv.add_model(serving.Model.from_artifact(model_dir, name="m", **kw))
    return srv.start()


def test_serve_protocol_replies_match_jax(tmp_path):
    """``serve``'s reply lines for the same request lines agree field for
    field: the same keys, ids, models, error types and health states,
    and outputs within JAX_TOL ("ms"/"dispatch_ms" are timings)."""
    from importlib import import_module
    jdir, tdir = _export_both(_mlp, {"x": ((-1, 8), "float32")}, tmp_path)
    rng = np.random.RandomState(11)
    lines = [json.dumps({"id": i, "feeds": {
        "x": rng.rand(8).astype("float32").tolist()}}) for i in range(4)]
    lines += [
        json.dumps({"id": "d", "model": "m", "deadline_ms": None,
                    "feeds": {"x": [0.25] * 8}}),
        json.dumps({"id": "c", "feeds": {"x": [0.5] * 8},
                    "ctx": "1:tdead-1:beef-2"}),
        json.dumps({"cmd": "health", "id": "h"}),
        json.dumps({"cmd": "health", "id": "hm", "metrics": True}),
        "not json",
        json.dumps({"id": 9}),
        json.dumps({"id": 10, "feeds": {"x": [1.0, 2.0]}}),
        json.dumps({"id": 11, "model": "ghost", "feeds": {"x": [0.5] * 8}}),
        json.dumps({"id": 12, "feeds": {"y": [0.5] * 8}}),
    ]
    replies = {}
    for pkg, d in ((pt, jdir), (ptt, tdir)):
        cli = import_module(pkg.__name__ + ".serving.cli")
        srv = _cli_server(pkg, d)
        fh = io.StringIO()
        emitter = cli._Emitter(fh)
        cb = cli._response_cb(emitter)
        try:
            admitted = [cli._handle_line(srv, emitter, cb, ln)
                        for ln in lines]
        finally:
            srv.shutdown(drain=True, timeout=30)
        out = [json.loads(ln) for ln in fh.getvalue().splitlines()]
        replies[pkg] = (admitted, sorted(
            out, key=lambda o: json.dumps(o.get("id"))))
    (t_adm, t_out), (j_adm, j_out) = replies[ptt], replies[pt]
    assert t_adm == j_adm == [1] * 6 + [0] * 7
    assert len(t_out) == len(j_out) == len(lines)
    for t, j in zip(t_out, j_out):
        assert set(t) == set(j), (t, j)
        for k in ("id", "model", "error"):
            assert t.get(k) == j.get(k), (k, t, j)
        if "outputs" in t:
            np.testing.assert_allclose(np.asarray(t["outputs"]),
                                       np.asarray(j["outputs"]), **JAX_TOL)
            assert t["ms"] >= 0 and t["dispatch_ms"] is not None
        if "health" in t:
            assert t["health"]["state"] == j["health"]["state"]
            assert sorted(t["health"]["models"]) == \
                sorted(j["health"]["models"])
        if "identity" in t:
            assert t["identity"]["role"] == j["identity"]["role"]
            assert isinstance(t["metrics"]["metrics"], dict)


def test_command_line_serves_fleets_and_refuses_the_rest(capsys,
                                                         monkeypatch):
    """``python -m paddle_tpu_torch``: ``serve --autotune`` hands the
    opt-in to the server with the batcher knobs omitted; ``tune`` runs;
    ``stats``, ``trace`` and ``check`` reach their own parsers (the
    command line's, ``cli.py``), which refuse an empty argument list as
    a usage error, exit 2."""
    from paddle_tpu_torch.__main__ import main
    from paddle_tpu_torch.serving import cli

    class Built(Exception):
        pass

    seen = {}

    def server(**kw):
        seen.update(kw)
        raise Built
    monkeypatch.setattr(cli, "Server", server)
    # the process keeps its own identity (serve_main stamps "serve")
    monkeypatch.setattr(cli, "set_process_identity", lambda *a, **k: None)
    with pytest.raises(Built):
        main(["serve", "--model", "m=nowhere", "--autotune"])
    assert seen["autotune"] is True
    assert seen["max_batch"] is None and seen["max_wait_ms"] is None
    with pytest.raises(Built):
        main(["serve", "--model", "m=nowhere", "--max-batch", "8"])
    assert seen["autotune"] is None and seen["max_batch"] == 8
    assert main(["tune", "--list"]) == 0
    assert "serving/batcher" in capsys.readouterr().out
    for sub in ("stats", "trace", "check"):
        with pytest.raises(SystemExit) as e:
            main([sub])
        assert e.value.code == 2
        err = capsys.readouterr().err
        assert f"usage: paddle_tpu_torch {sub}" in err
        assert "item 9e" not in err
