"""The port's fleet observability on the CPU
(paddle_tpu_torch/observability/collector.py and the fleet's trace rims),
the counterparts of ``tests/test_fleet_observability.py``'s fleet half:

* **fleet metrics**: ``merge_snapshots`` semantics (counters sum, gauges
  stay per-source, skewed histograms are skipped-and-named), and the
  merged view, its rendering and its Prometheus text byte-equal to the
  JAX package's for the same sources;
* **malformed context is ignored-and-counted, never fatal**: the W3C
  ``traceparent`` header and the wire ``ctx`` field fuzzed, with the JAX
  package's verdict on every input; an HTTP request's ``traceparent``
  parents its ``http/request`` span;
* **zero overhead when off**: with ``observe`` off the router's stdio
  request lines carry no ``ctx`` field and are otherwise the observing
  router's lines byte for byte;
* **the ``fleet-stats`` command** end to end over JSONL logs, live
  pserver shard endpoints (the port's ``sparse.wire``) and a master's
  heartbeat piggyback (the port's ``MasterClient``), and the collector
  over a live router.
"""
import http.client
import json
import threading

import pytest

from paddle_tpu import flags as jflags
from paddle_tpu import observability as jobs
from paddle_tpu.observability import export as jexport
from paddle_tpu_torch import flags
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.observability import export as obs_export
from paddle_tpu_torch.observability import tracing

HOST = "127.0.0.1"
IO_TO = 10.0


@pytest.fixture(autouse=True)
def clean_observability():
    obs.registry().reset()
    jobs.registry().reset()
    prev = {n: flags.get_flag(n) for n in ("observe", "metrics_log")}
    jprev = {n: jflags.get_flag(n) for n in ("observe", "metrics_log")}
    yield
    for n, v in prev.items():
        flags.set_flag(n, v)
    for n, v in jprev.items():
        jflags.set_flag(n, v)
    obs_export._reset_writer()
    jexport._reset_writer()
    obs_export.set_process_identity(None)
    obs.registry().reset()
    jobs.registry().reset()


@pytest.fixture
def shards2():
    """A 2-shard in-thread pserver fleet of the port."""
    from paddle_tpu_torch.sparse.pserver import PServer
    servers, threads = [], []
    for k in range(2):
        s = PServer(k, 2, host=HOST, io_timeout_s=IO_TO)
        s.start()
        servers.append(s)
    for s in servers:
        t = threading.Thread(target=s.serve_forever, daemon=True,
                             name="pt-pserver-test")
        t.start()
        threads.append(t)
    try:
        yield servers
    finally:
        for s in servers:
            s.stop()
        for t in threads:
            t.join(timeout=5.0)


def _rejected():
    m = obs.registry().snapshot().get("trace/context_rejected") or {}
    return m.get("value", 0.0)


# ---------------------------------------------------------------------------
# fleet metrics: merge semantics, byte-equal to the JAX package's
# ---------------------------------------------------------------------------
def _sources():
    h = {"kind": "histogram", "count": 2, "sum": 3.0, "min": 1.0,
         "max": 2.0, "boundaries": [1.0, 10.0], "counts": [1, 1]}
    h_skew = dict(h, boundaries=[5.0], counts=[2])
    return {
        "a": {"metrics": {"metrics": {
                  "fault/retries": {"kind": "counter", "value": 2.0},
                  "device/bytes_in_use": {"kind": "gauge",
                                          "values": {"cpu:0": 5.0}},
                  "pserver/frame_ms": h},
              "compile": {"compile/traces": 1},
              "device_memory": {"cpu:0": {"bytes_in_use": 5}}},
              "identity": {"role": "trainer", "pid": 1}},
        "b": {"metrics": {"metrics": {
                  "fault/retries": {"kind": "counter", "value": 3.0},
                  "device/bytes_in_use": {"kind": "gauge",
                                          "values": {"cpu:0": 7.0}},
                  "pserver/frame_ms": h_skew},
              "compile": {"compile/traces": 2}},
              "identity": {"role": "pserver", "index": 1, "pid": 2}},
    }


def _fleet_sources():
    """Three serving processes' snapshots as the collector gathers them:
    the http/fleet rows, per-replica gauges, a bare registry snapshot,
    and one source without a snapshot."""
    hist = {"kind": "histogram", "count": 3, "sum": 41.5, "min": 0.5,
            "max": 30.0,
            "boundaries": [0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                           25.0, 50.0, 100.0, 250.0, 500.0, 1000.0,
                           2500.0, 5000.0, 10000.0],
            "counts": [0, 0, 0, 1, 0, 0, 0, 1, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0]}
    return {
        "fleet": {"metrics": {"metrics": {
                      "http/requests": {"kind": "counter", "value": 9.0},
                      "http/rejected": {"kind": "counter", "value": 2.0},
                      "http/request_ms": hist,
                      "fleet/requests": {"kind": "counter", "value": 7.0},
                      "fleet/failovers": {"kind": "counter", "value": 1.0},
                      "fleet/replicas": {"kind": "gauge", "values": {
                          "ready": 2.0, "dead": 0.0}}},
                  "compile": {}},
                  "identity": {"role": "fleet", "pid": 10}},
        "serve:0": {"metrics": {
                        "serving/requests": {"kind": "counter",
                                             "value": 4.0},
                        "serving/request_ms": hist},
                    "identity": {"role": "serve", "index": 0, "pid": 11}},
        "serve:1": {"metrics": {"metrics": {
                        "serving/requests": {"kind": "counter",
                                             "value": 3.0},
                        "serving/request_ms": dict(hist, count=1,
                                                   sum=0.5, max=0.5),
                        "device/peak_bytes_in_use": {
                            "kind": "gauge",
                            "values": {"cuda:0": 1.5e9}}},
                        "device_memory": {"cuda:0": {
                            "bytes_in_use": 12}}},
                    "identity": {"role": "serve", "index": 1, "pid": 12}},
        "ghost": {"metrics": None, "identity": None},
    }


def test_merge_snapshots_semantics():
    from paddle_tpu_torch.observability import collector
    merged = collector.merge_snapshots(_sources())
    m = merged["metrics"]
    assert m["fault/retries"] == {"kind": "counter", "value": 5.0}
    # gauges are per-process levels: one sample per source, never summed
    assert m["device/bytes_in_use"]["values"] == {"a:cpu:0": 5.0,
                                                  "b:cpu:0": 7.0}
    # the bucket-skewed source is skipped AND named, not averaged in
    assert m["pserver/frame_ms"]["count"] == 2
    assert m["pserver/frame_ms"]["counts"] == [1, 1]
    assert merged["skipped"] == ["b:pserver/frame_ms (bucket mismatch)"]
    assert merged["compile"]["compile/traces"] == 3.0
    assert merged["device_memory"] == {"a:cpu:0": {"bytes_in_use": 5}}
    assert set(merged["sources"]) == {"a", "b"}
    text = collector.render_fleet(merged)
    assert "fleet snapshot: 2 source(s)" in text
    assert "fault/retries: 5" in text
    assert "skipped: b:pserver/frame_ms (bucket mismatch)" in text
    snap = obs.registry().snapshot()
    assert snap["collector/merges"]["value"] >= 1.0
    assert snap["collector/sources"]["values"][""] == 2.0


@pytest.mark.parametrize("which", ["semantics", "fleet"])
def test_merge_render_and_prometheus_byte_equal_to_jax(which):
    """The same sources give the same merged view (as JSON), the same
    rendering and the same Prometheus text in both packages."""
    from paddle_tpu.observability import collector as jcollector
    from paddle_tpu_torch.observability import collector
    src = _sources() if which == "semantics" else _fleet_sources()
    merged = collector.merge_snapshots(json.loads(json.dumps(src)))
    jmerged = jcollector.merge_snapshots(json.loads(json.dumps(src)))
    assert json.dumps(merged, sort_keys=True) == \
        json.dumps(jmerged, sort_keys=True)
    assert collector.render_fleet(merged) == \
        jcollector.render_fleet(jmerged)
    prom = {"metrics": merged["metrics"], "compile": merged["compile"]}
    assert obs.to_prometheus(prom) == jobs.to_prometheus(prom)
    if which == "fleet":
        assert merged["skipped"] == ["ghost (no snapshot)"]
        assert merged["metrics"]["serving/requests"]["value"] == 7.0
        assert merged["metrics"]["fleet/replicas"]["values"] == {
            "fleet:ready": 2.0, "fleet:dead": 0.0}
        assert "paddle_tpu_http_requests_total 9" in obs.to_prometheus(
            prom)


def test_collector_rows_are_registered_and_written():
    """The collector's own rows: ``collector/merges`` counts merges,
    ``collector/sources`` the last merge's source count."""
    from paddle_tpu_torch.observability import collector
    collector.merge_snapshots(_fleet_sources())
    collector.merge_snapshots(_sources())
    snap = obs.registry().snapshot()
    assert snap["collector/merges"]["value"] == 2.0
    assert snap["collector/sources"]["values"] == {"": 2.0}


# ---------------------------------------------------------------------------
# malformed context: ignored-and-counted at every rim, never fatal
# ---------------------------------------------------------------------------
TRACEPARENTS = [
    None, "nonsense", "00-abc-def-01",
    "zz-" + "a" * 32 + "-" + "b" * 16 + "-01",   # non-hex version
    "ff-" + "a" * 32 + "-" + "b" * 16 + "-01",   # forbidden version
    "00-" + "0" * 32 + "-" + "b" * 16 + "-01",   # all-zero trace
    "00-" + "a" * 32 + "-" + "0" * 16 + "-01",   # all-zero parent
    "00-" + "a" * 31 + "-" + "b" * 16 + "-01",   # short trace
    "00-" + "A" * 32 + "-" + "b" * 16 + "-01",   # upper-case hex
    123,                                          # not a string
    "00-" + "a" * 32 + "-" + "b" * 16 + "-01",   # valid
    " 01-" + "c" * 32 + "-" + "d" * 16 + "-00-x ",  # valid, padded
]


def test_traceparent_rim_fuzz_rejected_and_counted():
    from paddle_tpu.observability import tracing as jtracing
    base = _rejected()
    jbase = jobs.registry().snapshot()["trace/context_rejected"]["value"]
    rejected = 0
    for tp in TRACEPARENTS:
        got, want = tracing.extract_traceparent(tp), \
            jtracing.extract_traceparent(tp)
        if want is None:
            assert got is None, tp
            rejected += tp is not None
        else:
            assert (got.trace_id, got.span_id) == \
                (want.trace_id, want.span_id), tp
    assert rejected == 9
    assert _rejected() == base + rejected
    assert jobs.registry().snapshot()["trace/context_rejected"][
        "value"] == jbase + rejected
    good = tracing.extract_traceparent(TRACEPARENTS[-2])
    assert good.trace_id == "t" + "a" * 32 and good.span_id == "b" * 16


def test_wire_ctx_rim_fuzz_rejected_and_counted():
    base = _rejected()
    assert tracing.extract(None) is None                # absent: silent
    bad = [123, ["1", "t", "s"], "2:tabc-1:abc-2",      # unknown version
           "1:only-two", "1::abc-2", "1:tabc-1:", "::", ""]
    for ctx in bad:
        assert tracing.extract(ctx) is None
    assert _rejected() == base + len(bad)
    rp = tracing.extract("1:tdead-1:beef-2")
    assert rp.trace_id == "tdead-1" and rp.span_id == "beef-2"


def test_http_traceparent_parents_the_request_span(tmp_path):
    """A valid ``traceparent`` parents the front's ``http/request`` span
    onto the caller's trace; a garbage one is counted and the request
    still serves, in a fresh trace."""
    from paddle_tpu_torch.serving.http import HttpFront
    from torch_serving_fakes import FakeModel, mk_server
    flags.set_flag("observe", True)
    log = tmp_path / "front.jsonl"
    flags.set_flag("metrics_log", str(log))
    srv = mk_server(FakeModel())
    front = HttpFront(srv, port=0).start()
    base = _rejected()
    try:
        host, port = front.address
        for i, tp in enumerate(("00-" + "e" * 32 + "-" + "f" * 16 + "-01",
                                "garbage")):
            conn = http.client.HTTPConnection(host, port, timeout=10)
            conn.request("POST", "/v1/infer", body=json.dumps(
                {"id": i, "feeds": {"x": [1.0, 2.0]}}),
                headers={"traceparent": tp})
            resp = conn.getresponse()
            assert resp.status == 200
            resp.read()
            conn.close()
    finally:
        front.stop()
        srv.shutdown(timeout=10)
    assert _rejected() == base + 1
    obs_export._reset_writer()
    events, _ = obs_export.iter_log_events([str(log)])
    spans = [e for e in events if e.get("kind") == "span"
             and e["name"] == "http/request"]
    assert len(spans) == 2
    assert spans[0]["trace"] == "t" + "e" * 32
    assert spans[0]["parent"] == "f" * 16
    assert spans[0]["labels"]["status"] == 200
    assert spans[1]["trace"] != spans[0]["trace"]
    assert not spans[1].get("parent")
    snap = obs.registry().snapshot()
    assert snap["http/requests"]["value"] == 2.0
    assert snap["http/request_ms"]["count"] == 2


# ---------------------------------------------------------------------------
# zero overhead when off: the router's stdio wire grows no byte
# ---------------------------------------------------------------------------
def _wire_replica_cls():
    from paddle_tpu_torch.serving.fleet import ProcessReplica

    class WireReplica(ProcessReplica):
        """A ProcessReplica whose stdio wire is a list: each request
        line is recorded and answered at once, as a ready replica's
        serve process would."""

        def __init__(self, name):
            super().__init__([], name)
            self.sent = []

        @property
        def alive(self):
            return self.state not in ("dead", "stopped")

        def spawn(self):
            self.state = "ready"
            return self

        def begin_drain(self):
            self.state = "stopped"

        def stop(self, drain=True, timeout_s=60.0):
            self.begin_drain()

        def _send(self, obj):
            line = json.dumps(obj, default=repr)
            self.sent.append(line)
            if obj.get("cmd") == "health":
                self._on_message({"id": None, "health": {
                    "state": "ready", "ready": True,
                    "models": {"m": {"breaker": "closed",
                                     "queue_depth": 0}}}})
            else:
                self._on_message({"id": obj["id"], "model": "m",
                                  "outputs": [[1.0]], "ms": 0.1,
                                  "dispatch_ms": 0.05})
            return True

    return WireReplica


def _wire_lines(observe):
    from paddle_tpu_torch.serving.fleet import FleetRouter
    flags.set_flag("observe", observe)
    reps = []

    def factory(i):
        reps.append(_wire_replica_cls()(f"r{i}"))
        return reps[-1]

    router = FleetRouter(factory, replicas=1,
                         poll_interval_s=30.0).start()
    try:
        with tracing.span("http/request", method="POST"):
            for i in range(3):
                router.submit({"x": [float(i), 1.0]}, model="m",
                              req_id=i).result(timeout=5)
    finally:
        router.shutdown(timeout_s=10)
    return [json.loads(ln) for ln in reps[0].sent
            if "cmd" not in json.loads(ln)]


def test_observe_off_adds_zero_wire_bytes(tmp_path):
    flags.set_flag("metrics_log", str(tmp_path / "wire.jsonl"))
    base = _rejected()
    off = _wire_lines(False)
    on = _wire_lines(True)
    assert len(off) == len(on) == 3
    assert all("ctx" not in ln for ln in off)         # no request grew
    for a, b in zip(on, off):
        assert tracing.extract(a["ctx"]) is not None   # well formed
        assert {k: v for k, v in a.items() if k != "ctx"} == b
    assert _rejected() == base


# ---------------------------------------------------------------------------
# the fleet-stats command and the collector frontends
# ---------------------------------------------------------------------------
def _two_logs(logs):
    obs_export.set_process_identity("trainer")
    flags.set_flag("metrics_log", str(logs / "trainer.jsonl"))
    obs_export.periodic_report(1)
    obs_export._reset_writer()
    obs_export.set_process_identity("serve", 0)
    flags.set_flag("metrics_log", str(logs / "serve.jsonl"))
    obs_export.periodic_report(2)
    obs_export._reset_writer()
    obs_export.set_process_identity(None)
    flags.set_flag("metrics_log", "")


def test_fleet_stats_cli_merges_logs_endpoints_and_master(
        shards2, tmp_path, capsys):
    from paddle_tpu_torch.__main__ import main as cli_main
    from paddle_tpu_torch.distributed.master import Master, MasterServer
    from paddle_tpu_torch.sparse.client import RemoteSparseTable
    logs = tmp_path / "logs"
    logs.mkdir()
    _two_logs(logs)
    # rows on both shards, so each shard's registry has pserver/* work
    with RemoteSparseTable("t", 32, 4, addrs=[(HOST, s.port)
                                              for s in shards2],
                           io_timeout_s=IO_TO) as rt:
        import numpy as np
        rt.pull(np.arange(8, dtype=np.int64))
    msrv = MasterServer(Master()).start()
    try:
        argv = ["fleet-stats", str(logs)] \
            + [f"{HOST}:{s.port}" for s in shards2] \
            + ["--master", f"{msrv.host}:{msrv.port}"]
        assert cli_main(argv + ["--json"]) == 0
        merged = json.loads(
            capsys.readouterr().out.strip().splitlines()[-1])
        assert set(merged["sources"]) == {"trainer", "serve:0",
                                          "pserver:0", "pserver:1",
                                          "master"}
        assert merged["sources"]["pserver:1"]["role"] == "pserver"
        assert merged["sources"]["serve:0"]["index"] == 0
        assert merged["metrics"]["pserver/requests"]["kind"] == "counter"
        assert merged["metrics"]["pserver/requests"]["value"] > 0
        assert cli_main(argv) == 0
        text = capsys.readouterr().out
        assert text.startswith("fleet snapshot: 5 source(s)")
        assert "  source pserver:1 (pid " in text
        # Prometheus exposition of the SAME merge
        assert cli_main(argv + ["--prom"]) == 0
        prom = capsys.readouterr().out
        assert "# TYPE paddle_tpu_pserver_requests_total counter" in prom
    finally:
        msrv.stop()


def test_fleet_stats_stats_op_default_reply_is_byte_stable(shards2):
    """The pserver's ``stats`` op piggybacks metrics only when asked: the
    default reply has neither ``metrics`` nor ``identity``."""
    import socket

    from paddle_tpu_torch.sparse import wire
    replies = []
    for ask in (False, True):
        with socket.create_connection((HOST, shards2[1].port),
                                      timeout=IO_TO) as s:
            s.settimeout(IO_TO)
            wire.write_frame(s, {"op": "hello"})
            wire.read_frame(s)
            wire.write_frame(s, dict({"op": "stats"},
                                     **({"metrics": True} if ask else {})))
            replies.append(wire.read_frame(s)[0])
    plain, asked = replies
    assert "metrics" not in plain and "identity" not in plain
    assert asked["identity"]["role"] == "pserver"
    assert asked["identity"]["index"] == 1
    assert isinstance(asked["metrics"]["metrics"], dict)
    volatile = ("requests", "totals", "_wire_nbytes")
    assert {k: v for k, v in asked.items()
            if k not in ("metrics", "identity") + volatile} == \
        {k: v for k, v in plain.items() if k not in volatile}


def test_fleet_stats_cli_refuses_nonsense_source(tmp_path):
    from paddle_tpu_torch.__main__ import main as cli_main
    with pytest.raises(SystemExit):
        cli_main(["fleet-stats", "definitely/not/a/thing"])
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit):
        cli_main(["fleet-stats", str(empty)])


def test_collect_router_labels_every_replica():
    """``collect_router`` over a live router of in-process replicas: one
    source per member, merged."""
    from paddle_tpu_torch.observability import collector
    from paddle_tpu_torch.serving.fleet import FleetRouter, LocalReplica
    from torch_serving_fakes import FakeModel, mk_server, req
    router = FleetRouter(
        lambda i: LocalReplica(mk_server(FakeModel()), name=f"rep{i}"),
        replicas=2, poll_interval_s=0.05).start()
    try:
        router.submit(req(1)).result(timeout=10)
        sources = collector.collect_router(router, timeout_s=5.0)
    finally:
        router.shutdown(timeout_s=20)
    assert sorted(sources) == ["local", "local#2"]
    assert all(e["identity"]["role"] == "local" for e in sources.values())
    merged = collector.merge_snapshots(sources)
    assert merged["metrics"]["fleet/requests"]["value"] >= 2.0
