"""The port's HTTP serving front on the CPU
(paddle_tpu_torch/serving/http.py): the counterparts of
``tests/test_http_front.py``'s 12 tests, hermetic round-trips over an
in-process port server on an ephemeral port.

A client timeout header becomes the per-request deadline and expires at
the server's two rims — batch formation and dispatch — mapping to 504;
the typed-rejection -> status-code matrix covers the rest (Overloaded
429, ModelUnavailable 503, ServerClosed 503 + Connection: close,
BadRequest 400, auth 401/403).  ``status_for`` gives the JAX package's
code for every typed error.

A gated fake model makes "the dispatcher is busy" a fact, not a race.
Subprocess/CLI rounds are in tests/test_torch_fleet_chaos.py (``@slow``).
"""
import http.client
import json
import threading
import time

import numpy as np
import pytest

from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.serving.http import (DEADLINE_HEADER, TOKEN_HEADER,
                                           HttpFront, status_for)
from torch_serving_fakes import FakeModel, mk_server as _mk_server
from torch_serving_fakes import req as _req
from torch_serving_fakes import soak_pipeline as _soak_pipeline


@pytest.fixture
def front_of():
    """Factory fixture: front_of(server, **kw) -> (host, port); every
    front and backend is stopped at teardown."""
    cleanup = []

    def make(srv, **kw):
        front = HttpFront(srv, port=0, **kw).start()
        cleanup.append((front, srv))
        return front.address

    yield make
    for front, srv in cleanup:
        front.stop()
        try:
            srv.shutdown(timeout=10)
        except TypeError:
            srv.shutdown()


@pytest.fixture
def observing():
    """The port's server writes its serving events only when built with
    the ``observe`` flag on (the JAX server writes them unconditionally):
    the deadline tests read the rim from the ``deadline_expired`` event."""
    from paddle_tpu_torch import flags
    prev = flags.get_flag("observe")
    flags.set_flag("observe", True)
    yield
    flags.set_flag("observe", prev)


def _http(host, port, method, path, body=None, headers=None, timeout=30):
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        data = resp.read().decode("utf-8")
        return resp.status, dict(resp.getheaders()), data
    finally:
        conn.close()


def _lines(data):
    return [json.loads(ln) for ln in data.splitlines() if ln.strip()]


def _post_line(host, port, obj, headers=None, timeout=30):
    status, hdrs, data = _http(host, port, "POST", "/v1/infer",
                               body=json.dumps(obj), headers=headers,
                               timeout=timeout)
    return status, hdrs, (_lines(data)[0] if data.strip() else None)


# ---------------------------------------------------------------------------
# basic round trips
# ---------------------------------------------------------------------------
def test_healthz_infer_metrics_and_404(front_of):
    fake = FakeModel()
    srv = _mk_server(fake)
    host, port = front_of(srv)

    status, _, data = _http(host, port, "GET", "/healthz")
    assert status == 200 and json.loads(data)["ready"] is True

    status, _, obj = _post_line(
        host, port, {"id": 7, "feeds": {"x": [1.0, 2.0]}})
    assert status == 200
    assert obj["id"] == 7 and obj["outputs"] == [[2.0, 4.0]]
    assert obj["ms"] >= 0 and obj["dispatch_ms"] is not None

    status, _, data = _http(host, port, "GET", "/metrics")
    assert status == 200 and "http_requests_total" in data

    status, _, _ = _http(host, port, "GET", "/nope")
    assert status == 404
    status, _, _ = _http(host, port, "POST", "/nope", body="{}")
    assert status == 404


def test_multi_line_body_streams_per_request_lines(front_of):
    fake = FakeModel()
    srv = _mk_server(fake)
    host, port = front_of(srv)
    body = "\n".join(
        [json.dumps({"id": i, "feeds": {"x": [float(i), 0.0]}})
         for i in range(4)] + ["not json at all"])
    status, hdrs, data = _http(host, port, "POST", "/v1/infer", body=body)
    assert status == 200
    assert hdrs.get("Content-Type") == "application/x-ndjson"
    lines = _lines(data)
    assert len(lines) == 5                      # 4 results + 1 error line
    by_id = {ln.get("id"): ln for ln in lines if "outputs" in ln}
    assert sorted(by_id) == [0, 1, 2, 3]
    for i in range(4):
        assert by_id[i]["outputs"] == [[2.0 * i, 0.0]]
    errs = [ln for ln in lines if "error" in ln]
    assert len(errs) == 1 and errs[0]["error"] in ("ValueError",
                                                   "BadRequest")


# ---------------------------------------------------------------------------
# deadline propagation (satellite acceptance)
# ---------------------------------------------------------------------------
def test_deadline_header_expires_at_batch_formation_504(front_of,
                                                        monkeypatch,
                                                        observing):
    """The client timeout header becomes the request deadline; a request
    that expires while QUEUED (the batch-formation rim) maps to 504 and
    is never computed."""
    expiries = []
    real_emit = obs.emit_event

    def spy(kind, **fields):
        if kind == "serving" and fields.get("event") == "deadline_expired":
            expiries.append(fields.get("where"))
        return real_emit(kind, **fields)

    monkeypatch.setattr(obs, "emit_event", spy)
    fake = FakeModel(gate=True)
    srv = _mk_server(fake, max_batch=1, deadline_ms=None,
                     staging_depth=1)
    host, port = front_of(srv)
    # dispatcher gated, staging full, batcher blocked on staging.put:
    # the next request stays in the ADMISSION QUEUE until released
    held = _soak_pipeline(srv)
    t2_result = {}

    def queued():
        t2_result["r2"] = _post_line(
            host, port, {"id": 2, "feeds": {"x": [2.0, 2.0]}},
            headers={DEADLINE_HEADER: "40"})

    t2 = threading.Thread(target=queued, daemon=True)
    t2.start()
    time.sleep(0.3)                      # r2's 40 ms deadline lapses
    fake.open_gate_forever()
    t2.join(timeout=15)
    for r in held:
        assert r.result(timeout=10) is not None
    status, _, obj = t2_result["r2"]
    assert status == 504
    assert obj["error"] == "DeadlineExceeded" and obj["id"] == 2
    assert 2.0 not in fake.rows          # expired = never computed
    assert "batching" in expiries


def test_deadline_header_expires_at_dispatch_rim_504(front_of,
                                                     monkeypatch,
                                                     observing):
    """A request that forms a batch in time but expires while STAGED
    (the dispatch rim) also maps to 504 — the server's second rim."""
    expiries = []
    real_emit = obs.emit_event

    def spy(kind, **fields):
        if kind == "serving" and fields.get("event") == "deadline_expired":
            expiries.append(fields.get("where"))
        return real_emit(kind, **fields)

    monkeypatch.setattr(obs, "emit_event", spy)
    fake = FakeModel(gate=True)
    srv = _mk_server(fake, max_batch=1, max_wait_ms=1.0,
                     deadline_ms=None, staging_depth=1)
    host, port = front_of(srv)

    res = {}

    def post(key, obj, headers=None):
        res[key] = _post_line(host, port, obj, headers=headers)

    t1 = threading.Thread(
        target=post, args=("r1", {"id": 1, "feeds": {"x": [1.0, 1.0]}}),
        daemon=True)
    t1.start()
    time.sleep(0.15)                     # r1 dispatching (gated)
    # r2: batches immediately (max_wait 1 ms), then sits in staging
    # behind the gated r1 until its 120 ms deadline lapses
    t2 = threading.Thread(
        target=post, args=("r2", {"id": 2, "feeds": {"x": [2.0, 2.0]}}),
        kwargs={"headers": {DEADLINE_HEADER: "120"}}, daemon=True)
    t2.start()
    time.sleep(0.4)                      # past r2's deadline
    fake.open_gate_forever()
    t1.join(timeout=15)
    t2.join(timeout=15)
    assert res["r1"][0] == 200
    status, _, obj = res["r2"]
    assert status == 504 and obj["error"] == "DeadlineExceeded"
    assert 2.0 not in fake.rows
    assert "dispatch" in expiries


def test_body_deadline_field_overrides_header(front_of):
    """A per-line deadline_ms beats the header default — the header is
    the default for lines that don't choose their own."""
    fake = FakeModel()
    srv = _mk_server(fake)
    host, port = front_of(srv)
    # header would expire instantly; the body opts out of deadlines
    status, _, obj = _post_line(
        host, port,
        {"id": 1, "feeds": {"x": [1.0, 2.0]}, "deadline_ms": None},
        headers={DEADLINE_HEADER: "0.001"})
    assert status == 200 and obj["outputs"] == [[2.0, 4.0]]


# ---------------------------------------------------------------------------
# typed-rejection -> status-code matrix
# ---------------------------------------------------------------------------
def test_overloaded_maps_to_429_with_retry_after(front_of):
    fake = FakeModel(gate=True)
    srv = _mk_server(fake, max_batch=1, queue_capacity=1,
                     deadline_ms=None, staging_depth=1)
    host, port = front_of(srv)
    held = _soak_pipeline(srv)
    rq = srv.submit(_req(2), deadline_ms=9000.0)   # fills the queue
    # incoming via HTTP with the soonest deadline -> shed -> 429
    status, hdrs, obj = _post_line(
        host, port, {"id": 3, "feeds": {"x": [3.0, 3.0]}},
        headers={DEADLINE_HEADER: "10"})
    assert status == 429
    assert obj["error"] == "Overloaded"
    assert hdrs.get("Retry-After") == "1"
    fake.open_gate_forever()
    for r in held + [rq]:
        assert r.result(timeout=10) is not None


def test_model_unavailable_maps_to_503(front_of):
    fake = FakeModel(fail=[RuntimeError("poison")])
    srv = _mk_server(fake, max_batch=1, breaker_threshold=1,
                     retry_policy=None)
    host, port = front_of(srv)
    with pytest.raises(Exception):
        srv.infer(_req(1), timeout=10)             # opens the breaker
    assert srv.health()["models"]["fake"]["breaker"] == "open"
    status, hdrs, obj = _post_line(
        host, port, {"id": 2, "feeds": {"x": [2.0, 2.0]}})
    assert status == 503
    assert obj["error"] == "ModelUnavailable"
    assert hdrs.get("Retry-After") is not None


def test_server_closed_maps_to_503_connection_close(front_of):
    fake = FakeModel()
    srv = _mk_server(fake)
    host, port = front_of(srv)
    srv.begin_drain()
    status, hdrs, obj = _post_line(
        host, port, {"id": 1, "feeds": {"x": [1.0, 1.0]}})
    assert status == 503
    assert obj["error"] == "ServerClosed"
    assert hdrs.get("Connection", "").lower() == "close"
    # the readiness surface flips with it
    status, _, data = _http(host, port, "GET", "/healthz")
    assert status == 503 and json.loads(data)["ready"] is False


def test_bad_requests_map_to_400(front_of):
    fake = FakeModel()
    srv = _mk_server(fake)
    host, port = front_of(srv)
    status, _, obj = _post_line(host, port, {"nope": 1})
    assert status == 400
    status, _, _ = _http(host, port, "POST", "/v1/infer",
                         body="not json")
    assert status == 400
    # unknown model name is a 400-class admission error too
    status, _, obj = _post_line(
        host, port, {"id": 1, "model": "ghost",
                     "feeds": {"x": [1.0, 1.0]}})
    assert status == 400


def test_status_for_covers_the_frozen_matrix():
    from paddle_tpu_torch import faults
    from paddle_tpu_torch.serving.server import ModelError
    assert status_for(faults.Overloaded("x")) == 429
    assert status_for(faults.DeadlineExceeded("x")) == 504
    assert status_for(faults.ModelUnavailable("x")) == 503
    assert status_for(faults.ServerClosed("x")) == 503
    assert status_for(ValueError("x")) == 400
    assert status_for(ModelError("x")) == 500


def test_status_for_matches_jax_for_every_typed_error():
    """Every typed error of the port (its faults module's classes, the
    server's ModelError, the fleet's internal ReplicaGone and the
    protocol errors) gets the JAX package's status for its counterpart."""
    import inspect

    from paddle_tpu import faults as jfaults
    from paddle_tpu.serving.fleet import ReplicaGone as JGone
    from paddle_tpu.serving.http import status_for as jstatus_for
    from paddle_tpu.serving.server import ModelError as JModelError
    from paddle_tpu_torch import faults
    from paddle_tpu_torch.serving.fleet import ReplicaGone
    from paddle_tpu_torch.serving.server import ModelError
    pairs = [(ModelError, JModelError), (ReplicaGone, JGone)]
    for name, cls in inspect.getmembers(faults, inspect.isclass):
        if issubclass(cls, BaseException) and cls.__module__ == \
                faults.__name__ and hasattr(jfaults, name):
            pairs.append((cls, getattr(jfaults, name)))
    assert {"Overloaded", "DeadlineExceeded", "ModelUnavailable",
            "ServerClosed", "TransientError"} <= {
                c.__name__ for c, _ in pairs}
    pairs += [(c, c) for c in (ValueError, TypeError, KeyError,
                               PermissionError, RuntimeError,
                               ConnectionError, TimeoutError)]
    for cls, jcls in pairs:
        try:
            exc, jexc = cls("x"), jcls("x")
        except TypeError:               # a constructor with its own args
            continue
        assert status_for(exc) == jstatus_for(jexc), cls


# ---------------------------------------------------------------------------
# auth-token -> model routing
# ---------------------------------------------------------------------------
def test_token_auth_and_model_routing(front_of):
    a, b = FakeModel("a"), FakeModel("b")
    srv = _mk_server([a, b])
    host, port = front_of(srv, tokens={"tok-a": "a", "open": None})

    # no token -> 401 (and counted as an auth failure)
    status, hdrs, _ = _post_line(
        host, port, {"id": 1, "model": "a", "feeds": {"x": [1.0, 1.0]}})
    assert status == 401 and "WWW-Authenticate" in hdrs
    # unknown token -> 401
    status, _, _ = _post_line(
        host, port, {"id": 2, "model": "a", "feeds": {"x": [1.0, 1.0]}},
        headers={TOKEN_HEADER: "wrong"})
    assert status == 401
    # bound token routes WITHOUT a model field (tenant inferred)
    status, _, obj = _post_line(
        host, port, {"id": 3, "feeds": {"x": [3.0, 3.0]}},
        headers={TOKEN_HEADER: "tok-a"})
    assert status == 200 and obj["model"] == "a"
    assert 3.0 in a.rows and 3.0 not in b.rows
    # bound token + mismatched explicit model -> 403
    status, _, obj = _post_line(
        host, port, {"id": 4, "model": "b", "feeds": {"x": [4.0, 4.0]}},
        headers={TOKEN_HEADER: "tok-a"})
    assert status == 403 and 4.0 not in b.rows
    # unbound token may pick any tenant; Bearer form accepted
    status, _, obj = _post_line(
        host, port, {"id": 5, "model": "b", "feeds": {"x": [5.0, 5.0]}},
        headers={"Authorization": "Bearer open"})
    assert status == 200 and obj["model"] == "b" and 5.0 in b.rows


def test_open_front_needs_no_token(front_of):
    fake = FakeModel()
    srv = _mk_server(fake)
    host, port = front_of(srv)                    # tokens=None
    status, _, obj = _post_line(
        host, port, {"id": 1, "feeds": {"x": [1.0, 1.0]}})
    assert status == 200
