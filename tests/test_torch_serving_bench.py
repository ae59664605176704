"""The server's retry rim and fault-injection sites, and the load
benchmark (``paddle_tpu_torch/serving/server.py``,
``paddle_tpu_torch/benchmark/serving.py``):

* ``serving.dispatch``: a transient retries inside the rim (the request
  is served, once), a fatal fails the batch with ``ModelError`` and
  counts toward the breaker, an exhausted retry fails the batch;
* ``serving.request``: ``drop`` refuses the admission with a
  ``ConnectionError``, ``delay:ms`` sleeps before it;
* ``PendingResponse.add_done_callback`` fires once, on completion or at
  once when already done;
* the benchmark's SMOKE rows on the CPU are complete: capacity, the
  shedding arms at 1x and 2x, the control with its queue samples, the
  acceptance row, the doctor's refusal naming ROADMAP item 9.  Gates and
  timing are not asserted here.
"""
import threading
import time

import numpy as np
import pytest

from paddle_tpu_torch.faults import RetryPolicy
from paddle_tpu_torch.serving import Model, Server
from paddle_tpu_torch.serving.server import ModelError
from paddle_tpu_torch.testing import faultinject as fi

EXAMPLE = {"x": np.arange(4, dtype=np.float32)}


def _model(calls):
    def fn(feeds):
        calls.append(feeds["x"].shape[0])
        return [feeds["x"] * 2.0]
    return Model("m", fn, example=EXAMPLE)


def _server(calls, **kw):
    srv = Server(max_batch=4, max_wait_ms=1.0, deadline_ms=None, **kw)
    srv.add_model(_model(calls))
    return srv.start()


@pytest.fixture(autouse=True)
def _clear_faults():
    yield
    fi.clear()


def test_dispatch_transient_retries_inside_the_rim():
    calls = []
    srv = _server(calls)
    try:
        calls.clear()
        fi.configure("serving.dispatch@1=transient")
        out = srv.infer(EXAMPLE, timeout=30.0)
        np.testing.assert_array_equal(out[0], EXAMPLE["x"] * 2.0)
        assert fi.fired("serving.dispatch") == 1
        assert len(calls) == 1          # the failed attempt never ran
        assert srv.health()["models"]["m"]["breaker"] == "closed"
    finally:
        srv.shutdown()


def test_dispatch_fatal_fails_the_batch_and_feeds_the_breaker():
    calls = []
    srv = _server(calls, breaker_threshold=1, breaker_cooldown_s=30.0)
    try:
        fi.configure("serving.dispatch@1=fatal")
        with pytest.raises(ModelError, match="InjectedFault"):
            srv.infer(EXAMPLE, timeout=30.0)
        assert srv.health()["models"]["m"]["breaker"] == "open"
    finally:
        srv.shutdown()


def test_dispatch_retries_exhausted_fail_the_batch():
    calls = []
    srv = _server(calls, retry_policy=RetryPolicy(
        max_attempts=2, backoff_base_s=0.0, jitter=0.0))
    try:
        calls.clear()
        fi.configure("serving.dispatch@*=transient")
        with pytest.raises(ModelError, match="RetriesExhausted"):
            srv.infer(EXAMPLE, timeout=30.0)
        assert fi.fired("serving.dispatch") == 2 and not calls
    finally:
        srv.shutdown()


def test_request_site_drop_and_delay():
    calls = []
    srv = _server(calls)
    try:
        fi.configure("serving.request@1=drop;serving.request@2=delay:30")
        with pytest.raises(ConnectionError):
            srv.submit(EXAMPLE)
        t0 = time.monotonic()
        out = srv.infer(EXAMPLE, timeout=30.0)
        assert time.monotonic() - t0 >= 0.03
        np.testing.assert_array_equal(out[0], EXAMPLE["x"] * 2.0)
        assert fi.fired("serving.request") == 2
    finally:
        srv.shutdown()


def test_done_callbacks():
    calls = []
    srv = _server(calls)
    seen = []
    done = threading.Event()
    try:
        r = srv.submit(EXAMPLE)
        r.add_done_callback(lambda p: (seen.append(p), done.set()))
        assert done.wait(30.0)
        r.add_done_callback(seen.append)         # already done: at once
        assert seen == [r, r]
        assert r.t_admit <= time.monotonic()
    finally:
        srv.shutdown()


def test_serving_bench_smoke_rows_complete(tmp_path):
    from paddle_tpu_torch.benchmark import serving

    row = serving.run_all(smoke=True, device="cpu",
                          model_dir=str(tmp_path / "mlp"), quiet=True)
    assert row["smoke"] is True and row["device"] == "cpu"
    cap = row["closed_loop"]
    assert cap["served"] > 0 and cap["req_per_s"] > 0
    assert row["capacity_req_per_s"] >= cap["req_per_s"]
    factors = [a["load_factor"] for a in row["open_loop"]]
    assert factors == list(serving.SMOKE["factors"])
    for a in row["open_loop"]:
        assert a["config"]["shed"] is True
        assert a["offered"] >= a["served"] > 0
        assert a["latency_ms_p99"] >= a["latency_ms_p50"]
    ctl = row["control"]
    assert ctl["config"]["shed"] is False and ctl["config"]["queue"] is None
    assert ctl["queue_depth_samples"] and "pending_at_stop" in ctl
    acc = row["acceptance"]
    assert acc["p99_1x_ms"] is not None
    assert acc["bounded_under_overload"] in (True, False)
    assert "item 9" in row["doctor"]["not_ported"]
