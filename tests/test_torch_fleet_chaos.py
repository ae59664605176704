"""The port's serving fleet with REAL replica processes (the counterparts
of ``tests/test_fleet_chaos.py``), on the CPU (``--device cpu``):

* a fleet of 2 ``python -m paddle_tpu_torch serve`` subprocesses behind
  the router, 200 admitted requests in flight, one replica SIGKILLed:
  ZERO admitted requests dropped fleet-wide, and the dead replica
  relaunches through the supervisor's bounded-restart gate, returns to
  ready and serves again;
* the ``fleet`` command: replicas come up behind the HTTP front,
  requests round-trip over the wire, SIGTERM drains the whole fleet and
  exits 0; the ``serve`` command's stdio protocol drains on SIGTERM the
  same way;
* a fresh interpreter importing ``paddle_tpu_torch.serving`` loads
  neither ``serving.http`` nor ``serving.fleet``;
* ``benchmark.fleet`` at SMOKE with CPU replicas: every row.

Every test starts processes and is ``@slow``.  One more, marked
``cuda``, runs two replicas on the card through ``chip_smoke.py
--fleet-child`` and holds K1's launches in each against the gate; it
skips without a card.  No JAX import here: the card's machine has none.
"""
import http.client
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env.pop("PADDLE_TPU_TORCH_METRICS_LOG", None)
    env.pop("PADDLE_TPU_FAULT_SPEC", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _export(build, spec, dirname, device):
    import paddle_tpu_torch as ptt
    ptt.core.reset_default_programs()
    ptt.core.reset_global_scope()
    ptt.unique_name.reset()
    out = build(ptt)
    ptt.default_startup_program().random_seed = 5
    ptt.Executor(ptt.CPUPlace() if device == "cpu" else ptt.CUDAPlace(0)) \
        .run(ptt.default_startup_program())
    ptt.export_compiled_model(dirname, spec, [out], device=device)
    ptt.core.reset_default_programs()
    ptt.core.reset_global_scope()
    return dirname


def _mlp(pkg):
    x = pkg.layers.data("x", shape=[8], dtype="float32")
    h = pkg.layers.fc(x, size=32, act="relu")
    return pkg.layers.fc(h, size=4, act="softmax")


@pytest.fixture(scope="module")
def artifact_dir(tmp_path_factory):
    """One tiny exported MLP artifact (CPU) shared by every round."""
    d = str(tmp_path_factory.mktemp("fleet_artifact") / "mlp")
    return _export(_mlp, {"x": ((-1, 8), "float32")}, d, "cpu")


@pytest.mark.timeout(600)
def test_replica_sigkill_under_load_zero_drops_and_relaunch(artifact_dir):
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.serving.fleet import (FleetRouter, ProcessReplica,
                                                serve_argv)

    argv = serve_argv([f"m={artifact_dir}"], max_batch=16,
                      max_wait_ms=20.0, deadline_ms=0, queue=4096,
                      device="cpu")

    def factory(i):
        # the victim admits each request 5 ms late, so the flood is still
        # in flight there when the SIGKILL lands (else a fast host could
        # answer it all first and the round would prove nothing)
        env = _env()
        if i == 0:
            env["PADDLE_TPU_FAULT_SPEC"] = "serving.request@*=delay:5"
        return ProcessReplica(argv, name=f"replica{i}", env=env)

    router = FleetRouter(factory, replicas=2, poll_interval_s=0.1,
                         max_restarts=3, restart_backoff_base_s=0.1)
    try:
        router.start(ready_timeout_s=300)
        # start() returns once ONE replica is routable: wait for both,
        # or the flood could all go to the survivor
        deadline = time.monotonic() + 300
        while len(router._routable()) < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert len(router._routable()) == 2
        feeds = {"x": np.full(8, 0.5, "float32")}
        assert router.infer(feeds, deadline_ms=None,
                            timeout=120) is not None
        victim = router.replicas[0]
        failovers0 = obs.registry().snapshot()["fleet/failovers"]["value"]
        # flood, then kill while batches are forming (20 ms windows)
        fps = [router.submit(feeds, deadline_ms=None) for _ in range(200)]
        victim.kill()                       # SIGKILL: no handler runs
        dropped = []
        for fp in fps:
            try:
                out = fp.result(timeout=180)
                if out is None:
                    dropped.append((fp.id, "none"))
            except BaseException as e:      # noqa: BLE001 — the claim
                dropped.append((fp.id, f"{type(e).__name__}: {e}"))
        assert not dropped, (
            f"{len(dropped)}/200 admitted requests dropped fleet-wide: "
            f"{dropped[:5]}")
        failovers = obs.registry().snapshot()["fleet/failovers"][
            "value"] - failovers0
        assert failovers >= 1, "SIGKILL landed outside the load window"
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline and victim.state != "ready":
            time.sleep(0.2)
        assert victim.state == "ready", (
            f"killed replica never relaunched (state {victim.state})")
        assert victim.restarts >= 1
        # the relaunched replica serves: the survivor cordoned
        router.cordon("replica1")
        router._poll_all()
        out = router.infer(feeds, deadline_ms=None, timeout=120)
        assert len(out[0]) == 4
        router.cordon("replica1", cordoned=False)
    finally:
        router.shutdown(timeout_s=120)


@pytest.mark.timeout(600)
def test_fleet_cli_http_round_sigterm_drains_exit_0(artifact_dir):
    cmd = [sys.executable, "-m", "paddle_tpu_torch", "fleet",
           "--model", f"m={artifact_dir}", "--device", "cpu",
           "--replicas", "2", "--http", "0", "--max-batch", "8",
           "--max-wait-ms", "5", "--deadline-ms", "0", "--queue", "1024",
           "--poll-interval-s", "0.1"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                            env=_env(), cwd=REPO)
    try:
        port = None
        deadline = time.monotonic() + 500
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            assert line, f"fleet CLI exited early (rc={proc.poll()})"
            ev = json.loads(line)
            if ev.get("event") == "state" and ev.get("state") == "ready":
                port = ev["port"]
                break
        assert port is not None, "fleet never became ready"
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        health = json.loads(resp.read())
        assert resp.status == 200 and health["ready"] is True
        assert len(health["replicas"]) == 2
        body = json.dumps({"id": 1, "feeds": {"x": [0.5] * 8}})
        conn.request("POST", "/v1/infer", body=body)
        resp = conn.getresponse()
        out = json.loads(resp.read())
        assert resp.status == 200 and len(out["outputs"][0]) == 4
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        assert resp.status == 200
        assert "paddle_tpu_http_requests_total 1" in resp.read().decode()
        conn.close()
        proc.send_signal(signal.SIGTERM)
        states = []
        while True:
            line = proc.stdout.readline()
            if not line:
                break
            ev = json.loads(line)
            if ev.get("event") == "state":
                states.append(ev["state"])
        assert proc.wait(timeout=120) == 0
        assert states[-2:] == ["draining", "stopped"]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


@pytest.mark.timeout(600)
def test_serve_cli_stdio_round_sigterm_drains_exit_0(artifact_dir):
    """``serve``'s stdio protocol: ready, a request and a health poll
    answered, SIGTERM drains and exits 0 with the stopped event."""
    cmd = [sys.executable, "-m", "paddle_tpu_torch", "serve",
           "--model", f"m={artifact_dir}", "--device", "cpu",
           "--max-batch", "4", "--replica-index", "3"]
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, text=True, env=_env(),
                            cwd=REPO)
    try:
        events = []
        while True:
            ev = json.loads(proc.stdout.readline())
            events.append(ev)
            if ev.get("state") == "ready":
                break
        assert [e.get("state") for e in events
                if e.get("event") == "state"] == ["warming", "ready"]
        assert events[-1]["models"] == ["m"]
        proc.stdin.write(json.dumps({"id": "a", "feeds": {
            "x": [0.5] * 8}}) + "\n")
        proc.stdin.write(json.dumps({"cmd": "health", "id": "h",
                                     "metrics": True}) + "\n")
        proc.stdin.flush()
        got = {}
        while len(got) < 2:
            ev = json.loads(proc.stdout.readline())
            got[ev.get("id")] = ev
        assert len(got["a"]["outputs"][0]) == 4
        assert got["h"]["health"]["state"] == "ready"
        assert got["h"]["identity"]["role"] == "serve"
        assert got["h"]["identity"]["index"] == 3
        proc.send_signal(signal.SIGTERM)
        rest = [json.loads(ln) for ln in proc.stdout]
        assert proc.wait(timeout=60) == 0
        assert [e.get("state") for e in rest
                if e.get("event") == "state"] == ["draining", "stopped"]
        assert rest[-1]["event"] == "stopped" and rest[-1]["admitted"] == 1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


@pytest.mark.timeout(300)
def test_import_serving_does_not_import_http_or_fleet():
    code = ("import sys; import paddle_tpu_torch.serving; "
            "bad = [m for m in ('paddle_tpu_torch.serving.http', "
            "'paddle_tpu_torch.serving.fleet', "
            "'paddle_tpu_torch.serving.cli', "
            "'paddle_tpu_torch.observability.collector') "
            "if m in sys.modules]; assert not bad, bad; print('CLEAN')")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=_env(), cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert "CLEAN" in r.stdout


@pytest.mark.timeout(600)
def test_benchmark_fleet_smoke_rows_complete():
    """``benchmark.fleet`` at SMOKE with CPU replicas: every arm's row,
    the JAX runner's acceptance keys, and the chaos arm's zero drops and
    relaunch (its numbers are meaningless at these durations)."""
    from paddle_tpu_torch.benchmark import fleet as bfleet
    row = bfleet.run(smoke=True, device="cpu", quiet=True)
    assert row["device"] == "cpu" and row["replica_device"] == "cpu"
    assert row["saturation"]["served_per_s"] > 0
    assert len(row["capacity_pairs"]["pairs"]) == bfleet.SMOKE["pairs"]
    assert set(row["overload"]) == {"1.0x", "2.0x"}
    assert set(row["acceptance"]) == {
        "host_parallel_ceiling_2proc", "fleet_speedup",
        "fleet_over_ceiling", "capacity_scales_with_replicas",
        "p99_1x_ms", "p99_2x_ms", "p99_ratio_2x_over_1x",
        "bounded_under_overload"}
    chaos = row["chaos_sigkill"]
    assert chaos["zero_admitted_drops"] and chaos["dropped"] == 0
    assert chaos["victim_relaunched_ready"] and chaos["victim_restarts"] >= 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the replicas serve on it and "
                    "launch the 1x1-convolution kernel")


def _conv_net(pkg):
    """A 1x1 conv 128 -> 128 at 8 x 8 (the kernel's gate passes at even
    batches: P = 64 x batch), global pooling and a 10-way head."""
    img = pkg.layers.data("img", [128, 8, 8])
    h = pkg.layers.conv2d(img, num_filters=128, filter_size=1, act="relu")
    h = pkg.layers.pool2d(h, pool_type="avg", global_pooling=True)
    return pkg.layers.fc(h, size=10, act="softmax")


@pytest.mark.cuda
@pytest.mark.timeout(900)
def test_two_replicas_on_the_card_serve_a_conv_artifact_with_k1(
        card, tmp_path):
    """Two ``serve`` replicas on the card (``chip_smoke.py
    --fleet-child``) behind the router and the HTTP front serve a small
    conv artifact: every response within 1e-3 (relative) of the
    parent's direct call of the artifact at batch 1, and in each replica
    process K1's fp32 forward launched once per eligible conv for each
    artifact call."""
    import importlib.util

    import torch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from paddle_tpu_torch import export_model
    from paddle_tpu_torch.serving.fleet import (FleetRouter, ProcessReplica,
                                                serve_argv)
    from paddle_tpu_torch.serving.http import HttpFront
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    model_dir = _export(_conv_net, {"img": ((-1, 128, 8, 8), "float32")},
                        str(tmp_path / "conv"), "cuda")
    run, _ = export_model.load_compiled_model(model_dir)
    rng = np.random.RandomState(9)
    imgs = rng.rand(4, 128, 8, 8).astype(np.float32)
    want = [run({"img": imgs[i:i + 1]})[0][0].cpu().numpy()
            for i in range(4)]
    stats = tmp_path / "stats"
    stats.mkdir()
    argv = serve_argv([f"m={model_dir}"], max_batch=8, max_wait_ms=5.0,
                      deadline_ms=0, warmup_all=True, device="cuda")
    head = [sys.executable, os.path.join(REPO, "chip_smoke.py"),
            "--fleet-child", str(stats), "--", "serve"]

    def factory(i):
        return ProcessReplica(head + argv[4:] + ["--replica-index", str(i)],
                              name=f"replica{i}", env=_env())

    router = FleetRouter(factory, replicas=2, poll_interval_s=0.1)
    front = None
    try:
        router.start(ready_timeout_s=300)
        front = HttpFront(router, port=0).start()
        host, port = front.address
        conn = http.client.HTTPConnection(host, port, timeout=120)
        for k in range(16):
            i = k % 4
            conn.request("POST", "/v1/infer", body=json.dumps(
                {"id": k, "feeds": {"img": imgs[i].tolist()}}))
            resp = conn.getresponse()
            obj = json.loads(resp.read())
            assert resp.status == 200, obj
            np.testing.assert_allclose(np.asarray(obj["outputs"][0],
                                                  np.float32), want[i],
                                       rtol=1e-3, atol=1e-6)
        conn.close()
    finally:
        if front is not None:
            front.stop()
        router.shutdown(timeout_s=120)
    import paddle_tpu_torch as ptt
    ptt.unique_name.reset()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        _conv_net(ptt)
    files = sorted(os.listdir(stats))
    assert len(files) == 2
    for f in files:
        with open(stats / f) as fh:
            s = json.load(fh)
        expect = sum(len(cs.eligible_1x1_shapes(main, int(b))) * n
                     for b, n in s["calls"].items())
        assert s["rc"] == 0
        assert expect > 0 and {k: v for k, v in s["forms"].items() if v} \
            == {"forward": expect}, s
