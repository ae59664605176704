"""distributed/launch.py of the port (mirrors tests/test_launch.py):
the single-process no-op, the env-var coordinator, retry with backoff
around the join, the typed coordinator-timeout error, and the backend
chosen by the device asked for.  ``torch.distributed``'s
``init_process_group`` and ``TCPStore`` are replaced by fakes here; the
``slow`` round joins two real processes over a coordinator's TCPStore
on localhost."""
import os
import subprocess
import sys

import pytest
import torch

from paddle_tpu_torch.distributed import launch
from paddle_tpu_torch.faults import RetryPolicy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    launch.reset_distributed_state()
    monkeypatch.delenv("PADDLE_TPU_COORDINATOR", raising=False)
    monkeypatch.delenv("PADDLE_TPU_COORDINATOR_TIMEOUT_S", raising=False)
    yield
    launch.reset_distributed_state()


class _Store:
    made = []

    def __init__(self, host, port, world, is_master=False, **kw):
        _Store.made.append((host, port, world, is_master))


@pytest.fixture
def fake_store(monkeypatch):
    _Store.made = []
    monkeypatch.setattr(torch.distributed, "TCPStore", _Store)
    return _Store


def test_single_process_noop(monkeypatch):
    """No coordinator anywhere: init is a no-op that still marks the
    process initialized (idempotent), and never touches the world."""
    def boom(**kw):
        raise AssertionError("init_process_group must not be called")
    monkeypatch.setattr(torch.distributed, "init_process_group", boom)
    assert not launch.is_initialized()
    launch.init_distributed()
    assert launch.is_initialized()
    launch.init_distributed()          # second call: still a no-op
    assert launch.is_initialized()
    assert launch.process_index() == 0 and launch.process_count() == 1


def test_env_var_coordinator_path(monkeypatch, fake_store):
    """PADDLE_TPU_COORDINATOR alone routes into the multi-process path:
    a TCPStore at that address (rank 0 hosts it) and a gloo group for the
    CPU."""
    seen = {}

    def fake_init(**kw):
        seen.update(kw)
    monkeypatch.setattr(torch.distributed, "init_process_group", fake_init)
    monkeypatch.setenv("PADDLE_TPU_COORDINATOR", "10.0.0.1:1234")
    launch.init_distributed(num_processes=2, process_id=1, device="cpu")
    assert fake_store.made == [("10.0.0.1", 1234, 2, False)]
    assert (seen["backend"], seen["world_size"], seen["rank"]) == \
        ("gloo", 2, 1)
    assert isinstance(seen["store"], _Store)
    assert launch.is_initialized()


def test_transient_failures_retry_then_succeed(monkeypatch, fake_store):
    """Connection-flavored failures retry with the seeded backoff; a
    later success initializes normally."""
    calls = {"n": 0}

    def flaky(**kw):
        calls["n"] += 1
        if calls["n"] < 3:
            raise ConnectionRefusedError("coordinator not up yet")
    monkeypatch.setattr(torch.distributed, "init_process_group", flaky)
    sleeps = []
    monkeypatch.setattr(launch, "retry_call",
                        lambda fn, policy, **kw: _drive_retry(
                            fn, policy, sleeps, kw))
    launch.init_distributed(coordinator_address="h:1", num_processes=2,
                            process_id=0, timeout_s=30.0, device="cpu")
    assert calls["n"] == 3
    assert launch.is_initialized()
    assert len(sleeps) == 2 and all(s > 0 for s in sleeps)
    # rank 0 hosts the store, once an attempt
    assert [m[3] for m in fake_store.made] == [True] * 3


def _drive_retry(fn, policy, sleeps, kw):
    """Run the real retry_call with an instrumented no-op sleep."""
    from paddle_tpu_torch.faults import retry_call
    kw = dict(kw)
    kw["sleep"] = sleeps.append
    return retry_call(fn, policy, **kw)


def test_store_network_errors_retry(monkeypatch):
    """The store's own connection error (a RuntimeError to the retry
    classifier) retries too."""
    net = getattr(torch.distributed, "DistNetworkError", None)
    if net is None:
        pytest.skip("this torch has no DistNetworkError")
    calls = {"n": 0}

    class Flaky(_Store):
        def __init__(self, *a, **kw):
            calls["n"] += 1
            if calls["n"] < 2:
                raise net("connect() refused")
            super().__init__(*a, **kw)
    monkeypatch.setattr(torch.distributed, "TCPStore", Flaky)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **kw: None)
    import paddle_tpu_torch.faults as faults
    monkeypatch.setattr(faults.time, "sleep", lambda s: None)
    launch.init_distributed(coordinator_address="h:2", num_processes=2,
                            process_id=1, device="cpu", timeout_s=5)
    assert calls["n"] == 2 and launch.is_initialized()


def test_timeout_budget_raises_typed_error(monkeypatch, fake_store):
    """A coordinator that never answers exhausts the budget and raises
    CoordinatorTimeoutError carrying address + budget (not the raw
    transport error)."""
    def dead(**kw):
        raise ConnectionRefusedError("nobody home")
    monkeypatch.setattr(torch.distributed, "init_process_group", dead)
    monkeypatch.setenv("PADDLE_TPU_COORDINATOR_TIMEOUT_S", "3")
    import paddle_tpu_torch.faults as faults
    monkeypatch.setattr(faults.time, "sleep", lambda s: None)
    with pytest.raises(launch.CoordinatorTimeoutError) as ei:
        launch.init_distributed(coordinator_address="h:9", num_processes=2,
                                process_id=0, device="cpu")
    err = ei.value
    assert err.address == "h:9"
    assert err.timeout_s == 3.0
    assert isinstance(err.last, ConnectionRefusedError)
    assert isinstance(err, TimeoutError)
    assert not launch.is_initialized()


def test_fatal_failures_do_not_retry(monkeypatch, fake_store):
    """A deterministic setup error (bad arguments) propagates on the
    first attempt."""
    calls = {"n": 0}

    def bad(**kw):
        calls["n"] += 1
        raise ValueError("num_processes mismatch")
    monkeypatch.setattr(torch.distributed, "init_process_group", bad)
    with pytest.raises(ValueError):
        launch.init_distributed(coordinator_address="h:1",
                                num_processes=2, process_id=0, device="cpu")
    assert calls["n"] == 1
    assert not launch.is_initialized()


def test_retry_policy_fits_budget():
    """The derived schedule's total sleep stays within the budget and is
    deterministic (seeded)."""
    for budget in (1.0, 10.0, 60.0, 300.0):
        policy = launch._retry_policy(budget)
        assert isinstance(policy, RetryPolicy)
        total = sum(policy.delay(i)
                    for i in range(policy.max_attempts - 1))
        assert total <= budget * (1.0 + policy.jitter) + 1e-6, budget
    a, b = launch._retry_policy(60.0), launch._retry_policy(60.0)
    assert [a.delay(i) for i in range(a.max_attempts - 1)] == \
        [b.delay(i) for i in range(b.max_attempts - 1)]


def test_backend_follows_the_device_with_no_fallback(monkeypatch):
    """nccl for the card, gloo for the CPU; a card world on a machine
    without a card raises instead of joining over gloo."""
    assert launch.backend_for("cuda") == "nccl"
    assert launch.backend_for("cpu") == "gloo"
    with pytest.raises(ValueError, match="no collective backend"):
        launch.backend_for("meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **kw: pytest.fail("joined without a card"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.init_distributed(coordinator_address="h:1", num_processes=2,
                                process_id=0)
    with pytest.raises(ValueError, match="host:port"):
        launch._store("nohost", 2, 0, 1.0)


_CHILD = r"""
import sys, torch
sys.path.insert(0, {repo!r})
from paddle_tpu_torch.distributed import launch
rank = int(sys.argv[1])
launch.init_distributed("localhost:{port}", num_processes=2, process_id=rank,
                        device="cpu", timeout_s=60)
t = torch.tensor([float(rank + 1)])
torch.distributed.all_reduce(t)
print("sum", t.item(), launch.process_index(), launch.process_count())
launch.shutdown()
"""


@pytest.mark.slow
def test_two_processes_join_over_a_tcp_coordinator():
    """Two interpreters join one gloo world through rank 0's TCPStore on
    localhost and all-reduce."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = _CHILD.format(repo=REPO, port=port)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)],
                              stdout=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert sorted(o.split()[1:] for o in outs) == \
        [["3.0", "0", "2"], ["3.0", "1", "2"]]
