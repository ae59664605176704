"""The port's task-queue master (``paddle_tpu_torch/distributed/master.py``)
on the CPU: the tests of ``tests/test_master_service.py`` on the port,
a property test that drives both packages' ``Master`` through the same
random operations on a fake clock (equal ``state_dict()``s and equal
tasks handed out at every step), and the wire across packages (the
port's client against the JAX server and the JAX client against the
port's).  The one cross-process test is ``@slow`` (the rule of
``tests/test_repo_lint.py``)."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time
import types

import pytest
from hypothesis import example, given, settings, strategies as st

from paddle_tpu_torch.distributed.master import (Master, MasterClient,
                                                 MasterServer,
                                                 TaskQueueClient)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _start(master):
    return MasterServer(master).start()


def test_client_server_roundtrip():
    m = Master(chunks_per_task=2, timeout_s=30.0)
    m.set_dataset(list(range(10)))
    srv = _start(m)
    try:
        c = MasterClient(srv.address)
        assert c.ping() == "pong"
        got = []
        while True:
            t = c.get_task()
            if t is None:
                break
            got.extend(t.chunks)
            c.task_finished(t.task_id)
        assert sorted(got) == list(range(10))
        st_ = c.stats()
        assert st_["done"] == 5 and st_["todo"] == 0 and st_["pending"] == 0
        c.close()
    finally:
        srv.stop()


def test_task_queue_client_over_rpc():
    """TaskQueueClient (the reader integration) duck-types over the RPC
    stub unchanged."""
    m = Master(chunks_per_task=1, timeout_s=30.0)
    m.set_dataset([[1, 2], [3, 4], [5, 6]])
    srv = _start(m)
    try:
        c = MasterClient(srv.address)
        r = TaskQueueClient(c, chunk_reader=lambda ch: iter(ch))
        assert sorted(r.reader()()) == [1, 2, 3, 4, 5, 6]
    finally:
        srv.stop()


WORKER = textwrap.dedent("""
    import json, sys, os, time
    sys.path.insert(0, {repo!r})
    from paddle_tpu_torch.distributed.master import MasterClient
    addr, mode = sys.argv[1], sys.argv[2]
    c = MasterClient(addr)
    if mode == "die":
        t = c.get_task()
        assert t is not None
        print(json.dumps({{"got": t.task_id}}), flush=True)
        os._exit(1)          # hard death mid-task: no finish, no cleanup
    got = []
    while True:
        t = c.get_task()
        if t is None:
            st = c.stats()
            if st["pending"] == 0 and st["todo"] == 0:
                break
            time.sleep(0.2)   # a dead trainer's lease must lapse first
            continue
        got.extend(t.chunks)
        c.task_finished(t.task_id)
    print(json.dumps({{"chunks": got}}), flush=True)
""")


@pytest.mark.slow
@pytest.mark.timeout(60)
def test_elastic_trainer_death_cross_process(tmp_path):
    """Two trainer processes against one master service: trainer A takes
    a task and dies; after the lease times out the task re-queues and
    trainer B finishes the full dataset."""
    m = Master(chunks_per_task=1, timeout_s=1.0, failure_max=3)
    m.set_dataset(list(range(6)))
    srv = _start(m)
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=REPO))
    try:
        a = subprocess.run([sys.executable, str(script), srv.address,
                            "die"], capture_output=True, text=True,
                           timeout=30)
        died_with = json.loads(a.stdout.strip().splitlines()[-1])
        assert "got" in died_with
        assert a.returncode == 1
        b = subprocess.run([sys.executable, str(script), srv.address,
                            "work"], capture_output=True, text=True,
                           timeout=45)
        assert b.returncode == 0, b.stderr
        out = json.loads(b.stdout.strip().splitlines()[-1])
        assert sorted(out["chunks"]) == list(range(6))
    finally:
        srv.stop()


def test_generator_close_prompt_when_master_dead():
    """Closing a task-loop reader whose master died returns promptly:
    the GeneratorExit finalizer takes the single-attempt <=2 s
    ``task_returned_nowait`` path, not the full retry loop."""
    from paddle_tpu_torch.distributed.master import task_loop_reader

    m = Master(chunks_per_task=1, timeout_s=30.0)
    m.set_dataset([[1, 2], [3, 4], [5, 6]])
    srv = _start(m)
    c = MasterClient(srv.address)
    gen = task_loop_reader(c, chunk_reader=lambda ch: iter(ch))()
    assert next(gen) in (1, 3, 5)
    srv.stop()
    t0 = time.time()
    gen.close()
    elapsed = time.time() - t0
    assert elapsed < 10.0, f"generator close stalled {elapsed:.1f}s"
    c.close()


def test_task_failed_max_failure_drop():
    """A task that keeps failing is dropped after failure_max failures
    and never re-served this pass."""
    m = Master(chunks_per_task=1, timeout_s=30.0, failure_max=2)
    m.set_dataset([["poison"]])
    t1 = m.get_task()
    assert t1 is not None
    m.task_failed(t1.task_id)
    assert m.stats() == {"todo": 1, "pending": 0, "done": 0, "epoch": 0}
    t2 = m.get_task()
    assert t2 is not None and t2.task_id == t1.task_id
    assert t2.num_failures == 1
    m.task_failed(t2.task_id)
    assert m.stats() == {"todo": 0, "pending": 0, "done": 1, "epoch": 0}
    assert m.get_task() is None
    m.task_failed(t2.task_id)          # an unknown id is a no-op
    assert m.stats()["done"] == 1


def test_requeue_timeouts_redispatch_exactly_once():
    """A task whose holder dies is re-served exactly once: one timeout,
    one budget tick, one re-serve, no duplicate in any queue."""
    m = Master(chunks_per_task=1, timeout_s=0.15, failure_max=3)
    m.set_dataset([["c0"], ["c1"]])
    dead = m.get_task()
    assert dead is not None
    time.sleep(0.25)
    got = [m.get_task(), m.get_task()]
    ids = sorted(t.task_id for t in got)
    assert ids == sorted({dead.task_id} | {t.task_id for t in got})
    assert len(ids) == 2
    redispatched = next(t for t in got if t.task_id == dead.task_id)
    assert redispatched.num_failures == 1
    assert m.get_task() is None
    st_ = m.stats()
    assert st_["pending"] == 2 and st_["todo"] == 0
    for t in got:
        m.task_finished(t.task_id)
    st_ = m.stats()
    assert st_["done"] == 2 and st_["pending"] == 0


def test_membership_register_heartbeat_members_over_rpc():
    """Register, heartbeat, lease-style staleness, the command on the
    heartbeat reply and deregister, over the wire."""
    m = Master(chunks_per_task=1, timeout_s=30.0, world=2,
               heartbeat_lease_s=0.2)
    m.set_dataset([["a"], ["b"]])
    srv = _start(m)
    try:
        c = MasterClient(srv.address)
        resp = c.register_worker(0, cursor=None, pid=123)
        assert resp["ok"] and resp["world"] == 2
        assert resp["shard_done"] == 0
        hb = c.heartbeat(0)
        assert hb["ok"] and hb["cmd"] is None
        mem = c.members()
        assert mem[0]["stale"] is False and mem[0]["pid"] == 123
        time.sleep(0.3)
        assert c.members()[0]["stale"] is True
        c.heartbeat(0)
        assert c.members()[0]["stale"] is False
        m.set_command("drain", slot=0)
        assert c.heartbeat(0)["cmd"] == "drain"
        m.set_command(None, slot=0)
        assert c.heartbeat(0)["cmd"] is None
        c.deregister_worker(0)
        assert c.members() == {}
        c.close()
    finally:
        srv.stop()


def test_heartbeat_from_unregistered_slot_auto_registers():
    m = Master(heartbeat_lease_s=5.0)
    assert m.heartbeat(3)["ok"]
    assert 3 in m.members() and not m.members()[3]["stale"]


def test_membership_survives_state_dict_round_trip():
    """Membership and world serialize in state_dict; a long outage reads
    as every member stale."""
    m = Master(world=4, heartbeat_lease_s=0.05)
    m.set_dataset([[i] for i in range(4)])
    m.register_worker(0, cursor=1, pid=11)
    m.register_worker(2, cursor=0, pid=22)
    state = json.loads(json.dumps(m.state_dict()))
    fresh = Master(heartbeat_lease_s=0.05)
    fresh.load_state_dict(state)
    assert fresh.world == 4
    mem = fresh.members()
    assert set(mem) == {0, 2} and mem[0]["pid"] == 11
    time.sleep(0.06)
    assert all(v["stale"] for v in fresh.members().values())
    assert fresh.stats()["done"] == 1


def test_snapshot_path_preserves_sharded_mode(tmp_path):
    """The snapshot file carries state_dict's payload (world and
    membership included): a restored sharded master stays sharded."""
    p = str(tmp_path / "snap.json")
    m = Master(world=2, snapshot_path=p)
    m.set_dataset([["a"], ["b"], ["c"], ["d"]])
    m.register_worker(0, pid=7)
    t = m.get_task(slot=0)
    m.task_finished(t.task_id)
    m2 = Master(snapshot_path=p)
    m2.restore_snapshot()
    assert m2.world == 2
    assert m2.members()[0]["pid"] == 7
    with pytest.raises(ValueError):
        m2.get_task()
    assert m2.get_task(slot=0).task_id == 2


def test_state_dict_rpc_duck_types_for_checkpoint_embedding():
    """MasterClient.state_dict(): train(master=client) can embed a
    remote master's queue position in its checkpoint."""
    m = Master(chunks_per_task=1, timeout_s=30.0)
    m.set_dataset([["a"], ["b"]])
    srv = _start(m)
    try:
        c = MasterClient(srv.address)
        t = c.get_task()
        c.task_finished(t.task_id)
        state = c.state_dict()
        assert len(state["done"]) == 1 and len(state["todo"]) == 1
        c.close()
    finally:
        srv.stop()


def test_task_returned_nowait_succeeds_against_live_master():
    m = Master(chunks_per_task=1, timeout_s=30.0)
    m.set_dataset([[1, 2]])
    srv = _start(m)
    try:
        c = MasterClient(srv.address)
        t = c.get_task()
        assert t is not None
        c.task_returned_nowait(t.task_id)
        t2 = c.get_task()
        assert t2 is not None and t2.chunks == t.chunks
        c.task_finished(t2.task_id)
        assert c.stats()["done"] == 1
        c.close()
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# both packages' Master under one random sequence of operations
# ---------------------------------------------------------------------------
_ARGS = {
    # slot 3 asks with no slot: a slot-sharded master refuses that
    "get_task": st.tuples(st.integers(0, 3)),
    "advance": st.tuples(st.sampled_from([0.5, 2.5])),
    "heartbeat": st.tuples(st.integers(0, 3)),
    "set_dataset": st.tuples(st.integers(0, 9)),
    "task_finished": st.tuples(st.integers(0, 9)),
    "task_failed": st.tuples(st.integers(0, 9)),
    "task_returned": st.tuples(st.integers(0, 9)),
    "register_worker": st.tuples(st.integers(0, 3),
                                 st.one_of(st.none(), st.integers(0, 4))),
    "deregister_worker": st.tuples(st.integers(0, 3)),
    "set_command": st.tuples(st.integers(0, 3),
                             st.sampled_from([None, "drain"])),
    "resize": st.tuples(st.integers(1, 4)),
}
# weighted toward serving, heartbeats and the clock (the paths of
# leases, timeouts and the failure budget); a new dataset resets every
# queue, so it is rare
_KINDS = ["get_task"] * 6 + ["advance"] * 4 + ["heartbeat"] * 2 + [
    k for k in _ARGS if k not in ("get_task", "advance", "heartbeat")]
_OPS = st.sampled_from(_KINDS).flatmap(
    lambda k: _ARGS[k].map(lambda args: (k,) + args))


def _apply(m, op):
    kind = op[0]
    if kind == "set_dataset":
        return m.set_dataset([f"c{i}" for i in range(op[1])])
    if kind == "get_task":
        t = m.get_task(slot=op[1] if op[1] < 3 else None)
        return None if t is None else dataclasses.asdict(t)
    if kind in ("task_finished", "task_failed", "task_returned",
                "heartbeat", "deregister_worker", "resize"):
        return getattr(m, kind)(op[1])
    if kind == "register_worker":
        return m.register_worker(op[1], cursor=op[2], pid=100 + op[1])
    if kind == "set_command":
        return m.set_command(op[2], slot=op[1])
    raise AssertionError(kind)


@settings(max_examples=300, deadline=None)
# a task timed out twice (the failure budget drops it)
@example(world=None, chunks_per_task=1, n_chunks=1,
         ops=[("get_task", 0), ("advance", 2.5), ("get_task", 0),
              ("advance", 2.5), ("get_task", 0)])
# cursor reconcile, a live member's lease renewed, a stale one forfeited,
# a resize, and a sharded master asked with no slot
@example(world=2, chunks_per_task=1, n_chunks=6,
         ops=[("get_task", 0), ("task_finished", 0), ("get_task", 0),
              ("register_worker", 0, 0), ("get_task", 0), ("get_task", 0),
              ("register_worker", 0, 2), ("get_task", 0),
              ("heartbeat", 0), ("advance", 2.5), ("get_task", 1),
              ("register_worker", 1, None), ("get_task", 1),
              ("advance", 2.5), ("heartbeat", 1), ("get_task", 0),
              ("advance", 0.5), ("get_task", 0), ("resize", 1),
              ("get_task", 3), ("get_task", 0), ("task_returned", 4),
              ("task_failed", 5), ("get_task", 0)])
@given(world=st.sampled_from([None, 1, 2, 3]),
       chunks_per_task=st.integers(1, 2), n_chunks=st.integers(1, 9),
       ops=st.lists(_OPS, min_size=5, max_size=50))
def test_masters_of_both_packages_agree(world, chunks_per_task, n_chunks,
                                        ops):
    """The same operations on the JAX ``Master`` and the port's, each on
    one fake clock (task timeouts 2 s, heartbeat lease 1 s; the clock
    moves by 0.5 or 2.5 s): every
    operation returns the same value (the tasks handed out included) or
    raises the same exception type, and the ``state_dict()``s stay
    equal."""
    from paddle_tpu.distributed import master as jmaster
    from paddle_tpu_torch.distributed import master as tmaster

    clock = [1000.0]
    fake = types.SimpleNamespace(time=lambda: clock[0])
    saved = (jmaster.time, tmaster.time)
    jmaster.time = tmaster.time = fake
    try:
        kw = dict(chunks_per_task=chunks_per_task, timeout_s=2.0,
                  failure_max=2, world=world, heartbeat_lease_s=1.0)
        a, b = jmaster.Master(**kw), tmaster.Master(**kw)
        for op in [("set_dataset", n_chunks)] + ops:
            if op[0] == "advance":
                clock[0] += op[1]
                continue
            out = []
            for m in (a, b):
                try:
                    out.append(("ok", _apply(m, op)))
                except Exception as e:  # noqa: BLE001 — compared below
                    out.append(("raised", type(e).__name__))
            assert out[0] == out[1], (op, out)
            assert a.state_dict() == b.state_dict(), op
            assert a.stats() == b.stats() and a.members() == b.members()
    finally:
        jmaster.time, tmaster.time = saved


# ---------------------------------------------------------------------------
# the wire across packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("client_pkg", ["port", "jax"],
                         ids=["port-client-jax-server",
                              "jax-client-port-server"])
def test_wire_crosses_packages(client_pkg):
    """One protocol: either package's client drives either package's
    server through every method, and the server's master ends in the
    state the same calls leave an in-process master of the client's
    package in."""
    from paddle_tpu.distributed import master as jmaster
    from paddle_tpu_torch.distributed import master as tmaster
    client_mod, server_mod = (tmaster, jmaster) if client_pkg == "port" \
        else (jmaster, tmaster)
    m = server_mod.Master(chunks_per_task=1, timeout_s=30.0, world=2,
                          heartbeat_lease_s=30.0)
    srv = server_mod.MasterServer(m).start()
    try:
        c = client_mod.MasterClient(srv.address)
        assert c.ping() == "pong"
        assert c.set_dataset_if_empty([f"p{i}" for i in range(6)]) is True
        assert c.set_dataset_if_empty(["x"]) is False
        assert c.register_worker(0, cursor=None, pid=5) == {
            "ok": True, "world": 2, "slot": 0, "shard_done": 0}
        assert c.heartbeat(0) == {"ok": True, "cmd": None}
        t = c.get_task(slot=0)
        assert isinstance(t, client_mod.Task)
        assert (t.task_id, t.chunks, t.epoch, t.num_failures) == \
            (0, ["p0"], 0, 0)
        c.task_finished(t.task_id)
        t = c.get_task(slot=1)
        c.task_failed(t.task_id)
        t = c.get_task(slot=1)
        assert (t.task_id, t.num_failures) == (1, 1)
        c.task_returned_nowait(t.task_id)
        m.set_command("drain", slot=0)
        assert c.heartbeat(0)["cmd"] == "drain"
        assert c.request_save_model("w0") is True
        assert c.request_save_model("w1") is False
        assert c.stats() == {"todo": 5, "pending": 0, "done": 1,
                             "epoch": 0}
        assert set(c.members()) == {0}
        state = c.state_dict()
        assert state == json.loads(json.dumps(m.state_dict()))
        c.deregister_worker(0)
        assert c.members() == {}
        with pytest.raises(RuntimeError, match="master: ValueError"):
            c.get_task()                      # sharded: slot required
        c.close()
    finally:
        srv.stop()


def test_cloud_reader_reads_every_record_once(tmp_path):
    """``reader.creator.cloud_reader``: part files become the master's
    tasks; two readers sharing one master read every record once between
    them, and a reader closed early hands its task back."""
    import pickle
    from paddle_tpu_torch.reader.creator import cloud_reader
    for i in range(4):
        with open(tmp_path / f"part-{i:03d}.pickle", "wb") as f:
            pickle.dump([(i, j) for j in range(3)], f)
    m = Master(chunks_per_task=1, timeout_s=30.0)
    srv = _start(m)
    try:
        pattern = str(tmp_path / "part-*.pickle")
        early = cloud_reader(pattern, srv.address)()
        assert next(early)[1] == 0
        early.close()                       # returned, not failed
        assert m.stats() == {"todo": 4, "pending": 0, "done": 0,
                             "epoch": 0}
        got = list(cloud_reader(pattern, srv.address)())
        assert sorted(got) == [(i, j) for i in range(4) for j in range(3)]
        assert m.stats()["done"] == 4
        assert all(t.num_failures == 0 for t in m.done)
        with pytest.raises(FileNotFoundError):
            cloud_reader(str(tmp_path / "none-*"), srv.address)
    finally:
        srv.stop()
