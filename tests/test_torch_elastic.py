"""The port's elastic training service (``paddle_tpu_torch/distributed/
elastic.py`` with ``trainer.SGD.train(elastic=)`` and the master's
slot-sharded streams) on the CPU: the tests of ``tests/test_elastic.py``
on the port, with the port on ``CPUPlace``, and three held against the
JAX package:

* one slot's stream through both packages' ``ElasticWorker`` and
  trainer, the JAX startup scope carried into the port: costs within
  1e-5 (fp32, no dropout: the draws differ between the packages);
* ``merge_checkpoints`` of the same replicas (written by the JAX
  checkpoint manager, whose layout the port reads) equal to the JAX
  merge bit for bit, TrainState included;
* ``plan_for_world`` at worlds 1, 2, 4 and 8: the JAX planner's
  candidate and specs (the JAX program loaded through ``to_json``), and
  zero PT030/PT031 findings.
"""
import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch import layers
from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
from paddle_tpu_torch.distributed.elastic import (ElasticWorker,
                                                  merge_checkpoints,
                                                  plan_for_world)
from paddle_tpu_torch.distributed.master import Master, MasterServer
from paddle_tpu_torch.faults import Preempted
from paddle_tpu_torch.testing import faultinject as fi
from paddle_tpu_torch.train_state import TRAIN_STATE_VAR, TrainState

CPU = ptt.CPUPlace()


@pytest.fixture(autouse=True)
def _clean_spec():
    fi.clear()
    yield
    fi.clear()


def _write_chunks(tmp_path, n_chunks=4, recs_per_chunk=8, seed=0):
    rng = np.random.RandomState(seed)
    chunks = []
    for i in range(n_chunks):
        p = str(tmp_path / f"part-{i:03d}.pickle")
        recs = [(rng.rand(8).astype("float32"),
                 rng.randint(0, 3, (1,))) for _ in range(recs_per_chunk)]
        with open(p, "wb") as f:
            pickle.dump(recs, f)
        chunks.append(p)
    return chunks


def _write_chunk_records(n, seed=3):
    rng = np.random.RandomState(seed)
    return [(rng.rand(8).astype("float32"),
             rng.randint(0, 3, (1,))) for _ in range(n)]


def _build_trainer(pkg=ptt, dropout=0.3, place=CPU):
    L = pkg.layers
    x = L.data("x", shape=[8], dtype="float32")
    y = L.data("y", shape=[1], dtype="int64")
    h = L.fc(x, size=16, act="relu")
    if dropout:
        h = L.dropout(h, dropout_prob=dropout)   # the stream resumes too
    pred = L.fc(h, size=3, act="softmax")
    loss = L.mean(L.cross_entropy(pred, y))
    kw = {} if pkg is not ptt else {"place": place}
    return pkg.trainer.SGD(cost=loss,
                           update_equation=pkg.optimizer.Momentum(0.05, 0.9),
                           **kw)


def _fresh():
    ptt.core.reset_default_programs()
    ptt.core.reset_global_scope()
    ptt.unique_name.reset()


def _train_worker(tr, worker_cls, address, ckpt_dir, slot, batch_size,
                  spec, events):
    w = worker_cls(address, slot=slot, batch_size=batch_size,
                   heartbeat_interval_s=0.0)      # heartbeat every batch
    if spec:
        fi.configure(spec)
    out = []

    def handler(e):
        if isinstance(e, events.EndIteration):
            out.append(float(e.cost).hex())

    try:
        tr.train(w.reader, num_passes=1, event_handler=handler,
                 elastic=w, checkpoint_dir=str(ckpt_dir), resume=True)
    except Preempted:
        w.preempted = True
    finally:
        if spec:
            w.fired = {s: fi.fired(s)
                       for s in ("elastic.worker", "master.heartbeat")}
            fi.clear()
    return out, w


def _run_worker(master, ckpt_dir, slot=0, batch_size=4, spec=None):
    """One in-process elastic worker pass; returns (cost hexes, worker)."""
    srv = MasterServer(master).start()
    _fresh()
    tr = _build_trainer()
    try:
        return _train_worker(tr, ElasticWorker, srv.address, ckpt_dir,
                             slot, batch_size, spec, ptt.trainer.events)
    finally:
        srv.stop()


def _restore_cpu(d):
    sc = ptt.Scope()
    CheckpointManager(str(d), device="cpu").restore(scope=sc)
    return sc


# ---------------------------------------------------------------------------
# 1. slot-sharded exactly-once serving
# ---------------------------------------------------------------------------
def test_sharded_master_deterministic_disjoint_streams():
    m = Master(world=2, timeout_s=30.0)
    m.set_dataset([f"c{i}" for i in range(6)])
    with pytest.raises(ValueError):
        m.get_task()                       # sharded: slot is required
    s0 = [m.get_task(slot=0).task_id for _ in range(3)]
    s1 = [m.get_task(slot=1).task_id for _ in range(3)]
    assert s0 == [0, 2, 4] and s1 == [1, 3, 5]
    assert m.get_task(slot=0) is None and m.get_task(slot=1) is None


def test_register_cursor_reconciles_shard():
    """Done-but-uncommitted tasks re-serve in order; committed but
    unreported tasks stay done."""
    m = Master(world=2, timeout_s=30.0)
    m.set_dataset([f"c{i}" for i in range(6)])
    t0 = m.get_task(slot=0)
    m.task_finished(t0.task_id)
    m.get_task(slot=0)                     # task 2 leased, never finished
    resp = m.register_worker(0, cursor=0)
    assert resp["shard_done"] == 0
    assert [m.get_task(slot=0).task_id for _ in range(3)] == [0, 2, 4]
    m2 = Master(world=2, timeout_s=30.0)
    m2.set_dataset([f"c{i}" for i in range(6)])
    resp = m2.register_worker(0, cursor=2)
    assert resp["shard_done"] == 2
    assert m2.get_task(slot=0).task_id == 4
    assert m2.stats()["done"] == 2


def test_resize_reshards_remaining_work():
    m = Master(world=4, timeout_s=30.0)
    m.set_dataset([f"c{i}" for i in range(8)])
    m.register_worker(0, cursor=1)
    m.register_worker(1, cursor=1)
    leased = m.get_task(slot=2)
    assert leased.task_id == 2
    m.resize(2)
    assert m.world == 2 and m.members() == {}

    def drain(slot):
        ids = []
        while True:
            t = m.get_task(slot=slot)
            if t is None:
                return ids
            ids.append(t.task_id)
    assert drain(0) == [2, 4, 6]
    assert drain(1) == [3, 5, 7]


def test_live_member_lease_renews_instead_of_requeueing():
    """A lapsed task deadline whose holder still heartbeats renews; it
    forfeits once the membership lease goes stale."""
    import time as _time
    m = Master(world=1, timeout_s=0.05, heartbeat_lease_s=0.5)
    m.set_dataset(["c0", "c1"])
    m.register_worker(0)
    assert m.get_task(slot=0).task_id == 0
    _time.sleep(0.1)
    m.heartbeat(0)
    t2 = m.get_task(slot=0)
    assert t2.task_id == 1 and t2.num_failures == 0
    assert m.stats()["pending"] == 2
    _time.sleep(0.6)
    assert {m.get_task(slot=0).task_id for _ in range(2)} == {0, 1}


def test_empty_tasks_all_commit(tmp_path):
    """Two zero-batch tasks in a row both report finished after the next
    commit."""
    chunks = []
    for i, recs in enumerate(([], [], _write_chunk_records(8))):
        p = str(tmp_path / f"part-{i:03d}.pickle")
        with open(p, "wb") as f:
            pickle.dump(recs, f)
        chunks.append(p)
    m = Master(world=1, timeout_s=30.0)
    m.set_dataset(chunks)
    out, w = _run_worker(m, tmp_path / "ck")
    assert len(out) == 2
    assert w.cursor == 3
    assert m.stats() == {"todo": 0, "pending": 0, "done": 3, "epoch": 0}


def test_reconcile_ignores_failure_budget_drops():
    """A task retired by the failure budget is not counted by the
    committed cursor."""
    import time as _time
    m = Master(world=1, timeout_s=0.05, failure_max=1,
               heartbeat_lease_s=0.05)
    m.set_dataset(["c0", "c1", "c2"])
    m.register_worker(0)
    assert m.get_task(slot=0).task_id == 0
    _time.sleep(0.12)
    assert m.get_task(slot=0).task_id == 1
    assert m.stats()["done"] == 1
    resp = m.register_worker(0, cursor=1)
    assert resp["shard_done"] == 1
    assert m.get_task(slot=0).task_id == 2
    assert m.get_task(slot=0) is None


@pytest.mark.timeout(180)
def test_zero_batch_tail_after_drained_resume_commits(tmp_path):
    """A drained worker resumed onto empty tasks trains zero batches; the
    final save still commits so those tasks report finished."""
    chunks = []
    for i, recs in enumerate((_write_chunk_records(8), [], [])):
        p = str(tmp_path / f"part-{i:03d}.pickle")
        with open(p, "wb") as f:
            pickle.dump(recs, f)
        chunks.append(p)
    m = Master(world=1, timeout_s=30.0)
    m.set_dataset(chunks)
    m.register_worker(0)
    m.set_command("drain", slot=0)
    out1, w1 = _run_worker(m, tmp_path / "ck")
    assert w1.drained and len(out1) == 2
    assert m.stats()["done"] == 1
    out2, w2 = _run_worker(m, tmp_path / "ck")
    assert out2 == [] and w2.cursor == 3
    assert m.stats() == {"todo": 0, "pending": 0, "done": 3, "epoch": 0}


# ---------------------------------------------------------------------------
# 2. workers over the sharded stream: exactly-once and bit identity
# ---------------------------------------------------------------------------
@pytest.mark.timeout(180)
def test_two_slot_workers_consume_disjoint_shards(tmp_path):
    chunks = _write_chunks(tmp_path, n_chunks=4)
    m = Master(world=2, timeout_s=30.0)
    m.set_dataset(chunks)
    out0, w0 = _run_worker(m, tmp_path / "s0", slot=0)
    out1, w1 = _run_worker(m, tmp_path / "s1", slot=1)
    assert len(out0) == 4 and len(out1) == 4
    assert w0.cursor == 2 and w1.cursor == 2
    assert m.stats() == {"todo": 0, "pending": 0, "done": 4, "epoch": 0}
    assert m.members() == {}
    for d, slot in ((tmp_path / "s0", 0), (tmp_path / "s1", 1)):
        ts = TrainState.from_array(_restore_cpu(d).get(TRAIN_STATE_VAR))
        assert ts.elastic["slot"] == slot
        assert ts.elastic["cursor"] == 2 and ts.elastic["offset"] == 0


@pytest.mark.timeout(300)
def test_elastic_preempt_resume_bit_identity_mid_task(tmp_path):
    """A worker preempted mid-task and relaunched against the same
    master gives the uninterrupted run's stream bit for bit: no lost
    batch, no replayed batch."""
    chunks = _write_chunks(tmp_path, n_chunks=4)
    base_master = Master(world=1, timeout_s=30.0)
    base_master.set_dataset(chunks)
    baseline, _ = _run_worker(base_master, tmp_path / "ck-base")
    assert len(baseline) == 8
    m = Master(world=1, timeout_s=30.0)
    m.set_dataset(chunks)
    ck = tmp_path / "ck-int"
    part1, w1 = _run_worker(m, ck, spec="elastic.worker@5=preempt")
    assert getattr(w1, "preempted", False)
    assert 0 < len(part1) < 8
    part2, w = _run_worker(m, ck)
    assert part1 + part2 == baseline
    assert w.cursor == 4
    assert m.stats()["done"] == 4


@pytest.mark.timeout(180)
def test_drain_command_ends_stream_at_task_boundary(tmp_path):
    chunks = _write_chunks(tmp_path, n_chunks=3)
    m = Master(world=1, timeout_s=30.0)
    m.set_dataset(chunks)
    m.register_worker(0)
    m.set_command("drain", slot=0)
    out1, w1 = _run_worker(m, tmp_path / "ck")
    assert w1.drained
    assert len(out1) == 2
    assert m.stats()["done"] == 1
    out2, w2 = _run_worker(m, tmp_path / "ck")
    assert not w2.drained
    assert len(out2) == 4
    assert m.stats()["done"] == 3


def test_heartbeat_drop_injection_is_survivable(tmp_path):
    chunks = _write_chunks(tmp_path, n_chunks=2)
    m = Master(world=1, timeout_s=30.0, heartbeat_lease_s=0.0)
    m.set_dataset(chunks)
    out, w = _run_worker(m, tmp_path / "ck",
                         spec="master.heartbeat@*=drop")
    assert len(out) == 4
    assert w.fired["master.heartbeat"] >= 1
    assert m.stats()["done"] == 2


# ---------------------------------------------------------------------------
# 3. the train(elastic=) and Checkpointer(master=) surfaces
# ---------------------------------------------------------------------------
def test_train_elastic_requires_checkpoint_dir_and_per_batch_path():
    _fresh()
    tr = _build_trainer()

    class Hook:
        pass

    with pytest.raises(ValueError, match="checkpoint_dir"):
        tr.train(lambda: iter([]), elastic=Hook())
    with pytest.raises(ValueError, match="checkpoint_dir"):
        tr.train(lambda: iter([]), master=Master())
    with pytest.raises(ValueError, match="per-batch"):
        tr.train(lambda: iter([]), elastic=Hook(), checkpoint_dir="/x",
                 pipeline=True)
    with pytest.raises(ValueError, match="per-batch"):
        tr.train(lambda: iter([]), elastic=Hook(), checkpoint_dir="/x",
                 steps_per_dispatch=4)


def test_train_state_elastic_field_round_trips():
    ts = TrainState(emitted=7, elastic={"slot": 3, "cursor": 5,
                                        "offset": 1, "world": 8,
                                        "resize_epoch": 2})
    back = TrainState.from_array(ts.to_array())
    assert back.elastic == ts.elastic
    legacy = dataclasses.replace(ts, elastic=None)
    assert TrainState.from_array(legacy.to_array()).elastic is None


def test_train_master_state_rides_the_checkpoint(tmp_path):
    """``train(master=)``: the master's queue commits inside every
    checkpoint's TrainState and loads back on resume."""
    m = Master(chunks_per_task=1, timeout_s=30.0)
    m.set_dataset(["a", "b", "c"])
    t = m.get_task()
    m.task_finished(t.task_id)
    _fresh()
    tr = _build_trainer(dropout=0)
    rows = _write_chunk_records(8)
    tr.train(lambda: iter([rows[:4], rows[4:]]), master=m,
             checkpoint_dir=str(tmp_path), save_every_n_steps=1)
    ts = TrainState.from_array(_restore_cpu(tmp_path).get(TRAIN_STATE_VAR))
    assert ts.master == m.state_dict()
    fresh = Master(chunks_per_task=1, timeout_s=30.0)
    _fresh()
    tr2 = _build_trainer(dropout=0)
    tr2.train(lambda: iter([]), master=fresh, checkpoint_dir=str(tmp_path),
              resume=True)
    assert fresh.stats() == {"todo": 2, "pending": 0, "done": 1,
                             "epoch": 0}


# ---------------------------------------------------------------------------
# 4. replica merge
# ---------------------------------------------------------------------------
def _write_replica(d, params, emitted, elastic):
    sc = ptt.Scope()
    for k, v in params.items():
        sc.set(k, torch.as_tensor(v))
    ts = TrainState(emitted=emitted, exe_step=emitted, pass_id=1,
                    elastic=elastic)
    sc.set(TRAIN_STATE_VAR, ts.to_array())
    CheckpointManager(str(d), async_save=False, device="cpu").save(
        emitted, sc, blocking=True)


def test_merge_checkpoints_elementwise_mean_and_lineage(tmp_path):
    w = np.array([1.0, 3.0], np.float32)
    _write_replica(tmp_path / "s0",
                   {"w": w, "step": np.array([4], np.int64)},
                   emitted=4, elastic={"slot": 0, "cursor": 2,
                                       "offset": 0, "world": 2,
                                       "resize_epoch": 0})
    _write_replica(tmp_path / "s1",
                   {"w": w + 2.0, "step": np.array([9], np.int64)},
                   emitted=6, elastic={"slot": 1, "cursor": 3,
                                       "offset": 0, "world": 2,
                                       "resize_epoch": 0})
    info = merge_checkpoints([str(tmp_path / "s0"), str(tmp_path / "s1")],
                             str(tmp_path / "base"), world=1,
                             resize_epoch=1)
    assert len(info["merged_from"]) == 2
    assert info["emitted"] == 6
    sc = _restore_cpu(tmp_path / "base")
    np.testing.assert_allclose(sc.numpy("w"), w + 1.0)
    assert int(sc.numpy("step")[0]) == 9
    ts = TrainState.from_array(sc.get(TRAIN_STATE_VAR))
    assert ts.pass_id == 0 and ts.batch_id == 0
    assert ts.elastic == {"slot": None, "cursor": None, "offset": 0,
                          "world": 1, "resize_epoch": 1}
    assert ts.emitted == 6


def test_merge_skips_empty_and_requires_one(tmp_path):
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        merge_checkpoints([str(tmp_path / "empty")],
                          str(tmp_path / "base"), world=1, resize_epoch=1)
    _write_replica(tmp_path / "s0", {"w": np.ones(2, np.float32)},
                   emitted=1, elastic=None)
    info = merge_checkpoints([str(tmp_path / "empty"),
                              str(tmp_path / "s0")],
                             str(tmp_path / "base"), world=1,
                             resize_epoch=1)
    assert info["merged_from"] == [str(tmp_path / "s0")]


def test_merge_equals_the_jax_merge_bit_for_bit(tmp_path):
    """Three replicas written by the JAX checkpoint manager (float32
    weights, an int counter, a var whose shape differs in one replica):
    the port's merge and the JAX merge give the same bytes and the same
    TrainState (the counter's value: the JAX package keeps int64 as
    int32)."""
    from paddle_tpu.core.scope import Scope as JScope
    from paddle_tpu.distributed.checkpoint import CheckpointManager as JMgr
    from paddle_tpu.distributed.elastic import merge_checkpoints as jmerge
    from paddle_tpu.train_state import TrainState as JTS

    rng = np.random.default_rng(11)
    dirs = []
    for k in range(3):
        sc = JScope()
        sc.set("w", rng.standard_normal((17, 5)).astype(np.float32))
        sc.set("b", (rng.standard_normal(5) * 1e-3).astype(np.float32))
        sc.set("@STEP_COUNTER@", np.array([10 + k], np.int64))
        sc.set("odd", np.ones(3 if k == 1 else 4, np.float32) * k)
        ts = JTS(emitted=5 + 3 * (k == 2), exe_step=7 + k, pass_id=1,
                 elastic={"slot": k, "cursor": k, "offset": 0,
                          "world": 3, "resize_epoch": 0})
        sc.set(TRAIN_STATE_VAR, ts.to_array())
        d = str(tmp_path / f"slot-{k}")
        JMgr(d, async_save=False).save(ts.emitted, sc, blocking=True)
        dirs.append(d)
    ji = jmerge(dirs, str(tmp_path / "jbase"), world=2, resize_epoch=1)
    ti = merge_checkpoints(dirs, str(tmp_path / "tbase"), world=2,
                           resize_epoch=1)
    assert ji == ti
    a, b = _restore_cpu(tmp_path / "jbase"), _restore_cpu(tmp_path / "tbase")
    assert sorted(a.keys()) == sorted(b.keys())
    for k in a.keys():
        if k == TRAIN_STATE_VAR:
            continue
        if not b.get(k).is_floating_point():
            # the JAX package holds int64 as int32 (no x64): the values
            np.testing.assert_array_equal(a.numpy(k), b.numpy(k))
            continue
        assert a.get(k).dtype == b.get(k).dtype, k
        assert a.numpy(k).tobytes() == b.numpy(k).tobytes(), k
    assert TrainState.from_array(a.get(TRAIN_STATE_VAR)) == \
        TrainState.from_array(b.get(TRAIN_STATE_VAR))


# ---------------------------------------------------------------------------
# 5. the re-plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world", [8, 4, 2, 1])
def test_plan_for_world_zero_sharding_findings(world):
    _fresh()
    x = layers.data("x", shape=[8], dtype="float32")
    y = layers.data("label", shape=[1], dtype="int64")
    h = layers.fc(x, size=16, act="relu")
    pred = layers.fc(h, size=3, act="softmax")
    layers.mean(layers.cross_entropy(pred, y))
    payload = plan_for_world(ptt.default_main_program(), world,
                             assume_batch=16)
    assert payload["lint_findings"] == []
    assert payload["mesh"] == {"dp": world}
    assert payload["plan"]["feed_specs"]


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_plan_for_world_matches_the_jax_planner(world):
    """The JAX program of the elastic runner's config, with its backward
    and Momentum ops, loaded into the port through ``to_json``: the same
    candidate and specs as the JAX planner's, and no finding.  The port's
    cost model holds one H100's constants, so only the costs differ."""
    import paddle_tpu as pt
    from paddle_tpu.distributed.elastic import plan_for_world as jplan
    from torch_parity import reset_both
    reset_both()
    L = pt.layers
    x = L.data("x", shape=[32], dtype="float32")
    y = L.data("label", shape=[1], dtype="int64")
    h = L.fc(L.fc(x, size=64, act="relu"), size=64, act="relu")
    pred = L.fc(h, size=5, act="softmax")
    loss = L.mean(L.cross_entropy(pred, y))
    pt.optimizer.Momentum(0.1, 0.9).minimize(loss)
    jprog = pt.default_main_program()
    tprog = ptt.Program.from_json(jprog.to_json())
    want = jplan(jprog, world, assume_batch=8)
    got = plan_for_world(tprog, world, assume_batch=8)
    assert got["lint_findings"] == [] == want["lint_findings"]
    assert got["mesh"] == want["mesh"] == {"dp": world}
    assert got["candidate"] == want["candidate"]
    for k in ("param_specs", "feed_specs", "batch_axis", "candidate"):
        assert got["plan"][k] == want["plan"][k], k


# ---------------------------------------------------------------------------
# 6. one slot's stream through both packages
# ---------------------------------------------------------------------------
@pytest.mark.timeout(180)
def test_one_slot_stream_matches_the_jax_worker(tmp_path):
    """The same chunks through both packages' master, ElasticWorker and
    trainer (fp32, no dropout), the port from the JAX startup scope:
    the same number of batches, costs within 1e-5, both shards done."""
    import paddle_tpu as pt
    from paddle_tpu.distributed import master as jmaster
    from paddle_tpu.distributed.elastic import ElasticWorker as JWorker
    from torch_parity import jax_state, reset_both

    chunks = _write_chunks(tmp_path, n_chunks=4)
    reset_both()
    pt.default_startup_program().random_seed = 3
    jtr = _build_trainer(pt, dropout=0)
    jtr.exe.run(pt.default_startup_program(), feed={}, fetch_list=[])
    jtr._initialized = True
    ttr = _build_trainer(ptt, dropout=0)
    ttr.exe.run(ptt.default_startup_program(), feed={}, fetch_list=[])
    ptt.load_numpy_state(ptt.global_scope(), jax_state(pt.global_scope()),
                         "cpu")
    ttr._initialized = True

    costs = {}
    for name, tr, mmod, wcls, ev in (
            ("jax", jtr, jmaster, JWorker, pt.trainer.events),
            ("port", ttr, None, ElasticWorker, ptt.trainer.events)):
        mm = (mmod.Master if mmod else Master)(world=2, timeout_s=30.0)
        mm.set_dataset(chunks)
        srv = (mmod.MasterServer if mmod else MasterServer)(mm).start()
        try:
            out, w = _train_worker(tr, wcls, srv.address,
                                   tmp_path / f"ck-{name}", 1, 4, None, ev)
        finally:
            srv.stop()
        assert w.cursor == 2 and mm.stats()["done"] == 2
        costs[name] = [float.fromhex(c) for c in out]
    assert len(costs["port"]) == len(costs["jax"]) == 4
    np.testing.assert_allclose(costs["port"], costs["jax"], rtol=1e-5,
                               atol=1e-6)


def test_relaunch_gate_bounds_the_restarts():
    from paddle_tpu_torch.distributed.supervisor import Supervisor
    sup = Supervisor(max_restarts=2, backoff_base_s=0.0)
    assert sup.relaunch_gate("w", "exit -9")
    assert sup.relaunch_gate("w", "exit 75")
    assert not sup.relaunch_gate("w", "exit -9")
    assert sup.restarts == 2


def test_worker_place_raises_without_a_card(monkeypatch):
    """A worker told ``cuda`` on a machine without a card raises; it
    never carries on on the CPU."""
    from paddle_tpu_torch.distributed.elastic import worker_place
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CPUPlace"):
        worker_place("cuda")
    with pytest.raises(ValueError, match="cuda"):
        worker_place("tpu")
    assert worker_place("cpu").device() == torch.device("cpu")
