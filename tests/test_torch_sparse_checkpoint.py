"""Sparse tables in checkpoints: the port's ``__sparse__/`` row groups
(``distributed/checkpoint.py``, ``train_state.Checkpointer``,
``trainer.SGD.train(sparse_tables=, checkpoint_dir=)``).

* a run preempted at a step (``trainer.step@K=preempt``) and resumed in
  a fresh executor and scope, into a table of another shard count, with
  the overlap legs on or off, continues bit for bit: the loss stream,
  the final rows and Adagrad moments equal an uninterrupted run's;
* with every push slowed, the prefetch, async-push and combined legs
  equal the synchronous rim bit for bit (the prefetch lead's bound);
* a chain of commits with sparse groups (a full base, then deltas of
  the rows pushed since) saved by one package restores in the other,
  both ways, to the same table bytes and dense var.
"""
import time

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.distributed.checkpoint import \
    CheckpointManager as JManager
from paddle_tpu.sparse import SparseTable as JTable
from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
from paddle_tpu_torch.faults import Preempted
from paddle_tpu_torch.sparse import SparseSession, SparseTable
from paddle_tpu_torch.testing import faultinject

from torch_parity import reset_both

VOCAB, DIM = 48, 6
CPU = ptt.CPUPlace()
ALL = np.arange(VOCAB, dtype=np.int64)


def _build():
    reset_both()
    ptt.default_main_program().random_seed = 42
    ptt.default_startup_program().random_seed = 42
    L = ptt.layers
    ids = L.data("ids", shape=[1], dtype="int64")
    label = L.data("label", shape=[1], dtype="float32")
    emb = L.embedding(ids, size=[VOCAB, DIM], sparse=True, name="tbl")
    loss = L.mean(L.square(L.fc(emb, size=1) - label))
    return loss, ptt.optimizer.Adagrad(learning_rate=0.1)


def _batches(n=6, seed=1, pools=None):
    rng = np.random.RandomState(seed)
    return [[(np.array([rng.choice(pools[b % len(pools)]) if pools
                        else rng.randint(0, VOCAB)], np.int64),
              rng.rand(1).astype(np.float32)) for _ in range(8)]
            for b in range(n)]


def _table(shards):
    return SparseTable("tbl", VOCAB, DIM, optimizer="adagrad",
                       learning_rate=0.1, num_shards=shards, seed=5)


def _train(batches, passes, shards, sess_kw=None, **kw):
    loss, opt = _build()
    table = _table(shards)
    sess = SparseSession(table, **(sess_kw or {}))
    tr = ptt.trainer.SGD(loss, update_equation=opt, place=CPU)
    got = []

    def handler(e):
        if isinstance(e, ptt.trainer.events.EndIteration):
            got.append(e.cost)
    try:
        tr.train(lambda: iter(batches), num_passes=passes,
                 event_handler=handler, sparse_tables=sess,
                 handle_signals=False, **kw)
    except Preempted:
        got.append("preempted")
    return got, table, sess


@pytest.mark.parametrize("sess_kw,pools", [
    ({}, None),
    ({"prefetch_depth": 2, "async_push": 2},
     [np.arange(i * 8, (i + 1) * 8) for i in range(6)]),
], ids=["sync", "prefetch+async"])
def test_preempt_and_resume_bit_identical_across_shard_change(
        tmp_path, sess_kw, pools):
    batches = _batches(pools=pools)
    ck = str(tmp_path / "ck")
    full, t_full, _ = _train(batches, 3, 2, sess_kw)
    faultinject.configure("trainer.step@9=preempt")
    try:
        first, _, _ = _train(batches, 3, 2, sess_kw, checkpoint_dir=ck,
                             save_every_n_steps=2)
    finally:
        faultinject.clear()
    assert first[-1] == "preempted" and len(first) == 10
    second, t_res, sess = _train(batches, 3, 5, sess_kw,
                                 checkpoint_dir=ck, resume=True,
                                 save_every_n_steps=2)
    assert first[:-1] + second == full
    assert t_res.pull(ALL).tobytes() == t_full.pull(ALL).tobytes()
    assert t_res.pull_slot("moment", ALL).tobytes() == \
        t_full.pull_slot("moment", ALL).tobytes()
    assert sess.pending_batches == 0


POOLS6 = [np.arange(i * 8, (i + 1) * 8) for i in range(6)]


@pytest.mark.parametrize("delay_ms", [50, 200])
@pytest.mark.parametrize("sess_kw", [
    {"prefetch_depth": 2},
    {"async_push": 2},
    {"prefetch_depth": 2, "async_push": 2},
], ids=["prefetch", "async", "prefetch+async"])
def test_overlap_legs_match_sync_rim_under_slow_pushes(
        monkeypatch, sess_kw, delay_ms):
    """With every push slowed, the overlap legs still equal the
    synchronous rim bit for bit over the 6-pool, 3-pass schedule: no
    pull runs far enough ahead to read a row whose push is pending."""
    batches = _batches(pools=POOLS6)
    sync, t_sync, _ = _train(batches, 3, 2)
    real_push = SparseTable.push

    def slow_push(self, *a, **kw):
        time.sleep(delay_ms / 1e3)
        return real_push(self, *a, **kw)
    monkeypatch.setattr(SparseTable, "push", slow_push)
    got, t_got, sess = _train(batches, 3, 2, sess_kw)
    assert got == sync
    assert t_got.pull(ALL).tobytes() == t_sync.pull(ALL).tobytes()
    assert t_got.pull_slot("moment", ALL).tobytes() == \
        t_sync.pull_slot("moment", ALL).tobytes()
    assert sess.pending_batches == 0


def test_resume_without_sparse_state_raises(tmp_path):
    ck = str(tmp_path / "ck")
    reset_both()
    L = ptt.layers
    ids = L.data("ids", shape=[1], dtype="int64")
    label = L.data("label", shape=[1], dtype="float32")
    emb = L.embedding(ids, size=[VOCAB, DIM], name="tbl")
    loss = L.mean(L.square(L.fc(emb, size=1) - label))
    tr = ptt.trainer.SGD(loss, update_equation=ptt.optimizer.SGD(0.1),
                         place=CPU)
    tr.train(lambda: iter(_batches(2)), checkpoint_dir=ck,
             handle_signals=False)
    loss, opt = _build()
    tr = ptt.trainer.SGD(loss, update_equation=opt, place=CPU)
    with pytest.raises(ValueError, match="no sparse-table state"):
        tr.train(lambda: iter(_batches(2)), num_passes=2,
                 sparse_tables=SparseSession(_table(2)),
                 checkpoint_dir=ck, resume=True, handle_signals=False)


def _touch(t, rng):
    ids = np.unique(rng.randint(0, 800, 40).astype(np.int64))
    t.push(ids, rng.randn(len(ids), t.dim).astype(np.float32))


def _commit_chain(make_scope, manager, table, rng):
    """A full commit, then two deltas of the rows pushed since, each
    under the token protocol; returns the dense var's last value."""
    w = np.zeros(4096, np.float32)
    for step, kind in ((1, "full"), (2, "delta"), (3, "delta")):
        _touch(table, rng)
        w[step * 100:step * 100 + 50] += step
        tok, st = table.export_full() if kind == "full" \
            else table.export_delta()
        manager.save(step, make_scope({**st, "w": w.copy()}),
                     blocking=True, kind=kind,
                     on_commit=lambda info, t=tok: table.commit_delta(t),
                     on_fail=lambda e, t=tok: table.retract_delta(t))
    return w


def _jax_scope(vals):
    sc = pt.Scope()
    for k, v in vals.items():
        sc.set(k, v)
    return sc


def _port_scope(vals):
    sc = ptt.Scope()
    for k, v in vals.items():
        sc.set(k, v if k.startswith("__sparse__/") else torch.from_numpy(v))
    return sc


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_sparse_chain_crosses_packages(tmp_path, writer):
    rng = np.random.RandomState(3)
    kw = dict(optimizer="adagrad", learning_rate=0.1, seed=11)
    if writer == "port":
        src = SparseTable("emb", 800, 6, num_shards=3, **kw)
        w = _commit_chain(_port_scope, CheckpointManager(
            str(tmp_path), async_save=False, device="cpu"), src, rng)
    else:
        src = JTable("emb", 800, 6, num_shards=3, **kw)
        w = _commit_chain(_jax_scope, JManager(str(tmp_path),
                                               async_save=False), src, rng)
    want = src.export_state_vars()
    for reader in ("port", "jax"):
        if reader == "port":
            sc = ptt.Scope()
            assert CheckpointManager(str(tmp_path),
                                     device="cpu").restore(scope=sc) == 3
            dense = sc.numpy("w")
            state = {k: sc.get(k) for k in sc.keys()
                     if k.startswith("__sparse__/")}
            assert all(isinstance(v, np.ndarray) for v in state.values())
            dst = SparseTable("emb", 800, 6, num_shards=2, **kw)
        else:
            sc = pt.Scope()
            assert JManager(str(tmp_path)).restore(scope=sc) == 3
            dense = np.asarray(sc.get("w"))
            state = {k: np.asarray(sc.get(k)) for k in sc.keys()
                     if k.startswith("__sparse__/")}
            dst = JTable("emb", 800, 6, num_shards=2, **kw)
        assert dense.tobytes() == w.tobytes()
        dst.restore_state_vars(state)
        again = SparseTable("emb", 800, 6, num_shards=3, **kw)
        again.restore_state_vars(dst.export_state_vars())
        got = again.export_state_vars()
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].tobytes() == want[k].tobytes(), (reader, k)
