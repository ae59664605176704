"""The port's ``distributed/checkpoint.py`` on the CPU: mirrors of
``tests/test_checkpoint_delta.py`` (dense chunk deltas, the chain
manifest, rebase) and of the manager tests of
``tests/test_fault_tolerance.py:281-455`` (fallback from corrupt and
truncated commits, injected torn writes, async failures, the re-commit
shelf, timeouts), the snapshot's independence from later writes, and
both directions of the cross-package check: the port restores what the
JAX ``CheckpointManager`` wrote and the JAX package restores what the
port wrote.  Every comparison is exact (bit-equal arrays, equal
TrainState fields)."""
import json
import os
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.distributed.checkpoint import (
    DEFAULT_BARRIER_TIMEOUT_S, CheckpointManager, CheckpointTimeoutError,
    DeltaChainError, load_checkpoint, save_checkpoint)
from paddle_tpu_torch.faults import InjectedFault
from paddle_tpu_torch.testing import faultinject as fi
from paddle_tpu_torch.train_state import (TRAIN_STATE_VAR, Checkpointer,
                                          DeltaPolicy, TrainState)


@pytest.fixture(autouse=True)
def _clean_spec():
    fi.clear()
    yield
    fi.clear()


def _cm(path, **kw):
    kw.setdefault("async_save", False)
    return CheckpointManager(str(path), device="cpu", **kw)


def _scope(**vals):
    sc = ptt.Scope()
    for k, v in vals.items():
        sc.set(k, v if isinstance(v, torch.Tensor) else torch.tensor(v))
    return sc


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


def _mixed():
    g = torch.Generator().manual_seed(3)
    return {"w": torch.randn(5, 7, generator=g),
            "h": torch.randn(9, generator=g).to(torch.bfloat16),
            "@STEP_COUNTER@": torch.tensor([41], dtype=torch.int64),
            "n": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "flag": torch.tensor([True, False]),
            "d": torch.randn(4, generator=g, dtype=torch.float64)}


# ---------------------------------------------------------------------------
# Round trips
# ---------------------------------------------------------------------------
def test_full_round_trip_keeps_every_dtype(tmp_path):
    vals = _mixed()
    cm = _cm(tmp_path)
    cm.save(3, _scope(**vals))
    fresh = ptt.Scope()
    assert _cm(tmp_path).restore(scope=fresh) == 3
    for k, v in vals.items():
        _same(fresh.get(k), v)
    with open(tmp_path / "ckpt-3" / "meta.json") as f:
        meta = json.load(f)
    assert meta["format"] == "sharded-v1" and meta["kind"] == "full"
    assert meta["vars"]["h"]["dtype"] == "bfloat16"
    assert meta["vars"]["w"]["shards"][0]["index"] == [[0, 5], [0, 7]]


def test_restore_keeps_the_scope_dtype_and_device(tmp_path):
    """A var the scope already holds comes back in its dtype (an int32
    file into an int64 counter); one of another shape is replaced by the
    checkpoint's, as the JAX manager does."""
    cm = _cm(tmp_path)
    cm.save(1, _scope(c=torch.tensor([5], dtype=torch.int32)))
    dest = _scope(c=torch.tensor([0], dtype=torch.int64))
    cm.restore(scope=dest)
    _same(dest.get("c"), torch.tensor([5], dtype=torch.int64))
    other = _scope(c=torch.zeros(3))
    _cm(tmp_path).restore(scope=other)
    _same(other.get("c"), torch.tensor([5], dtype=torch.int32))


def test_a_delta_never_replaces_its_parent(tmp_path):
    """Re-saving the tip's step (the final save after a periodic one at
    the same step) as a delta would chain onto the directory it
    replaces: refused before anything is written, and the Checkpointer
    commits a full rebase instead."""
    cm = _cm(tmp_path, chunk_bytes=64)
    cm.save(1, _scope(w=torch.zeros(64)))
    cm.save(2, _scope(w=torch.ones(64)), kind="delta")
    with pytest.raises(DeltaChainError, match="replaces"):
        cm.save(2, _scope(w=torch.full((64,), 2.0)), kind="delta")

    class _Exe:
        _step = 0
        device = "cpu"
    ck = Checkpointer(str(tmp_path / "ck"), _Exe(), handle_signals=False,
                      delta=DeltaPolicy(chunk_bytes=64), max_to_keep=10)
    scope = _scope(w=torch.zeros(64))
    ck.begin(scope, None, 0, {})
    for step, final in ((1, False), (2, False), (2, True)):
        scope.set("w", torch.full((64,), float(step + final)))
        ck.emitted = step
        ck._save(1 if final else 0, 0, blocking=True)
    assert [s["kind"] for s in ck.saves] == ["full", "delta", "full"]
    with open(tmp_path / "ck" / "ckpt-2" / "meta.json") as f:
        assert json.load(f)["kind"] == "full"
    fresh = ptt.Scope()
    assert _cm(tmp_path / "ck").restore(scope=fresh) == 2
    _same(fresh.get("w"), torch.full((64,), 3.0))


def test_save_and_load_checkpoint_functions(tmp_path):
    save_checkpoint(str(tmp_path), 4, _scope(w=torch.ones(3)))
    sc = ptt.Scope()
    assert load_checkpoint(str(tmp_path), scope=sc, device="cpu") == 4
    _same(sc.get("w"), torch.ones(3))


def test_snapshot_owns_its_bytes(tmp_path):
    """``save()`` returns with the snapshot on the host: writes to the
    scope's tensors afterwards, in place or by a new tensor, before the
    async writer runs, do not reach the checkpoint."""
    w = torch.arange(8, dtype=torch.float32)
    h = torch.ones(4, dtype=torch.bfloat16)
    sc = _scope(w=w, h=h)
    cm = CheckpointManager(str(tmp_path), async_save=True, device="cpu")
    gate = __import__("threading").Event()
    real = cm._write

    def slow_write(*a, **kw):
        gate.wait(5)
        return real(*a, **kw)
    cm._write = slow_write
    cm.save(1, sc)
    w.add_(100.0)                 # in place, as a captured replay writes
    h.mul_(3)
    sc.set("w2", torch.zeros(2))
    gate.set()
    cm.wait()
    fresh = ptt.Scope()
    cm.restore(scope=fresh)
    _same(fresh.get("w"), torch.arange(8, dtype=torch.float32))
    _same(fresh.get("h"), torch.ones(4, dtype=torch.bfloat16))
    assert not fresh.has("w2")
    assert cm.last_snapshot["bytes"] == 8 * 4 + 4 * 2
    assert [c["step"] for c in cm.commits] == [1]
    assert cm.last_restore_ms >= 0


# ---------------------------------------------------------------------------
# Delta chains
# ---------------------------------------------------------------------------
def test_delta_chain_restores_bit_identical(tmp_path):
    chunk = 256
    w = torch.zeros(2048)
    cm = _cm(tmp_path, chunk_bytes=chunk)
    m = []
    for step, kind in ((1, "full"), (2, "delta"), (3, "delta")):
        if step == 2:
            w[100:200] += 1.0
        if step == 3:
            w[1500] = -3.0
        cm.save(step, _scope(w=w.clone(), b=torch.ones(3)), kind=kind)
        with open(tmp_path / f"ckpt-{step}" / "meta.json") as f:
            m.append(json.load(f))
    assert [x["kind"] for x in m] == ["full", "delta", "delta"]
    assert [x["chain_len"] for x in m] == [0, 1, 2]
    assert m[1]["parent"] == m[0]["content_hash"]
    assert m[2]["parent"] == m[1]["content_hash"]
    # the unchanged var writes nothing; w only its changed chunks
    assert all(sh["patch"] is None for sh in m[1]["vars"]["b"]["shards"])
    assert m[2]["vars"]["w"]["shards"][0]["patch"]["changed"] == [23]
    assert 0 < m[2]["delta_bytes"] <= 2 * chunk
    fresh = ptt.Scope()
    cm2 = _cm(tmp_path)
    assert cm2.restore(scope=fresh) == 3
    _same(fresh.get("w"), w)
    # the restored tip is adopted: the next delta chains onto it
    assert cm2.chain_stats()["alive"]
    cm2.save(4, _scope(w=w + 1, b=torch.ones(3)), kind="delta")
    with open(tmp_path / "ckpt-4" / "meta.json") as f:
        m4 = json.load(f)
    assert m4["parent"] == m[2]["content_hash"] and m4["chain_len"] == 3


def test_delta_requires_a_live_chain(tmp_path):
    cm = _cm(tmp_path)
    with pytest.raises(DeltaChainError):
        cm.save(1, _scope(w=torch.ones(4)), kind="delta")
    cm.save(1, _scope(w=torch.ones(4)))
    fi.configure("ckpt.delta@1=error")
    with pytest.raises(InjectedFault):
        cm.save(2, _scope(w=torch.ones(4) * 2), kind="delta")
    fi.clear()
    assert not cm.chain_stats()["alive"]
    with pytest.raises(DeltaChainError):
        cm.save(2, _scope(w=torch.ones(4)), kind="delta")


def test_torn_delta_falls_back_to_the_durable_prefix(tmp_path):
    cm = _cm(tmp_path, chunk_bytes=64)
    cm.save(1, _scope(w=torch.zeros(64)))
    cm.save(2, _scope(w=torch.ones(64)), kind="delta")
    fi.configure("ckpt.delta@1=truncate")
    cm.save(3, _scope(w=torch.full((64,), 2.0)), kind="delta")
    fi.clear()
    fresh = ptt.Scope()
    assert _cm(tmp_path).restore(scope=fresh) == 2
    _same(fresh.get("w"), torch.ones(64))


def test_checkpointer_policy_full_then_deltas_then_rebase(tmp_path):
    """Dense weights that change in a few chunks a step: deltas until
    ``max_chain``, then a full rebase; the chain restores exactly."""
    class _Exe:
        _step = 0
        device = "cpu"
    ck = Checkpointer(str(tmp_path), _Exe(), handle_signals=False,
                      delta=DeltaPolicy(max_chain=2, chunk_bytes=1024),
                      max_to_keep=10)
    scope = ptt.Scope()
    w = torch.zeros(4096)
    scope.set("w", w)
    ck.begin(scope, None, 0, {})
    kinds = []
    for step in range(1, 6):
        w[step * 7] = step
        ck.emitted = step
        ck._save(0, step, blocking=True)
        with open(tmp_path / f"ckpt-{step}" / "meta.json") as f:
            kinds.append(json.load(f)["kind"])
    assert kinds == ["full", "delta", "delta", "full", "delta"]
    assert not scope.has(TRAIN_STATE_VAR)
    fresh = ptt.Scope()
    _cm(tmp_path).restore(scope=fresh)
    _same(fresh.get("w"), w)
    assert TrainState.from_array(fresh.get(TRAIN_STATE_VAR)).emitted == 5


def test_every_chunk_changed_rebases_every_other_commit(tmp_path):
    """A dense step changes every chunk: a delta writes what a base
    writes, so the rebase fraction (0.5) makes every other commit full."""
    class _Exe:
        _step = 0
        device = "cpu"
    ck = Checkpointer(str(tmp_path), _Exe(), handle_signals=False,
                      delta=DeltaPolicy(chunk_bytes=512), max_to_keep=10)
    scope = ptt.Scope()
    ck.begin(scope, None, 0, {})
    kinds = []
    for step in range(1, 5):
        scope.set("w", torch.full((1024,), float(step)))
        ck.emitted = step
        ck._save(0, step, blocking=True)
        kinds.append(ck.saves[-1]["kind"])
    assert kinds == ["full", "delta", "full", "delta"]


def test_retention_keeps_a_kept_delta_s_ancestors(tmp_path):
    cm = _cm(tmp_path, max_to_keep=2, chunk_bytes=64)
    cm.save(1, _scope(w=torch.zeros(64)))
    for s in (2, 3, 4):
        cm.save(s, _scope(w=torch.full((64,), float(s))), kind="delta")
    assert cm.all_steps() == [1, 2, 3, 4]      # 3 and 4 replay from 1
    cm.save(5, _scope(w=torch.ones(64)))
    cm.save(6, _scope(w=torch.ones(64) * 6))
    assert cm.all_steps() == [5, 6]


# ---------------------------------------------------------------------------
# Corruption, failures, timeouts
# ---------------------------------------------------------------------------
def _save_two(tmp_path):
    cm = _cm(tmp_path)
    cm.save(1, _scope(w=torch.arange(6, dtype=torch.float32)))
    cm.save(2, _scope(w=torch.arange(6, dtype=torch.float32) * 10))
    return cm


def _shard(tmp_path, step):
    d = tmp_path / f"ckpt-{step}"
    return d / [f for f in os.listdir(d) if f.endswith(".npy")][0]


def test_corrupt_latest_falls_back_to_newest_intact(tmp_path):
    cm = _save_two(tmp_path)
    with open(_shard(tmp_path, 2), "r+b") as f:
        f.seek(-4, 2)
        f.write(b"\xde\xad\xbe\xef")
    fresh = ptt.Scope()
    assert cm.restore(scope=fresh) == 1
    _same(fresh.get("w"), torch.arange(6, dtype=torch.float32))


def test_truncated_latest_falls_back(tmp_path):
    cm = _save_two(tmp_path)
    with open(_shard(tmp_path, 2), "r+b") as f:
        f.truncate(8)
    assert cm.restore(scope=ptt.Scope()) == 1


def test_injected_write_truncation_detected_on_restore(tmp_path):
    cm = _cm(tmp_path)
    cm.save(1, _scope(w=torch.arange(64, dtype=torch.float32)))
    fi.configure("ckpt.write@1=truncate")
    cm.save(2, _scope(w=torch.arange(64, dtype=torch.float32) + 1))
    fi.clear()
    fresh = ptt.Scope()
    assert cm.restore(scope=fresh) == 1
    _same(fresh.get("w"), torch.arange(64, dtype=torch.float32))
    assert cm.all_steps() == [1, 2]


def test_async_write_failure_surfaces_on_wait(tmp_path):
    sc = _scope(w=torch.arange(4, dtype=torch.float32))
    cm = CheckpointManager(str(tmp_path), async_save=True, device="cpu")
    fi.configure("ckpt.write@1=error")
    cm.save(1, sc)
    with pytest.raises(InjectedFault):
        cm.wait()
    fi.clear()
    assert cm.all_steps() == []
    cm.save(2, sc, blocking=True)
    assert cm.all_steps() == [2]


def test_async_write_failure_surfaces_on_the_next_save(tmp_path):
    sc = _scope(w=torch.arange(4, dtype=torch.float32))
    cm = CheckpointManager(str(tmp_path), async_save=True, device="cpu")
    fi.configure("ckpt.write@1=error")
    cm.save(1, sc)
    while cm._pending_steps():
        pass
    with pytest.raises(InjectedFault):
        cm.save(2, sc)
    fi.clear()


def _sparse_scope(shards):
    return _scope(w=torch.ones(4), **{
        f"__sparse__/tbl/shard{k}/{m}": v for k in range(shards)
        for m, v in (("ids", torch.arange(3, dtype=torch.int64)),
                     ("rows", torch.ones(3, 2)))})


def test_a_failing_async_delta_surfaces_once_on_the_next_delta(tmp_path):
    """An async delta whose sparse layout changed fails on the writer,
    which marks the chain dead before it holds the error.  A delta save
    in that window waits for the error and raises it, and the rebase
    after it commits: the race once raised "no live parent chain" there
    and the held error again on the rebase."""
    cm = CheckpointManager(str(tmp_path), async_save=True, device="cpu")
    cm.save(1, _sparse_scope(2))
    cm.wait()
    # on_fail runs in the window: the chain dead, the error not yet held
    cm.save(2, _sparse_scope(3), kind="delta",
            on_fail=lambda exc: time.sleep(0.5))
    t0 = time.monotonic()
    while cm.chain_stats()["alive"] and time.monotonic() - t0 < 30:
        time.sleep(0.001)
    with pytest.raises(DeltaChainError, match="sparse layout changed"):
        cm.save(3, _sparse_scope(3), kind="delta")
    cm.save(3, _sparse_scope(3))
    cm.wait()
    assert cm.all_steps() == [1, 3]


def test_recommit_shelf_recovers_when_final_missing(tmp_path):
    cm = _cm(tmp_path)
    cm.save(3, _scope(w=torch.arange(4, dtype=torch.float32)))
    os.rename(tmp_path / "ckpt-3", tmp_path / "ckpt-3.prev.tmp")
    assert cm.all_steps() == [3]
    fresh = ptt.Scope()
    assert cm.restore(scope=fresh) == 3
    _same(fresh.get("w"), torch.arange(4, dtype=torch.float32))
    cm.save(3, _scope(w=torch.arange(4, dtype=torch.float32)))
    assert not os.path.exists(tmp_path / "ckpt-3.prev.tmp")


def test_all_corrupt_raises_file_not_found(tmp_path):
    cm = _cm(tmp_path)
    cm.save(1, _scope(w=torch.arange(6, dtype=torch.float32)))
    with open(_shard(tmp_path, 1), "r+b") as f:
        f.truncate(4)
    with pytest.raises(FileNotFoundError, match="no valid checkpoint"):
        cm.restore(scope=ptt.Scope())


def test_ckpt_write_generic_action_raises(tmp_path):
    cm = _cm(tmp_path)
    fi.configure("ckpt.write@1=error")
    with pytest.raises(InjectedFault):
        cm.save(1, _scope(w=torch.arange(8, dtype=torch.float32)))
    assert fi.fired("ckpt.write") == 1


def test_wait_for_timeout_typed_and_configurable(tmp_path, monkeypatch):
    cm = _cm(tmp_path, barrier_timeout_s=0.05)
    with pytest.raises(CheckpointTimeoutError) as ei:
        cm._wait_for(lambda: False, "ckpt-9 shard manifests")
    assert isinstance(ei.value, TimeoutError)
    assert ei.value.tag == "ckpt-9 shard manifests"
    assert ei.value.timeout_s == 0.05
    monkeypatch.setenv("PADDLE_TPU_CKPT_TIMEOUT_S", "0.03")
    assert _cm(tmp_path).barrier_timeout_s == 0.03
    monkeypatch.delenv("PADDLE_TPU_CKPT_TIMEOUT_S")
    assert _cm(tmp_path).barrier_timeout_s == DEFAULT_BARRIER_TIMEOUT_S


def test_two_processes_process_zero_writes(tmp_path):
    """The multi-process protocol with an injected identity: process 1
    writes an empty manifest and waits for process 0's commit."""
    import threading
    barrier = threading.Barrier(2)
    sc = _scope(w=torch.arange(5, dtype=torch.float32))
    errs = []

    def run(rank):
        try:
            cm = CheckpointManager(str(tmp_path), async_save=False,
                                   process_index=rank, process_count=2,
                                   barrier=lambda tag: barrier.wait(10),
                                   barrier_timeout_s=10, device="cpu")
            cm.save(1, sc)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errs.append(e)
    ts = [threading.Thread(target=run, args=(r,)) for r in (0, 1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(20)
    assert not errs
    fresh = ptt.Scope()
    assert _cm(tmp_path).restore(scope=fresh) == 1
    _same(fresh.get("w"), torch.arange(5, dtype=torch.float32))


def test_sparse_vars_and_multi_piece_vars_raise(tmp_path):
    """A var stored in several pieces (a sharded run's), which raised
    until the multi-card path was ported, restores whole, or as the piece
    a scope's layout holds.  A sparse table's row group, which raised
    before the sparse tables were ported, now commits in mode ``sparse``
    and comes back as the host array it was."""
    ids = np.array([3, 7, 9], np.int64)
    _cm(tmp_path).save(1, _scope(**{"__sparse__/t/shard0/ids": ids}))
    meta = json.loads((tmp_path / "ckpt-1" / "meta.json").read_text())
    assert meta["vars"]["__sparse__/t/shard0/ids"]["mode"] == "sparse"
    back = ptt.Scope()
    assert _cm(tmp_path).restore(scope=back) == 1
    got = back.get("__sparse__/t/shard0/ids")
    assert isinstance(got, np.ndarray) and got.tobytes() == ids.tobytes()
    cm = _cm(tmp_path)
    cm.save(2, _scope(w=torch.arange(4, dtype=torch.float32)))
    meta_path = tmp_path / "ckpt-2" / "meta.json"
    meta = json.loads(meta_path.read_text())
    sh = meta["vars"]["w"]["shards"][0]
    halves = []
    for k, (lo, hi) in enumerate(((0, 2), (2, 4))):
        fn = f"w.p{k}s0.npy"
        np.save(tmp_path / "ckpt-2" / fn,
                np.arange(lo, hi, dtype=np.float32))
        halves.append(dict(sh, file=fn, index=[[lo, hi]],
                           shard_shape=[hi - lo]))
    meta["vars"]["w"]["shards"] = halves
    meta_path.write_text(json.dumps(meta))
    whole = ptt.Scope()
    assert cm.restore(scope=whole, verify=False) == 2
    _same(whole.get("w"), torch.arange(4, dtype=torch.float32))
    piece = ptt.Scope()
    piece.set("w", torch.zeros(2))
    piece.layouts["w"] = {"shape": [4], "index": [[2, 4]], "writer": True}
    assert cm.restore(scope=piece, verify=False) == 2
    _same(piece.get("w"), torch.tensor([2.0, 3.0]))


# ---------------------------------------------------------------------------
# Across packages
# ---------------------------------------------------------------------------
def test_port_restores_a_jax_checkpoint(tmp_path):
    """The JAX ``CheckpointManager`` commits fp32, bf16, int32 (an int64
    var with x64 off), uint8 and a TrainState; the port restores each
    bit for bit (into an int64 counter, as int64)."""
    import jax.numpy as jnp
    import paddle_tpu as pt
    from paddle_tpu.distributed import CheckpointManager as JaxManager
    from paddle_tpu.train_state import TrainState as JaxTrainState
    r = np.random.RandomState(4)
    w = r.randn(6, 5).astype(np.float32)
    h = r.randn(7).astype(np.float32)
    jts = JaxTrainState(exe_step=12, pass_id=1, batch_id=2, emitted=11,
                        random_seed=3, optimizer={"type": "Momentum"},
                        emergency=True)
    js = pt.core.Scope()
    js.set("w", jnp.asarray(w))
    js.set("h", jnp.asarray(h).astype(jnp.bfloat16))
    js.set("@STEP_COUNTER@", jnp.asarray([9], jnp.int32))
    js.set(TRAIN_STATE_VAR, jts.to_array())
    JaxManager(str(tmp_path), async_save=False).save(5, js)
    dest = _scope(**{"@STEP_COUNTER@": torch.tensor([0], dtype=torch.int64)})
    assert _cm(tmp_path).restore(scope=dest) == 5
    _same(dest.get("w"), torch.from_numpy(w))
    _same(dest.get("h"), torch.from_numpy(h).to(torch.bfloat16))
    _same(dest.get("@STEP_COUNTER@"), torch.tensor([9], dtype=torch.int64))
    ts = TrainState.from_array(dest.get(TRAIN_STATE_VAR))
    assert ts.__dict__ == jts.__dict__


def test_jax_restores_a_port_checkpoint(tmp_path):
    """The port's Checkpointer commits a scope (fp32, bf16, int64,
    float64) and its TrainState, full then delta; the JAX manager
    restores the delta tip: every var bit-equal (the int64 counter as
    int32, x64 off) and the TrainState's fields equal."""
    import paddle_tpu as pt
    from paddle_tpu.distributed import CheckpointManager as JaxManager
    from paddle_tpu.train_state import TrainState as JaxTrainState

    class _Exe:
        _step = 7
        device = "cpu"
    vals = _mixed()
    del vals["flag"], vals["d"]
    ck = Checkpointer(str(tmp_path), _Exe(), handle_signals=False,
                      delta=DeltaPolicy(chunk_bytes=16))
    scope = _scope(**vals)
    ck.begin(scope, None, 3, {"type": "Momentum"})
    ck.emitted = 1
    ck._save(0, 1, blocking=True)
    vals["w"][2, 3] = 42.0                        # one chunk changes
    ck.emitted = 2
    ck._save(0, 2, emergency=True, blocking=True)
    assert ck.saves[-1]["kind"] == "delta"
    js = pt.core.Scope()
    assert JaxManager(str(tmp_path)).restore(scope=js) == 2
    np.testing.assert_array_equal(np.asarray(js.get("w")),
                                  vals["w"].numpy())
    got_h = np.asarray(js.get("h").astype("float32"))
    np.testing.assert_array_equal(got_h, vals["h"].float().numpy())
    np.testing.assert_array_equal(np.asarray(js.get("@STEP_COUNTER@")),
                                  [41])
    np.testing.assert_array_equal(np.asarray(js.get("n")),
                                  vals["n"].numpy())
    jts = JaxTrainState.from_array(np.asarray(js.get(TRAIN_STATE_VAR)))
    want = TrainState(exe_step=7, pass_id=0, batch_id=2, emitted=2,
                      iters_done=0, random_seed=3,
                      optimizer={"type": "Momentum"}, emergency=True)
    assert jts.__dict__ == want.__dict__
