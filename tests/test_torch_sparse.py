"""The port's host sparse table and its rim against the JAX package's
(``paddle_tpu/sparse/``), on the same numpy inputs.  Both are numpy, so
the Philox rows, the lazy init under any shard count, ``PAD_ID``,
``prepare_feed``'s dedup/inverse/bucket and the checkpoint exports are
held bit for bit, across shard counts and both ``impl``s.  The one
difference is the update's rounding: each package's host update mirrors
its own dense optimizer ops (the JAX table emulates XLA's FMAs, the port
rounds each operation as the port's torch ops do), so the port's push is
held bit for bit against the port's ``sgd``/``adagrad`` ops and within
2 float32 ulps of the largest entry a push of the JAX table's."""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.sparse import SparseSession as JSession
from paddle_tpu.sparse import SparseTable as JTable
from paddle_tpu.sparse.philox import philox_uniform_rows as j_philox
from paddle_tpu_torch.core.registry import get_op_impl
from paddle_tpu_torch.sparse import PAD_ID, SparseSession, SparseTable
from paddle_tpu_torch.sparse.philox import philox_uniform_rows

from torch_parity import reset_both


def _ids(rng, vocab, n):
    return rng.randint(0, vocab, n).astype(np.int64)


@pytest.mark.parametrize("seed,dim", [(0, 1), (1, 6), (7, 16), (2**40, 5)])
def test_philox_rows_are_the_jax_packages(seed, dim):
    rng = np.random.RandomState(seed % 1000)
    ids = np.concatenate([_ids(rng, 10**9, 300),
                          np.array([0, 2**32 + 3, 2**40], np.int64)])
    got = philox_uniform_rows(seed, ids, dim, -0.05, 0.05)
    want = j_philox(seed, ids, dim, -0.05, 0.05)
    assert got.tobytes() == want.tobytes()
    # and numpy's own per-id Generator, the oracle both copy
    for j in (0, 7, len(ids) - 1):
        g = np.random.Generator(np.random.Philox(
            key=(seed << 32) ^ (int(ids[j]) & 0xFFFFFFFF)))
        assert got[j].tobytes() == g.uniform(-0.05, 0.05, dim).tobytes()


@pytest.mark.parametrize("shards", [1, 3, 8])
@pytest.mark.parametrize("impl", ["vectorized", "reference"])
def test_lazy_init_across_shard_counts(shards, impl):
    rng = np.random.RandomState(shards)
    ids = _ids(rng, 5000, 400)
    port = SparseTable("t", 5000, 6, num_shards=shards, seed=3, impl=impl)
    jax_t = JTable("t", 5000, 6, num_shards=1, seed=3)
    # touch order differs: the rows depend on (seed, id) only
    a = port.pull(ids[::-1])[::-1]
    b = jax_t.pull(ids)
    assert a.tobytes() == b.tobytes()
    assert port.live_rows == jax_t.live_rows == len(np.unique(ids))


def test_pad_id_pulls_zero_and_pushes_nothing():
    ids = np.array([5, PAD_ID, 9, PAD_ID], np.int64)
    for t in (SparseTable("t", 16, 4, optimizer="adagrad"),
              JTable("t", 16, 4, optimizer="adagrad")):
        rows = t.pull(ids)
        assert not rows[[1, 3]].any() and rows[[0, 2]].any()
        assert t.push(ids, np.ones((4, 4), np.float32)) == 2
        assert t.live_rows == 2
    with pytest.raises(ValueError, match="duplicates"):
        SparseTable("t", 16, 4).push(np.array([1, 1]),
                                     np.zeros((2, 4), np.float32))
    with pytest.raises(ValueError, match="out-of-vocab"):
        SparseTable("t", 16, 4).pull(np.array([16]))


def _op_update(opt, rows, grads, moment, lr, eps=1e-6):
    """The port's dense optimizer op on the same rows."""
    ins = {"Param": [torch.from_numpy(rows.copy())],
           "Grad": [torch.from_numpy(grads.copy())],
           "LearningRate": [torch.tensor([lr], dtype=torch.float32)]}
    if opt == "sgd":
        return get_op_impl("sgd")(None, ins, {})["ParamOut"].numpy(), None
    ins["Moment"] = [torch.from_numpy(moment.copy())]
    out = get_op_impl("adagrad")(None, ins, {"epsilon": eps})
    return out["ParamOut"].numpy(), out["MomentOut"].numpy()


@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
def test_slot_math(opt):
    """Three pushes: the port's rows and moments equal its dense ops'
    bit for bit, and stay within 2 ulps of the largest entry a push of
    the JAX table's (whose FMAs round once where the port rounds
    twice)."""
    rng = np.random.RandomState(4)
    ids = np.unique(_ids(rng, 200, 60))
    port = SparseTable("t", 200, 8, optimizer=opt, learning_rate=0.05,
                       num_shards=3, seed=9)
    jax_t = JTable("t", 200, 8, optimizer=opt, learning_rate=0.05,
                   num_shards=2, seed=9)
    rows = port.pull(ids)
    assert rows.tobytes() == jax_t.pull(ids).tobytes()
    moment = np.zeros_like(rows)
    pushes = 3
    for _ in range(pushes):
        g = rng.randn(len(ids), 8).astype(np.float32)
        port.push(ids, g)
        jax_t.push(ids, g)
        rows, m = _op_update(opt, rows, g, moment, 0.05)
        assert port.pull(ids).tobytes() == rows.tobytes()
        if opt == "adagrad":
            moment = m
            assert port.pull_slot("moment", ids).tobytes() == m.tobytes()
    for got, want in [(port.pull(ids), jax_t.pull(ids))] + (
            [(port.pull_slot("moment", ids),
              jax_t.pull_slot("moment", ids))] if opt == "adagrad" else []):
        ulp = np.spacing(np.abs(want).max())
        assert np.abs(got - want).max() <= 2 * pushes * ulp
        assert got.tobytes() != want.tobytes()   # the rounding differs


def _trained(cls, shards, impl="vectorized", pushes=2):
    rng = np.random.RandomState(6)
    t = cls("emb", 3000, 5, optimizer="adagrad", learning_rate=0.1,
            num_shards=shards, seed=2, impl=impl)
    for _ in range(pushes):
        ids = np.unique(_ids(rng, 3000, 120))
        t.pull(ids)
        t.push(ids, rng.randn(len(ids), 5).astype(np.float32))
    return t


@pytest.mark.parametrize("src_shards,dst_shards,impl",
                         [(1, 4, "vectorized"), (4, 1, "reference"),
                          (3, 5, "vectorized"), (2, 2, "reference")])
def test_export_restore_crosses_packages_and_shard_counts(
        src_shards, dst_shards, impl):
    """A table exported by one package restores into the other under
    another shard count and impl; both then export the same bytes."""
    for src_cls, dst_cls in ((SparseTable, JTable), (JTable, SparseTable)):
        state = _trained(src_cls, src_shards).export_state_vars()
        dst = dst_cls("emb", 3000, 5, optimizer="adagrad",
                      learning_rate=0.1, num_shards=dst_shards, seed=2,
                      impl=impl)
        dst.restore_state_vars(state)
        same = (SparseTable if dst_cls is JTable else JTable)(
            "emb", 3000, 5, optimizer="adagrad", learning_rate=0.1,
            num_shards=dst_shards, seed=2, impl=impl)
        same.restore_state_vars(state)
        a, b = dst.export_state_vars(), same.export_state_vars()
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].tobytes() == b[k].tobytes(), k
        ids = np.arange(3000, dtype=np.int64)
        assert dst.pull(ids).tobytes() == same.pull(ids).tobytes()


def test_delta_export_protocol():
    """Dirty rows: lazily initialized and pushed rows ride the next
    delta; an acked commit clears them, a retracted one re-marks them;
    the same pulls dirty the same rows in both packages."""
    port, jax_t = SparseTable("d", 100, 3, num_shards=2), \
        JTable("d", 100, 3, num_shards=2)
    for t in (port, jax_t):
        t.pull(np.array([1, 2, 3, 50]))
    tok, delta = port.export_delta()
    jtok, jdelta = jax_t.export_delta()
    assert sorted(delta) == sorted(jdelta)
    for k in delta:
        assert delta[k].tobytes() == jdelta[k].tobytes(), k
    assert port.dirty_rows == 0
    port.retract_delta(tok)
    assert port.dirty_rows == 4
    tok, _ = port.export_delta()
    port.commit_delta(tok)
    port.push(np.array([2]), np.ones((1, 3), np.float32))
    tok, delta = port.export_delta()
    assert delta["__sparse__/d/shard0/ids"].tolist() == [2]
    assert delta["__sparse__/d/shard1/ids"].size == 0


def test_save_load_standalone(tmp_path):
    t = _trained(SparseTable, 3)
    t.save(str(tmp_path / "t"))
    for cls in (SparseTable, JTable):
        back = cls.load(str(tmp_path / "t"), num_shards=2)
        ids = np.arange(3000, dtype=np.int64)
        assert back.pull(ids).tobytes() == t.pull(ids).tobytes()
        assert back.pull_slot("moment", ids).tobytes() == \
            t.pull_slot("moment", ids).tobytes()


def _sparse_program(pkg, vocab=32, dim=4):
    ids = pkg.layers.data("ids", shape=[1], dtype="int64")
    emb = pkg.layers.embedding(ids, size=[vocab, dim], sparse=True,
                               name="tbl")
    return pkg.layers.mean(emb)


def test_prepare_feed_matches_the_jax_session():
    """Dedup, the pow2 bucket padded with PAD_ID rows, the inverse
    index, and the pulled rows, against the JAX session on one feed."""
    reset_both()
    jl = _sparse_program(pt)
    tl = _sparse_program(ptt)
    rng = np.random.RandomState(0)
    feed = {"ids": rng.randint(0, 32, (20, 1)).astype(np.int64)}
    js = JSession(JTable("tbl", 32, 4, seed=5), bucket_floor=8)
    ts = SparseSession(SparseTable("tbl", 32, 4, seed=5), bucket_floor=8)
    js.bind(jl.block.program)
    ts.bind(tl.block.program)
    jf, tf = js.prepare_feed(feed), ts.prepare_feed(feed)
    assert sorted(jf) == sorted(tf) == ["ids", "tbl@RIDX", "tbl@ROWS"]
    n_unique = len(np.unique(feed["ids"]))
    bucket = max(8, 1 << (n_unique - 1).bit_length())
    assert tf["tbl@ROWS"].shape == (bucket, 4)
    assert not tf["tbl@ROWS"][n_unique:].any()
    assert tf["tbl@RIDX"].dtype == np.int32 and \
        tf["tbl@RIDX"].shape == (20,)
    for k in ("tbl@ROWS", "tbl@RIDX"):
        assert jf[k].tobytes() == tf[k].tobytes(), k
    # the inverse index names each id's row
    np.testing.assert_array_equal(
        tf["tbl@ROWS"][tf["tbl@RIDX"]],
        ts.tables["tbl"].pull(feed["ids"].reshape(-1)))
    assert ts.grad_fetch_list == js.grad_fetch_list == ["tbl@ROWS@GRAD"]
    assert ts.pending_batches == 1
    ts.complete([np.zeros((bucket, 4), np.float32)])
    assert ts.pending_batches == 0
    with pytest.raises(ValueError, match="outside the declared vocab"):
        ts.prepare_feed({"ids": np.array([[32]], np.int64)})


def test_program_json_roundtrip_keeps_sparse_wiring():
    """A JAX program with a sparse table loads into the port through its
    JSON form with its session feeds, specs and gradient wiring."""
    from paddle_tpu.sparse import table_specs as j_specs
    from paddle_tpu_torch.sparse import table_specs
    reset_both()
    jl = _sparse_program(pt)
    pt.optimizer.SGD(learning_rate=0.1).minimize(jl)
    prog = ptt.Program.from_json(jl.block.program.to_json())
    gb = prog.global_block()
    assert gb.var("tbl@ROWS").session_feed and \
        gb.var("tbl@RIDX").session_feed
    assert table_specs(prog) == j_specs(jl.block.program)
    bw = [op for op in gb.ops if op.type == "backward"][0]
    assert "tbl@ROWS" in bw.attrs["params"]
    # no optimizer op updates the host rows
    assert not any("tbl@ROWS" in op.input_names for op in gb.ops
                   if op.type == "sgd")
    sess = SparseSession(SparseTable("tbl", 32, 4))
    sess.bind(prog)
    assert sess.grad_fetch_list == ["tbl@ROWS@GRAD"]
    # and the port's own program appends the same backward wrt set
    reset_both()
    tl = _sparse_program(ptt)
    _, pg = ptt.optimizer.SGD(learning_rate=0.1).minimize(tl)
    assert [p.name for p, _ in pg] == ["tbl@ROWS"]
    assert json.loads(tl.block.program.to_json()) is not None


def test_embedding_sparse_refusals():
    reset_both()
    ids = ptt.layers.data("ids", shape=[1], dtype="int64")
    with pytest.raises(ValueError, match="padding_idx"):
        ptt.layers.embedding(ids, size=[8, 2], sparse=True, padding_idx=0)
    ptt.layers.embedding(ids, size=[8, 2], sparse=True, name="a")
    with pytest.raises(ValueError, match="already exists"):
        ptt.layers.embedding(ids, size=[8, 2], sparse=True, name="a")


def test_hot_row_cache_never_serves_a_stale_row():
    reset_both()
    tl = _sparse_program(ptt, vocab=16)
    table = SparseTable("tbl", 16, 4, learning_rate=1.0)
    sess = SparseSession(table, cache_rows=8)
    sess.bind(tl.block.program)
    feed = {"ids": np.array([[1], [2]], np.int64)}
    a = sess.prepare_feed(feed, is_test=True)["tbl@ROWS"]
    b = sess.prepare_feed(feed, is_test=True)["tbl@ROWS"]
    assert a.tobytes() == b.tobytes()
    assert sess.cache_stats()["hits"] == 2
    sess.prepare_feed(feed)
    sess.complete([np.ones((8, 4), np.float32)])
    c = sess.prepare_feed(feed, is_test=True)["tbl@ROWS"]
    np.testing.assert_array_equal(c[:2], a[:2] - 1.0)


def test_mmap_storage_matches_memory(tmp_path):
    """The mmap arenas (beyond-RAM vocabs) hold what the memory ones
    hold, through growth and a restore."""
    mem = _trained(SparseTable, 3)
    rng = np.random.RandomState(6)
    mm = SparseTable("emb", 3000, 5, optimizer="adagrad", learning_rate=0.1,
                     num_shards=3, seed=2, storage="mmap",
                     storage_dir=str(tmp_path))
    for _ in range(2):
        ids = np.unique(_ids(rng, 3000, 120))
        mm.pull(ids)
        mm.push(ids, rng.randn(len(ids), 5).astype(np.float32))
    a, b = mem.export_state_vars(), mm.export_state_vars()
    assert all(a[k].tobytes() == b[k].tobytes() for k in a)
    back = SparseTable("emb", 3000, 5, optimizer="adagrad",
                       learning_rate=0.1, num_shards=2, seed=2,
                       storage="mmap", storage_dir=str(tmp_path / "r"))
    back.restore_state_vars(b)
    ids = np.arange(3000, dtype=np.int64)
    assert back.pull(ids).tobytes() == mem.pull(ids).tobytes()
