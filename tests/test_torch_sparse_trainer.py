"""Sparse tables in training: the port's ``lookup_table_sparse``, the
rim in ``trainer.SGD.train`` and ``Executor``, against the JAX package
on the same numpy inputs, and against the port's own dense path.

* the op's rows gradient against ``jax.grad``, within 1e-6;
* the CTR program of ``benchmark/ctr.py`` built in JAX, carried by
  ``to_json`` and ``load_numpy_state``: 6 steps through each package's
  session, losses within 1e-5 relative, rows and Adagrad moments within
  1e-5 of the largest entry (the update rounds differently in the two
  packages: tests/test_torch_sparse.py); under AMP, 3 steps within
  the repo's bf16 tolerances;
* dense and sparse training bit-identical in the port (SGD, Adagrad);
* the chunked, pipelined, prefetching and async-push loops bit-identical
  to per-batch when a chunk's batches touch disjoint ids; ``test()``
  read-only; Adam's ``lazy_mode`` against the JAX op within 1e-6; a
  served model pulls cache-first; the runner at ``SMOKE``;
* on a card (``cuda``): the captured step's rows gradient and update
  equal ``use_jit=False``'s.

The JAX side is imported inside the tests that hold the port against
it, so the ``cuda`` test runs on a machine without JAX (``python3 -m
pytest --noconftest -m cuda tests/test_torch_sparse_trainer.py``).
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.sparse import SparseSession, SparseTable

VOCAB, DIM = 48, 6
CPU = ptt.CPUPlace()


def _reset():
    ptt.core.reset_default_programs()
    ptt.core.reset_global_scope()
    ptt.unique_name.reset()


def _build(sparse, opt_name):
    _reset()
    ptt.default_main_program().random_seed = 42
    ptt.default_startup_program().random_seed = 42
    L = ptt.layers
    ids = L.data("ids", shape=[1], dtype="int64")
    label = L.data("label", shape=[1], dtype="float32")
    emb = L.embedding(ids, size=[VOCAB, DIM], sparse=sparse, name="tbl")
    fc = L.fc(emb, size=1, param_attr=ptt.ParamAttr(name="fcw"),
              bias_attr=ptt.ParamAttr(name="fcb"))
    loss = L.mean(L.square(fc - label))
    opt = (ptt.optimizer.SGD(learning_rate=0.1) if opt_name == "sgd"
           else ptt.optimizer.Adagrad(learning_rate=0.1))
    return loss, opt


def _batches(n_batches=6, rows=8, seed=1, id_pool=None):
    rng = np.random.RandomState(seed)
    out = []
    for b in range(n_batches):
        rows_b = []
        for _ in range(rows):
            i = rng.choice(id_pool[b % len(id_pool)]) if id_pool is not None \
                else rng.randint(0, VOCAB)
            rows_b.append((np.array([i], np.int64),
                           rng.rand(1).astype(np.float32)))
        out.append(rows_b)
    return out


def _collect():
    got = []

    def handler(e):
        if isinstance(e, ptt.trainer.events.EndIteration):
            got.append(e.cost)
    return got, handler


def _table(shards=2, **kw):
    kw.setdefault("seed", 5)
    return SparseTable("tbl", VOCAB, DIM, optimizer="adagrad",
                       learning_rate=0.1, num_shards=shards, **kw)


def _run_sparse(batches, num_passes=1, sess_kw=None, table=None,
                **train_kw):
    loss, opt = _build(True, "adagrad")
    table = table or _table()
    sess = SparseSession(table, **(sess_kw or {}))
    tr = ptt.trainer.SGD(loss, update_equation=opt, place=CPU)
    got, handler = _collect()
    tr.train(lambda: iter(batches), num_passes=num_passes,
             event_handler=handler, sparse_tables=sess, **train_kw)
    return got, table, sess, tr


ALL = np.arange(VOCAB, dtype=np.int64)


def test_op_gradient_against_jax_grad():
    import jax
    import jax.numpy as jnp
    from paddle_tpu.core.registry import get_op_impl as j_op
    from paddle_tpu_torch.core.registry import get_op_impl as t_op
    rng = np.random.RandomState(0)
    rows = rng.randn(16, 5).astype(np.float32)
    inv = rng.randint(0, 11, (40,)).astype(np.int32)
    w = rng.randn(40, 5).astype(np.float32)

    def jloss(r):
        out = j_op("lookup_table_sparse")(
            None, {"Rows": [r], "Inverse": [jnp.asarray(inv)],
                   "Ids": [None]}, {})["Out"]
        return jnp.sum(out * w)

    jg = np.asarray(jax.grad(jloss)(jnp.asarray(rows)))
    r = torch.from_numpy(rows).requires_grad_(True)
    out = t_op("lookup_table_sparse")(
        None, {"Rows": [r], "Inverse": [torch.from_numpy(inv)],
               "Ids": [None]}, {})["Out"]
    assert tuple(out.shape) == (40, 5)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(r.grad.numpy(), jg, rtol=0, atol=1e-6)
    assert not r.grad.numpy()[11:].any()      # the bucket's pad rows


CTR = {"batch": 32, "emb_dim": 4, "vocab_big": 5000, "vocab_small": 300,
       "dense_features": 3, "hidden": 8, "zipf_a": 1.2}


def _ctr_program(pkg, cfg):
    """benchmark/ctr.py's model (ctr.py:104-130) in ``pkg``."""
    L = pkg.layers
    pkg.default_main_program().random_seed = 42
    pkg.default_startup_program().random_seed = 42
    ids_big = L.data("ids_big", shape=[1], dtype="int64")
    ids_small = L.data("ids_small", shape=[1], dtype="int64")
    dense = L.data("dense", shape=[cfg["dense_features"]], dtype="float32")
    label = L.data("label", shape=[1], dtype="float32")
    e_big = L.embedding(ids_big, size=[cfg["vocab_big"], cfg["emb_dim"]],
                        name="ctr_big", sparse=True)
    e_small = L.embedding(ids_small, size=[cfg["vocab_small"],
                                           cfg["emb_dim"]],
                          name="ctr_small", sparse=True)
    x = L.concat([e_big, e_small, dense], axis=1)
    x = L.fc(x, size=cfg["hidden"], act="relu")
    pred = L.fc(x, size=1, act="sigmoid")
    loss = L.mean(L.square(pred - label))
    pkg.optimizer.Adagrad(learning_rate=0.05).minimize(loss)
    return loss


def _ctr_tables(cls, cfg):
    kw = dict(optimizer="adagrad", learning_rate=0.05)
    return {"ctr_big": cls("ctr_big", cfg["vocab_big"], cfg["emb_dim"],
                           num_shards=8, seed=1, **kw),
            "ctr_small": cls("ctr_small", cfg["vocab_small"],
                             cfg["emb_dim"], num_shards=4, seed=2, **kw)}


def test_ctr_program_trains_as_in_the_jax_package():
    import paddle_tpu as pt
    from paddle_tpu.sparse import SparseSession as JSession
    from paddle_tpu.sparse import SparseTable as JTable
    from paddle_tpu_torch.benchmark.ctr import feed_stream
    from torch_parity import jax_state, reset_both
    reset_both()
    jloss = _ctr_program(pt, CTR)
    jmain = pt.default_main_program()
    jscope = pt.core.Scope()
    jexe = pt.Executor(pt.CPUPlace())
    jexe.run(pt.default_startup_program(), scope=jscope)
    tmain = ptt.Program.from_json(jmain.to_json())
    tscope = ptt.Scope()
    ptt.load_numpy_state(tscope, jax_state(jscope), "cpu")
    texe = ptt.Executor(CPU)
    jt, tt = _ctr_tables(JTable, CTR), _ctr_tables(SparseTable, CTR)
    js = JSession(jt, bucket_floor=CTR["batch"])
    ts = SparseSession(tt, bucket_floor=CTR["batch"])
    jl, tl = [], []
    for feed in feed_stream(CTR, 6, seed=3):
        jl.append(float(js.run(jexe, jmain, feed, [jloss.name],
                               scope=jscope)[0]))
        tl.append(float(ts.run(texe, tmain, feed, [jloss.name],
                               scope=tscope)[0]))
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    for name in tt:
        ids = np.arange(CTR["vocab_big" if name == "ctr_big"
                            else "vocab_small"], dtype=np.int64)
        live = ids[np.isin(ids, np.concatenate([
            v for k, v in jt[name].export_state_vars().items()
            if k.endswith("/ids")]))]
        assert tt[name].live_rows == jt[name].live_rows == len(live)
        for get in (lambda t: t.pull(live),
                    lambda t: t.pull_slot("moment", live)):
            got, want = get(tt[name]), get(jt[name])
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    for k in ("fc_0.w_0", "fc_1.w_0"):
        want = jscope.numpy(k)
        assert np.abs(tscope.numpy(k) - want).max() <= \
            1e-5 * np.abs(want).max()


def test_amp_rows_gradient_as_in_the_jax_package():
    """Under AMP the rows feed takes the forward's bf16 copy, as in the
    JAX package, and its gradient comes back fp32: 3 steps of the CTR
    program from the same weights and tables, with the repo's bf16
    tolerances (tests/test_torch_seq2seq.py): losses within 2e-2
    relative, the fetched rows gradients within 5e-2 of their largest
    entry."""
    import paddle_tpu as pt
    from paddle_tpu.sparse import SparseSession as JSession
    from paddle_tpu.sparse import SparseTable as JTable
    from paddle_tpu_torch.benchmark.ctr import feed_stream
    from torch_parity import jax_state, reset_both
    reset_both()
    jloss = _ctr_program(pt, CTR)
    jmain = pt.default_main_program()
    jscope = pt.core.Scope()
    jexe = pt.Executor(pt.CPUPlace(), amp=True)
    jexe.run(pt.default_startup_program(), scope=jscope)
    tmain = ptt.Program.from_json(jmain.to_json())
    tscope = ptt.Scope()
    ptt.load_numpy_state(tscope, jax_state(jscope), "cpu")
    texe = ptt.Executor(CPU, amp=True)
    js = JSession(_ctr_tables(JTable, CTR), bucket_floor=CTR["batch"])
    ts = SparseSession(_ctr_tables(SparseTable, CTR),
                       bucket_floor=CTR["batch"])
    js.bind(jmain)
    ts.bind(tmain)
    fetch = [jloss.name] + ts.grad_fetch_list
    for feed in feed_stream(CTR, 3, seed=5):
        jo = jexe.run(jmain, feed=js.prepare_feed(feed), fetch_list=fetch,
                      scope=jscope)
        to = texe.run(tmain, feed=ts.prepare_feed(feed), fetch_list=fetch,
                      scope=tscope)
        np.testing.assert_allclose(to[0], jo[0], rtol=2e-2)
        for j, t in zip(jo[1:], to[1:]):
            j = np.asarray(j, np.float32)
            assert t.dtype == np.float32
            assert np.abs(t - j).max() <= 5e-2 * np.abs(j).max()
        js.complete(jo[1:])
        ts.complete(to[1:])


@pytest.mark.parametrize("opt_name", ["sgd", "adagrad"])
def test_dense_vs_sparse_bit_identical(opt_name):
    """Same seed: the same losses, final rows and Adagrad moments,
    dense table on the executor vs host table (per-batch rim)."""
    batches = _batches()
    loss, opt = _build(False, opt_name)
    tr = ptt.trainer.SGD(loss, update_equation=opt, place=CPU)
    scope = ptt.global_scope()
    d_losses, handler = _collect()
    tr.exe.run(ptt.default_startup_program())
    tr._initialized = True
    w0 = scope.numpy("tbl.w_0").copy()
    fc0 = {k: scope.numpy(k).copy() for k in ("fcw", "fcb")}
    tr.train(lambda: iter(batches), num_passes=2, event_handler=handler)
    w_dense = scope.numpy("tbl.w_0").copy()
    mom = [k for k in scope.keys() if k.startswith("tbl.w_0_moment")]
    mom_dense = scope.numpy(mom[0]).copy() if mom else None

    # the table seeded from the dense init; the fc params pinned to the
    # dense run's (the dense program's extra init op shifts the startup
    # stream)
    loss, opt = _build(True, opt_name)
    table = SparseTable("tbl", VOCAB, DIM, optimizer=opt_name,
                        learning_rate=0.1, num_shards=3,
                        initializer=("dense", w0))
    sess = SparseSession(table)
    tr = ptt.trainer.SGD(loss, update_equation=opt, place=CPU)
    tr.exe.run(ptt.default_startup_program())
    tr._initialized = True
    scope = ptt.global_scope()
    for k, v in fc0.items():
        scope.set(k, torch.from_numpy(v.copy()))
    s_losses, handler = _collect()
    tr.train(lambda: iter(batches), num_passes=2, event_handler=handler,
             sparse_tables=sess)
    assert d_losses == s_losses
    assert table.pull(ALL).tobytes() == w_dense.tobytes()
    if mom_dense is not None:
        assert table.pull_slot("moment", ALL).tobytes() == \
            mom_dense.tobytes()
    assert sess.pending_batches == 0
    assert not np.array_equal(scope.numpy("fcw"), fc0["fcw"])


POOLS = [np.arange(0, 12), np.arange(12, 24), np.arange(24, 36),
         np.arange(36, 48)]
OVERLAP = {"prefetch_depth": 2, "async_push": 2, "push_flush_batch": 2}
PIPE = {"steps_per_dispatch": 2, "prefetch_depth": 1, "num_workers": 0}


@pytest.mark.parametrize("sess_kw,train_kw", [
    ({}, {"steps_per_dispatch": 4}),
    ({}, {"pipeline": PIPE}),
    (OVERLAP, {}),
    (OVERLAP, {"steps_per_dispatch": 4}),
    (OVERLAP, {"pipeline": PIPE}),
], ids=["chunked", "pipelined", "prefetch+async", "prefetch+async-chunked",
        "prefetch+async-pipelined"])
def test_async_loops_match_per_batch_on_disjoint_ids(sess_kw, train_kw):
    """Batches on disjoint ids make the pull-ahead staleness immaterial:
    every loop trains what the synchronous per-batch rim trains."""
    batches = _batches(n_batches=4, id_pool=POOLS)
    ref, t_ref, _, _ = _run_sparse(batches)
    got, table, sess, _ = _run_sparse(batches, sess_kw=sess_kw, **train_kw)
    assert got == ref
    assert table.pull(ALL).tobytes() == t_ref.pull(ALL).tobytes()
    assert table.pull_slot("moment", ALL).tobytes() == \
        t_ref.pull_slot("moment", ALL).tobytes()
    assert sess.stats["pushes"] == len(batches) * 1
    assert sess.pending_batches == 0
    if sess_kw:
        assert sess.stats["prefetch_hits"] + \
            sess.stats["prefetch_misses"] == len(batches)


def test_overlapping_ids_train_with_every_push_applied():
    batches = _batches(n_batches=8)
    for kw in ({"steps_per_dispatch": 4},
               {"pipeline": {"steps_per_dispatch": 2,
                             "prefetch_depth": 2}}):
        got, _, sess, _ = _run_sparse(batches, num_passes=2, **kw)
        assert len(got) == 16 and np.isfinite(got).all()
        assert sess.stats["pushes"] == 16 and sess.pending_batches == 0
        assert got[-1] < got[0]


def test_trainer_test_is_read_only():
    batches = _batches(n_batches=2)
    _, table, sess, tr = _run_sparse(batches)
    before = table.export_state_vars()
    res = tr.test(lambda: iter(batches), sparse_tables=sess)
    assert np.isfinite(res[0]).all()
    after = table.export_state_vars()
    assert all(before[k].tobytes() == after[k].tobytes() for k in before)
    assert sess.pending_batches == 0


def test_trainer_guards():
    loss, opt = _build(True, "sgd")
    sess = SparseSession(SparseTable("tbl", VOCAB, DIM))
    tr = ptt.trainer.SGD(loss, update_equation=opt, place=CPU)
    with pytest.raises(ValueError, match="warmup"):
        tr.train(lambda: iter([]), sparse_tables=sess, warmup=True)
    with pytest.raises(NotImplementedError,
                       match="RemoteSparseTable.*pserver"):
        tr.train(lambda: iter([]), sparse_tables=sess, elastic=object(),
                 checkpoint_dir="/nonexistent")


def test_adam_lazy_mode_against_the_jax_op():
    """Adam with ``lazy_mode``: the rows the batch looked up update,
    the rest keep their values and moments; the port's op on the JAX
    op's operands within 1e-6."""
    import jax.numpy as jnp
    from paddle_tpu.core.registry import get_op_impl as j_op
    from paddle_tpu_torch.core.registry import get_op_impl as t_op
    rng = np.random.RandomState(2)
    V, D = 20, 3
    vals = {"Param": rng.randn(V, D), "Grad": rng.randn(V, D),
            "Moment1": rng.randn(V, D) * 0.1,
            "Moment2": np.abs(rng.randn(V, D)) * 0.1,
            "Beta1Pow": np.array([0.9 ** 3]),
            "Beta2Pow": np.array([0.999 ** 3]),
            "LearningRate": np.array([0.01])}
    vals = {k: v.astype(np.float32) for k, v in vals.items()}
    ids = np.array([[3], [7], [3], [12]], np.int64)
    attrs = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
             "lazy_mode": True}
    jout = j_op("adam")(None, {**{k: [jnp.asarray(v)]
                                  for k, v in vals.items()},
                              "Rows": [jnp.asarray(ids)]}, attrs)
    tout = t_op("adam")(None, {**{k: [torch.from_numpy(v)]
                                  for k, v in vals.items()},
                              "Rows": [torch.from_numpy(ids)]}, attrs)
    untouched = np.setdiff1d(np.arange(V), ids)
    for k in jout:
        got, want = tout[k].numpy(), np.asarray(jout[k])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for k, src in (("ParamOut", "Param"), ("Moment1Out", "Moment1")):
        assert tout[k].numpy()[untouched].tobytes() == \
            vals[src][untouched].tobytes()
    # and the optimizer wires it for a table that only lookups read
    _reset()
    L = ptt.layers
    x = L.data("ids", shape=[1], dtype="int64")
    loss = L.mean(L.embedding(x, size=[V, D]))
    ptt.optimizer.Adam(learning_rate=0.01, lazy_mode=True).minimize(loss)
    adam = [op for op in ptt.default_main_program().global_block().ops
            if op.type == "adam"][0]
    assert adam.attrs["lazy_mode"] and adam.input("Rows") == ["ids"]


def test_serving_model_pulls_cache_first():
    _reset()
    ptt.default_main_program().random_seed = 7
    L = ptt.layers
    ids = L.data("ids", shape=[1], dtype="int64")
    emb = L.embedding(ids, size=[VOCAB, DIM], sparse=True, name="tbl")
    pred = L.fc(emb, size=1, act="sigmoid")
    exe = ptt.Executor(CPU)
    exe.run(ptt.default_startup_program())
    sess = SparseSession(SparseTable("tbl", VOCAB, DIM, seed=3),
                         cache_rows=64)
    infer = ptt.default_main_program().prune([pred]).clone(for_test=True)
    sess.bind(infer)
    from paddle_tpu_torch.serving.model import Model
    m = sess.serving_model(Model.from_program(exe, infer, [pred]))
    assert m.name.endswith("-sparse")
    feeds = {"ids": np.array([[3], [7], [3], [11]], np.int64)}
    out1 = np.asarray(m(feeds)[0])
    assert out1.shape == (4, 1) and np.array_equal(out1[0], out1[2])
    out2 = np.asarray(m(feeds)[0])
    assert np.array_equal(out1, out2)
    cs = sess.cache_stats()
    assert cs["hits"] >= 3 and cs["hit_rate"] > 0
    assert sess.pending_batches == 0


def test_id_bounds_cover_sparse_tables():
    import paddle_tpu as pt
    from paddle_tpu.data_feeder import infer_id_bounds as j_bounds
    from paddle_tpu_torch.data_feeder import infer_id_bounds
    from torch_parity import reset_both
    reset_both()
    _ctr_program(pt, CTR)
    tprog = ptt.Program.from_json(pt.default_main_program().to_json())
    assert infer_id_bounds(tprog) == \
        j_bounds(pt.default_main_program()) == \
        {"ids_big": CTR["vocab_big"], "ids_small": CTR["vocab_small"]}


def test_runner_smoke_on_the_cpu():
    """``benchmark.run --model ctr --smoke --device cpu``: every arm of
    the runner at ``SMOKE`` (the doctor pass recorded as not ported)."""
    from paddle_tpu_torch.benchmark import ctr
    from paddle_tpu_torch.benchmark import run as zoo_run
    assert zoo_run.main(["--model", "ctr", "--smoke", "--device",
                         "cpu"]) == 0
    row = ctr.run_all(smoke=True, place=CPU, quiet=True)
    assert row["doctor"] == {"not_ported": ctr.DOCTOR_NOT_PORTED}
    assert row["device"] == "cpu"
    assert row["vectorization_ab"]["steady"]["arms_bit_identical"]
    assert row["sparse"]["pushed_rows"] > 0
    assert 0 < row["cache"]["hit_rate"] < 1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    yield ptt.CUDAPlace(0)


@pytest.mark.cuda
def test_captured_rows_gradient_equals_use_jit_false(card):
    """The captured step's ``<rows>@GRAD`` fetches, losses and host
    tables equal the interpreted step's, bit for bit."""
    from paddle_tpu_torch.core import compile_cache
    batches = _batches(n_batches=5, seed=4)
    runs = []
    for use_jit in (True, False):
        loss, opt = _build(True, "adagrad")
        opt.minimize(loss)
        table = _table()
        sess = SparseSession(table, bucket_floor=8)
        exe = ptt.Executor(card, use_jit=use_jit)
        exe.run(ptt.default_startup_program())
        main = ptt.default_main_program()
        sess.bind(main)
        grads, losses = [], []
        before = compile_cache.stats().snapshot()
        for b in batches:
            feed = {"ids": np.stack([r[0] for r in b]),
                    "label": np.stack([r[1] for r in b])}
            out = exe.run(main, feed=sess.prepare_feed(feed),
                          fetch_list=[loss.name] + sess.grad_fetch_list)
            losses.append(out[0].tobytes())
            grads.append(out[1].tobytes())
            sess.complete(out[1:])
        after = compile_cache.stats().snapshot()
        runs.append((losses, grads, table.export_state_vars(),
                     after["replays"] - before["replays"]))
    (l1, g1, s1, replays), (l2, g2, s2, _) = runs
    assert replays >= 3
    assert l1 == l2 and g1 == g2
    assert all(s1[k].tobytes() == s2[k].tobytes() for k in s1)
