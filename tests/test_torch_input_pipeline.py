"""The input-pipeline slice of the port against the JAX package, on the
CPU: the ``concat`` op and its gradient, the feeder's staging slots,
``stack_feeds`` and the feed signature, ``Executor.run_pipelined``
against the sequential ``run`` loop (bitwise, across a signature change,
a partial stack and a failing feed source; mirrors
tests/test_input_pipeline.py), ``Program.prune``, the wide_deep program
through JSON, and ``trainer.SGD.train`` (synchronous, chunked and
pipelined) from the JAX weights: per-iteration costs within 1e-5 of the
JAX trainer's and the same event sequence."""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.core.executor import _feed_signature as jax_signature
from paddle_tpu.core.registry import get_op_impl as jax_impl
from paddle_tpu_torch.core.executor import _feed_signature
from paddle_tpu_torch.core.registry import get_op_impl as torch_impl
from paddle_tpu_torch.reader.pipeline import THREAD_NAME_PREFIX
from torch_parity import jax_state, reset_both

CPU = ptt.CPUPlace()
# fp32 on both sides (the JAX tests pin matmul precision to "highest")
COST_TOL = dict(rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# concat
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("axis,shapes", [
    (1, [(4, 3), (4, 1), (4, 5)]),
    (0, [(2, 3, 2), (1, 3, 2)]),
    (2, [(2, 3, 1), (2, 3, 4)]),
    (-1, [(3, 2), (3, 2)])])
def test_concat_op_matches_jax(axis, shapes):
    r = np.random.RandomState(len(shapes) + axis)
    xs = [r.randn(*s).astype(np.float32) for s in shapes]
    jctx = pt.core.LoweringContext(pt.Program(), jax.random.PRNGKey(0))
    want = jax_impl("concat")(jctx, {"X": [jax.numpy.asarray(x)
                                           for x in xs]}, {"axis": axis})
    tctx = ptt.core.ExecContext(ptt.Program(), torch.device("cpu"), 0)
    got = torch_impl("concat")(tctx, {"X": [torch.from_numpy(x)
                                            for x in xs]}, {"axis": axis})
    np.testing.assert_array_equal(got["Out"].numpy(),
                                  np.asarray(want["Out"]))


def _concat_net(pkg):
    pkg.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 3
    with pkg.program_guard(main, startup):
        a = pkg.layers.data("a", [3])
        b = pkg.layers.data("b", [5])
        ha = pkg.layers.fc(a, 4)
        hb = pkg.layers.fc(b, 2, act="relu")
        cat = pkg.layers.concat([ha, hb, a], axis=1)
        loss = pkg.layers.mean(pkg.layers.fc(cat, 1, act="sigmoid"))
        pkg.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return main, startup, loss, cat


def test_concat_gradient_matches_jax():
    reset_both()
    jm, js, _, jcat = _concat_net(pt)
    tm, _, tl, tcat = _concat_net(ptt)
    assert tcat.shape == jcat.shape == (-1, 9)
    jscope = pt.core.Scope()
    pt.Executor(pt.CPUPlace()).run(js, scope=jscope)
    tscope = ptt.load_numpy_state(ptt.Scope(), jax_state(jscope), "cpu")
    r = np.random.RandomState(0)
    feed = {"a": r.randn(6, 3).astype(np.float32),
            "b": r.randn(6, 5).astype(np.float32)}
    params = [p.name for p in tm.all_parameters()]
    fetch = [tl.name, tcat.name] + [p + "@GRAD" for p in params]
    want = pt.Executor(pt.CPUPlace()).run(jm, feed=feed, fetch_list=fetch,
                                          scope=jscope)
    got = ptt.Executor(CPU).run(tm, feed=feed, fetch_list=fetch,
                                scope=tscope)
    for name, g, w in zip(fetch, got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    for p in params:
        np.testing.assert_allclose(tscope.numpy(p), jscope.numpy(p),
                                   rtol=1e-5, atol=1e-6, err_msg=p)


# ---------------------------------------------------------------------------
# the feeder's staging slots, stack_feeds, the feed signature
# ---------------------------------------------------------------------------
def _feeder_vars(pkg):
    pkg.unique_name.reset()
    main = pkg.Program()
    with pkg.program_guard(main, pkg.Program()):
        ids = pkg.layers.data("ids", [1], dtype="int64")
        dense = pkg.layers.data("dense", [4])
        seq = pkg.layers.data("seq", [], dtype="int64", lod_level=1)
        lab = pkg.layers.data("lab", [1])
    return [ids, dense, seq, lab]


def _rows(r, n):
    return [(int(r.randint(0, 9)), r.rand(4).astype(np.float32),
             list(r.randint(0, 50, r.randint(1, 6))), np.float32(r.rand()))
            for _ in range(n)]


@pytest.mark.parametrize("slots", [0, 1, 3])
def test_staging_slots_feed_matches_jax_and_reuses_buffers(slots):
    r = np.random.RandomState(slots)
    batches = [_rows(r, 5) for _ in range(4)]
    jf = pt.DataFeeder(_feeder_vars(pt), staging_slots=slots)
    tf = ptt.DataFeeder(_feeder_vars(ptt), staging_slots=slots)
    outs = []
    for b in batches:
        want, got = jf.feed(b), tf.feed(b)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        outs.append({k: v for k, v in got.items()})
    if slots:
        # slot i + slots reuses slot i's buffer (dense stacks into it)
        assert np.shares_memory(outs[0]["dense"], outs[slots]["dense"])
        assert not np.shares_memory(outs[0]["dense"], outs[1]["dense"]) \
            or slots == 1
    else:
        assert not np.shares_memory(outs[0]["dense"], outs[1]["dense"])


def test_stack_feeds_and_signature_match_jax():
    r = np.random.RandomState(1)
    feeds = [{"x": r.rand(2, 3).astype(np.float32),
              "y": np.array([i], np.int64)} for i in range(4)]
    got, want = ptt.stack_feeds(feeds), pt.core.executor.stack_feeds(feeds)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["x"].shape == (4, 2, 3) and got["y"].shape == (4, 1)
    for f in feeds + [{"x": [[1.0, 2.0]], "z": np.zeros((2,), np.int32)}]:
        assert _feed_signature(f) == jax_signature(f)
    with pytest.raises(ValueError):
        ptt.stack_feeds([])
    with pytest.raises(ValueError, match="keys differ"):
        ptt.stack_feeds([{"x": np.zeros(2)}, {"z": np.zeros(2)}])


# ---------------------------------------------------------------------------
# Executor.run_pipelined against the sequential run loop
# ---------------------------------------------------------------------------
def _cls_net(dropout=True):
    ptt.core.reset_default_programs()
    ptt.core.reset_global_scope()
    ptt.unique_name.reset()
    L = ptt.layers
    x = L.data("x", shape=[8], dtype="float32")
    y = L.data("y", shape=[1], dtype="int64")
    h = L.fc(x, size=16, act="relu")
    if dropout:
        h = L.dropout(h, dropout_prob=0.3)   # the step-keyed draws match
    pred = L.fc(h, size=3, act="softmax")
    loss = L.mean(L.cross_entropy(pred, y))
    ptt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe = ptt.Executor(CPU)
    exe.run(ptt.default_startup_program())
    return exe, loss


def _batches(r, n, batch=16):
    return [{"x": r.rand(batch, 8).astype("float32"),
             "y": r.randint(0, 3, (batch, 1))} for _ in range(n)]


@pytest.mark.parametrize("K,sizes", [
    (4, [16] * 11),                      # 2 full runs + a tail of 3
    (4, [16] * 6 + [10] * 3),            # a partial stack flushed by a
                                         # signature change, then a tail
    (1, [16] * 5),
    (3, [16, 10, 16, 16, 16, 10, 10, 10, 10])])
def test_run_pipelined_matches_sequential_run_bitwise(K, sizes):
    r = np.random.RandomState(7)
    batches = [b for s in sizes for b in _batches(r, 1, batch=s)]
    exe, loss = _cls_net()
    seq = [exe.run(feed=f, fetch_list=[loss])[0] for f in batches]
    seq_state = {k: ptt.global_scope().numpy(k)
                 for k in ptt.global_scope().keys()}
    exe2, loss2 = _cls_net()
    pip = [o[0] for o in exe2.run_pipelined(
        iter(batches), fetch_list=[loss2], steps_per_dispatch=K)]
    assert len(pip) == len(seq)
    for i, (a, b) in enumerate(zip(seq, pip)):
        assert np.array_equal(a, b), f"step {i}: {a} != {b}"
    assert exe2._step == exe._step
    for k, v in seq_state.items():
        np.testing.assert_array_equal(ptt.global_scope().numpy(k), v,
                                      err_msg=k)


def test_run_pipelined_propagates_feed_iter_exception():
    exe, loss = _cls_net(dropout=False)

    def feeds():
        yield from _batches(np.random.RandomState(0), 3)
        raise RuntimeError("source died")

    got = []
    with pytest.raises(RuntimeError, match="source died"):
        for o in exe.run_pipelined(feeds(), fetch_list=[loss],
                                   steps_per_dispatch=2):
            got.append(o)
    assert len(got) == 2           # one full run before the failure


def test_abandoned_run_pipelined_joins_its_staging_thread():
    import threading
    exe, loss = _cls_net(dropout=False)
    r = np.random.RandomState(0)

    def endless():
        while True:
            yield _batches(r, 1)[0]

    gen = exe.run_pipelined(endless(), fetch_list=[loss],
                            steps_per_dispatch=2)
    next(gen)
    gen.close()
    assert not [t for t in threading.enumerate()
                if t.name.startswith(THREAD_NAME_PREFIX) and t.is_alive()]


def test_run_pipelined_rejects_bad_steps_per_dispatch():
    exe, loss = _cls_net(dropout=False)
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        next(iter(exe.run_pipelined(iter([]), fetch_list=[loss],
                                    steps_per_dispatch=0)))


# ---------------------------------------------------------------------------
# Program.prune
# ---------------------------------------------------------------------------
def test_prune_keeps_the_same_ops_as_jax():
    reset_both()
    jm, _, jl, _ = _concat_net(pt)
    tm = _concat_net(ptt)[0]
    for targets in ([jl.name], [jl.name, "fc_0.tmp_1"]):
        want = [op.type for op in jm.prune(targets).global_block().ops]
        got = [op.type for op in tm.prune(targets).global_block().ops]
        assert got == want and "sgd" not in got and "backward" not in got
    assert [op.type for op in tm.global_block().ops][-1] == "sgd"


# ---------------------------------------------------------------------------
# wide_deep and trainer.SGD against the JAX trainer
# ---------------------------------------------------------------------------
def _smoke_cfg():
    from paddle_tpu_torch.benchmark import input_pipeline as tip
    return dict(tip.WORKLOADS["wide_deep"]["smoke"])


def _both_trainers():
    """The wide_deep workload built by each package's trainer in its
    default programs, the JAX startup run and its scope carried into the
    port's global scope; the same batched reader for both."""
    from benchmark import input_pipeline as jip
    from paddle_tpu_torch.benchmark import input_pipeline as tip
    cfg = _smoke_cfg()
    reset_both()
    jsgd, jfl = jip.build_wide_deep(cfg)
    jsgd.exe.run(pt.default_startup_program(), feed={}, fetch_list=[])
    jsgd._initialized = True
    tsgd, tfl = tip.build_wide_deep(cfg, place=CPU)
    ptt.load_numpy_state(ptt.global_scope(), jax_state(pt.global_scope()),
                         "cpu")
    tsgd._initialized = True
    return (jsgd, jfl), (tsgd, tfl), tip.make_reader(cfg)


def test_wide_deep_program_through_json_has_the_same_ops():
    (jsgd, _), (tsgd, _), _ = _both_trainers()
    jm = jsgd.main_program
    loaded = ptt.Program.from_json(jm.to_json())
    want = [op.type for op in jm.global_block().ops]
    assert [op.type for op in loaded.global_block().ops] == want
    assert [op.type for op in tsgd.main_program.global_block().ops] == want
    assert want.count("lookup_table") == 52 and want.count("concat") == 2
    assert all(op.attrs.get("is_sparse") for op in
               tsgd.main_program.global_block().ops
               if op.type == "lookup_table")
    # one step of the JSON-loaded program from the JAX weights
    feed = ptt.DataFeeder([loaded.global_block().var(v.name)
                           for v in tsgd.main_program.global_block()
                           .vars.values() if v.is_data])
    batch = next(iter(_smoke_reader()()))
    fd = feed.feed(batch)
    cost = jsgd.cost.name
    got = ptt.Executor(CPU).run(loaded, feed=fd, fetch_list=[cost],
                                scope=ptt.global_scope())[0]
    want = jsgd.exe.run(jm, feed=fd, fetch_list=[cost])[0]
    np.testing.assert_allclose(got, np.asarray(want), **COST_TOL)


def _smoke_reader():
    from paddle_tpu_torch.benchmark import input_pipeline as tip
    return tip.make_reader(_smoke_cfg())


def _train(sgd, feed_list, reader, **kw):
    events, costs = [], []

    def handler(e):
        events.append((type(e).__name__, e.pass_id,
                       getattr(e, "batch_id", None)))
        if hasattr(e, "cost"):
            costs.append(e.cost)

    sgd.train(reader, num_passes=2, event_handler=handler,
              feed_list=feed_list, **kw)
    return events, costs


@pytest.mark.parametrize("mode", ["sync", "chunked", "pipelined",
                                  "pipelined_no_workers", "validated"])
def test_sgd_train_matches_jax_trainer(mode):
    kw = {"sync": {}, "chunked": {"steps_per_dispatch": 4},
          "pipelined": {"pipeline": {"steps_per_dispatch": 3,
                                     "num_workers": 1}},
          "pipelined_no_workers": {"pipeline": {"steps_per_dispatch": 4,
                                                "num_workers": 0}},
          "validated": {"pipeline": {"steps_per_dispatch": 3,
                                     "num_workers": 1},
                        "validate": True}}[mode]
    (jsgd, jfl), (tsgd, tfl), reader = _both_trainers()
    jev, jcost = _train(jsgd, jfl, reader, **kw)
    tev, tcost = _train(tsgd, tfl, reader, **kw)
    assert tev == jev and len(tcost) == 12
    np.testing.assert_allclose(tcost, jcost, **COST_TOL)
    assert tcost[-1] < tcost[0]
    for k in pt.global_scope().keys():
        if k.endswith(".w_0"):
            np.testing.assert_allclose(ptt.global_scope().numpy(k),
                                       pt.global_scope().numpy(k),
                                       rtol=1e-4, atol=1e-6, err_msg=k)


def test_sgd_test_matches_jax_and_leaves_weights():
    (jsgd, jfl), (tsgd, tfl), reader = _both_trainers()
    before = {k: ptt.global_scope().numpy(k)
              for k in ptt.global_scope().keys()}
    got = tsgd.test(reader, feed_list=tfl)
    want = jsgd.test(reader, feed_list=jfl)
    np.testing.assert_allclose(got, want, **COST_TOL)
    for k, v in before.items():
        np.testing.assert_array_equal(ptt.global_scope().numpy(k), v)


@pytest.mark.parametrize("arg,value", [
    ("warmup", True), ("autotune", True),
    ("auto_shard", {"dp": 2}), ("master", object()),
    ("elastic", object())])
def test_train_refuses_what_is_not_ported(arg, value):
    _, (tsgd, tfl), reader = _both_trainers()
    with pytest.raises(NotImplementedError, match="Queue A item"):
        tsgd.train(reader, feed_list=tfl, **{arg: value})


def test_pipelined_train_with_sparse_tables_matches_jax():
    """``sparse_tables`` on the pipelined loop (refused until the sparse
    tables were ported): a host-table program trained through
    ``pipeline=`` in both packages, each batch on ids of its own (so
    the pulls running ahead of the pushes read the same rows), gives
    the JAX trainer's losses within 1e-5 and every push."""
    from paddle_tpu.sparse import SparseSession as JSession
    from paddle_tpu.sparse import SparseTable as JTable
    from paddle_tpu_torch.sparse import SparseSession, SparseTable

    def build(pkg):
        L = pkg.layers
        pkg.default_startup_program().random_seed = 3
        ids = L.data("ids", shape=[1], dtype="int64")
        y = L.data("y", shape=[1], dtype="float32")
        emb = L.embedding(ids, size=[64, 4], sparse=True, name="tbl")
        loss = L.mean(L.square(L.fc(emb, size=1) - y))
        return loss

    def reader():
        rng = np.random.RandomState(2)
        for b in range(8):
            yield [(np.array([b * 8 + i]), rng.rand(1).astype("float32"))
                   for i in range(8)]

    reset_both()
    jl = build(pt)
    tl = build(ptt)
    jsgd = pt.trainer.SGD(jl, update_equation=pt.optimizer.Adagrad(0.1))
    jsgd.exe.run(pt.default_startup_program(), feed={}, fetch_list=[])
    jsgd._initialized = True
    tsgd = ptt.trainer.SGD(tl, update_equation=ptt.optimizer.Adagrad(0.1),
                           place=CPU)
    ptt.load_numpy_state(ptt.global_scope(), jax_state(pt.global_scope()),
                         "cpu")
    tsgd._initialized = True
    kw = dict(optimizer="adagrad", learning_rate=0.1, seed=4)
    jsess, tsess = JSession(JTable("tbl", 64, 4, **kw)), \
        SparseSession(SparseTable("tbl", 64, 4, **kw))
    pipe = {"steps_per_dispatch": 2, "prefetch_depth": 1, "num_workers": 0}
    costs = {"jax": [], "port": []}
    for key, sgd, sess, ev in (("jax", jsgd, jsess, pt.trainer.events),
                               ("port", tsgd, tsess, ptt.trainer.events)):
        sgd.train(reader, pipeline=pipe, sparse_tables=sess,
                  event_handler=lambda e, c=costs[key], ev=ev: c.append(
                      e.cost) if isinstance(e, ev.EndIteration) else None)
        assert sess.stats["pushes"] == 8 and sess.pending_batches == 0
    np.testing.assert_allclose(costs["port"], costs["jax"], rtol=1e-5)


@pytest.mark.parametrize("arg", ["checkpoint_dir", "resume",
                                 "save_every_n_steps"])
def test_train_takes_the_checkpoint_options(arg, tmp_path):
    """The options the training runtime brought: each trains the pass
    and commits its final checkpoint; without ``checkpoint_dir``,
    ``resume`` and ``save_every_n_steps`` are refused."""
    _, (tsgd, tfl), reader = _both_trainers()
    kw = {"checkpoint_dir": str(tmp_path), "resume": True,
          "save_every_n_steps": 2}
    if arg != "checkpoint_dir":
        with pytest.raises(ValueError, match="checkpoint_dir"):
            tsgd.train(reader, feed_list=tfl, **{arg: kw[arg]})
    kw = {"checkpoint_dir": str(tmp_path), arg: kw[arg]}
    costs = []
    tsgd.train(reader, feed_list=tfl, event_handler=lambda e: costs.append(
        e.cost) if isinstance(e, ptt.trainer.events.EndIteration) else None,
        **kw)
    from paddle_tpu_torch.distributed import CheckpointManager
    assert costs and CheckpointManager(str(tmp_path)).latest_step() == \
        len(costs)
