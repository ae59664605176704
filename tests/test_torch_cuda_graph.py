"""The captured step on the card: ``Executor(use_jit=True)`` replays a
CUDA graph of each step, and its fetches and final scope equal the
interpreted step's (``use_jit=False``) bit for bit, over small programs
that reach the 1x1-conv kernel (a ResNet bottleneck, bf16 and fp32), the
flash-attention kernels (a long-context step), the recurrences (seq2seq)
and the input pipeline (wide_deep through ``run_pipelined``); a scope
entry replaced between replays is seen; a captured training step and a
captured test step on one scope (directly, and through
``trainer.SGD.test`` between passes) each see what the other wrote; the
graph-pool byte bound evicts the least recent key; fetches are fresh
tensors; a dropout program captures, draws what use_jit=False draws and
new masks every step; the capture-safe scalars of ``increment`` and
``sequence_pool(max)`` capture; an LSTM text classifier's step
captures.

Every test needs a CUDA card (``cuda`` marker); none imports JAX, so on
the card they run with ``python3 -m pytest --noconftest -m cuda
tests/test_torch_cuda_graph.py``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import compile_cache
from paddle_tpu_torch.ops import conv1x1, flash_attention


@pytest.fixture
def card():
    """The card, with TF32 off and cuDNN's deterministic algorithms: the
    interpreted fp32 bottleneck step is not bit-repeatable without them
    (cuDNN's fp32 3x3 convolution backward; two interpreted runs of one
    step differed in conv2d_0's and batch_norm_0's updates on an H100),
    so there is nothing bitwise to hold a capture to."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    compile_cache.stats().reset()
    yield torch.device("cuda", 0)
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = saved


def _programs(seed=0):
    ptt.unique_name.reset()
    main, startup = ptt.Program(), ptt.Program()
    startup.random_seed = seed
    return main, startup


def _start(startup):
    scope = ptt.Scope()
    ptt.Executor(use_jit=False).run(startup, scope=scope)
    return scope


def _clone(scope):
    out = ptt.Scope()
    for k in scope.keys():
        out.set(k, scope.get(k).clone())
    return out


def _same_scope(a, b):
    assert sorted(a.keys()) == sorted(b.keys())
    bad = [k for k in a.keys() if not torch.equal(a.get(k), b.get(k))]
    assert not bad, f"scope entries differ: {bad[:8]}"


def _same(xs, ys):
    assert len(xs) == len(ys)
    for x, y in zip(xs, ys):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape and x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def _both_arms(main, start, fetch, feeds, steps=3, **exe_kw):
    """run_steps(steps) then two run()s, captured and interpreted, from
    copies of ``start``: (captured, interpreted) of (fetches, scope,
    launch counts)."""
    arms = []
    for use_jit in (True, False):
        exe = ptt.Executor(use_jit=use_jit, **exe_kw)
        scope = _clone(start)
        conv1x1.reset_counts()
        flash_attention.reset_counts()
        out = list(exe.run_steps(steps, main, feed=feeds, fetch_list=fetch,
                                 scope=scope))
        for _ in range(2):
            out += exe.run(main, feed=feeds, fetch_list=fetch, scope=scope)
        torch.cuda.synchronize()
        arms.append((out, scope, dict(conv1x1.mm.by_form),
                     dict(flash_attention.launches)))
        exe.close()
    return arms


def _bottleneck(amp_seed=0):
    """A ResNet bottleneck at P = 2 x 8 x 8 = 128 pixels and 128/256
    channels, so its 1x1 convs pass the kernel's gate; Momentum."""
    main, startup = _programs(amp_seed)
    L = ptt.layers
    with ptt.program_guard(main, startup):
        img = L.data("img", [128, 8, 8])
        label = L.data("label", [1], dtype="int64")
        a = L.batch_norm(L.conv2d(img, 128, 1, bias_attr=False), act="relu")
        b = L.batch_norm(L.conv2d(a, 128, 3, padding=1, bias_attr=False),
                         act="relu")
        c = L.batch_norm(L.conv2d(b, 256, 1, bias_attr=False))
        short = L.batch_norm(L.conv2d(img, 256, 1, bias_attr=False))
        y = L.elementwise_add(c, short, act="relu")
        pooled = L.pool2d(y, pool_type="avg", global_pooling=True)
        pred = L.fc(pooled, 10, act="softmax")
        loss = L.mean(L.cross_entropy(pred, label))
        ptt.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(
            loss)
    return main, startup, loss


@pytest.mark.cuda
@pytest.mark.parametrize("amp", [True, False])
def test_bottleneck_captured_equals_interpreted(card, amp):
    main, startup, loss = _bottleneck()
    start = _start(startup)
    compile_cache.stats().reset()
    rng = np.random.RandomState(1)
    feeds = {"img": rng.randn(2, 128, 8, 8).astype(np.float32),
             "label": rng.randint(0, 10, (2, 1)).astype(np.int64)}
    cap, ref = _both_arms(main, start, [loss], feeds, amp=amp,
                          conv1x1_pallas=True)
    _same(cap[0], ref[0])
    _same_scope(cap[1], ref[1])
    assert cap[2] == ref[2] and cap[2]["forward"] == 3 * 5
    s = compile_cache.stats().snapshot()
    assert s["captures"] == 1 and s["replays"] == 4 and s["warmups"] == 1
    assert s["uncaptured"] == {"use_jit=False": 5}


def _longctx(T=1024, heads=2):
    main, startup = _programs(3)
    with ptt.program_guard(main, startup):
        helper = ptt.layer_helper.LayerHelper("lc")
        q, k, v = (helper.create_parameter(
            ptt.ParamAttr(name=f"lc_{n}"), shape=[heads, T, 64],
            dtype="float32") for n in "qkv")
        o = ptt.layers.flash_attention(q, k, v, causal=True, block_q=256,
                                       block_k=256)
        loss = ptt.layers.scale(
            ptt.layers.mean(ptt.layers.elementwise_mul(o, o)), 1e-3)
        ptt.optimizer.SGD(learning_rate=1e-2).minimize(loss)
    return main, startup, loss


@pytest.mark.cuda
def test_attention_step_captured_equals_interpreted(card):
    main, startup, loss = _longctx()
    start = _start(startup)
    cap, ref = _both_arms(main, start, [loss], {}, amp=True)
    _same(cap[0], ref[0])
    _same_scope(cap[1], ref[1])
    assert cap[3] == ref[3] == {"fwd": 5, "bwd_dq": 5, "bwd_dkv": 5}


def _seq2seq(vocab=300, dim=32):
    main, startup = _programs(5)
    L = ptt.layers
    with ptt.program_guard(main, startup):
        src = L.data("src", shape=[], dtype="int64", lod_level=1)
        tgt = L.data("tgt", shape=[], dtype="int64", lod_level=1)
        lbl = L.data("lbl", shape=[], dtype="int64", lod_level=1)
        probs = ptt.models.seq2seq_attention(src, tgt, vocab, vocab,
                                             emb_dim=dim, hidden_dim=dim)
        flat = L.reshape(probs, [-1, vocab])
        loss = L.mean(L.cross_entropy(flat, L.reshape(lbl, [-1, 1])))
        ptt.optimizer.Adam(1e-2).minimize(loss)
    return main, startup, loss


@pytest.mark.cuda
@pytest.mark.parametrize("amp", [False, True])
def test_seq2seq_captured_equals_interpreted(card, amp):
    main, startup, loss = _seq2seq()
    start = _start(startup)
    r = np.random.RandomState(2)
    B, T = 4, 6
    feeds = {k: r.randint(0, 300, (B, T)) for k in ("src", "tgt", "lbl")}
    lens = r.randint(1, T + 1, B)
    lens[0] = T
    feeds.update({"src@LEN": lens, "tgt@LEN": lens[::-1].copy(),
                  "lbl@LEN": lens[::-1].copy()})
    cap, ref = _both_arms(main, start, [loss], feeds, amp=amp)
    _same(cap[0], ref[0])
    _same_scope(cap[1], ref[1])


def _wide_deep():
    from paddle_tpu_torch.benchmark import input_pipeline as ip
    cfg = dict(ip.WORKLOADS["wide_deep"]["smoke"])
    ip.fresh_programs()
    main, startup = ptt.default_main_program(), ptt.default_startup_program()
    startup.random_seed = 7
    L = ptt.layers
    sparse = [L.data("s%d" % i, shape=[1], dtype="int64")
              for i in range(ip.NF_SPARSE)]
    dense = L.data("dense", shape=[ip.NF_DENSE], dtype="float32")
    label = L.data("label", shape=[1], dtype="float32")
    pred = ptt.models.wide_deep(sparse, dense, [cfg["vocab"]] * ip.NF_SPARSE,
                                emb_dim=cfg["emb"], deep_hidden=(32, 16))
    cost = L.mean(L.square_error_cost(pred, label))
    ptt.optimizer.SGD(learning_rate=0.05).minimize(cost)
    feeder = ptt.DataFeeder(sparse + [dense, label])
    feeds = [feeder.feed(b) for b in ip.make_reader(cfg)()]
    return main, startup, cost, feeds


@pytest.mark.cuda
def test_wide_deep_pipelined_equals_sequential(card):
    main, startup, cost, feeds = _wide_deep()
    feeds = feeds + feeds[:2]          # 8 feeds: two runs of 3, two singles
    start = _start(startup)
    compile_cache.stats().reset()
    seq_scope, pipe_scope, ref_scope = (_clone(start) for _ in range(3))
    exe = ptt.Executor()
    seq = [exe.run(main, feed=f, fetch_list=[cost], scope=seq_scope)
           for f in feeds]
    pipe = list(ptt.Executor().run_pipelined(
        iter(feeds), main, fetch_list=[cost], scope=pipe_scope,
        steps_per_dispatch=3))
    ref_exe = ptt.Executor(use_jit=False)
    ref = [ref_exe.run(main, feed=f, fetch_list=[cost], scope=ref_scope)
           for f in feeds]
    _same([p[0] for p in pipe], [s[0] for s in seq])
    _same([s[0] for s in seq], [r[0] for r in ref])
    _same_scope(pipe_scope, seq_scope)
    _same_scope(seq_scope, ref_scope)
    assert compile_cache.stats().snapshot()["uncaptured"] == {
        "use_jit=False": len(feeds)}


@pytest.mark.cuda
def test_scope_swap_between_replays_is_seen(card):
    main, startup, cost, feeds = _wide_deep()
    start = _start(startup)
    exe, ref_exe = ptt.Executor(), ptt.Executor(use_jit=False)
    scope, ref_scope = _clone(start), _clone(start)
    for _ in range(3):                 # warm-up, capture, replay
        exe.run(main, feed=feeds[0], fetch_list=[cost], scope=scope)
        ref_exe.run(main, feed=feeds[0], fetch_list=[cost], scope=ref_scope)
    w = next(p.name for p in main.all_parameters()
             if p.name.startswith("fc"))
    new = torch.randn_like(scope.get(w))
    scope.set(w, new.clone())
    ref_scope.set(w, new.clone())
    got = exe.run(main, feed=feeds[1], fetch_list=[cost, w], scope=scope)
    want = ref_exe.run(main, feed=feeds[1], fetch_list=[cost, w],
                       scope=ref_scope)
    _same(got, want)
    # a swap to another scope altogether
    other, ref_other = _clone(start), _clone(start)
    _same(exe.run(main, feed=feeds[2], fetch_list=[cost], scope=other),
          ref_exe.run(main, feed=feeds[2], fetch_list=[cost],
                      scope=ref_other))
    _same_scope(other, ref_other)


@pytest.mark.cuda
def test_captured_train_and_test_steps_share_a_scope(card):
    """Training and evaluation in turns on one scope, both captured: a
    replay writes its state buffers in place and leaves their ``_version``
    as it was, and each step still reads what the other wrote."""
    main, startup, cost, feeds = _wide_deep()
    test_prog = main.prune([cost]).clone(for_test=True)
    start = _start(startup)
    compile_cache.stats().reset()
    arms = []
    for use_jit in (True, False):
        exe, scope, out = ptt.Executor(use_jit=use_jit), _clone(start), []
        for i in range(4):
            out.append(exe.run_steps(2, main, feed=feeds[i],
                                     fetch_list=[cost], scope=scope))
            out.append(exe.run(test_prog, feed=feeds[5], fetch_list=[cost],
                               scope=scope, is_test=True))
        arms.append((out, scope))
    for a, b in zip(arms[0][0], arms[1][0]):
        _same(a, b)
    _same_scope(arms[0][1], arms[1][1])
    tests = [float(np.asarray(o[0])) for o in arms[0][0][1::2]]
    assert len(set(tests)) == 4, tests       # evaluation follows training
    s = compile_cache.stats().snapshot()
    assert s["captures"] == 2 and s["uncaptured"] == {"use_jit=False": 12}


@pytest.mark.cuda
def test_trainer_test_between_passes_sees_the_trained_weights(card):
    """``trainer.SGD.test`` builds its test program anew each call; its
    key repeats, so the second and later evaluations replay the graph
    captured before, which must read the weights trained since."""
    from paddle_tpu_torch.benchmark import input_pipeline as ip
    cfg = dict(ip.WORKLOADS["wide_deep"]["smoke"])
    reader = ip.make_reader(cfg)
    arms = []
    for use_jit in (True, False):
        ip.fresh_programs()
        ptt.default_startup_program().random_seed = 5
        sgd, feed_list = ip.build_wide_deep(cfg)
        sgd.exe = ptt.Executor(use_jit=use_jit)
        evals, costs = [], []

        def handler(e):
            if isinstance(e, ptt.trainer.events.EndIteration):
                costs.append(e.cost)
            elif isinstance(e, ptt.trainer.events.EndPass):
                evals.append(sgd.test(reader, feed_list=feed_list))

        sgd.train(reader, num_passes=4, event_handler=handler,
                  feed_list=feed_list)
        arms.append((evals, costs, {k: ptt.global_scope().numpy(k)
                                    for k in ptt.global_scope().keys()}))
    (evals, costs, state), (revals, rcosts, rstate) = arms
    np.testing.assert_array_equal(np.asarray(costs), np.asarray(rcosts))
    np.testing.assert_array_equal(np.asarray(evals), np.asarray(revals))
    assert len({e[0] for e in evals}) == 4, evals
    assert sorted(state) == sorted(rstate)
    for k in state:
        np.testing.assert_array_equal(state[k], rstate[k], err_msg=k)


@pytest.mark.cuda
def test_graph_byte_bound_evicts_the_least_recent_key(card):
    main, startup, cost, feeds = _wide_deep()
    start = _start(startup)
    compile_cache.stats().reset()
    exe, ref = ptt.Executor(), ptt.Executor(use_jit=False)
    exe._cache.max_bytes = 1                 # every second key evicts
    scope, ref_scope = _clone(start), _clone(start)
    small = {k: np.asarray(v)[:2] for k, v in feeds[0].items()}
    order = [feeds[0]] * 3 + [small] * 2 + [feeds[0]] * 2
    held = []
    for f in order:
        _same(exe.run(main, feed=f, fetch_list=[cost], scope=scope),
              ref.run(main, feed=f, fetch_list=[cost], scope=ref_scope))
        held.append(len(exe._cache))
    # a new key's warm-up holds two keys; its capture evicts the other
    assert held == [1, 1, 1, 2, 1, 2, 1] and exe._cache.nbytes > 1
    _same_scope(scope, ref_scope)
    s = compile_cache.stats().snapshot()
    assert (s["captures"], s["warmups"], s["evictions"]) == (3, 3, 2)


@pytest.mark.cuda
def test_fetches_are_fresh_tensors(card):
    main, startup, cost, feeds = _wide_deep()
    scope = _start(startup)
    exe = ptt.Executor()
    outs = [exe.run(main, feed=feeds[i], fetch_list=[cost], scope=scope,
                    return_numpy=False)[0] for i in range(4)]
    kept = [o.clone() for o in outs]
    exe.run(main, feed=feeds[4], fetch_list=[cost], scope=scope)
    for o, k in zip(outs, kept):
        assert torch.equal(o, k)
    assert len({o.data_ptr() for o in outs}) == len(outs)
    assert compile_cache.stats().snapshot()["replays"] == 4


@pytest.mark.cuda
def test_dropout_program_is_captured_and_matches_use_jit_false(card):
    """A training program with two dropouts (and the uniform_random of
    its startup) captures: run_steps(3) then two run()s replay, their
    fetches (loss and both masks) and final scope bit-equal to
    use_jit=False; each step's masks differ from the other steps' and
    from the other op's."""
    main, startup = _programs(9)
    with ptt.program_guard(main, startup):
        x = ptt.layers.data("x", [256])
        h = ptt.layers.dropout(ptt.layers.fc(x, 256), dropout_prob=0.5)
        h = ptt.layers.dropout(h, dropout_prob=0.5)
        loss = ptt.layers.mean(ptt.layers.fc(h, 1))
        ptt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    masks = [op.output("Mask")[0] for op in main.global_block().ops
             if op.type == "dropout"]
    scope = _start(startup)
    feed = {"x": np.ones((8, 256), np.float32)}
    cap, ref = _both_arms(main, scope, [loss] + masks, feed)
    s = compile_cache.stats().snapshot()
    assert s["captures"] == 1 and s["replays"] == 4
    assert s["uncaptured"] == {"use_jit=False": 6}     # with the startup
    _same(cap[0], ref[0])
    _same_scope(cap[1], ref[1])
    m1 = [np.asarray(cap[0][1])[i] for i in range(3)] + [cap[0][4], cap[0][7]]
    m2 = [np.asarray(cap[0][2])[i] for i in range(3)] + [cap[0][5], cap[0][8]]
    for ms in (m1, m2):
        assert len({m.tobytes() for m in ms}) == 5
        assert all(0.4 < m.mean() < 0.6 for m in ms)
    assert all(not np.array_equal(a, b) for a, b in zip(m1, m2))


@pytest.mark.cuda
def test_run_steps_advances_the_dropout_streams_every_replay(card):
    """run_steps(4) on the captured path draws four different masks, the
    ones four run() calls draw on a second executor from the same start,
    and a second program with another seed draws others."""
    def build(seed):
        main, startup = _programs()
        main.random_seed = seed
        with ptt.program_guard(main, startup):
            x = ptt.layers.data("x", [64])
            h = ptt.layers.dropout(x, dropout_prob=0.5)
            loss = ptt.layers.mean(h)
        mask, = [op.output("Mask")[0] for op in main.global_block().ops
                 if op.type == "dropout"]
        return main, loss, mask

    feed = {"x": np.ones((16, 64), np.float32)}
    main, loss, mask = build(1)
    a = ptt.Executor().run_steps(4, main, feed=feed,
                                 fetch_list=[mask], scope=ptt.Scope())[0]
    exe = ptt.Executor()
    b = [exe.run(main, feed=feed, fetch_list=[mask], scope=ptt.Scope())[0]
         for _ in range(4)]
    assert len({m.tobytes() for m in a}) == 4
    _same(list(a), b)
    other, _, omask = build(2)
    c = ptt.Executor().run_steps(4, other, feed=feed, fetch_list=[omask],
                                 scope=ptt.Scope())[0]
    assert not any(np.array_equal(x, y) for x, y in zip(a, c))


@pytest.mark.cuda
def test_increment_and_sequence_pool_max_capture(card):
    main, startup = _programs(11)
    L = ptt.layers
    with ptt.program_guard(main, startup):
        seq = L.data("seq", shape=[8], dtype="float32", lod_level=1)
        counter = main.global_block().create_var(
            name="counter", shape=[1], dtype="int64", persistable=True)
        L.increment(counter, 1.0, in_place=True)
        pooled = L.sequence_pool(seq, "max")
        total = L.mean(pooled)
    rng = np.random.RandomState(4)
    feed = {"seq": rng.randn(3, 5, 8).astype(np.float32),
            "seq@LEN": np.array([5, 2, 3], np.int32)}
    arms = []
    for use_jit in (True, False):
        scope = ptt.Scope()
        scope.set("counter", torch.zeros(1, dtype=torch.int64,
                                         device="cuda"))
        out = ptt.Executor(use_jit=use_jit).run_steps(
            4, main, feed=feed, fetch_list=[total, pooled], scope=scope)
        arms.append((out, scope.numpy("counter")))
    _same(arms[0][0], arms[1][0])
    assert arms[0][1].tolist() == arms[1][1].tolist() == [4]
    assert compile_cache.stats().snapshot()["captures"] == 1


@pytest.mark.cuda
def test_capture_in_another_thread_than_the_warm_up(card):
    """A server warms a key up on its starting thread and dispatches from
    its own: each thread takes an interpreted warm-up step (PyTorch keeps
    cuDNN and cuBLAS handles per thread) before the capture."""
    import threading
    main, startup, _ = _bottleneck()
    probs = next(op.output_names[0] for op in main.global_block().ops
                 if op.type == "softmax")
    infer = main.prune([probs]).clone(for_test=True)
    start = _start(startup)
    compile_cache.stats().reset()
    feed = {"img": np.random.RandomState(3).randn(2, 128, 8, 8)
            .astype(np.float32)}
    exe = ptt.Executor(amp=True, conv1x1_pallas=True)
    fetch = [probs]
    got = [exe.run(infer, feed=feed, fetch_list=fetch, scope=start,
                   is_test=True)]

    def serve():
        for _ in range(3):
            got.append(exe.run(infer, feed=feed, fetch_list=fetch,
                               scope=start, is_test=True))

    t = threading.Thread(target=serve)
    t.start()
    t.join()
    want = ptt.Executor(amp=True, conv1x1_pallas=True, use_jit=False).run(
        infer, feed=feed, fetch_list=fetch, scope=start, is_test=True)
    for g in got:
        _same(g, want)
    s = compile_cache.stats().snapshot()
    assert (s["warmups"], s["captures"], s["replays"]) == (2, 1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("amp", [False, True])
def test_lstm_textcls_captured_equals_interpreted(card, amp):
    """The LSTM text classifier (2 layers over ragged rows, Adam) captures
    and matches use_jit=False bit for bit."""
    main, startup = _programs(5)
    L = ptt.layers
    with ptt.program_guard(main, startup):
        words = L.data("words", shape=[], dtype="int64", lod_level=1)
        label = L.data("label", [1], dtype="int64")
        pred = ptt.models.lstm_text_classification(
            words, vocab_size=50, emb_dim=16, hidden_size=16, lstm_num=2)
        loss = L.mean(L.cross_entropy(pred, label))
        ptt.optimizer.Adam(2e-3).minimize(loss)
    r = np.random.RandomState(3)
    feed = {"words": r.randint(0, 50, (8, 12)),
            "words@LEN": np.array([12, 1, 5, 12, 7, 3, 9, 2], np.int32),
            "label": r.randint(0, 2, (8, 1))}
    cap, ref = _both_arms(main, _start(startup), [loss], feed, amp=amp)
    _same(cap[0], ref[0])
    _same_scope(cap[1], ref[1])
    assert compile_cache.stats().snapshot()["captures"] == 1
