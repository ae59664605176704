"""Compile ahead of the first call on the CPU (paddle_tpu_torch
``Executor.compile``, ``compile_cache.CompiledProgram``/``CachedStep``,
the disk layer, ``trainer.SGD.train(warmup=True)``,
``serving.Model.from_compiled``, the flash-attention forward's custom op
in an exported graph, ``benchmark.compile_cache``), mirroring
tests/test_compile_cache.py: the same programs and seeded inputs go
through the JAX package's compile-then-run and the port's, with the JAX
weights carried across (``weights.load_numpy_state``).

Tolerances: fp32 on both sides, another summation order (XLA against
torch's CPU kernels): 1e-5 relative and absolute, per fetch.  Within the
port, a compiled run and an uncompiled one are held bit for bit.  The
tests that need a card are in tests/test_torch_compile_card.py."""
import logging
import os

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch import flags
from paddle_tpu_torch.core import compile_cache
from paddle_tpu_torch.core.executor import stack_feeds
from paddle_tpu_torch.ops import flash_attention as fa
from torch_parity import both_train, jax_state, reset_both

CPU = ptt.CPUPlace()
TOL = dict(rtol=1e-5, atol=1e-5)
STEPS = 3


def _mlp(pkg, seed=4, dropout=0.0):
    """fc 16 relu (dropout) -> fc 4 softmax, mean cross entropy, SGD, in
    fresh programs of ``pkg``: (main, startup, loss)."""
    pkg.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = seed
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[8], dtype="float32")
        y = pkg.layers.data("y", shape=[1], dtype="int64")
        h = pkg.layers.fc(x, size=16, act="relu")
        if dropout:
            h = pkg.layers.dropout(h, dropout_prob=dropout)
        pred = pkg.layers.fc(h, size=4, act="softmax")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, y))
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _mlp_feed(rng, batch=4):
    return {"x": rng.rand(batch, 8).astype("float32"),
            "y": rng.randint(0, 4, (batch, 1)).astype("int64")}


def _both(model):
    """{"jax": (main, loss, scope), "torch": (...)} of a small MLP or a
    narrow CIFAR ResNet (depth 8), JAX weights carried into the port, and
    the seeded feed."""
    rng = np.random.RandomState(11)
    if model == "mlp":
        reset_both()
        jm, js, jl = _mlp(pt)
        tm, _, tl = _mlp(ptt)
        jscope = pt.core.Scope()
        pt.Executor(pt.CPUPlace()).run(js, scope=jscope)
        tscope = ptt.load_numpy_state(ptt.Scope(), jax_state(jscope), "cpu")
        arms = {"jax": (jm, jl, jscope), "torch": (tm, tl, tscope)}
        return arms, _mlp_feed(rng)
    reset_both()
    arms = both_train("resnet_cifar", [3, 8, 8], depth=8, num_classes=4)
    feed = {"img": rng.rand(2, 3, 8, 8).astype("float32"),
            "label": rng.randint(0, 4, (2, 1)).astype("int64")}
    return arms, feed


def _clone(scope):
    out = ptt.Scope()
    for k in scope.keys():
        out.set(k, scope.get(k).clone())
    return out


def _same_scope(a, b):
    assert sorted(a.keys()) == sorted(b.keys())
    bad = [k for k in a.keys() if not torch.equal(a.get(k), b.get(k))]
    assert not bad, f"scope entries differ: {bad[:8]}"


@pytest.fixture
def cache_dir(tmp_path):
    """The port's cache_dir flag on a temporary directory, and fresh
    counters."""
    prev = flags.get_flag("cache_dir")
    flags.set_flag("cache_dir", str(tmp_path))
    compile_cache.stats().reset()
    yield tmp_path
    flags.set_flag("cache_dir", prev)


# ---------------------------------------------------------------------------
# compile-then-run against the JAX package's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model", ["mlp", "resnet"])
def test_compile_then_run_equals_the_jax_compile_then_run(model):
    arms, feed = _both(model)
    jm, jl, jscope = arms["jax"]
    tm, tl, tscope = arms["torch"]
    jexe = pt.Executor(pt.CPUPlace())
    jcp = jexe.compile(jm, feed=feed, fetch_list=[jl], scope=jscope)
    texe = ptt.Executor(CPU)
    tcp = texe.compile(tm, feed=feed, fetch_list=[tl], scope=tscope)
    assert tcp.fetch_names == jcp.fetch_names == [tl.name]
    assert set(tcp.compile_times) == {"validate_s"}
    for _ in range(STEPS):
        want, = jcp.run(feed=feed, scope=jscope)
        got, = tcp.run(feed=feed, scope=tscope)
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
    for name in tscope.keys():
        np.testing.assert_allclose(tscope.numpy(name), jscope.numpy(name),
                                   err_msg=name, **TOL)


def test_compiled_run_steps_equal_the_jax_stacked_compile():
    arms, _ = _both("mlp")
    jm, jl, jscope = arms["jax"]
    tm, tl, tscope = arms["torch"]
    rng = np.random.RandomState(5)
    stacked = stack_feeds([_mlp_feed(rng) for _ in range(STEPS)])
    jcp = pt.Executor(pt.CPUPlace()).compile(
        jm, feed=stacked, fetch_list=[jl], scope=jscope, num_steps=STEPS,
        feeds_stacked=True)
    tcp = ptt.Executor(CPU).compile(
        tm, feed=stacked, fetch_list=[tl], scope=tscope, num_steps=STEPS,
        feeds_stacked=True)
    assert tcp.num_steps == STEPS and tcp.feeds_stacked
    want, = jcp.run(feed=stacked, scope=jscope)
    got, = tcp.run(feed=stacked, scope=tscope)
    assert got.shape == (STEPS,)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the key: specs reach the key a concrete run takes
# ---------------------------------------------------------------------------
def _run_key(exe, main, feed, loss, scope):
    gb = main.global_block()
    feeds = {k: exe._feed_tensor(gb, k, v) for k, v in feed.items()}
    return compile_cache.fingerprint_hex(
        exe._fingerprint(main, feeds, [loss.name], scope, False))


@pytest.mark.parametrize("form", ["tuple", "meta", "example"])
@pytest.mark.parametrize("stacked", [False, True],
                         ids=["single", "stacked"])
def test_spec_feeds_reach_the_key_a_run_takes(form, stacked):
    reset_both()
    main, startup, loss = _mlp(ptt)
    scope = ptt.Scope()
    exe = ptt.Executor(CPU)
    exe.run(startup, scope=scope)
    feed = _mlp_feed(np.random.RandomState(2))
    want = _run_key(exe, main, feed, loss, scope)
    lead = (STEPS,) if stacked else ()
    if form == "tuple":
        # int32 ids: the declared int64 var dtype overrides, as run coerces
        spec = {"x": (lead + (4, 8), "float32"),
                "y": (list(lead + (4, 1)), "int32")}
    elif form == "meta":
        spec = {"x": torch.empty(lead + (4, 8), device="meta"),
                "y": torch.empty(lead + (4, 1), dtype=torch.int64,
                                 device="meta")}
    else:
        spec = stack_feeds([feed] * STEPS) if stacked else feed
    kw = dict(num_steps=STEPS, feeds_stacked=True) if stacked else {}
    cp = exe.compile(main, feed=spec, fetch_list=[loss], scope=scope, **kw)
    assert cp.fingerprint == want
    # num_steps without stacking keys the same single step
    cp2 = exe.compile(main, feed=feed, fetch_list=[loss], scope=scope,
                      num_steps=STEPS)
    assert cp2.fingerprint == want and cp2.step is cp.step


def test_a_spec_of_lengths_is_refused_and_an_example_is_taken():
    reset_both()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        w = ptt.layers.data("w", shape=[], dtype="int64", lod_level=1)
        emb = ptt.layers.embedding(w, size=[50, 8])
        pooled = ptt.layers.sequence_pool(emb, "sum")
        out = ptt.layers.mean(pooled)
    scope = ptt.Scope()
    exe = ptt.Executor(CPU)
    exe.run(startup, scope=scope)
    with pytest.raises(ValueError, match="w@LEN.*steer"):
        exe.compile(main, feed={"w": ((2, 5), "int64"),
                                "w@LEN": ((2,), "int32")},
                    fetch_list=[out], scope=scope)
    lens = np.array([5, 3], np.int32)
    cp = exe.compile(main, feed={"w": ((2, 5), "int64"), "w@LEN": lens},
                     fetch_list=[out], scope=scope)
    ids = np.random.RandomState(0).randint(0, 50, (2, 5))
    got, = cp.run(feed={"w": ids, "w@LEN": lens}, scope=scope)
    want, = ptt.Executor(CPU).run(main, feed={"w": ids, "w@LEN": lens},
                                  fetch_list=[out], scope=scope)
    assert got.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# compile takes no step and writes nothing
# ---------------------------------------------------------------------------
def test_compile_leaves_the_scope_and_the_step_counter_bit_equal():
    """Compile changes neither the scope nor the step counter, and a
    compiled-then-run sequence of a dropout program equals the same run
    without compile bit for bit (fetches and final scope)."""
    reset_both()
    main, startup, loss = _mlp(ptt, dropout=0.5)
    start = ptt.Scope()
    ptt.Executor(CPU).run(startup, scope=start)
    feed = _mlp_feed(np.random.RandomState(3))
    arms = []
    for compiled in (False, True):
        scope = _clone(start)
        exe = ptt.Executor(CPU)
        if compiled:
            before = _clone(scope)
            cp = exe.compile(main, feed=feed, fetch_list=[loss],
                             scope=scope)
            _same_scope(scope, before)
            assert exe._step == 0
            assert cp.step.source == "compile"
        out = [exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
               for _ in range(STEPS)]
        out += list(exe.run_steps(2, main, feed=feed, fetch_list=[loss],
                                  scope=scope)[0])
        arms.append((np.asarray(out), scope, exe._step))
    (a, sa, na), (b, sb, nb) = arms
    assert a.tobytes() == b.tobytes() and na == nb == STEPS + 2
    assert len(set(a.tolist())) == len(a)        # new masks every step
    _same_scope(sa, sb)


@pytest.mark.parametrize("case", ["use_jit", "stacked_without_steps",
                                  "nan_inf_steps", "lead_dim"])
def test_compile_refusals(case):
    reset_both()
    main, startup, loss = _mlp(ptt)
    scope = ptt.Scope()
    ptt.Executor(CPU).run(startup, scope=scope)
    feed = _mlp_feed(np.random.RandomState(0))
    exe_kw, kw, match = {}, {}, None
    if case == "use_jit":
        exe_kw, match = {"use_jit": False}, "use_jit=True"
    elif case == "stacked_without_steps":
        kw, match = {"feeds_stacked": True}, "requires num_steps"
    elif case == "nan_inf_steps":
        exe_kw, kw = {"check_nan_inf": True}, {"num_steps": 2}
        match = "check_nan_inf"
    else:
        kw = {"num_steps": 3, "feeds_stacked": True}
        feed = stack_feeds([feed] * 2)
        match = "leading dim 3"
    exe = ptt.Executor(CPU, **exe_kw)
    with pytest.raises(ValueError, match=match):
        exe.compile(main, feed=feed, fetch_list=[loss], scope=scope, **kw)


def test_the_step_listing_names_each_op_with_its_route():
    reset_both()
    main, startup, loss = _mlp(ptt)
    scope = ptt.Scope()
    exe = ptt.Executor(CPU)
    exe.run(startup, scope=scope)
    cp = exe.compile(main, feed=_mlp_feed(np.random.RandomState(0)),
                     fetch_list=[loss], scope=scope)
    listing = cp.step.listing
    ops = main.global_block().ops
    assert [r["op"] for r in listing] == [op.type for op in ops]
    assert [r["index"] for r in listing] == list(range(len(ops)))
    # the CPU: no op moved a kernel's launch counter
    assert {r["route"] for r in listing} == {"other"}
    assert all(not r["launches"] for r in listing)
    text = cp.stablehlo()
    assert len(text.splitlines()) == len(ops) and "backward" in text
    assert cp.step.facts["launches"] == {} and \
        cp.step.facts["pool_bytes"] == 0
    from paddle_tpu_torch.observability import attribution
    assert attribution.executable_facts(cp) is None      # nothing captured


def test_the_compiled_check_raises_where_a_card_compile_fails(monkeypatch):
    """On a card a failed compile or capture of ``profile
    --compiled-check`` raises, and is not reported as the CPU's None.  The
    executor here stands on a card by its device and builds its
    throwaway executor on the CPU; its compile raises."""
    from types import SimpleNamespace

    from paddle_tpu_torch.observability import opprof
    reset_both()
    main, startup, loss = _mlp(ptt)
    scope = ptt.Scope()
    ptt.Executor(CPU).run(startup, scope=scope)
    closed = []

    def fail(self, *a, **k):
        raise RuntimeError("capture failed")
    monkeypatch.setattr(ptt.Executor, "compile", fail)
    monkeypatch.setattr(ptt.Executor, "close",
                        lambda self: closed.append(self))
    card = SimpleNamespace(device=torch.device("cuda", 0), place=CPU,
                           amp=False, compute_dtype=None,
                           conv1x1_pallas=False)
    state = {k: scope.get(k) for k in scope.keys()}
    feeds = {k: torch.from_numpy(v)
             for k, v in _mlp_feed(np.random.RandomState(0)).items()}
    with pytest.raises(RuntimeError, match="capture failed"):
        opprof._compiled_facts(card, main, feeds, state, False)
    assert len(closed) == 1                  # the throwaway executor
    cpu = SimpleNamespace(device=torch.device("cpu"))
    assert opprof._compiled_facts(cpu, main, feeds, state, False) is None


# ---------------------------------------------------------------------------
# trainer warmup and the served compiled bucket
# ---------------------------------------------------------------------------
def _rows(n=32, seed=7):
    rng = np.random.RandomState(seed)
    return [(rng.rand(8).astype("float32"), int(rng.randint(4)))
            for _ in range(n)]


def _train(pkg, warmup, steps_per_dispatch, rows, init=None):
    """trainer.SGD over the MLP in ``pkg``'s default programs, the JAX
    startup's weights (``init`` in the port) in both: the per-batch
    losses, the trainer and the initial weights."""
    L = pkg.layers
    x = L.data("x", shape=[8], dtype="float32")
    y = L.data("y", shape=[1], dtype="int64")
    pred = L.fc(L.fc(x, size=16, act="relu"), size=4, act="softmax")
    loss = L.mean(L.cross_entropy(pred, y))
    kw = {} if pkg is pt else {"place": CPU}
    tr = pkg.trainer.SGD(loss, update_equation=pkg.optimizer.SGD(0.1), **kw)
    if pkg is pt:
        pkg.default_startup_program().random_seed = 9
        tr.exe.run(pkg.default_startup_program(), feed={}, fetch_list=[])
        init = jax_state(pt.global_scope())
    else:
        ptt.load_numpy_state(ptt.global_scope(), init, "cpu")
    tr._initialized = True
    out = []

    def reader():
        for i in range(0, len(rows), 8):
            yield rows[i:i + 8]

    def handler(e):
        if isinstance(e, pkg.trainer.events.EndIteration):
            out.append(float(e.cost))
    tr.train(reader, num_passes=1, event_handler=handler, feed_list=[x, y],
             warmup=warmup, steps_per_dispatch=steps_per_dispatch)
    return out, tr, init


@pytest.mark.parametrize("k", [1, 2])
def test_trainer_warmup_equals_no_warmup_and_the_jax_run(k):
    rows = _rows()
    reset_both()
    want, _, init = _train(pt, True, k, rows)
    got = {}
    for warmup in (False, True):
        ptt.core.reset_default_programs()
        ptt.core.reset_global_scope()
        ptt.unique_name.reset()
        got[warmup], tr, _ = _train(ptt, warmup, k, rows, init)
    assert got[True] == got[False] and len(got[True]) == 4
    assert tr.exe._step == 4            # the compile took no step
    np.testing.assert_allclose(got[True], want, **TOL)


def test_model_from_compiled_rows_equal_from_program():
    from paddle_tpu_torch.serving import Model, Server
    reset_both()
    main, startup, _ = _mlp(ptt)
    pred = main.global_block().var(
        [op for op in main.global_block().ops
         if op.type == "softmax"][0].outputs["Out"][0])
    infer = main.prune([pred]).clone(for_test=True)
    scope = ptt.Scope()
    exe = ptt.Executor(CPU)
    exe.run(startup, scope=scope)
    cp = exe.compile(infer, feed={"x": ((4, 8), "float32")},
                     fetch_list=[pred], scope=scope, is_test=True)
    m = Model.from_compiled(cp, name="c", scope=scope)
    ref = Model.from_program(exe, infer, [pred], scope=scope, name="p")
    assert m.output_names == [pred.name]
    feeds = {"x": np.random.RandomState(1).rand(4, 8).astype("float32")}
    got, = m(feeds)
    want, = ref(feeds)
    assert torch.equal(got, want)
    srv = Server(max_batch=4, max_wait_ms=1.0, deadline_ms=None,
                 warmup=False)
    srv.add_model(m)
    srv.start()
    try:
        row = srv.infer({"x": feeds["x"][0]}, model="c", timeout=30.0)
    finally:
        srv.shutdown()
    # one request rides the batch-1 bucket: the owning executor's own key
    one, = ref({"x": feeds["x"][:1]})
    np.testing.assert_array_equal(np.asarray(row[0]), one[0].numpy())


# ---------------------------------------------------------------------------
# the disk layer
# ---------------------------------------------------------------------------
def test_disk_round_trip_in_process(cache_dir):
    """A cold compile stores its entry; with the in-memory cache cleared
    the next compile of the key starts from the disk (one hit), and the
    fetches are bit-identical."""
    reset_both()
    main, startup, loss = _mlp(ptt)
    start = ptt.Scope()
    ptt.Executor(CPU).run(startup, scope=start)
    feed = _mlp_feed(np.random.RandomState(4))
    outs = []
    for i in range(2):
        exe = ptt.Executor(CPU)
        scope = _clone(start)
        cp = exe.compile(main, feed=feed, fetch_list=[loss], scope=scope)
        outs.append((cp, exe.run(main, feed=feed, fetch_list=[loss],
                                 scope=scope)[0]))
        exe.close()
    s = compile_cache.stats().snapshot()
    assert (s["disk_stores"], s["disk_hits"], s["disk_misses"]) == (1, 1, 1)
    names = [p.name for p in cache_dir.iterdir()]
    assert names == [f"ptxc-{outs[0][0].fingerprint}.pkl"]
    (cold, v1), (warm, v2) = outs
    assert cold.step.source == "compile" and warm.step.source == "disk"
    assert warm.step.facts["cold_times"] == cold.compile_times
    assert warm.step.listing == cold.step.listing
    assert v1.tobytes() == v2.tobytes()
    stats = compile_cache.stats()
    assert stats.entries[warm.fingerprint]["source"] == "disk"
    assert "disk_hits: 1" in stats.report()


def test_corrupt_entry_is_a_miss_logged_once_and_recomputed(cache_dir,
                                                           caplog):
    reset_both()
    main, startup, loss = _mlp(ptt)
    scope = ptt.Scope()
    ptt.Executor(CPU).run(startup, scope=scope)
    feed = _mlp_feed(np.random.RandomState(4))
    cp = ptt.Executor(CPU).compile(main, feed=feed, fetch_list=[loss],
                                   scope=scope)
    path = cache_dir / f"ptxc-{cp.fingerprint}.pkl"
    path.write_bytes(b"corrupt")
    compile_cache.stats().reset()
    with caplog.at_level(logging.WARNING, logger="paddle_tpu_torch"):
        cp2 = ptt.Executor(CPU).compile(main, feed=feed, fetch_list=[loss],
                                        scope=scope)
    warned = [r for r in caplog.records if "unreadable entry" in r.message]
    assert len(warned) == 1
    s = compile_cache.stats().snapshot()
    assert (s["disk_misses"], s["disk_hits"], s["disk_stores"]) == (1, 0, 1)
    assert cp2.step.source == "compile"
    assert compile_cache.disk_load(cp.fingerprint)["listing"] == \
        cp2.step.listing
    got, = cp2.run(feed=feed, scope=scope)
    assert np.isfinite(got)
    # a foreign fingerprint inside a valid file is a miss too
    os.replace(path, cache_dir / "ptxc-other.pkl")
    assert compile_cache.disk_load("other") is None


def test_no_cache_dir_no_disk():
    flags_prev = flags.get_flag("cache_dir")
    flags.set_flag("cache_dir", "")
    try:
        compile_cache.stats().reset()
        reset_both()
        main, startup, loss = _mlp(ptt)
        scope = ptt.Scope()
        exe = ptt.Executor(CPU)
        exe.run(startup, scope=scope)
        exe.compile(main, feed=_mlp_feed(np.random.RandomState(0)),
                    fetch_list=[loss], scope=scope)
        s = compile_cache.stats().snapshot()
        assert s["disk_hits"] == s["disk_misses"] == s["disk_stores"] == 0
    finally:
        flags.set_flag("cache_dir", flags_prev)


# ---------------------------------------------------------------------------
# flash attention in an exported graph
# ---------------------------------------------------------------------------
FA_T, FA_D = 256, 16


def _flash_program(pkg):
    """x [B, T, D] -> flash_attention(x * w, x, 2x), causal, 64-row
    blocks (the JAX op in Pallas interpret mode): (main, startup, out)."""
    pkg.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 3
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[FA_T, FA_D], dtype="float32")
        helper = pkg.layer_helper.LayerHelper("fa")
        w = helper.create_parameter(pkg.ParamAttr(name="fa_w"),
                                    shape=[FA_T, FA_D], dtype="float32")
        q = pkg.layers.elementwise_mul(x, w)
        v = pkg.layers.scale(x, 2.0)
        out = pkg.layers.flash_attention(q, x, v, causal=True, block_q=64,
                                         block_k=64, interpret=True)
    return main, startup, out


def test_flash_attention_artifact_equals_the_jax_artifact(tmp_path):
    reset_both()
    jm, js, jo = _flash_program(pt)
    tm, _, to = _flash_program(ptt)
    jscope = pt.core.Scope()
    pt.Executor(pt.CPUPlace()).run(js, scope=jscope)
    tscope = ptt.load_numpy_state(ptt.Scope(), jax_state(jscope), "cpu")
    xv = np.random.RandomState(0).randn(2, FA_T, FA_D).astype("float32")
    spec = {"x": ((2, FA_T, FA_D), "float32")}
    with pt.core.scope_guard(jscope):
        pt.export_model.export_compiled_model(
            str(tmp_path / "jax"), spec, [jo], main_program=jm,
            scope=jscope)
    jrun, _ = pt.export_model.load_compiled_model(str(tmp_path / "jax"))
    want = np.asarray(jrun({"x": xv})[0])
    manifest = ptt.export_compiled_model(
        str(tmp_path / "torch"), spec, [to], main_program=tm, scope=tscope,
        device="cpu")
    assert manifest["custom_ops"] == {
        "paddle_tpu_torch::flash_attention_fwd": 1}
    run, _ = ptt.load_compiled_model(str(tmp_path / "torch"), device="cpu")
    got = run({"x": xv})[0].numpy()
    np.testing.assert_allclose(got, want, **TOL)
    live, = ptt.Executor(CPU).run(tm.clone(for_test=True), feed={"x": xv},
                                  fetch_list=[to], scope=tscope,
                                  is_test=True)
    assert got.tobytes() == live.tobytes()


def test_flash_forward_op_without_gradient_and_with_it():
    """No gradient recorded: the custom op, equal to the plain forward;
    with one: _Flash, whose gradient flows (the op has no autograd)."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 128, 16, generator=g) for _ in range(3))
    with torch.no_grad():
        got = fa.flash_attention(q, k, v, causal=True, block_q=64,
                                 block_k=64)
    want, _ = fa.flash_fwd_reference(q, k, v, True, 16 ** -0.5)
    assert torch.equal(got, want)
    assert torch.equal(torch.ops.paddle_tpu_torch.flash_attention_fwd(
        q, k, v, True, 16 ** -0.5), want)
    qg = q.clone().requires_grad_(True)
    out = fa.flash_attention(qg, k, v, causal=True, block_q=64, block_k=64)
    assert torch.equal(out.detach(), want)
    out.sum().backward()
    assert qg.grad is not None and torch.isfinite(qg.grad).all()


# ---------------------------------------------------------------------------
# the benchmark's A/B in fresh processes
# ---------------------------------------------------------------------------
@pytest.mark.slow
def test_benchmark_compile_cache_smoke_in_subprocesses():
    from paddle_tpu_torch.benchmark import compile_cache as bench
    row = bench.run_smoke(device="cpu")
    assert row["bit_identical"] and row["warm_disk_hits"] == 1
    assert row["cold"]["source"] == "compile"
    assert row["warm"]["source"] == "disk"
    assert row["warm_skipped"] == []      # every cold phase runs warm too


def test_a_program_with_no_feeds_exports(tmp_path):
    """The long-context forward (three [heads, T, d] parameters, causal
    flash attention), an is_test clone fetching its output, from a scope
    cast to bf16: the artifact takes no input, holds the op once, and
    equals the live program bit for bit."""
    ptt.unique_name.reset()
    main, startup = ptt.Program(), ptt.Program()
    startup.random_seed = 1
    with ptt.program_guard(main, startup):
        helper = ptt.layer_helper.LayerHelper("lc")
        q, k, v = (helper.create_parameter(ptt.ParamAttr(name=f"lc_{n}"),
                                           shape=[2, 256, 16],
                                           dtype="float32") for n in "qkv")
        out = ptt.layers.flash_attention(q, k, v, causal=True, block_q=64,
                                         block_k=64)
    infer = main.prune([out]).clone(for_test=True)
    scope = ptt.Scope()
    ptt.Executor(CPU).run(startup, scope=scope)
    for name in scope.keys():
        scope.set(name, scope.get(name).to(torch.bfloat16))
    manifest = ptt.export_compiled_model(str(tmp_path), {}, [out],
                                         main_program=infer, scope=scope,
                                         device="cpu")
    assert manifest["inputs"] == {} and manifest["custom_ops"] == {
        "paddle_tpu_torch::flash_attention_fwd": 1}
    run, _ = ptt.load_compiled_model(str(tmp_path), device="cpu")
    got = run({})[0]
    live, = ptt.Executor(CPU).run(infer, feed={}, fetch_list=[out],
                                  scope=scope, is_test=True,
                                  return_numpy=False)
    assert got.dtype == torch.bfloat16 and torch.equal(got, live)
