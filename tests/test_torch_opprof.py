"""The per-op profiler (``paddle_tpu_torch/observability/opprof.py``)
against the JAX package's ``tests/test_opprof.py``.

* With the fake timer, the same rows in the same execution order as the
  JAX package (index, op type, phase, output shapes and dtypes, bytes):
  the forward ops, the backward as one unit, the update ops; one
  measurement per op, then one of the full replay.
* In fp32 the memory timeline is equal to the JAX package's.
* AMP training: forward rows time against bf16 operands, the backward's
  gradients stay fp32 (as in the JAX package).
* Every window places the random streams at the step again: a dropout
  op's output does not depend on how many windows ran.
* The profiler leaves the executor alone (its step counter, its
  captured steps, the scope).
* ``modeled=True``: each row's FLOPs, bytes and arithmetic intensity
  equal the JAX profiler's (always modeled), its predicted time and
  roofline verdict follow from them with the H100 constants, the
  op-class calibration rows and the by-class ranking aggregate them as
  the JAX package does, the modeled peak is the JAX package's, and the
  measured fields are those of an unmodeled profile.
* The real timer and the driver run on the CPU.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
import torch_parity as tp
from paddle_tpu.observability import opprof as jopprof
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.core import compile_cache
from paddle_tpu_torch.observability import attribution, opprof

CPU = ptt.CPUPlace()


@pytest.fixture(autouse=True)
def clean():
    obs.registry().reset()
    yield
    obs.registry().reset()


def _net(pkg, dropout=True):
    x = pkg.layers.data("x", shape=[8], dtype="float32")
    y = pkg.layers.data("y", shape=[3], dtype="float32")
    h = pkg.layers.fc(x, size=16, act="relu")
    if dropout:
        h = pkg.layers.dropout(h, dropout_prob=0.3)
    pred = pkg.layers.fc(h, size=3, act="softmax")
    loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
    pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def _conv_net(pkg):
    x = pkg.layers.data("x", shape=[3, 8, 8], dtype="float32")
    y = pkg.layers.data("y", shape=[4], dtype="float32")
    c = pkg.layers.conv2d(x, num_filters=4, filter_size=3, padding=1,
                          act="relu")
    p = pkg.layers.pool2d(c, pool_size=2, pool_type="avg", pool_stride=2)
    pred = pkg.layers.fc(p, size=4)
    loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
    pkg.optimizer.Momentum(learning_rate=0.05, momentum=0.9).minimize(loss)
    return loss


def _feed(build, seed=0):
    rng = np.random.RandomState(seed)
    if build is _conv_net:
        return {"x": rng.rand(2, 3, 8, 8).astype("f4"),
                "y": rng.rand(2, 4).astype("f4")}
    return {"x": rng.rand(16, 8).astype("f4"),
            "y": rng.rand(16, 3).astype("f4")}


def _both(build):
    tp.reset_both()
    jm, js = pt.Program(), pt.Program()
    with pt.program_guard(jm, js):
        loss = build(pt)
    jscope = pt.core.Scope()
    pt.Executor(pt.CPUPlace()).run(js, scope=jscope)
    tm = ptt.Program.from_json(jm.to_json())
    tscope = ptt.Scope()
    ptt.load_numpy_state(tscope, tp.jax_state(jscope), "cpu")
    return (jm, jscope), (tm, tscope), loss.name


def _fake(calls=None):
    def measure(call, *, reps, warmup):
        call()
        if calls is not None:
            calls.append(reps)
        return {"seconds": 1e-3, "windows": [1e-3], "spread_pct": 0.0}
    return measure


ROW_KEYS = ("index", "op_type", "phase", "out_shapes", "out_dtypes",
            "bytes")


@pytest.mark.parametrize("build,amp", [(_net, False), (_conv_net, False),
                                       (_net, True)],
                         ids=["fc", "conv", "fc_amp"])
def test_rows_and_order_match_the_jax_profiler(build, amp):
    (jm, jscope), (tm, tscope), loss = _both(build)
    feed = _feed(build)
    jrep = jopprof.profile_program(
        jm, executor=pt.Executor(pt.CPUPlace(), amp=amp), feed=feed,
        scope=jscope, measure=_fake(), batch=16)
    calls = []
    trep = opprof.profile_program(
        tm, executor=ptt.Executor(CPU, amp=amp), feed=feed, scope=tscope,
        measure=_fake(calls), batch=16)
    n = len(tm.global_block().ops)
    assert len(calls) == n + 1 and trep["ops"] == n
    assert [{k: r[k] for k in ROW_KEYS} for r in trep["rows"]] == \
        [{k: r[k] for k in ROW_KEYS} for r in jrep["rows"]]
    phases = [r["phase"] for r in trep["rows"]]
    bw = phases.index("backward")
    assert set(phases[:bw]) == {"forward"} and set(phases[bw + 1:]) == {
        "update"}
    assert trep["per_op_sum_ms"] == pytest.approx(n * 1.0)
    if not amp:
        # fp32: the memory timeline is the JAX package's
        assert trep["memory"]["timeline"] == jrep["memory"]["timeline"]
        for k in ("state_bytes", "peak_bytes", "peak_index", "peak_op"):
            assert trep["memory"][k] == jrep["memory"][k], k
    else:
        fwd = [r for r in trep["rows"] if r["phase"] == "forward"
               and r["op_type"] == "mul"]
        assert fwd and all(d == ["bfloat16"] for r in fwd
                           for d in [r["out_dtypes"]])
        assert set(trep["rows"][bw]["out_dtypes"]) == {"float32"}
    snap = obs.registry().snapshot()
    assert snap["opprof/runs"]["value"] == 1
    assert snap["opprof/ops"]["value"] == n


def test_windows_draw_the_steps_masks():
    (_, _), (tm, tscope), loss = _both(_net)
    feed = _feed(_net)
    drop = next(op for op in tm.global_block().ops if op.type == "dropout")
    mask = drop.outputs["Out"][0]

    def many(call, *, reps, warmup):
        for _ in range(3):
            call()
        return {"seconds": 1e-3, "windows": [1e-3], "spread_pct": 0.0}

    outs = [opprof.profile_program(
        tm, executor=ptt.Executor(CPU), feed=feed, scope=tscope,
        measure=m, fetch_list=[mask, loss])["fetches"]
        for m in (_fake(), many)]
    for name in (mask, loss):
        np.testing.assert_array_equal(outs[0][name], outs[1][name])


def test_profiling_leaves_the_executor_alone():
    (_, _), (tm, tscope), loss = _both(_net)
    exe = ptt.Executor(CPU)
    before = {k: tscope.numpy(k).copy() for k in tscope.keys()}
    step = exe._step
    c0 = compile_cache.stats().snapshot()
    opprof.profile_program(tm, executor=exe, feed=_feed(_net),
                           scope=tscope, measure=_fake())
    assert exe._step == step
    assert compile_cache.stats().snapshot() == c0
    for k, v in before.items():
        np.testing.assert_array_equal(tscope.numpy(k), v)


@pytest.mark.parametrize("build", [_net, _conv_net], ids=["fc", "conv"])
def test_modeled_join_equals_the_jax_profilers(build):
    from paddle_tpu_torch.analysis.cost_model import (HBM_GBPS, ICI_GBPS,
                                                      PEAK_FLOPS)
    (jm, jscope), (tm, tscope), _ = _both(build)
    feed = _feed(build)
    jrep = jopprof.profile_program(jm, executor=pt.Executor(pt.CPUPlace()),
                                   feed=feed, scope=jscope,
                                   measure=_fake(), batch=16)
    plain = opprof.profile_program(tm, executor=ptt.Executor(CPU),
                                   feed=feed, scope=tscope,
                                   measure=_fake(), batch=16)
    trep = opprof.profile_program(tm, executor=ptt.Executor(CPU),
                                  feed=feed, scope=tscope, measure=_fake(),
                                  batch=16, modeled=True)
    # the join adds fields; the measured ones are an unmodeled profile's
    assert "modeled" not in plain["rows"][0] and "op_classes" not in plain
    assert [{k: r[k] for k in ROW_KEYS} for r in trep["rows"]] == \
        [{k: r[k] for k in ROW_KEYS} for r in plain["rows"]]
    for t, j in zip(trep["rows"], jrep["rows"]):
        tm_, jm_ = t["modeled"], j["modeled"]
        for k in ("flops", "hbm_bytes", "arithmetic_intensity"):
            assert tm_[k] == jm_[k], (t["op_type"], k)
        compute_s = tm_["flops"] / PEAK_FLOPS
        hbm_s = tm_["hbm_bytes"] / HBM_GBPS
        assert tm_["predicted_ms"] == round((compute_s + hbm_s) * 1e3, 9)
        assert tm_["roofline"] == ("compute-bound" if compute_s >= hbm_s
                                   else "memory-bound")
        assert t["ratio"] == round(t["wall_ms"]
                                   / ((compute_s + hbm_s) * 1e3), 4)
    assert ICI_GBPS > 0 and trep["mesh_axes"] == jrep["mesh_axes"] == {}
    keys = ("op_type", "count", "measured_ms", "assume_batch",
            "mesh_axes")
    assert [{k: c[k] for k in keys} for c in trep["op_classes"]] == \
        [{k: c[k] for k in keys} for c in jrep["op_classes"]]
    assert {c["program"] for c in trep["op_classes"]} == {trep["program"]}
    assert trep["op_classes"] == opprof.op_class_rows(
        trep["rows"], trep["program"], 16)
    keys = ("op_type", "count", "measured_ms", "share")
    assert [{k: e[k] for k in keys} for e in trep["xla_loses_here"]] == \
        [{k: e[k] for k in keys} for e in jrep["xla_loses_here"]]
    assert [e.get("pallas_candidate") for e in trep["xla_loses_here"]] == \
        [e.get("pallas_candidate") for e in jrep["xla_loses_here"]]
    assert trep["memory"]["modeled_peak_bytes"] == \
        jrep["memory"]["modeled_peak_bytes"]
    assert plain["memory"]["modeled_peak_bytes"] is None
    text = opprof.render_profile(trep)
    assert "where the time goes" in text and "ratio" in text
    assert opprof.PALLAS_CANDIDATES == jopprof.PALLAS_CANDIDATES
    assert opprof.TOLERANCE == attribution.BUDGET_TOLERANCE == \
        jopprof.TOLERANCE


def test_real_timer_rows_and_render():
    (_, _), (tm, tscope), _ = _both(_conv_net)
    rep = opprof.profile_program(tm, executor=ptt.Executor(CPU),
                                 feed=_feed(_conv_net), scope=tscope,
                                 reps=3, warmup=1)
    assert all(r["wall_ms"] > 0 and len(r["windows_ms"]) == 3
               for r in rep["rows"])
    assert rep["eager_total_ms"] > 0 and rep["device"] == "cpu"
    text = opprof.render_profile(rep)
    assert "per-op profile" in text and "backward" in text


def test_synth_feeds_match_the_jax_package():
    tp.reset_both()
    for pkg, mod in ((pt, jopprof), (ptt, opprof)):
        pkg.unique_name.reset()
        main, start = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, start):
            _conv_net(pkg)
        feeds = mod.synth_feeds(main, batch=4, seed=1)
        if pkg is pt:
            want = feeds
        else:
            assert sorted(feeds) == sorted(want)
            for k in feeds:
                np.testing.assert_array_equal(feeds[k], want[k])


def test_driver_smoke_on_the_cpu():
    from paddle_tpu_torch.benchmark import opprof as driver
    doc = driver.main(["--smoke", "--device", "cpu"])
    assert [r["model"] for r in doc["rows"]] == list(driver.MODELS)
    for r in doc["rows"]:
        assert r["ops"] > 0 and len(r["top3"]) == 3
        assert r["memory"]["peak_bytes"] >= r["memory"]["state_bytes"]
    assert doc["device"] == "cpu"
    # the modeled columns and the calibration table the planner reads
    assert all("roofline" in t for r in doc["rows"] for t in r["top3"])
    assert all(r["xla_loses_here"] and r["memory"]["modeled_peak_bytes"]
               for r in doc["rows"])
    ratios = attribution.load_op_class_ratios(doc["calibration"])
    assert {"mul", "backward"} <= set(ratios)
    programs = {r["program"] for r in doc["rows"]}
    for key, row in doc["calibration"]["op_classes"].items():
        assert key == f"{row['program']}:{row['op_type']}"
        assert row["program"] in programs
