"""``Executor(check_nan_inf=..., compute_dtype=...)`` and the NaN
bisect (``paddle_tpu_torch/observability/nanprov.py``) against the JAX
package on the same programs and inputs.

* ``check_nan_inf``: the step raises ``FloatingPointError`` naming the
  first producer in program order, with the same message in both
  packages; the eager bisect diagnoses the same op, var, slot, phase,
  shape, dtype and NaN/Inf counts — on a planted ``log(-1)``, on
  ``log(0)`` inside a training step's forward slice, on a NaN feed and
  on a NaN weight.  The bisect's dropout masks are the step's own.
  ``run_steps`` and ``run_pipelined`` refuse; a ``nan`` event reaches
  the log; ``executor/nan_events`` counts only when observing.
* ``compute_dtype="float64"``: 3 training steps of an fc and a 1x1-conv
  program match the JAX package under ``jax.enable_x64`` to 1e-12, and
  the float64 conv takes the plain route, counted (the kernels take
  fp32 and bf16).
"""
import json

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
import torch_parity as tp
from paddle_tpu.observability import nanprov as jnanprov
from paddle_tpu_torch import flags
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.observability import export, nanprov
from paddle_tpu_torch.ops import conv1x1

CPU = ptt.CPUPlace()


@pytest.fixture(autouse=True)
def clean():
    obs.registry().reset()
    prev = {n: flags.get_flag(n) for n in ("observe", "metrics_log")}
    yield
    for n, v in prev.items():
        flags.set_flag(n, v)
    export._reset_writer()
    obs.registry().reset()


def _both(build, seed=0):
    """``build(pkg)`` -> fetch var name, in both packages: the JAX
    program's JSON in the port and its startup scope carried over."""
    tp.reset_both()
    jm, js = pt.Program(), pt.Program()
    js.random_seed = jm.random_seed = seed
    with pt.program_guard(jm, js):
        out = build(pt)
    jscope = pt.core.Scope()
    pt.Executor(pt.CPUPlace()).run(js, scope=jscope)
    tm = ptt.Program.from_json(jm.to_json())
    tscope = ptt.Scope()
    ptt.load_numpy_state(tscope, tp.jax_state(jscope), "cpu")
    return (jm, jscope), (tm, tscope), out


def _log_neg(pkg):
    x = pkg.layers.data("x", shape=[4], dtype="float32")
    h = pkg.layers.fc(x, size=3)
    return pkg.layers.mean(pkg.layers.log(h)).name


def _train_log0(pkg):
    x = pkg.layers.data("x", shape=[4], dtype="float32")
    y = pkg.layers.data("y", shape=[1], dtype="float32")
    h = pkg.layers.fc(x, size=4, act="relu")
    z = pkg.layers.log(pkg.layers.scale(h, scale=0.0))
    pred = pkg.layers.fc(z, size=1)
    loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
    pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss.name


def _dropout_train(pkg):
    x = pkg.layers.data("x", shape=[8], dtype="float32")
    h = pkg.layers.dropout(pkg.layers.fc(x, size=8), dropout_prob=0.5)
    z = pkg.layers.log(h)
    loss = pkg.layers.mean(z)
    pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss.name


CASES = {
    # fc outputs of mixed sign: log of the negatives
    "log_neg": (_log_neg, lambda r: {"x": r.randn(5, 4).astype("f4")}),
    "train_log0": (_train_log0, lambda r: {
        "x": np.ones((2, 4), "f4"), "y": np.ones((2, 1), "f4")}),
    "nan_feed": (_log_neg, lambda r: {"x": np.where(
        r.rand(5, 4) < 0.2, np.nan, 1.0 + r.rand(5, 4)).astype("f4")}),
}


def _jax_fail(jm, jscope, feed, fetch):
    with pytest.raises(FloatingPointError) as ei:
        pt.Executor(pt.CPUPlace(), check_nan_inf=True).run(
            jm, feed=feed, fetch_list=[fetch], scope=jscope)
    return str(ei.value)


@pytest.mark.parametrize("case", sorted(CASES))
def test_check_nan_inf_and_bisect_match_the_jax_package(case, tmp_path):
    build, make_feed = CASES[case]
    (jm, jscope), (tm, tscope), fetch = _both(build)
    feed = make_feed(np.random.RandomState(3))
    # the bisects on the same pre-step state
    jexe = pt.Executor(pt.CPUPlace(), check_nan_inf=True)
    jstate = {k: jscope.get(k) for k in jexe._state_keys(jm, jscope)}
    jdiag = jnanprov.bisect_step(jexe, jm, feed, jstate, 0)
    texe = ptt.Executor(CPU, check_nan_inf=True)
    tfeed = {k: texe._feed_tensor(tm.global_block(), k, v)
             for k, v in feed.items()}
    tstate = {k: tscope.get(k) for k in texe._state_keys(tm, tscope)}
    tdiag = nanprov.bisect_step(texe, tm, tfeed, tstate, 0)
    assert jdiag is not None and tdiag == jdiag
    # the steps raise with the same localization
    jmsg = _jax_fail(jm, jscope, feed, fetch)
    log = tmp_path / "nan.jsonl"
    flags.set_flag("metrics_log", str(log))
    with pytest.raises(FloatingPointError) as ei:
        texe.run(tm, feed=feed, fetch_list=[fetch], scope=tscope)
    tmsg = str(ei.value)
    assert tmsg.splitlines()[0] == jmsg.splitlines()[0]
    assert nanprov.format_diagnosis(tdiag) in tmsg
    export._reset_writer()
    evs = [json.loads(line) for line in log.read_text().splitlines()]
    nan = [e for e in evs if e["kind"] == "nan"]
    assert len(nan) == 1 and nan[0]["var"] == tdiag["var"]
    assert nan[0]["op_type"] == tdiag["op_type"]
    # not observing: the counter stays put
    assert obs.registry().snapshot()["executor/nan_events"]["value"] == 0


def test_poisoned_weight_is_reported_as_state():
    (jm, jscope), (tm, tscope), fetch = _both(_log_neg)
    w = next(n for n in tscope.keys() if n.endswith(".w_0"))
    bad = tscope.numpy(w).copy()
    bad[0, 0] = np.nan
    jscope.set(w, bad)
    tscope.set(w, torch.from_numpy(bad))
    feed = {"x": np.ones((2, 4), "f4")}
    jmsg = _jax_fail(jm, jscope, feed, fetch)
    with pytest.raises(FloatingPointError) as ei:
        ptt.Executor(CPU, check_nan_inf=True).run(
            tm, feed=feed, fetch_list=[fetch], scope=tscope)
    assert str(ei.value).splitlines()[0] == jmsg.splitlines()[0]
    assert "phase state" in str(ei.value) and repr(w) in str(ei.value)


def test_bisect_replays_the_steps_dropout():
    """A step with dropout: the bisect (at the failing step's index)
    draws the step's masks, so its NaN count is the step's."""
    (_, _), (tm, tscope), fetch = _both(_dropout_train)
    texe = ptt.Executor(CPU, check_nan_inf=True)
    feed = {"x": np.random.RandomState(0).randn(16, 8).astype("f4")}
    texe.run(ptt.Program(), scope=tscope)         # advance the step
    tfeed = {k: texe._feed_tensor(tm.global_block(), k, v)
             for k, v in feed.items()}
    pre = {k: tscope.get(k).clone()
           for k in texe._state_keys(tm, tscope)}
    step = texe._step
    with pytest.raises(FloatingPointError) as ei:
        texe.run(tm, feed=feed, fetch_list=[fetch], scope=tscope)
    diag = nanprov.bisect_step(texe, tm, tfeed, pre, step)
    assert nanprov.format_diagnosis(diag) in str(ei.value)
    # a different step index draws other masks (other NaN counts)
    other = nanprov.bisect_step(texe, tm, tfeed, pre, step + 7)
    assert other["var"] == diag["var"]
    assert other["nan_count"] != diag["nan_count"]


def test_nan_event_counter_gated_by_observe():
    (_, _), (tm, tscope), fetch = _both(_log_neg)
    exe = ptt.Executor(CPU, check_nan_inf=True, observe=True)
    with pytest.raises(FloatingPointError):
        exe.run(tm, feed={"x": -np.ones((1, 4), "f4") * 50},
                fetch_list=[fetch], scope=tscope)
    assert obs.registry().snapshot()["executor/nan_events"]["value"] == 1


def test_finite_steps_pass_and_batched_paths_refuse():
    ok = ptt.Executor(CPU, check_nan_inf=True)
    sc = ptt.Scope()
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start):
        x = ptt.layers.data("x", shape=[4], dtype="float32")
        y = ptt.layers.scale(x, scale=2.0)
    val, = ok.run(main, feed={"x": np.ones((2, 4), "f4")}, fetch_list=[y],
                  scope=sc)
    np.testing.assert_array_equal(val, np.full((2, 4), 2.0, "f4"))
    with pytest.raises(ValueError, match="check_nan_inf"):
        ok.run_steps(2, main, feed={"x": np.ones((2, 4), "f4")},
                     fetch_list=[y], scope=sc)
    with pytest.raises(ValueError, match="check_nan_inf"):
        next(ok.run_pipelined(iter([{"x": np.ones((2, 4), "f4")}]), main,
                              fetch_list=[y], scope=sc))


# ---------------------------------------------------------------------------
# compute_dtype
# ---------------------------------------------------------------------------
def _fc_train(pkg):
    x = pkg.layers.data("x", shape=[6], dtype="float32")
    y = pkg.layers.data("y", shape=[2], dtype="float32")
    h = pkg.layers.fc(x, size=8, act="tanh")
    pred = pkg.layers.fc(h, size=2)
    loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
    pkg.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(loss)
    return loss.name


def _conv1x1_train(pkg):
    x = pkg.layers.data("x", shape=[128, 4, 4], dtype="float32")
    y = pkg.layers.data("y", shape=[2], dtype="float32")
    c = pkg.layers.conv2d(x, num_filters=128, filter_size=1, act="relu")
    pred = pkg.layers.fc(c, size=2)
    loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
    pkg.optimizer.SGD(learning_rate=0.01).minimize(loss)
    return loss.name


@pytest.mark.parametrize("build,shape", [
    (_fc_train, (4, 6)), (_conv1x1_train, (8, 128, 4, 4))],
    ids=["fc", "conv1x1"])
def test_compute_dtype_float64_matches_jax_x64(build, shape):
    rng = np.random.RandomState(0)
    feeds = [{"x": rng.randn(*shape).astype("f4"),
              "y": rng.randn(shape[0], 2).astype("f4")} for _ in range(3)]
    with jax.enable_x64(True):
        (jm, jscope), (tm, tscope), loss = _both(build)
        jexe = pt.Executor(pt.CPUPlace(), compute_dtype="float64")
        jl = [jexe.run(jm, feed=f, fetch_list=[loss], scope=jscope)[0]
              for f in feeds]
        jparams = {k: np.asarray(jscope.numpy(k)) for k in jscope.keys()}
    conv1x1.reset_counts()
    texe = ptt.Executor(CPU, compute_dtype="float64",
                        conv1x1_pallas=True)
    tl = [texe.run(tm, feed=f, fetch_list=[loss], scope=tscope)[0]
          for f in feeds]
    for a, b in zip(tl, jl):
        assert a.dtype == np.float64
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    for k, v in jparams.items():
        t = tscope.numpy(k)
        assert t.dtype == v.dtype, k     # the scope keeps its dtypes
        np.testing.assert_allclose(t, v, rtol=1e-12, atol=1e-12,
                                   err_msg=k)
    if build is _conv1x1_train:
        # the float64 1x1 conv passed the shape gate, took the plain
        # route by dtype (3 steps), and launched nothing
        assert conv1x1.routes["dtype"] == 3
        assert conv1x1.launches() == 0
