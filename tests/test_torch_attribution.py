"""The doctor's measured budgets (``paddle_tpu_torch/observability/
attribution.py``) against the JAX package's on the same logs.

* A log written by the JAX package and one written by the port give
  equal ``step_budget``, ``serving_budget``, ``decode_budget``,
  ``remote_budget`` and ``doctor_report`` results in both packages, the
  milliseconds to 1e-9: the executor's pipelined training log of each
  package, the port's serving and decode runtimes' logs, and a seeded
  synthetic log holding every event the budgets read.
* Budgets reconcile with the measured wall within ``BUDGET_TOLERANCE``.
* The modeled side: ``calibration_row``'s predicted time is the JAX
  cost model's static quantities over the H100 constants, the row
  schema and rendering are the JAX package's, ``doctor_report(program=)``
  carries the row for its measured warm step, and the calibration table
  written by ``save_calibration`` and ``save_op_class_calibration``
  equals the JAX package's file and reads back through
  ``load_op_class_ratios`` alike; ``executable_facts`` is None, so a
  row's model is ``"static"``.
"""
import json

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
import torch_parity as tp
from paddle_tpu import flags as jflags
from paddle_tpu.observability import attribution as jattr
from paddle_tpu.observability import export as jexport
from paddle_tpu_torch import flags, layers
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.observability import attribution, export

CPU = ptt.CPUPlace()
BUDGETS = ("step_budget", "serving_budget", "decode_budget",
           "remote_budget")


@pytest.fixture(autouse=True)
def clean():
    prev = {n: flags.get_flag(n) for n in ("observe", "metrics_log")}
    jprev = {n: jflags.get_flag(n) for n in ("observe", "metrics_log")}
    yield
    for n, v in prev.items():
        flags.set_flag(n, v)
    for n, v in jprev.items():
        jflags.set_flag(n, v)
    export._reset_writer()
    jexport._reset_writer()
    obs.registry().reset()


def assert_close(a, b, path="$"):
    """Equal structures, numbers to 1e-9."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            assert_close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, abs=1e-9, rel=0), path
    else:
        assert a == b, path


def _events(path):
    return obs.iter_log_events([str(path)])[0]


def _agree(path):
    """Every budget and the doctor report over ``path``, both packages;
    returns the port's step budget."""
    events = _events(path)
    jevents = jexport.iter_log_events([str(path)])[0]
    assert events == jevents
    for name in BUDGETS:
        mine = getattr(attribution, name)(events)
        theirs = getattr(jattr, name)(events)
        if mine is None or theirs is None:
            assert mine is None and theirs is None, name
            continue
        keys = set(mine) - {"hints"}       # hint texts name each CLI
        assert_close({k: mine[k] for k in keys},
                     {k: theirs[k] for k in keys})
    mine, theirs = attribution.doctor_report([str(path)]), \
        jattr.doctor_report([str(path)])
    for d in (mine, theirs):
        for sec in ("training", "serving", "decode", "remote"):
            if sec in d:
                d[sec].pop("hints", None)
    assert_close(mine, theirs)
    return attribution.step_budget(events)


def _net(pkg):
    x = pkg.layers.data("x", shape=[8], dtype="float32")
    y = pkg.layers.data("y", shape=[3], dtype="float32")
    pred = pkg.layers.fc(pkg.layers.fc(x, size=16, act="relu"), size=3)
    loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
    pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def _train_log(pkg, fl, path):
    tp.reset_both()
    main, start = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, start):
        loss = _net(pkg)
    scope = pkg.Scope() if pkg is ptt else pkg.core.Scope()
    exe = pkg.Executor(pkg.CPUPlace(), observe=True)
    exe.run(start, scope=scope)
    rng = np.random.RandomState(0)
    feeds = [{"x": rng.rand(6, 8).astype("f4"),
              "y": rng.rand(6, 3).astype("f4")} for _ in range(12)]
    fl.set_flag("metrics_log", str(path))
    list(exe.run_pipelined(iter(feeds), main, fetch_list=[loss],
                           scope=scope, steps_per_dispatch=4,
                           prefetch_depth=2))
    fl.set_flag("metrics_log", "")
    export._reset_writer()
    jexport._reset_writer()
    return main


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_training_budgets_agree_over_either_packages_log(writer, tmp_path):
    pkg, fl = (pt, jflags) if writer == "jax" else (ptt, flags)
    path = tmp_path / f"{writer}.jsonl"
    _train_log(pkg, fl, path)
    sb = _agree(path)
    assert sb is not None and sb["within_tolerance"]
    assert sb["steps"] == 12
    assert abs(sum(sb["budget"].values()) - sb["measured_wall_ms"]) <= \
        attribution.BUDGET_TOLERANCE * sb["measured_wall_ms"]


def test_serving_and_decode_budgets_agree(tmp_path):
    from paddle_tpu_torch.serving import Model, Server
    from paddle_tpu_torch.serving.decode import DecodeEngine
    path = tmp_path / "serve.jsonl"
    flags.set_flag("metrics_log", str(path))
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start):
        x = layers.data("x", shape=[4], dtype="float32")
        y = layers.fc(x, size=3)
    sc = ptt.Scope()
    exe = ptt.Executor(CPU)
    exe.run(start, scope=sc)
    flags.set_flag("observe", True)
    srv = Server(max_batch=4, max_wait_ms=2.0, deadline_ms=None)
    srv.add_model(Model.from_program(exe, main, [y], name="fc", scope=sc,
                                     example={"x": np.ones(4, "f4")}))
    srv.add_decode_model(DecodeEngine(vocab_size=16, hidden_dim=8,
                                      slots=2, max_len=16, place=CPU,
                                      use_jit=False), name="dec")
    srv.start()
    try:
        rs = [srv.submit({"x": np.full(4, i, "f4")}, model="fc")
              for i in range(8)]
        rs += [srv.submit_decode([1, 2], 5, model="dec")
               for _ in range(4)]
        for r in rs:
            r.result(timeout=60)
    finally:
        srv.shutdown(drain=True)
    flags.set_flag("metrics_log", "")
    export._reset_writer()
    _agree(path)
    events = _events(path)
    sv = attribution.serving_budget(events)
    assert sv["served"] == 12 and sv["within_tolerance"]
    db = attribution.decode_budget(events)
    assert db["steps"] > 0 and db["tokens"] > 0


def _synthetic(path, seed):
    """Every event the budgets read, with seeded times."""
    rng = np.random.RandomState(seed)
    t, lines = 1000.0, []
    for i in range(20):
        wall = float(rng.uniform(1, 20))
        t += wall / 1e3 + float(rng.uniform(0, 0.004))
        lines.append({"ts": t, "kind": "step", "steps": int(rng.randint(1, 5)),
                      "wall_ms": wall, "cold_compile": bool(i == 0),
                      "fetch_block_ms": float(rng.uniform(0, wall / 2))})
        lines.append({"ts": t, "kind": "span", "name": "pipeline/stage",
                      "trace": "t1", "span": f"s{i}", "parent": None,
                      "t0": t - float(rng.uniform(0, 0.03)),
                      "dur_ms": float(rng.uniform(0, 9))})
    for i in range(10):
        d = float(rng.uniform(1, 9))
        lines.append({"ts": t, "kind": "span", "name": "serving/batch",
                      "trace": f"b{i}", "span": f"b{i}", "t0": t,
                      "dur_ms": d, "labels": {"dispatch_ms": d,
                                              "requests": [i]}})
        lines.append({"ts": t, "kind": "span", "name": "serving/request",
                      "trace": f"r{i}", "span": f"r{i}", "t0": t,
                      "dur_ms": d + float(rng.uniform(0, 5)),
                      "labels": {"id": i, "status": "ok" if i % 4
                                 else "Overloaded"}})
        lines.append({"ts": t + i * 0.01, "kind": "span",
                      "name": "serving/decode_step", "trace": f"d{i}",
                      "span": f"d{i}", "t0": t, "dur_ms": d + 0.5,
                      "labels": {"active": int(rng.randint(1, 4)),
                                 "dispatch_ms": d}})
        lines.append({"ts": t, "kind": "span", "name": "pserver/rpc",
                      "trace": f"p{i}", "span": f"p{i}", "t0": t,
                      "dur_ms": d + 2.0,
                      "labels": {"op": "pull" if i % 2 else "push",
                                 "srv_queue_ms": float(rng.uniform(0, 1)),
                                 "srv_kernel_ms": d}})
    path.write_text("".join(json.dumps(e) + "\n" for e in lines))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_synthetic_budgets_agree(seed, tmp_path):
    path = tmp_path / f"syn{seed}.jsonl"
    _synthetic(path, seed)
    _agree(path)
    events = _events(path)
    for name in BUDGETS:
        assert getattr(attribution, name)(events) is not None, name


def test_calibration_row_and_doctor_report(tmp_path):
    from paddle_tpu.analysis.cost_model import estimate_cost
    from paddle_tpu_torch.analysis import cost_model
    path = tmp_path / "t.jsonl"
    main = _train_log(ptt, flags, path)
    tp.reset_both()
    jmain, jstart = pt.Program(), pt.Program()
    with pt.program_guard(jmain, jstart):
        _net(pt)
    assert ptt.Program.from_json(jmain.to_json()).to_json() == \
        main.to_json()
    row = attribution.calibration_row(main, 2.5, assume_batch=6)
    jrow = jattr.calibration_row(jmain, 2.5, assume_batch=6)
    assert sorted(row) == sorted(jrow)
    for k in ("assume_batch", "mesh_axes", "measured_ms", "model"):
        assert row[k] == jrow[k], k
    assert row["model"] == "static"
    # the reference's static quantities over the H100 constants
    j = estimate_cost(jmain, {}, assume_batch=6)
    want = (j.flops_per_device / cost_model.PEAK_FLOPS
            + j.hbm_bytes_per_device / cost_model.HBM_GBPS) * 1e3
    assert row["predicted_ms"] == round(want, 6)
    assert row["ratio"] == round(2.5 / want, 4)
    rep = attribution.doctor_report([str(path)], program=main,
                                    assume_batch=6)
    assert rep["training"]["within_tolerance"]
    assert rep["calibration"] == attribution.calibration_row(
        main, rep["training"]["step_ms_warm_mean"], assume_batch=6)
    text = attribution.render_doctor(rep)
    line = next(ln for ln in text.splitlines()
                if ln.startswith("calibration:"))
    assert line == next(
        ln for ln in jattr.render_doctor(
            {"calibration": rep["calibration"]}).splitlines()
        if ln.startswith("calibration:"))
    assert "top bottleneck" in text
    assert attribution.executable_facts(object()) is None
    assert attribution.BUDGET_TOLERANCE == jattr.BUDGET_TOLERANCE


def test_calibration_table_equals_the_reference(tmp_path):
    rows = [{"program": "aa", "predicted_ms": 1.0, "measured_ms": 3.0,
             "ratio": 3.0, "assume_batch": 8, "mesh_axes": {},
             "model": "static"},
            {"program": "bb", "predicted_ms": 2.0, "measured_ms": 3.0,
             "ratio": 1.5, "assume_batch": 8, "mesh_axes": {},
             "model": "static"}]
    classes = [{"program": p, "op_type": t, "ratio": r, "count": 1,
                "predicted_ms": 1.0, "measured_ms": r}
               for p, t, r in (("aa", "conv2d", 4.0), ("bb", "conv2d", 8.0),
                               ("cc", "conv2d", 5.0), ("aa", "mul", 2.0),
                               ("bb", "relu", -1.0))]
    docs = []
    for mod, name in ((attribution, "t"), (jattr, "j")):
        path = str(tmp_path / f"{name}.json")
        mod.save_calibration(rows[:1], path)
        mod.save_op_class_calibration(classes, path)
        docs.append(mod.save_calibration(rows[1:], path))
        with open(path) as f:
            docs.append(f.read())
        docs.append(mod.load_op_class_ratios(path))
    assert docs[:3] == docs[3:]
    assert docs[2] == {"conv2d": 5.0, "mul": 2.0}
    assert attribution.load_op_class_ratios(docs[0]) == docs[2]
    assert attribution.load_op_class_ratios({"programs": {}}) == {}
    with pytest.raises(ValueError):
        attribution.load_op_class_ratios([1])


def test_empty_log_renders_the_hint(tmp_path):
    p = tmp_path / "empty.jsonl"
    p.write_text("")
    rep = attribution.doctor_report([str(p)])
    assert attribution.render_doctor(rep) == jattr.render_doctor(
        jattr.doctor_report([str(p)]))
