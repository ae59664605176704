"""The control-flow and io families in the port against the JAX package:
the 16 op names of ``paddle_tpu/ops/control_flow_ops.py`` the port
lacked (``while``, ``conditional_block``, the IfElse split and merge,
the tensor arrays, ``lod_rank_table``, ``reorder_lod_tensor_by_rank``,
``shrink_rnn_memory``, ``print``, ``assert``), ``save``/``load``, the 15
control-flow layers, and the executor's uncaptured route.

* **Single ops.** One case or more a name
  (``paddle_tpu_torch.testing.op_cases.CF_CASES``: negative and
  out-of-range array indices, a float merge mask, tied lengths in the
  rank table, a var without lengths) through ``torch_parity.check_op``:
  outputs, their dtypes, the lengths each op sets, the gradients against
  ``jax.vjp``; again in bf16.
* **Programs.** The JAX package's own While (``tests/test_executor.py``)
  and IfElse (``tests/test_ops_misc.py``) programs; a greedy decoder
  looped by ``While`` writing its ids into an array
  (``testing/cf_programs.py``, ``array_length`` is the capacity, 128);
  a ``Switch`` with overlapping cases and a default; a ``DynamicRNN``
  classifier over a rank table, two Momentum steps; a
  ``conditional_block`` whose untaken branch is ``log(0)``, differentiated;
  a gradient through ``While``, refused by both packages; ``print`` at
  every iteration.
* **The route.** ``while``, ``conditional_block`` and ``print`` (in any
  block) make a step run uncaptured, counted under the op, through
  ``run``, ``run_steps``, ``compile`` and ``trainer.SGD.train`` (its
  losses the JAX trainer's); IfElse and DynamicRNN programs
  keep no reason; ``export_compiled_model`` refuses a program holding
  ``while`` or ``conditional_block`` and names the op.

Tolerances: single ops fp32 ``rtol=1e-4, atol=1e-5``, bf16 within 2^-7
of the output's scale, integer, bool, index and length outputs exactly;
programs in fp32 within ``rtol=1e-5, atol=1e-6`` (``PROG_TOL``), ids,
counters and array lengths exactly.
"""
import re

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
import torch_parity as tp
from paddle_tpu_torch.core import compile_cache
from paddle_tpu_torch.core.executor import UNCAPTURED_OPS, uncaptured_op
from paddle_tpu_torch.testing import cf_programs as cf
from paddle_tpu_torch.testing import op_cases as oc

PROG_TOL = dict(rtol=1e-5, atol=1e-6)


def _names(module):
    src = open(f"paddle_tpu/ops/{module}.py").read()
    names = set()
    for m in re.finditer(r"register_op\(([^)]*)\)", src):
        names |= set(re.findall(r'"([a-z0-9_]+)"', m.group(1)))
    return names


CF = _names("control_flow_ops") | _names("io_ops")
CASES = sorted(oc.CF_CASES)


def test_every_new_name_has_a_case_or_a_program():
    """The single-op cases cover every name but the three that need a
    program (and ``rnn``/``rnn_memory_helper``, ported with seq2seq)."""
    cased = {n.split("[")[0] for n in CASES}
    assert CF - cased == {"while", "conditional_block", "print", "rnn",
                          "rnn_memory_helper"}


@pytest.mark.parametrize("name", CASES)
def test_op_matches_jax(name):
    op, ins, attrs, wrt, lens = oc.CF_CASES[name](oc.rng(name))
    tp.check_op(op, ins, attrs, "float32", wrt, lens=lens)


@pytest.mark.parametrize("name", CASES)
def test_op_matches_jax_in_bf16(name):
    op, ins, attrs, _, lens = oc.CF_CASES[name](oc.rng(name))
    tp.check_op(op, ins, attrs, "bfloat16", lens=lens)


def test_lod_array_length_is_the_capacity_and_rank_table_is_stable():
    """Two differences from the reference's semantics, kept as the JAX
    package has them (ROADMAP Queue C): the length of an array is its
    buffer's capacity; the rank table's order among equal lengths is
    the rows' order; ``lod_tensor_to_array`` ignores its table."""
    op, ins, attrs, _, lens = oc.CF_CASES["lod_array_length"](oc.rng("x"))
    _, t, _, _ = tp.run_op(op, ins, attrs)
    assert int(t[("Out", 0)]) == 7
    op, ins, attrs, _, lens = oc.CF_CASES["lod_rank_table"](oc.rng("x"))
    _, t, _, _ = tp.run_op(op, ins, attrs, lens=lens)
    assert t[("Out", 0)].tolist() == [1, 3, 0, 4, 2, 5]
    assert t[("Out", 0)].dtype == torch.int32
    op, ins, attrs, _, lens = oc.CF_CASES["lod_tensor_to_array"](oc.rng("x"))
    _, t, _, _ = tp.run_op(op, ins, attrs, lens=lens)
    np.testing.assert_array_equal(t[("Out", 0)].numpy(),
                                  ins["X"][0].swapaxes(0, 1))


# ---------------------------------------------------------------------------
# programs in both packages
# ---------------------------------------------------------------------------
def _run(pkg, main, feed, fetch, scope):
    return pkg.Executor(pkg.CPUPlace()).run(main, feed=feed,
                                            fetch_list=fetch, scope=scope)


def _fresh(pkg):
    pkg.unique_name.reset()
    return pkg.Program(), pkg.Program()


def _while_sum(pkg, body_print=False):
    """The JAX package's While test (``tests/test_executor.py``): sum ones
    until the counter reaches 5."""
    main, startup = _fresh(pkg)
    with pkg.program_guard(main, startup):
        L = pkg.layers
        i = L.fill_constant([1], "int64", 0)
        limit = L.fill_constant([1], "int64", 5)
        total = L.fill_constant([1], "float32", 0.0)
        cond = L.less_than(i, limit)
        w = L.While(cond)
        with w.block():
            L.sums([total, L.ones([1], "float32")], out=total)
            if body_print:
                pkg.layer_helper.LayerHelper("print").append_op(
                    type="print", inputs={"In": [total]}, outputs={},
                    attrs={"message": "total"})
            L.increment(i, 1.0)
            L.less_than(i, limit, cond=cond)
    return main, startup, {"total": total, "i": i}


@pytest.mark.parametrize("pkg", [pt, ptt], ids=["jax", "torch"])
def test_while_program_as_the_reference(pkg):
    main, _, v = _while_sum(pkg)
    scope = pkg.core.Scope() if pkg is pt else ptt.Scope()
    out, iv = _run(pkg, main, {}, [v["total"], v["i"]], scope)
    assert float(out[0]) == 5.0 and int(iv[0]) == 5


def _ifelse(pkg):
    """The JAX package's IfElse test (``tests/test_ops_misc.py``)."""
    main, startup = _fresh(pkg)
    with pkg.program_guard(main, startup):
        L = pkg.layers
        x = L.data("x", shape=[1], dtype="float32")
        cond = L.less_than(x, L.fill_constant([1], "float32", 0.5))
        ie = L.IfElse(cond)
        with ie.true_block():
            ie.output(L.scale(ie.input(x), scale=10.0))
        with ie.false_block():
            ie.output(L.scale(ie.input(x), scale=-1.0))
        out = ie()
    return main, startup, {"out": out}


def test_ifelse_program_as_the_reference():
    feed = {"x": np.array([[0.2], [0.8], [0.5], [-3.0]], np.float32)}
    got = {}
    for name, pkg in (("jax", pt), ("torch", ptt)):
        main, _, v = _ifelse(pkg)
        scope = pkg.core.Scope() if pkg is pt else ptt.Scope()
        got[name] = _run(pkg, main, feed, [v["out"]], scope)[0]
    np.testing.assert_allclose(np.asarray(got["torch"]).reshape(-1),
                               [2.0, -0.8, -0.5, -30.0], rtol=1e-6)
    np.testing.assert_array_equal(got["torch"], np.asarray(got["jax"]))


def test_greedy_while_decode_with_arrays():
    """A greedy decoder looped by While (the seq2seq model's encoder head
    and decoder step) in both packages from the JAX weights: the same
    ids at every step, top-2 probabilities within ``PROG_TOL``, the
    counter at the fed limit, the buffer's rows past it zero, and
    ``array_length`` the capacity, 128."""
    V, D, B, steps = 37, 16, 5, 6
    m = tp.both_built(lambda pkg: cf.build_greedy_decoder(pkg, V, D))
    r = np.random.RandomState(0)
    feed = {"src": r.randint(0, V, (B, 7)).astype(np.int64),
            "src@LEN": np.array([7, 3, 5, 1, 6], np.int32),
            "limit": np.array([steps], np.int64)}
    out = {}
    for name, pkg in (("jax", pt), ("torch", ptt)):
        main, v, scope = m[name]
        out[name] = [np.asarray(a) for a in _run(
            pkg, main, feed, [v["ids"], v["tops"], v["steps"], v["length"]],
            scope)]
    (ids, tops, i, length), (jids, jtops, ji, jlength) = \
        out["torch"], out["jax"]
    assert ids.shape == (128, B) and tops.shape == (128, B, 2)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(tops, jtops, **PROG_TOL)
    assert int(i[0]) == int(ji[0]) == steps
    assert int(length) == int(jlength) == 128
    assert not ids[steps + 1:].any() and ids[1:steps + 1].any()


def _switch(pkg):
    """A Switch over x: case x < 3 sets out to 1, case x > 1 multiplies
    out by 10, the default adds 100.  The cases are not exclusive and
    the default always runs last, in both packages (ROADMAP Queue C)."""
    main, startup = _fresh(pkg)
    with pkg.program_guard(main, startup):
        L = pkg.layers
        x = L.data("x", shape=[1], dtype="float32", append_batch_size=False)
        out = L.fill_constant([1], "float32", 0.0)

        def c(v):
            return L.fill_constant([1], "float32", v)

        with L.Switch() as sw:
            with sw.case(L.less_than(x, c(3.0))):
                L.assign(c(1.0), output=out)
            with sw.case(L.less_than(c(1.0), x)):
                L.assign(L.scale(out, scale=10.0), output=out)
            with sw.default():
                L.assign(L.elementwise_add(out, c(100.0)), output=out)
    return main, startup, {"out": out}


@pytest.mark.parametrize("x,want", [(0.0, 101.0), (2.0, 110.0),
                                    (5.0, 100.0)])
def test_switch_cases_overlap_and_the_default_runs_last(x, want):
    got = {}
    for name, pkg in (("jax", pt), ("torch", ptt)):
        main, _, v = _switch(pkg)
        scope = pkg.core.Scope() if pkg is pt else ptt.Scope()
        got[name] = float(_run(pkg, main, {"x": np.float32([x])},
                               [v["out"]], scope)[0][0])
    assert got["torch"] == got["jax"] == want


def test_dynamic_rnn_over_a_rank_table_trains_as_the_reference():
    """The DynamicRNN classifier (rank table, reorder, gru_unit steps,
    IfElse head) over ragged lengths with ties, 2 Momentum steps from
    the JAX weights: losses, rank tables and logits, then every
    parameter and velocity, within ``PROG_TOL``."""
    V, E, H, C, B, T = 50, 8, 6, 3, 6, 7
    m = tp.both_built(lambda pkg: cf.build_drnn_classifier(pkg, V, E, H, C,
                                                           lr=0.1))
    r = np.random.RandomState(1)
    feed = {"words": r.randint(0, V, (B, T)).astype(np.int64),
            "words@LEN": np.array([7, 2, 5, 5, 1, 3], np.int32),
            "label": r.randint(0, C, (B, 1)).astype(np.int64)}
    jexe, texe = pt.Executor(pt.CPUPlace()), ptt.Executor(ptt.CPUPlace())
    (jm, jv, js), (tm, tv, ts) = m["jax"], m["torch"]
    fetch = ("loss", "rank", "logits")
    for _ in range(2):
        jo = jexe.run(jm, feed=feed, fetch_list=[jv[k] for k in fetch],
                      scope=js)
        to = texe.run(tm, feed=feed, fetch_list=[tv[k] for k in fetch],
                      scope=ts)
        np.testing.assert_array_equal(to[1], [0, 2, 3, 5, 1, 4])
        for a, b in zip(to, jo):
            np.testing.assert_allclose(np.asarray(a, np.float64),
                                       np.asarray(b, np.float64), **PROG_TOL)
    assert sorted(ts.keys()) == sorted(js.keys())
    for k in js.keys():
        np.testing.assert_allclose(ts.numpy(k), js.numpy(k), err_msg=k,
                                   **PROG_TOL)


def _cond_grad(pkg):
    """w [3] (ones); out = 2 w, or log(w * 0) where the fed flag is
    negative (a conditional_block); loss mean(out), SGD(1)."""
    main, startup = _fresh(pkg)
    with pkg.program_guard(main, startup):
        L = pkg.layers
        w = pkg.layer_helper.LayerHelper("w").create_parameter(
            pkg.ParamAttr(name="w",
                          initializer=pkg.initializer.Constant(1.0)),
            shape=[3], dtype="float32")
        flag = L.data("flag", shape=[1], dtype="float32",
                      append_batch_size=False)
        out = L.scale(w, scale=2.0)
        cond = L.less_than(flag, L.fill_constant([1], "float32", 0.0))
        with L.ConditionalBlock([cond]).block():
            L.assign(L.log(L.scale(w, scale=0.0)), output=out)
        loss = L.mean(out)
        pkg.optimizer.SGD(learning_rate=1.0).minimize(loss)
    return main, startup, {"loss": loss, "w": w}


@pytest.mark.parametrize("flag", [1.0, -1.0], ids=["untaken", "taken"])
def test_conditional_block_differentiates_only_the_taken_branch(flag):
    """Untaken, the log(0) branch leaves the gradient 2/3 (computing both
    branches and selecting would give 0 * inf = NaN); taken, the loss is
    -inf and its gradient inf, as in the JAX package."""
    m = tp.both_built(_cond_grad)
    feed = {"flag": np.float32([flag])}
    got = {}
    for name, pkg in (("jax", pt), ("torch", ptt)):
        main, v, scope = m[name]
        loss, = _run(pkg, main, feed, [v["loss"]], scope)
        got[name] = (float(np.asarray(loss)), scope.numpy("w"))
    assert got["torch"][0] == got["jax"][0]
    np.testing.assert_array_equal(got["torch"][1], got["jax"][1])
    if flag > 0:
        assert got["torch"][0] == 2.0
        np.testing.assert_allclose(got["torch"][1], 1.0 - 2.0 / 3.0,
                                   rtol=1e-6)
    else:
        assert got["torch"][0] == -np.inf


def _while_grad(pkg):
    """A While whose carry grows from a parameter: out = w, doubled until
    the counter reaches 3; minimized."""
    main, startup = _fresh(pkg)
    with pkg.program_guard(main, startup):
        L = pkg.layers
        w = pkg.layer_helper.LayerHelper("w").create_parameter(
            pkg.ParamAttr(name="w"), shape=[3], dtype="float32")
        out = L.scale(w, scale=1.0)
        i = L.fill_constant([1], "int64", 0)
        limit = L.fill_constant([1], "int64", 3)
        cond = L.less_than(i, limit)
        loop = L.While(cond)
        with loop.block():
            L.assign(L.scale(out, scale=2.0), output=out)
            L.increment(i, 1.0)
            L.less_than(i, limit, cond=cond)
        loss = L.mean(out)
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("pkg", [pt, ptt], ids=["jax", "torch"])
def test_gradient_through_while_is_refused(pkg):
    """Reverse mode through a loop whose trip count is data: the JAX
    package's lax.while_loop refuses it, and the port refuses it too,
    naming the op (ROADMAP Queue C)."""
    main, startup, loss = _while_grad(pkg)
    scope = pkg.core.Scope() if pkg is pt else ptt.Scope()
    exe = pkg.Executor(pkg.CPUPlace())
    exe.run(startup, scope=scope)
    match = "while_loop" if pkg is pt else "while: reverse-mode"
    with pytest.raises(Exception, match=match):
        exe.run(main, fetch_list=[loss], scope=scope)


def test_print_prints_at_every_iteration(capfd):
    """``print`` inside a While prints at each of its iterations, as the
    JAX package's jax.debug.print does: the same lines."""
    out = {}
    for name, pkg in (("jax", pt), ("torch", ptt)):
        main, _, v = _while_sum(pkg, body_print=True)
        scope = pkg.core.Scope() if pkg is pt else ptt.Scope()
        capfd.readouterr()
        _run(pkg, main, {}, [v["total"]], scope)
        out[name] = capfd.readouterr().out.splitlines()
    assert out["torch"] == [f"total [{k}.]" for k in range(1, 6)]
    assert out["torch"] == out["jax"]


# ---------------------------------------------------------------------------
# the executor's uncaptured route
# ---------------------------------------------------------------------------
def _print_in_rnn():
    """A StaticRNN whose step block (not the global block) prints."""
    main, startup = _fresh(ptt)
    with ptt.program_guard(main, startup):
        L = ptt.layers
        seq = L.data("seq", shape=[2], dtype="float32", lod_level=1)
        rnn = L.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(seq)
            h = rnn.memory(shape=[2])
            h2 = L.elementwise_add(h, x_t)
            ptt.layer_helper.LayerHelper("print").append_op(
                type="print", inputs={"In": [h2]}, outputs={},
                attrs={"message": "h"})
            rnn.update_memory(h, h2)
            rnn.output(h2)
        out = rnn()
    return main, {"out": out}


def test_uncaptured_op_is_found_in_any_block_and_memoized():
    assert UNCAPTURED_OPS == ("while", "conditional_block", "print")
    main, _, _ = _while_sum(ptt)
    assert uncaptured_op(main) == "while"
    main, _, _ = _switch(ptt)
    assert uncaptured_op(main) == "conditional_block"
    main, _ = _print_in_rnn()
    assert main.global_block().ops[-1].type == "rnn"
    assert uncaptured_op(main) == "print"
    # a new op bumps the program's version, and the scan runs again
    main, _, _ = _ifelse(ptt)
    assert uncaptured_op(main) is None
    main.global_block().append_op("print", {"In": ["x"]}, {},
                                  {"message": ""})
    assert uncaptured_op(main) == "print"


@pytest.mark.parametrize("build", ["ifelse", "drnn", "arrays"])
def test_capturable_control_flow_keeps_no_reason(build):
    """IfElse (a where), DynamicRNN (the rnn op) and the array and rank
    table ops hold no op of ``UNCAPTURED_OPS``: on a card they capture;
    here they run interpreted only because the place is the CPU."""
    if build == "ifelse":
        main = _ifelse(ptt)[0]
    elif build == "drnn":
        main = cf.build_drnn_classifier(ptt, 20, 4, 3, 2)[0]
    else:
        main, startup = _fresh(ptt)
        with ptt.program_guard(main, startup):
            L = ptt.layers
            x = L.data("x", shape=[4, 2], dtype="float32", lod_level=1)
            i = L.fill_constant([1], "int64", 1)
            arr = L.array_write(x, i)
            L.array_length(arr)
            L.array_read(arr, i)
            rank = L.lod_rank_table(x)
            L.reorder_lod_tensor_by_rank(x, rank)
            L.array_to_lod_tensor(L.lod_tensor_to_array(x, rank), rank)
    assert uncaptured_op(main) is None
    exe = ptt.Executor(ptt.CPUPlace())
    assert exe._uncaptured_reason(main, False) == "cpu"
    gpu = ptt.Executor.__new__(ptt.Executor)
    gpu.device, gpu.use_jit = torch.device("cuda", 0), True
    assert ptt.Executor._uncaptured_reason(gpu, main, False) is None
    gpu.use_jit = False
    assert ptt.Executor._uncaptured_reason(gpu, main, False) == \
        "use_jit=False"


def test_uncaptured_steps_are_counted_under_their_op():
    """A While program counts under ``while`` on any device, before the
    place and use_jit are asked: one a ``run``, K a ``run_steps(K)``;
    a Switch under ``conditional_block``; an IfElse program under
    ``cpu`` here."""
    stats = compile_cache.stats()
    stats.reset()
    main, _, v = _while_sum(ptt)
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    exe.run(main, fetch_list=[v["total"]], scope=scope)
    out = exe.run_steps(3, main, fetch_list=[v["total"]], scope=scope)
    assert np.asarray(out[0]).reshape(-1).tolist() == [5.0, 5.0, 5.0]
    assert stats.snapshot()["uncaptured"] == {"while": 4}
    main, _, v = _switch(ptt)
    exe.run(main, feed={"x": np.float32([2.0])}, fetch_list=[v["out"]],
            scope=ptt.Scope())
    main, _, v = _ifelse(ptt)
    exe.run(main, feed={"x": np.float32([[1.0]])}, fetch_list=[v["out"]],
            scope=ptt.Scope())
    assert stats.snapshot()["uncaptured"] == {
        "while": 4, "conditional_block": 1, "cpu": 1}


def test_compile_takes_the_uncaptured_route():
    """``Executor.compile`` of a While program captures nothing: the
    handle names the op (``step.uncaptured``), its listing puts the op
    on the ``host`` route, and its runs count under the op."""
    stats = compile_cache.stats()
    stats.reset()
    main, _, v = _while_sum(ptt)
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    cp = exe.compile(main, fetch_list=[v["total"]], scope=scope)
    assert cp.step.uncaptured == "while"
    routes = {r["op"]: r["route"] for r in cp.step.listing}
    assert routes["while"] == "host" and routes["less_than"] == "other"
    assert float(cp.run(scope=scope)[0][0]) == 5.0
    snap = stats.snapshot()
    assert snap["uncaptured"] == {"while": 1} and not snap["captures"]
    main, _, v = _ifelse(ptt)
    cp = exe.compile(main, feed={"x": np.float32([[1.0]])},
                     fetch_list=[v["out"]], scope=ptt.Scope())
    assert cp.step.uncaptured == "cpu"


@pytest.mark.parametrize("build", ["while", "switch"])
def test_export_refuses_host_read_control_flow(build, tmp_path):
    from paddle_tpu_torch.export_model import export_compiled_model
    if build == "while":
        main, _, v = _while_sum(ptt)
        target, op = v["total"], "while"
    else:
        main, _, v = _switch(ptt)
        target, op = v["out"], "conditional_block"
    feeds = {"x": ((1,), "float32")} if build == "switch" else {}
    with pytest.raises(ValueError, match=repr(op)):
        export_compiled_model(str(tmp_path), feeds, [target],
                              main_program=main, scope=ptt.Scope(),
                              device="cpu")


@pytest.mark.parametrize("warmup,k", [(False, 1), (True, 2)])
def test_trainer_takes_the_uncaptured_route(warmup, k):
    """``trainer.SGD.train`` over a program whose loss passes a
    conditional_block (taken: the fed flag is negative) runs its steps
    uncaptured and counts them under the op, with and without its
    compile warm-up and over stacked dispatches, and its losses are the
    JAX trainer's on the same weights."""
    rows = [(np.float32(np.random.RandomState(i).randn(4)),
             np.float32([i % 3]), np.float32([-1.0])) for i in range(8)]
    losses = {}
    init = None
    for name, pkg in (("jax", pt), ("torch", ptt)):
        tp.reset_both()
        L = pkg.layers
        x = L.data("x", shape=[4], dtype="float32")
        y = L.data("y", shape=[1], dtype="float32")
        flag = L.data("flag", shape=[1], dtype="float32")
        out = L.fc(x, size=1)
        cond = L.less_than(L.reduce_sum(flag), L.fill_constant(
            [1], "float32", 0.0))
        with L.ConditionalBlock([cond]).block():
            L.assign(L.scale(out, scale=2.0), output=out)
        loss = L.mean(L.square_error_cost(out, y))
        kw = {} if pkg is pt else {"place": ptt.CPUPlace()}
        tr = pkg.trainer.SGD(loss, update_equation=pkg.optimizer.SGD(0.1),
                             **kw)
        if pkg is pt:
            pkg.default_startup_program().random_seed = 3
            tr.exe.run(pkg.default_startup_program(), feed={},
                       fetch_list=[])
            init = tp.jax_state(pt.global_scope())
        else:
            ptt.load_numpy_state(ptt.global_scope(), init, "cpu")
            compile_cache.stats().reset()
        tr._initialized = True
        got = losses.setdefault(name, [])

        def handler(e, got=got, pkg=pkg):
            if isinstance(e, pkg.trainer.events.EndIteration):
                got.append(float(e.cost))

        def reader():
            for i in range(0, len(rows), 2):
                yield rows[i:i + 2]
        tr.train(reader, num_passes=1, event_handler=handler,
                 feed_list=[x, y, flag], warmup=warmup and pkg is ptt,
                 steps_per_dispatch=k)
    assert compile_cache.stats().snapshot()["uncaptured"] == \
        {"conditional_block": 4}
    np.testing.assert_allclose(losses["torch"], losses["jax"], **PROG_TOL)
    assert len(losses["torch"]) == 4
