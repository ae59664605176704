"""The learning-rate schedules of the port (``paddle_tpu_torch/lr_decay.py``
and the ops they build: ``exp``, ``log``, ``floor``, ``ceil``,
``reciprocal``, ``cast``, ``pow``, ``less_than`` and
``layers.autoincreased_step_counter``) against the JAX package's.

Each schedule builds the same program JSON in both packages, and the
rate fetched over 12 steps agrees within 1e-6 relative in fp32 (mirror
of ``tests/test_ops_misc.py:217``).  Under the executor's AMP, the
schedule's ops run inside the bf16 forward in both packages; the rate
and one Momentum update (fp32 master weights, bf16 copies of the
velocity) agree within 1e-6 relative, which is what the AMP rule of the
port's training tests asks of an update computed in fp32 from the same
bf16 operands."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.core.registry import get_op_impl as jax_impl
from paddle_tpu_torch.core.registry import get_op_impl as torch_impl

STEPS = 12
RTOL = 1e-6

SCHEDULES = [
    ("exponential_decay", dict(learning_rate=0.1, decay_steps=3,
                               decay_rate=0.5, staircase=False)),
    ("exponential_decay", dict(learning_rate=0.1, decay_steps=3,
                               decay_rate=0.5, staircase=True)),
    ("natural_exp_decay", dict(learning_rate=0.1, decay_steps=4,
                               decay_rate=0.3, staircase=False)),
    ("natural_exp_decay", dict(learning_rate=0.1, decay_steps=4,
                               decay_rate=0.3, staircase=True)),
    ("inverse_time_decay", dict(learning_rate=0.2, decay_steps=2,
                                decay_rate=0.7, staircase=False)),
    ("inverse_time_decay", dict(learning_rate=0.2, decay_steps=2,
                                decay_rate=0.7, staircase=True)),
    ("polynomial_decay", dict(learning_rate=0.1, decay_steps=7,
                              end_learning_rate=1e-3, power=2.0,
                              cycle=False)),
    ("polynomial_decay", dict(learning_rate=0.1, decay_steps=5,
                              end_learning_rate=1e-3, power=1.5,
                              cycle=True)),
    ("piecewise_decay", dict(boundaries=[3, 6, 9],
                             values=[0.1, 0.05, 0.01, 0.001])),
    ("noam_decay", dict(d_model=64, warmup_steps=4)),
    ("v1_poly_decay", dict(learning_rate=0.1, decay_a=0.01, decay_b=0.75,
                           batch_size=8)),
]
IDS = [f"{n}{i}" for i, (n, _) in enumerate(SCHEDULES)]


def closed_form(name, kw, step):
    """The schedule's value at ``step`` in float64."""
    if name in ("exponential_decay", "natural_exp_decay",
                "inverse_time_decay"):
        div = step / kw["decay_steps"]
        if kw["staircase"]:
            div = np.floor(div)
        lr, r = kw["learning_rate"], kw["decay_rate"]
        return {"exponential_decay": lr * r ** div,
                "natural_exp_decay": lr * np.exp(-r * div),
                "inverse_time_decay": lr / (1 + r * div)}[name]
    if name == "polynomial_decay":
        steps = kw["decay_steps"]
        gs = step
        if kw["cycle"]:
            steps = steps * max(np.ceil(step / steps), 1.0)
        else:
            gs = min(step, steps)
        end = kw["end_learning_rate"]
        return (kw["learning_rate"] - end) * (1 - gs / steps) \
            ** kw["power"] + end
    if name == "piecewise_decay":
        for b, v in zip(kw["boundaries"], kw["values"]):
            if step < b:
                return v
        return kw["values"][-1]
    if name == "noam_decay":
        gs = max(step, 1.0)
        return kw["d_model"] ** -0.5 * min(gs ** -0.5,
                                           gs * kw["warmup_steps"] ** -1.5)
    if name == "v1_poly_decay":
        return kw["learning_rate"] * (
            1 + kw["decay_a"] * step * kw["batch_size"]) ** -kw["decay_b"]
    raise KeyError(name)


def build(pkg, name, kw, opt="SGD"):
    """(main, startup, lr, loss): a one-layer regression whose optimizer
    takes the schedule's rate."""
    pkg.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[4], dtype="float32")
        y = pkg.layers.data("y", shape=[1], dtype="float32")
        pred = pkg.layers.fc(x, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        lr = getattr(pkg.lr_decay, name)(**kw)
        if opt == "SGD":
            pkg.optimizer.SGD(learning_rate=lr).minimize(loss)
        else:
            pkg.optimizer.Momentum(learning_rate=lr,
                                   momentum=0.9).minimize(loss)
    return main, startup, lr, loss


def carry(jscope, main):
    """A port scope holding the JAX scope's values, each in the dtype
    the program declares (JAX keeps an int64 var as int32 with x64
    off)."""
    tscope = ptt.Scope()
    gb = main.global_block()
    for k in jscope.keys():
        arr = np.asarray(jscope.numpy(k))
        if gb.has_var(k):
            arr = arr.astype(gb.var(k).dtype)
        tscope.set(k, torch.from_numpy(np.array(arr)))
    return tscope


def feeds(seed=3):
    r = np.random.RandomState(seed)
    return {"x": r.rand(8, 4).astype("float32"),
            "y": r.rand(8, 1).astype("float32")}


@pytest.mark.parametrize("name,kw", SCHEDULES, ids=IDS)
def test_schedule_matches_jax(name, kw):
    jm, js, jlr, _ = build(pt, name, kw)
    tm, ts, tlr, _ = build(ptt, name, kw)
    assert tm.to_dict() == jm.to_dict()
    jscope = pt.core.Scope()
    jexe = pt.Executor(pt.CPUPlace())
    jexe.run(js, scope=jscope)
    tscope = carry(jscope, tm)
    texe = ptt.Executor(ptt.CPUPlace())
    f = feeds()
    jl = [float(jexe.run(jm, feed=f, fetch_list=[jlr], scope=jscope)[0][0])
          for _ in range(STEPS)]
    tl = [float(texe.run(tm, feed=f, fetch_list=[tlr], scope=tscope)[0][0])
          for _ in range(STEPS)]
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=0)
    want = [closed_form(name, kw, s) for s in range(STEPS)]
    np.testing.assert_allclose(tl, want, rtol=RTOL, atol=0)
    counter = tscope.get("@STEP_COUNTER@")
    assert counter.dtype == torch.int64 and int(counter[0]) == STEPS - 1


@pytest.mark.parametrize("name,kw", [SCHEDULES[1], SCHEDULES[8]],
                         ids=["exponential_staircase", "piecewise"])
def test_schedule_under_amp_with_momentum_matches_jax(name, kw):
    """The AMP rule: the schedule's ops run before the backward op, in
    the bf16 forward; the rate stays fp32 (it starts from the int
    counter), and the Momentum update is computed in fp32 from the bf16
    copy of the velocity in both packages."""
    jm, js, jlr, jloss = build(pt, name, kw, opt="Momentum")
    tm, ts, tlr, tloss = build(ptt, name, kw, opt="Momentum")
    jscope = pt.core.Scope()
    jexe = pt.Executor(pt.CPUPlace(), amp=True)
    pt.Executor(pt.CPUPlace()).run(js, scope=jscope)
    tscope = carry(jscope, tm)
    texe = ptt.Executor(ptt.CPUPlace(), amp=True)
    params = [p.name for p in tm.all_parameters()]
    before = {p: tscope.numpy(p).copy() for p in params}
    f = feeds()
    for step in range(4):
        jout = jexe.run(jm, feed=f, fetch_list=[jlr, jloss], scope=jscope)
        tout = texe.run(tm, feed=f, fetch_list=[tlr, tloss], scope=tscope)
        assert tout[0].dtype == np.float32
        np.testing.assert_allclose(tout[0], jout[0], rtol=RTOL, atol=0)
        np.testing.assert_allclose(tout[1], jout[1], rtol=2e-2)
        if step == 0:
            for p in params:
                dj = jscope.numpy(p) - before[p]
                dt = tscope.numpy(p) - before[p]
                np.testing.assert_allclose(dt, dj, rtol=0,
                                           atol=5e-2 * np.abs(dj).max())


UNARY = ["exp", "log", "floor", "ceil", "reciprocal"]


@pytest.mark.parametrize("op", UNARY)
def test_schedule_unary_ops_match_jax(op):
    x = np.random.RandomState(5).rand(3, 5).astype("float32") * 4 + 0.25
    j = jax_impl(op)(None, {"X": [jnp.asarray(x)]}, {})["Out"]
    t = torch_impl(op)(None, {"X": [torch.from_numpy(x)]}, {})["Out"]
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=0)


@pytest.mark.parametrize("dtype,out", [("int64", "float32"),
                                       ("float32", "int32"),
                                       ("bool", "float32")])
def test_cast_matches_jax(dtype, out):
    x = (np.arange(6) * 1.7 - 3).astype(dtype)
    attrs = {"out_dtype": out}
    j = jax_impl("cast")(None, {"X": [jnp.asarray(x)]}, attrs)["Out"]
    t = torch_impl("cast")(None, {"X": [torch.from_numpy(x)]}, attrs)["Out"]
    assert str(t.dtype).replace("torch.", "") == out
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("factor", [2.0, -0.5, 1.5])
def test_pow_matches_jax(factor):
    x = np.random.RandomState(6).rand(4, 3).astype("float32") + 0.5
    attrs = {"factor": factor}
    j = jax_impl("pow")(None, {"X": [jnp.asarray(x)]}, attrs)["Out"]
    t = torch_impl("pow")(None, {"X": [torch.from_numpy(x)]}, attrs)["Out"]
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=0)


def test_less_than_matches_jax():
    r = np.random.RandomState(8)
    x, y = r.rand(4, 3).astype("float32"), r.rand(3).astype("float32")
    ins_j = {"X": [jnp.asarray(x)], "Y": [jnp.asarray(y)]}
    ins_t = {"X": [torch.from_numpy(x)], "Y": [torch.from_numpy(y)]}
    j = jax_impl("less_than")(None, ins_j, {"axis": 1})["Out"]
    t = torch_impl("less_than")(None, ins_t, {"axis": 1})["Out"]
    assert t.dtype == torch.bool
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_step_counter_is_shared_and_starts_at_begin():
    """A second call returns the same counter; one increment op a run,
    and the counter's value at the first run is ``begin``."""
    for pkg in (pt, ptt):
        pkg.unique_name.reset()
    progs = {}
    for pkg in (pt, ptt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            a = pkg.layers.autoincreased_step_counter(begin=5, step=2)
            b = pkg.layers.autoincreased_step_counter(begin=5, step=2)
            assert a is b
        progs[pkg] = (main, startup, a)
    assert progs[ptt][0].to_dict() == progs[pt][0].to_dict()
    assert progs[ptt][1].to_dict() == progs[pt][1].to_dict()
    main, startup, a = progs[ptt]
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    got = [int(exe.run(main, fetch_list=[a], scope=scope)[0][0])
           for _ in range(3)]
    assert got == [5, 7, 9]
