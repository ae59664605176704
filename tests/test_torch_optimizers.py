"""The port's remaining optimizers against the JAX package's: the eight
ops (``adamax``, ``adagrad``, ``adadelta``, ``decayed_adagrad``,
``rmsprop``, ``ftrl``, ``proximal_gd``, ``proximal_adagrad``) on the
same inputs (fp32 within 1e-6 of each output's largest magnitude,
mirroring ``tests/test_ops_optimizer.py``; with the bf16 accumulators and rate
that AMP hands them, also for ``momentum`` and ``adam``, the same
dtypes out and values within 1e-6 of the largest magnitude: a constant
meeting a bf16 accumulator is rounded to bf16 first in both packages,
JAX's weak typing); each optimizer class minimizing ``models.mnist.mlp`` for 3 steps
in both packages (fp32: losses within 1e-5 relative, parameters within
1e-5; AMP: by the seq2seq tests' rule, losses within 2e-2 relative and
the first step's gradients within 5e-2 of their largest magnitude; the
adaptive updates normalize each entry by its own history, so an entry
whose bf16 gradient is noise moves by about the rate either way, and
the update from given operands is what the AMP op test holds);
``ModelAverage`` and ``StaticPruningHook`` against the JAX ones (1e-6); the Variable
arithmetic sugar building the same program as the JAX package; and
``framework``'s names."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.core.registry import get_op_impl as jax_impl
from paddle_tpu_torch.core.registry import get_op_impl as torch_impl

R = np.random.RandomState(17)
N = (4, 3)


def _u(lo=-1.0, hi=1.0, shape=N):
    return R.uniform(lo, hi, shape).astype("float32")


def _op_case(op):
    """(inputs, attrs) of one op, accumulators in their valid ranges."""
    base = {"Param": _u(), "Grad": _u(),
            "LearningRate": np.array([0.1], "float32")}
    extra, attrs = {
        "adamax": ({"Moment": _u(), "InfNorm": _u(0.1, 1.0),
                    "Beta1Pow": np.array([0.9 ** 3], "float32")},
                   {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
        "adagrad": ({"Moment": _u(0.0, 1.0)}, {"epsilon": 1e-6}),
        "adadelta": ({"AvgSquaredGrad": _u(0.0, 1.0),
                      "AvgSquaredUpdate": _u(0.0, 1.0)},
                     {"rho": 0.95, "epsilon": 1e-6}),
        "decayed_adagrad": ({"Moment": _u(0.0, 1.0)},
                            {"decay": 0.95, "epsilon": 1e-6}),
        "rmsprop": ({"MeanSquare": _u(0.0, 1.0), "Moment": _u()},
                    {"decay": 0.9, "momentum": 0.5, "epsilon": 1e-6}),
        "ftrl": ({"SquaredAccumulator": _u(0.1, 1.0),
                  "LinearAccumulator": _u()},
                 {"l1": 0.1, "l2": 0.2, "lr_power": -0.5}),
        "proximal_gd": ({}, {"l1": 0.05, "l2": 0.1}),
        "proximal_adagrad": ({"Moment": _u(0.1, 1.0)},
                             {"l1": 0.05, "l2": 0.1}),
        "momentum": ({"Velocity": _u()}, {"mu": 0.9}),
        "adam": ({"Moment1": _u(), "Moment2": _u(0.0, 1.0),
                  "Beta1Pow": np.array([0.9 ** 3], "float32"),
                  "Beta2Pow": np.array([0.999 ** 3], "float32")},
                 {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    }[op]
    base.update(extra)
    return base, attrs


OPS = ["adamax", "adagrad", "adadelta", "decayed_adagrad", "rmsprop",
       "ftrl", "proximal_gd", "proximal_adagrad"]
STATE = {"Param", "Grad"}


def _run_both(op, ins, attrs):
    j = jax_impl(op)(None, {k: [jnp.asarray(v)] for k, v in ins.items()},
                     dict(attrs))
    t = torch_impl(op)(None, {k: [torch.from_numpy(np.array(v))]
                              for k, v in ins.items()}, dict(attrs))
    assert sorted(j) == sorted(t)
    return j, t


@pytest.mark.parametrize("op", OPS)
def test_op_matches_jax(op):
    ins, attrs = _op_case(op)
    j, t = _run_both(op, ins, attrs)
    _close(j, t)


def _close(j, t):
    """Each output within 1e-6 of its largest magnitude (ftrl's linear
    accumulator subtracts nearly equal terms, so a one-ulp difference of
    pow between the libraries shows relative to a small entry)."""
    for k in j:
        want = np.asarray(j[k])
        np.testing.assert_allclose(t[k].numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=k)


@pytest.mark.parametrize("op", ["proximal_gd", "proximal_adagrad", "ftrl"])
def test_op_without_l1_matches_jax(op):
    ins, attrs = _op_case(op)
    j, t = _run_both(op, ins, dict(attrs, l1=0.0))
    _close(j, t)


@pytest.mark.parametrize("op", OPS + ["momentum", "adam"])
def test_op_on_amp_operands_matches_jax(op):
    """What the AMP step hands an optimizer op: fp32 param and gradient,
    bf16 copies of the accumulators and of a persistable rate."""
    ins, attrs = _op_case(op)
    jins = {k: jnp.asarray(v) if k in STATE else
            jnp.asarray(v).astype(jnp.bfloat16) for k, v in ins.items()}
    tins = {k: torch.from_numpy(np.array(v)) if k in STATE else
            torch.from_numpy(np.array(v)).to(torch.bfloat16)
            for k, v in ins.items()}
    j = jax_impl(op)(None, {k: [v] for k, v in jins.items()}, dict(attrs))
    t = torch_impl(op)(None, {k: [v] for k, v in tins.items()}, dict(attrs))
    for k in j:
        assert str(t[k].dtype).replace("torch.", "") == str(j[k].dtype), k
        want = np.asarray(j[k].astype(jnp.float32))
        np.testing.assert_allclose(t[k].float().numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=k)


# ---------------------------------------------------------------------------
# The optimizer classes on a model
# ---------------------------------------------------------------------------
CLASSES = [("Adagrad", dict(learning_rate=0.05)),
           ("Adamax", dict(learning_rate=0.01)),
           ("DecayedAdagrad", dict(learning_rate=0.05)),
           ("Adadelta", dict(learning_rate=1.0, rho=0.9)),
           ("RMSProp", dict(learning_rate=0.01, momentum=0.5)),
           ("Ftrl", dict(learning_rate=0.05, l1=0.01, l2=0.01))]


def build_mlp(pkg, opt_name, kw, seed=0):
    pkg.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = seed
    with pkg.program_guard(main, startup):
        img = pkg.layers.data("img", [1, 8, 8])
        label = pkg.layers.data("label", [1], dtype="int64")
        pred = pkg.models.mnist.mlp(img, hidden_sizes=(16, 12),
                                    num_classes=10)
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
        opt = getattr(pkg.optimizer, opt_name)(**kw)
        opt.minimize(loss)
    return main, startup, loss


def carry(jscope, main):
    tscope = ptt.Scope()
    gb = main.global_block()
    for k in jscope.keys():
        arr = np.asarray(jscope.numpy(k))
        if gb.has_var(k):
            arr = arr.astype(gb.var(k).dtype)
        tscope.set(k, torch.from_numpy(np.array(arr)))
    return tscope


def _feed(seed=2, batch=8):
    r = np.random.RandomState(seed)
    return {"img": r.rand(batch, 1, 8, 8).astype("float32"),
            "label": r.randint(0, 10, (batch, 1)).astype("int64")}


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
@pytest.mark.parametrize("name,kw", CLASSES, ids=[c[0] for c in CLASSES])
def test_optimizer_class_matches_jax(name, kw, amp):
    jm, js, jl = build_mlp(pt, name, kw)
    tm, ts, tl = build_mlp(ptt, name, kw)
    assert tm.to_dict() == jm.to_dict()
    jscope = pt.core.Scope()
    pt.Executor(pt.CPUPlace()).run(js, scope=jscope)
    tscope = carry(jscope, tm)
    jexe = pt.Executor(pt.CPUPlace(), amp=amp)
    texe = ptt.Executor(ptt.CPUPlace(), amp=amp)
    params = [p.name for p in tm.all_parameters()]
    grads = [p + "@GRAD" for p in params]
    for step in range(3):
        f = _feed(step)
        jo = jexe.run(jm, feed=f, fetch_list=[jl] + grads, scope=jscope)
        to = texe.run(tm, feed=f, fetch_list=[tl] + grads, scope=tscope)
        np.testing.assert_allclose(to[0], jo[0],
                                   rtol=2e-2 if amp else 1e-5)
        for g, a, b in zip(grads, to[1:], jo[1:]):
            b = np.asarray(b)
            assert a.dtype == b.dtype == np.float32
            if amp and step > 0:
                continue          # from weights that differ already
            np.testing.assert_allclose(
                a, b, rtol=0 if amp else 1e-4,
                atol=(5e-2 if amp else 1e-5) * np.abs(b).max(), err_msg=g)
    for p in params:
        assert tscope.get(p).dtype == torch.float32
        if not amp:
            np.testing.assert_allclose(tscope.numpy(p), jscope.numpy(p),
                                       rtol=1e-5, atol=1e-6, err_msg=p)
    # the accumulators carry the JAX names (a checkpoint carries across)
    assert sorted(tscope.keys()) == sorted(jscope.keys())


# ---------------------------------------------------------------------------
# ModelAverage and StaticPruningHook
# ---------------------------------------------------------------------------
def _both_defaults(name="SGD", kw=None):
    """The mlp in both packages' default programs and global scopes, the
    JAX startup's weights in both."""
    kw = kw or {"learning_rate": 0.1}
    out = {}
    for pkg in (pt, ptt):
        pkg.core.reset_default_programs()
        pkg.core.reset_global_scope()
        pkg.unique_name.reset()
        img = pkg.layers.data("img", [1, 8, 8])
        label = pkg.layers.data("label", [1], dtype="int64")
        pred = pkg.models.mnist.mlp(img, hidden_sizes=(16, 12))
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
        getattr(pkg.optimizer, name)(**kw).minimize(loss)
        out[pkg] = loss
    return out


def _init_both(jexe):
    jexe.run(pt.default_startup_program(), feed={}, fetch_list=[])
    src = carry(pt.global_scope(), ptt.default_main_program())
    for k in src.keys():
        ptt.global_scope().set(k, src.get(k))


def test_model_average_matches_jax():
    losses = _both_defaults()
    jexe, texe = pt.Executor(pt.CPUPlace()), ptt.Executor(ptt.CPUPlace())
    _init_both(jexe)
    jma = pt.optimizer.ModelAverage(average_window_rate=0.5,
                                    min_average_window=2)
    tma = ptt.optimizer.ModelAverage(average_window_rate=0.5,
                                     min_average_window=2)
    for step in range(5):
        f = _feed(step)
        jexe.run(feed=f, fetch_list=[losses[pt]])
        texe.run(feed=f, fetch_list=[losses[ptt]])
        jma.update()
        tma.update()
    assert sorted(tma._avg) == sorted(jma._avg) and tma._avg
    for n in jma._avg:
        np.testing.assert_allclose(tma._avg[n], jma._avg[n], rtol=1e-6,
                                   atol=1e-7)
    scope = ptt.global_scope()
    trained = {n: scope.numpy(n).copy() for n in tma._avg}
    with tma.apply():
        for n in tma._avg:
            np.testing.assert_array_equal(scope.numpy(n), tma._avg[n])
            assert scope.get(n).dtype == torch.float32
        # a run sees the averaged weights
        out = texe.run(ptt.default_main_program().clone(for_test=True),
                       feed=_feed(9), fetch_list=[losses[ptt]],
                       is_test=True)
        assert np.isfinite(out[0]).all()
    for n in tma._avg:
        np.testing.assert_array_equal(scope.numpy(n), trained[n])


def test_static_pruning_hook_matches_jax():
    losses = _both_defaults("Momentum", {"learning_rate": 0.1,
                                         "momentum": 0.9})
    names = [p.name for p in ptt.default_main_program().all_parameters()
             if p.name.endswith("w_0")][:2]
    hooks = {pt: pt.optimizer.StaticPruningHook(0.6).attach(names),
             ptt: ptt.optimizer.StaticPruningHook(0.6).attach(names)}
    assert ptt.default_main_program().to_dict() == \
        pt.default_main_program().to_dict()
    jexe, texe = pt.Executor(pt.CPUPlace()), ptt.Executor(ptt.CPUPlace())
    _init_both(jexe)
    hooks[pt].initialize()
    hooks[ptt].initialize()
    for n in names:
        m = ptt.global_scope().numpy(n + "@PRUNE_MASK")
        np.testing.assert_array_equal(
            m, np.asarray(pt.global_scope().numpy(n + "@PRUNE_MASK")))
        assert abs((m == 0).mean() - 0.6) < 0.02
    for step in range(2):
        f = _feed(step)
        jexe.run(feed=f, fetch_list=[losses[pt]])
        texe.run(feed=f, fetch_list=[losses[ptt]])
    for n in names:
        w = ptt.global_scope().numpy(n)
        m = ptt.global_scope().numpy(n + "@PRUNE_MASK")
        assert (w[m == 0] == 0).all()
        np.testing.assert_allclose(w, pt.global_scope().numpy(n),
                                   rtol=1e-6, atol=1e-7)
        assert hooks[ptt].sparsity(n) == pytest.approx(
            hooks[pt].sparsity(n))


# ---------------------------------------------------------------------------
# Variable sugar and framework
# ---------------------------------------------------------------------------
def test_variable_arithmetic_builds_the_jax_program():
    progs = {}
    for pkg in (pt, ptt):
        pkg.unique_name.reset()
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            x = pkg.layers.data("x", shape=[3], dtype="float32")
            y = pkg.layers.data("y", shape=[3], dtype="float32")
            z = (x + 1.0) * y - 2.0
            z = 3.0 / z + (2.0 - x) / 4.0
            z = z + y * 0.5 - x / y
            z = 2.0 * z + 1.5 + z
        progs[pkg] = (main, z)
    assert progs[ptt][0].to_dict() == progs[pt][0].to_dict()
    r = np.random.RandomState(1)
    feed = {"x": r.rand(2, 3).astype("float32") + 0.5,
            "y": r.rand(2, 3).astype("float32") + 0.5}
    j = pt.Executor(pt.CPUPlace()).run(progs[pt][0], feed=feed,
                                        fetch_list=[progs[pt][1]],
                                        scope=pt.core.Scope())
    t = ptt.Executor(ptt.CPUPlace()).run(progs[ptt][0], feed=feed,
                                          fetch_list=[progs[ptt][1]],
                                          scope=ptt.Scope())
    np.testing.assert_allclose(t[0], j[0], rtol=1e-6)
    with pytest.raises(TypeError):
        ptt.layers.elementwise_binary_dispatch("elementwise_pow", 2.0,
                                               progs[ptt][1])


def test_framework_names_match_jax():
    from paddle_tpu import framework as jf
    from paddle_tpu_torch import framework as tf
    names = {"Program", "Block", "Operator", "Variable", "Parameter",
             "default_main_program", "default_startup_program",
             "program_guard", "grad_var_name", "unique_name", "VarType",
             "convert_dtype"}
    assert names <= set(dir(tf)) and names <= set(dir(jf))
    assert tf.Program is ptt.Program
    assert tf.grad_var_name("w") == jf.grad_var_name("w")
    assert [v.value for v in tf.VarType] == [v.value for v in jf.VarType]


def test_optimizer_aliases_and_schedules_reexported():
    for name in ("SGD", "Momentum", "Adagrad", "Adam", "Adamax",
                 "DecayedAdagrad", "Adadelta", "RMSProp", "Ftrl"):
        assert getattr(ptt.optimizer, name) is getattr(
            ptt.optimizer, name + "Optimizer")
    for name in ("exponential_decay", "natural_exp_decay",
                 "inverse_time_decay", "polynomial_decay",
                 "piecewise_decay", "noam_decay"):
        assert getattr(ptt.optimizer, name) is getattr(ptt.lr_decay, name)
