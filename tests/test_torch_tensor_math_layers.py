"""The tensor and math layers and program (c), in the port against the
JAX package on the CPU.

* **Layers.** Each of the 22 layers of the slice (``layers/tensor.py``:
  ``create_tensor``, ``assign``, ``zeros_like``, ``reverse``,
  ``argsort``, ``scatter``, ``shape``, ``range``, ``slice``;
  ``layers/nn.py``: ``crop``, ``pad``, ``expand``, ``multiplex``,
  ``sampling_id``, ``elementwise_pow``, ``l2_normalize``, ``conv_shift``,
  ``interpolation``, ``outer_prod``, ``factorization_machine``,
  ``scale_sub_region``; ``layers/control_flow.py``: ``equal``) has the
  JAX signature and builds the same program in both packages (``to_dict``
  equal, main and startup); the JAX program, carried to the port through
  ``to_dict``/``from_dict`` with the JAX startup's weights
  (``weights.load_numpy_state``: ``factorization_machine``'s ``V``
  among them), computes the same forward.  ``sampling_id`` draws other
  numbers than JAX's: its ids are held to their range.
* **Program (c)** (``torch_parity.build_sampler``: a GPT-style decoder's
  first sampled token under a top-p 0.9 filter) at small widths (2
  layers, d 32, 2 heads, T 32, vocab 97, batch 2): the JAX program
  through JSON with its weights; the logits, probabilities, the sort, the
  cumulative mass, the tail mask and the kept mass (the input of
  ``sampling_id``) against JAX's; after it, each sampled id inside its
  row's nucleus and equal to the sort's index at the sampled position,
  and over 300 steps the sampled positions distributed as the kept mass
  (chi-square at a false-alarm rate of 1e-6).

Tolerances: float forwards ``rtol=1e-4, atol=1e-5``; integer and bool
outputs exactly; the sort held as a permutation that sorts JAX's
probabilities within 1e-7 (an exact tie between two fp32 probabilities
may order either way), and the tail mask exactly wherever the mass
before a position is more than 1e-6 from 0.9.
"""
import inspect

import numpy as np
import pytest
from scipy import stats

import paddle_tpu as pt
import paddle_tpu_torch as ptt
import torch_parity as tp

CPU = ptt.CPUPlace()
TOL = dict(rtol=1e-4, atol=1e-5)


def _d(L, name, shape, dtype="float32", batch=True):
    return L.data(name, shape, dtype=dtype, append_batch_size=batch)


def _created(L):
    t = L.create_tensor("float32", name="created")
    return L.assign(_d(L, "x", [3]), t)


LAYERS = {
    # layers/tensor.py
    "create_tensor": (_created, None),
    "assign": (lambda L: L.assign(_d(L, "x", [3, 2])), None),
    "zeros_like": (lambda L: L.zeros_like(_d(L, "x", [3])), None),
    "reverse": (lambda L: L.reverse(_d(L, "x", [3, 4]), [0, 2]), None),
    "argsort": (lambda L: list(L.argsort(_d(L, "x", [7]), axis=1)),
                lambda r: {"x": (r.randint(0, 3, (4, 7)) * 0.5)
                           .astype(np.float32)}),
    "scatter": (lambda L: L.scatter(
        _d(L, "x", [3]), _d(L, "i", [3], "int64", batch=False),
        _d(L, "u", [3, 3], batch=False)),
        lambda r: {"x": r.rand(4, 3).astype(np.float32),
                   "i": np.array([1, 3, 1], np.int64),
                   "u": r.rand(3, 3).astype(np.float32)}),
    "scatter[accumulate]": (lambda L: L.scatter(
        _d(L, "x", [3]), _d(L, "i", [3], "int64", batch=False),
        _d(L, "u", [3, 3], batch=False), overwrite=False),
        lambda r: {"x": r.rand(4, 3).astype(np.float32),
                   "i": np.array([1, 3, 1], np.int64),
                   "u": r.rand(3, 3).astype(np.float32)}),
    "shape": (lambda L: L.shape(_d(L, "x", [3, 5])), None),
    "range": (lambda L: L.range(1, 12, 2), {}),
    "slice": (lambda L: L.slice(_d(L, "x", [5, 6]), axes=[1, 2],
                                starts=[1, 2], ends=[4, 6]), None),
    # layers/nn.py
    "crop": (lambda L: L.crop(_d(L, "x", [5, 6]), shape=[-1, 2, 3],
                              offsets=[0, 1, 2]), None),
    "pad": (lambda L: L.pad(_d(L, "x", [3]), [0, 1, 2, 1], pad_value=0.5),
            None),
    "expand": (lambda L: L.expand(_d(L, "x", [1, 3]), [1, 2, 2]), None),
    "multiplex": (lambda L: L.multiplex(
        [_d(L, n, [3]) for n in ("a", "b", "c")],
        _d(L, "i", [1], "int64")),
        lambda r: {**{n: r.rand(4, 3).astype(np.float32) for n in "abc"},
                   "i": np.array([[2], [0], [1], [2]], np.int64)}),
    "elementwise_pow": (lambda L: L.elementwise_pow(_d(L, "x", [4]),
                                                    _d(L, "y", [4])), None),
    "l2_normalize": (lambda L: L.l2_normalize(_d(L, "x", [5]), axis=1),
                     None),
    "conv_shift": (lambda L: L.conv_shift(_d(L, "x", [7]), _d(L, "y", [3])),
                   None),
    "interpolation": (lambda L: L.interpolation(
        _d(L, "w", [1]), _d(L, "x", [5]), _d(L, "y", [5])), None),
    "outer_prod": (lambda L: L.outer_prod(_d(L, "x", [3]), _d(L, "y", [4])),
                   None),
    "factorization_machine": (
        lambda L: L.factorization_machine(_d(L, "x", [6]), 3), None),
    "scale_sub_region": (lambda L: L.scale_sub_region(
        _d(L, "x", [2, 4, 5]), _d(L, "i", [6], "int64"), value=2.0),
        lambda r: {"x": r.rand(4, 2, 4, 5).astype(np.float32),
                   "i": np.array([[1, 1, 1, 2, 1, 5], [1, 2, 2, 4, 3, 3],
                                  [2, 2, 1, 4, 1, 1], [1, 2, 3, 3, 2, 4]],
                                 np.int64)}),
    # layers/control_flow.py
    "equal": (lambda L: L.equal(_d(L, "x", [5], "int64"),
                                _d(L, "y", [5], "int64")), None),
}
SAMPLING = (lambda L: L.sampling_id(L.softmax(_d(L, "x", [6]))), None)


def _build(pkg, make):
    pkg.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 3
    with pkg.program_guard(main, startup):
        out = make(pkg.layers)
    return main, startup, out if isinstance(out, list) else [out]


def _feed(main, r):
    feed = {}
    for v in main.global_block().vars.values():
        if getattr(v, "is_data", False):
            shape = [4] + list(v.shape[1:])
            feed[v.name] = r.randint(0, 5, shape).astype(np.int64) \
                if str(v.dtype).endswith("int64") else \
                (r.rand(*shape) + 0.1).astype(np.float32)
    return feed


def _both(name, make, feed_of):
    tp.reset_both()
    jm, js, jouts = _build(pt, make)
    tm, ts, touts = _build(ptt, make)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    assert [o.name for o in touts] == [o.name for o in jouts]
    jscope = pt.core.Scope()
    pt.Executor(pt.CPUPlace()).run(js, scope=jscope)
    tscope = ptt.Scope()
    ptt.load_numpy_state(tscope, tp.jax_state(jscope), "cpu")
    carried = ptt.Program.from_dict(jm.to_dict())
    r = np.random.RandomState(sum(map(ord, name)))
    feed = feed_of if isinstance(feed_of, dict) else \
        feed_of(r) if feed_of else _feed(jm, r)
    names = [o.name for o in jouts]
    want = pt.Executor(pt.CPUPlace()).run(jm, feed=feed, fetch_list=names,
                                          scope=jscope)
    got = ptt.Executor(CPU).run(carried, feed=feed, fetch_list=names,
                                scope=tscope)
    return [np.asarray(g) for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_builds_the_jax_program_and_forward(name):
    got, want = _both(name, *LAYERS[name])
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, **TOL)
        else:
            np.testing.assert_array_equal(g, w)


def test_sampling_id_layer_builds_the_jax_program_and_draws_in_range():
    got, want = _both("sampling_id", *SAMPLING)
    assert got[0].dtype == np.int64 and got[0].shape == want[0].shape == (4,)
    assert ((0 <= got[0]) & (got[0] < 6)).all()


def test_the_22_layers_have_the_jax_signatures():
    names = {n.split("[")[0] for n in LAYERS} | {"sampling_id"}
    assert len(names) == 22
    for n in names:
        assert str(inspect.signature(getattr(ptt.layers, n))) == \
            str(inspect.signature(getattr(pt.layers, n))), n
        assert n in ptt.layers.__all__, n


def test_the_factorization_machines_weight_is_carried():
    """V [6, 3] is a parameter of the startup, loaded from JAX's scope."""
    tp.reset_both()
    jm, js, _ = _build(pt, LAYERS["factorization_machine"][0])
    params = [p.name for p in jm.global_block().all_parameters()]
    assert len(params) == 1
    jscope = pt.core.Scope()
    pt.Executor(pt.CPUPlace()).run(js, scope=jscope)
    tscope = ptt.Scope()
    ptt.load_numpy_state(tscope, tp.jax_state(jscope), "cpu")
    np.testing.assert_array_equal(tscope.numpy(params[0]),
                                  jscope.numpy(params[0]))
    assert tscope.numpy(params[0]).shape == (6, 3)


# ---------------------------------------------------------------------------
# program (c): the first sampled token under a top-p filter
# ---------------------------------------------------------------------------
SAMPLER = dict(vocab=97, T=32, d=32, heads=2, n_layers=2, ffn=64, batch=2,
               block=16)
TOP_P = 0.9


def _sampler():
    tp.reset_both()
    jm, js, jv = tp.build_sampler(pt, interpret=True, **SAMPLER)
    _, _, tv = tp.build_sampler(ptt, interpret=True, **SAMPLER)
    tm = ptt.Program.from_json(jm.to_json())
    jscope = pt.core.Scope()
    pt.Executor(pt.CPUPlace()).run(js, scope=jscope)
    tscope = ptt.Scope()
    ptt.load_numpy_state(tscope, tp.jax_state(jscope), "cpu")
    feed = {"tok": np.random.RandomState(26).randint(
        0, SAMPLER["vocab"], (SAMPLER["batch"], SAMPLER["T"]))
        .astype(np.int64)}
    return jm, jv, jscope, tm, tv, tscope, feed


KEYS = ("logits", "probs", "sorted", "order", "cum", "before", "tail",
        "kept", "pos", "ids")


def test_program_c_matches_jax_up_to_the_sampler_input():
    jm, jv, jscope, tm, tv, tscope, feed = _sampler()
    ops = [op.type for op in tm.global_block().ops]
    for t in ("range", "expand", "slice", "argsort", "cumsum",
              "greater_equal", "where", "fill_zeros_like", "sampling_id",
              "one_hot", "reduce_sum"):
        assert t in ops, t
    names = [jv[k].name for k in KEYS]
    want = dict(zip(KEYS, (np.asarray(v) for v in pt.Executor(
        pt.CPUPlace()).run(jm, feed=feed, fetch_list=names,
                           scope=jscope))))
    got = dict(zip(KEYS, (np.asarray(v) for v in ptt.Executor(CPU).run(
        tm, feed=feed, fetch_list=names, scope=tscope))))
    for k in ("logits", "probs", "sorted", "cum", "before", "kept"):
        assert got[k].dtype == np.float32, k
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    assert got["order"].dtype == np.int64
    rows = np.arange(SAMPLER["batch"])[:, None]
    # the port's order sorts JAX's probabilities (near-ties either way)
    assert (np.diff(want["probs"][rows, got["order"]], axis=1)
            <= 1e-7).all()
    assert sorted(got["order"][0].tolist()) == list(range(SAMPLER["vocab"]))
    sure = np.abs(want["before"] - TOP_P) > 1e-6
    np.testing.assert_array_equal(got["tail"][sure], want["tail"][sure])
    # after the sampler: inside the nucleus, mapped back through the sort
    for g in (got, want):
        pos = g["pos"].astype(np.int64)
        assert not g["tail"][rows[:, 0], pos].any()
        np.testing.assert_array_equal(g["ids"], g["order"][rows[:, 0], pos])


def test_program_c_samples_the_kept_mass():
    """300 steps (one draw a row a step, the same probabilities): the
    sampled sorted positions are distributed as the kept mass over bins
    of at least 25 expected draws; every draw inside its nucleus."""
    _, jv, _, tm, tv, tscope, feed = _sampler()
    steps = 300
    names = [jv[k].name for k in ("kept", "tail", "pos")]
    runs = ptt.Executor(CPU).run_steps(steps, tm, feed=feed,
                                       fetch_list=names, scope=tscope)
    kept, tail, pos = (np.asarray(v) for v in runs)
    assert (kept == kept[0]).all()
    for b in range(SAMPLER["batch"]):
        p = kept[0, b] / kept[0, b].sum()
        draws = pos[:, b]
        assert not tail[0, b][draws].any()
        counts = np.bincount(draws, minlength=len(p))
        # consecutive positions merged until each bin expects >= 25
        bins, exp, obs, e, o = [], [], [], 0.0, 0
        for i in range(len(p)):
            e += p[i] * steps
            o += counts[i]
            if e >= 25:
                exp.append(e)
                obs.append(o)
                e, o = 0.0, 0
        exp[-1] += e
        obs[-1] += o
        exp, obs = np.array(exp), np.array(obs)
        chi2 = float(((obs - exp) ** 2 / exp).sum())
        assert chi2 < stats.chi2.isf(1e-6, len(exp) - 1), (b, chi2)
    assert len({tuple(pos[i]) for i in range(steps)}) > steps // 2
