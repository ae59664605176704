"""The sequence, CRF and embedding layers and programs (d) and (e) in the
port against the JAX package on the CPU.

* **Layers.** Each of the 15 layers of the slice (``sequence_softmax``,
  ``sequence_expand``, ``sequence_concat``, ``sequence_reshape``,
  ``sequence_slice``, ``sequence_reverse``, ``lod_reset``, ``row_conv``,
  ``lstm_unit``, ``kmax_sequence_score``, ``nce``, ``hsigmoid``,
  ``linear_chain_crf``, ``crf_decoding``, ``warpctc``) has the JAX
  signature and builds the same program in both packages (``to_dict``
  equal, main and startup); the JAX program, carried to the port
  through ``to_dict``/``from_dict`` with the JAX startup's weights
  (``weights.load_numpy_state``: ``row_conv``'s Filter, the CRF's
  Transition, ``nce``'s and ``hsigmoid``'s weights and biases), computes
  the same forward over ragged lengths (0, 1 and T among them).
  ``nce`` draws other negatives than JAX's: its cost is held to the
  float64 recomputation from the drawn samples and the carried weights.
* **The book's semantic-role program** (``tests/test_book.py:120-164``:
  a GRU tagger under ``linear_chain_crf``, Adam) trained 3 steps in
  both packages from the JAX startup, and its Viterbi decode
  (``crf_decoding`` sharing ``crfw``) from the JAX-trained weights.
* **Programs (d) and (e)** (``torch_parity.build_crf_tagger`` and
  ``build_ctc_head``, ``chip_smoke.py``'s ``[dense]`` arms) at small
  widths: 2 Momentum steps in both packages from the JAX startup (the
  losses and the updated Transition), the decode (path, chunk counts,
  ``ChunkEvaluator``; argmax path and edit distance), each held too
  against the float64 oracles of ``paddle_tpu_torch.testing
  .seq_oracles``, which are held against the JAX package here.

Tolerances: forwards ``rtol=1e-4, atol=1e-5``; a 2-step training run
``rtol=1e-4, atol=1e-6`` (the losses and the Transition); integer,
path and count outputs exactly; the oracles ``rtol=1e-5`` in float64
against fp32 ops.
"""
import inspect

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
import torch_parity as tp
from paddle_tpu_torch.testing import op_cases as oc
from paddle_tpu_torch.testing import seq_oracles as so

CPU = ptt.CPUPlace()
TOL = dict(rtol=1e-4, atol=1e-5)
B = 4


def _d(L, name, shape, dtype="float32", lod=0, batch=True):
    return L.data(name, shape, dtype=dtype, lod_level=lod,
                  append_batch_size=batch)


def _lod_reset(L):
    return L.sequence_reverse(L.lod_reset(_d(L, "x", [6, 2]),
                                          target_lod=[0, 6, 7, 7, 11]))


def _lstm_unit(L):
    return list(L.lstm_unit(_d(L, "x", [5]), _d(L, "h", [3]),
                            _d(L, "c", [3]), forget_bias=0.5))


def _crf_label(L):
    return L.linear_chain_crf(_d(L, "em", [5], lod=1),
                              _d(L, "y", [], "int64", lod=1))


def _ints(hi):
    return lambda r, shape: r.randint(0, hi, shape).astype(np.int64)


LAYERS = {
    "sequence_softmax": (lambda L: L.sequence_softmax(
        _d(L, "x", [], lod=1)), {}),
    "sequence_expand": (lambda L: L.sequence_expand(
        _d(L, "x", [3]), _d(L, "y", [3], lod=1)), {}),
    "sequence_concat": (lambda L: L.sequence_concat(
        [_d(L, "a", [3], lod=1), _d(L, "b", [3], lod=1)]), {}),
    "sequence_reshape": (lambda L: L.sequence_reshape(
        _d(L, "x", [4], lod=1), 8), {}),
    "sequence_slice": (lambda L: L.sequence_slice(
        _d(L, "x", [2], lod=1), _d(L, "o", [1], "int64"),
        _d(L, "n", [1], "int64")), {"o": _ints(2), "n": _ints(4)}),
    "sequence_reverse": (lambda L: L.sequence_reverse(
        _d(L, "x", [3], lod=1)), {}),
    "lod_reset": (_lod_reset, {}),
    "row_conv": (lambda L: L.row_conv(_d(L, "x", [3], lod=1), 2,
                                      act="tanh"), {}),
    "lstm_unit": (_lstm_unit, {}),
    "kmax_sequence_score": (lambda L: L.kmax_sequence_score(
        _d(L, "x", [], lod=1), beam_size=3), {}),
    "hsigmoid": (lambda L: L.hsigmoid(_d(L, "x", [3]),
                                      _d(L, "y", [1], "int64"), 6),
                 {"y": _ints(6)}),
    "linear_chain_crf": (_crf_label, {"y": _ints(5)}),
    "crf_decoding": (lambda L: L.crf_decoding(
        _d(L, "em", [5], lod=1), param_attr="crfw"), {}),
    "warpctc": (lambda L: L.warpctc(_d(L, "x", [6], lod=1),
                                    _d(L, "y", [], "int64", lod=1)),
                {"y": lambda r, shape: r.randint(1, 6, shape)
                 .astype(np.int64)}, {"y": 3}),
}


def _build(pkg, make):
    pkg.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 3
    with pkg.program_guard(main, startup):
        out = make(pkg.layers)
    return main, startup, out if isinstance(out, list) else [out]


def _feed(main, r, ints, times):
    """Every data var: ints where ``ints`` names a maker, else ragged
    floats; a lod var has ``times`` steps (6 by default) and an
    ``@LEN`` with lengths 0, 1 and T among them."""
    feed = {}
    for v in main.global_block().vars.values():
        if not getattr(v, "is_data", False):
            continue
        # a lod var's steps: 6, or as ``times`` says
        T = times.get(v.name, 6)
        shape = [B] + [T if d < 0 else d for d in v.shape[1:]]
        if v.name in ints:
            feed[v.name] = ints[v.name](r, shape)
        elif str(v.dtype).endswith("int64"):
            feed[v.name] = r.randint(0, 5, shape).astype(np.int64)
        else:
            feed[v.name] = r.randn(*shape).astype(np.float32)
        if v.lod_level:
            feed[v.name + "@LEN"] = np.minimum(
                np.array([T, 1, 0, T - 2]), T).astype(np.int32)
    return feed


def _both(name, make, ints, times=None):
    tp.reset_both()
    jm, js, jouts = _build(pt, make)
    tm, ts, touts = _build(ptt, make)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    jscope = pt.core.Scope()
    pt.Executor(pt.CPUPlace()).run(js, scope=jscope)
    tscope = ptt.Scope()
    ptt.load_numpy_state(tscope, tp.jax_state(jscope), "cpu")
    carried = ptt.Program.from_dict(jm.to_dict())
    feed = _feed(jm, np.random.RandomState(sum(map(ord, name))), ints,
                 times or {})
    names = [o.name for o in jouts]
    want = pt.Executor(pt.CPUPlace()).run(jm, feed=feed, fetch_list=names,
                                          scope=jscope)
    got = ptt.Executor(CPU).run(carried, feed=feed, fetch_list=names,
                                scope=tscope)
    return [np.asarray(g) for g in got], [np.asarray(w) for w in want], \
        (jm, jscope, carried, tscope, feed)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_builds_the_jax_program_and_forward(name):
    got, want, _ = _both(name, *LAYERS[name])
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, **TOL)
        else:
            np.testing.assert_array_equal(g, w)


def _nce(L):
    return L.nce(_d(L, "x", [4]), _d(L, "y", [1], "int64"),
                 num_total_classes=20, num_neg_samples=5)


def test_nce_layer_builds_the_jax_program_and_its_cost_follows_the_draw():
    got, want, (jm, jscope, carried, tscope, feed) = _both(
        "nce", _nce, {"y": _ints(20)})
    op = next(o for o in carried.global_block().ops if o.type == "nce")
    labels, logits, cost = (np.asarray(v) for v in ptt.Executor(CPU).run(
        carried, feed=feed, fetch_list=[op.output("SampleLabels")[0],
                                        op.output("SampleLogits")[0],
                                        op.output("Cost")[0]],
        scope=tscope))
    ins = {"Input": [feed["x"]], "Label": [feed["y"]],
           "Weight": [tscope.numpy(op.input("Weight")[0])],
           "Bias": [tscope.numpy(op.input("Bias")[0])]}
    np.testing.assert_array_equal(ins["Weight"][0],
                                  jscope.numpy(op.input("Weight")[0]))
    oc.check_nce({"SampleLabels": labels, "SampleLogits": logits,
                  "Cost": cost}, ins, dict(op.attrs))
    assert got[0].shape == want[0].shape == (B, 1)


def test_the_15_layers_have_the_jax_signatures():
    names = set(LAYERS) | {"nce"}
    assert len(names) == 15
    for n in names:
        assert str(inspect.signature(getattr(ptt.layers, n))) == \
            str(inspect.signature(getattr(pt.layers, n))), n
        assert n in ptt.layers.__all__, n


# ---------------------------------------------------------------------------
# the book's semantic-role program
# ---------------------------------------------------------------------------
V, NT, E, H = 30, 4, 8, 8


def _srl(pkg, decode=False):
    """tests/test_book.py:120-164's program in ``pkg``."""
    pkg.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 1
    with pkg.program_guard(main, startup):
        L = pkg.layers
        words = L.data("words", shape=[], dtype="int64", lod_level=1)
        emb = L.embedding(words, size=[V, E])
        proj = L.fc(emb, size=H * 3, num_flatten_dims=2)
        fwd = L.dynamic_gru(proj, size=H)
        emission = L.fc(fwd, size=NT, num_flatten_dims=2)
        if decode:
            out = L.crf_decoding(emission,
                                 param_attr=pkg.ParamAttr(name="crfw"))
        else:
            target = L.data("target", shape=[], dtype="int64", lod_level=1)
            out = L.mean(L.linear_chain_crf(
                emission, target, param_attr=pkg.ParamAttr(name="crfw")))
            pkg.optimizer.Adam(learning_rate=0.1).minimize(out)
    return main, startup, out


def test_semantic_role_program_trains_and_decodes_as_jax():
    r = np.random.RandomState(0)
    toks = r.randint(0, V, (4, 6))
    tags = (toks % NT).astype("int64")
    lens = np.array([6, 5, 6, 4], np.int32)
    feed = {"words": toks, "words@LEN": lens, "target": tags,
            "target@LEN": lens}
    tp.reset_both()
    jm, js, jloss = _srl(pt)
    tm, ts, tloss = _srl(ptt)
    assert tm.to_dict() == jm.to_dict()
    jscope, jexe = pt.core.Scope(), pt.Executor(pt.CPUPlace())
    jexe.run(js, scope=jscope)
    tscope, texe = ptt.Scope(), ptt.Executor(CPU)
    ptt.load_numpy_state(tscope, tp.jax_state(jscope), "cpu")
    carried = ptt.Program.from_json(jm.to_json())
    for _ in range(3):
        want = jexe.run(jm, feed=feed, fetch_list=[jloss], scope=jscope)[0]
        got = texe.run(carried, feed=feed, fetch_list=[jloss.name],
                       scope=tscope)[0]
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-4)
    np.testing.assert_allclose(tscope.numpy("crfw"), jscope.numpy("crfw"),
                               rtol=1e-4, atol=1e-6)
    jd, _, jpath = _srl(pt, decode=True)
    want = jexe.run(jd, feed={"words": toks, "words@LEN": lens},
                    fetch_list=[jpath], scope=jscope)[0]
    ptt.load_numpy_state(tscope, tp.jax_state(jscope), "cpu")
    got = texe.run(ptt.Program.from_json(jd.to_json()),
                   feed={"words": toks, "words@LEN": lens},
                   fetch_list=[jpath.name], scope=tscope)[0]
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert np.asarray(got).dtype == np.int64
    m = np.arange(6)[None] < lens[:, None]
    assert not np.asarray(got)[~m].any()


# ---------------------------------------------------------------------------
# programs (d) and (e) at small widths
# ---------------------------------------------------------------------------
SMALL = dict(vocab=50, emb=16, hidden=16)
N_TYPES, T, LO, HI = 8, 10, 3, 10


def _tags(r, lens):
    return {"target": r.randint(0, 2 * N_TYPES + 1, (len(lens), T))
            .astype(np.int64), "target@LEN": lens}


def _ctc_labels(r, lens):
    """Labels in 1..vocab-1, lengths 1..5; row 0's 5 labels cannot fit
    in its 3 steps."""
    lens[0] = 3
    n = r.randint(1, 6, len(lens)).astype(np.int32)
    n[0] = 5
    return {"lbl": r.randint(1, SMALL["vocab"], (len(lens), 5))
            .astype(np.int64), "lbl@LEN": n}


def _train_both(build, feed, steps=2, **kw):
    tp.reset_both()
    jm, js, jv = build(pt, **SMALL, **kw)
    tm, ts, tv = build(ptt, **SMALL, **kw)
    assert tm.to_dict() == jm.to_dict() and ts.to_dict() == js.to_dict()
    jscope, jexe = pt.core.Scope(), pt.Executor(pt.CPUPlace())
    jexe.run(js, scope=jscope)
    tscope, texe = ptt.Scope(), ptt.Executor(CPU)
    ptt.load_numpy_state(tscope, tp.jax_state(jscope), "cpu")
    carried = ptt.Program.from_json(jm.to_json())
    return jm, jv, jscope, jexe, carried, tscope, texe


def test_program_d_crf_tagger_trains_and_decodes_as_jax():
    r = np.random.RandomState(27)
    feeds = [tp.seq_feed(r, B, T, SMALL["vocab"], LO, HI, _tags)
             for _ in range(2)]
    feeds[0]["words@LEN"][:2] = [HI, 1]
    feeds[0]["target@LEN"] = feeds[0]["words@LEN"]
    jm, jv, jscope, jexe, carried, tscope, texe = _train_both(
        lambda pkg, **k: tp.build_crf_tagger(pkg, n_types=N_TYPES, **k),
        feeds[0])
    names = [jv["loss"].name, jv["emission"].name]
    for f in feeds:
        trans = tscope.numpy("crfw")
        want = jexe.run(jm, feed=f, fetch_list=names, scope=jscope)
        got = texe.run(carried, feed=f, fetch_list=names, scope=tscope)
        np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                                   rtol=1e-4, atol=1e-6)
        # the loss is the float64 forward algorithm's over the fetched
        # emissions and the Transition the step read
        nll = so.crf_nll(np.asarray(got[1]), trans, f["target"],
                         f["target@LEN"])
        np.testing.assert_allclose(float(np.asarray(got[0])), nll.mean(),
                                   rtol=1e-5)
    np.testing.assert_allclose(tscope.numpy("crfw"), jscope.numpy("crfw"),
                               rtol=1e-4, atol=1e-6)
    # the decode program shares crfw; the JAX-trained weights in both
    tp.reset_both()
    jd, jds, jdv = tp.build_crf_tagger(pt, n_types=N_TYPES, decode=True,
                                       **SMALL)
    td, tds, tdv = tp.build_crf_tagger(ptt, n_types=N_TYPES, decode=True,
                                       **SMALL)
    assert td.to_dict() == jd.to_dict()
    jexe.run(jds, scope=(jd_scope := pt.core.Scope()))
    state = {**tp.jax_state(jd_scope), **tp.jax_state(jscope)}
    for k in tp.jax_state(jd_scope):
        if k.startswith("chunk_eval"):
            state[k] = np.zeros_like(state[k])
            jscope.set(k, jd_scope.get(k))
    dscope = ptt.Scope()
    ptt.load_numpy_state(dscope, state, "cpu")
    dnames = [jdv["path"].name, jdv["emission"].name]
    want_counts = np.zeros(3)
    for f in feeds:
        want = jexe.run(jd, feed=f, fetch_list=dnames, scope=jscope)
        got = texe.run(ptt.Program.from_json(jd.to_json()), feed=f,
                       fetch_list=dnames, scope=dscope)
        path = np.asarray(got[0])
        np.testing.assert_array_equal(path, np.asarray(want[0]))
        ref, margin = so.viterbi(np.asarray(got[1]), jscope.numpy("crfw"),
                                 f["words@LEN"])
        sure = margin > 1e-4
        assert sure.sum() >= B - 1
        np.testing.assert_array_equal(path[sure], ref[sure])
        want_counts += so.chunk_counts(path, f["target"], f["target@LEN"],
                                       N_TYPES)
    ev_t, ev_j = tdv["evaluator"], jdv["evaluator"]
    np.testing.assert_array_equal(ev_t.eval(None, scope=dscope),
                                  ev_j.eval(None, scope=jscope))
    np.testing.assert_array_equal(
        [dscope.numpy(s.name)[0] for s in ev_t.states], want_counts)


def test_program_e_ctc_head_trains_and_decodes_as_jax():
    r = np.random.RandomState(28)
    feeds = [tp.seq_feed(r, B, T, SMALL["vocab"], LO, HI, _ctc_labels)
             for _ in range(2)]
    jm, jv, jscope, jexe, carried, tscope, texe = _train_both(
        tp.build_ctc_head, feeds[0])
    keys = ("loss", "ctc", "logits", "path", "dist")
    names = [jv[k].name for k in keys]
    for f in feeds:
        want = dict(zip(keys, (np.asarray(v) for v in jexe.run(
            jm, feed=f, fetch_list=names, scope=jscope))))
        got = dict(zip(keys, (np.asarray(v) for v in texe.run(
            carried, feed=f, fetch_list=names, scope=tscope))))
        for k in ("loss", "ctc"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-6)
        assert 0.99e30 < got["ctc"][0, 0] < 1.01e30
        oracle = so.ctc_nll(got["logits"], f["lbl"], f["words@LEN"],
                            f["lbl@LEN"])
        np.testing.assert_allclose(got["ctc"][:, 0], oracle, rtol=1e-5)
        np.testing.assert_array_equal(got["path"], want["path"])
        np.testing.assert_array_equal(got["dist"], want["dist"])
        lev = [so.levenshtein(got["path"][b, :f["words@LEN"][b]],
                              f["lbl"][b, :f["lbl@LEN"][b]])
               for b in range(B)]
        assert got["dist"][:, 0].tolist() == lev
