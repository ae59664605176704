"""``paddle_tpu_torch.evaluator`` and ``paddle_tpu_torch.metrics``
against the JAX package's classes on the CPU.

* **metrics** (host numpy, the port's own copy): each of the five
  classes fed the same arrays as its JAX twin gives the same results.
* **Host evaluators** (``RankAuc``, ``CTCError``, ``DetectionMAP``): the
  same, plus the cases of ``tests/test_evaluator_tail.py`` (the pairwise
  AUC with ties, the CTC best path and its error counts).
* **Evaluator.Accuracy**: built over a program in each package (the
  same program and state names), and the JAX program carried to the
  port through ``to_json`` with its startup scope: over the same feeds
  its states and ``eval`` equal the JAX evaluator's exactly, ``reset``
  zeroes the states in their dtype, and the evaluator accumulates inside
  ``run_steps`` (``tests/test_ops_misc.py::test_evaluator_accuracy``).
* **The trainer's extra layers** (``tests/test_highlevel.py:14``):
  ``trainer.SGD(extra_layers=[accuracy])`` reports the batch accuracy in
  every ``EndIteration.metrics``, equal to the JAX trainer's from the
  same weights and batches.
* **Evaluator.ChunkEvaluator**: the same program and states in each
  package over the CRF family's ``chunk_eval`` op; over several batches
  of ragged IOB tags its batch metrics, states and ``eval`` equal the
  JAX evaluator's exactly, and its states are a numpy recount by the
  JAX package's simplified IOB rule.

Tolerances: none for counts and accuracies (exact); the metrics' float
results equal the JAX classes' (the same numpy code on the same arrays);
the trainer's costs ``rtol=1e-5``.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
import torch_parity as tp

CPU = ptt.CPUPlace()
R = np.random.RandomState(31)


# ---------------------------------------------------------------------------
# metrics: the same numbers as the JAX classes
# ---------------------------------------------------------------------------
def _feed_metric(name, mod):
    r = np.random.RandomState(7)
    if name == "Accuracy":
        m = mod.Accuracy()
        for _ in range(3):
            m.update(r.rand(9, 5), r.randint(0, 5, (9, 1)))
    elif name == "Auc":
        m = mod.Auc(num_thresholds=30)
        for _ in range(3):
            p = r.rand(20, 1)
            m.update(np.concatenate([1 - p, p], 1), r.randint(0, 2, (20, 1)))
    elif name == "PrecisionRecall":
        m = mod.PrecisionRecall(4)
        for _ in range(3):
            m.update(r.rand(12, 4), r.randint(0, 4, 12))
    else:
        m = mod.EditDistance()
        for _ in range(3):
            m.update(r.randint(0, 5, 7))
    return m


@pytest.mark.parametrize("name", ["Accuracy", "Auc", "PrecisionRecall",
                                  "EditDistance"])
def test_metrics_equal_the_jax_classes(name):
    got = _feed_metric(name, ptt.metrics).eval()
    want = _feed_metric(name, pt.metrics).eval()
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    m = _feed_metric(name, ptt.metrics)
    m.reset()
    assert np.all(np.asarray(m.eval()) == 0.0)


def test_metric_base_is_abstract():
    m = ptt.metrics.Metric()
    for call in (m.reset, m.eval, lambda: m.update(1)):
        with pytest.raises(NotImplementedError):
            call()


# ---------------------------------------------------------------------------
# the host evaluators
# ---------------------------------------------------------------------------
def _brute_auc(scores, clicks, pv):
    """Pairwise definition: P(score_click > score_noclick), ties half."""
    num = den = 0.0
    n = len(scores)
    for i in range(n):
        for j in range(n):
            w = clicks[i] * (pv[j] - clicks[j])
            if w <= 0:
                continue
            den += w
            if scores[i] > scores[j]:
                num += w
            elif scores[i] == scores[j]:
                num += 0.5 * w
    return num / den if den else 0.0


def test_rank_auc_matches_the_pairwise_definition_and_jax():
    for _ in range(5):
        n = 12
        scores = np.round(R.rand(n), 1)         # rounding forces ties
        clicks = R.randint(0, 3, n).astype(float)
        pv = clicks + R.randint(0, 3, n)
        ev, jev = ptt.evaluator.RankAuc(), pt.evaluator.RankAuc()
        ev.update(scores, clicks, pv, seq_lens=[5, 7])
        jev.update(scores, clicks, pv, seq_lens=[5, 7])
        assert ev.eval() == jev.eval()
        one = ptt.evaluator.RankAuc()
        one.update(scores, clicks, pv)
        assert abs(one.eval() - _brute_auc(scores, clicks, pv)) < 1e-9


def _onehot_path(path, num_classes):
    acts = np.zeros((len(path), num_classes), np.float32)
    acts[np.arange(len(path)), path] = 1.0
    return acts


def test_ctc_best_path_and_error_counts():
    CTC = ptt.evaluator.CTCError
    assert CTC.best_path(_onehot_path([0, 0, 4, 0, 1, 1], 5), 4) == [0, 0, 1]
    assert CTC.best_path(_onehot_path([4, 2, 4, 4, 3, 4], 5), 4) == [2, 3]
    ev = CTC()
    ev.update(_onehot_path([0, 4, 2], 5), [0, 1])
    r = ev.results()
    assert r["error"] == 0.5 and r["substitution_error"] == 0.5
    assert r["deletion_error"] == 0.0 and r["sequence_error"] == 1.0
    ev.update(_onehot_path([4, 4], 5), [3])
    ev.update(_onehot_path([3], 5), [])
    jev = pt.evaluator.CTCError()
    for acts, lab in ((_onehot_path([0, 4, 2], 5), [0, 1]),
                      (_onehot_path([4, 4], 5), [3]),
                      (_onehot_path([3], 5), [])):
        jev.update(acts, lab)
    assert ev.results() == jev.results()
    acts = R.randn(3, 9, 6)
    labels = [R.randint(0, 5, R.randint(0, 6)) for _ in range(3)]
    ev.reset()
    jev.reset()
    for a, lab in zip(acts, labels):
        ev.update(a, lab)
        jev.update(a, lab)
    assert ev.eval() == jev.eval()


def test_detection_map_equals_jax():
    r = np.random.RandomState(3)
    N, K, M = 3, 6, 4
    boxes = np.sort(r.rand(N, K, 4), axis=-1)[..., [0, 1, 2, 3]]
    det = np.concatenate([r.randint(-1, 3, (N, K, 1)).astype(float),
                          r.rand(N, K, 1), boxes[..., [0, 1]],
                          boxes[..., [0, 1]] + 0.3], axis=-1)
    gtb = r.rand(N, M, 2)
    gtb = np.concatenate([gtb, gtb + 0.3], axis=-1)
    gtl = r.randint(-1, 3, (N, M))
    for version in ("11point", "integral"):
        ev = ptt.evaluator.DetectionMAP(ap_version=version)
        jev = pt.evaluator.DetectionMAP(ap_version=version)
        ev.update(det, gtb, gtl)
        jev.update(det, gtb, gtl)
        assert ev.eval() == jev.eval()
        assert 0.0 <= ev.eval() <= 1.0


# ---------------------------------------------------------------------------
# ChunkEvaluator over a program
# ---------------------------------------------------------------------------
def _chunk_program(pkg, n_types=3):
    pkg.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        inf = pkg.layers.data("inf", shape=[], dtype="int64", lod_level=1)
        lbl = pkg.layers.data("lbl", shape=[], dtype="int64", lod_level=1)
        ev = pkg.evaluator.ChunkEvaluator(inf, lbl, chunk_scheme="IOB",
                                          num_chunk_types=n_types)
    return main, startup, ev


def _chunk_feeds(n=4, T=7):
    """IOB tags over 3 chunk types (B-k 2k, I-k 2k + 1, O 6), ragged
    lengths with 0 and T among them, inferred tags right 60% of the
    time."""
    r = np.random.RandomState(12)
    feeds = []
    for _ in range(n):
        lbl = r.randint(0, 7, (5, T)).astype(np.int64)
        inf = np.where(r.rand(5, T) < 0.6, lbl, r.randint(0, 7, (5, T)))
        lens = r.randint(0, T + 1, 5).astype(np.int32)
        lens[:2] = [T, 0]
        feeds.append({"inf": inf.astype(np.int64), "lbl": lbl,
                      "inf@LEN": lens, "lbl@LEN": lens})
    return feeds


def test_chunk_evaluator_equals_jax_over_several_batches():
    """The same program and states in both packages; the JAX program
    carried through JSON: each batch's precision, recall and F1, the
    three states and ``eval`` after 4 batches equal the JAX
    evaluator's; ``reset`` zeroes them."""
    tp.reset_both()
    jm, js, jev = _chunk_program(pt)
    tm, ts, tev = _chunk_program(ptt)
    assert tm.to_dict() == jm.to_dict()
    assert [s.name for s in tev.states] == [s.name for s in jev.states]
    carried = ptt.Program.from_json(jm.to_json())
    jscope, tscope = pt.core.Scope(), ptt.Scope()
    jexe, texe = pt.Executor(pt.CPUPlace()), ptt.Executor(CPU)
    jexe.run(js, scope=jscope)
    texe.run(ts, scope=tscope)
    names = [m.name for m in jev.metrics]
    for f in _chunk_feeds():
        want = jexe.run(jm, feed=f, fetch_list=names, scope=jscope)
        got = texe.run(carried, feed=f, fetch_list=names, scope=tscope)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    for s in jev.states:
        np.testing.assert_array_equal(tscope.numpy(s.name),
                                      jscope.numpy(s.name))
    got = tev.eval(texe, scope=tscope)
    np.testing.assert_array_equal(got, jev.eval(jexe, scope=jscope))
    assert got.dtype == np.float32 and 0 < got[2] < 1
    assert tscope.numpy(tev.num_label.name)[0] > 0
    tev.reset(texe, scope=tscope)
    for s in tev.states:
        assert not tscope.get(s.name).any()


def test_chunk_evaluator_counts_by_the_simplified_iob_rule():
    """Over one batch, the states are a numpy recount: a chunk starts at
    an even tag below 2 * num_chunk_types within the length, a correct
    one where the inferred tag equals the label there."""
    tp.reset_both()
    main, startup, ev = _chunk_program(ptt)
    scope = ptt.Scope()
    exe = ptt.Executor(CPU)
    exe.run(startup, scope=scope)
    f = _chunk_feeds(1)[0]
    exe.run(main, feed=f, fetch_list=[ev.metrics[0].name], scope=scope)
    m = np.arange(7)[None] < f["lbl@LEN"][:, None]
    start = lambda t: (t % 2 == 0) & (t < 6) & m   # noqa: E731
    want = [start(f["inf"]).sum(), start(f["lbl"]).sum(),
            (start(f["lbl"]) & (f["inf"] == f["lbl"])).sum()]
    assert [scope.numpy(s.name)[0] for s in ev.states] == want


# ---------------------------------------------------------------------------
# Evaluator.Accuracy over a program
# ---------------------------------------------------------------------------
def _acc_program(pkg, k=1):
    pkg.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 5
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[4], dtype="float32")
        lbl = pkg.layers.data("lbl", shape=[1], dtype="int64")
        pred = pkg.layers.fc(x, size=3, act="softmax")
        ev = pkg.evaluator.Accuracy(input=pred, label=lbl, k=k)
    return main, startup, pred, ev


def _feeds(n=4):
    r = np.random.RandomState(11)
    return [{"x": r.rand(8, 4).astype("float32"),
             "lbl": r.randint(0, 3, (8, 1))} for _ in range(n)]


@pytest.mark.parametrize("k", [1, 2])
def test_accuracy_evaluator_equals_jax_through_json(k):
    tp.reset_both()
    jm, js, jpred, jev = _acc_program(pt, k)
    tm, ts, tpred, tev = _acc_program(ptt, k)
    assert tm.to_dict() == jm.to_dict()
    assert [s.name for s in tev.states] == [s.name for s in jev.states]
    carried = ptt.Program.from_json(jm.to_json())
    jscope = pt.core.Scope()
    jexe = pt.Executor(pt.CPUPlace())
    jexe.run(js, scope=jscope)
    tscope = ptt.Scope()
    ptt.load_numpy_state(tscope, tp.jax_state(jscope), "cpu")
    texe = ptt.Executor(CPU)
    jev.reset(jexe, scope=jscope)
    tev.reset(texe, scope=tscope)
    for f in _feeds():
        ja = jexe.run(jm, feed=f, fetch_list=[jev.batch_accuracy],
                      scope=jscope)[0]
        ta = texe.run(carried, feed=f, fetch_list=[tev.batch_accuracy.name],
                      scope=tscope)[0]
        np.testing.assert_array_equal(np.asarray(ta), np.asarray(ja))
    for s in jev.states:
        np.testing.assert_array_equal(tscope.numpy(s.name),
                                      jscope.numpy(s.name))
    got = tev.eval(texe, scope=tscope)
    np.testing.assert_array_equal(got, jev.eval(jexe, scope=jscope))
    assert tscope.numpy(tev.total.name)[0] == 32.0
    # reset zeroes the states in the dtype the scope holds
    tev.reset(texe, scope=tscope)
    for s in tev.states:
        v = tscope.get(s.name)
        assert v.dtype.is_floating_point and not v.any()
    assert tev.eval(texe, scope=tscope)[0] == 0.0


def test_accuracy_evaluator_accumulates_inside_run_steps():
    """The states are summed inside the step, so K stacked steps of
    ``run_steps`` accumulate K batches, as K calls of ``run`` do."""
    ptt.core.reset_default_programs()
    ptt.core.reset_global_scope()
    main, startup, pred, ev = _acc_program(ptt)
    feeds = _feeds(3)
    a = ptt.Scope()
    exe = ptt.Executor(CPU)
    exe.run(startup, scope=a)
    b = ptt.Scope()
    for k in a.keys():
        b.set(k, a.get(k).clone())
    for f in feeds:
        exe.run(main, feed=f, fetch_list=[pred], scope=a)
    stacked = {n: np.stack([f[n] for f in feeds]) for n in feeds[0]}
    exe.run_steps(3, main, feed=stacked, fetch_list=[pred.name], scope=b,
                  feeds_stacked=True)
    for s in ev.states:
        np.testing.assert_array_equal(b.numpy(s.name), a.numpy(s.name))
    assert ev.eval(exe, scope=b)[0] == ev.eval(exe, scope=a)[0]
    assert b.numpy(ev.total.name)[0] == 24.0


# ---------------------------------------------------------------------------
# the trainer's extra layers
# ---------------------------------------------------------------------------
def _mlp(pkg):
    img = pkg.layers.data("img", shape=[20], dtype="float32")
    label = pkg.layers.data("label", shape=[1], dtype="int64")
    pred = pkg.models.mnist_mlp(img, hidden_sizes=(16,), num_classes=4)
    cost = pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
    acc = pkg.layers.accuracy(pred, label)
    return img, label, cost, acc


def _reader():
    r = np.random.RandomState(13)
    rows = [(r.rand(20).astype("float32"), int(r.randint(4)))
            for _ in range(48)]

    def batches():
        for i in range(0, len(rows), 16):
            yield rows[i:i + 16]
    return batches


def test_trainer_reports_accuracy_like_the_jax_trainer():
    tp.reset_both()
    jimg, jlabel, jcost, jacc = _mlp(pt)
    jsgd = pt.trainer.SGD(cost=jcost, update_equation=pt.optimizer.Adam(0.01),
                          extra_layers=[jacc])
    jsgd.exe.run(pt.default_startup_program(), feed={}, fetch_list=[])
    jsgd._initialized = True
    timg, tlabel, tcost, tacc = _mlp(ptt)
    tsgd = ptt.trainer.SGD(cost=tcost,
                           update_equation=ptt.optimizer.Adam(0.01),
                           extra_layers=[tacc], place=CPU)
    ptt.load_numpy_state(ptt.global_scope(), tp.jax_state(pt.global_scope()),
                         "cpu")
    tsgd._initialized = True
    seen = {}
    for name, sgd, feed_list in (("jax", jsgd, [jimg, jlabel]),
                                 ("torch", tsgd, [timg, tlabel])):
        rows = seen[name] = []

        def handler(e, rows=rows):
            if type(e).__name__ == "EndIteration":
                rows.append((e.cost, dict(e.metrics)))

        sgd.train(_reader(), num_passes=1, event_handler=handler,
                  feed_list=feed_list)
    assert len(seen["torch"]) == len(seen["jax"]) == 3
    for (tc, tm), (jc, jm) in zip(seen["torch"], seen["jax"]):
        np.testing.assert_allclose(tc, jc, rtol=1e-5)
        assert list(tm) == list(jm) == [tacc.name]
        acc = float(np.asarray(tm[tacc.name]).reshape(-1)[0])
        assert acc == float(np.asarray(jm[jacc.name]).reshape(-1)[0])
        assert 0.0 <= acc <= 1.0 and acc * 16 == round(acc * 16)
