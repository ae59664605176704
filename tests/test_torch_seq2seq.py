"""The seq2seq+attention training leg of ``bench.py`` in the port
against the JAX package on the CPU, at a small size (vocab 200, dim 32,
batch 4, ragged lengths up to 7): the program both build (ops, attrs,
parameter names, the step sub-block, JSON), one fp32 step (loss and
every ``<param>@GRAD``) and three ``run_steps`` (parameters, moments,
beta pows), the same under ``amp=True`` with its zero Adam update, and
``DataFeeder``'s padded feeds.

Tolerances: fp32 loss ``rtol=1e-5``, gradients within 1e-4 of each
gradient's largest magnitude, parameters after three Adam steps within
5e-3 of the learning rate, absolute: a gradient element whose terms
cancel to near zero keeps their fp32 rounding (about 1e-10 here), and
Adam's first steps scale it by up to lr * 0.0316 / eps (3e4 at lr
1e-2) on its way to the update, which is itself at most about lr a
step (measured: 6e-6 after one step, 6e-4 of lr; a wrong update is off
by the order of lr). AMP: the bf16 forward rounds the loss to bf16, so
loss ``rtol=2e-2`` (two ulps of a loss in [4, 8)), gradients within
5e-2 of their largest magnitude (several bf16 ulps through the
recurrences; measured 1.3-1.9e-2); the parameters are unchanged on
both sides, exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from torch_parity import build_seq2seq, jax_state, reset_both

V, D, B, T = 200, 32, 4, 7
LR = 1e-2


@pytest.fixture(autouse=True)
def _fresh():
    reset_both()
    yield


def _rows(seed):
    """B ragged (src, tgt, lbl) rows, lengths 1..T, both ends present
    (so every batch pads to T)."""
    r = np.random.RandomState(seed)
    ls, lt = r.randint(1, T + 1, B), r.randint(1, T + 1, B)
    ls[0] = lt[0] = T
    ls[-1] = lt[-1] = 1
    return [(r.randint(0, V, ls[i]).tolist(), r.randint(0, V, lt[i]).tolist(),
             r.randint(0, V, lt[i]).tolist()) for i in range(B)]


def _feed(pkg, main, seed=0):
    gb = main.global_block()
    return pkg.DataFeeder([gb.var(n) for n in ("src", "tgt", "lbl")],
                          seq_bucket_multiple=1).feed(_rows(seed))


def _both(via_json):
    """The JAX program and startup run on the CPU, and the port's
    program, built by the port (or loaded from the JAX JSON) with the
    JAX scope carried across."""
    jm, js, jl = build_seq2seq(pt, V, D, LR)
    if via_json:
        tm = ptt.Program.from_json(jm.to_json())
        tl = tm.global_block().var(jl.name)
    else:
        tm, _, tl = build_seq2seq(ptt, V, D, LR)
    jscope = pt.core.Scope()
    pt.Executor(pt.CPUPlace()).run(js, scope=jscope)
    return jm, jl, tm, tl, jax_state(jscope)


def _scopes(state):
    jsc = pt.core.Scope()
    for k, v in state.items():
        jsc.set(k, jnp.array(v))
    tsc = ptt.Scope()
    ptt.load_numpy_state(tsc, state, "cpu")
    return jsc, tsc


def _sig(prog):
    return [(b.idx, b.parent_idx,
             [(op.type, sorted(op.inputs.items()), sorted(op.outputs.items()),
               sorted((k, repr(v)) for k, v in op.attrs.items()))
              for op in b.ops]) for b in prog.blocks]


def test_seq2seq_program_matches_jax_and_survives_json():
    """Both packages build the same program (blocks, parents, op types,
    slots, attrs; the rnn op's sub_block) and startup, with the same
    parameter names; the port's JSON loads back equal."""
    jm, js, _ = build_seq2seq(pt, V, D, LR)
    tm, ts, _ = build_seq2seq(ptt, V, D, LR)
    assert _sig(tm) == _sig(jm) and _sig(ts) == _sig(js)
    assert [p.name for p in tm.all_parameters()] == \
        [p.name for p in jm.all_parameters()]
    assert len(tm.blocks) == 2 and tm.blocks[1].parent_idx == 0
    rnn = next(op for op in tm.global_block().ops if op.type == "rnn")
    assert rnn.attrs["sub_block"] == 1
    assert tm.current_block_idx == 0
    back = ptt.Program.from_json(tm.to_json())
    assert _sig(back) == _sig(tm)
    assert {op.type for op in tm.blocks[1].ops} == {
        "elementwise_add", "gru_unit", "matmul", "mul", "softmax",
        "squeeze", "sum", "unsqueeze"}


def test_data_feeder_matches_jax():
    """Ragged rows padded the same way in both packages: ids, @LEN,
    dtypes, the bucket rounding; the id bound check raises in both."""
    jm, _, _ = build_seq2seq(pt, V, D, LR)
    tm, _, _ = build_seq2seq(ptt, V, D, LR)
    for mult in (1, 8):
        rows = _rows(3)
        jf = pt.DataFeeder([jm.global_block().var(n)
                            for n in ("src", "tgt", "lbl")],
                           seq_bucket_multiple=mult).feed(rows)
        tf = ptt.DataFeeder([tm.global_block().var(n)
                             for n in ("src", "tgt", "lbl")],
                            seq_bucket_multiple=mult).feed(rows)
        assert jf.keys() == tf.keys()
        for k in jf:
            assert tf[k].dtype == jf[k].dtype, k
            np.testing.assert_array_equal(tf[k], jf[k], err_msg=k)
        assert tf["src"].shape[1] == (T if mult == 1 else 8)
    for pkg, m in ((pt, jm), (ptt, tm)):
        with pytest.raises(ValueError, match="outside"):
            pkg.DataFeeder([m.global_block().var("src")],
                           id_bounds={"src": 5}).feed([([7, 1],)])


def test_data_feeder_pads_nested_rows_like_jax():
    jv = pt.layers.data("n", shape=[], dtype="int64", lod_level=2)
    tv = ptt.layers.data("n", shape=[], dtype="int64", lod_level=2)
    rows = [([[1, 2, 3], [4]],), ([[5]],), ([[6, 7], [8, 9], [1]],)]
    jf = pt.DataFeeder([jv], seq_bucket_multiple=1).feed(rows)
    tf = ptt.DataFeeder([tv], seq_bucket_multiple=1).feed(rows)
    assert jf.keys() == tf.keys() == {"n", "n@LEN", "n@LEN2"}
    for k in jf:
        assert tf[k].dtype == jf[k].dtype
        np.testing.assert_array_equal(tf[k], jf[k])


def _grads_close(names, got, want, scale_tol):
    for n, g, w in zip(names, got, want):
        assert g.dtype == w.dtype, n
        err = np.abs(g.astype(np.float64) - w).max()
        assert err <= scale_tol * np.abs(w).max(), (n, err, np.abs(w).max())


@pytest.mark.parametrize("via_json", [False, True])
def test_one_fp32_step_matches_jax(via_json):
    """The loss and every <param>@GRAD of one fp32 step."""
    jm, jl, tm, tl, state = _both(via_json)
    feed = _feed(pt, jm)
    params = [p.name for p in jm.all_parameters()]
    fetch = [jl.name] + [p + "@GRAD" for p in params]
    jsc, tsc = _scopes(state)
    jout = pt.Executor(pt.CPUPlace()).run(jm, feed=feed, fetch_list=fetch,
                                          scope=jsc)
    tout = ptt.Executor(ptt.CPUPlace()).run(tm, feed=feed, fetch_list=fetch,
                                            scope=tsc)
    np.testing.assert_allclose(tout[0], jout[0], rtol=1e-5)
    _grads_close(fetch[1:], tout[1:], jout[1:], 1e-4)
    assert all(np.abs(g).max() > 0 for g in tout[1:])


@pytest.mark.parametrize("amp", [False, True])
def test_three_run_steps_match_jax(amp):
    """Three steps of run_steps from the same start on stacked ragged
    feeds: losses, parameters, moments and beta pows.  Under AMP the
    Adam step is zero in both packages (bf16(0.999) = 1.0) and the
    beta pows follow bf16 arithmetic; in fp32 the parameters move."""
    jm, jl, tm, tl, state = _both(via_json=True)
    feed = ptt.stack_feeds([_feed(ptt, tm, seed=s) for s in range(3)])
    assert feed["src@LEN"].dtype == np.int32 and feed["src"].shape[0] == 3
    jsc, tsc = _scopes(state)
    jl3, = pt.Executor(pt.CPUPlace(), amp=amp).run_steps(
        3, jm, feed=feed, fetch_list=[jl], scope=jsc, feeds_stacked=True)
    tl3, = ptt.Executor(ptt.CPUPlace(), amp=amp).run_steps(
        3, tm, feed=feed, fetch_list=[tl], scope=tsc, feeds_stacked=True)
    np.testing.assert_allclose(tl3, jl3, rtol=2e-2 if amp else 1e-5)
    params = [p.name for p in jm.all_parameters()]
    for k in state:
        got, want = tsc.numpy(k), jsc.numpy(k)
        assert got.dtype == want.dtype, k
        if k in params:
            moved = np.abs(got - state[k]).max()
            if amp:
                assert moved == 0.0 and np.array_equal(want, state[k]), k
            else:
                assert moved > 0.0, k
                np.testing.assert_allclose(got, want, rtol=0, atol=5e-3 * LR,
                                           err_msg=k)
        elif "_pow_" in k:
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=k)
    b2p = next(k for k in state if k.endswith("beta2_pow_0"))
    assert tsc.numpy(b2p)[0] == (1.0 if amp else np.float32(0.999) ** 4)


def test_one_amp_step_matches_jax():
    """One AMP step: the fp32 loss and the fp32 <param>@GRADs (of the
    bf16 forward) within the bf16 tolerance, in the same dtypes."""
    jm, jl, tm, tl, state = _both(via_json=False)
    feed = _feed(pt, jm, seed=1)
    params = [p.name for p in jm.all_parameters()]
    fetch = [jl.name] + [p + "@GRAD" for p in params]
    jsc, tsc = _scopes(state)
    jout = pt.Executor(pt.CPUPlace(), amp=True).run(
        jm, feed=feed, fetch_list=fetch, scope=jsc)
    tout = ptt.Executor(ptt.CPUPlace(), amp=True).run(
        tm, feed=feed, fetch_list=fetch, scope=tsc)
    assert tout[0].dtype == jout[0].dtype == np.float32
    np.testing.assert_allclose(tout[0], jout[0], rtol=2e-2)
    _grads_close(fetch[1:], tout[1:], jout[1:], 5e-2)


def test_run_steps_of_lengths_equal_separate_runs():
    """run_steps over stacked feeds with @LEN companions equals the same
    batches run one by one: each step reads its own lengths."""
    _, _, tm, tl, state = _both(via_json=False)
    per = [_feed(ptt, tm, seed=s) for s in range(2)]
    _, a = _scopes(state)
    _, b = _scopes(state)
    stacked, = ptt.Executor(ptt.CPUPlace()).run_steps(
        2, tm, feed=ptt.stack_feeds(per), fetch_list=[tl], scope=a,
        feeds_stacked=True)
    exe = ptt.Executor(ptt.CPUPlace())
    one = [exe.run(tm, feed=f, fetch_list=[tl], scope=b)[0] for f in per]
    np.testing.assert_array_equal(stacked, np.asarray(one))
    for k in state:
        np.testing.assert_array_equal(a.numpy(k), b.numpy(k), err_msg=k)


def test_len_feeds_stay_integers_through_amp_and_run_steps():
    """@LEN feeds keep their integer dtype and values through the feed
    staging, the AMP backward (``_to_bf16`` casts only fp32) and
    stacked run_steps; the rnn output's @LEN set in the forward env is
    fetchable after the step."""
    from paddle_tpu_torch.core.executor import _to_bf16
    _, _, tm, tl, state = _both(via_json=False)
    feed = _feed(ptt, tm)
    for t in (torch.arange(3, dtype=torch.int32),
              torch.arange(3, dtype=torch.int64)):
        assert _to_bf16(t) is t
    rnn_out = next(op for op in tm.global_block().ops
                   if op.type == "rnn").output("Outputs")[0]
    names = ["src@LEN", "tgt@LEN", rnn_out + "@LEN"]
    _, tsc = _scopes(state)
    out = ptt.Executor(ptt.CPUPlace(), amp=True).run(
        tm, feed=feed, fetch_list=[tl.name] + names, scope=tsc,
        return_numpy=False)
    for n, v in zip(names, out[1:]):
        assert v.dtype == torch.int32, (n, v.dtype)
        np.testing.assert_array_equal(
            v.numpy(), feed["tgt@LEN" if n != "src@LEN" else n], err_msg=n)
    stacked = ptt.stack_feeds([feed, _feed(ptt, tm, seed=1)])
    _, tsc = _scopes(state)
    lens, = ptt.Executor(ptt.CPUPlace(), amp=True).run_steps(
        2, tm, feed=stacked, fetch_list=["src@LEN"], scope=tsc,
        feeds_stacked=True)
    assert lens.dtype == np.int32
    np.testing.assert_array_equal(lens, stacked["src@LEN"])
