"""Beam-search decoding in the port (paddle_tpu_torch/ops/generation_ops.py,
layers/generation.py, models.seq2seq_infer) against the JAX package on
the CPU, mirroring tests/test_generation.py.  The seq2seq decoder runs
from the JAX startup scope's weights (load_numpy_state); the Markov
decoder (next-token probabilities P[token], computable in numpy) from
the same numpy tables in both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch.ops import generation_ops
from torch_parity import jax_state, reset_both

# scores: both packages sum the same fp32 log-probs in the same order;
# the encoder/decoder products differ in summation order only
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
V, DIM, BEAM, MAX_LEN, SRC_LEN = 50, 16, 3, 6, 7


def _s2s(pkg, beam=BEAM, max_len=MAX_LEN, lp=0.0):
    pkg.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 5
    with pkg.program_guard(main, startup):
        src = pkg.layers.data("src", shape=[SRC_LEN], dtype="int64")
        outs = pkg.models.seq2seq_infer(
            src, V, V, emb_dim=DIM, hidden_dim=DIM, beam_size=beam,
            max_len=max_len, length_penalty=lp)
    return main, startup, outs


def _both_s2s(**kw):
    """(JAX program, outs, scope), (port program, outs, scope) with the JAX
    startup's weights in both."""
    reset_both()
    jm, js, jo = _s2s(pt, **kw)
    tm, _, to = _s2s(ptt, **kw)
    jscope = pt.core.Scope()
    pt.Executor(pt.CPUPlace()).run(js, scope=jscope)
    tscope = ptt.Scope()
    ptt.load_numpy_state(tscope, jax_state(jscope), "cpu")
    return (jm, jo, jscope), (tm, to, tscope)


def _run_jax(prog, outs, scope, feed):
    return [np.asarray(o) for o in pt.Executor(pt.CPUPlace()).run(
        prog, feed=feed, fetch_list=list(outs), scope=scope, is_test=True)]


def _run_port(prog, outs, scope, feed):
    return ptt.Executor(ptt.CPUPlace()).run(
        prog, feed=feed, fetch_list=list(outs), scope=scope, is_test=True)


def _assert_same_decode(j, t):
    (jids, jsc, jlens), (tids, tsc, tlens) = j, t
    assert tids.dtype == np.int32 and tlens.dtype == np.int32
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(tlens, jlens)
    np.testing.assert_allclose(tsc, jsc, **SCORE_TOL)


@pytest.mark.parametrize("lp", [0.0, 0.7])
def test_seq2seq_infer_matches_jax(lp):
    (jm, jo, jsc), (tm, to, tsc) = _both_s2s(lp=lp)
    src = np.random.RandomState(0).randint(2, V, (4, SRC_LEN)).astype(
        "int64")
    j = _run_jax(jm, jo, jsc, {"src": src})
    t = _run_port(tm, to, tsc, {"src": src})
    assert t[0].shape == (4, BEAM, MAX_LEN) and t[1].shape == (4, BEAM)
    _assert_same_decode(j, t)
    # beams come out best first
    assert (t[1][:, :-1] >= t[1][:, 1:]).all()


def test_seq2seq_infer_program_through_json():
    """The JAX decoding program, serialized, runs in the port (its
    sub-block, the beam_search op's attrs) and decodes alike."""
    (jm, jo, jsc), _ = _both_s2s()
    tm = ptt.Program.from_json(jm.to_json())
    tscope = ptt.Scope()
    ptt.load_numpy_state(tscope, jax_state(jsc), "cpu")
    src = np.random.RandomState(1).randint(2, V, (3, SRC_LEN)).astype(
        "int64")
    names = [o.name for o in jo]
    _assert_same_decode(_run_jax(jm, jo, jsc, {"src": src}),
                        _run_port(tm, names, tscope, {"src": src}))


def test_exact_ties_follow_lax_top_k():
    """Uniform next-token probabilities (the output layer zeroed): every
    candidate ties, and both packages pick by lax.top_k's rule, the lower
    index first, at every step."""
    (jm, jo, jsc), (tm, to, tsc) = _both_s2s()
    for name in ("s2s.dec_out_w", "s2s.dec_out_b"):
        zero = np.zeros_like(jsc.numpy(name))
        jsc.set(name, jnp.asarray(zero))
        tsc.set(name, torch.from_numpy(zero))
    src = np.random.RandomState(2).randint(2, V, (2, SRC_LEN)).astype(
        "int64")
    j = _run_jax(jm, jo, jsc, {"src": src})
    t = _run_port(tm, to, tsc, {"src": src})
    _assert_same_decode(j, t)
    # step 0 picks tokens 0, 1 and 2 of beam 0; the eos beam (1) stops at
    # log(1/V) while the others lose log(V) a step, so it ranks first
    assert (t[0][:, 0] == 1).all() and (t[2][:, 0] == 1).all()
    np.testing.assert_allclose(t[1][:, 0], -np.log(V), rtol=1e-6)


@pytest.mark.parametrize("n,k", [(12, 3), (40, 5), (7, 7)])
def test_top_k_breaks_ties_by_lower_index(n, k):
    """generation_ops.top_k against lax.top_k on rows full of equal values
    (negatives, zeros, -1e30) and on distinct ones."""
    rng = np.random.RandomState(n)
    x = rng.choice(np.float32([-1e30, -3.5, -0.25, 0.0, 2.0]), (6, n))
    x[0] = rng.randn(n)
    jv, ji = lax.top_k(jnp.asarray(x), k)
    tv, ti = generation_ops.top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ---------------------------------------------------------------------------
# the Markov decoder of tests/test_generation.py
# ---------------------------------------------------------------------------
def _markov(pkg, V, beam_size, max_len, bos, eos, step_hook=None):
    Pvar = pkg.layers.data("P", shape=[V, V], dtype="float32",
                           append_batch_size=False)
    init = pkg.layers.data("init", shape=[1], dtype="float32")
    bs = pkg.layers.BeamSearchDecoder(beam_size=beam_size, bos_id=bos,
                                      eos_id=eos, max_len=max_len,
                                      vocab_size=V, step_hook=step_hook)
    with bs.step():
        tok = bs.token()
        mem = bs.memory(init=init)
        probs = pkg.layers.gather(Pvar, tok)
        bs.update_memory(mem, mem)
        bs.set_probs(probs)
    return bs()


def _markov_run(P, beam, T, bos, eos, batch=2, hook=None):
    reset_both()
    outs = _markov(ptt, P.shape[0], beam, T, bos, eos, step_hook=hook)
    feed = {"P": P, "init": np.zeros((batch, 1), "float32")}
    return ptt.Executor(ptt.CPUPlace()).run(feed=feed, fetch_list=list(outs))


def test_beam_k1_matches_greedy_chain():
    rng = np.random.RandomState(0)
    Vm, T, bos, eos = 5, 4, 0, 4
    P = rng.dirichlet(np.ones(Vm), size=Vm).astype("float32")
    P[:, eos] = 1e-6           # never stop
    P /= P.sum(1, keepdims=True)
    ids, scores, lens = _markov_run(P, 1, T, bos, eos)
    tok, exp_ids, exp_score = bos, [], 0.0
    for _ in range(T):
        nxt = int(np.argmax(P[tok]))
        exp_score += np.log(P[tok, nxt])
        exp_ids.append(nxt)
        tok = nxt
    for b in range(2):
        np.testing.assert_array_equal(ids[b, 0], exp_ids)
        np.testing.assert_allclose(scores[b, 0], exp_score, rtol=1e-5)
    assert (lens == T).all()


def test_beam_finds_better_than_greedy():
    Vm, bos, eos = 4, 0, 3
    P = np.full((Vm, Vm), 1e-9, "float32")
    P[0, 1], P[0, 2] = 0.6, 0.4
    P[1, 1], P[1, 2] = 0.5, 0.5
    P[2, 2] = 1.0
    P /= P.sum(1, keepdims=True)
    ids, scores, _ = _markov_run(P, 2, 3, bos, eos, batch=1)
    np.testing.assert_array_equal(ids[0, 0], [2, 2, 2])
    np.testing.assert_allclose(scores[0, 0], np.log(0.4), rtol=1e-5)


def test_beam_eos_freezes_score():
    Vm, bos, eos = 3, 0, 2
    P = np.full((Vm, Vm), 1e-9, "float32")
    P[0, 2], P[0, 1], P[1, 1] = 0.9, 0.1, 1.0
    P /= P.sum(1, keepdims=True)
    ids, scores, lens = _markov_run(P, 2, 5, bos, eos, batch=1)
    np.testing.assert_array_equal(ids[0, 0], [2] * 5)     # eos, then frozen
    np.testing.assert_allclose(scores[0, 0], np.log(P[0, 2]), rtol=1e-5)
    assert int(lens[0, 0]) == 1


def test_markov_decode_matches_jax_with_ties():
    """A table with tied rows and tied entries, beam 3, in both
    packages: ids, lens and scores agree."""
    Vm, T, bos, eos = 6, 5, 0, 5
    P = np.full((Vm, Vm), 1.0 / Vm, "float32")
    P[1] = np.float32([0.1, 0.3, 0.3, 0.1, 0.1, 0.1])
    want = {}
    for name, pkg in (("jax", pt), ("port", ptt)):
        reset_both()
        outs = _markov(pkg, Vm, 3, T, bos, eos)
        feed = {"P": P, "init": np.zeros((2, 1), "float32")}
        exe = pkg.Executor(pkg.CPUPlace())
        want[name] = [np.asarray(o) for o in exe.run(
            feed=feed, fetch_list=list(outs))]
    _assert_same_decode(want["jax"], want["port"])


def test_beam_step_hook_forces_early_eos():
    """A hook that prunes every candidate but eos from step 2 on stops
    generation there, in ids and lens."""
    rng = np.random.RandomState(1)
    Vm, T, bos, eos = 5, 6, 0, 4
    P = rng.dirichlet(np.ones(Vm), size=Vm).astype("float32")
    P[:, eos] = 1e-9                      # never stops on its own
    P /= P.sum(1, keepdims=True)
    base_ids, _, base_lens = _markov_run(P, 2, T, bos, eos)
    assert (base_lens == T).all()

    def force_eos(t, info):
        assert isinstance(info["scores"], torch.Tensor)
        bias = torch.where(torch.arange(info["scores"].shape[-1]) == eos,
                           0.0, -1e30)[None, None, :]
        return bias if t >= 2 else torch.zeros_like(bias)

    h_ids, _, h_lens = _markov_run(P, 2, T, bos, eos, hook=force_eos)
    assert (h_lens == 3).all(), h_lens
    assert (h_ids[:, :, 2:] == eos).all()
    assert not np.array_equal(h_ids, base_ids)


def test_beam_hook_registry_roundtrip():
    calls = []

    def noop_hook(t, info):
        calls.append(t)
        return None

    L = ptt.layers
    assert L.register_beam_hook("port_noop_hook", noop_hook) == \
        "port_noop_hook"
    assert L.get_beam_hook("port_noop_hook") is noop_hook
    with pytest.raises(KeyError, match="not registered"):
        L.get_beam_hook("no_such_hook")
    rng = np.random.RandomState(0)
    Vm, T, bos, eos = 5, 3, 0, 4
    P = rng.dirichlet(np.ones(Vm), size=Vm).astype("float32")
    P[:, eos] = 1e-6
    P /= P.sum(1, keepdims=True)
    base_ids = _markov_run(P, 2, T, bos, eos, batch=1)[0]
    h_ids = _markov_run(P, 2, T, bos, eos, batch=1,
                        hook="port_noop_hook")[0]
    np.testing.assert_array_equal(h_ids, base_ids)
    assert calls == list(range(T))


def test_recurrent_and_decode_aliases():
    """``recurrent`` runs the ``rnn`` lowering; ``beam_search_decode``
    passes (Ids, Scores) through."""
    from paddle_tpu_torch.core.registry import get_op_impl
    assert get_op_impl("recurrent") is not None
    ids, sc = torch.zeros(2, 3, 4, dtype=torch.int32), torch.zeros(2, 3)
    out = get_op_impl("beam_search_decode")(None, {"Ids": [ids],
                                                   "Scores": [sc]}, {})
    assert out["SentenceIds"] is ids and out["SentenceScores"] is sc
