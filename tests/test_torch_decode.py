"""Continuous-batching incremental decode in the port
(``paddle_tpu_torch/serving/decode.py``, the ``attention_with_cache``
op), held against the JAX package and against itself:

* the op against the JAX op on the same slabs, lengths (``Len == Tmax``
  on a masked row among them) and write masks: outputs within 1e-6 of
  their scale, the cache outputs bit-equal;
* the engine, its weights carried across from the JAX engine's scope,
  teacher-forced on the JAX engine's tokens: every prefill and decode
  step's logits within 1e-5 of their scale, the tokens equal wherever
  the top-two margin exceeds 10x that;
* the port's own invariants: incremental decode bit-equal to the
  recompute oracle under slot churn and relocation, rows independent of
  co-resident slots, continuous and static tokens bit-equal, no new
  capture key after warm-up, an injected transient invisible, a fatal
  fault failing the active sequence then the breaker then recovery,
  and the server's ``submit_decode`` front door;
* on a card (``cuda``): the captured engine bit-equal to
  ``use_jit=False``, a relocation between two replays reaching the
  decode step, one capture per program.

JAX is imported inside the cross-package tests only, so the ``cuda``
test runs on a machine without it (``python3 -m pytest --noconftest -m
cuda tests/test_torch_decode.py``).
"""
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import compile_cache
from paddle_tpu_torch.faults import InjectedFault, ModelUnavailable
from paddle_tpu_torch.serving.decode import (DecodeEngine, DecodeRuntime,
                                             bucket_for_len)
from paddle_tpu_torch.serving.server import ModelError
from paddle_tpu_torch.testing import faultinject as fi

CPU = ptt.CPUPlace()
OP_TOL = 1e-6       # of the output's largest magnitude
LOGIT_TOL = 1e-5    # of the logits row's largest magnitude


def _engine(vocab=23, hidden=12, layers=2, slots=3, seed=5, name="t",
            place=CPU, **kw):
    return DecodeEngine(vocab, hidden_dim=hidden, n_layers=layers,
                        slots=slots, max_len=16, len_buckets=(16,),
                        eos_id=None, seed=seed, name=name, place=place,
                        **kw)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _greedy(eng, slot, prompt, n_steps, cohab=None, churn_at=None,
            churn_prompt=None, tokens=None):
    """Drive the engine by hand: prefill ``prompt`` into ``slot`` (and
    the ``cohab`` prompts into theirs, advanced in lockstep), greedy-
    decode ``n_steps``; at step ``churn_at`` evict the first cohab slot
    and admit ``churn_prompt`` there.  ``tokens`` forces ``slot``'s
    tokens (teacher forcing).  Returns (tokens, [n_steps + 1, V] logit
    rows) of ``slot``."""
    S = eng.slots
    eng.reset()
    cur = np.zeros(S, np.int64)
    lens = np.zeros(S, np.int32)
    act = np.zeros(S, np.float32)
    tok, row = eng.prefill(slot, prompt)
    rows, toks = [row], [tok]
    cur[slot] = tok if tokens is None else tokens[0]
    lens[slot], act[slot] = len(prompt), 1.0
    for s, p in (cohab or {}).items():
        t2, _ = eng.prefill(s, p)
        cur[s], lens[s], act[s] = t2, len(p), 1.0
    for k in range(n_steps):
        if churn_at is not None and k == churn_at:
            victim = next(iter(cohab))
            act[victim] = 0.0                      # evict mid-flight
            t3, _ = eng.prefill(victim, churn_prompt)
            cur[victim], lens[victim] = t3, len(churn_prompt)
            act[victim] = 1.0                      # admit into the hole
        logits = eng.decode_step(cur, lens, act)
        for s in range(S):
            if act[s]:
                nxt = int(np.asarray(logits[s, 0]).argmax())
                if s == slot:
                    rows.append(np.asarray(logits[s, 0], np.float32))
                    toks.append(nxt)
                    if tokens is not None:
                        nxt = tokens[k + 1]
                cur[s] = nxt
                lens[s] += 1
    return toks, np.stack(rows)


def test_bucket_for_len():
    assert bucket_for_len(5, (32, 64)) == 32
    assert bucket_for_len(33, (32, 64)) == 64
    assert bucket_for_len(64, (32, 64)) == 64
    assert bucket_for_len(65, (32, 64)) == 65


# (B, Tq, Tmax, D, lens, write mask): a decode step with a dead slot at
# Len == Tmax (masked) and one at 0, a prefill, a 4-token chunk
OP_CASES = {
    "decode": (4, 1, 16, 8, [5, 16, 0, 15], [1.0, 0.0, 0.0, 1.0]),
    "prefill": (1, 16, 16, 8, [0], [1.0]),
    "chunk": (3, 4, 16, 6, [0, 7, 12], [1.0, 1.0, 0.0]),
}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_attention_with_cache_matches_jax(case):
    import jax.numpy as jnp
    from paddle_tpu.core.registry import get_op_impl as jax_op
    from paddle_tpu_torch.core import get_op_impl

    B, Tq, Tmax, D, lens, wm = OP_CASES[case]
    rng = np.random.RandomState(3)
    arrs = {"Q": rng.randn(B, Tq, D), "K": rng.randn(B, Tq, D),
            "V": rng.randn(B, Tq, D), "CacheK": rng.randn(B, Tmax, D),
            "CacheV": rng.randn(B, Tmax, D)}
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    arrs["Len"] = np.asarray(lens, np.int32)
    arrs["WriteMask"] = np.asarray(wm, np.float32)
    want = jax_op("attention_with_cache")(
        None, {k: [jnp.asarray(v)] for k, v in arrs.items()}, {})
    got = get_op_impl("attention_with_cache")(
        None, {k: [torch.from_numpy(v)] for k, v in arrs.items()}, {})
    w_out = np.asarray(want["Out"])
    g_out = got["Out"].numpy()
    assert g_out.shape == w_out.shape == (B, Tq, D)
    assert np.abs(g_out - w_out).max() <= OP_TOL * np.abs(w_out).max()
    for k in ("CacheKOut", "CacheVOut"):
        np.testing.assert_array_equal(_bits(got[k].numpy()),
                                      _bits(np.asarray(want[k])))
    # the masked rows' slabs are untouched
    for b, m in enumerate(wm):
        if m <= 0:
            np.testing.assert_array_equal(got["CacheKOut"][b].numpy(),
                                          arrs["CacheK"][b])


def test_engine_teacher_forced_matches_jax():
    """The JAX engine's weights in the port's engine; both driven with the
    JAX engine's tokens through a churned three-slot schedule."""
    from paddle_tpu.serving.decode import DecodeEngine as JaxEngine

    kw = dict(hidden_dim=12, n_layers=2, slots=3, max_len=16,
              len_buckets=(16,), eos_id=None, seed=5, name="par")
    jeng = JaxEngine(23, **kw)
    eng = DecodeEngine(23, place=CPU, **kw)
    eng.load_numpy_state({n: jeng.scope.numpy(n)
                          for n in eng.param_names()})
    sched = dict(cohab={0: [2, 5], 2: [9, 9, 1, 4, 4]}, churn_at=3,
                 churn_prompt=[8, 8, 4])
    prompt, n = [3, 7, 1, 9], 8
    jtoks, jrows = _greedy(jeng, 1, prompt, n, **sched)
    toks, rows = _greedy(eng, 1, prompt, n, tokens=jtoks, **sched)
    checked = 0
    for t in range(n + 1):
        scale = np.abs(jrows[t]).max()
        assert np.abs(rows[t] - jrows[t]).max() <= LOGIT_TOL * scale, t
        top2 = np.sort(jrows[t])[-2:]
        if top2[1] - top2[0] > 10 * LOGIT_TOL * scale:
            assert toks[t] == jtoks[t], t
            checked += 1
    assert checked >= n // 2


def test_load_numpy_state_refuses_unknown_names():
    eng = _engine(layers=1, name="w")
    with pytest.raises(KeyError, match="no weights named"):
        eng.load_numpy_state({"w/l7/wq": np.zeros((12, 12), np.float32)})


def test_incremental_decode_matches_recompute_oracle():
    """The incremental path reuses the slabs across every step; the
    oracle rebuilds them from zero for each token (reset, prefill,
    replay the recorded prefix through the same one-token program) in
    another slot beside another neighbour, and must land on the same
    bits, under slot churn in the incremental run."""
    eng = _engine(name="oracle")
    prompt, n = [3, 7, 1, 9], 6
    toks, rows = _greedy(eng, 0, prompt, n, cohab={1: [2, 5]},
                         churn_at=3, churn_prompt=[8, 8, 4])
    assert len(toks) == n + 1 and rows.shape == (n + 1, eng.vocab_size)
    assert toks == [int(r.argmax()) for r in rows]
    for t in range(n + 1):
        eng.reset()
        first, row = eng.prefill(2, prompt)
        eng.prefill(0, [6, 2, 2, 1, 5])
        assert first == toks[0]
        if t == 0:
            replay = row
        else:
            cur = np.zeros(eng.slots, np.int64)
            lens = np.zeros(eng.slots, np.int32)
            act = np.zeros(eng.slots, np.float32)
            lens[2], act[2] = len(prompt), 1.0
            for k in range(t):
                cur[2] = toks[k]
                logits = eng.decode_step(cur, lens, act)
                lens[2] += 1
            replay = np.asarray(logits[2, 0], np.float32)
        np.testing.assert_array_equal(
            _bits(replay), _bits(rows[t]),
            err_msg=f"recompute oracle diverged at token step {t}")


def test_decode_rows_independent_of_coresidents():
    eng = _engine(name="indep")
    prompt = [4, 11, 2]
    toks_solo, rows_solo = _greedy(eng, 1, prompt, 5)
    toks_full, rows_full = _greedy(eng, 1, prompt, 5,
                                   cohab={0: [9, 1], 2: [6, 6, 6, 3]})
    assert toks_solo == toks_full
    np.testing.assert_array_equal(_bits(rows_solo), _bits(rows_full))


def test_continuous_and_static_tokens_identical():
    """The same weights under both schedulers: every request's tokens
    bit-equal, and the static arm takes more decode steps."""
    reqs = [([1 + i % 5, 2, 7][: 1 + i % 3], (2, 9, 4, 6)[i % 4])
            for i in range(7)]
    base = _engine(vocab=19, hidden=8, layers=1, slots=3, name="cs")
    weights = {n: base.scope.get(n).numpy() for n in base.param_names()}
    outs, steps = {}, {}
    for mode in ("continuous", "static"):
        eng = _engine(vocab=19, hidden=8, layers=1, slots=3, name="cs")
        eng.load_numpy_state(weights)
        rt = DecodeRuntime(eng, mode=mode, step_wait_ms=0.5).start()
        try:
            pending = [rt.submit(p, m) for p, m in reqs]
            outs[mode] = [r.result(timeout=60.0)["tokens"] for r in pending]
        finally:
            rt.shutdown(drain=True, timeout=60.0)
        steps[mode] = rt.health()["steps"]
    assert outs["continuous"] == outs["static"]
    assert [len(t) for t in outs["static"]] == [m for _, m in reqs]
    assert steps["static"] > steps["continuous"]


def test_steady_state_decode_makes_no_new_key():
    """After warm-up the pool serves mixed prompt and generation lengths
    with admit/evict churn through the same two capture keys (and, on
    the card, no new capture, warm-up or cache miss)."""
    eng = _engine(vocab=13, hidden=8, layers=1, slots=2, name="keys")
    rt = DecodeRuntime(eng, step_wait_ms=0.5, default_deadline_ms=None)
    rt.start(warmup=True)
    keys = set(eng.keys)
    assert len(keys) == 2
    try:
        c0 = compile_cache.stats().snapshot()
        reqs = [rt.submit([1 + (i % 7), 2, 3][: 1 + (i % 3)], 1 + (i % 5))
                for i in range(9)]
        outs = [r.result(timeout=120.0) for r in reqs]
        c1 = compile_cache.stats().snapshot()
    finally:
        rt.shutdown(drain=True, timeout=60.0)
    for i, o in enumerate(outs):
        assert len(o["tokens"]) == 1 + (i % 5)
        assert o["finish"] == "length"
    assert eng.keys == keys
    for k in ("captures", "warmups", "misses"):
        assert c1[k] == c0[k], k


def test_decode_step_transient_fault_is_invisible():
    eng = _engine(vocab=19, hidden=8, layers=1, slots=2, name="fit")
    rt = DecodeRuntime(eng, step_wait_ms=0.5, default_deadline_ms=None)
    rt.start(warmup=True)
    trace = [([2, 9], 4), ([5, 1, 7], 3), ([8], 5)]
    try:
        base = [r.result(timeout=60.0)["tokens"]
                for r in [rt.submit(p, m) for p, m in trace]]
        fi.configure("serving.decode_step@2=transient")
        inj = [r.result(timeout=60.0)["tokens"]
               for r in [rt.submit(p, m) for p, m in trace]]
        assert fi.fired("serving.decode_step") == 1
        assert inj == base
        assert rt.breaker_state() == "closed"
    finally:
        fi.clear()
        rt.shutdown(drain=True, timeout=60.0)


def test_decode_step_fatal_fault_breaker_and_recovery():
    """A fatal fault at the decode step fails the active sequence with a
    typed error, leaves the queued request alive, opens the breaker
    (admission refused), and the probe after the cooldown recovers."""
    eng = _engine(vocab=19, hidden=8, layers=1, slots=1, name="fif")
    rt = DecodeRuntime(eng, step_wait_ms=0.5, default_deadline_ms=None,
                       breaker_threshold=1, breaker_cooldown_s=0.3)
    rt.start(warmup=True)
    try:
        fi.configure("serving.decode_step@1=fatal")
        r1 = rt.submit([2, 9], 4)          # takes the only slot
        r2 = rt.submit([5, 1, 7], 3)       # queued behind it
        with pytest.raises(ModelError):
            r1.result(timeout=60.0)
        assert fi.fired("serving.decode_step") == 1
        fi.clear()
        assert rt.breaker_state() == "open"
        with pytest.raises(ModelUnavailable):
            rt.submit([3, 3], 2)
        out = r2.result(timeout=60.0)
        assert len(out["tokens"]) == 3 and out["finish"] == "length"
        deadline = time.monotonic() + 5.0
        while rt.breaker_state() != "closed" \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert rt.breaker_state() == "closed"
        assert len(rt.submit([4], 2).result(timeout=60.0)["tokens"]) == 2
    finally:
        fi.clear()
        rt.shutdown(drain=True, timeout=60.0)
    assert isinstance(r1.error, (ModelError, InjectedFault))


def test_server_decode_front_door():
    from paddle_tpu_torch.faults import ServerClosed
    from paddle_tpu_torch.serving import Server

    eng = _engine(vocab=19, hidden=8, layers=1, slots=2, name="srv")
    srv = Server(deadline_ms=None)
    srv.add_decode_model(eng, name="gen")
    with pytest.raises(ValueError, match="duplicate"):
        srv.add_decode_model(eng, name="gen")
    srv.start()
    try:
        outs = [srv.submit_decode([2, 9, 4], 3, model="gen")
                .result(timeout=60.0) for _ in range(3)]
        assert all(o["tokens"] == outs[0]["tokens"] for o in outs)
        assert all(o["ttft_ms"] >= 0 and len(o["inter_token_ms"]) == 2
                   for o in outs)
        h = srv.health()
        assert h["decode"]["gen"]["served"] >= 3
        assert h["decode"]["gen"]["mode"] == "continuous"
    finally:
        srv.shutdown(drain=True)
    with pytest.raises(ServerClosed):
        srv.submit_decode([1], 1, model="gen")


def test_autotune_and_oversized_requests_refused():
    with pytest.raises(NotImplementedError, match="item 9"):
        _engine(name="at", autotune=True)
    eng = _engine(layers=1, name="big")
    with pytest.raises(NotImplementedError, match="item 9"):
        DecodeRuntime(eng, autotune=True)
    rt = DecodeRuntime(eng)
    with pytest.raises(ValueError, match="bucket"):
        rt.submit([1] * 10, 7)


def test_decode_bench_smoke_row_complete():
    from paddle_tpu_torch.benchmark import decode

    row = decode.run_all(smoke=True, place=CPU, quiet=True)
    assert row["smoke"] is True and row["device"] == "cpu"
    ab = row["ab"]
    assert len(ab["pair_ratios"]) >= 2
    assert len(ab["default_windows"]) == len(ab["candidate_windows"])
    assert ab["min_speedup"] == 1.3
    assert ab["accepted"] or ab["refusal_reason"]
    for arm in ("static", "continuous"):
        r = row[arm]
        assert r["mode"] == arm
        assert r["decode_tokens_per_s"] > 0
        assert r["ttft_ms"]["p99"] >= r["ttft_ms"]["p50"]
        assert r["inter_token_ms"]["p99"] >= r["inter_token_ms"]["p50"]
        assert 0 < r["slot_occupancy"] <= 1
    assert row["arms_tokens_identical"] is True
    assert row["capture_keys"] == {"static": 2, "continuous": 2}
    # the doctor pass: a token-step budget over its own observed window
    doc = row["doctor"]
    assert doc["steps"] > 0 and doc["tokens"] > 0
    assert doc["dispatch_ms_mean"] is not None and doc["top"] in (
        "dispatch", "scheduler")
    assert row["stats_decode"]["sequences_done"] == len(
        decode.trace(decode.SMOKE))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    yield ptt.CUDAPlace(0)


@pytest.mark.cuda
def test_captured_engine_equals_use_jit_false(card):
    """The captured engine against ``use_jit=False`` with the same
    weights through a churned schedule: every logits row bit-equal (the
    churn relocates rows into the slabs between two decode replays), one
    capture per program, and no step run uncaptured."""
    runs = {}
    weights = None
    sched = dict(cohab={0: [2, 5], 2: [9, 9, 1, 4, 4]}, churn_at=3,
                 churn_prompt=[8, 8, 4])
    for use_jit in (True, False):
        eng = _engine(name="cap", place=card, use_jit=use_jit)
        if weights is None:
            weights = {n: eng.scope.get(n).cpu().numpy()
                       for n in eng.param_names()}
        eng.load_numpy_state(weights)
        eng.warmup()
        c0 = compile_cache.stats().snapshot()
        runs[use_jit] = _greedy(eng, 1, [3, 7, 1, 9], 8, **sched)
        c1 = compile_cache.stats().snapshot()
        if use_jit:
            assert len(eng.executor.graph_pools()) == 2
            assert c1["replays"] - c0["replays"] >= 8
            for k in ("captures", "warmups", "misses"):
                assert c1[k] == c0[k], k
            assert c1["uncaptured"] == c0["uncaptured"]
    (t1, r1), (t2, r2) = runs[True], runs[False]
    assert t1 == t2
    np.testing.assert_array_equal(_bits(r1), _bits(r2))
