"""The port's step cache (``paddle_tpu_torch/core/compile_cache.py``) and
the executor's use of it, on the CPU: the content digest survives a JSON
round trip and changes with an edit; the captured-step fingerprint
changes with every part of its key; the LRU evicts by count and by the
bytes charged to its entries, and the dead-program sweep drops; the
kernel wrappers register their launch counters with the cache, which
the core layer reads without importing any op module; a captured step
copies in every state entry that is not its own buffer; the per-program
memos follow version bumps; and on the CPU nothing is captured."""
import ast
import gc
import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import compile_cache
from paddle_tpu_torch.core import executor as executor_mod


def _program(width=8):
    ptt.unique_name.reset()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = ptt.layers.data("x", [width])
        h = ptt.layers.fc(x, 4, act="relu")
        loss = ptt.layers.mean(h)
        ptt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _scope(startup):
    scope = ptt.Scope()
    ptt.Executor(ptt.CPUPlace()).run(startup, scope=scope)
    return scope


def test_digest_is_stable_across_a_json_round_trip():
    main, _, _ = _program()
    d = compile_cache.program_content_digest(main)
    assert d == compile_cache.program_content_digest(main)
    again = ptt.Program.from_json(main.to_json())
    assert compile_cache.program_content_digest(again) == d
    assert compile_cache.program_content_digest(main.clone()) == d


def test_digest_changes_with_an_edit():
    main, _, loss = _program()
    d = compile_cache.program_content_digest(main)
    with ptt.program_guard(main):
        ptt.layers.scale(loss, 2.0)
    assert compile_cache.program_content_digest(main) != d
    main.random_seed += 1
    d2 = compile_cache.program_content_digest(main)
    assert d2 != d
    # a clone edited without a version bump does not inherit the memo
    other = main.clone()
    other.global_block().var("x").dtype = "float64"
    assert compile_cache.program_content_digest(other) != d2


@pytest.mark.parametrize("change", ["feed_shape", "feed_dtype", "feed_name",
                                    "fetch", "is_test", "amp",
                                    "conv1x1_pallas", "state", "program"])
def test_fingerprint_changes_with_each_part_of_the_key(change):
    main, startup, loss = _program()
    scope = _scope(startup)
    exe = ptt.Executor(ptt.CPUPlace())
    feeds = {"x": torch.zeros(2, 8)}
    base = exe._fingerprint(main, feeds, [loss.name], scope, False)
    assert base == exe._fingerprint(main, dict(feeds), [loss.name], scope,
                                    False)
    prog, fetch, is_test = main, [loss.name], False
    if change == "feed_shape":
        feeds = {"x": torch.zeros(3, 8)}
    elif change == "feed_dtype":
        feeds = {"x": torch.zeros(2, 8, dtype=torch.float64)}
    elif change == "feed_name":
        feeds = {"x": torch.zeros(2, 8), "y": torch.zeros(1)}
    elif change == "fetch":
        fetch = [loss.name, "x"]
    elif change == "is_test":
        is_test = True
    elif change == "amp":
        exe = ptt.Executor(ptt.CPUPlace(), amp=True)
    elif change == "conv1x1_pallas":
        exe = ptt.Executor(ptt.CPUPlace(), conv1x1_pallas=False)
    elif change == "state":
        w = next(k for k in scope.keys() if k.endswith(".w_0"))
        scope.set(w, scope.get(w).double())
    elif change == "program":
        prog = main.clone()
        with ptt.program_guard(prog):
            ptt.layers.scale(prog.global_block().var(loss.name), 3.0)
    assert exe._fingerprint(prog, feeds, fetch, scope, is_test) != base


class _Value:
    def __init__(self, log, name):
        self.log, self.name = log, name

    def close(self):
        self.log.append(self.name)


def test_lru_evicts_the_oldest_and_closes_it():
    compile_cache.stats().reset()
    cache, log = compile_cache.ExecCache(max_entries=2), []
    progs = [ptt.Program() for _ in range(3)]
    for i, p in enumerate(progs):
        cache.put(f"k{i}", _Value(log, f"k{i}"), p)
        if i == 1:
            assert cache.get("k0", p).name == "k0"   # k0 becomes recent
    assert log == ["k1"] and len(cache) == 2
    assert cache.get("k1") is None and cache.get("k2").name == "k2"
    s = compile_cache.stats().snapshot()
    assert (s["evictions"], s["hits"], s["misses"]) == (1, 2, 1)
    cache.clear()
    assert sorted(log) == ["k0", "k1", "k2"] and len(cache) == 0


def test_dead_program_sweep_drops_entries_of_collected_programs():
    cache, log = compile_cache.ExecCache(max_entries=8), []
    keep, gone = ptt.Program(), ptt.Program()
    cache.put("keep", _Value(log, "keep"), keep)
    cache.put("gone", _Value(log, "gone"), gone)
    shared = ptt.Program()
    cache.put("shared", _Value(log, "shared"), shared)
    cache.get("shared", keep)            # a second client keeps it alive
    del gone, shared
    gc.collect()
    cache.sweep()
    assert log == ["gone"] and len(cache) == 2
    assert "keep" in cache and "shared" in cache


def test_state_keys_and_random_ops_are_memoized_per_version():
    main, startup, loss = _program()
    scope = _scope(startup)
    exe = ptt.Executor(ptt.CPUPlace())
    keys = exe._state_keys(main, scope)
    assert keys is exe._state_keys(main, scope)
    assert all(scope.has(k) for k in keys)
    assert executor_mod._random_streams(main, False) == []
    with ptt.program_guard(main):
        ptt.layers.dropout(main.global_block().var(loss.name), 0.5)
    streams = executor_mod._random_streams(main, False)
    n = len(main.global_block().ops) - 1
    assert streams == [(0, n, 0)]                        # the dropout
    assert executor_mod._random_streams(main, False) is streams
    assert executor_mod._random_streams(main, True) == []
    assert executor_mod._random_streams(startup, True)   # uniform_random
    scope.set("extra", torch.zeros(1))
    assert exe._state_keys(main, scope) == keys


def test_nothing_is_captured_on_the_cpu():
    main, startup, loss = _program()
    scope = _scope(startup)
    compile_cache.stats().reset()
    exe = ptt.Executor(ptt.CPUPlace())
    assert exe.use_jit
    feed = {"x": np.ones((2, 8), np.float32)}
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    exe.run_steps(3, main, feed=feed, fetch_list=[loss], scope=scope)
    s = compile_cache.stats().snapshot()
    assert s["captures"] == s["replays"] == s["warmups"] == 0
    assert s["uncaptured"] == {"cpu": 4}
    assert len(exe._cache) == 0
    ptt.Executor(ptt.CPUPlace(), use_jit=False).run(
        main, feed=feed, fetch_list=[loss], scope=scope)
    assert compile_cache.stats().snapshot()["uncaptured"] == {
        "cpu": 5}


def test_use_jit_false_matches_default_on_the_cpu():
    main, startup, loss = _program()
    start = _scope(startup)
    feed = {"x": np.random.RandomState(0).rand(5, 2, 8).astype(np.float32)}
    outs = []
    for use_jit in (True, False):
        scope = ptt.Scope()
        for k in start.keys():
            scope.set(k, start.get(k).clone())
        outs.append(ptt.Executor(ptt.CPUPlace(), use_jit=use_jit).run_steps(
            5, main, feed=feed, fetch_list=[loss], scope=scope,
            feeds_stacked=True)[0])
    np.testing.assert_array_equal(outs[0], outs[1])


def test_fingerprint_follows_the_conv1x1_flag_when_the_executor_defers():
    from paddle_tpu_torch import flags
    main, startup, loss = _program()
    scope = _scope(startup)
    exe = ptt.Executor(ptt.CPUPlace())            # conv1x1_pallas=None
    feeds = {"x": torch.zeros(2, 8)}
    before = exe._fingerprint(main, feeds, [loss.name], scope, False)
    saved = flags.get_flag("conv1x1_pallas")
    try:
        flags.set_flag("conv1x1_pallas", not saved)
        flipped = exe._fingerprint(main, feeds, [loss.name], scope, False)
    finally:
        flags.set_flag("conv1x1_pallas", saved)
    assert flipped != before
    pinned = ptt.Executor(ptt.CPUPlace(), conv1x1_pallas=saved)
    assert pinned._fingerprint(main, feeds, [loss.name], scope,
                               False) == before


def test_fingerprint_hex_is_the_keys_stable_string():
    main, startup, loss = _program()
    scope = _scope(startup)
    exe = ptt.Executor(ptt.CPUPlace())
    feeds = {"x": torch.zeros(2, 8)}
    key = exe._fingerprint(main, feeds, [loss.name], scope, False)
    hexed = compile_cache.fingerprint_hex(key)
    assert len(hexed) == 64 and int(hexed, 16) >= 0
    assert compile_cache.fingerprint_hex(exe._fingerprint(
        main, dict(feeds), [loss.name], scope, False)) == hexed
    assert compile_cache.fingerprint_hex(exe._fingerprint(
        main, {"x": torch.zeros(3, 8)}, [loss.name], scope, False)) != hexed


def test_byte_bound_evicts_the_least_recent_never_the_charged_entry():
    compile_cache.stats().reset()
    cache, log = compile_cache.ExecCache(max_entries=8, max_bytes=100), []
    p = ptt.Program()
    for k in "abc":
        cache.put(k, _Value(log, k), p)
    cache.charge("a", 40)
    cache.charge("b", 40)
    assert log == [] and cache.nbytes == 80
    assert cache.get("a", p).name == "a"         # order now c, b, a
    cache.charge("c", 50)                        # 130 > 100: b goes
    assert log == ["b"] and cache.nbytes == 90
    cache.charge("c", 500)                       # alone over the bound
    assert log == ["b", "a"] and len(cache) == 1 and cache.nbytes == 500
    assert compile_cache.stats().snapshot()["evictions"] == 2
    unbounded = compile_cache.ExecCache(max_entries=8)
    unbounded.put("a", _Value(log, "x"), p)
    unbounded.put("b", _Value(log, "y"), p)
    unbounded.charge("a", 10 ** 12)
    unbounded.charge("b", 10 ** 12)
    assert len(unbounded) == 2


def test_kernel_wrappers_register_their_launch_counters():
    from paddle_tpu_torch.ops import conv1x1, flash_attention as fa
    regs = compile_cache.launch_counters()
    for c in (conv1x1.mm.by_form, fa.launches, fa.launches_by_dtype,
              fa.reference_route):
        assert any(r is c for r in regs)
    assert compile_cache.register_launch_counter(fa.launches) is fa.launches
    assert len(compile_cache.launch_counters()) == len(regs)
    # the core layer names no op module: the registry is how it finds them
    core = os.path.dirname(executor_mod.__file__)
    for name in os.listdir(core):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(core, name)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                assert not (node.level >= 2 and mod.split(".")[0] == "ops"), \
                    (name, mod)
                assert not (node.level == 2 and mod == "" and any(
                    a.name == "ops" for a in node.names)), name


def test_load_state_copies_every_entry_but_the_steps_own_buffer():
    step = executor_mod._CapturedStep()
    own, other = torch.zeros(3), torch.ones(3)
    step.static_state = {"own": own, "other": torch.zeros(3)}
    scope = ptt.Scope()
    scope.set("own", own)
    scope.set("other", other)
    step.load_state(scope)
    assert torch.equal(step.static_state["other"], other)
    assert step.static_state["own"] is own
    # written in place with no version bump, as a graph replay writes
    # another captured step's buffer
    version = other._version
    other.data.fill_(5.0)
    assert other._version == version
    step.load_state(scope)
    assert step.static_state["other"].tolist() == [5.0, 5.0, 5.0]
