"""The port's autotuner (paddle_tpu_torch.tuning) held against the JAX
package's (paddle_tpu.tuning) on the CPU: the registry's declaration
errors, the seven shared host knobs' spaces and digests, the searches
and the paired A/B's noise gate under one deterministic clock, the
store's round trip and invalidation matrix, replay at every host call
site, the pending stub of the device knobs, fault containment, the
``tune`` command line and the tuning events in the port's log summary;
then the card's knobs: K1's launch plans (``cuda/conv1x1_plan``) and
K2-K4's ring depths (``cuda/flash_attention``), and, on a card, one
non-default plan and depth of each against the plain versions."""
import json
import os
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch import flags
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.executor import CPUPlace
from paddle_tpu_torch.testing import faultinject as tfi

CPU = CPUPlace()
HOST_KNOBS = ("executor/run_pipelined", "reader/prefetch", "serving/batcher",
              "serving/decode_slots", "sparse/hot_rows", "sparse/prefetch",
              "sparse/push_flush")
KNOB = "test/knob"


def _declare_jax_host_knobs():
    """Import the JAX subsystems that declare the host knobs."""
    import paddle_tpu.serving.decode  # noqa: F401
    import paddle_tpu.serving.server  # noqa: F401
    import paddle_tpu.sparse.session  # noqa: F401


def _declare_port_host_knobs():
    import paddle_tpu_torch.serving.decode  # noqa: F401
    import paddle_tpu_torch.serving.server  # noqa: F401
    import paddle_tpu_torch.sparse.session  # noqa: F401


@pytest.fixture(autouse=True)
def fresh_port_programs():
    ptt.core.reset_default_programs()
    ptt.core.reset_global_scope()
    ptt.unique_name.reset()


@pytest.fixture
def tuning():
    """The port's tuning package (imported lazily, as a call site does)
    with a clean memo and fault state."""
    from paddle_tpu_torch import tuning as t
    t.clear_memo()
    tfi.clear()
    yield t
    t.clear_memo()
    tfi.clear()


@pytest.fixture
def knob(tuning):
    """A throwaway tunable declared alike in both registries."""
    from paddle_tpu.core import registry as jreg
    decl = dict(side="host", space={"a": (1, 2), "b": (10, 20)},
                default={"a": 1, "b": 10}, description="test knob")
    for reg in (treg, jreg):
        reg._TUNABLES.pop(KNOB, None)
    tentry = treg.register_tunable(KNOB, **decl)
    jentry = jreg.register_tunable(KNOB, **decl)
    yield KNOB, tentry, jentry
    for reg in (treg, jreg):
        reg._TUNABLES.pop(KNOB, None)


@pytest.fixture
def autotune_env(tmp_path, tuning):
    """The port's cache_dir and autotune flags on a throwaway store."""
    prev = {n: flags.get_flag(n) for n in ("cache_dir", "autotune")}
    flags.set_flag("cache_dir", str(tmp_path))
    flags.set_flag("autotune", True)
    yield str(tmp_path)
    for n, v in prev.items():
        flags.set_flag(n, v)
    tuning.clear_memo()


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
BAD_DECLARATIONS = [
    ("twice", KNOB, dict(side="host", space={"a": (1,)}, default={"a": 1}),
     "registered twice"),
    ("side", "test/bad", dict(side="gpu", space={"a": (1,)},
                              default={"a": 1}), "side"),
    ("empty_space", "test/bad", dict(side="host", space={}, default={}),
     "empty"),
    ("default_keys", "test/bad", dict(side="host", space={"a": (1,)},
                                      default={"a": 1, "b": 2}),
     "default keys"),
    ("default_outside", "test/bad", dict(side="host", space={"a": (1, 2)},
                                         default={"a": 3}),
     "not in its axis"),
    ("duplicates", "test/bad", dict(side="host", space={"a": (1, 1)},
                                    default={"a": 1}), "duplicate values"),
    ("empty_axis", "test/bad", dict(side="host", space={"a": ()},
                                    default={"a": 1}), "is empty"),
    ("no_rule", "test/bad", dict(side="device", space={"a": (1,)},
                                 default={"a": 1}, pending_hardware=True),
     "decision_rule"),
    ("namespace", "flatname", dict(side="host", space={"a": (1,)},
                                   default={"a": 1}), "not namespaced"),
]


@pytest.mark.parametrize("case,name,decl,match", BAD_DECLARATIONS,
                         ids=[c[0] for c in BAD_DECLARATIONS])
def test_bad_declarations_raise_in_both_registries(knob, case, name, decl,
                                                   match):
    from paddle_tpu.core import registry as jreg
    for reg in (treg, jreg):
        with pytest.raises(ValueError, match=match):
            reg.register_tunable(name, **decl)
        assert "test/bad" not in reg._TUNABLES


@pytest.mark.parametrize("name", HOST_KNOBS)
def test_host_knob_matches_the_jax_declaration(tuning, name):
    """Each host knob: the same space, default, side, grid order,
    validation problems and schema digest as the JAX package's."""
    from paddle_tpu.tuning import tunables as jtn
    _declare_jax_host_knobs()
    _declare_port_host_knobs()
    t, j = tuning.get_tunable(name), jtn.get_tunable(name)
    for key in ("side", "space", "default", "pending_hardware"):
        assert t[key] == j[key], key
    assert list(tuning.grid_configs(t)) == list(jtn.grid_configs(j))
    assert tuning.space_digest(t) == jtn.space_digest(j)
    probes = [dict(t["default"]), {}, {**t["default"], "zz": 0},
              {k: "nope" for k in t["space"]}]
    for cfg in probes:
        assert tuning.validate_config(t, cfg) == \
            jtn.validate_config(j, cfg)


def test_port_declares_its_own_device_knobs(tuning):
    """The JAX package's pallas/* and xla/* knobs have no counterpart;
    the port's device knobs are its own, each pending hardware with a
    decision rule written for the card."""
    from paddle_tpu_torch.tuning import targets
    for n in targets.target_names():
        targets.ensure_registered(n)
    names = tuning.registered_tunables()
    assert not [n for n in names if n.startswith(("pallas/", "xla/"))]
    device = [n for n in names if tuning.get_tunable(n)["side"] == "device"]
    assert device == ["cuda/conv1x1_plan", "cuda/flash_attention",
                      "cuda/fused_optimizer_update", "cuda/lod_gather_scatter",
                      "cuda/paged_kv_gather"]
    for n in device:
        e = tuning.get_tunable(n)
        assert e["pending_hardware"] and "1.1" in e["decision_rule"]
    assert set(HOST_KNOBS) <= set(names)


# ---------------------------------------------------------------------------
# Search parity under one deterministic clock
# ---------------------------------------------------------------------------
class _Clock:
    """A fake ``time.perf_counter``: time moves only when a measure runs,
    so every call order reads the same windows."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _measure(clock, costs, fail=()):
    """A deterministic one-window measure: each call advances the clock
    by its config's cost, scaled by a repeating per-call factor."""
    calls = [0]

    def measure(cfg):
        key = (cfg["a"], cfg["b"])
        if key in fail:
            raise RuntimeError("this config cannot run")
        calls[0] += 1
        clock.t += costs[key] * (1.0 + 0.05 * (calls[0] % 4))
    return measure


COSTS = {(1, 10): 0.015, (1, 20): 0.004, (2, 10): 0.012, (2, 20): 0.009}


def _both(monkeypatch, run):
    """``run(pkg_search, measure)`` in the port and in the JAX package,
    each from a fresh clock."""
    from paddle_tpu.tuning import search as jsearch
    from paddle_tpu_torch.tuning import search as tsearch
    out = []
    for mod in (tsearch, jsearch):
        clock = _Clock()
        monkeypatch.setattr(time, "perf_counter", clock)
        out.append(run(mod, clock))
    monkeypatch.undo()
    return out


def test_grid_search_matches_jax(knob, monkeypatch):
    name = knob[0]
    t, j = _both(monkeypatch, lambda s, c: s.grid_search(
        name, _measure(c, COSTS, fail={(2, 10)}), reps=3, warmup=1))
    assert t.to_dict() == j.to_dict()
    assert t.best == {"a": 1, "b": 20}
    assert [x.status for x in t.trials].count("failed") == 1


def test_successive_halving_matches_jax(knob, monkeypatch):
    name = knob[0]
    t, j = _both(monkeypatch, lambda s, c: s.successive_halving(
        name, _measure(c, COSTS), reps=3, warmup=1, eta=2))
    assert t.to_dict() == j.to_dict()
    assert t.best == {"a": 1, "b": 20} and t.algo == "halving"


@pytest.mark.parametrize("ratio", [1.0, 1.5])
def test_paired_ab_matches_jax(knob, monkeypatch, ratio):
    costs = {(1, 10): 0.01 * ratio, (2, 20): 0.01}
    t, j = _both(monkeypatch, lambda s, c: s.paired_ab(
        _measure(c, costs), {"a": 1, "b": 10}, {"a": 2, "b": 20},
        pairs=5, warmup=1))
    assert t == j
    assert t["accepted"] == (ratio > 1.2)
    assert len(t["pair_ratios"]) == 5


def test_tune_document_matches_jax(knob, monkeypatch):
    name = knob[0]
    t, j = _both(monkeypatch, lambda s, c: s.tune(
        name, _measure(c, COSTS), reps=2, pairs=3, warmup=0, save=False))
    assert t == j
    assert t["status"] == "winner" and t["winner"] == {"a": 1, "b": 20}


def test_run_trial_soft_timeout_is_contained(tuning, knob):
    from paddle_tpu_torch.tuning.search import run_trial
    t = run_trial(lambda cfg: time.sleep(0.05), {"a": 1, "b": 10}, reps=3,
                  warmup=0, trial_timeout_s=0.01)
    assert t.status == "timeout" and t.seconds is None


def test_fault_site_fail_and_timeout_become_trials(tuning, knob):
    """The ``tuning.trial`` site's ``fail`` and ``timeout`` are recorded
    trials, and the search goes on."""
    tfi.configure("tuning.trial@1=fail;tuning.trial@2=timeout")
    result = tuning.grid_search(knob[0], lambda cfg: None, reps=1, warmup=0)
    assert [t.status for t in result.trials] == \
        ["failed", "timeout", "ok", "ok"]
    assert "injected" in result.trials[0].error
    assert tfi.fired("tuning.trial") == 2
    assert result.best is not None


# ---------------------------------------------------------------------------
# Store
# ---------------------------------------------------------------------------
def test_store_roundtrip_and_merge_subset(tuning, knob, tmp_path):
    name, base = knob[0], str(tmp_path)
    path = tuning.save_record(name, {"a": 2, "b": 20}, base=base,
                              speedup=1.5)
    assert os.path.basename(path).startswith("ptat-")
    assert os.path.dirname(path) == os.path.join(base, "tuning")
    rec = tuning.load_record(name, base=base)
    assert rec["config"] == {"a": 2, "b": 20} and rec["speedup"] == 1.5
    assert rec["topology"] == ["cpu", 0]
    assert tuning.tuned(name, {"a": 1, "b": 10}, base=base) == \
        {"a": 2, "b": 20}
    tuning.clear_memo()
    assert tuning.tuned(name, {"a": 1}, base=base) == {"a": 2}
    assert [p for p, _ in tuning.list_records(base=base)] == [path]


def test_store_refuses_a_foreign_config(tuning, knob, tmp_path):
    with pytest.raises(ValueError, match="declared space"):
        tuning.save_record(knob[0], {"a": 7, "b": 10}, base=str(tmp_path))


def test_tuned_without_record_returns_the_default_object(tuning, knob,
                                                         tmp_path):
    from paddle_tpu_torch.tuning import store
    default = {"a": 1, "b": 10}
    assert tuning.tuned(knob[0], default, base=str(tmp_path)) is default
    assert tuning.tuned(knob[0], default, base=str(tmp_path)) is default
    assert store.probes() == {(knob[0], "", str(tmp_path)): 1}


def test_store_invalidation_matrix(tuning, knob, tmp_path, monkeypatch):
    """Another format, an edited space, another context, another card,
    new torch/CUDA/port versions, and a corrupt, drifted or foreign
    record: each falls back to the default, without an error."""
    from paddle_tpu_torch.core import compile_cache
    from paddle_tpu_torch.tuning import store

    name, entry = knob[0], knob[1]
    base = str(tmp_path)
    default, winner = {"a": 1, "b": 10}, {"a": 2, "b": 20}
    tuning.save_record(name, winner, base=base, context="ctx")

    def fresh(context="ctx"):
        tuning.clear_memo()
        return tuning.tuned(name, default, base=base, context=context)

    assert fresh() == winner
    assert fresh("other") is default                    # context
    monkeypatch.setattr(compile_cache, "environment_key",
                        lambda: ("9.9.9", "13.0", "9.0"))
    assert fresh() is default                           # versions
    monkeypatch.undo()
    monkeypatch.setattr(store, "topology_key",
                        lambda: ("NVIDIA H100 80GB HBM3", 1))
    assert fresh() is default                           # topology
    monkeypatch.undo()
    monkeypatch.setattr(store, "TUNING_FORMAT", store.TUNING_FORMAT + 1)
    assert fresh() is default                           # format
    monkeypatch.undo()
    old = dict(entry["space"])
    entry["space"]["a"] = (1, 2, 3)
    assert fresh() is default                           # space edit
    entry["space"].update(old)
    assert fresh() == winner

    path = store.record_path(name, "ctx", base=base)
    blob = open(path, "rb").read()
    for bad in (blob[:len(blob) // 2], b"\x00\xff\x13garbage"):
        with open(path, "wb") as f:
            f.write(bad)
        assert fresh() is default                       # corrupt
    for field, value in (("config", {"a": 7, "b": 10}),
                         ("tunable", "other/knob")):
        payload = json.loads(blob.decode())
        payload[field] = value
        with open(path, "w") as f:
            json.dump(payload, f)
        assert fresh() is default                       # drifted, foreign
    with open(path, "wb") as f:
        f.write(blob)
    assert fresh() == winner


def test_environment_key_carries_the_versions():
    from paddle_tpu_torch.core import compile_cache
    assert compile_cache.environment_key() == (
        torch.__version__, str(torch.version.cuda), ptt.__version__)
    prev = flags.get_flag("cache_dir")
    try:
        flags.set_flag("cache_dir", "/somewhere")
        assert compile_cache.cache_dir() == "/somewhere"
    finally:
        flags.set_flag("cache_dir", prev)


# ---------------------------------------------------------------------------
# Call sites
# ---------------------------------------------------------------------------
def _mlp(minimize=True):
    L = ptt.layers
    x = L.data("x", shape=[8], dtype="float32")
    y = L.data("y", shape=[1], dtype="int64")
    h = L.fc(x, size=8, act="relu")
    pred = L.fc(h, size=3, act="softmax")
    loss = L.mean(L.cross_entropy(pred, y))
    if minimize:
        ptt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def _feeds(n, batch=8):
    rng = np.random.RandomState(5)
    return [{"x": rng.rand(batch, 8).astype(np.float32),
             "y": rng.randint(0, 3, (batch, 1))} for _ in range(n)]


def _reset():
    ptt.core.reset_default_programs()
    ptt.core.reset_global_scope()
    ptt.unique_name.reset()


def test_untuned_call_sites_resolve_todays_defaults(tuning, tmp_path):
    from paddle_tpu_torch.reader.pipeline import _tuned_defaults
    from paddle_tpu_torch.serving.decode import DecodeRuntime
    from paddle_tpu_torch.serving.server import Server
    from paddle_tpu_torch.sparse import SparseSession, SparseTable
    d = {"steps_per_dispatch": 4, "prefetch_depth": 2}
    assert ptt.Executor(CPU)._tuned("executor/run_pipelined", d) is d
    prev = flags.get_flag("cache_dir")
    flags.set_flag("cache_dir", str(tmp_path))
    try:                                # on, but no record
        assert ptt.Executor(CPU, autotune=True)._tuned(
            "executor/run_pipelined", d) is d
    finally:
        flags.set_flag("cache_dir", prev)
    assert _tuned_defaults(None, None) == (8, 1)
    assert _tuned_defaults(3, 2) == (3, 2)
    s = Server()
    assert (s.max_batch, s.max_wait_s) == (32, 0.005)
    eng = _decode_engine()
    assert eng.slots == 8
    assert DecodeRuntime(eng).step_wait_s == 0.001
    sess = SparseSession(SparseTable("t", 16, 4, seed=0))
    assert (sess.cache.capacity, sess.prefetch_depth,
            sess.push_flush_batch) == (0, 0, 1)


def test_run_pipelined_default_equals_explicit_4_2(tuning):
    """``run_pipelined`` with its knobs omitted (autotune off) fetches
    bit for bit what the explicit (4, 2) call fetches."""
    feeds = _feeds(6)
    outs = []
    for kw in ({}, {"steps_per_dispatch": 4, "prefetch_depth": 2}):
        _reset()
        loss = _mlp()
        exe = ptt.Executor(CPU)
        exe.run(ptt.default_startup_program(), feed={}, fetch_list=[])
        outs.append([o[0] for o in exe.run_pipelined(
            iter(feeds), ptt.default_main_program(), fetch_list=[loss],
            **kw)])
    assert len(outs[0]) == 6
    for a, b in zip(*outs):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def _decode_engine(**kw):
    from paddle_tpu_torch.serving.decode import DecodeEngine
    return DecodeEngine(17, hidden_dim=8, n_layers=1, max_len=16,
                        len_buckets=(16,), seed=1, place=CPU, **kw)


def test_a_record_reaches_every_host_call_site(tuning, autotune_env,
                                               monkeypatch):
    """Persisted winners replay into run_pipelined (its dispatches), the
    trainer's pipelined fills, the reader's prefetch defaults, the
    server's batcher, the decode pool, the sparse session and ``serve
    --autotune``; explicit arguments win, and autotune off keeps the
    defaults."""
    base = autotune_env
    for name, cfg in (
            ("executor/run_pipelined",
             {"steps_per_dispatch": 2, "prefetch_depth": 1}),
            ("reader/prefetch", {"num_workers": 2, "buffer_size": 16}),
            ("serving/batcher", {"max_batch": 8, "max_wait_ms": 2.0}),
            ("serving/decode_slots", {"slots": 4, "step_wait_ms": 0.5}),
            ("sparse/hot_rows", {"cache_rows": 1024}),
            ("sparse/prefetch", {"depth": 2}),
            ("sparse/push_flush", {"batch": 4})):
        tuning.save_record(name, cfg, base=base)
    tuning.clear_memo()

    # run_pipelined: 4 feeds at the replayed K=2 are 2 dispatches
    loss = _mlp()
    exe = ptt.Executor(CPU, autotune=True)
    exe.run(ptt.default_startup_program(), feed={}, fetch_list=[])
    calls = []
    real = exe.run_steps
    monkeypatch.setattr(exe, "run_steps",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    assert len(list(exe.run_pipelined(
        iter(_feeds(4)), ptt.default_main_program(),
        fetch_list=[loss]))) == 4
    assert len(calls) == 2

    # the trainer's fills; an explicit knob survives
    sgd = ptt.trainer.SGD.__new__(ptt.trainer.SGD)
    sgd.exe = ptt.Executor(CPU, autotune=True)
    opts = {"buffer_size": 99}
    sgd._fill_tuned_pipeline_opts(opts, steps_per_dispatch=1)
    assert opts == {"buffer_size": 99, "steps_per_dispatch": 2,
                    "prefetch_depth": 1, "num_workers": 2}

    from paddle_tpu_torch.reader.pipeline import _tuned_defaults
    assert _tuned_defaults(None, None) == (16, 2)

    from paddle_tpu_torch.serving.decode import DecodeRuntime
    from paddle_tpu_torch.serving.server import Server
    assert (Server(autotune=True).max_batch,
            Server(autotune=True).max_wait_s) == (8, 0.002)
    assert Server(autotune=False).max_batch == 32
    assert Server(max_batch=64, autotune=True).max_batch == 64
    eng = _decode_engine(autotune=True)
    assert eng.slots == 4
    assert DecodeRuntime(eng, autotune=True).step_wait_s == 0.0005
    assert _decode_engine(autotune=False).slots == 8

    from paddle_tpu_torch.sparse import SparseSession, SparseTable
    sess = SparseSession(SparseTable("t", 16, 4, seed=0))
    assert (sess.prefetch_depth, sess.push_flush_batch) == (2, 4)
    assert sess.cache.capacity == 1024
    sess = SparseSession(SparseTable("t", 16, 4, seed=0), prefetch_depth=0)
    assert sess.prefetch_depth == 0

    # serve --autotune hands the opt-in to the server, knobs omitted
    from paddle_tpu_torch.serving import cli

    class Stop(Exception):
        pass

    seen = {}

    def fake_server(**kw):
        seen.update(kw)
        raise Stop
    monkeypatch.setattr(cli, "Server", fake_server)
    # the process keeps its own identity (serve_main stamps "serve")
    monkeypatch.setattr(cli, "set_process_identity", lambda *a, **k: None)
    with pytest.raises(Stop):
        cli.serve_main(["--model", "m=nowhere", "--autotune"])
    assert seen["autotune"] is True and seen["max_batch"] is None
    # every call site probed the store once
    from paddle_tpu_torch.tuning import store
    assert set(store.probes().values()) == {1}


def test_warm_replay_runs_no_search_trial(tuning, autotune_env):
    from paddle_tpu_torch.observability import registry
    tuning.save_record("executor/run_pipelined",
                       {"steps_per_dispatch": 2, "prefetch_depth": 1},
                       base=autotune_env)
    tuning.clear_memo()
    loss = _mlp()
    exe = ptt.Executor(CPU, autotune=True)
    exe.run(ptt.default_startup_program(), feed={}, fetch_list=[])

    def trials():
        return registry().snapshot().get("tuning/trials", {}).get("value",
                                                                  0)
    before = trials()
    for _ in range(2):
        assert len(list(exe.run_pipelined(
            iter(_feeds(4)), ptt.default_main_program(),
            fetch_list=[loss]))) == 4
    assert trials() == before
    from paddle_tpu_torch.tuning import store
    assert list(store.probes().values()) == [1]


def test_train_autotune_fills_the_pipelined_loop(tuning, autotune_env,
                                                 monkeypatch):
    """``trainer.SGD.train(autotune=True)`` runs the pipelined loop at
    the record's K, with the same
    losses as the explicit K; autotune is restored after the call."""
    tuning.save_record("executor/run_pipelined",
                       {"steps_per_dispatch": 2, "prefetch_depth": 1},
                       base=autotune_env)
    tuning.clear_memo()
    flags.set_flag("autotune", False)
    rows = [list(zip(f["x"], f["y"])) for f in _feeds(4)]
    costs = {}
    for label, kw in (("tuned", {"autotune": True}),
                      ("explicit", {"pipeline": {"steps_per_dispatch": 2,
                                                 "prefetch_depth": 1}})):
        _reset()
        loss = _mlp(minimize=False)
        x, y = (ptt.default_main_program().global_block().var(n)
                for n in ("x", "y"))
        sgd = ptt.trainer.SGD(loss, update_equation=ptt.optimizer.SGD(
            learning_rate=0.1), place=CPU)
        seen = []
        real = sgd.exe.run_pipelined
        monkeypatch.setattr(
            sgd.exe, "run_pipelined",
            lambda *a, **k: seen.append(k["steps_per_dispatch"])
            or real(*a, **k))
        got = []
        sgd.train(lambda: iter(rows), num_passes=1, feed_list=[x, y],
                  **{"pipeline": True, **kw},
                  event_handler=lambda e: got.append(e.cost)
                  if hasattr(e, "cost") else None)
        assert seen == [2] and sgd.exe.autotune is None
        costs[label] = got
    assert np.array_equal(np.asarray(costs["tuned"]),
                          np.asarray(costs["explicit"]))


def test_device_tunables_give_the_pending_stub_without_a_card(tuning):
    for name in ("cuda/conv1x1_plan", "cuda/flash_attention",
                 "cuda/fused_optimizer_update"):
        doc = tuning.tune(name, None)
        assert doc["status"] == "pending_hardware"
        assert doc["backend"] == "cpu"
        assert ">= 1.1" in doc["decision_rule"]


# ---------------------------------------------------------------------------
# The command line and the log
# ---------------------------------------------------------------------------
def test_tune_command_lists_the_registry(tuning, capsys):
    from paddle_tpu_torch.__main__ import main
    assert main(["tune", "--list"]) == 0
    out = capsys.readouterr().out
    for name in HOST_KNOBS + ("cuda/conv1x1_plan", "cuda/flash_attention"):
        assert name in out
    assert "decision rule" in out and "pending hardware" in out


def test_tune_command_refuses_to_search_without_a_store(tuning):
    from paddle_tpu_torch.__main__ import main
    prev = flags.get_flag("cache_dir")
    flags.set_flag("cache_dir", "")
    try:
        with pytest.raises(SystemExit, match="no winner store"):
            main(["tune", "reader/prefetch", "--smoke"])
    finally:
        flags.set_flag("cache_dir", prev)


def test_tune_command_smoke_on_a_host_target(tuning, capsys, tmp_path):
    from paddle_tpu_torch.__main__ import main
    out = tmp_path / "doc.json"
    assert main(["tune", "reader/prefetch", "--smoke", "--budget", "2",
                 "--reps", "1", "--pairs", "2", "--no-save",
                 "--out", str(out)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(lines[-1])
    assert summary["tunable"] == "reader/prefetch"
    assert summary["status"] in ("winner", "default_is_best",
                                 "noise_gate_refusal")
    assert len(json.load(open(out))["search"]["trials"]) == 2
    assert main(["tune", "cuda/flash_attention"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "status"] == "pending_hardware"


def test_tuning_events_reach_summarize_log(tuning, knob, tmp_path,
                                           monkeypatch):
    from paddle_tpu_torch.observability import export
    name = knob[0]
    log = str(tmp_path / "run.jsonl")
    prev = flags.get_flag("metrics_log")
    flags.set_flag("metrics_log", log)
    try:
        clock = _Clock()
        monkeypatch.setattr(time, "perf_counter", clock)
        tuning.tune(name, _measure(clock, COSTS), reps=2, pairs=3,
                    warmup=0, base=str(tmp_path))
        monkeypatch.undo()
        tuning.clear_memo()
        tuning.tuned(name, {"a": 1, "b": 10}, base=str(tmp_path))
    finally:
        flags.set_flag("metrics_log", prev)
        export._reset_writer()
    tu = export.summarize_log(log)["tuning"]
    assert tu["trials"] == 4
    assert tu["winners"][0]["config"] == {"a": 1, "b": 20}
    assert tu["replays"][0]["tunable"] == name
    text = export.render_summary(export.summarize_log(log))
    assert "tuning:" in text and "winner:" in text


def test_opprof_candidates_carry_the_port_rules():
    """opprof's where-the-time-goes entries name the JAX candidates, as
    the JAX report does, with the decision rule and hardware flag of the
    port's counterpart tunable."""
    from paddle_tpu.observability import opprof as jopprof
    from paddle_tpu_torch.observability import opprof
    rows = [{"op_type": "sgd", "wall_ms": 2.0},
            {"op_type": "sequence_pool", "wall_ms": 1.0},
            {"op_type": "mul", "wall_ms": 0.5}]
    got = opprof.xla_loses_here(rows, 3.5, top=3)
    want = jopprof._xla_loses_here(rows, 3.5, top=3)
    assert [e.get("pallas_candidate") for e in got] == \
        [e.get("pallas_candidate") for e in want]
    for e in got[:2]:
        t = treg.get_tunable(opprof.CANDIDATE_TUNABLES[e["pallas_candidate"]])
        assert e["tunable"] == t["name"]
        assert e["decision_rule"] == t["decision_rule"]
        assert e["pending_hardware"] is True
    assert "decision_rule" not in got[2]
    text = opprof.render_profile({
        "ops": 3, "eager_total_ms": 3.5, "per_op_sum_ms": 3.5,
        "sum_gap_frac": 0.0, "within_tolerance": True, "top": [],
        "xla_loses_here": got})
    assert "[pending hardware]" in text and "cuda/fused_optimizer_update" \
        in text


# ---------------------------------------------------------------------------
# The card's knobs: K1's launch plans, K2-K4's ring depths
# ---------------------------------------------------------------------------
# ResNet-50's eligible 1x1 shapes at batch 128 and GoogLeNet's two, as
# (P, C, M)
CONV_SHAPES = [(100352, 512, 128), (100352, 128, 512), (25088, 1024, 256),
               (25088, 256, 1024), (6272, 2048, 512), (6272, 512, 2048),
               (6272, 1024, 2048), (93312, 256, 128), (21632, 512, 128)]
FORMS = {"forward": (False, True), "dgrad": (False, False),
         "wgrad": (True, False)}


def _mnk(form, P, C, M):
    return {"forward": (P, M, C), "dgrad": (P, C, M),
            "wgrad": (M, C, P)}[form]


def _cu_accepts(p, dtype, out_stats, a_colsum, out_dtype):
    """conv1x1_mm's checks (csrc/conv1x1_mm.cu, conv1x1_mm), written out
    here, on the launch a plan makes."""
    bf16 = dtype == torch.bfloat16
    return (1 <= p.splits <= 65535 and p.ctas >= 0
            and not (out_stats and p.splits > 1)
            and 1 <= p.cluster <= 8 and p.splits % p.cluster == 0
            and not (p.ctas > 0 and (not bf16 or p.splits != 1
                                     or out_dtype != torch.bfloat16
                                     or a_colsum)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_default_plan_config_is_todays_plan(dtype):
    """The default ``cuda/conv1x1_plan`` config gives ``plan()`` at every
    form, epilogue and output dtype at the ResNet-50 and GoogLeNet
    shapes; so does a config that spells out the rule's own values."""
    from paddle_tpu_torch.ops import conv1x1
    default = treg.get_tunable("cuda/conv1x1_plan")["default"]
    n = 0
    for P, C, M in CONV_SHAPES:
        for form, (ta, tb) in FORMS.items():
            # the epilogues ride the forms that have them: out_stats the
            # forward (conv2d_1x1_with_bn_stats), a_colsum the wgrad
            for out_stats, a_colsum in ((False, False), (True, False),
                                        (False, True)):
                if (a_colsum and form != "wgrad") or \
                        (out_stats and form != "forward"):
                    continue
                for out_dtype in (torch.bfloat16, torch.float32):
                    args = (*_mnk(form, P, C, M), ta, tb, dtype, 132,
                            out_stats, a_colsum, out_dtype)
                    want = conv1x1.plan(*args)
                    assert conv1x1.plan_for(default, *args) is want
                    spelled = {"splits": want.splits,
                               "cluster": want.cluster,
                               "persistent": conv1x1.RULE}
                    assert conv1x1.plan_for(spelled, *args) == want
                    conv1x1.check_launch(want, dtype, out_stats, a_colsum,
                                         out_dtype)
                    n += 1
    assert n == len(CONV_SHAPES) * (2 + 1 + 2) * 2


@pytest.mark.parametrize("shape", [(100352, 512, 128), (93312, 256, 128),
                                   (21632, 512, 128)],
                         ids=["resnet50_s2", "googlenet_3b", "googlenet_4c"])
def test_every_plan_config_launches_checked_or_fails_first(tuning, shape):
    """Each config of the space at a wgrad shape: a plan that passes
    conv1x1_mm's checks (written out here), or a trial that fails in
    ``conv1x1.mm`` before anything launches."""
    from paddle_tpu_torch.ops import conv1x1
    from paddle_tpu_torch.tuning.search import run_trial
    P, C, M = shape
    entry = tuning.get_tunable("cuda/conv1x1_plan")
    gout = torch.zeros(P, M, dtype=torch.bfloat16)
    x = torch.zeros(P, C, dtype=torch.bfloat16)
    ok = failed = 0
    for cfg in tuning.grid_configs(entry):
        p = conv1x1.plan_for(cfg, M, C, P, True, False)
        try:
            conv1x1.check_launch(p)
        except ValueError:
            before = dict(conv1x1.mm.by_form)
            t = run_trial(lambda c: conv1x1.mm(gout, x, True, False,
                                               config=c),
                          cfg, reps=1, warmup=0)
            assert t.status == "failed" and "refused before launch" in t.error
            assert dict(conv1x1.mm.by_form) == before
            failed += 1
        else:
            assert _cu_accepts(p, torch.bfloat16, False, False,
                               torch.bfloat16), cfg
            assert p.splits <= p.ksteps
            ok += 1
    assert ok > 10 and failed > 10


def test_plan_config_runs_the_plain_version_on_the_cpu():
    from paddle_tpu_torch.ops import conv1x1
    g = torch.Generator().manual_seed(0)
    a = torch.randn(512, 128, generator=g)
    b = torch.randn(512, 256, generator=g)
    cfg = {"splits": 2, "cluster": 2, "persistent": False}
    assert torch.equal(conv1x1.mm(a, b, True, False, config=cfg),
                       conv1x1.mm_reference(a, b, True, False))
    with pytest.raises(ValueError, match="refused before launch"):
        conv1x1.mm(a, b, True, False,
                   config={"splits": 4, "cluster": 8, "persistent": "rule"})


def test_every_flash_depth_fits_and_the_default_is_todays():
    """Each ``cuda/flash_attention`` depth is in the kernels' range and
    fits SMEM_LIMIT at both widths; the default config is the plans' own
    deepest ring; a depth outside the range raises."""
    from paddle_tpu_torch.ops import flash_attention as fa
    entry = treg.get_tunable("cuda/flash_attention")
    for D in (64, 128):
        dims = (8, 4096, 4096, D, D, True)
        assert fa.fwd_plan(*dims) == fa.fwd_plan(
            *dims, entry["default"]["fwd_stages"])
        assert fa.bwd_plan(*dims) == fa.bwd_plan(
            *dims, entry["default"]["bwd_stages"])
        for s in entry["space"]["fwd_stages"]:
            kp = fa.fwd_plan(*dims, s).fwd
            assert fa.FWD_MIN_STAGES <= kp.stages == s <= fa.FWD_MAX_STAGES
            assert kp.smem <= fa.SMEM_LIMIT
        for s in entry["space"]["bwd_stages"]:
            bp = fa.bwd_plan(*dims, s)
            for kp in (bp.dq, bp.dkv):
                assert fa.BWD_MIN_STAGES <= kp.stages == s <= \
                    fa.BWD_MAX_STAGES
                assert kp.smem <= fa.SMEM_LIMIT
        with pytest.raises(ValueError, match="stages"):
            fa.fwd_plan(*dims, 1)
        for s in (1, fa.BWD_MAX_STAGES + 1):    # 1: K3 fails on the card
            with pytest.raises(ValueError, match="stages"):
                fa.bwd_plan(*dims, s)


def test_flash_record_becomes_op_attrs(tuning, autotune_env):
    """A ``cuda/flash_attention`` record becomes the op's fwd_stages and
    bwd_stages attrs (so the content digest sees it); with no record, or
    autotune off, the op has none, and the program is today's."""
    from paddle_tpu_torch.core.compile_cache import program_content_digest
    from torch_parity import build_longctx

    def attrs():
        main, _, _ = build_longctx(ptt, 64, 2, 16)
        op = [o for o in main.global_block().ops
              if o.type == "flash_attention"][0]
        return op.attrs, program_content_digest(main)

    plain, digest = attrs()                 # on, but no record
    assert "fwd_stages" not in plain
    tuning.save_record("cuda/flash_attention",
                       {"fwd_stages": 2, "bwd_stages": 3},
                       base=autotune_env)
    tuning.clear_memo()
    tuned, tuned_digest = attrs()
    assert (tuned["fwd_stages"], tuned["bwd_stages"]) == (2, 3)
    assert tuned_digest != digest
    flags.set_flag("autotune", False)
    off, off_digest = attrs()
    assert "fwd_stages" not in off and off_digest == digest


def test_flash_op_with_depth_attrs_equals_the_plain_step(tuning):
    """On the CPU the op with depth attrs runs the plain versions: the
    same loss and gradients as the op without them."""
    from torch_parity import build_longctx
    fetched = []
    for stages in (None, (2, 3)):
        main, startup, loss = build_longctx(ptt, 64, 2, 16)
        if stages:
            op = [o for o in main.global_block().ops
                  if o.type == "flash_attention"][0]
            op.attrs.update(fwd_stages=stages[0], bwd_stages=stages[1])
        scope = ptt.Scope()
        exe = ptt.Executor(CPU)
        exe.run(startup, scope=scope)
        fetched.append(exe.run(main, fetch_list=[loss, "lc_q@GRAD"],
                               scope=scope))
    for a, b in zip(*fetched):
        assert np.array_equal(a, b)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_non_default_k1_plan_matches_plain_on_card(cuda_device):
    from paddle_tpu_torch.ops import conv1x1
    g = torch.Generator(device=cuda_device).manual_seed(0)
    P, C, M = 21632, 512, 128
    gout = torch.randn(P, M, device=cuda_device, generator=g).to(
        torch.bfloat16)
    x = torch.randn(P, C, device=cuda_device, generator=g).to(torch.bfloat16)
    ref = conv1x1.mm_reference(gout, x, True, False)
    for cfg in ({"splits": 8, "cluster": 8, "persistent": "rule"},
                {"splits": 1, "cluster": "rule", "persistent": "rule"}):
        before = conv1x1.launches()
        out = conv1x1.mm(gout, x, True, False, config=cfg)
        torch.cuda.synchronize()
        assert conv1x1.launches() == before + 1
        torch.testing.assert_close(out.float(), ref.float(), rtol=1.6e-2,
                                   atol=max(1e-2, 2e-7 * P))


@pytest.mark.cuda
def test_non_default_flash_depth_matches_plain_on_card(cuda_device):
    from paddle_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v, go = (torch.randn(2, 1024, 64, device=cuda_device,
                               generator=g).to(torch.bfloat16)
                   for _ in range(4))
    ro, rl = fa.flash_fwd_reference(q, k, v, True)
    before = dict(fa.launches_by_stages)
    out, lse = fa.flash_fwd(q, k, v, True, stages=2)
    grads = fa.flash_bwd(q, k, v, out, lse, go, True, stages=2)
    refs = fa.flash_bwd_reference(q, k, v, out, lse, go, True)
    torch.cuda.synchronize()
    assert fa.launches_by_stages["fwd", 2] == before.get(("fwd", 2), 0) + 1
    assert fa.launches_by_stages["bwd_dq", 2] == \
        before.get(("bwd_dq", 2), 0) + 1
    torch.testing.assert_close(out.float(), ro.float(), rtol=2e-2,
                               atol=2e-2)
    assert (lse - rl).abs().max().item() <= 1e-3
    for got, want in zip(grads, refs):
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2 * want.abs().max().item())
