"""The port's training runtime (``trainer.SGD.train(checkpoint_dir=...)``,
``train_state.py``, ``faults.py``, ``testing/faultinject.py``,
``distributed/supervisor.py`` and the executor's dispatch retries) on
the CPU: mirrors of ``tests/test_fault_tolerance.py`` (preempt and
resume, reader crashes, the options, TrainState, retries, the signal
window, the supervisor) without the master, elastic and sparse parts.

Bit identity is exact (``float.hex`` of every loss, ``torch.equal`` of
every scope entry).  The one cross-package test holds the port's
preempted and resumed run of a dropout-free fp32 model against the JAX
package's uninterrupted run of the same program from the same weights:
losses and final parameters within 1e-5 relative.  Tests that send real
signals or start subprocesses are ``@slow`` (the rule of
``tests/test_repo_lint.py``)."""
import errno
import hashlib
import json
import os
import signal
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch import layers
from paddle_tpu_torch.distributed import CheckpointManager
from paddle_tpu_torch.distributed.supervisor import (Supervisor,
                                                     SupervisorGaveUp)
from paddle_tpu_torch.faults import (EXIT_PREEMPTED, InjectedFault,
                                     Preempted, RetriesExhausted,
                                     RetryPolicy, TransientError, classify)
from paddle_tpu_torch.testing import faultinject as fi
from paddle_tpu_torch.train_state import (TRAIN_STATE_VAR, Checkpointer,
                                          TrainState)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ptt.CPUPlace()


@pytest.fixture(autouse=True)
def _clean_spec():
    fi.clear()
    _fresh()
    yield
    fi.clear()


def _fresh():
    ptt.core.reset_default_programs()
    ptt.core.reset_global_scope()
    ptt.unique_name.reset()


def _build_trainer(lr=0.1, dropout=0.3, pkg=ptt, place=CPU):
    """A small classifier with dropout (so resume must restore the random
    streams, not only the parameters), Momentum."""
    L = pkg.layers
    pkg.default_startup_program().random_seed = 5
    x = L.data("x", shape=[8], dtype="float32")
    y = L.data("y", shape=[1], dtype="int64")
    h = L.fc(x, size=16, act="relu")
    if dropout:
        h = L.dropout(h, dropout_prob=dropout)
    pred = L.fc(h, size=3, act="softmax")
    loss = L.mean(L.cross_entropy(pred, y))
    return pkg.trainer.SGD(cost=loss,
                           update_equation=pkg.optimizer.Momentum(lr, 0.9),
                           place=place)


def _reader(n_batches=10, batch=4):
    def r():
        rng = np.random.RandomState(7)
        for _ in range(n_batches):
            yield [(rng.rand(8).astype("float32"),
                    rng.randint(0, 3, (1,))) for _ in range(batch)]
    return r


def _collect(tr, reader, num_passes=2, **kw):
    out = []

    def handler(e):
        if isinstance(e, ptt.trainer.events.EndIteration):
            out.append((e.pass_id, e.batch_id, float(e.cost).hex()))
    tr.train(reader, num_passes=num_passes, event_handler=handler, **kw)
    return out


def _scope_equal(a, b):
    assert sorted(a.keys()) == sorted(b.keys())
    for k in a.keys():
        assert torch.equal(a.get(k), b.get(k)), k


_BASELINE = {}


def _baseline():
    """The uninterrupted run (2 passes x 10 batches, per batch) and its
    final scope."""
    if "ev" not in _BASELINE:
        _fresh()
        ev = _collect(_build_trainer(), _reader())
        scope = ptt.global_scope()
        _BASELINE["ev"] = ev
        _BASELINE["scope"] = {k: scope.get(k).clone() for k in scope.keys()}
        _fresh()
    return _BASELINE["ev"]


def _same_as_baseline_scope():
    scope = ptt.global_scope()
    want = _BASELINE["scope"]
    assert sorted(scope.keys()) == sorted(want)
    for k, v in want.items():
        assert torch.equal(scope.get(k), v), k


# ---------------------------------------------------------------------------
# Preempt and resume, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("at", [7, 10, 13])
def test_preempt_resume_bit_identity_per_batch(tmp_path, at):
    """Preempted at batch ``at`` of 20 and resumed: the fetch stream and
    the final scope (parameters, velocities, the dropout streams' step)
    equal the uninterrupted run's."""
    baseline = _baseline()
    tr = _build_trainer()
    part1 = []

    def h1(e):
        if isinstance(e, ptt.trainer.events.EndIteration):
            part1.append((e.pass_id, e.batch_id, float(e.cost).hex()))
    fi.configure(f"trainer.step@{at}=preempt")
    with pytest.raises(Preempted) as ei:
        tr.train(_reader(), num_passes=2, event_handler=h1,
                 checkpoint_dir=str(tmp_path), save_every_n_steps=3)
    assert ei.value.code == EXIT_PREEMPTED
    assert ei.value.step == at
    fi.clear()
    assert len(part1) == at
    _fresh()
    part2 = _collect(_build_trainer(), _reader(),
                     checkpoint_dir=str(tmp_path), resume=True,
                     save_every_n_steps=3)
    assert part1 + part2 == baseline
    _same_as_baseline_scope()


def test_preempt_resume_bit_identity_chunked(tmp_path):
    """The chunked loop (run_steps of 4): saves and the preemption wait
    for the chunk's boundary."""
    baseline = _collect(_build_trainer(), _reader(), steps_per_dispatch=4)
    _fresh()
    tr = _build_trainer()
    part1 = []

    def h1(e):
        if isinstance(e, ptt.trainer.events.EndIteration):
            part1.append((e.pass_id, e.batch_id, float(e.cost).hex()))
    fi.configure("trainer.step@6=preempt")
    with pytest.raises(Preempted) as ei:
        tr.train(_reader(), num_passes=2, event_handler=h1,
                 steps_per_dispatch=4, checkpoint_dir=str(tmp_path),
                 save_every_n_steps=3)
    fi.clear()
    assert ei.value.step == 8                # the chunk's boundary
    _fresh()
    part2 = _collect(_build_trainer(), _reader(), steps_per_dispatch=4,
                     checkpoint_dir=str(tmp_path), resume=True)
    assert part1 + part2 == baseline


def test_preempt_resume_bit_identity_pipelined(tmp_path):
    """The same through the pipelined loop (num_workers=0 keeps the
    order), preempted mid-stream."""
    pipe = {"steps_per_dispatch": 4, "num_workers": 0}
    baseline = _collect(_build_trainer(), _reader(), pipeline=pipe)
    _fresh()
    tr = _build_trainer()
    part1 = []

    def h1(e):
        if isinstance(e, ptt.trainer.events.EndIteration):
            part1.append((e.pass_id, e.batch_id, float(e.cost).hex()))
    fi.configure("trainer.step@9=preempt")
    with pytest.raises(Preempted):
        tr.train(_reader(), num_passes=2, event_handler=h1, pipeline=pipe,
                 checkpoint_dir=str(tmp_path), save_every_n_steps=4)
    fi.clear()
    _fresh()
    part2 = _collect(_build_trainer(), _reader(), pipeline=pipe,
                     checkpoint_dir=str(tmp_path), resume=True,
                     save_every_n_steps=4)
    assert part1 + part2 == baseline


def test_request_preempt_from_an_event_handler(tmp_path):
    """``Checkpointer.request_preempt()`` (what a scheduler hook calls)
    after step 5: an emergency checkpoint at step 5 marked so, and the
    resume continues bit for bit."""
    baseline = _baseline()
    tr = _build_trainer()
    part1 = []

    def h1(e):
        if isinstance(e, ptt.trainer.events.EndIteration):
            part1.append((e.pass_id, e.batch_id, float(e.cost).hex()))
            if len(part1) == 5:
                tr.checkpointer.request_preempt()
    with pytest.raises(Preempted) as ei:
        tr.train(_reader(), num_passes=2, event_handler=h1,
                 checkpoint_dir=str(tmp_path), save_every_n_steps=2)
    assert ei.value.step == 5
    saves = tr.checkpointer.saves
    assert [s["step"] for s in saves] == [2, 4, 5]
    assert saves[-1]["emergency"] and saves[-1]["blocking"]
    scope = ptt.Scope()
    CheckpointManager(str(tmp_path), device="cpu").restore(scope=scope)
    ts = TrainState.from_array(scope.get(TRAIN_STATE_VAR))
    # the executor's steps: the startup program's and five
    assert (ts.emitted, ts.exe_step, ts.emergency) == (5, 6, True)
    _fresh()
    part2 = _collect(_build_trainer(), _reader(),
                     checkpoint_dir=str(tmp_path), resume=True)
    assert part1 + part2 == baseline


def test_reader_crash_propagates_then_resumable(tmp_path):
    """A reader exception at item 8 reaches the caller; the resume starts
    from the last periodic checkpoint (6), and the replayed batches
    equal what the crashed run produced."""
    baseline = _baseline()
    tr = _build_trainer()
    part1 = []

    def h1(e):
        if isinstance(e, ptt.trainer.events.EndIteration):
            part1.append((e.pass_id, e.batch_id, float(e.cost).hex()))
    fi.configure("reader.item@8=error")
    with pytest.raises(InjectedFault):
        tr.train(_reader(), num_passes=2, event_handler=h1,
                 checkpoint_dir=str(tmp_path), save_every_n_steps=3)
    fi.clear()
    assert len(part1) == 7
    _fresh()
    part2 = _collect(_build_trainer(), _reader(),
                     checkpoint_dir=str(tmp_path), resume=True,
                     save_every_n_steps=3)
    merged = {(p, b): c for p, b, c in part1}
    merged.update({(p, b): c for p, b, c in part2})
    assert [(p, b, merged[(p, b)]) for p, b, _ in baseline] == baseline
    d1 = {(p, b): c for p, b, c in part1}
    d2 = {(p, b): c for p, b, c in part2}
    overlap = set(d1) & set(d2)
    assert overlap == {(0, 6)}
    for k in overlap:
        assert d1[k] == d2[k]


@pytest.mark.slow
def test_real_sigterm_mid_training(tmp_path):
    """A real SIGTERM to this process mid-run: the handler waits for the
    boundary, commits an emergency checkpoint and raises Preempted; the
    previous handler is back afterwards."""
    old = signal.getsignal(signal.SIGTERM)
    tr = _build_trainer()
    fi.configure("trainer.step@5=sigterm")
    with pytest.raises(Preempted) as ei:
        tr.train(_reader(), num_passes=2, checkpoint_dir=str(tmp_path),
                 save_every_n_steps=100)
    fi.clear()
    assert ei.value.code == EXIT_PREEMPTED
    assert signal.getsignal(signal.SIGTERM) is old
    assert CheckpointManager(str(tmp_path)).all_steps() == [5]
    _fresh()
    resumed = _collect(_build_trainer(), _reader(),
                       checkpoint_dir=str(tmp_path), resume=True)
    baseline = _baseline()
    assert resumed == baseline[5:]


def test_resume_with_empty_dir_starts_fresh_and_completion_idempotent(
        tmp_path):
    baseline = _baseline()
    got = _collect(_build_trainer(), _reader(),
                   checkpoint_dir=str(tmp_path), resume=True,
                   save_every_n_steps=5)
    assert got == baseline
    _fresh()
    again = _collect(_build_trainer(), _reader(),
                     checkpoint_dir=str(tmp_path), resume=True,
                     save_every_n_steps=5)
    assert again == []


def test_checkpoint_options_require_checkpoint_dir():
    tr = _build_trainer()
    with pytest.raises(ValueError, match="checkpoint_dir"):
        tr.train(_reader(), resume=True)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        tr.train(_reader(), save_every_n_steps=5)


@pytest.mark.parametrize("name,item", [
    ("master", "item 8"), ("elastic", "item 8"),
    ("warmup", "item 6"), ("autotune", "item 9"),
    ("auto_shard", "item 7")])
def test_options_not_ported_raise_naming_their_item(tmp_path, name, item):
    tr = _build_trainer()
    with pytest.raises(NotImplementedError, match=item):
        tr.train(_reader(), checkpoint_dir=str(tmp_path),
                 **{name: object() if name not in ("warmup", "autotune")
                    else True})


def test_sparse_tables_ride_the_checkpoint(tmp_path):
    """``sparse_tables`` (refused until the sparse tables were ported):
    the table's rows commit with the model as ``__sparse__/`` groups,
    full then delta, and a restore gives them back as host arrays."""
    from paddle_tpu_torch.sparse import SparseSession, SparseTable
    L = ptt.layers
    ids = L.data("ids", shape=[1], dtype="int64")
    emb = L.embedding(ids, size=[32, 4], sparse=True, name="tbl")
    loss = L.mean(L.square(emb))
    tr = ptt.trainer.SGD(cost=loss,
                         update_equation=ptt.optimizer.SGD(0.1), place=CPU)
    table = SparseTable("tbl", 32, 4, learning_rate=0.1)

    def reader():
        for b in range(4):
            yield [(np.array([b * 4 + i]),) for i in range(4)]
    tr.train(reader, sparse_tables=SparseSession(table),
             checkpoint_dir=str(tmp_path), save_every_n_steps=2,
             handle_signals=False)
    kinds = [c["kind"] for c in tr.checkpointer.manager.commits]
    assert kinds[0] == "full" and "delta" in kinds
    assert table.live_rows == 16
    sc = ptt.Scope()
    CheckpointManager(str(tmp_path), device="cpu").restore(scope=sc)
    back = SparseTable("tbl", 32, 4, learning_rate=0.1)
    back.restore_state_vars({k: sc.get(k) for k in sc.keys()
                             if k.startswith("__sparse__/")})
    all_ids = np.arange(32)
    assert back.pull(all_ids).tobytes() == table.pull(all_ids).tobytes()


def test_restore_rejects_checkpoint_without_train_state(tmp_path):
    scope = ptt.global_scope()
    scope.set("w", torch.ones(3))
    CheckpointManager(str(tmp_path), async_save=False).save(1, scope)
    tr = _build_trainer()
    with pytest.raises(ValueError, match="TrainState"):
        tr.train(_reader(), checkpoint_dir=str(tmp_path), resume=True)


def test_step_advancing_event_handler_degrades_to_per_pass_saves(tmp_path):
    tr = _build_trainer()
    test_reader = _reader(2)

    def handler(e):
        if isinstance(e, ptt.trainer.events.EndIteration):
            tr.test(test_reader)          # advances exe._step mid-pass
    tr.train(_reader(4), num_passes=2, event_handler=handler,
             checkpoint_dir=str(tmp_path), save_every_n_steps=2)
    steps = CheckpointManager(str(tmp_path)).all_steps()
    assert len(steps) >= 2
    assert 8 in steps                     # the final save


# ---------------------------------------------------------------------------
# TrainState
# ---------------------------------------------------------------------------
def test_train_state_roundtrip_and_version_guard():
    ts = TrainState(exe_step=41, pass_id=1, batch_id=3, emitted=23,
                    iters_done=23, random_seed=9,
                    optimizer={"type": "Momentum", "learning_rate": 0.1},
                    emergency=True)
    assert TrainState.from_array(ts.to_array()) == ts
    assert TrainState.from_array(torch.tensor(ts.to_array())) == ts
    d = json.loads(bytes(ts.to_array()).decode())
    d["version"] = TrainState().version + 1
    arr = np.frombuffer(json.dumps(d).encode(), dtype=np.uint8)
    with pytest.raises(ValueError, match="newer"):
        TrainState.from_array(arr)
    d["version"] = TrainState().version
    d["future_field"] = "ignored"
    arr = np.frombuffer(json.dumps(d).encode(), dtype=np.uint8)
    assert TrainState.from_array(arr).exe_step == 41


def test_train_state_matches_the_jax_fields():
    from paddle_tpu.train_state import TrainState as JaxTrainState
    ts = TrainState(exe_step=3, pass_id=1, emitted=7, random_seed=2)
    assert JaxTrainState.from_array(ts.to_array()).__dict__ == ts.__dict__
    jts = JaxTrainState(exe_step=9, batch_id=4, optimizer={"type": "SGD"})
    assert TrainState.from_array(jts.to_array()).__dict__ == jts.__dict__


def test_train_state_never_leaks_into_scope(tmp_path):
    tr = _build_trainer()
    _collect(tr, _reader(4), num_passes=1, checkpoint_dir=str(tmp_path),
             save_every_n_steps=2)
    assert not ptt.global_scope().has(TRAIN_STATE_VAR)


# ---------------------------------------------------------------------------
# Dispatch retries
# ---------------------------------------------------------------------------
def _tiny_exe(**kw):
    x = layers.data("x", shape=[4], dtype="float32")
    loss = layers.mean(layers.fc(x, size=2))
    exe = ptt.Executor(CPU, **kw)
    exe.run(ptt.default_startup_program(), feed={}, fetch_list=[])
    return exe, loss, {"x": np.ones((2, 4), np.float32)}


def test_dispatch_transient_retried():
    exe, loss, feed = _tiny_exe(retry_policy=RetryPolicy(
        max_attempts=3, backoff_base_s=0.0, jitter=0.0))
    ref = exe.run(feed=feed, fetch_list=[loss])
    fi.configure("executor.dispatch@1=transient")
    out = exe.run(feed=feed, fetch_list=[loss])
    assert fi.fired("executor.dispatch") == 1
    assert exe.dispatch_retries == 1
    np.testing.assert_array_equal(out[0], ref[0])


def test_dispatch_retries_exhausted():
    exe, loss, feed = _tiny_exe(retry_policy=RetryPolicy(
        max_attempts=2, backoff_base_s=0.0, jitter=0.0))
    fi.configure("executor.dispatch@*=transient")
    with pytest.raises(RetriesExhausted):
        exe.run(feed=feed, fetch_list=[loss])
    assert exe._step == 1                   # only the startup ran


def test_dispatch_fatal_not_retried():
    exe, loss, feed = _tiny_exe(retry_policy=RetryPolicy(
        max_attempts=5, backoff_base_s=0.0, jitter=0.0))
    fi.configure("executor.dispatch@*=error")
    with pytest.raises(InjectedFault):
        exe.run(feed=feed, fetch_list=[loss])
    assert fi.fired("executor.dispatch") == 1
    assert exe.dispatch_retries == 0


def test_dispatch_not_retried_after_a_step_ran(monkeypatch):
    """A retryable error after a step of the dispatch ran (its state is
    written) is not retried: the second attempt would apply it twice."""
    exe, loss, feed = _tiny_exe(retry_policy=RetryPolicy(
        max_attempts=3, backoff_base_s=0.0, jitter=0.0))
    real = exe._run_once

    def flaky(*a, **kw):
        out = real(*a, **kw)
        raise TransientError("after the step")
    monkeypatch.setattr(exe, "_run_once", flaky)
    with pytest.raises(TransientError):
        exe.run(feed=feed, fetch_list=[loss])
    assert exe.dispatch_retries == 0 and exe._step == 2


def test_retry_policy_deterministic_schedule():
    a = RetryPolicy(max_attempts=5, backoff_base_s=0.1, backoff_max_s=1.0,
                    jitter=0.2, seed=42)
    b = RetryPolicy(max_attempts=5, backoff_base_s=0.1, backoff_max_s=1.0,
                    jitter=0.2, seed=42)
    da = [a.delay(i) for i in range(6)]
    assert da == [b.delay(i) for i in range(6)]
    assert all(d <= 1.0 * 1.2 + 1e-9 for d in da)
    from paddle_tpu.faults import RetryPolicy as JaxRetryPolicy
    j = JaxRetryPolicy(max_attempts=5, backoff_base_s=0.1,
                       backoff_max_s=1.0, jitter=0.2, seed=42)
    assert da == [j.delay(i) for i in range(6)]


def test_retry_during_training_run_keeps_math_identical():
    baseline = _baseline()
    tr = _build_trainer()
    tr.exe.retry_policy = RetryPolicy(max_attempts=3, backoff_base_s=0.0,
                                      jitter=0.0)
    fi.configure("executor.dispatch@5=transient")
    got = _collect(tr, _reader())
    assert fi.fired("executor.dispatch") == 1
    assert got == baseline


def test_classify_matches_jax():
    import paddle_tpu.faults as jf
    cases = [OSError(errno.ECONNRESET, "reset"),
             OSError(errno.ETIMEDOUT, "timeo"), OSError("no errno"),
             OSError(errno.ENOSPC, "disk full"), OSError(errno.EIO, "io"),
             OSError(errno.EMFILE, "fd limit"),
             ConnectionError("c"), TimeoutError("t"), MemoryError(),
             FloatingPointError("nan"), ValueError("shape"),
             FileNotFoundError("f")]
    assert [classify(e) for e in cases] == \
        [jf.classify(e) for e in cases]
    # each package's own fault types
    assert [classify(TransientError("t")), classify(InjectedFault("x"))] \
        == [jf.classify(jf.TransientError("t")),
            jf.classify(jf.InjectedFault("x"))] == ["retryable", "fatal"]
    assert classify(OSError(errno.ENOSPC, "disk full")) == "fatal"


def test_injected_preempt_without_checkpoint_dir_fails_loudly():
    tr = _build_trainer()
    fi.configure("trainer.step@2=preempt")
    with pytest.raises(InjectedFault, match="checkpoint_dir"):
        tr.train(_reader(4), num_passes=1)


def test_fault_spec_grammar():
    fi.configure("trainer.step@3=preempt; ckpt.write@*=truncate")
    assert fi.ENABLED and fi.active_spec()
    assert fi.check("trainer.step", index=2) is None
    assert fi.check("trainer.step", index=3) == "preempt"
    assert fi.check("ckpt.write") == "truncate"
    assert fi.hits("ckpt.write") == 1 and fi.fired("trainer.step") == 1
    with pytest.raises(ValueError, match="site@when=action"):
        fi.configure("trainer.step=preempt")
    with pytest.raises(ValueError, match="integer"):
        fi.configure("trainer.step@x=preempt")
    with pytest.raises(ValueError, match="not understood"):
        fi.raise_for("preempt", "reader.item")
    fi.clear()
    assert not fi.ENABLED


def test_off_path_touches_no_fault_site(monkeypatch):
    """With no spec and no checkpoint_dir the loop and the executor
    never call into the injection harness."""
    def boom(*a, **kw):
        raise AssertionError("faultinject.check called on the off path")
    monkeypatch.setattr(fi, "check", boom)
    out = _collect(_build_trainer(), _reader(6), num_passes=1)
    assert len(out) == 6


def test_cross_signal_keeps_grace_window_same_signal_escalates(tmp_path):
    class _Exe:
        _step = 0
        device = "cpu"
    c = Checkpointer(str(tmp_path), _Exe())
    escalated = []
    c._old_handlers = {signal.SIGINT: lambda s, f: escalated.append(s),
                       signal.SIGTERM: lambda s, f: escalated.append(s)}
    c._on_signal(signal.SIGINT, None)
    assert c._preempt_sig == signal.SIGINT
    c._on_signal(signal.SIGTERM, None)        # another signal: absorbed
    assert c._preempt_sig == signal.SIGINT
    assert escalated == []
    c._on_signal(signal.SIGINT, None)         # the same again: escalate
    assert escalated == [signal.SIGINT]


def test_checkpointer_restores_signal_handlers(tmp_path):
    class _Exe:
        _step = 0
        device = "cpu"
    before = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                               signal.SIGINT)}
    c = Checkpointer(str(tmp_path), _Exe())
    c.begin(ptt.Scope(), None, 0, {})
    assert signal.getsignal(signal.SIGTERM) == c._on_signal
    c.close()
    assert {s: signal.getsignal(s) for s in before} == before


# ---------------------------------------------------------------------------
# The supervisor
# ---------------------------------------------------------------------------
def test_supervisor_restarts_preempted_fn_with_backoff():
    sleeps = []
    state = {"runs": 0}

    def fn():
        state["runs"] += 1
        if state["runs"] < 3:
            raise Preempted(step=state["runs"] * 5, checkpoint_dir="/x")
        return "done"

    sup = Supervisor(max_restarts=3, backoff_base_s=0.25, backoff_max_s=10,
                     jitter=0.0, sleep=sleeps.append)
    assert sup.run(fn) == "done"
    assert state["runs"] == 3 and sup.restarts == 2
    assert sleeps == [0.25, 0.5]


def test_supervisor_gives_up_and_fatal_propagates():
    def flaky():
        raise TransientError("flaky")

    sup = Supervisor(max_restarts=2, backoff_base_s=0.0, jitter=0.0,
                     sleep=lambda s: None)
    with pytest.raises(SupervisorGaveUp):
        sup.run(flaky)
    assert sup.restarts == 2

    def fatal():
        raise ValueError("shape mismatch")
    sup2 = Supervisor(max_restarts=5, sleep=lambda s: None)
    with pytest.raises(ValueError):
        sup2.run(fatal)
    assert sup2.restarts == 0


@pytest.mark.slow
def test_supervisor_run_command_relaunches_on_preempt_exit(tmp_path):
    import subprocess  # noqa: F401  (a subprocess test)
    flag = tmp_path / "ran_once"
    script = tmp_path / "job.py"
    script.write_text(
        "import os, sys\n"
        f"flag = {str(flag)!r}\n"
        "if os.path.exists(flag):\n"
        "    sys.exit(0)\n"
        "open(flag, 'w').close()\n"
        f"sys.exit({EXIT_PREEMPTED})\n")
    sup = Supervisor(max_restarts=2, backoff_base_s=0.0, jitter=0.0,
                     sleep=lambda s: None)
    assert sup.run_command([sys.executable, str(script)]) == 0
    assert sup.restarts == 1 and sup.outcomes == [EXIT_PREEMPTED, 0]
    bad = tmp_path / "bad.py"
    bad.write_text("import sys; sys.exit(3)\n")
    sup2 = Supervisor(max_restarts=5, backoff_base_s=0.0, jitter=0.0,
                      sleep=lambda s: None)
    with pytest.raises(SupervisorGaveUp):
        sup2.run_command([sys.executable, str(bad)])
    assert sup2.restarts == 0


def _run_command_in_thread(sup, argv):
    box = {}

    def target():
        try:
            box["rc"] = sup.run_command(argv)
        except BaseException as e:   # noqa: BLE001 — surfaced via box
            box["error"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        with sup._child_lock:
            if sup._child is not None:
                return t, box
        time.sleep(0.005)
    raise AssertionError("run_command never spawned its child")


@pytest.mark.slow
def test_supervisor_terminate_forwards_signal_without_relaunch():
    sup = Supervisor(max_restarts=5, backoff_base_s=0.0, jitter=0.0,
                     sleep=lambda s: None)
    t, box = _run_command_in_thread(
        sup, [sys.executable, "-c", "import time; time.sleep(60)"])
    child = sup._child
    sup.terminate()
    t.join(timeout=15)
    assert not t.is_alive()
    assert "error" not in box, f"unexpected: {box.get('error')}"
    assert box["rc"] == -signal.SIGTERM
    assert sup.restarts == 0
    assert child.poll() is not None


@pytest.mark.slow
def test_supervisor_terminate_escalates_to_sigkill(tmp_path):
    flag = tmp_path / "ignoring"
    script = (
        "import signal, time\n"
        "signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
        f"open({str(flag)!r}, 'w').close()\n"
        "time.sleep(60)\n")
    sup = Supervisor(max_restarts=5, backoff_base_s=0.0, jitter=0.0,
                     sleep=lambda s: None)
    t, box = _run_command_in_thread(sup, [sys.executable, "-c", script])
    deadline = time.monotonic() + 10.0
    while not flag.exists():
        assert time.monotonic() < deadline, "child never started"
        time.sleep(0.005)
    sup.terminate(kill_timeout_s=0.5)
    t.join(timeout=15)
    assert not t.is_alive()
    assert box["rc"] == -signal.SIGKILL
    assert sup.restarts == 0


_SUPERVISED_JOB = """
import sys
sys.path.insert(0, {repo!r})
import numpy as np
import paddle_tpu_torch as ptt
from paddle_tpu_torch.testing import faultinject as fi
L = ptt.layers
ptt.default_startup_program().random_seed = 5
x = L.data("x", shape=[8], dtype="float32")
y = L.data("y", shape=[1], dtype="int64")
h = L.dropout(L.fc(x, size=16, act="relu"), dropout_prob=0.3)
loss = L.mean(L.cross_entropy(L.fc(h, size=3, act="softmax"), y))
tr = ptt.trainer.SGD(cost=loss, place=ptt.CPUPlace(),
                     update_equation=ptt.optimizer.Momentum(0.1, 0.9))
def reader():
    rng = np.random.RandomState(7)
    for _ in range(10):
        yield [(rng.rand(8).astype("float32"), rng.randint(0, 3, (1,)))
               for _ in range(4)]
log = open({log!r}, "a")
def handler(e):
    if isinstance(e, ptt.trainer.events.EndIteration):
        log.write("%d %d %s\\n" % (e.pass_id, e.batch_id, float(e.cost).hex()))
        log.flush()
tr.train(reader, num_passes=2, event_handler=handler,
         checkpoint_dir={ckpt!r}, resume=True, save_every_n_steps=3)
"""


@pytest.mark.slow
def test_supervised_command_resumes_after_a_real_sigterm(tmp_path):
    """``python -m paddle_tpu_torch.distributed.supervisor -- job``: the
    job SIGTERMs itself at batch 6 (a real signal), exits 75 after its
    emergency checkpoint, is relaunched and resumes; the merged loss
    stream equals an uninterrupted run's."""
    import subprocess
    baseline = _baseline()
    log = tmp_path / "log.txt"
    job = tmp_path / "job.py"
    job.write_text(_SUPERVISED_JOB.format(repo=REPO, log=str(log),
                                          ckpt=str(tmp_path / "ckpt")))
    env = dict(os.environ, PADDLE_TPU_FAULT_SPEC="trainer.step@6=sigterm")
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.supervisor",
         "--backoff-base-s", "0", "--", sys.executable, str(job)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "exit statuses [75, 0]" in proc.stderr
    got = [tuple(line.split()) for line in log.read_text().splitlines()]
    assert [(int(p), int(b), c) for p, b, c in got] == baseline


# ---------------------------------------------------------------------------
# The resumed port run against the JAX package's uninterrupted run
# ---------------------------------------------------------------------------
def test_resumed_run_matches_the_jax_uninterrupted_run(tmp_path):
    """fp32, no dropout: the JAX trainer trains 2 passes x 10 batches
    uninterrupted; the port, from the same weights, is preempted at
    batch 7 and resumed by a fresh trainer.  Losses and final
    parameters within 1e-5 relative."""
    import paddle_tpu as pt
    pt.core.reset_default_programs()
    pt.core.reset_global_scope()
    pt.unique_name.reset()
    jtr = _build_trainer(dropout=0, pkg=pt, place=pt.CPUPlace())
    jtr.exe.run(pt.default_startup_program(), feed={}, fetch_list=[])
    jtr._initialized = True
    jscope = pt.global_scope()
    start = {k: np.asarray(jscope.numpy(k)) for k in jscope.keys()}
    jl = []
    jtr.train(_reader(), num_passes=2, event_handler=lambda e: jl.append(
        float(e.cost)) if isinstance(e, pt.trainer.events.EndIteration)
        else None)

    def port_trainer():
        _fresh()
        tr = _build_trainer(dropout=0)
        gb = tr.main_program.global_block()
        scope = ptt.global_scope()
        for k, v in start.items():
            scope.set(k, torch.from_numpy(np.array(v.astype(
                gb.var(k).dtype) if gb.has_var(k) else v)))
        tr._initialized = True
        return tr
    tl = []

    def handler(e):
        if isinstance(e, ptt.trainer.events.EndIteration):
            tl.append(float(e.cost))
    fi.configure("trainer.step@7=preempt")
    with pytest.raises(Preempted):
        port_trainer().train(_reader(), num_passes=2, event_handler=handler,
                             checkpoint_dir=str(tmp_path),
                             save_every_n_steps=3)
    fi.clear()
    tr = port_trainer()
    tr.train(_reader(), num_passes=2, event_handler=handler,
             checkpoint_dir=str(tmp_path), resume=True)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    scope = ptt.global_scope()
    for p in tr.main_program.all_parameters():
        np.testing.assert_allclose(scope.numpy(p.name),
                                   np.asarray(jscope.numpy(p.name)),
                                   rtol=1e-5, atol=1e-6)


def test_sha_of_streams_is_stable():
    """The baseline's stream hashes the same twice (the loop is
    deterministic on the CPU)."""
    a = _baseline()
    _BASELINE.clear()
    b = _baseline()
    assert hashlib.sha256(repr(a).encode()).hexdigest() == \
        hashlib.sha256(repr(b).encode()).hexdigest()
