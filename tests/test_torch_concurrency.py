"""The PT05x concurrency pass over the port's host code
(``paddle_tpu_torch/analysis/concurrency.py``), the counterpart of
``tests/test_concurrency_analysis.py``, against the JAX package's pass.

* **Seeded corpus.** ``tests/fixtures/concurrency/`` (read-only, shared
  with the reference's test) holds one minimal defect per PT05x code and
  a clean control: each fires exactly its code exactly once, with the
  same findings (code, line, symbol) as the reference's pass.
* **The package gate.** ``analyze_package`` over ``paddle_tpu_torch/``
  reports nothing beyond its one-entry baseline (lockwatch's condition
  wrapper, PT053), and the baseline holds no stale entry.
* **Grounding.** The pattern tables name real stdlib (and lockwatch)
  attributes, every global of the pass resolves, and the frozen
  ``THREAD_NAME_PREFIXES`` literal parses to the live table: the JAX
  table's rows for the threads the port starts, and ``pt-loadgen``.
* **Baseline mechanics.** ``apply_baseline``'s new / suppressed / stale
  split.

Tolerances: none — every comparison is exact.
"""
import ast
import builtins
import dis
import inspect
import os
import pathlib

import pytest

from paddle_tpu.analysis import concurrency as jcc
from paddle_tpu.observability.metrics import \
    THREAD_NAME_PREFIXES as JPREFIXES
from paddle_tpu_torch.analysis import concurrency as cc
from paddle_tpu_torch.analysis.diagnostics import CODES

FIXTURES = pathlib.Path(__file__).parent / "fixtures" / "concurrency"
# hermetic prefix table: fixtures never depend on a live registry
FX_PREFIXES = ("pt-fx",)
SEEDED = [
    ("pt050_guard_inconsistency.py", "PT050"),
    ("pt051_order_cycle.py", "PT051"),
    ("pt052_blocking_under_lock.py", "PT052"),
    ("pt053_wait_no_loop.py", "PT053"),
    ("pt054_signal_handler_lock.py", "PT054"),
    ("pt055_unnamed_thread.py", "PT055"),
]


def _facts(findings):
    return [(f.code, f.path, f.line, f.symbol) for f in findings]


def _analyze(mod, name):
    return mod.analyze_source((FIXTURES / name).read_text(),
                              f"tests/{name}", thread_prefixes=FX_PREFIXES)


@pytest.mark.parametrize("fixture,code", SEEDED, ids=[c for _, c in SEEDED])
def test_seeded_defect_fires_exactly_once_as_the_reference(fixture, code):
    findings = _analyze(cc, fixture)
    assert [f.code for f in findings] == [code]
    assert _facts(findings) == _facts(_analyze(jcc, fixture))
    f = findings[0]
    assert f.line > 0 and f.symbol and f.code in f.render()
    assert f.to_diagnostic().code == code


def test_seeded_corpus_covers_every_pt05x_code():
    assert {c for _, c in SEEDED} == {c for c in CODES
                                      if c.startswith("PT05")}


def test_clean_fixture_is_silent():
    assert _analyze(cc, "clean.py") == []


def test_package_reports_nothing_beyond_its_baseline():
    findings = cc.analyze_package()
    new, suppressed, stale = cc.apply_baseline(findings)
    assert new == [], cc.render_report(findings)
    assert stale == []
    assert suppressed == {("paddle_tpu_torch/testing/lockwatch.py",
                           "PT053"): 1}
    assert list(cc.BASELINE) == [("paddle_tpu_torch/testing/lockwatch.py",
                                  "PT053")]
    # the justification is the reference's, for the same wrapper
    assert cc.BASELINE[("paddle_tpu_torch/testing/lockwatch.py",
                        "PT053")] == \
        jcc.BASELINE[("paddle_tpu/testing/lockwatch.py", "PT053")]


def test_package_scan_walks_the_port_only():
    root = cc.package_root()
    assert os.path.basename(root) == "paddle_tpu_torch"
    scanned = set()
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        scanned.update(f for f in files if f.endswith(".py"))
    assert {"server.py", "session.py", "lockwatch.py",
            "executor.py"} <= scanned


@pytest.mark.parametrize("rel", ["benchmark/pserver.py",
                                 "benchmark/serving_common.py"])
def test_the_benchmark_threads_are_named(rel):
    path = os.path.join(cc.package_root(), rel)
    with open(path) as f:
        src = f.read()
    findings = cc.analyze_source(src, f"paddle_tpu_torch/{rel}")
    assert [f for f in findings if f.code == "PT055"] == []


def test_thread_name_prefixes_parse_matches_the_live_table():
    from paddle_tpu_torch.observability.metrics import THREAD_NAME_PREFIXES
    assert cc.thread_name_prefixes() == tuple(
        p for p, _help in THREAD_NAME_PREFIXES)
    jrows = dict(JPREFIXES)
    own = [(p, h) for p, h in THREAD_NAME_PREFIXES if p not in jrows]
    assert [p for p, _ in own] == ["pt-loadgen"]
    for p, h in THREAD_NAME_PREFIXES:
        if p in jrows:
            assert h == jrows[p], p


def test_pattern_tables_name_real_stdlib_attributes():
    import queue
    import socket
    import threading
    from subprocess import Popen

    from paddle_tpu_torch.testing import lockwatch

    for name in cc.LOCK_FACTORIES + cc.RLOCK_FACTORIES + cc.COND_FACTORIES:
        assert (callable(getattr(threading, name, None))
                or callable(getattr(lockwatch, name, None))), name
    for name in cc.QUEUE_FACTORIES:
        assert callable(getattr(queue, name)), name
    for name in cc.EVENT_FACTORIES + cc.THREAD_FACTORY_NAMES:
        assert callable(getattr(threading, name)), name
    for name in cc.BLOCKING_SOCKET_METHODS:
        assert hasattr(socket.socket, name), name
    for name in cc.BLOCKING_PROC_METHODS:
        assert hasattr(Popen, name), name
    assert (cc.LOCK_FACTORIES, cc.QUEUE_FACTORIES,
            cc.BLOCKING_SOCKET_METHODS) == \
        (jcc.LOCK_FACTORIES, jcc.QUEUE_FACTORIES,
         jcc.BLOCKING_SOCKET_METHODS)


def test_analyzer_globals_all_resolve():
    def walk(code):
        yield code
        for const in code.co_consts:
            if hasattr(const, "co_code"):
                yield from walk(const)

    bad = []
    for name, obj in vars(cc).items():
        fns = []
        if inspect.isfunction(obj) and obj.__module__ == cc.__name__:
            fns.append(obj)
        elif inspect.isclass(obj) and obj.__module__ == cc.__name__:
            fns.extend(f for f in vars(obj).values()
                       if inspect.isfunction(f))
        for fn in fns:
            for code in walk(fn.__code__):
                for ins in dis.get_instructions(code):
                    if (ins.opname == "LOAD_GLOBAL"
                            and ins.argval not in fn.__globals__
                            and not hasattr(builtins, ins.argval)):
                        bad.append((name, fn.__qualname__, ins.argval))
    assert not bad


def _finding(code, path, line=10):
    return cc.Finding(code=code, path=path, line=line, symbol="x",
                      message="seeded")


def test_apply_baseline_three_way_split():
    findings = [_finding("PT050", "paddle_tpu_torch/a.py", 1),
                _finding("PT052", "paddle_tpu_torch/b.py", 2),
                _finding("PT052", "paddle_tpu_torch/b.py", 9)]
    baseline = {
        ("paddle_tpu_torch/b.py", "PT052"): (1, "legacy wire path"),
        ("paddle_tpu_torch/gone.py", "PT051"): (1, "stale: code fixed"),
    }
    new, suppressed, stale = cc.apply_baseline(findings, baseline)
    assert [(f.path, f.code, f.line) for f in new] == [
        ("paddle_tpu_torch/a.py", "PT050", 1),
        ("paddle_tpu_torch/b.py", "PT052", 9)]
    assert suppressed == {("paddle_tpu_torch/b.py", "PT052"): 1}
    assert stale == [("paddle_tpu_torch/gone.py", "PT051")]
    report = cc.render_report(findings, baseline)
    assert "2 new" in report and "baselined PT052 x1" in report
    assert "STALE baseline entry" in report
    assert cc.apply_baseline([], {}) == ([], {}, [])


def test_fixture_docstrings_name_their_code():
    for fixture, code in SEEDED:
        doc = ast.get_docstring(ast.parse((FIXTURES / fixture).read_text()))
        assert code in (doc or ""), fixture
