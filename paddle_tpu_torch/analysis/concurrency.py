"""Static concurrency verifier over the port's host code (PT05x;
counterpart of ``paddle_tpu/analysis/concurrency.py``: the same rules,
tables and baseline mechanics, rooted at ``paddle_tpu_torch/``).

The port is a fleet of cooperating threads too — the serving batcher and
dispatcher, the decode loop, reader pipeline workers, the executor's
staging thread, sparse prefetch/async-push workers, the checkpoint
writer, the pserver's serve loop — so it carries the JAX package's
tooling: an AST pass over ``paddle_tpu_torch/`` that builds a per-class
model of locks, conditions, queues and shared mutable attributes, and
emits frozen ``PT05x`` diagnostics (:mod:`.diagnostics`).

Rules (one stable code each, severities pinned in ``diagnostics.CODES``):

========  ===========================================================
PT050     shared ``self.attr`` written both under a class lock and
          outside any lock (guard inconsistency); ``__init__`` writes
          are construction-time and exempt
PT051     static lock-acquisition-order cycle: ``with A: with B`` in
          one place and ``with B: with A`` in another (lock identity
          aggregates by *class attribute*, lockdep-style; one level of
          intra-class ``self.method()`` call expansion)
PT052     blocking call while holding a lock: socket
          send/recv/accept/connect, ``queue.get``/``put`` without a
          timeout, subprocess ``wait``/``communicate``, bare thread
          ``.join()``
PT053     ``Condition.wait`` outside a while-predicate loop (lost
          wakeup / spurious wakeup hazard); ``wait_for`` is exempt
PT054     lock/condition acquisition reachable from a registered
          signal handler (a deadlock class: the interrupted thread may
          already hold the lock)
PT055     ``threading.Thread(...)`` without a ``name=`` that begins
          with a prefix registered in the frozen
          ``observability.metrics.THREAD_NAME_PREFIXES`` table (the
          port's own, read from ``paddle_tpu_torch``)
========  ===========================================================

The pass is import-free (pure ``ast`` over source text), so it also
covers flag-gated or lazily imported modules, exactly like the
``tests/test_repo_lint.py`` gates.  Current-tree findings that are
*accepted by design* live in :data:`BASELINE` — a frozen per-file,
per-code allowlist with a one-line justification each, tier-1-enforced
in both directions (new findings fail; stale entries must be ratcheted
out).  Surface: ``tests/test_torch_concurrency.py``'s gate over the
package.  The runtime twin (an instrumented lock that fails
deterministically on an order cycle instead of deadlocking) is
:mod:`paddle_tpu_torch.testing.lockwatch`.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .diagnostics import CODES, Diagnostic, diag

__all__ = [
    "Finding", "BASELINE", "THREAD_FACTORY_NAMES",
    "LOCK_FACTORIES", "RLOCK_FACTORIES", "COND_FACTORIES",
    "QUEUE_FACTORIES", "EVENT_FACTORIES", "BLOCKING_SOCKET_METHODS",
    "BLOCKING_PROC_METHODS",
    "analyze_source", "analyze_package", "apply_baseline",
    "package_root", "thread_name_prefixes", "render_report",
]

# ---------------------------------------------------------------------------
# Pattern tables.  Every name here must resolve against the real stdlib
# object it models — tests/test_concurrency_analysis.py pins that (the
# dis/AST agreement check), so a typo cannot silently disable a rule.
# ---------------------------------------------------------------------------
#: factory callables whose result is a mutex (module.attr or bare name)
LOCK_FACTORIES = ("Lock", "make_lock")
RLOCK_FACTORIES = ("RLock", "make_rlock")
COND_FACTORIES = ("Condition", "make_condition")
QUEUE_FACTORIES = ("Queue", "LifoQueue", "PriorityQueue", "SimpleQueue")
EVENT_FACTORIES = ("Event",)
THREAD_FACTORY_NAMES = ("Thread",)

#: method names that block on a socket (PT052)
BLOCKING_SOCKET_METHODS = ("recv", "recv_into", "recvfrom", "accept",
                           "connect", "sendall")
#: method names that block on a child process (PT052); ``wait`` only
#: fires on process-like receivers (see ``_looks_like_process``) so it
#: cannot collide with Condition.wait (PT053's domain)
BLOCKING_PROC_METHODS = ("wait", "communicate")

#: receiver-name fragments that identify a process handle for the
#: ``wait``/``communicate`` rules
_PROC_NAME_HINTS = ("proc", "popen", "child")

#: methods exempt from __init__-style construction-time write analysis
_CONSTRUCTION_METHODS = ("__init__", "__new__", "__set_name__")

#: method-name suffix meaning "caller holds the class lock" — writes in
#: ``_foo_locked()`` count as guarded for PT050 (the repo-wide naming
#: convention; the analyzer trusts the name because it cannot see the
#: caller's critical section interprocedurally)
_LOCKED_SUFFIX = "_locked"


# ---------------------------------------------------------------------------
# Frozen baseline: (relpath, code) -> (count, one-line justification).
# The tier-1 gate (tests/test_torch_concurrency.py) enforces BOTH
# directions: findings above the count fail (fix them), and counts above
# the actual findings fail (ratchet the entry down).  Never add entries for new
# code — fix the finding instead.
# ---------------------------------------------------------------------------
BASELINE: Dict[Tuple[str, str], Tuple[int, str]] = {
    # lockwatch's _WatchedCondition.wait() is the wait PRIMITIVE itself:
    # it delegates to threading.Condition.wait, and the while-predicate
    # loop the rule demands lives (correctly) at its CALLERS, which the
    # pass checks separately.
    ("paddle_tpu_torch/testing/lockwatch.py", "PT053"): (
        1, "condition-wrapper delegate: the predicate loop belongs to "
           "the caller, which the pass checks at each call site"),
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One PT05x finding located in host source."""

    code: str
    path: str          # repo-relative, forward slashes
    line: int
    symbol: str        # lock/attr/thread symbol involved
    message: str

    def render(self) -> str:
        sev = CODES[self.code][0]
        return (f"{self.code} {sev} {self.path}:{self.line} "
                f"[{self.symbol}]: {self.message}")

    def to_diagnostic(self) -> Diagnostic:
        return diag(self.code, f"{self.path}:{self.line}: {self.message}",
                    var=self.symbol)


def package_root() -> str:
    """Absolute path of the paddle_tpu_torch package directory."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def thread_name_prefixes() -> Tuple[str, ...]:
    """Registered thread-name prefixes, parsed from the frozen
    ``THREAD_NAME_PREFIXES`` literal in observability/metrics.py WITHOUT
    importing it (same contract as the metric-name lint gate)."""
    path = os.path.join(package_root(), "observability", "metrics.py")
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "THREAD_NAME_PREFIXES"
                for t in node.targets):
            rows = ast.literal_eval(node.value)
            return tuple(prefix for prefix, _help in rows)
    raise AssertionError(
        "THREAD_NAME_PREFIXES literal not found in observability/"
        "metrics.py")


# ---------------------------------------------------------------------------
# AST helpers
# ---------------------------------------------------------------------------
def _call_tail(func: ast.expr) -> Optional[str]:
    """Terminal name of a call target: ``a.b.C(...)`` -> ``C``."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _recv_tail(func: ast.expr) -> Optional[str]:
    """Terminal name of a method call's RECEIVER: ``a.b.m(...)`` -> ``b``."""
    if not isinstance(func, ast.Attribute):
        return None
    v = func.value
    if isinstance(v, ast.Attribute):
        return v.attr
    if isinstance(v, ast.Name):
        return v.id
    return None


def _factory_kind(value: ast.expr) -> Optional[str]:
    """'lock' | 'rlock' | 'cond' | 'queue' | 'event' for a factory call."""
    if not isinstance(value, ast.Call):
        return None
    tail = _call_tail(value.func)
    if tail in LOCK_FACTORIES:
        return "lock"
    if tail in RLOCK_FACTORIES:
        return "rlock"
    if tail in COND_FACTORIES:
        return "cond"
    if tail in QUEUE_FACTORIES:
        return "queue"
    if tail in EVENT_FACTORIES:
        return "event"
    return None


def _self_attr_target(node: ast.expr) -> Optional[str]:
    """``self.X`` -> ``X``."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _kwarg(call: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _looks_like_process(name: Optional[str]) -> bool:
    if not name:
        return False
    low = name.lower()
    return any(h in low for h in _PROC_NAME_HINTS)


def _looks_like_socket(name: Optional[str]) -> bool:
    if not name:
        return False
    low = name.lower()
    return "sock" in low or "conn" in low


# ---------------------------------------------------------------------------
# Per-module model
# ---------------------------------------------------------------------------
class _ClassModel:
    def __init__(self, name: str):
        self.name = name
        self.attr_kinds: Dict[str, str] = {}   # attr -> factory kind

    def attrs_of(self, *kinds: str) -> Set[str]:
        return {a for a, k in self.attr_kinds.items() if k in kinds}


class _ModuleModel:
    """Names resolved over one source file: class attribute kinds,
    module-level primitives, and string constants (for thread-name
    prefix resolution)."""

    def __init__(self, tree: ast.Module, path: str):
        self.path = path
        self.classes: Dict[str, _ClassModel] = {}
        self.module_kinds: Dict[str, str] = {}   # module var -> kind
        self.constants: Dict[str, str] = {}      # module var -> str value
        for node in tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                tname = node.targets[0].id
                kind = _factory_kind(node.value)
                if kind:
                    self.module_kinds[tname] = kind
                elif isinstance(node.value, ast.Constant) \
                        and isinstance(node.value.value, str):
                    self.constants[tname] = node.value.value
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                cm = _ClassModel(node.name)
                for sub in ast.walk(node):
                    if isinstance(sub, (ast.Assign, ast.AnnAssign)):
                        targets = (sub.targets
                                   if isinstance(sub, ast.Assign)
                                   else [sub.target])
                        value = sub.value
                        kind = _factory_kind(value) if value else None
                        if not kind:
                            continue
                        for t in targets:
                            attr = _self_attr_target(t)
                            if attr:
                                cm.attr_kinds[attr] = kind
                self.classes[node.name] = cm
        # attr name -> kind, merged over all classes (for resolving
        # attribute access on non-self receivers, e.g. ``rt.cond``)
        self.attr_kind_index: Dict[str, str] = {}
        for cm in self.classes.values():
            for a, k in cm.attr_kinds.items():
                self.attr_kind_index.setdefault(a, k)

    def kind_of_expr(self, node: ast.expr) -> Optional[str]:
        """Resolve a lock-ish expression to its primitive kind."""
        if isinstance(node, ast.Name):
            return self.module_kinds.get(node.id)
        if isinstance(node, ast.Attribute):
            return self.attr_kind_index.get(node.attr)
        return None

    def token_of_expr(self, node: ast.expr,
                      cls: Optional[str]) -> Optional[str]:
        """Lockdep-style lock-class token for a lock expression.

        Instance locks aggregate by (owning class, attribute); module
        locks by (module, name).  ``None`` when the expression does not
        resolve to a known lock/condition."""
        if isinstance(node, ast.Name):
            if self.module_kinds.get(node.id) in ("lock", "rlock", "cond"):
                return f"{self.path}::{node.id}"
            return None
        if isinstance(node, ast.Attribute):
            attr = node.attr
            kind = self.attr_kind_index.get(attr)
            if kind not in ("lock", "rlock", "cond"):
                return None
            owner = None
            if _self_attr_target(node) is not None and cls is not None \
                    and attr in self.classes[cls].attr_kinds:
                owner = cls
            else:
                owners = [c.name for c in self.classes.values()
                          if c.attr_kinds.get(attr) in
                          ("lock", "rlock", "cond")]
                owner = owners[0] if owners else None
            if owner is None:
                return None
            return f"{self.path}::{owner}.{attr}"
        return None


# ---------------------------------------------------------------------------
# The analyzer
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _Write:
    attr: str
    method: str
    line: int
    guarded: bool


class _FunctionWalker:
    """Walk one function/method body tracking the lexically-held lock
    set, the enclosing-loop flag, and locally-created primitives."""

    def __init__(self, analyzer: "_Analyzer", mm: _ModuleModel,
                 cls: Optional[str], func_name: str):
        self.an = analyzer
        self.mm = mm
        self.cls = cls
        self.func = func_name
        self.local_kinds: Dict[str, str] = {}   # local var -> kind
        self.writes: List[_Write] = []
        self.acquired: Set[str] = set()         # tokens (for call expand)
        self.thread_calls: List[ast.Call] = []

    # -- resolution -------------------------------------------------------
    def _kind_of(self, node: ast.expr) -> Optional[str]:
        if isinstance(node, ast.Name) and node.id in self.local_kinds:
            return self.local_kinds[node.id]
        return self.mm.kind_of_expr(node)

    def _class_lock_held(self, held: Tuple[str, ...]) -> bool:
        if self.cls is None:
            return False
        want = f"::{self.cls}."
        return any(want in t for t in held)

    # -- entry ------------------------------------------------------------
    def walk(self, body: Sequence[ast.stmt]):
        self._visit_block(body, held=(), inloop=False)

    # -- statement dispatch ----------------------------------------------
    def _visit_block(self, body, held, inloop):
        for stmt in body:
            self._visit_stmt(stmt, held, inloop)

    def _visit_stmt(self, stmt, held, inloop):
        if isinstance(stmt, ast.With):
            new = list(held)
            for item in stmt.items:
                tok = self.mm.token_of_expr(item.context_expr, self.cls)
                if tok is not None and tok not in new:
                    self.an.note_acquire(self.mm.path, stmt.lineno,
                                         tuple(new), tok)
                    self.acquired.add(tok)
                    new.append(tok)
                else:
                    self._visit_expr(item.context_expr, tuple(held), inloop)
            self._visit_block(stmt.body, tuple(new), inloop)
            return
        if isinstance(stmt, ast.While):
            self._visit_expr(stmt.test, held, inloop)
            self._visit_block(stmt.body, held, inloop=True)
            self._visit_block(stmt.orelse, held, inloop)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._visit_expr(stmt.iter, held, inloop)
            self._visit_block(stmt.body, held, inloop=True)
            self._visit_block(stmt.orelse, held, inloop)
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested def runs later, on its own thread/stack: fresh
            # held set, but it shares the module model and local kinds
            inner = _FunctionWalker(self.an, self.mm, self.cls,
                                    f"{self.func}.{stmt.name}")
            inner.local_kinds.update(self.local_kinds)
            inner.walk(stmt.body)
            self.writes.extend(inner.writes)
            self.acquired |= inner.acquired
            self.thread_calls.extend(inner.thread_calls)
            return
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            value = stmt.value
            if value is not None:
                self._visit_expr(value, held, inloop)
                kind = _factory_kind(value)
                if kind:
                    for t in targets:
                        if isinstance(t, ast.Name):
                            self.local_kinds[t.id] = kind
                # track process handles: p = subprocess.Popen(...)
                if isinstance(value, ast.Call) \
                        and _call_tail(value.func) == "Popen":
                    for t in targets:
                        if isinstance(t, ast.Name):
                            self.local_kinds[t.id] = "process"
            for t in targets:
                attr = _self_attr_target(t)
                if attr is not None:
                    self.writes.append(_Write(
                        attr=attr, method=self.func, line=stmt.lineno,
                        guarded=self._class_lock_held(held)))
                else:
                    self._visit_expr(t, held, inloop)
            return
        if isinstance(stmt, (ast.If,)):
            self._visit_expr(stmt.test, held, inloop)
            self._visit_block(stmt.body, held, inloop)
            self._visit_block(stmt.orelse, held, inloop)
            return
        if isinstance(stmt, ast.Try):
            self._visit_block(stmt.body, held, inloop)
            for h in stmt.handlers:
                self._visit_block(h.body, held, inloop)
            self._visit_block(stmt.orelse, held, inloop)
            self._visit_block(stmt.finalbody, held, inloop)
            return
        if isinstance(stmt, (ast.Return, ast.Expr, ast.Raise,
                             ast.Assert, ast.Delete)):
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self._visit_expr(child, held, inloop)
            return
        # anything else: walk expressions conservatively
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._visit_expr(child, held, inloop)
            elif isinstance(child, ast.stmt):
                self._visit_stmt(child, held, inloop)

    # -- expressions ------------------------------------------------------
    def _visit_expr(self, node, held, inloop):
        for call in [n for n in ast.walk(node)
                     if isinstance(n, ast.Call)]:
            self._visit_call(call, held, inloop)

    def _visit_call(self, call: ast.Call, held, inloop):
        tail = _call_tail(call.func)
        if tail in THREAD_FACTORY_NAMES:
            self.thread_calls.append(call)
        recv = _recv_tail(call.func)
        recv_kind = None
        if isinstance(call.func, ast.Attribute):
            recv_kind = self._kind_of(call.func.value)

        # PT053: Condition.wait must sit in a while-predicate loop
        if tail == "wait" and recv_kind == "cond":
            if not inloop:
                self.an.add(Finding(
                    "PT053", self.mm.path, call.lineno,
                    symbol=recv or "?",
                    message=f"Condition.wait on {recv!r} outside a "
                            f"while-predicate loop in {self.func}() — a "
                            f"spurious or stolen wakeup proceeds on a "
                            f"false predicate; re-test the condition in "
                            f"a while loop (or use wait_for)"))
            return

        # the interprocedural PT051 edge: self.method() under a lock
        if held and isinstance(call.func, ast.Attribute) \
                and _self_attr_target(call.func) is not None \
                and self.cls is not None:
            self.an.note_self_call(self.mm.path, call.lineno, held,
                                   self.cls, call.func.attr)

        # PT052: blocking calls under a lock
        if not held:
            return
        if tail in BLOCKING_SOCKET_METHODS or (
                tail == "send" and _looks_like_socket(recv)):
            self.an.add(Finding(
                "PT052", self.mm.path, call.lineno, symbol=tail,
                message=f"socket .{tail}() while holding "
                        f"{_short(held[-1])} in {self.func}() — a slow "
                        f"or dead peer stalls every thread contending "
                        f"for the lock"))
            return
        if tail in ("get", "put") and recv_kind == "queue":
            if _kwarg(call, "timeout") is not None:
                return
            if call.args and isinstance(call.args[0], ast.Constant) \
                    and call.args[0].value is False:
                return          # .get(False) / .put(x) never blocks
            if tail == "put" and len(call.args) >= 2 \
                    and isinstance(call.args[1], ast.Constant) \
                    and call.args[1].value is False:
                return
            self.an.add(Finding(
                "PT052", self.mm.path, call.lineno, symbol=tail,
                message=f"queue .{tail}() without a timeout while "
                        f"holding {_short(held[-1])} in {self.func}() — "
                        f"backpressure (or an empty queue) parks the "
                        f"lock holder indefinitely"))
            return
        if tail in BLOCKING_PROC_METHODS and (
                recv_kind == "process" or _looks_like_process(recv)):
            if tail == "wait" and (_kwarg(call, "timeout") is not None
                                   or call.args):
                return
            self.an.add(Finding(
                "PT052", self.mm.path, call.lineno, symbol=tail,
                message=f"subprocess .{tail}() while holding "
                        f"{_short(held[-1])} in {self.func}() — child "
                        f"exit time is unbounded"))
            return
        if tail == "join" and not call.args \
                and _kwarg(call, "timeout") is None \
                and recv_kind not in ("queue",):
            # str.join always takes a positional; queue.join is also
            # unbounded but queues are drained by workers we control
            self.an.add(Finding(
                "PT052", self.mm.path, call.lineno, symbol="join",
                message=f"bare .join() while holding {_short(held[-1])} "
                        f"in {self.func}() — if the joined thread needs "
                        f"this lock, this is a deadlock"))


def _short(token: str) -> str:
    return token.split("::", 1)[-1]


class _Analyzer:
    def __init__(self, thread_prefixes: Sequence[str]):
        self.prefixes = tuple(thread_prefixes)
        self.findings: List[Finding] = []
        # token -> token -> first (path, line) seeing that edge
        self.edges: Dict[str, Dict[str, Tuple[str, int]]] = {}
        # (path, class, method) -> acquired tokens (for call expansion)
        self.method_acquires: Dict[Tuple[str, str, str], Set[str]] = {}
        # deferred interprocedural edges: (path, line, held, cls, method)
        self.self_calls: List[Tuple[str, int, Tuple[str, ...], str,
                                    str]] = []

    def add(self, f: Finding):
        self.findings.append(f)

    # -- PT051 graph ------------------------------------------------------
    def note_acquire(self, path: str, line: int,
                     held: Tuple[str, ...], new: str):
        for h in held:
            if h != new:
                self.edges.setdefault(h, {}).setdefault(new, (path, line))

    def note_self_call(self, path: str, line: int, held: Tuple[str, ...],
                       cls: str, method: str):
        self.self_calls.append((path, line, held, cls, method))

    def expand_self_calls(self):
        for path, line, held, cls, method in self.self_calls:
            acq = self.method_acquires.get((path, cls, method), set())
            for tok in acq:
                self.note_acquire(path, line, held, tok)

    def order_cycles(self) -> List[List[str]]:
        """Elementary cycles via SCC decomposition (each SCC with more
        than one node is reported once, as a representative path)."""
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        on: Set[str] = set()
        stack: List[str] = []
        sccs: List[List[str]] = []
        counter = [0]

        def strongconnect(v):
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on.add(v)
            for w in self.edges.get(v, {}):
                if w not in index:
                    strongconnect(w)
                    low[v] = min(low[v], low[w])
                elif w in on:
                    low[v] = min(low[v], index[w])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) > 1:
                    sccs.append(sorted(comp))

        for v in sorted(set(self.edges)
                        | {w for d in self.edges.values() for w in d}):
            if v not in index:
                strongconnect(v)
        return sccs

    def emit_cycles(self):
        for comp in self.order_cycles():
            a = comp[0]
            b = next(w for w in self.edges.get(a, {}) if w in comp)
            path, line = self.edges[a][b]
            names = " -> ".join(_short(t) for t in comp + [comp[0]])
            self.add(Finding(
                "PT051", path, line, symbol=_short(a),
                message=f"lock-acquisition-order cycle: {names} — two "
                        f"threads taking these locks in opposite order "
                        f"deadlock; pick one global order (or split the "
                        f"critical sections)"))


def _iter_defs(tree: ast.Module):
    """(class_name_or_None, FunctionDef) for every top-level function and
    every method of every class (nested defs are handled by the
    walker)."""
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield None, node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    yield node.name, sub


def _resolve_thread_name(call: ast.Call, mm: _ModuleModel,
                         local_consts: Dict[str, str]) -> Tuple[str, bool]:
    """(static name prefix, resolvable) for a Thread(...) call."""
    name = _kwarg(call, "name")
    if name is None:
        return "", False
    if isinstance(name, ast.Constant) and isinstance(name.value, str):
        return name.value, True
    if isinstance(name, ast.JoinedStr) and name.values:
        first = name.values[0]
        if isinstance(first, ast.Constant) and isinstance(first.value,
                                                          str):
            return first.value, True
        if isinstance(first, ast.FormattedValue) \
                and isinstance(first.value, ast.Name):
            v = mm.constants.get(first.value.id,
                                 local_consts.get(first.value.id))
            if v is not None:
                return v, True
    if isinstance(name, ast.Name):
        v = mm.constants.get(name.id, local_consts.get(name.id))
        if v is not None:
            return v, True
    return "", False


def _check_threads(an: _Analyzer, mm: _ModuleModel,
                   walkers: List[_FunctionWalker]):
    for w in walkers:
        for call in w.thread_calls:
            name, ok = _resolve_thread_name(call, mm, {})
            if not ok:
                kw = _kwarg(call, "name")
                why = ("has no name= argument" if kw is None else
                       "name is not statically resolvable to a literal "
                       "prefix")
                an.add(Finding(
                    "PT055", mm.path, call.lineno, symbol="Thread",
                    message=f"framework thread in {w.func}() {why} — "
                            f"name it with a prefix frozen in "
                            f"observability.metrics.THREAD_NAME_PREFIXES "
                            f"so the conftest leak fixture and operators "
                            f"can attribute it"))
                continue
            if not any(name == p or name.startswith(p + "-")
                       or name.startswith(p) for p in an.prefixes):
                an.add(Finding(
                    "PT055", mm.path, call.lineno, symbol=name,
                    message=f"thread name {name!r} does not begin with "
                            f"a prefix registered in observability."
                            f"metrics.THREAD_NAME_PREFIXES"))


def _check_pt050(an: _Analyzer, mm: _ModuleModel,
                 per_class: Dict[str, List[_Write]]):
    for cls, writes in per_class.items():
        cm = mm.classes.get(cls)
        if cm is None:
            continue
        lockish = cm.attrs_of("lock", "rlock", "cond", "event", "queue")
        by_attr: Dict[str, List[_Write]] = {}
        for wr in writes:
            if wr.attr in lockish:
                continue
            by_attr.setdefault(wr.attr, []).append(wr)
        for attr, ws in sorted(by_attr.items()):
            guarded = [w for w in ws if w.guarded]
            naked = [w for w in ws if not w.guarded
                     and w.method.split(".")[0]
                     not in _CONSTRUCTION_METHODS
                     and not w.method.split(".")[0]
                     .endswith(_LOCKED_SUFFIX)]
            if guarded and naked:
                g = guarded[0]
                n = naked[0]
                an.add(Finding(
                    "PT050", mm.path, n.line, symbol=f"{cls}.{attr}",
                    message=f"self.{attr} is written under a class lock "
                            f"in {g.method}() (line {g.line}) but "
                            f"without any lock in {n.method}() — either "
                            f"every write takes the lock or the guard "
                            f"is theater"))


def _handler_targets(call: ast.Call) -> List[ast.expr]:
    """Handler expressions from signal.signal(sig, handler) calls."""
    if _call_tail(call.func) != "signal":
        return []
    # skip signal.signal(sig, old)-style RESTORES of a saved handler:
    # restoring a variable is not registering framework code
    if len(call.args) >= 2:
        return [call.args[1]]
    return []


def _check_pt054(an: _Analyzer, mm: _ModuleModel, tree: ast.Module,
                 acquires_by_method: Dict[Tuple[str, str], Set[str]],
                 acquires_by_func: Dict[str, Set[str]]):
    """Lock acquisition reachable from a registered signal handler."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        for handler in _handler_targets(node):
            toks: Set[str] = set()
            hname = "?"
            if isinstance(handler, ast.Lambda):
                hname = "<lambda>"
                w = _FunctionWalker(_Analyzer(()), mm, None, hname)
                w._visit_expr(handler.body, (), False)
                toks |= w.acquired
                for sub in ast.walk(handler.body):
                    if isinstance(sub, ast.With):
                        for item in sub.items:
                            t = mm.token_of_expr(item.context_expr, None)
                            if t:
                                toks.add(t)
                    if isinstance(sub, ast.Call) \
                            and _call_tail(sub.func) == "acquire":
                        rt = _recv_tail(sub.func)
                        if rt and mm.attr_kind_index.get(rt) in (
                                "lock", "rlock", "cond"):
                            toks.add(rt)
            elif isinstance(handler, ast.Name):
                hname = handler.id
                toks |= acquires_by_func.get(handler.id, set())
            elif isinstance(handler, ast.Attribute):
                hname = handler.attr
                for (cls, meth), acq in acquires_by_method.items():
                    if meth == handler.attr:
                        toks |= acq
            if toks:
                tok = sorted(toks)[0]
                an.add(Finding(
                    "PT054", mm.path, node.lineno, symbol=hname,
                    message=f"signal handler {hname!r} acquires "
                            f"{_short(str(tok))} — the interrupted "
                            f"thread may already hold it (a "
                            f"deadlock class); set a flag/Event in the "
                            f"handler and do the work on a normal "
                            f"thread"))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def analyze_source(src: str, path: str, *,
                   thread_prefixes: Optional[Sequence[str]] = None,
                   _an: Optional[_Analyzer] = None) -> List[Finding]:
    """Run every PT05x rule over one source file."""
    prefixes = (tuple(thread_prefixes) if thread_prefixes is not None
                else thread_name_prefixes())
    an = _an if _an is not None else _Analyzer(prefixes)
    tree = ast.parse(src, filename=path)
    mm = _ModuleModel(tree, path)

    walkers: List[_FunctionWalker] = []
    per_class_writes: Dict[str, List[_Write]] = {}
    acquires_by_method: Dict[Tuple[str, str], Set[str]] = {}
    acquires_by_func: Dict[str, Set[str]] = {}
    for cls, fn in _iter_defs(tree):
        w = _FunctionWalker(an, mm, cls, fn.name)
        w.walk(fn.body)
        walkers.append(w)
        an.method_acquires[(path, cls or "", fn.name)] = set(w.acquired)
        if cls is not None:
            per_class_writes.setdefault(cls, []).extend(w.writes)
            acquires_by_method.setdefault((cls, fn.name),
                                          set()).update(w.acquired)
        else:
            acquires_by_func.setdefault(fn.name, set()).update(w.acquired)

    _check_threads(an, mm, walkers)
    _check_pt050(an, mm, per_class_writes)
    _check_pt054(an, mm, tree, acquires_by_method, acquires_by_func)

    if _an is None:          # single-file mode: close the graph locally
        an.expand_self_calls()
        an.emit_cycles()
        return sorted(an.findings, key=lambda f: (f.path, f.line, f.code))
    return an.findings


def analyze_package(root: Optional[str] = None, *,
                    thread_prefixes: Optional[Sequence[str]] = None
                    ) -> List[Finding]:
    """Run the pass over every ``paddle_tpu_torch/**.py`` source file."""
    root = root or package_root()
    prefixes = (tuple(thread_prefixes) if thread_prefixes is not None
                else thread_name_prefixes())
    an = _Analyzer(prefixes)
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            full = os.path.join(dirpath, f)
            rel = os.path.relpath(
                full, os.path.join(root, os.pardir)).replace(os.sep, "/")
            with open(full) as fh:
                analyze_source(fh.read(), rel,
                               thread_prefixes=prefixes, _an=an)
    an.expand_self_calls()
    an.emit_cycles()
    return sorted(an.findings, key=lambda f: (f.path, f.line, f.code))


def apply_baseline(findings: Sequence[Finding],
                   baseline: Optional[Dict] = None):
    """Split findings against the frozen baseline.

    Returns ``(new, suppressed, stale)``: findings beyond each
    (path, code) budget; the count suppressed per baselined key; and
    baseline keys whose budget exceeds today's findings (must be
    ratcheted down)."""
    baseline = BASELINE if baseline is None else baseline
    by_key: Dict[Tuple[str, str], List[Finding]] = {}
    for f in findings:
        by_key.setdefault((f.path, f.code), []).append(f)
    new: List[Finding] = []
    suppressed: Dict[Tuple[str, str], int] = {}
    for key, fs in sorted(by_key.items()):
        allowed = baseline.get(key, (0, ""))[0]
        if allowed:
            suppressed[key] = min(allowed, len(fs))
        if len(fs) > allowed:
            new.extend(fs[allowed:])
    stale = sorted(key for key, (allowed, _why) in baseline.items()
                   if len(by_key.get(key, [])) < allowed)
    return new, suppressed, stale


def render_report(findings: Sequence[Finding],
                  baseline: Optional[Dict] = None) -> str:
    """Human-readable report with the baseline applied."""
    new, suppressed, stale = apply_baseline(findings, baseline)
    lines = [f"concurrency verifier: {len(findings)} finding(s), "
             f"{sum(suppressed.values())} baselined, {len(new)} new"]
    lines += [f"  {f.render()}" for f in new]
    for (path, code), n in sorted(suppressed.items()):
        why = (BASELINE if baseline is None else baseline)[(path,
                                                            code)][1]
        lines.append(f"  baselined {code} x{n} in {path}: {why}")
    for key in stale:
        lines.append(f"  STALE baseline entry {key}: fewer findings "
                     f"remain than budgeted — ratchet it down")
    return "\n".join(lines)
