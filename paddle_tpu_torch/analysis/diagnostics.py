"""Structured diagnostics for the static program verifier (counterpart
of ``paddle_tpu/analysis/diagnostics.py``, the same codes and
severities).

The reference validates graphs inside its C++ desc layer — InferShape
hard-CHECKs (operator.cc RunImpl -> InferShapeContext), OpDesc attribute
checking (op_desc.cc), PADDLE_ENFORCE formatting (enforce.h) — and a failed
check aborts with a C++ stack trace.  The model-as-data IR
(core/program.py) has no such layer, so this module supplies its
replacement: every verification pass emits :class:`Diagnostic` records
with *stable* ``PT0xx`` codes instead of raising mid-walk, and a
:class:`ValidationReport` renders them as a readable, greppable report.
The table is equal, code for code and severity for severity, to the JAX
package's, so a report over one serialized program reads the same from
either package.

Code registry (frozen — new checks take new codes, existing codes never
change meaning):

========  ========  =====================================================
code      severity  meaning
========  ========  =====================================================
PT001     error     op input names a variable declared nowhere
PT002     error     use-before-def: input is never produced before use
PT003     warning   op output name is not declared in any visible block
PT004     warning   duplicate writers: var rebound by a non-reading op
PT005     error     op type has no registered lowering
PT006     error     orphaned companion: @GRAD/@LEN var without a base
PT007     error     dependency cycle among ops (via non-in-place defs)
PT010     error     shape inference: op inputs are incompatible
PT011     error     inferred dtype contradicts the declared dtype
PT012     error     inferred shape contradicts the declared shape
PT020     warning   dead op: unreachable from any fetch/state/effect
PT021     warning   retrace hazard: feed signature cannot stay stable
PT022     warning   retrace hazard: persistable var rebound per step
PT030     error     sharding spec names an axis the mesh does not have
PT031     error     sharded dim not divisible by its mesh axis size
PT040     error     sharding spec double-books a mesh axis across dims
PT041     warning   sharding conflict at an op: a reshard is required
PT042     warning   sharding propagation blind spot: op has no shard rule
PT050     warning   shared attribute written both under and outside a lock
PT051     error     static lock-acquisition-order cycle
PT052     warning   blocking call while holding a lock
PT053     error     Condition.wait outside a while-predicate loop
PT054     error     lock acquisition reachable from a signal handler
PT055     warning   framework thread without a registered pt- name prefix
========  ========  =====================================================

The PT05x family is emitted by :mod:`.concurrency` — an AST pass over the
*host source tree* (the threaded runtime itself), not the Program IR, so
its diagnostics locate findings as ``path:line`` in the message and leave
``op`` empty.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

ERROR = "error"
WARNING = "warning"

#: code -> (default severity, one-line description)
CODES = {
    "PT001": (ERROR, "undefined input variable"),
    "PT002": (ERROR, "variable used before any producer"),
    "PT003": (WARNING, "output variable not declared"),
    "PT004": (WARNING, "duplicate writers of a variable"),
    "PT005": (ERROR, "unregistered op type"),
    "PT006": (ERROR, "orphaned @GRAD/@LEN companion"),
    "PT007": (ERROR, "dependency cycle among ops"),
    "PT010": (ERROR, "shape inference failed"),
    "PT011": (ERROR, "dtype mismatch vs declaration"),
    "PT012": (ERROR, "shape mismatch vs declaration"),
    "PT020": (WARNING, "dead op unreachable from targets"),
    "PT021": (WARNING, "retrace hazard: unstable feed signature"),
    "PT022": (WARNING, "retrace hazard: persistable var rebound"),
    "PT030": (ERROR, "sharding spec names unknown mesh axis"),
    "PT031": (ERROR, "sharded dim not divisible by axis size"),
    "PT040": (ERROR, "mesh axis double-booked across dims of one spec"),
    "PT041": (WARNING, "sharding conflict at an op (reshard required)"),
    "PT042": (WARNING, "sharding propagation blind spot (no shard rule)"),
    "PT050": (WARNING, "shared attribute written both under and outside "
                       "a lock (guard inconsistency)"),
    "PT051": (ERROR, "static lock-acquisition-order cycle"),
    "PT052": (WARNING, "blocking call while holding a lock"),
    "PT053": (ERROR, "Condition.wait outside a while-predicate loop"),
    "PT054": (ERROR, "lock acquisition reachable from a signal handler"),
    "PT055": (WARNING, "framework thread without a registered pt- name "
                       "prefix"),
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding: stable code + severity + graph location + message.

    ``op`` locates the finding as ``(block_idx, op_idx, op_type)`` — the
    Program-IR analog of the reference's per-op PADDLE_ENFORCE context
    (enforce.h formats the op type and the failing check) — or ``None``
    for program-level findings (e.g. a bad sharding spec on a parameter).
    ``var`` names the variable involved when there is one.
    """

    code: str
    severity: str
    message: str
    op: Optional[Tuple[int, int, str]] = None
    var: Optional[str] = None

    def __post_init__(self):
        if self.code not in CODES:
            raise ValueError(f"unknown diagnostic code {self.code!r}")
        if self.severity not in (ERROR, WARNING):
            raise ValueError(f"bad severity {self.severity!r}")

    @property
    def is_error(self) -> bool:
        return self.severity == ERROR

    def render(self) -> str:
        loc = ""
        if self.op is not None:
            b, i, t = self.op
            loc = f" at block {b} op #{i} ({t})"
        var = f" [var {self.var!r}]" if self.var else ""
        return f"{self.code} {self.severity}{loc}{var}: {self.message}"

    def __str__(self):
        return self.render()


def diag(code: str, message: str, op=None, var: Optional[str] = None,
         severity: Optional[str] = None) -> Diagnostic:
    """Build a Diagnostic with the code's default severity unless overridden."""
    sev = severity or CODES[code][0]
    op_loc = None
    if op is not None:
        # accept a core.program.Operator (located via its block) or a tuple
        if isinstance(op, tuple):
            op_loc = op
        else:
            block = op.block
            try:
                idx = block.ops.index(op)
            except ValueError:
                idx = -1
            op_loc = (block.idx, idx, op.type)
    return Diagnostic(code=code, severity=sev, message=message, op=op_loc,
                      var=var)


class ProgramVerificationError(ValueError):
    """Raised when a program fails validation with error-severity findings.

    Carries the full :class:`ValidationReport` so callers (and tests) can
    inspect individual codes instead of parsing the rendered text.
    """

    def __init__(self, report: "ValidationReport"):
        self.report = report
        super().__init__(report.render())


class ValidationReport:
    """Ordered collection of diagnostics from one validation run."""

    def __init__(self, diagnostics: Optional[List[Diagnostic]] = None):
        self.diagnostics: List[Diagnostic] = list(diagnostics or [])

    # -- building ---------------------------------------------------------
    def add(self, d: Diagnostic):
        self.diagnostics.append(d)

    def extend(self, ds):
        self.diagnostics.extend(ds)

    # -- queries ----------------------------------------------------------
    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.is_error]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if not d.is_error]

    @property
    def ok(self) -> bool:
        return not self.errors

    def codes(self) -> List[str]:
        return [d.code for d in self.diagnostics]

    def __len__(self):
        return len(self.diagnostics)

    def __iter__(self):
        return iter(self.diagnostics)

    def __bool__(self):
        # truthiness == "has findings", so `if report:` reads naturally
        return bool(self.diagnostics)

    def raise_on_error(self) -> "ValidationReport":
        if self.errors:
            raise ProgramVerificationError(self)
        return self

    def render(self) -> str:
        if not self.diagnostics:
            return "program verifier: OK (0 diagnostics)"
        lines = [f"program verifier: {len(self.errors)} error(s), "
                 f"{len(self.warnings)} warning(s)"]
        lines += [f"  {d.render()}" for d in self.diagnostics]
        return "\n".join(lines)

    def __str__(self):
        return self.render()

    def __repr__(self):
        return (f"ValidationReport(errors={len(self.errors)}, "
                f"warnings={len(self.warnings)})")
