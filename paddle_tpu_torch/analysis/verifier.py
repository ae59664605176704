"""Well-formedness pass over the Program IR (counterpart of
``paddle_tpu/analysis/verifier.py``, PT001-PT007).

The reference enforces graph well-formedness structurally: OpDesc
construction cross-checks the OpInfoMap proto (op_desc.cc, op_registry.h
148-290), block/var lookups hard-fail (block_desc.h), and grad-var pairing
is guaranteed by the GradOpDescMaker machinery (backward.cc:353-415).
The Python-native IR has none of those guard rails, so this pass
recovers them as explicit checks:

* **PT001** an op input names a variable that is declared nowhere and
  produced by nothing — a dangling reference (typo, or a dropped var).
* **PT002** the input is declared but *no op ever produces it* and it is
  not feedable (``is_data``) or persistable (startup-initialized) — the
  producing op was dropped.
* **PT007** the only producers run *after* the consumer (def-after-use;
  two such edges form a dependency cycle — the reference's topological
  OpDesc order makes this unrepresentable, our op list does not).
* **PT003** (warning) an op writes a variable that is not declared in any
  visible block — executes fine (the interpreter's env binds it) but the
  IR no longer round-trips through ``Program.to_dict``.
* **PT004** (warning) two ops write the same variable and the later one
  does not read it — a rebind that silently shadows the earlier value
  (in-place update chains, which *do* read the var, are exempt).
* **PT005** the op type has no registered implementation
  (``core.registry``); the ``backward`` pseudo-op, which the executor
  runs itself through autograd, counts as registered.
* **PT006** an orphaned ``@GRAD``/``@LEN`` companion: a gradient var read
  without any ``backward`` op producing it, or a length companion whose
  base var is missing or not a sequence (``lod_level == 0``).

Sub-blocks (while/rnn/beam bodies) are checked leniently — their inputs
may be bound by the parent op's lowering convention (loop carries, step
slices), which the verifier recognizes by collecting every variable name
reachable from the parent op's slots and string-valued attrs.
"""
from __future__ import annotations

from typing import Dict, List, Set

from ..core.program import (GRAD_SUFFIX, LEN2_SUFFIX, LEN_SUFFIX,
                            _sub_block_indices)
from ..core.registry import has_op as _has_registered_op
from .diagnostics import ValidationReport, diag

#: op types the executor runs itself rather than through the registry
#: (``core/executor.py`` ``_run_backward``)
EXECUTOR_OPS = frozenset({"backward"})


def has_op(name: str) -> bool:
    return name in EXECUTOR_OPS or _has_registered_op(name)

#: op types whose execution is a side effect (kept live by the dead-code
#: lint, and legitimate without consumers here)
SIDE_EFFECT_OPS = frozenset({
    "print", "assert", "save", "load", "feed", "fetch",
})

#: ops that target an EXISTING output var on purpose (they forward
#: metadata like @LEN companions rather than rebinding the value) —
#: exempt from the duplicate-writer check
_METADATA_OPS = frozenset({"copy_len"})


def _companion_base(name: str):
    """(base, kind) for ``X@GRAD`` / ``X@LEN`` / ``X@LEN2`` names."""
    for suffix in (LEN2_SUFFIX, LEN_SUFFIX, GRAD_SUFFIX):
        if name.endswith(suffix):
            return name[:-len(suffix)], suffix
    return None, None


def _attr_names(op) -> Set[str]:
    """Every string (or list-of-strings) attr value of ``op`` — the
    superset of the per-op sub-block binding conventions (token_name,
    step_inputs, mem_step_names, ...)."""
    out: Set[str] = set()
    for v in op.attrs.values():
        if isinstance(v, str):
            out.add(v)
        elif isinstance(v, (list, tuple)):
            out.update(x for x in v if isinstance(x, str))
    return out


def _initially_defined(program) -> Set[str]:
    """Names available before any op runs: feeds (plus their sequence
    companions) and persistable state the startup program owns."""
    defined: Set[str] = set()
    for b in program.blocks:
        for v in b.vars.values():
            if v.is_data:
                defined.add(v.name)
                if v.lod_level >= 1:
                    defined.add(v.name + LEN_SUFFIX)
                if v.lod_level >= 2:
                    defined.add(v.name + LEN2_SUFFIX)
            elif v.persistable:
                defined.add(v.name)
    return defined


def run_verifier(program, report: ValidationReport):
    """Append PT001-PT007 findings for ``program`` to ``report``."""
    # sub-block idx -> names bound by the referencing parent op
    sub_binders: Dict[int, Set[str]] = {}
    for b in program.blocks:
        for op in b.ops:
            for idx in _sub_block_indices(op):
                binds = sub_binders.setdefault(idx, set())
                binds.update(op.input_names)
                binds.update(op.output_names)
                binds.update(_attr_names(op))

    produced_anywhere: Set[str] = set()
    for b in program.blocks:
        for op in b.ops:
            produced_anywhere.update(op.output_names)
            for n in op.output_names:
                # sequence/length companions emitted via ctx.set_len
                produced_anywhere.add(n + LEN_SUFFIX)
                produced_anywhere.add(n + LEN2_SUFFIX)

    base_defined = _initially_defined(program)

    for block in program.blocks:
        _check_declared_companions(block, report)
        if block.idx == 0:
            _check_block_strict(program, block, base_defined, report)
        else:
            _check_block_lenient(program, block, base_defined,
                                 sub_binders.get(block.idx, set()),
                                 produced_anywhere, report)


def _producers(block) -> Dict[str, List[int]]:
    """var name -> indices of ops that CREATE it (in-place updates — the
    op also reads the name — do not count as creation)."""
    prods: Dict[str, List[int]] = {}
    for i, op in enumerate(block.ops):
        in_names = set(op.input_names)
        for n in op.output_names:
            if n not in in_names:
                prods.setdefault(n, []).append(i)
    return prods


def _check_block_strict(program, block, base_defined: Set[str],
                        report: ValidationReport):
    defined = set(base_defined)
    prods = _producers(block)
    writers_seen: Dict[str, int] = {}

    for idx, op in enumerate(block.ops):
        loc = (block.idx, idx, op.type)
        if not has_op(op.type):
            report.add(diag("PT005",
                            f"op type {op.type!r} has no registered "
                            f"implementation", op=loc))
        in_names = set(op.input_names)
        for name in op.input_names:
            if name in defined:
                continue
            base, kind = _companion_base(name)
            if kind in (LEN_SUFFIX, LEN2_SUFFIX):
                v = block._find_var_recursive(base)
                if v is None or v.lod_level == 0:
                    report.add(diag(
                        "PT006",
                        f"length companion {name!r} has no sequence base "
                        f"var ({base!r} "
                        f"{'missing' if v is None else 'is not lod>0'})",
                        op=loc, var=name))
                continue
            later = [i for i in prods.get(name, []) if i >= idx]
            if kind == GRAD_SUFFIX and not prods.get(name):
                report.add(diag(
                    "PT006",
                    f"gradient var {name!r} is consumed but no backward "
                    f"op produces it (orphaned @GRAD — was "
                    f"append_backward dropped?)", op=loc, var=name))
            elif later:
                report.add(diag(
                    "PT007",
                    f"op reads {name!r} produced only by later op(s) "
                    f"{later} — def-after-use (dependency cycle when "
                    f"mutual)", op=loc, var=name))
            elif block._find_var_recursive(name) is not None:
                report.add(diag(
                    "PT002",
                    f"var {name!r} is declared but never produced by any "
                    f"op, fed, or initialized", op=loc, var=name))
            else:
                report.add(diag(
                    "PT001",
                    f"op input names undeclared var {name!r} with no "
                    f"producer (dangling reference)", op=loc, var=name))

        has_sub = bool(_sub_block_indices(op))
        for name in op.output_names:
            if block._find_var_recursive(name) is None:
                report.add(diag(
                    "PT003",
                    f"op writes var {name!r} that no block declares",
                    op=loc, var=name))
            if not has_sub and name not in in_names and \
                    op.type not in _METADATA_OPS:
                prev = writers_seen.get(name)
                if prev is not None:
                    report.add(diag(
                        "PT004",
                        f"var {name!r} already written by op #{prev}; "
                        f"this op rebinds it without reading it",
                        op=loc, var=name))
                writers_seen[name] = idx
            defined.add(name)
            defined.add(name + LEN_SUFFIX)
            defined.add(name + LEN2_SUFFIX)


def _check_block_lenient(program, block, base_defined: Set[str],
                         binders: Set[str], produced_anywhere: Set[str],
                         report: ValidationReport):
    """Sub-block pass: parent lowerings bind loop carries/step slices, so
    only fully-dangling references (PT001) and unregistered ops (PT005)
    are decidable."""
    for idx, op in enumerate(block.ops):
        loc = (block.idx, idx, op.type)
        if not has_op(op.type):
            report.add(diag("PT005",
                            f"op type {op.type!r} has no registered "
                            f"implementation", op=loc))
        for name in op.input_names:
            if name in base_defined or name in binders or \
                    name in produced_anywhere:
                continue
            base, kind = _companion_base(name)
            if kind is not None and (base in base_defined or
                                     base in binders or
                                     base in produced_anywhere):
                continue
            if block._find_var_recursive(name) is None:
                report.add(diag(
                    "PT001",
                    f"op input names undeclared var {name!r} with no "
                    f"producer (dangling reference)", op=loc, var=name))


def _check_declared_companions(block, report: ValidationReport):
    """Declared ``X@GRAD``/``X@LEN`` vars must have a live base var (the
    @LEN base must be a sequence)."""
    for name, v in block.vars.items():
        base, kind = _companion_base(name)
        if kind is None:
            continue
        bv = block._find_var_recursive(base)
        if bv is None:
            report.add(diag(
                "PT006",
                f"declared companion {name!r} has no base var {base!r}",
                var=name))
        elif kind in (LEN_SUFFIX, LEN2_SUFFIX) and bv.lod_level == 0:
            report.add(diag(
                "PT006",
                f"declared length companion {name!r}: base {base!r} is "
                f"not a sequence (lod_level=0)", var=name))
