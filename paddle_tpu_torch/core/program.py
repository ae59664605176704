"""Program IR: Variable / Operator / Block / Program.

Counterpart of ``paddle_tpu/core/program.py``: the same objects and the
same JSON form (``Program.to_dict`` / ``from_dict``), so a program
serialized by either package loads in the other.  The Executor
(``core/executor.py``) interprets these objects op by op on torch
tensors.

Sub-blocks (``create_block`` / ``rollback``) hold the step of a
``StaticRNN``; an op names its block by the ``sub_block`` attr.

Left out until a slice needs them: arithmetic sugar on ``Variable``
(it routes through layers not ported yet), pipeline stages and the
static verifier.
"""
from __future__ import annotations

import contextlib
import copy
import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from . import unique_name as unique_name_mod
from .types import VarType, convert_dtype

# ``append_backward`` declares the gradient of ``p`` as ``p@GRAD``
GRAD_SUFFIX = "@GRAD"


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


class Variable:
    """A named tensor slot in a Block.  ``dtype`` is a canonical dtype
    name (``core/types.py``); ``shape`` may hold ``-1`` in the batch
    dimension."""

    def __init__(self, block: "Block", name: str, shape=None, dtype="float32",
                 lod_level: int = 0, persistable: bool = False,
                 stop_gradient: bool = False,
                 type: VarType = VarType.LOD_TENSOR, initializer=None,
                 is_data: bool = False, session_feed: bool = False,
                 **kwargs):
        self.block = block
        self.name = name
        self.shape = tuple(int(s) for s in shape) if shape is not None else None
        self.dtype = convert_dtype(dtype)
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.type = type
        self.is_data = is_data
        self.session_feed = session_feed
        self.op = None            # the op that produced this var (last writer)

    def __repr__(self):
        return (f"Variable(name={self.name!r}, shape={self.shape}, "
                f"dtype={self.dtype}, lod={self.lod_level}, "
                f"persistable={self.persistable})")

    __str__ = __repr__

    # arithmetic sugar (``paddle_tpu/core/program.py:98-128``): ops
    # appended through layers.elementwise_binary_dispatch
    def _binary(self, other, op, reverse=False):
        from .. import layers
        a, b = (other, self) if reverse else (self, other)
        return layers.elementwise_binary_dispatch(op, a, b)

    def __add__(self, other):
        return self._binary(other, "elementwise_add")

    def __radd__(self, other):
        return self._binary(other, "elementwise_add", True)

    def __sub__(self, other):
        return self._binary(other, "elementwise_sub")

    def __rsub__(self, other):
        return self._binary(other, "elementwise_sub", True)

    def __mul__(self, other):
        return self._binary(other, "elementwise_mul")

    def __rmul__(self, other):
        return self._binary(other, "elementwise_mul", True)

    def __truediv__(self, other):
        return self._binary(other, "elementwise_div")

    def __rtruediv__(self, other):
        return self._binary(other, "elementwise_div", True)

    def to_dict(self):
        return {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype,
            "lod_level": self.lod_level,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "type": self.type.value,
            "is_data": self.is_data,
            "session_feed": self.session_feed,
            "is_parameter": isinstance(self, Parameter),
            "trainable": getattr(self, "trainable", None),
        }


class Parameter(Variable):
    """A trainable persistable variable with its optimization attributes
    (read by ``optimizer``, ``regularizer`` and ``clip``).  As in the JAX
    package's JSON form, only ``trainable`` is serialized: a program
    loaded from JSON has the default learning-rate multiplier and no
    regularizer or clip annotation."""

    def __init__(self, block, name, shape, dtype, trainable=True,
                 regularizer=None, gradient_clip_attr=None,
                 optimize_attr=None, sharding=None, **kwargs):
        super().__init__(block, name, shape=shape, dtype=dtype,
                         persistable=True, **kwargs)
        self.trainable = trainable
        self.regularizer = regularizer
        self.gradient_clip_attr = gradient_clip_attr
        self.optimize_attr = optimize_attr or {"learning_rate": 1.0}
        self.sharding = sharding


class Operator:
    """One operation: type + named input/output var lists + attrs.
    ``inputs``/``outputs`` map slot name -> list of variable names."""

    def __init__(self, block: "Block", type: str,
                 inputs: Optional[Dict[str, Any]] = None,
                 outputs: Optional[Dict[str, Any]] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.block = block
        self.type = type
        self.inputs = {k: _to_name_list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: _to_name_list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    @property
    def input_names(self):
        return [n for ns in self.inputs.values() for n in ns]

    @property
    def output_names(self):
        return [n for ns in self.outputs.values() for n in ns]

    def __repr__(self):
        return f"Operator({self.type}, in={self.inputs}, out={self.outputs})"

    def to_dict(self):
        attrs = {}
        for k, v in self.attrs.items():
            if isinstance(v, np.ndarray):
                attrs[k] = {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
            else:
                attrs[k] = v
        return {"type": self.type, "inputs": self.inputs,
                "outputs": self.outputs, "attrs": attrs}


def _to_name_list(v) -> List[str]:
    if v is None:
        return []
    if isinstance(v, (list, tuple)):
        return [x.name if isinstance(x, Variable) else str(x) for x in v]
    return [v.name if isinstance(v, Variable) else str(v)]


class Block:
    """vars + ops, with a parent for nested control flow."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    @property
    def parent_block(self) -> Optional["Block"]:
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    def create_var(self, name=None, **kwargs) -> Variable:
        if name is None:
            name = unique_name_mod.generate("tmp")
        if name in self.vars:
            return self.vars[name]
        v = Variable(self, name, **kwargs)
        self.vars[name] = v
        return v

    def create_parameter(self, name, shape, dtype, **kwargs) -> Parameter:
        p = Parameter(self, name, shape, dtype, **kwargs)
        # parameters always live in block 0
        self.program.global_block().vars[name] = p
        return p

    def var(self, name: str) -> Variable:
        v = self._find_var_recursive(name)
        if v is None:
            raise KeyError(f"Variable {name!r} not found in block {self.idx} "
                           f"or its ancestors")
        return v

    def has_var(self, name: str) -> bool:
        return self._find_var_recursive(name) is not None

    def _find_var_recursive(self, name: str) -> Optional[Variable]:
        b: Optional[Block] = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent_block
        return None

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def append_op(self, type: str, inputs=None, outputs=None, attrs=None) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        for ns in op.outputs.values():
            for n in ns:
                if n in self.vars:
                    self.vars[n].op = op
        self.program._bump_version()
        return op

    def to_dict(self):
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "vars": [v.to_dict() for v in self.vars.values()],
            "ops": [op.to_dict() for op in self.ops],
        }


class Program:
    """A list of blocks; block 0 is global.  ``version`` increments on
    mutation."""

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self.current_block_idx = 0
        self.version = 0
        self.random_seed = 0

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def create_block(self, parent_idx=None) -> Block:
        """Append a sub-block (a StaticRNN step) whose parent is the
        current block or ``parent_idx``, and make it current."""
        parent = self.current_block_idx if parent_idx is None else parent_idx
        b = Block(self, len(self.blocks), parent)
        self.blocks.append(b)
        self.current_block_idx = b.idx
        self._bump_version()
        return b

    def rollback(self):
        """Make the current block's parent current again."""
        self.current_block_idx = max(self.current_block().parent_idx, 0)

    def _bump_version(self):
        self.version += 1

    def all_parameters(self) -> List[Parameter]:
        return self.global_block().all_parameters()

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    def clone(self, for_test: bool = False) -> "Program":
        """Deep copy.  With ``for_test`` ops flip their ``is_test`` attr
        (dropout/batch_norm inference behavior)."""
        p = copy.deepcopy(self)
        if for_test:
            for b in p.blocks:
                for op in b.ops:
                    if "is_test" in _TEST_SENSITIVE_OPS.get(op.type, ()):
                        op.attrs["is_test"] = True
            p._bump_version()
        return p

    def prune(self, targets: Sequence[Variable]) -> "Program":
        """Backward-slice the global block to the ops ``targets`` need
        (``paddle_tpu/core/program.py:409``).  An op that only rewrites
        its own inputs (an optimizer's ParamOut) is dropped; ops with
        sub-blocks keep what their blocks read."""
        needed = {t.name if isinstance(t, Variable) else str(t)
                  for t in targets}
        p = copy.deepcopy(self)
        gb = p.global_block()
        kept: List[Operator] = []
        for op in reversed(gb.ops):
            produces = set(op.output_names) & needed
            if not produces:
                continue
            subs = _sub_block_indices(op)
            if not subs and produces <= set(op.input_names):
                continue
            kept.append(op)
            needed |= set(op.input_names)
            for idx in subs:
                for sop in p.blocks[idx].ops:
                    needed |= set(sop.input_names)
        gb.ops = list(reversed(kept))
        p._bump_version()
        return p

    def to_dict(self):
        return {"version": 1, "random_seed": self.random_seed,
                "blocks": [b.to_dict() for b in self.blocks]}

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @staticmethod
    def from_dict(d: dict) -> "Program":
        p = Program()
        p.random_seed = d.get("random_seed", 0)
        for bd in d["blocks"][1:]:
            p.blocks.append(Block(p, bd["idx"], bd["parent_idx"]))
        for bd in d["blocks"]:
            b = p.blocks[bd["idx"]]
            for vd in bd["vars"]:
                kwargs = dict(vd)
                name = kwargs.pop("name")
                kwargs["type"] = VarType(kwargs.pop("type", "lod_tensor"))
                is_param = kwargs.pop("is_parameter", False)
                trainable = kwargs.pop("trainable", None)
                if is_param:
                    b.create_parameter(
                        name=name, shape=kwargs.pop("shape"),
                        dtype=kwargs.pop("dtype"),
                        trainable=trainable if trainable is not None else True,
                        lod_level=kwargs.get("lod_level", 0))
                else:
                    b.create_var(name=name, **kwargs)
            for od in bd["ops"]:
                attrs = {}
                for k, v in od["attrs"].items():
                    if isinstance(v, dict) and "__ndarray__" in v:
                        attrs[k] = np.array(v["__ndarray__"], dtype=v["dtype"])
                    else:
                        attrs[k] = v
                b.append_op(od["type"], od["inputs"], od["outputs"], attrs)
        p.current_block_idx = 0
        return p

    @staticmethod
    def from_json(s: str) -> "Program":
        return Program.from_dict(json.loads(s))


def _sub_block_indices(op: Operator) -> List[int]:
    out = [v for key in ("sub_block", "sub_block_idx", "block")
           for v in (op.attrs.get(key),) if isinstance(v, int)]
    v = op.attrs.get("sub_blocks")
    if isinstance(v, (list, tuple)):
        out.extend(int(x) for x in v)
    return out


# ops whose behavior changes between train and test
_TEST_SENSITIVE_OPS = {
    "dropout": ("is_test",),
    "batch_norm": ("is_test",),
}

# ---------------------------------------------------------------------------
# default programs + program_guard
# ---------------------------------------------------------------------------
_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


@contextlib.contextmanager
def program_guard(main_program: Program, startup_program: Optional[Program] = None):
    global _main_program, _startup_program
    old_main, old_startup = _main_program, _startup_program
    _main_program = main_program
    if startup_program is not None:
        _startup_program = startup_program
    try:
        yield
    finally:
        _main_program, _startup_program = old_main, old_startup


def reset_default_programs():
    """Fresh default programs (test helper)."""
    global _main_program, _startup_program
    _main_program = Program()
    _startup_program = Program()
