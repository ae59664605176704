"""Core IR + runtime: Program/Block/Op/Var, registry, Executor, Scope."""

from . import unique_name
from .types import VarType, convert_dtype, to_torch_dtype
from .program import (
    Program, Block, Operator, Variable, Parameter,
    default_main_program, default_startup_program, program_guard,
    reset_default_programs, grad_var_name,
)
from .registry import register_op, get_op_impl
from .scope import Scope, global_scope, reset_global_scope
from .executor import (
    Executor, Place, CPUPlace, CUDAPlace, Env, ExecContext, interpret_ops,
    run_op, stack_feeds, pad_batch,
)

__all__ = [
    "unique_name", "VarType", "convert_dtype", "to_torch_dtype",
    "Program", "Block", "Operator", "Variable", "Parameter",
    "default_main_program", "default_startup_program", "program_guard",
    "reset_default_programs", "grad_var_name", "register_op", "get_op_impl",
    "Scope", "global_scope", "reset_global_scope",
    "Executor", "Place", "CPUPlace", "CUDAPlace",
    "Env", "ExecContext", "interpret_ops", "run_op", "stack_feeds",
    "pad_batch",
]
