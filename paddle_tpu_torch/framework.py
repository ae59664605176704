"""Compat namespace mirroring ``fluid.framework`` import paths
(counterpart of ``paddle_tpu/framework.py``)."""
from .core.program import (   # noqa: F401
    Program, Block, Operator, Variable, Parameter,
    default_main_program, default_startup_program, program_guard,
    grad_var_name,
)
from .core import unique_name  # noqa: F401
from .core.types import VarType, convert_dtype  # noqa: F401
