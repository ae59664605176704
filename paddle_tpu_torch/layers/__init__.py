"""Layer API (counterpart of ``paddle_tpu/layers``): the layers the
ResNet serving and training paths and the gradient clips build."""

from .io import data  # noqa: F401
from .nn import *  # noqa: F401,F403
from .nn import __all__ as _nn_all
from .tensor import sums, fill_constant  # noqa: F401
from .control_flow import increment  # noqa: F401
from .ops import sqrt, sign  # noqa: F401

__all__ = ["data"] + list(_nn_all) + ["sums", "fill_constant", "increment",
                                      "sqrt", "sign"]
