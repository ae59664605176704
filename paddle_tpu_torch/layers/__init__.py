"""Layer API (counterpart of ``paddle_tpu/layers``): the layers the
ResNet serving and training paths, the gradient clips, the attention
slice, the seq2seq slice and the model zoo build."""

from . import control_flow  # noqa: F401
from .io import data  # noqa: F401
from .nn import *  # noqa: F401,F403
from .nn import __all__ as _nn_all
from .tensor import sums, fill_constant, fill_constant_batch_size_like  # noqa: F401
from .control_flow import increment, StaticRNN  # noqa: F401
from .ops import sqrt, sign, sigmoid, tanh  # noqa: F401

__all__ = ["data"] + list(_nn_all) + [
    "sums", "fill_constant", "fill_constant_batch_size_like", "increment",
    "StaticRNN", "sqrt", "sign", "sigmoid", "tanh"]
