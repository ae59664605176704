"""Layer API (counterpart of ``paddle_tpu/layers``): the layers the
ResNet serving and training paths, the gradient clips, the attention
slice, the seq2seq slice, the model zoo, beam-search decoding, the
learning-rate schedules, the dense op families and the tensor and math
op families build."""

from . import control_flow  # noqa: F401
from .io import data  # noqa: F401
from .nn import *  # noqa: F401,F403
from .nn import __all__ as _nn_all
from .tensor import (create_tensor, create_global_var,  # noqa: F401
                     sums, assign, fill_constant,
                     fill_constant_batch_size_like, ones, zeros, zeros_like,
                     reverse, argmax, argsort, gather, scatter, shape, range,
                     slice)
from .control_flow import increment, less_than, equal, StaticRNN  # noqa: F401
from .ops import *  # noqa: F401,F403
from .ops import __all__ as _ops_all
from .ops import elementwise_binary_dispatch  # noqa: F401
from .generation import (BeamSearchDecoder, get_beam_hook,  # noqa: F401
                         register_beam_hook, attention_with_cache)

__all__ = ["data"] + list(_nn_all) + [
    "create_tensor", "create_global_var", "sums", "assign",
    "fill_constant", "fill_constant_batch_size_like", "ones", "zeros",
    "zeros_like", "reverse", "argmax", "argsort", "gather", "scatter",
    "shape", "range", "slice", "increment", "less_than", "equal",
    "StaticRNN"] + [n for n in _ops_all if n not in _nn_all] + [
    "elementwise_binary_dispatch", "BeamSearchDecoder",
    "get_beam_hook", "register_beam_hook", "attention_with_cache"]
