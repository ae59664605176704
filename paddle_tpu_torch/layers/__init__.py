"""Layer API (counterpart of ``paddle_tpu/layers``): every public
callable of the JAX package's ``layers``, from ``nn``, ``tensor``,
``control_flow``, ``io``, ``ops``, ``detection`` and ``generation``."""

from . import control_flow, detection  # noqa: F401
from .io import data  # noqa: F401
from .nn import *  # noqa: F401,F403
from .nn import __all__ as _nn_all
from .tensor import (create_tensor, create_global_var,  # noqa: F401
                     sums, assign, fill_constant,
                     fill_constant_batch_size_like, ones, zeros, zeros_like,
                     reverse, argmax, argsort, gather, scatter, shape, range,
                     slice)
from .control_flow import *  # noqa: F401,F403
from .control_flow import __all__ as _cf_all
from .detection import (prior_box, box_coder, iou_similarity,  # noqa: F401
                        ssd_loss, detection_output)
from .ops import *  # noqa: F401,F403
from .ops import __all__ as _ops_all
from .ops import elementwise_binary_dispatch  # noqa: F401
from .generation import (BeamSearchDecoder, get_beam_hook,  # noqa: F401
                         register_beam_hook, attention_with_cache)

__all__ = ["data"] + list(_nn_all) + [
    "create_tensor", "create_global_var", "sums", "assign",
    "fill_constant", "fill_constant_batch_size_like", "ones", "zeros",
    "zeros_like", "reverse", "argmax", "argsort", "gather", "scatter",
    "shape", "range", "slice"] + list(_cf_all) + [
    "prior_box", "box_coder", "iou_similarity", "ssd_loss",
    "detection_output"] + [n for n in _ops_all if n not in _nn_all] + [
    "elementwise_binary_dispatch", "BeamSearchDecoder",
    "get_beam_hook", "register_beam_hook", "attention_with_cache"]
