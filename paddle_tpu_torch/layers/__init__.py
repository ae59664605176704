"""Layer API (counterpart of ``paddle_tpu/layers``): the layers the
ResNet serving path builds."""

from .io import data  # noqa: F401
from .nn import batch_norm, conv2d, elementwise_add, fc, pool2d  # noqa: F401

__all__ = ["data", "fc", "conv2d", "pool2d", "batch_norm", "elementwise_add"]
