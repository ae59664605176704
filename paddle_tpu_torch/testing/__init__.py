"""Deterministic testing utilities: :mod:`paddle_tpu_torch.testing
.faultinject`, the fault-injection harness behind
``PADDLE_TPU_FAULT_SPEC``, and :mod:`paddle_tpu_torch.testing.op_cases`,
the seeded operands of the tensor and math ops."""
from . import faultinject

__all__ = ["faultinject"]
