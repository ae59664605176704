"""Deterministic testing utilities of the training runtime:
:mod:`paddle_tpu_torch.testing.faultinject`, the fault-injection harness
behind ``PADDLE_TPU_FAULT_SPEC``."""
from . import faultinject

__all__ = ["faultinject"]
