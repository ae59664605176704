"""Deterministic testing utilities: :mod:`paddle_tpu_torch.testing
.faultinject`, the fault-injection harness behind
``PADDLE_TPU_FAULT_SPEC``; :mod:`paddle_tpu_torch.testing.op_cases`,
the seeded operands of the op families;
:mod:`paddle_tpu_torch.testing.seq_oracles`, float64 recursions of the
sequence ops; :mod:`paddle_tpu_torch.testing.seq_programs`, the CRF
tagger and CTC head programs."""
from . import faultinject

__all__ = ["faultinject"]
