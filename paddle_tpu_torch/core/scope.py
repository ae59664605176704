"""Scope: name -> tensor storage for persistable variables.

Counterpart of ``paddle_tpu/core/scope.py`` (without child scopes, which
no ported path creates).  Values are torch tensors on the executor's
device; the executor replaces them between runs and never mutates one
in place.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def to_numpy(value) -> np.ndarray:
    """Host copy of a tensor (bfloat16 widens to float32: numpy has no
    bfloat16)."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(value)


class Scope:
    def __init__(self):
        self._vars: Dict[str, object] = {}

    def set(self, name: str, value):
        self._vars[name] = value

    def get(self, name: str):
        return self._vars[name]

    def has(self, name: str) -> bool:
        return name in self._vars

    def keys(self):
        return list(self._vars)

    def numpy(self, name: str) -> np.ndarray:
        return to_numpy(self.get(name))

    def __contains__(self, name):
        return self.has(name)

    def __len__(self):
        return len(self._vars)


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


def reset_global_scope():
    global _global_scope
    _global_scope = Scope()
