"""Scope: name -> tensor storage for persistable variables.

Counterpart of ``paddle_tpu/core/scope.py`` (without child scopes, which
no ported path creates).  Values are torch tensors on the executor's
device.  The interpreted step replaces them between runs and never
mutates one in place; a captured step (``Executor(use_jit=True)`` on a
card) points the scope at its static state buffers, which each replay
updates in place, as the JAX executor donates its state buffers.

``uid`` names the scope for the executor's memo of state keys, and
``keys_version`` advances whenever a name is added or dropped.
``layouts`` maps a var a sharded executor holds in pieces to its global
``shape``, this rank's ``index`` window ([[lo, hi], ...]) and whether
this rank ``writer``s the piece into a checkpoint
(``parallel/sharded.py``).
"""
from __future__ import annotations

import itertools
from typing import Dict

import numpy as np
import torch


def to_numpy(value) -> np.ndarray:
    """A tensor's values as a numpy array (bfloat16 widens to float32:
    numpy has no bfloat16).  A copy for a tensor on a card, or a widened
    bfloat16 one; for any other tensor on the CPU, a view of the
    tensor's own memory, which a later in-place write changes.  Copy it
    to keep a snapshot (the checkpoint writer copies explicitly)."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(value)


_uids = itertools.count()


class Scope:
    def __init__(self):
        self._vars: Dict[str, object] = {}
        self.uid = next(_uids)
        self.keys_version = 0
        self.layouts: Dict[str, dict] = {}

    def set(self, name: str, value):
        if name not in self._vars:
            self.keys_version += 1
        self._vars[name] = value

    def get(self, name: str):
        return self._vars[name]

    def has(self, name: str) -> bool:
        return name in self._vars

    def delete(self, name: str):
        """Drop ``name`` if the scope holds it."""
        self.layouts.pop(name, None)
        if self._vars.pop(name, None) is not None:
            self.keys_version += 1

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
