"""Carry weights across from the JAX package.

Both packages build the same program with the same ``unique_name``
counters, so a persistable's name is the same on both sides.  Take the
JAX scope's persistables as numpy arrays (``{name: scope.numpy(name)}``)
and load them here; the port then computes with the same weights.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .core.scope import Scope


def load_numpy_state(scope: Scope, arrays: Dict[str, np.ndarray],
                     device) -> Scope:
    """Fill ``scope`` with a tensor on ``device`` for every array.  A
    bfloat16 array (numpy has none of its own; JAX hands out ml_dtypes
    ones) arrives as a bfloat16 tensor.  Returns ``scope``."""
    device = torch.device(device)
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr, order="C"))   # own copy
        scope.set(name, t.to(device))
    return scope
