"""Data types and variable types.

Counterpart of ``paddle_tpu/core/types.py``.  Numpy has no bfloat16, so a
dtype travels through the IR as its canonical NAME (``"float32"``,
``"bfloat16"``, ...) and becomes a ``torch.dtype`` only where a tensor is
made (:func:`to_torch_dtype`).
"""
from __future__ import annotations

import enum

import numpy as np
import torch


class VarType(enum.Enum):
    """Variable kinds (the same values as the JAX package, so serialized
    programs read the same in both)."""

    LOD_TENSOR = "lod_tensor"
    SELECTED_ROWS = "selected_rows"
    FEED_MINIBATCH = "feed_minibatch"
    FETCH_LIST = "fetch_list"
    STEP_SCOPES = "step_scopes"
    LOD_RANK_TABLE = "lod_rank_table"
    LOD_TENSOR_ARRAY = "lod_tensor_array"
    RAW = "raw"


# accepted spellings -> canonical name
_DTYPE_ALIASES = {
    "bool": "bool",
    "int8": "int8",
    "uint8": "uint8",
    "int16": "int16",
    "int32": "int32",
    "int64": "int64",
    "float16": "float16",
    "bfloat16": "bfloat16",
    "float32": "float32",
    "float64": "float64",
    # reference spellings (framework.proto / fluid data_type.py)
    "fp16": "float16",
    "bf16": "bfloat16",
    "fp32": "float32",
    "fp64": "float64",
}

_TORCH_DTYPES = {
    "bool": torch.bool,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
}
_NAMES_BY_TORCH = {v: k for k, v in _TORCH_DTYPES.items()}


def convert_dtype(dtype) -> str:
    """Normalise any accepted dtype spelling (name, numpy dtype,
    ``torch.dtype``) to its canonical name."""
    if dtype is None:
        return "float32"
    if isinstance(dtype, torch.dtype):
        return _NAMES_BY_TORCH[dtype]
    if isinstance(dtype, str):
        key = dtype.lower()
        if key in _DTYPE_ALIASES:
            return _DTYPE_ALIASES[key]
        return np.dtype(key).name
    name = np.dtype(dtype).name
    return _DTYPE_ALIASES.get(name, name)


def to_torch_dtype(dtype) -> torch.dtype:
    return _TORCH_DTYPES[convert_dtype(dtype)]
