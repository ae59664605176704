"""ParamAttr: per-parameter configuration (counterpart of
``paddle_tpu/param_attr.py``, without the v1 init spellings and weight
normalization)."""
from __future__ import annotations

from typing import Optional

from .initializer import Initializer


class ParamAttr:
    def __init__(self, name: Optional[str] = None,
                 initializer: Optional[Initializer] = None,
                 learning_rate: float = 1.0,
                 regularizer=None,
                 trainable: bool = True,
                 gradient_clip=None,
                 sharding=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        self.sharding = sharding

    @staticmethod
    def _to_attr(arg) -> "ParamAttr":
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        if isinstance(arg, bool):
            return ParamAttr() if arg else None
        raise TypeError(f"cannot convert {arg!r} to ParamAttr")

    def to_kwargs(self):
        return {
            "name": self.name,
            "optimize_attr": {"learning_rate": self.learning_rate},
            "regularizer": self.regularizer,
            "trainable": self.trainable,
            "gradient_clip_attr": self.gradient_clip,
            "sharding": self.sharding,
        }
