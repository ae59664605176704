"""Parameter initializers, realized as ops in the startup program
(counterpart of ``paddle_tpu/initializer.py``: the same op types and
attrs, so both packages emit the same startup program)."""
from __future__ import annotations

import math

from .core.program import Block, Variable


class Initializer:
    def __call__(self, var: Variable, block: Block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, var, block):
        block.append_op("fill_constant", outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape),
                               "dtype": var.dtype,
                               "value": float(self.value)})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op("uniform_random", outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape),
                               "dtype": var.dtype,
                               "min": float(self.low),
                               "max": float(self.high),
                               "seed": self.seed})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op("gaussian_random", outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape),
                               "dtype": var.dtype,
                               "mean": float(self.loc),
                               "std": float(self.scale),
                               "seed": self.seed})


def _fan_in_out(var):
    shape = var.shape
    if len(shape) < 2:
        return (shape[0] if shape else 1,) * 2
    receptive = 1
    for s in shape[2:]:
        receptive *= s
    # conv weights are [out, in, kh, kw]; fc weights are [in, out]
    if len(shape) == 2:
        return shape[0], shape[1]
    return shape[1] * receptive, shape[0] * receptive


class XavierInitializer(Initializer):
    """Glorot (fluid initializer.py XavierInitializer)."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = \
            uniform, fan_in, fan_out, seed

    def __call__(self, var, block):
        fi, fo = _fan_in_out(var)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / (fi + fo))
            NormalInitializer(0.0, std, self.seed)(var, block)


# fluid-style aliases
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
