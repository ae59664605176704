"""Pass-through layers for unary ops (counterpart of
``paddle_tpu/layers/ops.py``, which generates one per op type; here only
those the ported paths use), and the dispatch behind a Variable's
arithmetic operators."""
from __future__ import annotations

from .nn import _unary_layer

_UNARY_OPS = ["sqrt", "square", "sign", "sigmoid", "tanh", "exp", "log",
              "floor", "ceil", "reciprocal", "pow"]


def _make_unary(op_type):
    def layer(x, name=None, **attrs):
        return _unary_layer(op_type, x, attrs, name)
    layer.__name__ = op_type
    layer.__doc__ = f"{op_type} (pass-through layer)."
    return layer


sqrt = _make_unary("sqrt")
square = _make_unary("square")
sign = _make_unary("sign")
sigmoid = _make_unary("sigmoid")
tanh = _make_unary("tanh")
exp = _make_unary("exp")
log = _make_unary("log")
floor = _make_unary("floor")
ceil = _make_unary("ceil")
reciprocal = _make_unary("reciprocal")
pow = _make_unary("pow")

__all__ = list(_UNARY_OPS)


def elementwise_binary_dispatch(op, a, b):
    """``Variable`` +, -, *, / with a scalar or another ``Variable``
    (``paddle_tpu/layers/ops.py:39``): two Variables make the
    elementwise op, a scalar operand a ``scale`` (or ``reciprocal`` and
    ``scale`` for ``scalar / var``)."""
    from ..core.program import Variable
    from . import nn
    if isinstance(a, Variable) and isinstance(b, Variable):
        return getattr(nn, op)(a, b)
    if isinstance(a, Variable):
        s = float(b)
        if op == "elementwise_add":
            return nn.scale(a, 1.0, s)
        if op == "elementwise_sub":
            return nn.scale(a, 1.0, -s)
        if op == "elementwise_mul":
            return nn.scale(a, s, 0.0)
        if op == "elementwise_div":
            return nn.scale(a, 1.0 / s, 0.0)
        if op == "elementwise_pow":
            return pow(a, factor=s)
    else:
        s = float(a)
        if op == "elementwise_add":
            return nn.scale(b, 1.0, s)
        if op == "elementwise_sub":          # s - b
            return nn.scale(b, -1.0, s)
        if op == "elementwise_mul":
            return nn.scale(b, s, 0.0)
        if op == "elementwise_div":          # s / b
            return nn.scale(reciprocal(b), s, 0.0)
    raise TypeError(f"unsupported operands for {op}: {a!r}, {b!r}")
