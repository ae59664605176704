"""Pass-through layers for unary ops (counterpart of
``paddle_tpu/layers/ops.py``, which generates one per op type; here only
those the ported paths use)."""
from __future__ import annotations

from .nn import _unary_layer

_UNARY_OPS = ["sqrt", "sign", "sigmoid", "tanh"]


def _make_unary(op_type):
    def layer(x, name=None, **attrs):
        return _unary_layer(op_type, x, attrs, name)
    layer.__name__ = op_type
    layer.__doc__ = f"{op_type} (pass-through layer)."
    return layer


sqrt = _make_unary("sqrt")
sign = _make_unary("sign")
sigmoid = _make_unary("sigmoid")
tanh = _make_unary("tanh")

__all__ = list(_UNARY_OPS)
