"""The port's live registries against the JAX package's, after both
packages are imported: every op name the JAX package registers but the
``backward`` pseudo-op (which the port's executor runs itself) is the
port's, with a shape rule or an allowlist entry and a shard rule exactly
where the JAX registry has one; every public callable of
``paddle_tpu.layers`` is in ``paddle_tpu_torch.layers``."""
import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.analysis import shape_infer as jsi
from paddle_tpu.core import registry as jreg
from paddle_tpu_torch.analysis import shape_infer as tsi
from paddle_tpu_torch.core import registry as treg


def _public_callables(module):
    return {n for n in dir(module)
            if not n.startswith("_") and callable(getattr(module, n))}


def test_every_op_name_but_backward_is_registered():
    jops, tops = set(jreg.registered_ops()), set(treg.registered_ops())
    assert len(jops) == 240
    assert tops == jops - {"backward"}


def test_rules_are_registered_exactly_where_the_references_are():
    tops = set(treg.registered_ops())
    shape = set(treg.registered_shape_fns())
    assert shape == set(jreg.registered_shape_fns()) - {"backward"}
    assert tsi.SHAPE_INFER_ALLOWLIST == \
        jsi.SHAPE_INFER_ALLOWLIST - {"backward"}
    assert tops == shape | tsi.SHAPE_INFER_ALLOWLIST
    assert set(treg.registered_shard_fns()) == \
        set(jreg.registered_shard_fns()) - {"backward"}


def test_every_public_layer_is_ported():
    jl, tl = _public_callables(pt.layers), _public_callables(ptt.layers)
    assert len(jl) == 181
    assert jl <= tl, sorted(jl - tl)
