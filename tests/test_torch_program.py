"""The port's Program IR against the JAX package's: the same layers build
the same program (``to_dict`` equal, names included), and a JAX
``to_json`` loads into the port and writes back byte-identically."""
import json

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from torch_parity import build, reset_both

MODELS = [("resnet50", [3, 224, 224], {}),
          ("resnet_cifar", [3, 32, 32], {"depth": 8})]


@pytest.fixture(autouse=True)
def _fresh():
    reset_both()
    yield


@pytest.mark.parametrize("model,shape,kw", MODELS,
                         ids=[m[0] for m in MODELS])
def test_program_to_dict_matches_jax(model, shape, kw):
    jm, js, jp = build(pt, model, shape, **kw)
    tm, ts, tp = build(ptt, model, shape, **kw)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    assert tp.name == jp.name
    # the serialized form is byte-identical too (key order included)
    assert tm.to_json() == jm.to_json()
    assert ts.to_json() == js.to_json()


@pytest.mark.parametrize("model,shape,kw", MODELS,
                         ids=[m[0] for m in MODELS])
def test_jax_json_round_trips_through_port(model, shape, kw):
    jm, js, _ = build(pt, model, shape, **kw)
    for prog in (jm, js):
        s = prog.to_json()
        assert ptt.Program.from_json(s).to_json() == s


def test_clone_for_test_matches_jax():
    jm, _, _ = build(pt, "resnet_cifar", [3, 32, 32], depth=8)
    tm, _, _ = build(ptt, "resnet_cifar", [3, 32, 32], depth=8)
    jc, tc = jm.clone(for_test=True), tm.clone(for_test=True)
    assert tc.to_dict() == jc.to_dict()
    bn = [op for op in tc.global_block().ops if op.type == "batch_norm"]
    assert bn and all(op.attrs["is_test"] for op in bn)
    # the original is untouched
    assert not any(op.attrs["is_test"] for op in tm.global_block().ops
                   if op.type == "batch_norm")


def test_parameters_and_persistables_match_jax():
    jm, _, _ = build(pt, "resnet50", [3, 224, 224])
    tm, _, _ = build(ptt, "resnet50", [3, 224, 224])
    jparams = [(p.name, p.shape, p.trainable) for p in jm.all_parameters()]
    tparams = [(p.name, p.shape, p.trainable) for p in tm.all_parameters()]
    assert tparams == jparams
    assert len(tparams) == 161          # 53 convs + 53 bn * 2 + fc w, b
    jpers = sorted(v.name for v in jm.list_vars() if v.persistable)
    tpers = sorted(v.name for v in tm.list_vars() if v.persistable)
    assert tpers == jpers


def test_ndarray_attrs_round_trip():
    prog = ptt.Program()
    blk = prog.global_block()
    blk.create_var(name="out", shape=[2, 2], dtype="float32")
    blk.append_op("assign_value", outputs={"Out": ["out"]},
                  attrs={"values": np.arange(4, dtype=np.int32).reshape(2, 2),
                         "dtype": "int32"})
    d = json.loads(prog.to_json())
    assert d["blocks"][0]["ops"][0]["attrs"]["values"] == {
        "__ndarray__": [[0, 1], [2, 3]], "dtype": "int32"}
    back = ptt.Program.from_json(prog.to_json())
    v = back.global_block().ops[0].attrs["values"]
    assert v.dtype == np.int32 and v.tolist() == [[0, 1], [2, 3]]
    # the JAX package reads the same form back
    assert pt.Program.from_json(prog.to_json()).to_json() == prog.to_json()


@pytest.mark.parametrize("spelling,name", [
    ("float32", "float32"), ("fp32", "float32"), ("bf16", "bfloat16"),
    ("bfloat16", "bfloat16"), ("int64", "int64"), (np.float32, "float32"),
    ("FP16", "float16")])
def test_dtype_names(spelling, name):
    import torch
    from paddle_tpu_torch.core.types import convert_dtype, to_torch_dtype
    assert convert_dtype(spelling) == name
    assert convert_dtype(to_torch_dtype(spelling)) == name
    assert to_torch_dtype(name) == getattr(torch, name)
    # the JAX package spells the same dtype by the same name
    assert pt.core.convert_dtype(spelling).name == name
