"""The core of the v1 config DSL in the port
(``paddle_tpu_torch/trainer_config_helpers``) against the JAX package's
on the CPU: the elastic runner's config (its text and data the JAX
runner's), a narrow ResNet in the reference's
``benchmark/paddle/image/resnet.py`` layout (``chip_smoke.resnet_v1_conf``
with two bottleneck blocks at 32 x 32: the layout ``[elastic]`` trains
at full width) and an LSTM text classifier, each loaded by both
packages' ``load_v1_config``:

* the same op types in the same order, and the same parameter names;
* the forward within 1e-5 with the JAX startup's weights carried into
  the port (``weights.load_numpy_state``);
* a name of the DSL's submodules raises naming ROADMAP item 10,
  ``img_conv_layer(trans=True)`` item 4, and the ``paddle`` import shim
  is put back after a config ran.
"""
import importlib.util
import os
import sys

import numpy as np
import pytest

import paddle_tpu_torch as ptt
from paddle_tpu_torch.trainer_config_helpers import load_v1_config

from torch_parity import jax_state, reset_both

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ptt.CPUPlace()
TOL = dict(rtol=1e-5, atol=1e-5)

LSTM_CONF = """
settings(batch_size=4, learning_rate=0.01, learning_method=AdamOptimizer())
word = data_layer('word', 50)
emb = embedding_layer(input=word, size=16)
lstm = simple_lstm(input=emb, size=8)
last = last_seq(input=lstm)
out = fc_layer(input=last, size=3, act=SoftmaxActivation())
label = data_layer('label', 3)
outputs(classification_cost(input=out, label=label))
"""


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _conf(tmp_path, what):
    if what == "runner":
        from paddle_tpu_torch.benchmark.elastic import CONF
        text = CONF
    elif what == "resnet":
        text = _chip_smoke().resnet_v1_conf(
            blocks=(2,), widths=(16,), img=32, classes=10, stem=16, batch=4)
    else:
        text = LSTM_CONF
    path = tmp_path / f"{what}.py"
    path.write_text(text)
    return str(path)


def _rows(what, n=4, seed=0):
    rng = np.random.RandomState(seed)
    if what == "runner":
        return [(rng.rand(32).astype("float32"),
                 np.array([rng.randint(5)], "int64")) for _ in range(n)]
    if what == "resnet":
        return [(rng.rand(3 * 32 * 32).astype("float32"),
                 np.array([rng.randint(10)], "int64")) for _ in range(n)]
    return [(list(rng.randint(0, 50, size=rng.randint(2, 7))),
             np.array([rng.randint(3)], "int64")) for _ in range(n)]


def test_runner_config_and_data_are_the_jax_runners():
    import benchmark.elastic as jdrv
    from paddle_tpu_torch.benchmark import elastic as tdrv
    assert tdrv.CONF == jdrv.CONF
    assert (tdrv.FULL["workers"], tdrv.FULL["shrink_to"],
            tdrv.FULL["chunks"], tdrv.FULL["recs"]) == (8, 4, 96, 64)


def test_runner_data_maker_is_the_jax_runners(tmp_path):
    import pickle
    import benchmark.elastic as jdrv
    from paddle_tpu_torch.benchmark import elastic as tdrv
    jdrv._make_data(str(tmp_path / "j"), 3, 5)
    tdrv.make_data(str(tmp_path / "t"), 3, 5)
    for i in range(3):
        name = f"part-{i:03d}.pickle"
        with open(tmp_path / "j" / name, "rb") as f:
            a = pickle.load(f)
        with open(tmp_path / "t" / name, "rb") as f:
            b = pickle.load(f)
        assert len(a) == len(b) == 5
        for (x1, y1), (x2, y2) in zip(a, b):
            assert x1.tobytes() == x2.tobytes() and y1.tobytes() == \
                y2.tobytes()


@pytest.mark.parametrize("what", ["runner", "resnet", "lstm"])
def test_both_loaders_build_the_same_program_and_forward(tmp_path, what):
    import paddle_tpu as pt
    from paddle_tpu.trainer_config_helpers import load_v1_config as jload
    path = _conf(tmp_path, what)
    reset_both()
    j = jload(path)
    t = load_v1_config(path)
    jops = [op.type for op in j.main_program.global_block().ops]
    tops = [op.type for op in t.main_program.global_block().ops]
    assert tops == jops
    assert [op.type for op in t.startup_program.global_block().ops] == \
        [op.type for op in j.startup_program.global_block().ops]
    jparams = sorted(p.name for p in j.main_program.global_block()
                     .all_parameters())
    assert sorted(p.name for p in t.main_program.global_block()
                  .all_parameters()) == jparams
    assert list(t.data_layers) == list(j.data_layers)
    assert t.settings["batch_size"] == j.settings["batch_size"]
    assert type(t.make_optimizer()).__name__ == \
        type(j.make_optimizer()).__name__
    if what == "resnet":
        assert tops.count("conv2d") == jops.count("conv2d") == 8
        assert "elementwise_add" in tops and "batch_norm" in tops

    jscope = pt.Scope()
    pt.Executor().run(j.startup_program, scope=jscope)
    tscope = ptt.Scope()
    ptt.load_numpy_state(tscope, jax_state(jscope), "cpu")
    rows = _rows(what)
    jfeed = pt.DataFeeder(list(j.data_layers.values())).feed(rows)
    tfeed = ptt.DataFeeder(list(t.data_layers.values())).feed(rows)
    out_j = j.outputs[0].name
    got = ptt.Executor(CPU).run(t.main_program, feed=tfeed,
                                fetch_list=[t.outputs[0].name],
                                scope=tscope)[0]
    want = pt.Executor().run(j.main_program, feed=jfeed,
                             fetch_list=[out_j], scope=jscope)[0]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)
    assert np.isfinite(np.asarray(got)).all()


@pytest.mark.parametrize("name", ["lstmemory_group", "layer_math",
                                  "mixed_layer", "nce_layer"])
def test_submodule_names_raise_naming_item_10(tmp_path, name):
    path = tmp_path / "c.py"
    path.write_text("x = data_layer('x', 8)\n"
                    "def f(v):\n"
                    f"    return {name}\n"
                    "y = f(x)\n")
    with pytest.raises(NotImplementedError, match="item 10"):
        load_v1_config(str(path))
    path.write_text("from paddle.trainer_config_helpers import " + name)
    with pytest.raises(NotImplementedError, match="item 10"):
        load_v1_config(str(path))


def test_unknown_name_is_a_name_error_and_trans_conv_names_item_4(tmp_path):
    path = tmp_path / "c.py"
    path.write_text("x = no_such_layer_anywhere\n")
    with pytest.raises(NameError):
        load_v1_config(str(path))
    path.write_text("x = data_layer('x', 3 * 8 * 8)\n"
                    "y = img_conv_layer(input=x, num_channels=3, "
                    "filter_size=3, num_filters=4, trans=True)\n")
    with pytest.raises(NotImplementedError, match="item 4"):
        load_v1_config(str(path))


def test_star_import_config_runs_and_the_shim_is_put_back(tmp_path):
    """A reference config that imports the DSL by its ``paddle`` name
    runs against the port's DSL, and whatever ``paddle`` was before is
    back afterwards (the JAX package's loader keeps its own)."""
    import paddle_tpu_torch.trainer_config_helpers as tch
    path = tmp_path / "c.py"
    path.write_text("from paddle.trainer_config_helpers import *\n"
                    "import paddle.trainer_config_helpers as h\n"
                    "assert h.__name__ == " + repr(tch.__name__) + "\n"
                    + LSTM_CONF)
    before = {k: sys.modules.get(k)
              for k in ("paddle", "paddle.trainer_config_helpers")}
    cfg = load_v1_config(str(path))
    assert [op.type for op in cfg.main_program.global_block().ops]
    assert {k: sys.modules.get(k) for k in before} == before
