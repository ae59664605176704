"""The port's model persistence (paddle_tpu_torch/io.py) against the JAX
package's (paddle_tpu/io.py): the same on-disk format, ``__model__`` JSON
and one ``<name>.npy`` per var, so an inference directory either package
saved loads and runs in the other."""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from torch_parity import jax_state, reset_both

CPU = ptt.CPUPlace()
# the same weights through two fp32 implementations of fc and batch norm
TOL = dict(rtol=1e-5, atol=1e-6)


def _net(pkg):
    """conv -> batch norm -> relu -> pool -> fc softmax, with a
    ``/``-free and a dotted parameter name."""
    L = pkg.layers
    img = L.data("img", shape=[3, 8, 8], dtype="float32")
    h = L.conv2d(img, num_filters=4, filter_size=3, padding=1)
    h = L.batch_norm(h, act="relu")
    h = L.pool2d(h, pool_type="avg", global_pooling=True)
    return L.fc(h, size=5, act="softmax")


def _startup(pkg, exe_place):
    pkg.default_startup_program().random_seed = 7
    pkg.Executor(exe_place).run(pkg.default_startup_program())


def _x(b=3):
    return np.random.RandomState(b).rand(b, 3, 8, 8).astype("float32")


def test_jax_saved_inference_model_runs_in_the_port(tmp_path):
    reset_both()
    pred = _net(pt)
    _startup(pt, pt.CPUPlace())
    jexe = pt.Executor(pt.CPUPlace())
    pt.io.save_inference_model(str(tmp_path), ["img"], [pred], jexe)
    want, = jexe.run(pt.default_main_program().clone(for_test=True),
                     feed={"img": _x()}, fetch_list=[pred], is_test=True)
    assert os.path.exists(tmp_path / "__model__")
    scope = ptt.Scope()
    exe = ptt.Executor(CPU)
    prog, feeds, fetches = ptt.io.load_inference_model(str(tmp_path), exe,
                                                       scope=scope)
    assert feeds == ["img"] and [v.name for v in fetches] == [pred.name]
    got, = exe.run(prog, feed={"img": _x()}, fetch_list=fetches,
                   scope=scope, is_test=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_port_saved_inference_model_runs_in_jax(tmp_path):
    reset_both()
    pred = _net(ptt)
    _startup(ptt, CPU)
    exe = ptt.Executor(CPU)
    ptt.save_inference_model(str(tmp_path), ["img"], [pred], exe)
    want, = exe.run(ptt.default_main_program().clone(for_test=True),
                    feed={"img": _x()}, fetch_list=[pred], is_test=True)
    jscope = pt.core.Scope()
    jexe = pt.Executor(pt.CPUPlace())
    prog, feeds, fetches = pt.io.load_inference_model(str(tmp_path), jexe,
                                                      scope=jscope)
    got, = jexe.run(prog, feed={"img": _x()}, fetch_list=fetches,
                    scope=jscope, is_test=True)
    np.testing.assert_allclose(np.asarray(got), want, **TOL)
    # the files are the JAX package's: one .npy per persistable
    saved = sorted(f[:-4] for f in os.listdir(tmp_path) if f.endswith(".npy"))
    persist = sorted(v.name for v in ptt.default_main_program().list_vars()
                     if v.persistable and ptt.global_scope().has(v.name))
    assert saved == persist


def test_params_and_persistables_round_trip(tmp_path):
    """save_params writes the parameters only, save_persistables the
    batch-norm statistics too; loading them into a fresh scope restores
    each value bit for bit, on the executor's device."""
    reset_both()
    _net(ptt)
    _startup(ptt, CPU)
    main = ptt.default_main_program()
    src = ptt.global_scope()
    params = {p.name for p in main.all_parameters()}
    ptt.io.save_params(None, str(tmp_path / "p"), main)
    ptt.io.save_persistables(None, str(tmp_path / "s"), main)
    assert {f[:-4] for f in os.listdir(tmp_path / "p")} == params
    persist = {f[:-4] for f in os.listdir(tmp_path / "s")}
    assert params < persist
    exe = ptt.Executor(CPU)
    for sub, load in (("p", ptt.io.load_params),
                      ("s", ptt.io.load_persistables)):
        scope = ptt.Scope()
        load(exe, str(tmp_path / sub), main, scope=scope)
        assert set(scope.keys()) == (params if sub == "p" else persist)
        for k in scope.keys():
            assert scope.get(k).device == torch.device("cpu")
            assert torch.equal(scope.get(k), src.get(k)), k


def test_inference_program_is_pruned():
    reset_both()
    L = ptt.layers
    x = L.data("x", shape=[4], dtype="float32")
    a = L.fc(x, size=3)
    L.fc(x, size=2)                         # a branch the target never reads
    prog = ptt.io.get_inference_program(a)
    kinds = [op.type for op in prog.global_block().ops]
    assert kinds.count("mul") == 1


def test_loading_without_an_executor_needs_the_card(tmp_path):
    """The entry point runs on the card unless the caller passes an
    executor on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    reset_both()
    pred = _net(ptt)
    _startup(ptt, CPU)
    ptt.save_inference_model(str(tmp_path), ["img"], [pred],
                             ptt.Executor(CPU))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptt.io.load_inference_model(str(tmp_path))


def test_jax_weights_carry_into_a_port_program_saved_by_jax(tmp_path):
    """The JAX package's saved persistables load into the port's own
    build of the same program (names match), giving JAX's outputs."""
    reset_both()
    pred = _net(pt)
    _startup(pt, pt.CPUPlace())
    jexe = pt.Executor(pt.CPUPlace())
    pt.io.save_persistables(jexe, str(tmp_path), pt.default_main_program())
    want, = jexe.run(pt.default_main_program().clone(for_test=True),
                     feed={"img": _x(2)}, fetch_list=[pred], is_test=True)
    ptt.unique_name.reset()
    tpred = _net(ptt)
    scope = ptt.Scope()
    exe = ptt.Executor(CPU)
    ptt.load_persistables(exe, str(tmp_path), ptt.default_main_program(),
                          scope=scope)
    assert set(scope.keys()) == set(jax_state(pt.global_scope()))
    got, = exe.run(ptt.default_main_program().clone(for_test=True),
                   feed={"img": _x(2)}, fetch_list=[tpred], scope=scope,
                   is_test=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
