"""Each op of the ResNet serving path in the port against its JAX lowering,
on the same numpy-seeded inputs (fp32 unless stated; the JAX tests pin
matmul precision to "highest", so both sides compute in full fp32)."""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.core.registry import get_op_impl as jax_impl
from paddle_tpu_torch.core.registry import get_op_impl as torch_impl
from paddle_tpu_torch.ops import conv1x1

R = np.random.RandomState(5)
TOL = dict(rtol=1e-4, atol=1e-5)


def _run(op, ins, attrs, is_test=True, conv1x1_pallas=None):
    """Run ``op`` through both packages; returns ({slot: np} jax,
    {slot: np} torch)."""
    jctx = pt.core.LoweringContext(pt.Program(), jax.random.PRNGKey(0),
                                   is_test=is_test,
                                   conv1x1_pallas=conv1x1_pallas)
    jout = jax_impl(op)(jctx, {k: [jax.numpy.asarray(v) for v in vs]
                               for k, vs in ins.items()}, dict(attrs))
    tctx = ptt.core.ExecContext(ptt.Program(), torch.device("cpu"), 0,
                                is_test=is_test,
                                conv1x1_pallas=conv1x1_pallas)
    tout = torch_impl(op)(tctx, {k: [torch.from_numpy(np.array(v))
                                     for v in vs]
                                 for k, vs in ins.items()}, dict(attrs))
    return ({k: np.asarray(v) for k, v in jout.items()},
            {k: v.float().numpy() for k, v in tout.items()})


def _x(*shape):
    return R.randn(*shape).astype("float32")


CONVS = {
    "3x3_s1": ((2, 16, 12, 12), (32, 16, 3, 3), [1, 1], [1, 1]),
    "3x3_s2": ((2, 16, 12, 12), (32, 16, 3, 3), [2, 2], [1, 1]),
    "7x7_s2_stem": ((2, 3, 32, 32), (64, 3, 7, 7), [2, 2], [3, 3]),
    "1x1_s1_64ch": ((2, 64, 8, 8), (256, 64, 1, 1), [1, 1], [0, 0]),
    "1x1_s2": ((2, 64, 8, 8), (128, 64, 1, 1), [2, 2], [0, 0]),
}


@pytest.mark.parametrize("name", sorted(CONVS))
def test_conv2d_matches_jax(name):
    xs, ws, st, pd = CONVS[name]
    x, w = _x(*xs), _x(*ws) / np.float32(np.sqrt(np.prod(ws[1:])))
    attrs = {"strides": st, "paddings": pd, "dilations": [1, 1],
             "groups": 1}
    j, t = _run("conv2d", {"Input": [x], "Filter": [w]}, attrs)
    np.testing.assert_allclose(t["Output"], j["Output"], **TOL)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_1x1_router_matches_jax_pallas(stride):
    """An eligible 1x1 conv with the routing on: the JAX side runs its
    Pallas kernel (interpret mode), the port its conv1x1 wrapper, which
    on CPU tensors computes the plain version (no kernel launch)."""
    x, w = _x(2, 128, 16, 16), _x(256, 128, 1, 1) / np.float32(np.sqrt(128))
    attrs = {"strides": [stride, stride], "paddings": [0, 0],
             "dilations": [1, 1], "groups": 1, "use_pallas": True,
             "pallas_interpret": True}
    before = conv1x1.launches()
    j, t = _run("conv2d", {"Input": [x], "Filter": [w]}, attrs)
    assert conv1x1.launches() == before
    np.testing.assert_allclose(t["Output"], j["Output"], **TOL)


def test_conv2d_router_tristate(monkeypatch):
    """Per-op attr > executor setting > flag, as in the JAX package."""
    from paddle_tpu_torch.ops import nn_ops
    calls = []
    real = conv1x1.conv2d_1x1
    monkeypatch.setattr(conv1x1, "conv2d_1x1",
                        lambda *a: calls.append(1) or real(*a))
    x, w = torch.randn(1, 128, 16, 8), torch.randn(128, 128, 1, 1)
    base = {"strides": [1, 1], "paddings": [0, 0], "dilations": [1, 1],
            "groups": 1}

    def run(attrs, exe_opt):
        ctx = ptt.core.ExecContext(ptt.Program(), torch.device("cpu"), 0,
                                   conv1x1_pallas=exe_opt)
        nn_ops._conv2d(ctx, {"Input": [x], "Filter": [w]}, attrs)
        return len(calls)

    assert ptt.flags.get_flag("conv1x1_pallas") is True
    assert run(base, None) == 1                   # flag default: on
    assert run(base, False) == 1                  # executor off
    assert run(dict(base, use_pallas=True), False) == 2   # attr wins
    assert run(dict(base, use_pallas=False), True) == 2
    ptt.flags.set_flag("conv1x1_pallas", False)
    try:
        assert run(base, None) == 2
        assert run(base, True) == 3
    finally:
        ptt.flags.set_flag("conv1x1_pallas", True)


@pytest.mark.parametrize("attrs", [
    {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
     "paddings": [1, 1], "global_pooling": False},
    {"pooling_type": "avg", "ksize": [1, 1], "strides": [1, 1],
     "paddings": [0, 0], "global_pooling": True},
    {"pooling_type": "max", "ksize": [1, 1], "strides": [1, 1],
     "paddings": [0, 0], "global_pooling": True},
    {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
     "paddings": [1, 1], "global_pooling": False, "exclusive": True},
    {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
     "paddings": [1, 1], "global_pooling": False, "exclusive": False},
], ids=["max3s2p1", "global_avg", "global_max", "avg_excl", "avg_incl"])
def test_pool2d_matches_jax(attrs):
    j, t = _run("pool2d", {"X": [_x(2, 8, 9, 9)]}, attrs)
    np.testing.assert_allclose(t["Out"], j["Out"], **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_test_mode_matches_jax(dtype):
    c = 16
    ins = {"X": [_x(2, c, 5, 5)], "Scale": [_x(c)], "Bias": [_x(c)],
           "Mean": [_x(c)], "Variance": [R.rand(c).astype("float32") + 0.5]}
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "is_test": True,
             "use_global_stats": None}
    if dtype == "bfloat16":
        # x in bf16, stats fp32: the folded scale/shift applies in bf16
        import jax.numpy as jnp
        jctx = pt.core.LoweringContext(pt.Program(), jax.random.PRNGKey(0),
                                       is_test=True)
        jins = {k: [jnp.asarray(v[0])] for k, v in ins.items()}
        jins["X"] = [jins["X"][0].astype(jnp.bfloat16)]
        jy = np.asarray(jax_impl("batch_norm")(jctx, jins, attrs)["Y"]
                        .astype(jnp.float32))
        tctx = ptt.core.ExecContext(ptt.Program(), torch.device("cpu"), 0,
                                    is_test=True)
        tins = {k: [torch.from_numpy(v[0])] for k, v in ins.items()}
        tins["X"] = [tins["X"][0].bfloat16()]
        ty = torch_impl("batch_norm")(tctx, tins, attrs)["Y"]
        assert ty.dtype == torch.bfloat16
        np.testing.assert_allclose(ty.float().numpy(), jy, rtol=2e-2,
                                   atol=2e-2)
        return
    j, t = _run("batch_norm", ins, attrs)
    for slot in ("Y", "MeanOut", "VarianceOut", "SavedMean",
                 "SavedVariance"):
        np.testing.assert_allclose(t[slot], j[slot], **TOL)


def test_batch_norm_training_not_ported_yet():
    """Batch statistics are ported now (tests/test_torch_train_ops.py
    holds them against JAX): on a constant input a training pass
    normalizes to the bias and advances the running averages."""
    c = 4
    ins = {k: [torch.ones(c)] for k in ("Scale", "Bias", "Mean",
                                        "Variance")}
    ins["X"] = [torch.ones(2, c, 3, 3)]
    ctx = ptt.core.ExecContext(ptt.Program(), torch.device("cpu"), 0,
                               is_test=False)
    out = torch_impl("batch_norm")(ctx, ins, {"is_test": False,
                                              "momentum": 0.9})
    np.testing.assert_allclose(out["Y"].numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(out["MeanOut"].numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(out["VarianceOut"].numpy(), 0.9, atol=1e-6)


def test_relu_matches_jax():
    j, t = _run("relu", {"X": [_x(3, 7)]}, {})
    np.testing.assert_allclose(t["Out"], j["Out"], **TOL)


@pytest.mark.parametrize("yshape,axis", [((2, 8, 4, 4), -1), ((8,), 1),
                                         ((4, 4), 2)])
def test_elementwise_add_matches_jax(yshape, axis):
    j, t = _run("elementwise_add", {"X": [_x(2, 8, 4, 4)],
                                    "Y": [_x(*yshape)]}, {"axis": axis})
    np.testing.assert_allclose(t["Out"], j["Out"], **TOL)


@pytest.mark.parametrize("xshape,xn", [((4, 8, 1, 1), 1), ((4, 6), 1),
                                       ((2, 3, 6), 2)])
def test_mul_matches_jax(xshape, xn):
    k = int(np.prod(xshape[xn:]))
    j, t = _run("mul", {"X": [_x(*xshape)], "Y": [_x(k, 5)]},
                {"x_num_col_dims": xn, "y_num_col_dims": 1})
    np.testing.assert_allclose(t["Out"], j["Out"], **TOL)


@pytest.mark.parametrize("axis", [-1, 0])
def test_softmax_matches_jax(axis):
    j, t = _run("softmax", {"X": [_x(4, 10) * 3]}, {"axis": axis})
    np.testing.assert_allclose(t["Out"], j["Out"], **TOL)


def test_fill_constant_matches_jax():
    attrs = {"shape": [3, 2], "dtype": "float32", "value": 1.5}
    j, t = _run("fill_constant", {}, attrs)
    np.testing.assert_array_equal(t["Out"], j["Out"])


@pytest.mark.parametrize("op,attrs", [
    ("uniform_random", {"shape": [200, 100], "dtype": "float32",
                        "min": -0.5, "max": 0.25, "seed": 0}),
    ("gaussian_random", {"shape": [200, 100], "dtype": "float32",
                         "mean": 0.5, "std": 2.0, "seed": 3}),
])
def test_random_init_distributions_match_jax(op, attrs):
    """Different generators, the same distribution: range, mean and
    spread agree with the JAX draw within sampling error (20k draws)."""
    j, t = _run(op, {}, attrs)
    a, b = j["Out"], t["Out"]
    assert a.shape == b.shape == (200, 100)
    if op == "uniform_random":
        assert b.min() >= attrs["min"] and b.max() <= attrs["max"]
    # 6 standard errors of the mean and of the std (n = 20000)
    se = a.std() / np.sqrt(a.size)
    assert abs(b.mean() - a.mean()) < 6 * np.sqrt(2) * se
    assert abs(b.std() - a.std()) < 6 * a.std() / np.sqrt(a.size)


def test_random_ops_are_reproducible_and_vary_per_op():
    prog = ptt.Program()
    prog.random_seed = 7
    blk = prog.global_block()
    for n in ("a", "b"):
        blk.create_var(name=n, shape=[64], dtype="float32", persistable=True)
        blk.append_op("uniform_random", outputs={"Out": [n]},
                      attrs={"shape": [64], "dtype": "float32", "min": -1.0,
                             "max": 1.0, "seed": 0})
    exe = ptt.Executor(ptt.CPUPlace())
    s1, s2 = ptt.Scope(), ptt.Scope()
    exe.run(prog, scope=s1)
    ptt.Executor(ptt.CPUPlace()).run(prog, scope=s2)
    np.testing.assert_array_equal(s1.numpy("a"), s2.numpy("a"))
    assert not np.array_equal(s1.numpy("a"), s1.numpy("b"))


def _dropout_program(seed, n_ops=2):
    """x -> dropout -> dropout (training); returns (program, the masks)."""
    ptt.unique_name.reset()
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = seed
    with ptt.program_guard(main, startup):
        h = ptt.layers.data("x", [32])
        for _ in range(n_ops):
            h = ptt.layers.dropout(h, dropout_prob=0.5)
    return main, [op.output("Mask")[0] for op in main.global_block().ops]


def test_dropout_masks_repeat_per_seed_step_and_op():
    """A mask is a function of (program seed, step, op): run_steps(3) and
    three run()s on a second executor draw the same masks; they differ
    from step to step, from op to op, and under another seed."""
    feed = {"x": np.ones((16, 32), np.float32)}
    main, masks = _dropout_program(3)
    a = ptt.Executor(ptt.CPUPlace()).run_steps(3, main, feed=feed,
                                               fetch_list=masks,
                                               scope=ptt.Scope())
    exe = ptt.Executor(ptt.CPUPlace())
    b = [exe.run(main, feed=feed, fetch_list=masks, scope=ptt.Scope())
         for _ in range(3)]
    for i in range(3):
        for j in range(2):
            np.testing.assert_array_equal(a[j][i], b[i][j])
    draws = [a[j][i].tobytes() for i in range(3) for j in range(2)]
    assert len(set(draws)) == 6
    assert all(0.3 < a[j][i].mean() < 0.7 for i in range(3)
               for j in range(2))
    other, omasks = _dropout_program(4)
    c = ptt.Executor(ptt.CPUPlace()).run_steps(3, other, feed=feed,
                                               fetch_list=omasks,
                                               scope=ptt.Scope())
    assert not set(draws) & {c[j][i].tobytes() for i in range(3)
                             for j in range(2)}


def test_a_random_op_in_a_sub_block_draws_anew_each_call():
    """An op that runs several times within one step (here: twice, by
    hand, through one ExecContext) draws on from its stream, and a new
    context at the same step draws the same two draws again."""
    main, _ = _dropout_program(5, n_ops=1)
    op = main.global_block().ops[0]

    def two_draws(step):
        ctx = ptt.core.ExecContext(main, torch.device("cpu"), step)
        env = ptt.core.Env(main.global_block())
        env.local["x"] = torch.ones(8, 32)
        out = []
        for _ in range(2):
            ptt.core.run_op(op, env, ctx)
            out.append(env.get(op.output("Mask")[0]).clone())
        return out

    first, again, later = two_draws(7), two_draws(7), two_draws(8)
    assert not torch.equal(first[0], first[1])
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    assert not any(torch.equal(x, y) for x, y in zip(first, later))


def test_run_op_names_the_failing_op():
    prog = ptt.Program()
    blk = prog.global_block()
    for n in ("x", "y", "out"):
        blk.create_var(name=n, dtype="float32")
    blk.append_op("elementwise_add", inputs={"X": ["x"], "Y": ["y"]},
                  outputs={"Out": ["out"]}, attrs={"axis": -1})
    exe = ptt.Executor(ptt.CPUPlace())
    with pytest.raises(RuntimeError) as ei:
        exe.run(prog, feed={"x": np.ones((2, 3), "float32"),
                            "y": np.ones((4, 5), "float32")},
                fetch_list=["out"], scope=ptt.Scope())
    notes = "".join(getattr(ei.value, "__notes__", []))
    assert "elementwise_add" in notes and "(2, 3)" in notes


def test_unregistered_op_raises_with_its_name():
    # (lookup_table_sparse, the op this test named first, is registered
    # since the sparse tables were ported, nce since the embedding family
    # was, moe since the moe family was; tensor_array_to_tensor is in
    # neither package's registry)
    with pytest.raises(NotImplementedError, match="tensor_array_to_tensor"):
        torch_impl("tensor_array_to_tensor")
