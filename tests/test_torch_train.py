"""Training in the port against the JAX package on the CPU: the program
that append_backward and the optimizers build (also through JSON), a
128-channel 1x1-conv program trained with the JAX Pallas route in
interpret mode, a reduced bottleneck ResNet trained in fp32 and under
AMP, ``run_steps`` against ``run``, and the regularizer and clip ops."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch.ops import conv1x1
from torch_parity import both_train, jax_state, reset_both


@pytest.fixture(autouse=True)
def _fresh():
    reset_both()
    yield


def _copy_scopes(m):
    """Fresh copies of the two scopes of a ``both_train`` result (JAX
    donates its state buffers, so each run needs its own)."""
    (_, _, js), (_, _, ts) = m["jax"], m["torch"]
    jsc = pt.core.Scope()
    for k in js.keys():
        jsc.set(k, jnp.array(js.numpy(k)))
    tsc = ptt.Scope()
    ptt.load_numpy_state(tsc, jax_state(js), "cpu")
    return jsc, tsc


def _train(m, feeds, steps, amp=False, jax_exe=None, torch_exe=None):
    """Train both sides ``steps`` steps from the same start; returns the
    per-step losses and the final scopes of both."""
    (jm, jl, _), (tm, tl, _) = m["jax"], m["torch"]
    jsc, tsc = _copy_scopes(m)
    je = jax_exe or pt.Executor(pt.CPUPlace(), amp=amp)
    te = torch_exe or ptt.Executor(ptt.CPUPlace(), amp=amp)
    jloss = [float(je.run(jm, feed=feeds, fetch_list=[jl], scope=jsc)[0])
             for _ in range(steps)]
    tloss = [float(te.run(tm, feed=feeds, fetch_list=[tl], scope=tsc)[0])
             for _ in range(steps)]
    return jloss, tloss, jsc, tsc


def _assert_scopes_close(jsc, tsc, names, rtol, atol_scale):
    """Each named var close, atol relative to the var's own scale."""
    for k in names:
        want, got = jsc.numpy(k), tsc.numpy(k)
        np.testing.assert_allclose(
            got, want, rtol=rtol,
            atol=atol_scale * max(np.abs(want).max(), 1e-6), err_msg=k)


def _feeds(n, shape, classes=10, seed=0):
    r = np.random.RandomState(seed)
    return {"img": r.randn(n, *shape).astype("float32"),
            "label": r.randint(0, classes, (n, 1))}


# ---------------------------------------------------------------------------
# the program: backward op, grad vars, optimizer ops, JSON
# ---------------------------------------------------------------------------
def test_training_program_matches_jax_and_survives_json():
    m = both_train("resnet_cifar", [3, 8, 8], depth=8)
    (jm, jl, _), (tm, tl, _) = m["jax"], m["torch"]
    assert tm.to_dict() == jm.to_dict()
    bw = [op for op in tm.global_block().ops if op.type == "backward"]
    assert len(bw) == 1 and bw[0].attrs["loss"] == tl.name
    params = bw[0].attrs["params"]
    assert params == [p.name for p in tm.all_parameters()]
    mom = [op for op in tm.global_block().ops if op.type == "momentum"]
    assert [op.input("Param")[0] for op in mom] == params
    assert [op.input("Grad")[0] for op in mom] == \
        [ptt.core.grad_var_name(p) for p in params]
    loaded = ptt.Program.from_json(jm.to_json())
    assert loaded.to_json() == jm.to_json()
    gb = loaded.global_block()
    for op in mom:
        v = op.input("Velocity")[0]
        assert gb.var(v).persistable and gb.has_var(op.input(
            "LearningRate")[0])
        assert gb.has_var(op.input("Grad")[0])
    for p in gb.all_parameters():
        # JSON keeps trainable; the optimizer attrs take their defaults,
        # as in the JAX package's own round trip
        assert p.trainable is True
        assert p.optimize_attr == {"learning_rate": 1.0}
        assert p.regularizer is None and p.gradient_clip_attr is None


def test_program_loaded_from_jax_json_trains_like_jax():
    m = both_train("resnet_cifar", [3, 8, 8], via_json=True, depth=8,
                   lr=0.01)
    jloss, tloss, jsc, tsc = _train(m, _feeds(16, (3, 8, 8)), 2)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    _assert_scopes_close(jsc, tsc, jsc.keys(), 1e-4, 1e-5)


def test_append_backward_declares_grads_and_respects_no_grad():
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = ptt.layers.data("x", [4])
        h = ptt.layers.fc(x, 3, param_attr=ptt.ParamAttr(name="w1"),
                          bias_attr=ptt.ParamAttr(name="b1"))
        loss = ptt.layers.mean(h)
        pairs = ptt.append_backward(loss, no_grad_set={"b1"})
    assert [(p.name, g.name) for p, g in pairs] == [("w1", "w1@GRAD")]
    gb = main.global_block()
    assert gb.var("w1@GRAD").shape == (4, 3)
    assert gb.ops[-1].type == "backward"
    main2 = ptt.Program()
    with ptt.program_guard(main2, ptt.Program()):
        x = ptt.layers.data("x", [4])
        h = ptt.layers.fc(x, 3, param_attr=ptt.ParamAttr(name="w2"))
        loss2 = ptt.layers.mean(h)
        grads = ptt.backward.calc_gradient(loss2, ["w2"])
    assert [g.name for g in grads] == ["w2@GRAD"]
    main2.global_block().append_op("lookup_table_sparse",
                                   inputs={"Rows": ["w2"]})
    with pytest.raises(NotImplementedError, match="sparse"):
        ptt.append_backward(loss2)


def test_fetching_a_gradient_matches_jax():
    """``<p>@GRAD`` vars are fetchable, as in the JAX package."""
    m = both_train("resnet_cifar", [3, 8, 8], depth=8)
    (jm, jl, _), (tm, tl, _) = m["jax"], m["torch"]
    jsc, tsc = _copy_scopes(m)
    feeds = _feeds(16, (3, 8, 8))
    name = "fc_0.w_0@GRAD"
    jg, = pt.Executor(pt.CPUPlace()).run(jm, feed=feeds, fetch_list=[name],
                                         scope=jsc)
    tg, = ptt.Executor(ptt.CPUPlace()).run(tm, feed=feeds,
                                           fetch_list=[name], scope=tsc)
    np.testing.assert_allclose(tg, jg, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# a 128-channel 1x1 conv through the kernel route on both sides
# ---------------------------------------------------------------------------
def _bn_conv_program(pkg):
    layers = pkg.layers
    img = layers.data("img", shape=[128, 8, 8], dtype="float32")
    label = layers.data("label", shape=[1], dtype="int64")
    h = layers.conv2d(img, 128, 1, bias_attr=False,
                      param_attr=pkg.ParamAttr(name="cw"), use_pallas=True)
    h = layers.batch_norm(h)
    h = layers.pool2d(h, pool_size=8, pool_type="avg")
    pred = layers.fc(h, size=10, act="softmax",
                     param_attr=pkg.ParamAttr(name="fw"))
    loss = layers.mean(layers.cross_entropy(pred, label))
    pkg.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(loss)
    return loss


def test_1x1_conv_program_matches_jax_pallas_route(monkeypatch):
    """The program of tests/test_pallas_conv.py:123-177 trained 3 Momentum
    steps: JAX through the Pallas kernel in interpret mode, the port
    through conv1x1.matmul (its plain version on the CPU).  A spy proves
    the port's forward and wgrad went through mm; the conv reads a feed,
    which needs no gradient, so autograd asks for no dgrad."""
    r = np.random.RandomState(4)
    feeds = {"img": r.rand(4, 128, 8, 8).astype("float32") * 0.1,
             "label": r.randint(0, 10, (4, 1))}
    out = {}
    for name, pkg in (("jax", pt), ("torch", ptt)):
        pkg.unique_name.reset()
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            loss = _bn_conv_program(pkg)
        if pkg is pt:
            for op in main.global_block().ops:
                if op.type == "conv2d":
                    op.attrs["pallas_interpret"] = True
        out[name] = (main, startup, loss)
    jm, js, jl = out["jax"]
    tm, _, tl = out["torch"]
    jsc = pt.core.Scope()
    pt.Executor(pt.CPUPlace()).run(js, scope=jsc)
    tsc = ptt.Scope()
    ptt.load_numpy_state(tsc, jax_state(jsc), "cpu")

    forms = []
    real = conv1x1.mm
    monkeypatch.setattr(conv1x1, "mm", lambda a, b, ta=False, tb=False,
                        **kw: (forms.append((ta, tb)),
                               real(a, b, ta, tb, **kw))[1])
    je = pt.Executor(pt.CPUPlace(), conv1x1_pallas=True)
    te = ptt.Executor(ptt.CPUPlace(), conv1x1_pallas=True)
    jloss = [float(je.run(jm, feed=feeds, fetch_list=[jl], scope=jsc)[0])
             for _ in range(3)]
    tloss = [float(te.run(tm, feed=feeds, fetch_list=[tl], scope=tsc)[0])
             for _ in range(3)]
    assert forms == [(False, True), (True, False)] * 3
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4, atol=1e-6)
    _assert_scopes_close(jsc, tsc, ["cw", "fw", "cw_velocity_0"], 1e-3,
                         1e-4)


# ---------------------------------------------------------------------------
# a reduced bottleneck ResNet, fp32 and AMP
# ---------------------------------------------------------------------------
def _bottleneck_net(pkg, img):
    """Stem, two bottleneck blocks (the second strided) and the fc head,
    from the packages' own models.resnet functions.  The blocks are 128
    wide so their 1x1 convs pass the kernel's gate; at 16x16 and batch 4
    every batch norm sees at least 64 values per channel."""
    R = pkg.models.resnet
    h = R.conv_bn_layer(img, 32, 3, 1, 1)
    h = R.bottleneck_block(h, 32, 32, 1)          # 1x1s 32->32, 32->128
    h = R.bottleneck_block(h, 128, 128, 2)        # 1x1s 128->128, ->512
    h = pkg.layers.pool2d(h, pool_type="avg", global_pooling=True)
    return pkg.layers.fc(h, size=10, act="softmax")


@pytest.fixture
def bottleneck(monkeypatch):
    for pkg in (pt, ptt):
        monkeypatch.setattr(pkg.models, "bottleneck_net",
                            lambda img, _p=pkg: _bottleneck_net(_p, img),
                            raising=False)
    return both_train("bottleneck_net", [3, 16, 16], lr=0.01)


def test_bottleneck_resnet_trains_like_jax_fp32(bottleneck):
    """fp32, 3 Momentum steps, the port's 1x1 convs on conv1x1.matmul and
    the JAX ones on XLA: only rounding differs.  One batch-norm output of
    this net lies within 1e-6 of 0, so its relu mask flips between two
    fp32 implementations (a float64 run of the port sides with JAX), and
    that element's gradient moves the grads of the layers below by up to
    10%.  So the losses are held at rtol 1e-4 and the parameters and BN
    statistics, which those grads move by lr x velocity, at rtol 1e-3
    and atol 3e-4 (0.2% of the stem's weights)."""
    before = conv1x1.launches()
    jloss, tloss, jsc, tsc = _train(bottleneck, _feeds(4, (3, 16, 16)), 3)
    assert conv1x1.launches() == before
    assert tloss[-1] < 0.7 * tloss[0]
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    for k in jsc.keys():
        if "velocity" not in k:
            np.testing.assert_allclose(tsc.numpy(k), jsc.numpy(k),
                                       rtol=1e-3, atol=3e-4, err_msg=k)


def test_bottleneck_resnet_trains_like_jax_amp(bottleneck):
    """bf16 AMP on both sides, 3 steps.  bf16 rounds at other places in
    the two frameworks and batch norm's backward magnifies that: the
    gradients of either side lie 10-30% (in norm) from the fp32 ones.  So
    the losses are held at 2e-2, and each parameter of the port's AMP run
    must lie no farther from the fp32 result (JAX) than twice the JAX AMP
    run's own distance from it.  The masters and the state stay fp32."""
    feeds = _feeds(4, (3, 16, 16))
    jloss, tloss, jsc, tsc = _train(bottleneck, feeds, 3, amp=True)
    np.testing.assert_allclose(tloss, jloss, rtol=2e-2)
    _, _, j32, _ = _train(bottleneck, feeds, 3)
    (tm, _, _) = bottleneck["torch"]
    for p in tm.all_parameters():
        ref = j32.numpy(p.name)
        d_port = np.linalg.norm(tsc.numpy(p.name) - ref)
        d_jax = np.linalg.norm(jsc.numpy(p.name) - ref)
        assert d_port <= 2 * d_jax + 1e-7, (p.name, d_port, d_jax)
    for k in tsc.keys():
        assert tsc.get(k).dtype == torch.float32, k


# ---------------------------------------------------------------------------
# run_steps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stacked", [False, True])
def test_run_steps_matches_run_and_jax(stacked):
    """K steps in one run_steps call equal K run calls in the port, and
    the JAX run_steps; fetches come back stacked on a leading K axis and
    the step counter advances by K."""
    m = both_train("resnet_cifar", [3, 8, 8], depth=8, lr=0.01)
    (jm, jl, _), (tm, tl, _) = m["jax"], m["torch"]
    K = 3
    per = [_feeds(8, (3, 8, 8), seed=s) for s in range(K)]
    feed = ptt.stack_feeds(per) if stacked else per[0]
    jsc, tsc = _copy_scopes(m)
    jout, = pt.Executor(pt.CPUPlace()).run_steps(
        K, jm, feed=feed, fetch_list=[jl], scope=jsc, feeds_stacked=stacked)
    exe = ptt.Executor(ptt.CPUPlace())
    tout, = exe.run_steps(K, tm, feed=feed, fetch_list=[tl], scope=tsc,
                          feeds_stacked=stacked)
    assert tout.shape == (K,) and exe._step == K
    np.testing.assert_allclose(tout, jout, rtol=1e-5)
    _, tsc2 = _copy_scopes(m)
    exe2 = ptt.Executor(ptt.CPUPlace())
    one = [float(exe2.run(tm, feed=per[i] if stacked else per[0],
                          fetch_list=[tl], scope=tsc2)[0])
           for i in range(K)]
    np.testing.assert_array_equal(tout, np.asarray(one, np.float32))
    for k in tsc.keys():
        np.testing.assert_array_equal(tsc.numpy(k), tsc2.numpy(k), err_msg=k)


def test_run_steps_checks_the_stacked_axis():
    m = both_train("resnet_cifar", [3, 8, 8], depth=8)
    (tm, tl, tsc) = m["torch"]
    with pytest.raises(ValueError, match="leading dim 2"):
        ptt.Executor(ptt.CPUPlace()).run_steps(
            2, tm, feed=_feeds(8, (3, 8, 8)), fetch_list=[tl], scope=tsc,
            feeds_stacked=True)
    with pytest.raises(ValueError, match="num_steps"):
        ptt.Executor(ptt.CPUPlace()).run_steps(0, tm, feed={}, scope=tsc)


# ---------------------------------------------------------------------------
# regularizers and clips
# ---------------------------------------------------------------------------
def _fc_net(pkg, clip, reg_kind):
    x = pkg.layers.data("x", [16])
    label = pkg.layers.data("label", [1], dtype="int64")
    reg = {"l1": pkg.regularizer.L1Decay(1e-2),
           "l2": pkg.regularizer.L2Decay(1e-2)}.get(reg_kind)
    h = pkg.layers.fc(x, 32, act="relu",
                      param_attr=pkg.ParamAttr(name="w0", regularizer=reg))
    pred = pkg.layers.fc(h, 10, act="softmax",
                         param_attr=pkg.ParamAttr(name="w1"))
    loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
    if clip == "global_norm":
        pkg.clip.set_gradient_clip(pkg.clip.GradientClipByGlobalNorm(0.05))
    elif clip == "value":
        pkg.clip.set_gradient_clip(pkg.clip.GradientClipByValue(0.01))
    elif clip == "norm":
        pkg.clip.set_gradient_clip(pkg.clip.GradientClipByNorm(0.02))
    opt = pkg.optimizer.SGD(learning_rate=0.5,
                            regularization=pkg.regularizer.L2Decay(1e-3)
                            if reg_kind == "global_l2" else None)
    opt.minimize(loss)
    return loss


@pytest.mark.parametrize("clip,reg", [
    ("global_norm", None), ("value", "l1"), ("norm", "l2"),
    (None, "global_l2")])
def test_clip_and_regularizer_programs_match_jax(clip, reg):
    r = np.random.RandomState(6)
    feeds = {"x": r.randn(8, 16).astype("float32"),
             "label": r.randint(0, 10, (8, 1))}
    built = {}
    for name, pkg in (("jax", pt), ("torch", ptt)):
        pkg.unique_name.reset()
        main, startup = pkg.Program(), pkg.Program()
        startup.random_seed = 3
        with pkg.program_guard(main, startup):
            loss = _fc_net(pkg, clip, reg)
        built[name] = (main, startup, loss)
    (jm, js, jl), (tm, _, tl) = built["jax"], built["torch"]
    assert tm.to_dict() == jm.to_dict()
    jsc = pt.core.Scope()
    pt.Executor(pt.CPUPlace()).run(js, scope=jsc)
    m = {"jax": (jm, jl, jsc), "torch": (tm, tl, None)}
    jloss, tloss, jsc2, tsc2 = _train(m, feeds, 2)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    _assert_scopes_close(jsc2, tsc2, ["w0", "w1"], 1e-5, 1e-6)
