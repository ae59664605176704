"""The model zoo of ``benchmark/run.py --all`` in the port against the JAX
package on the CPU: each model built by both packages (the same program,
op for op), started from the JAX startup scope, and trained 2-3 steps
with dropout's ``dropout_prob`` set to 0 in both programs; one inception
block whose two 256 -> 128 1x1 convolutions take the JAX Pallas kernel in
interpret mode and the port's ``conv1x1.mm``; the ``nets`` helpers; and
the port's runner (``paddle_tpu_torch.benchmark.run``) at tiny sizes on
the CPU for every HEADLINE config.

Tolerances, stated per model: losses ``rtol=1e-4`` and each parameter's
update within ``UPDATE_TOL`` of the JAX update's norm, where the models
have no batch norm (a few fp32 ulps of difference in the sums grow
through 3 steps to at most 3e-3 of an update, measured: vgg19).
``vgg_cifar`` has batch norm at random init, which magnifies rounding
(ROADMAP Queue C): the forward loss across packages at ``rtol=1e-5``,
one step's updates across packages within 5e-2 of their norm (2.6%
measured at batch 8), and the port's 3-step trajectory against its own
float64 run, the exact witness, at ``rtol=1e-4``.  The biases of
convolutions followed by batch norm have a zero gradient in exact
arithmetic, so only rounding moves them: they are left out of update
comparisons.
"""
import importlib

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch.benchmark import run as zoo_run
from paddle_tpu_torch.ops import conv1x1
from torch_parity import build_train, jax_state, reset_both

UPDATE_TOL = 1e-2


@pytest.fixture(autouse=True)
def _fresh():
    reset_both()
    yield


def _no_dropout(*programs):
    for prog in programs:
        for op in prog.global_block().ops:
            if op.type == "dropout":
                op.attrs["dropout_prob"] = 0.0


def _start(js):
    """(JAX scope after the startup, its numpy state, a port scope with
    that state)."""
    jscope = pt.core.Scope()
    pt.Executor(pt.CPUPlace()).run(js, scope=jscope)
    state = jax_state(jscope)
    tscope = ptt.Scope()
    ptt.load_numpy_state(tscope, state, "cpu")
    return jscope, state, tscope


def _img_feed(batch, shape, classes=10, seed=0):
    r = np.random.RandomState(seed)
    return {"img": r.rand(batch, *shape).astype("float32"),
            "label": r.randint(0, classes, (batch, 1)).astype("int64")}


def _updates_close(tm, state, jscope, tscope, tol, skip_pre_bn=False):
    for p in tm.all_parameters():
        n = p.name
        if skip_pre_bn and n.startswith("conv2d") and n.endswith(".b_0"):
            continue
        ju = jscope.numpy(n) - state[n]
        tu = tscope.numpy(n) - state[n]
        scale = max(np.linalg.norm(ju), 1e-30)
        assert np.linalg.norm(tu - ju) / scale <= tol, n


def _train_both(jm, jl, tm, tl, jscope, tscope, feed, steps, amp=False):
    je = pt.Executor(pt.CPUPlace(), amp=amp)
    te = ptt.Executor(ptt.CPUPlace(), amp=amp)
    jloss = [float(je.run(jm, feed=feed, fetch_list=[jl], scope=jscope)[0])
             for _ in range(steps)]
    tloss = [float(te.run(tm, feed=feed, fetch_list=[tl], scope=tscope)[0])
             for _ in range(steps)]
    return jloss, tloss


IMAGE_MODELS = [  # (model, per-example shape, kwargs, batch)
    ("mnist_mlp", (784,), {}, 4),
    ("mnist_lenet", (1, 28, 28), {}, 4),
    ("alexnet", (3, 67, 67), {"num_classes": 10}, 4),
    ("vgg19", (3, 32, 32), {"num_classes": 10}, 4),
]


@pytest.mark.parametrize("model,shape,kwargs,batch", IMAGE_MODELS,
                         ids=[m[0] for m in IMAGE_MODELS])
def test_image_model_trains_like_jax(model, shape, kwargs, batch):
    """3 Momentum steps of the model without batch norm: the same ops,
    losses at rtol 1e-4, updates within UPDATE_TOL of the JAX update."""
    jm, js, _, jl = build_train(pt, model, shape, **kwargs)
    tm, _, _, tl = build_train(ptt, model, shape, **kwargs)
    assert [o.type for o in jm.global_block().ops] == \
        [o.type for o in tm.global_block().ops]
    _no_dropout(jm, tm)
    jscope, state, tscope = _start(js)
    jloss, tloss = _train_both(jm, jl, tm, tl, jscope, tscope,
                               _img_feed(batch, shape), 3)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    assert tloss[-1] < tloss[0]
    _updates_close(tm, state, jscope, tscope, UPDATE_TOL)


def test_vgg_cifar_matches_jax_and_its_float64_run():
    """vgg_cifar (batch norm, img_conv_group): one step across packages
    (forward loss at rtol 1e-5, updates within 5e-2 of their norm), and
    three steps of the port against its own float64 run at rtol 1e-4."""
    shape, lr = (3, 32, 32), 1e-3
    jm, js, _, jl = build_train(pt, "vgg_cifar", shape, lr=lr)
    tm, _, _, tl = build_train(ptt, "vgg_cifar", shape, lr=lr)
    assert [o.type for o in jm.global_block().ops] == \
        [o.type for o in tm.global_block().ops]
    _no_dropout(jm, tm)
    jscope, state, tscope = _start(js)
    feed = _img_feed(8, shape)
    jloss, tloss = _train_both(jm, jl, tm, tl, jscope, tscope, feed, 1)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    _updates_close(tm, state, jscope, tscope, 5e-2, skip_pre_bn=True)

    te = ptt.Executor(ptt.CPUPlace())
    tm64 = tm.clone()
    tm64.global_block().var("img").dtype = "float64"
    t32, t64 = ptt.Scope(), ptt.Scope()
    ptt.load_numpy_state(t32, state, "cpu")
    ptt.load_numpy_state(t64, {k: v.astype(np.float64)
                               if v.dtype == np.float32 else v
                               for k, v in state.items()}, "cpu")
    l32 = [float(te.run(tm, feed=feed, fetch_list=[tl], scope=t32)[0])
           for _ in range(3)]
    l64 = [float(te.run(tm64, feed=feed, fetch_list=[tl], scope=t64)[0])
           for _ in range(3)]
    np.testing.assert_allclose(l32, l64, rtol=1e-4)


def test_googlenet_trains_like_jax():
    """The whole GoogLeNet (9 inception blocks, main head) at 64x64 and
    batch 2, 2 Momentum steps: losses at rtol 1e-4, updates within
    UPDATE_TOL (its 1x1 convs are below the kernel's gate here)."""
    shape = (3, 64, 64)
    jm, js, _, jl = build_train(pt, "googlenet", shape, num_classes=10)
    tm, _, _, tl = build_train(ptt, "googlenet", shape, num_classes=10)
    assert [o.type for o in jm.global_block().ops] == \
        [o.type for o in tm.global_block().ops]
    _no_dropout(jm, tm)
    jscope, state, tscope = _start(js)
    jloss, tloss = _train_both(jm, jl, tm, tl, jscope, tscope,
                               _img_feed(2, shape), 2)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    _updates_close(tm, state, jscope, tscope, UPDATE_TOL)


def _inception_program(pkg, lr=0.05):
    """One inception block on a 256-channel 8x8 input at batch 2 (P =
    128): its c1 and c3r 1x1 convs (256 -> 128) pass the kernel's gate,
    c5r (256 -> 32) and proj (256 -> 64) do not; global average pool,
    an fc head, Momentum."""
    pkg.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        img = pkg.layers.data("img", [256, 8, 8])
        label = pkg.layers.data("label", [1], dtype="int64")
        inception = importlib.import_module(
            pkg.__name__ + ".models.googlenet").inception
        h = inception(img, 128, 128, 192, 32, 96, 64)
        h = pkg.layers.pool2d(h, pool_type="avg", global_pooling=True)
        pred = pkg.layers.fc(h, size=10, act="softmax")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
        pkg.optimizer.Momentum(learning_rate=lr, momentum=0.9).minimize(loss)
    return main, startup, loss


def test_inception_block_on_the_kernel_matches_jax_pallas(monkeypatch):
    """3 steps of the inception block: the JAX side through the Pallas
    1x1 kernel in interpret mode, the port through ``conv1x1.mm`` (its
    plain version on the CPU) for exactly the two eligible convs (a spy
    counts the forward, dgrad and wgrad products); losses at rtol 1e-4,
    updates within UPDATE_TOL."""
    jm, js, jl = _inception_program(pt)
    tm, _, tl = _inception_program(ptt)
    for op in jm.global_block().ops:
        if op.type == "conv2d":
            op.attrs["pallas_interpret"] = True
    jscope, state, tscope = _start(js)
    forms = []
    real = conv1x1.mm
    monkeypatch.setattr(conv1x1, "mm", lambda a, b, ta=False, tb=False,
                        **kw: (forms.append((ta, tb)),
                               real(a, b, ta, tb, **kw))[1])
    r = np.random.RandomState(2)
    feed = {"img": r.rand(2, 256, 8, 8).astype("float32"),
            "label": r.randint(0, 10, (2, 1)).astype("int64")}
    je = pt.Executor(pt.CPUPlace(), conv1x1_pallas=True)
    te = ptt.Executor(ptt.CPUPlace(), conv1x1_pallas=True)
    jloss = [float(je.run(jm, feed=feed, fetch_list=[jl], scope=jscope)[0])
             for _ in range(3)]
    tloss = [float(te.run(tm, feed=feed, fetch_list=[tl], scope=tscope)[0])
             for _ in range(3)]
    # per step: two forwards, then the two wgrads (the input is a feed:
    # no dgrad), in either order
    assert sorted(forms) == sorted([(False, True)] * 6 + [(True, False)] * 6)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    _updates_close(tm, state, jscope, tscope, UPDATE_TOL)


def _lstm_program(pkg, stacked=False):
    """lstm_text_classification (vocab 50, hidden 16, 2 layers), or the
    book's stacked_lstm_net (3 LSTMs of alternating direction, 16
    wide), with Adam."""
    pkg.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        words = pkg.layers.data("words", shape=[], dtype="int64",
                                lod_level=1)
        label = pkg.layers.data("label", [1], dtype="int64")
        if stacked:
            module = importlib.import_module(
                pkg.__name__ + ".models.lstm_textcls")
            pred = module.stacked_lstm_net(words, 50, emb_dim=8,
                                           hidden_dim=16, stacked_num=3)
        else:
            pred = pkg.models.lstm_text_classification(
                words, vocab_size=50, emb_dim=8, hidden_size=16,
                lstm_num=2)
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
        pkg.optimizer.Adam(2e-3).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("amp,stacked", [(False, False), (True, False),
                                         (False, True)],
                         ids=["fp32", "amp", "stacked-fp32"])
def test_lstm_text_classification_trains_like_jax(amp, stacked):
    """Two stacked LSTMs (peepholes on, as dynamic_lstm's default) over
    ragged rows, the last valid step, Adam, 3 steps (and the book's
    stacked_lstm_net: reversed LSTMs, sequence concat, max pooling):
    fp32 losses at rtol 1e-4 and updates within UPDATE_TOL; under AMP
    the losses at 2e-2 (bf16) and, in both packages, no weight moves
    (bf16(0.999) = 1.0)."""
    jm, js, jl = _lstm_program(pt, stacked)
    tm, _, tl = _lstm_program(ptt, stacked)
    assert [o.type for o in jm.global_block().ops] == \
        [o.type for o in tm.global_block().ops]
    jscope, state, tscope = _start(js)
    r = np.random.RandomState(5)
    feed = {"words": r.randint(0, 50, (6, 9)).astype("int64"),
            "words@LEN": np.array([9, 1, 4, 9, 6, 2], np.int32),
            "label": r.randint(0, 2, (6, 1)).astype("int64")}
    jloss, tloss = _train_both(jm, jl, tm, tl, jscope, tscope, feed, 3,
                               amp=amp)
    if not amp:
        np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
        _updates_close(tm, state, jscope, tscope, UPDATE_TOL)
        return
    np.testing.assert_allclose(tloss, jloss, rtol=2e-2)
    for p in tm.all_parameters():
        np.testing.assert_array_equal(tscope.numpy(p.name), state[p.name])
        np.testing.assert_array_equal(jscope.numpy(p.name), state[p.name])


def _nets_program(pkg, which):
    pkg.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    L = pkg.layers
    with pkg.program_guard(main, startup):
        label = L.data("label", [1], dtype="int64")
        if which == "sequence_conv_pool":
            seq = L.data("seq", shape=[6], dtype="float32", lod_level=1)
            h = pkg.nets.sequence_conv_pool(seq, num_filters=8,
                                            filter_size=3)
        elif which == "glu":
            # glu's halves carry no static shape (in the JAX layer too),
            # so the loss reads them without an fc
            x = L.data("x", [12])
            loss = L.mean(pkg.nets.glu(L.fc(x, 16), dim=-1))
            pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
            return main, startup, loss
        else:
            img = L.data("img", [3, 9, 9])
            h = pkg.nets.img_conv_group(
                img, conv_num_filter=[4, 6], pool_size=2, pool_stride=2,
                conv_act="relu", conv_with_batchnorm=[True, False],
                conv_batchnorm_drop_rate=[0.5, 0.0], pool_ceil_mode=True)
        pred = L.fc(h, size=3, act="softmax")
        loss = L.mean(L.cross_entropy(pred, label))
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("which", ["sequence_conv_pool", "glu",
                                   "img_conv_group"])
def test_nets_helpers_match_jax(which):
    """Each nets helper in a small training program (img_conv_group with
    per-conv batch norm and dropout and a ceil-mode pool over 9x9): the
    same ops, 2 SGD steps' losses at rtol 1e-4 and updates within
    UPDATE_TOL."""
    jm, js, jl = _nets_program(pt, which)
    tm, _, tl = _nets_program(ptt, which)
    assert [o.type for o in jm.global_block().ops] == \
        [o.type for o in tm.global_block().ops]
    _no_dropout(jm, tm)
    jscope, state, tscope = _start(js)
    r = np.random.RandomState(7)
    feed = {"label": r.randint(0, 3, (4, 1)).astype("int64")}
    if which == "sequence_conv_pool":
        feed["seq"] = r.randn(4, 5, 6).astype("float32")
        feed["seq@LEN"] = np.array([5, 2, 4, 1], np.int32)
    elif which == "glu":
        feed["x"] = r.randn(4, 12).astype("float32")
    else:
        feed["img"] = r.rand(4, 3, 9, 9).astype("float32")
    jloss, tloss = _train_both(jm, jl, tm, tl, jscope, tscope, feed, 2)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    _updates_close(tm, state, jscope, tscope, UPDATE_TOL, skip_pre_bn=True)


def test_zoo_names_match_the_jax_package():
    """models exports every one of the JAX package's names (seq2seq_infer
    with beam_search since the deploy slice); nets all of its helpers."""
    assert set(ptt.models.__all__) == set(pt.models.__all__)
    assert set(ptt.nets.__all__) == set(pt.nets.__all__)
    for name in ptt.models.__all__:
        assert callable(getattr(ptt.models, name))


TINY = {"alexnet": {"size": 67, "num_classes": 10},
        "googlenet": {"size": 64, "num_classes": 10},
        "smallnet": {},
        "resnet50": {"size": 64, "num_classes": 10},
        "vgg19": {"size": 32, "num_classes": 10},
        "lstm_h512": {"hidden": 8, "seq_len": 5, "vocab": 50, "emb": 8},
        "seq2seq": {"src_len": 4, "tgt_len": 4, "vocab": 50, "dim": 8}}


@pytest.mark.parametrize("name,batch", zoo_run.HEADLINE,
                         ids=[f"{n}-{b}" for n, b in zoo_run.HEADLINE])
def test_runner_runs_every_headline_config_on_the_cpu(name, batch):
    """run_config(device="cpu") at tiny sizes and batch 2: a finite row
    with the JAX runner's keys, its unit, and the upstream figure of the
    HEADLINE batch with its source."""
    row = zoo_run.run_config(name, 2, iters=2, reps=1, device="cpu",
                             sizes=TINY[name], quiet=True)
    for key in ("model", "batch", "ms_per_batch", "throughput", "unit",
                "ref", "amp", "speedup", "window_spread", "ref_source"):
        assert key in row
    assert row["device"] == "cpu" and row["amp"] is True
    assert np.isfinite(row["throughput"]) and row["throughput"] > 0
    assert row["unit"] == {"lstm_h512": "samples/s",
                           "seq2seq": "tokens/s"}.get(name, "img/s")
    units = batch * 60 if name == "seq2seq" else batch
    ref, source = zoo_run.reference(name, batch, units)
    if name == "seq2seq":
        assert ref is None and source is None
    else:
        assert ref > 0
        assert ("K40m" in source) == (name not in ("resnet50", "vgg19"))


def test_runner_delegates_and_refusals(monkeypatch):
    """--model input_pipeline runs the port's wide_deep A/B (smoke, on the
    CPU); --model compile_cache (refused until the disk layer was
    ported) reaches the port's compile-cache A/B with the runner's
    --smoke and --device; no delegate of the JAX runner is refused."""
    assert zoo_run.main(["--model", "input_pipeline", "--smoke",
                         "--device", "cpu"]) == 0
    from paddle_tpu_torch.benchmark import compile_cache as cc_bench
    got = []
    monkeypatch.setattr(cc_bench, "main", lambda argv=None: got.append(argv))
    assert zoo_run.main(["--model", "compile_cache", "--smoke",
                         "--device", "cpu"]) == 0
    assert got == [["--smoke", "--device", "cpu"]]
    assert not hasattr(zoo_run, "NOT_PORTED")


def test_runner_reference_figures():
    assert zoo_run.reference("alexnet", 128, 128)[0] == \
        pytest.approx(128 / 0.334)
    assert zoo_run.reference("vgg19", 64, 64)[0] == 28.46
    assert zoo_run.reference("lstm_h512", 128, 128)[0] == \
        pytest.approx(128 / 0.261)
    assert zoo_run.reference("alexnet", 7, 7) == (None, None)
