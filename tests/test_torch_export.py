"""The port's deploy path on the CPU (paddle_tpu_torch/export_model.py,
Executor.as_module, the paddle_tpu_torch::conv2d_1x1 custom op,
serving.Model.from_artifact, benchmark/serving_common.py), mirroring
tests/test_export.py: a trained model exports as a torch.export artifact
with its weights inside, reloads with no Program and no Scope and gives
the framework's outputs, with a symbolic batch; a reduced ResNet whose
1x1 convs pass the kernel's gate holds the custom op and agrees with the
live program and with the JAX package's artifact of the same weights."""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch import export_model
from paddle_tpu_torch.benchmark import serving_common
from paddle_tpu_torch.ops import conv1x1
from torch_parity import jax_state, reset_both

CPU = ptt.CPUPlace()
# the port's artifact against the JAX package's (XLA on the CPU): fp32,
# another summation order
JAX_TOL = dict(rtol=1e-5, atol=1e-5)


def _train_small(rng):
    """fc 16 relu -> fc 4 softmax trained 3 SGD steps on the CPU."""
    reset_both()
    L = ptt.layers
    x = L.data("x", shape=[8], dtype="float32")
    lab = L.data("lab", shape=[1], dtype="int64")
    h = L.fc(x, size=16, act="relu")
    pred = L.fc(h, size=4, act="softmax")
    loss = L.mean(L.cross_entropy(pred, lab))
    ptt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe = ptt.Executor(CPU)
    exe.run(ptt.default_startup_program())
    feeds = {"x": rng.rand(16, 8).astype("float32"),
             "lab": rng.randint(0, 4, (16, 1))}
    for _ in range(3):
        exe.run(ptt.default_main_program(), feed=feeds, fetch_list=[loss])
    return exe, pred


def _fresh_world():
    ptt.core.reset_default_programs()
    ptt.core.reset_global_scope()


def test_export_roundtrip_matches_framework(tmp_path, rng):
    exe, pred = _train_small(rng)
    infer_prog = ptt.io.get_inference_program([pred])
    xv = rng.rand(4, 8).astype("float32")
    want, = exe.run(infer_prog, feed={"x": xv}, fetch_list=[pred],
                    is_test=True)
    manifest = ptt.export_compiled_model(
        str(tmp_path), {"x": ((4, 8), "float32")}, [pred], device="cpu")
    assert manifest["outputs"] == [pred.name]
    assert not manifest["symbolic_batch"]
    # a fresh world: the artifact alone carries the weights
    _fresh_world()
    run, m2 = ptt.load_compiled_model(str(tmp_path), device="cpu")
    got = run({"x": xv})[0]
    np.testing.assert_array_equal(got.numpy(), want)
    assert (tmp_path / "model.pt2").exists()
    assert m2["format"] == "torch.export" and m2["device"] == "cpu"
    assert m2["inputs"] == {"x": {"shape": [4, 8], "dtype": "float32"}}


def test_export_symbolic_batch(tmp_path, rng):
    """A -1 leading dim exports a symbolic batch: one artifact serves
    every batch size, 1 included (the trace ran at 2)."""
    exe, pred = _train_small(rng)
    infer_prog = ptt.io.get_inference_program([pred])
    outs = {}
    for b in (1, 2, 7):
        xv = rng.rand(b, 8).astype("float32")
        outs[b] = (xv, exe.run(infer_prog, feed={"x": xv},
                               fetch_list=[pred], is_test=True)[0])
    manifest = ptt.export_compiled_model(
        str(tmp_path), {"x": ((-1, 8), "float32")}, [pred], device="cpu")
    assert manifest["symbolic_batch"]
    assert manifest["inputs"]["x"]["shape"] == [None, 8]
    _fresh_world()
    run, _ = ptt.load_compiled_model(str(tmp_path), device="cpu")
    for b, (xv, want) in outs.items():
        got = run({"x": xv})[0]
        assert tuple(got.shape) == (b, 4)
        np.testing.assert_array_equal(got.numpy(), want)


def test_export_symbolic_batch_multi_input(tmp_path, rng):
    """Two dynamic-batch inputs share one symbolic batch."""
    reset_both()
    L = ptt.layers
    a = L.data("a", shape=[4], dtype="float32")
    b = L.data("b", shape=[4], dtype="float32")
    s = L.fc(L.concat([a, b], axis=1), size=3)
    ptt.Executor(CPU).run(ptt.default_startup_program())
    manifest = ptt.export_compiled_model(
        str(tmp_path), {"a": ((-1, 4), "float32"),
                        "b": ((None, 4), "float32")}, [s], device="cpu")
    assert manifest["symbolic_batch"]
    run, _ = ptt.load_compiled_model(str(tmp_path), device="cpu")
    for bs in (2, 5):
        out = run({"a": rng.rand(bs, 4).astype("float32"),
                   "b": rng.rand(bs, 4).astype("float32")})[0]
        assert tuple(out.shape) == (bs, 3)
    with pytest.raises(ValueError, match="missing"):
        run({"a": rng.rand(2, 4).astype("float32")})


def test_load_refuses_another_device(tmp_path, rng):
    _, pred = _train_small(rng)
    ptt.export_compiled_model(str(tmp_path), {"x": ((-1, 8), "float32")},
                              [pred], device="cpu")
    path = tmp_path / "manifest.json"
    manifest = json.loads(path.read_text())
    manifest["device"] = "cuda:0"
    path.write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="exported for cuda:0.*on cpu"):
        ptt.load_compiled_model(str(tmp_path), device="cpu")


def test_as_module_refuses_a_training_program(rng):
    exe, _ = _train_small(rng)
    with pytest.raises(ValueError, match="backward"):
        exe.as_module(ptt.default_main_program(), [])


# ---------------------------------------------------------------------------
# a reduced ResNet whose 1x1 convs pass the gate
# ---------------------------------------------------------------------------
def _resnet(pkg, img):
    """Stem, two bottleneck blocks (the second strided) and the head: four
    1x1 convs with C and M divisible by 128."""
    R = pkg.models.resnet
    h = R.conv_bn_layer(img, 32, 3, 1, 1)
    h = R.bottleneck_block(h, 32, 128, 1)           # 1x1s 32->128, 128->512
    h = R.bottleneck_block(h, 512, 128, 2)          # 1x1s 512->128, ->512
    h = pkg.layers.pool2d(h, pool_type="avg", global_pooling=True)
    return pkg.layers.fc(h, size=10, act="softmax")


def _build_resnet(pkg):
    pkg.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 3
    with pkg.program_guard(main, startup):
        img = pkg.layers.data("img", [3, 16, 16])
        pred = _resnet(pkg, img)
    return main.clone(for_test=True), startup, pred


@pytest.fixture
def resnet():
    reset_both()
    jm, js, jp = _build_resnet(pt)
    tm, _, tp = _build_resnet(ptt)
    jscope = pt.core.Scope()
    pt.Executor(pt.CPUPlace()).run(js, scope=jscope)
    tscope = ptt.Scope()
    ptt.load_numpy_state(tscope, jax_state(jscope), "cpu")
    return (jm, jp, jscope), (tm, tp, tscope)


def test_resnet_artifact_holds_the_custom_op(resnet, tmp_path):
    """The 1x1 convs that pass the static gate (1x1, C and M divisible
    by 128) are paddle_tpu_torch::conv2d_1x1 nodes of the graph; each
    call routes them by its own P: at batch 1 the strided block's maps
    (8 x 8 = 64 pixels) take F.conv2d, at batch 4 all of them the
    kernel's route (its plain version on the CPU)."""
    _, (tm, tp, tscope) = resnet
    gb = tm.global_block()
    static = [op for op in gb.ops if op.type == "conv2d"
              and conv1x1.conv1x1_static_gate(
                  gb.var(op.input("Input")[0]).shape[1],
                  gb.var(op.input("Filter")[0]).shape, op.attrs["paddings"],
                  op.attrs["dilations"], op.attrs["groups"])]
    manifest = export_model.export_compiled_model(
        str(tmp_path), {"img": ((-1, 3, 16, 16), "float32")}, [tp],
        main_program=tm, scope=tscope, device="cpu")
    assert manifest["custom_ops"] == {"paddle_tpu_torch::conv2d_1x1":
                                      len(static)}
    assert len(static) == 4
    run, _ = export_model.load_compiled_model(str(tmp_path), device="cpu")
    routes = {}
    for b in (1, 4):
        x = np.random.RandomState(b).rand(b, 3, 16, 16).astype("float32")
        conv1x1.reset_counts()
        run({"img": x})
        routes[b] = dict(conv1x1.routes)
    assert routes == {1: {"kernel": 2, "conv2d": 2}, 4: {"kernel": 4}}
    assert conv1x1.launches() == 0          # CPU: the plain version


def test_resnet_artifact_matches_live_program_and_jax(resnet, tmp_path):
    """At two batches the artifact gives the live port program's outputs
    bit for bit, and the JAX package's artifact of the same weights
    within JAX_TOL."""
    (jm, jp, jscope), (tm, tp, tscope) = resnet
    spec = {"img": ((-1, 3, 16, 16), "float32")}
    export_model.export_compiled_model(str(tmp_path / "port"), spec, [tp],
                                       main_program=tm, scope=tscope,
                                       device="cpu")
    pt.export_compiled_model(str(tmp_path / "jax"), spec, [jp],
                             main_program=jm, scope=jscope)
    _fresh_world()
    run, _ = ptt.load_compiled_model(str(tmp_path / "port"), device="cpu")
    jrun, _ = pt.load_compiled_model(str(tmp_path / "jax"))
    exe = ptt.Executor(CPU)
    for b in (1, 4):
        x = np.random.RandomState(10 + b).rand(b, 3, 16, 16).astype(
            "float32")
        got = run({"img": x})[0].numpy()
        live, = exe.run(tm, feed={"img": x}, fetch_list=[tp], scope=tscope,
                        is_test=True)
        np.testing.assert_array_equal(got, live)
        np.testing.assert_allclose(got, np.asarray(jrun({"img": x})[0]),
                                   **JAX_TOL)


def test_seq2seq_decoder_exports_with_a_symbolic_batch(tmp_path):
    """Beam-4 decoding exports with a symbolic batch (the beam search
    unrolled over max_len) and gives the live program's ids, scores and
    lens bit for bit at batch 1 and 3."""
    reset_both()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        src = ptt.layers.data("src", shape=[5], dtype="int64")
        outs = ptt.models.seq2seq_infer(src, 40, 40, emb_dim=8,
                                        hidden_dim=8, beam_size=4,
                                        max_len=4)
    scope = ptt.Scope()
    exe = ptt.Executor(CPU)
    exe.run(startup, scope=scope)
    manifest = ptt.export_compiled_model(
        str(tmp_path), {"src": ((-1, 5), "int64")}, list(outs),
        main_program=main, scope=scope, device="cpu")
    assert manifest["outputs"] == [o.name for o in outs]
    run, _ = ptt.load_compiled_model(str(tmp_path), device="cpu")
    for b in (1, 3):
        s = np.random.RandomState(b).randint(2, 40, (b, 5)).astype("int64")
        got = [t.numpy() for t in run({"src": s})]
        want = exe.run(main, feed={"src": s}, fetch_list=list(outs),
                       scope=scope, is_test=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the artifact behind the server; the benchmark's helpers
# ---------------------------------------------------------------------------
def test_model_from_artifact_behind_server(tmp_path):
    """Model.from_artifact serves the artifact through the port's Server:
    every response equals the direct call's row; a mis-shaped request is
    refused at admission."""
    from paddle_tpu_torch.serving import Model, Server
    d = serving_common.export_mlp(str(tmp_path), in_dim=12, hidden=(16,),
                                  classes=5, device="cpu")
    model = Model.from_artifact(d, device="cpu")
    assert model.name == tmp_path.name and model.example["x"].shape == (12,)
    run, manifest = serving_common.load_artifact(d, device="cpu")
    xs = np.random.RandomState(0).rand(6, 12).astype("float32")
    direct = run({"x": xs})[0].numpy()
    srv = Server(max_batch=4, max_wait_ms=20.0, deadline_ms=None)
    srv.add_model(model)
    srv.start()
    try:
        pending = [srv.submit({"x": x}) for x in xs]
        got = np.stack([p.result(timeout=60)[0] for p in pending])
        with pytest.raises(ValueError, match="does not match"):
            srv.submit({"x": xs[0][:5]})
    finally:
        srv.shutdown(drain=True, timeout=60)
    np.testing.assert_allclose(got, direct, rtol=1e-6, atol=1e-7)


def test_serving_common_helpers(tmp_path):
    manifest = {"inputs": {"x": {"shape": [None, 3], "dtype": "float32"},
                           "i": {"shape": [None, 2], "dtype": "int64"}}}
    rng = np.random.RandomState(0)
    feeds = serving_common.feeds_from_manifest(manifest, 5, rng)
    assert feeds["x"].shape == (5, 3) and feeds["i"].dtype == np.int64
    ex = serving_common.single_example(manifest, rng)
    assert ex["x"].shape == (3,) and ex["i"].shape == (2,)
    with pytest.raises(ValueError, match="fixed shape"):
        serving_common.single_example(
            {"inputs": {"x": {"shape": [4, 3], "dtype": "float32"}}}, rng)
    assert serving_common.percentile([], 0.5) is None
    assert serving_common.percentile([1, 2, 3, 4], 0.5) == 3


def test_closed_loop_counts_failed_checks(tmp_path):
    """A response that fails ``check`` ends its worker and is counted;
    the other worker goes on."""
    from paddle_tpu_torch.serving import Model, Server
    d = serving_common.export_mlp(str(tmp_path), in_dim=4, hidden=(8,),
                                  classes=3, device="cpu")
    srv = Server(max_batch=2, max_wait_ms=1.0, deadline_ms=None)
    srv.add_model(Model.from_artifact(d, device="cpu"))
    srv.start()

    failed = []

    def check(outs):
        assert len(outs) == 1 and outs[0].shape == (3,)
        if not failed:              # the first response checked is "wrong"
            failed.append(1)
            raise AssertionError("wrong")

    try:
        ex = {"x": np.full(4, 0.5, np.float32)}
        lat, row = serving_common.closed_loop(srv, ex, workers=2,
                                              duration_s=0.2)
        _, bad = serving_common.closed_loop(srv, ex, workers=2,
                                            duration_s=0.2, check=check)
    finally:
        srv.shutdown(drain=True, timeout=60)
    assert row["served"] > 0 and row["worker_errors"] == 0 and lat
    assert bad["served"] > 0 and bad["worker_errors"] == 1
    assert "wrong" in bad["first_error"]


def test_inference_benchmark_helpers_on_cpu(tmp_path):
    """benchmark.inference's pipelined timing runs any artifact's run (a
    CPU one here: no number of it is a device metric), its response check
    holds outputs to the direct call, and its main refuses to measure
    without a card."""
    from paddle_tpu_torch.benchmark import inference as binf
    d = serving_common.export_mlp(str(tmp_path), in_dim=6, hidden=(8,),
                                  classes=3, device="cpu")
    run, manifest = serving_common.load_artifact(d, device="cpu")
    feeds = serving_common.feeds_from_manifest(manifest, 4,
                                               np.random.RandomState(0))
    row = binf.time_pipelined(run, feeds, 4, windows=2, target_s=0.01)
    assert row["calls_per_window"] >= 10 and row["throughput_per_s"] > 0
    want = [o[0].numpy() for o in run(feeds)]
    check = binf.check_response(want)
    check([w.copy() for w in want])
    with pytest.raises(AssertionError, match="differs"):
        check([w + 1.0 for w in want])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA card"):
            binf.main(["resnet50", "--out", str(tmp_path / "r.json")])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_artifact_replays_a_graph_per_shape_on_card(cuda_device, tmp_path):
    """On a card each input shape's first call runs eagerly, the second
    captures a CUDA graph and later ones replay it, all bit-equal, and the
    1x1 route's launches count once a call."""
    reset_both()
    infer, startup, pred = _build_resnet(ptt)
    scope = ptt.Scope()
    ptt.Executor().run(startup, scope=scope)
    export_model.export_compiled_model(
        str(tmp_path), {"img": ((-1, 3, 16, 16), "float32")}, [pred],
        main_program=infer, scope=scope)
    run, _ = export_model.load_compiled_model(str(tmp_path))
    x = np.random.RandomState(0).rand(4, 3, 16, 16).astype("float32")
    conv1x1.reset_counts()
    outs = [run({"img": x})[0] for _ in range(4)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    assert conv1x1.launches() == 4 * 4
    assert run.graphs[(("img", (4, 3, 16, 16)),)].graph is not None
