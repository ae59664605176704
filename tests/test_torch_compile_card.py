"""``Executor.compile`` on the card: a compiled key's first run replays
with no warm-up and no capture, and equals an uncompiled executor's run
bit for bit; the compile leaves the scope as it was; a worker thread
that never warmed the key up replays it; a warm compile (the key's entry
on disk) hits the entry, learns what the cold one learned and equals the
cold arm; the flash-attention forward's custom op launches K2 and
agrees with its plain version.

Every test needs a CUDA card (``cuda`` marker); none imports JAX, so on
the card they run with ``python3 -m pytest --noconftest -m cuda
tests/test_torch_compile_card.py``."""
import threading

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch import flags
from paddle_tpu_torch.core import compile_cache
from paddle_tpu_torch.ops import conv1x1, flash_attention as fa


@pytest.fixture
def card():
    """The card with TF32 off and cuDNN's deterministic algorithms (the
    interpreted fp32 convolution backward is not bit-repeatable without
    them: tests/test_torch_cuda_graph.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    compile_cache.stats().reset()
    yield torch.device("cuda", 0)
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = saved


def _bottleneck(seed=0):
    """A 1x1-conv bottleneck (128 channels, 8x8, batch 2: P = 128, on K1)
    with batch norm and dropout, mean cross entropy, Momentum."""
    ptt.unique_name.reset()
    main, startup = ptt.Program(), ptt.Program()
    startup.random_seed = seed
    L = ptt.layers
    with ptt.program_guard(main, startup):
        img = L.data("img", [128, 8, 8])
        label = L.data("label", [1], dtype="int64")
        h = L.conv2d(img, 128, 1, act=None, bias_attr=False)
        h = L.batch_norm(h, act="relu")
        h = L.conv2d(h, 128, 1, act="relu", bias_attr=False)
        h = L.dropout(L.pool2d(h, pool_type="avg", global_pooling=True),
                      dropout_prob=0.3)
        pred = L.fc(h, size=10, act="softmax")
        loss = L.mean(L.cross_entropy(pred, label))
        ptt.optimizer.Momentum(learning_rate=0.05,
                               momentum=0.9).minimize(loss)
    rng = np.random.RandomState(seed)
    feed = {"img": rng.rand(2, 128, 8, 8).astype("float32"),
            "label": rng.randint(0, 10, (2, 1))}
    return main, startup, loss, feed


def _clone(scope):
    out = ptt.Scope()
    for k in scope.keys():
        out.set(k, scope.get(k).clone())
    return out


def _same_scope(a, b):
    assert sorted(a.keys()) == sorted(b.keys())
    bad = [k for k in a.keys() if not torch.equal(a.get(k), b.get(k))]
    assert not bad, f"scope entries differ: {bad[:8]}"


def _start(startup):
    scope = ptt.Scope()
    ptt.Executor().run(startup, scope=scope)
    return scope


@pytest.mark.cuda
@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "bf16"])
def test_compile_then_run_replays_with_no_warmup(card, amp):
    main, startup, loss, feed = _bottleneck()
    start = _start(startup)
    arms = []
    for compiled in (True, False):
        exe = ptt.Executor(amp=amp)
        scope = _clone(start)
        if compiled:
            spec = {"img": torch.empty(2, 128, 8, 8, device="meta"),
                    "label": ((2, 1), "int64")}
            cp = exe.compile(main, feed=spec, fetch_list=[loss],
                             scope=scope)
            _same_scope(scope, start)
            assert exe._step == 0
            assert set(cp.compile_times) >= {"validate_s", "warmup_s",
                                             "capture_s"}
            assert cp.step.facts["launches"]["conv1x1_mm"]
            assert cp.step.facts["pool_bytes"] > 0
            assert any(r["route"] == "kernel" for r in cp.step.listing)
        compile_cache.stats().reset()
        conv1x1.reset_counts()
        out, = exe.run_steps(3, main, feed=feed, fetch_list=[loss],
                             scope=scope)
        torch.cuda.synchronize()
        snap = compile_cache.stats().snapshot()
        if compiled:
            assert (snap["warmups"], snap["captures"], snap["replays"]) \
                == (0, 0, 3)
        arms.append((np.asarray(out), scope, dict(conv1x1.mm.by_form)))
        exe.close()
    (a, sa, fa_), (b, sb, fb) = arms
    assert a.tobytes() == b.tobytes()
    _same_scope(sa, sb)
    assert fa_ == fb and fa_["forward"] == 2 * 3


@pytest.mark.cuda
def test_a_worker_thread_replays_a_compiled_key(card):
    main, startup, _, feed = _bottleneck()
    pred = [op for op in main.global_block().ops
            if op.type == "softmax"][0].output("Out")[0]
    infer = main.prune([main.global_block().var(pred)]).clone(for_test=True)
    scope = _start(startup)
    exe = ptt.Executor()
    exe.compile(infer, feed={"img": feed["img"]}, fetch_list=[pred],
                scope=scope, is_test=True)
    compile_cache.stats().reset()
    got = []
    t = threading.Thread(target=lambda: got.append(exe.run(
        infer, feed={"img": feed["img"]}, fetch_list=[pred], scope=scope,
        is_test=True)[0]))
    t.start()
    t.join()
    snap = compile_cache.stats().snapshot()
    assert (snap["warmups"], snap["captures"], snap["replays"]) == (0, 0, 1)
    want, = ptt.Executor(use_jit=False).run(
        infer, feed={"img": feed["img"]}, fetch_list=[pred], scope=scope,
        is_test=True)
    assert got[0].tobytes() == want.tobytes()


@pytest.mark.cuda
def test_a_warm_compile_starts_from_the_disk(card, tmp_path):
    prev = flags.get_flag("cache_dir")
    flags.set_flag("cache_dir", str(tmp_path))
    try:
        main, startup, loss, feed = _bottleneck()
        start = _start(startup)
        arms = []
        for _ in range(2):
            exe = ptt.Executor(amp=True)
            scope = _clone(start)
            compile_cache.stats().reset()
            cp = exe.compile(main, feed=feed, fetch_list=[loss],
                             scope=scope)
            snap = compile_cache.stats().snapshot()
            out, = exe.run_steps(2, main, feed=feed, fetch_list=[loss],
                                 scope=scope)
            arms.append((cp, snap, np.asarray(out), scope))
            exe.close()
        (cold, cs, a, sa), (warm, ws, b, sb) = arms
        assert cs["disk_stores"] == 1 and ws["disk_hits"] == 1
        assert warm.step.source == "disk"
        assert warm.step.facts["cold_times"] == cold.compile_times
        for k in ("launches", "detail", "listing"):
            assert warm.step.facts[k] == cold.step.facts[k], k
        assert list(warm.step.facts["launches"]) == ["conv1x1_mm"]
        assert a.tobytes() == b.tobytes()
        _same_scope(sa, sb)
    finally:
        flags.set_flag("cache_dir", prev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_the_flash_forward_op_launches_k2(card, dtype):
    g = torch.Generator(device=card).manual_seed(0)
    q, k, v = (torch.randn(4, 1024, 64, generator=g, device=card)
               .to(dtype) for _ in range(3))
    fa.reset_counts()
    with torch.no_grad():
        got = fa.flash_attention(q, k, v, causal=True, block_q=128,
                                 block_k=128)
    torch.cuda.synchronize()
    assert fa.launches["fwd"] == 1 and \
        fa.launches_by_dtype["fwd", dtype] == 1
    want, _ = fa.flash_fwd_reference(q, k, v, True, 64 ** -0.5)
    err = (got.double() - want.double()).abs().max().item()
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}[dtype]
    assert err <= tol * max(1.0, want.double().abs().max().item())
