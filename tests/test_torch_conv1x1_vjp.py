"""The gradients and epilogues of the port's 1x1-conv product
(paddle_tpu_torch/ops/conv1x1.py) against the JAX package's Pallas kernel
in interpret mode: ``matmul``'s backward against ``pallas_matmul``'s
custom VJP, the conv wrapper's autograd, ``conv2d_1x1_with_bn_stats``
and ``conv2d_1x1_grad_fused`` (mirroring tests/test_pallas_conv.py), and
the split-K rule.  On CPU tensors the wrapper computes its plain version;
the ``cuda``-marked tests hold the kernels themselves against it on a
card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_conv as jconv
from paddle_tpu_torch.ops import conv1x1

R = np.random.RandomState(13)
TOL = dict(rtol=1e-4, atol=1e-4)        # fp32 on both sides
TA_TB = [(False, False), (True, False), (False, True), (True, True)]
BLK = (128, 128, 128, True)             # Pallas blocks, interpret mode


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


@pytest.mark.parametrize("ta,tb", TA_TB)
def test_matmul_vjp_matches_pallas_interpret(ta, tb):
    """d/dA and d/dB of sum(op(A) @ op(B) * G) in all four storage forms:
    the port's autograd Function against jax.grad through pallas_matmul's
    custom VJP (the same blocked kernel, interpret mode)."""
    M, K, N = 256, 384, 128
    a = R.randn(*((K, M) if ta else (M, K))).astype("float32")
    b = R.randn(*((N, K) if tb else (K, N))).astype("float32")
    g = R.randn(M, N).astype("float32")
    ja, jb = jax.grad(lambda a, b: jnp.sum(
        jconv.pallas_matmul(a, b, ta, tb, *BLK) * g), (0, 1))(
            jnp.asarray(a), jnp.asarray(b))
    ta_, tb_ = _t(a, True), _t(b, True)
    before = conv1x1.launches()
    out = conv1x1.matmul(ta_, tb_, ta, tb)
    (out * _t(g)).sum().backward()
    assert conv1x1.launches() == before      # CPU: plain path, no launch
    np.testing.assert_allclose(ta_.grad.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(tb_.grad.numpy(), np.asarray(jb), **TOL)


def test_matmul_backward_runs_pm_bwd_transposes(monkeypatch):
    """The backward calls mm exactly as _pm_bwd calls _mm: the conv's
    forward form (ta=F, tb=T) gives the dgrad (F, F) and the wgrad (T, F),
    each on contiguous operands, even when the cotangent arrives through
    a permute."""
    calls = []
    real = conv1x1.mm

    def spy(a, b, ta=False, tb=False, **kw):
        calls.append((ta, tb, a.is_contiguous(), b.is_contiguous()))
        return real(a, b, ta, tb, **kw)

    monkeypatch.setattr(conv1x1, "mm", spy)
    x = _t(R.randn(2, 128, 8, 8).astype("float32"), True)
    w = _t(R.randn(256, 128, 1, 1).astype("float32"), True)
    out = conv1x1.conv2d_1x1(x, w)
    (out * out).sum().backward()
    assert calls == [(False, True, True, True), (False, False, True, True),
                     (True, False, True, True)]


def test_matmul_vjp_rounds_grads_to_operand_dtype():
    """bf16 operands (AMP): the gradients come back bf16, as _pm_bwd rounds
    da/db to the operand dtype, and agree with the JAX VJP to a bf16 ulp
    or two of their scale."""
    a = R.randn(256, 128).astype("float32")
    b = (R.randn(128, 128) / 11).astype("float32")
    g = R.randn(256, 128).astype("float32")
    ja, jb = jax.grad(lambda a, b: jnp.sum(
        jconv.pallas_matmul(a, b, False, True, *BLK).astype(jnp.float32)
        * g), (0, 1))(jnp.asarray(a, jnp.bfloat16),
                      jnp.asarray(b, jnp.bfloat16))
    at = torch.from_numpy(a).bfloat16().requires_grad_(True)
    bt = torch.from_numpy(b).bfloat16().requires_grad_(True)
    (conv1x1.matmul(at, bt, False, True).float() * _t(g)).sum().backward()
    assert at.grad.dtype == bt.grad.dtype == torch.bfloat16
    for got, want in ((at.grad, ja), (bt.grad, jb)):
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want,
                                   rtol=1.6e-2, atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_1x1_grads_match_pallas_interpret(stride):
    """Autograd through the conv wrapper (the executor's training path),
    stride 1 and 2: the input gradient flows back through the stride
    slice and the pixel-major views."""
    x = R.randn(2, 128, 16, 16).astype("float32")
    w = R.randn(256, 128, 1, 1).astype("float32")
    s = (stride, stride)
    ref = np.asarray(jconv.conv2d_1x1(jnp.asarray(x), jnp.asarray(w), s,
                                      *BLK))
    g = R.randn(*ref.shape).astype("float32")
    jdx, jdw = jax.grad(lambda x, w: jnp.sum(
        jconv.conv2d_1x1(x, w, s, *BLK) * g), (0, 1))(jnp.asarray(x),
                                                      jnp.asarray(w))
    xt, wt = _t(x, True), _t(w, True)
    out = conv1x1.conv2d_1x1(xt, wt, s)
    np.testing.assert_allclose(out.detach().numpy(), ref, **TOL)
    (out * _t(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jdw),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_1x1_with_bn_stats_matches_jax(stride):
    """The out_stats epilogue's entry point: the output and the
    per-channel fp32 sum and sum of squares, against the JAX function in
    interpret mode (sums over 128-512 values: rtol 1e-4, atol 1e-3)."""
    x = R.randn(2, 128, 16, 16).astype("float32")
    w = (R.randn(256, 128, 1, 1) / 11).astype("float32")
    s = (stride, stride)
    jo, js, jq = jconv.conv2d_1x1_with_bn_stats(jnp.asarray(x),
                                                jnp.asarray(w), s, *BLK)
    before = conv1x1.launches()
    to, ts, tq = conv1x1.conv2d_1x1_with_bn_stats(_t(x), _t(w), s)
    assert conv1x1.launches() == before
    assert ts.shape == tq.shape == (256,) and ts.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-4,
                               atol=1e-3)
    ref = np.asarray(jo)
    np.testing.assert_allclose(ts.numpy(), ref.sum((0, 2, 3)), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_1x1_grad_fused_matches_jax(stride):
    """The gradient entry point with the a_colsum epilogue: dx (scattered
    back through the stride), dw and dsum = sum of gout over N, H, W."""
    x = R.randn(2, 128, 16, 16).astype("float32")
    w = R.randn(256, 128, 1, 1).astype("float32")
    s = (stride, stride)
    oh = 16 // stride
    g = R.randn(2, 256, oh, oh).astype("float32")
    jdx, jdw, jds = jconv.conv2d_1x1_grad_fused(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(g), s, *BLK)
    tdx, tdw, tds = conv1x1.conv2d_1x1_grad_fused(_t(x), _t(w), _t(g), s)
    assert tuple(tdx.shape) == x.shape and tuple(tdw.shape) == w.shape
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(tdw.numpy(), np.asarray(jdw), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(tds.numpy(), np.asarray(jds), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(tds.numpy(), g.sum((0, 2, 3)), rtol=1e-4,
                               atol=1e-3)


def test_mm_epilogue_outputs_and_checks():
    a = _t(R.randn(384, 256).astype("float32"))      # storage [K, M]
    b = _t(R.randn(384, 128).astype("float32"))      # storage [K, N]
    out, csum = conv1x1.mm(a, b, True, False, a_colsum=True)
    np.testing.assert_allclose(csum.numpy(), a.numpy().sum(0), **TOL)
    out2, s, q, csum2 = conv1x1.mm(a, b, True, False, out_stats=True,
                                   a_colsum=True)
    o = a.numpy().T @ b.numpy()
    np.testing.assert_allclose(out2.numpy(), o, **TOL)
    np.testing.assert_allclose(s.numpy(), o.sum(0), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(q.numpy(), (o * o).sum(0), rtol=1e-4)
    np.testing.assert_array_equal(csum2.numpy(), csum.numpy())
    with pytest.raises(ValueError, match="a_colsum"):
        conv1x1.mm(a.t().contiguous(), b, False, False, a_colsum=True)


WGRAD_SHAPES = [(128, 256, 401408), (256, 512, 100352), (512, 1024, 25088),
                (2048, 1024, 6272), (512, 2048, 6272), (128, 128, 1000),
                (1000, 384, 264)]


RESNET50_WGRADS = [  # (P, C, M) of the 29 1x1 convs on the kernel, batch 128
    (401408, 256, 128), (100352, 128, 512), (100352, 256, 512),
    (100352, 512, 128), (100352, 128, 512), (100352, 512, 128),
    (100352, 128, 512), (100352, 512, 128), (100352, 128, 512),
    (100352, 512, 256), (25088, 256, 1024), (25088, 512, 1024),
    (25088, 1024, 256), (25088, 256, 1024), (25088, 1024, 256),
    (25088, 256, 1024), (25088, 1024, 256), (25088, 256, 1024),
    (25088, 1024, 256), (25088, 256, 1024), (25088, 1024, 256),
    (25088, 256, 1024), (25088, 1024, 512), (6272, 512, 2048),
    (6272, 1024, 2048), (6272, 2048, 512), (6272, 512, 2048),
    (6272, 2048, 512), (6272, 512, 2048)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("M,N,K", WGRAD_SHAPES)
def test_split_k_rule(M, N, K, dtype):
    """The wgrad form's split at 132 SMs.  bf16 (:func:`plan`): slabs of
    whole 64-steps, at least 8 steps each where there are several, and
    tiles x slabs fills about one block per SM unless K runs out or the
    cluster caps it.  fp32 (:func:`split_k`): slabs cover K once in whole
    32-steps, about two blocks per SM."""
    dt = getattr(torch, dtype)
    sms = 132
    if dt == torch.bfloat16:
        p = conv1x1.plan(M, N, K, True, False, dt, sms)
        tiles = p.grid[0] * p.grid[1]
        steps = [-(-(hi - lo) // 64) for lo, hi in p.slabs()]
        assert p.kchunk % 64 == 0 and max(steps) * 64 <= p.kchunk
        if p.splits > 1:
            assert min(steps) >= conv1x1._MIN_SLAB_STEPS
            assert tiles * (p.splits - p.cluster) < sms
        if tiles * 8 >= sms * 7 / 8 or K < 16 * 64:
            assert p.partials == 0
        if tiles < sms and K >= 16 * 64:
            assert p.splits > 1
        if tiles >= sms:
            assert p.splits == 1
        return
    S, kc = conv1x1.split_k(M, N, K, dt, sms)
    assert kc % 32 == 0 and S >= 1
    assert (S - 1) * kc < K <= S * kc
    tiles = -(-M // 64) * -(-N // 64)
    if S > 1:
        assert kc >= conv1x1._MIN_SLAB_K - 32
        assert tiles * (S - 1) < 2 * sms
    if tiles < 2 * sms and K >= 2 * conv1x1._MIN_SLAB_K:
        assert S > 1
    if tiles >= 2 * sms:
        assert S == 1


@pytest.mark.parametrize("M,N,K", WGRAD_SHAPES)
def test_plan_slabs_cover_k_once_in_whole_steps(M, N, K):
    """The bf16 wgrad's slabs: contiguous, in order, each starting on a
    64-step, covering [0, K) exactly once; none empty."""
    p = conv1x1.plan(M, N, K, True, False)
    slabs = p.slabs()
    assert len(slabs) == p.splits
    assert slabs[0][0] == 0 and slabs[-1][1] == K
    for (lo, hi), (lo2, _) in zip(slabs, slabs[1:]):
        assert hi == lo2
    for lo, hi in slabs:
        assert lo % 64 == 0 and hi > lo
        assert hi % 64 == 0 or hi == K


@pytest.mark.parametrize("sms", [132, 114, 16])
@pytest.mark.parametrize("M,N,K", WGRAD_SHAPES)
def test_plan_cluster_divides_splits(M, N, K, sms):
    """The cluster is 1 to 8 blocks and divides the slabs; partials are
    written only where the slabs outnumber the cluster, one per cluster."""
    p = conv1x1.plan(M, N, K, True, False, torch.bfloat16, sms)
    assert 1 <= p.cluster <= 8 and p.splits % p.cluster == 0
    if p.splits > p.cluster:
        assert p.cluster == 8 and p.partials == p.splits // 8
    else:
        assert p.partials == 0 and p.cluster == p.splits


@pytest.mark.parametrize("ta,tb,a_major,b_major", [
    (False, True, "K", "K"),     # forward: x [P, C], w [M, C]
    (False, False, "K", "N"),    # dgrad: gout [P, M], w [M, C]
    (True, False, "M", "N"),     # wgrad: gout [P, M], x [P, C]
    (True, True, "M", "K")])
def test_plan_majorness_per_form(ta, tb, a_major, b_major):
    """Each operand is read in its storage orientation: K-major operands
    in boxes of 64 K x 128 rows, MN-major ones in boxes of 64 x 64."""
    p = conv1x1.plan(512, 256, 1024, ta, tb)
    assert (p.a_major, p.b_major) == (a_major, b_major)
    assert p.a_box == ((64, 64) if a_major == "M" else (64, 128))
    assert p.b_box == ((64, 64) if b_major == "N" else (64, 128))
    assert p.tile == (128, 128, 64) and p.stages >= 2
    if (ta, tb) != (True, False):        # split within one cluster only
        assert p.partials == 0 and p.cluster == p.splits <= 8
    assert conv1x1.plan(512, 256, 1024, ta, tb, out_stats=True).splits == 1


def test_plan_resnet50_step_partials_and_reduce_passes():
    """One batch-128 ResNet-50 step at 132 SMs: the wgrads' fp32 partials
    (written and read) are at most 0.1 GB, and a reduce pass runs only
    where the slabs outnumber the cluster: the 10 launches at
    P >= 100352."""
    assert len(RESNET50_WGRADS) == 29
    plans = [conv1x1.plan(M, C, P, True, False) for P, C, M in
             RESNET50_WGRADS]
    assert sum(p.partial_bytes() for p in plans) <= 0.1e9
    reduce = [p for p in plans if p.partials]
    assert all(p.splits > p.cluster for p in reduce)
    assert all(p.splits <= p.cluster for p in plans if not p.partials)
    assert sorted({p.K for p in reduce}) == [100352, 401408]
    assert len(reduce) == 10


@pytest.mark.parametrize("ta,tb,M,N,K,bad", [
    (False, True, 256, 128, 260, "A"),       # A [M, K]: K not / 8
    (True, False, 250, 128, 512, "A"),       # A [K, M]: M not / 8
    (False, False, 256, 100, 512, "B"),      # B [K, N]: N not / 8
    (False, True, 256, 128, 100, "A")])
def test_plan_rejects_rows_not_multiple_of_8(ta, tb, M, N, K, bad):
    """TMA needs 16-byte row strides: a bf16 operand whose storage row is
    not a multiple of 8 elements raises before any launch."""
    with pytest.raises(ValueError, match=f"operand {bad}"):
        conv1x1.plan(M, N, K, ta, tb)
    with pytest.raises(ValueError, match="bf16"):
        conv1x1.plan(256, 256, 256, False, True, torch.float32)


def test_split_k_partials_sum_to_the_product():
    """The fp32 kernel's split-K decomposition: fp32 partials of each
    slab summed in slab order equal the product (fp32, CPU)."""
    K, M, N = 4096 + 96, 128, 256
    a = torch.from_numpy(R.randn(K, M).astype("float32"))
    b = torch.from_numpy(R.randn(K, N).astype("float32"))
    S, kc = conv1x1.split_k(M, N, K, torch.float32, 132)
    assert S == 8
    total = torch.zeros(M, N)
    for z in range(S):
        total += a[z * kc:(z + 1) * kc].t() @ b[z * kc:(z + 1) * kc]
    np.testing.assert_allclose(total.numpy(),
                               conv1x1.mm_reference(a, b, True).numpy(),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("M,N,K,sms", [(128, 256, 50176, 132),
                                       (256, 128, 8192 + 40, 16),
                                       (1000, 384, 2048, 132)])
def test_cluster_fold_order_matches_the_product(M, N, K, sms):
    """The bf16 wgrad's fold, emulated in fp32 on the CPU: each slab's
    partial, the slabs of a cluster summed in rank order, then the
    clusters' partials in order (splitk_reduce), with a_colsum folded the
    same way, equal mm_reference."""
    p = conv1x1.plan(M, N, K, True, False, torch.bfloat16, sms)
    a = torch.from_numpy(R.randn(K, M).astype("float32"))
    b = torch.from_numpy(R.randn(K, N).astype("float32"))
    part = [a[lo:hi].t() @ b[lo:hi] for lo, hi in p.slabs()]
    cpart = [a[lo:hi].sum(0) for lo, hi in p.slabs()]
    clusters, ccl = [], []
    for c0 in range(0, p.splits, p.cluster):
        acc, cacc = torch.zeros(M, N), torch.zeros(M)
        for r in range(p.cluster):
            acc, cacc = acc + part[c0 + r], cacc + cpart[c0 + r]
        clusters.append(acc)
        ccl.append(cacc)
    assert len(clusters) == max(p.partials, 1)
    out, csum = conv1x1.splitk_reduce_reference(torch.stack(clusters),
                                                torch.float32,
                                                torch.stack(ccl))
    ref, rcs = conv1x1.mm_reference(a, b, True, a_colsum=True)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(csum.numpy(), rcs.numpy(), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradients_and_epilogues_match_plain_on_card(cuda_device, dtype):
    """On a card: the dgrad, the split-K wgrad (with its reduce pass) and
    both epilogues against their plain versions, and the launch counts."""
    dt = getattr(torch, dtype)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    P, C, M = 25088, 256, 512
    x = torch.randn(P, C, device=cuda_device, generator=gen).to(dt)
    w = (torch.randn(M, C, device=cuda_device, generator=gen)
         / C ** 0.5).to(dt)
    g = torch.randn(P, M, device=cuda_device, generator=gen).to(dt)
    tol = dict(rtol=1e-4, atol=1e-3) if dt == torch.float32 else \
        dict(rtol=1.6e-2, atol=1e-2)
    conv1x1.reset_counts()
    dx = conv1x1.mm(g, w, False, False)
    dw, dsum = conv1x1.mm(g, x, True, False, a_colsum=True)
    out, s, q = conv1x1.mm(x, w, False, True, out_stats=True)
    torch.cuda.synchronize()
    assert conv1x1.launches() == 3
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    if dt == torch.bfloat16:
        reduce = int(conv1x1.plan(M, C, P, True, False, dt, sms).partials > 0)
    else:
        reduce = int(conv1x1.split_k(M, C, P, dt, sms)[0] > 1)
    assert conv1x1.mm.by_form["splitk_reduce"] == reduce
    torch.testing.assert_close(dx.float(), conv1x1.mm_reference(
        g, w, False, False).float(), **tol)
    rdw, rds = conv1x1.mm_reference(g, x, True, False, a_colsum=True)
    # K = P products: fp32 sums in two orders differ by a few eps32 x K
    torch.testing.assert_close(dw.float(), rdw.float(), rtol=tol["rtol"],
                               atol=max(tol["atol"], 2e-7 * P))
    torch.testing.assert_close(dsum, rds, rtol=1e-4, atol=1e-2)
    ro, rs, rq = conv1x1.mm_reference(x, w, False, True, out_stats=True)
    torch.testing.assert_close(out.float(), ro.float(), **tol)
    torch.testing.assert_close(s, rs, rtol=1e-4, atol=1e-1)
    torch.testing.assert_close(q, rq, rtol=1e-4, atol=1e-1)


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,K", [(1024, 256, 25088), (128, 256, 50176)])
def test_cluster_fold_on_card(cuda_device, M, N, K):
    """bf16 wgrad with a_colsum on a card: a fold with S <= cluster (the
    kernel writes the output: no reduce launch) and one with S > cluster
    (one splitk_reduce over the clusters' partials), against the plain
    version."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    g = torch.randn(K, M, device=cuda_device, generator=gen).bfloat16()
    x = torch.randn(K, N, device=cuda_device, generator=gen).bfloat16()
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    p = conv1x1.plan(M, N, K, True, False, torch.bfloat16, sms)
    conv1x1.reset_counts()
    dw, dsum = conv1x1.mm(g, x, True, False, a_colsum=True)
    torch.cuda.synchronize()
    assert conv1x1.mm.by_form["splitk_reduce"] == (1 if p.partials else 0)
    rdw, rds = conv1x1.mm_reference(g, x, True, False, a_colsum=True)
    torch.testing.assert_close(dw.float(), rdw.float(), rtol=1.6e-2,
                               atol=max(1e-2, 2e-7 * K))
    torch.testing.assert_close(dsum, rds, rtol=1e-4, atol=1e-2)


@pytest.mark.cuda
def test_wgrad_bit_equal_on_card(cuda_device):
    """Two runs of a split bf16 wgrad (clusters and a reduce pass) give
    the same bits: the fold has no atomics."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    K, M, N = 100352, 512, 128
    g = torch.randn(K, M, device=cuda_device, generator=gen).bfloat16()
    x = torch.randn(K, N, device=cuda_device, generator=gen).bfloat16()
    one = conv1x1.mm(g, x, True, False, a_colsum=True)
    two = conv1x1.mm(g, x, True, False, a_colsum=True)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(one, two))


@pytest.mark.parametrize("ta,tb,M,N,K,kw,persistent", [
    (False, True, 401408, 128, 256, {}, True),              # forward
    (False, True, 25088, 256, 1024, {"out_stats": True}, True),
    (False, False, 401408, 256, 128, {}, True),             # dgrad
    (False, True, 6272, 256, 1024, {}, False),              # split in a cluster
    (True, False, 128, 256, 401408, {}, False),             # split wgrad
    (False, True, 2048, 256, 512, {"out_dtype": torch.float32}, False),
    (True, False, 256, 384, 264, {"a_colsum": True}, False)])
def test_plan_persistent_schedule(ta, tb, M, N, K, kw, persistent):
    """One slab with a bf16 output and no a_colsum runs persistent: two
    blocks an SM (at most one per tile) walk the tiles with a 2-stage ring;
    every other launch runs one tile a block with a 3-stage ring."""
    p = conv1x1.plan(M, N, K, ta, tb, torch.bfloat16, 132, **kw)
    assert bool(p.ctas) == persistent
    if persistent:
        assert p.splits == 1 and p.stages == 2
        assert p.ctas == min(p.tiles, 2 * 132) and p.grid == (p.ctas, 1, 1)
    else:
        assert p.stages == 3 and p.grid[2] == p.splits
