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


def _rounds(p, sms, deep=True):
    """The fp32 plan's launch in whole rounds of one block an SM: (time in
    units of one full-K tile, the least such time over the slab counts
    the rule allows: at most 2, or a multiple of 2 for the wgrad form,
    {S: time} of those within 1/16 of the least)."""
    top = max(1, p.ksteps // conv1x1._MIN_SLAB_STEPS)
    if not deep:
        top = min(top, 2)
    cands = [s for s in range(1, top + 1) if s <= 2 or s % 2 == 0]
    t = {s: -(-p.tiles * s // sms) / s for s in cands}
    least = min(t.values())
    near = {s: v for s, v in t.items() if v <= 1.0625 * least}
    return t[p.splits], least, near


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("M,N,K", WGRAD_SHAPES)
def test_split_k_rule(M, N, K, dtype):
    """The wgrad form's split at 132 SMs, by :func:`plan`.  bf16: slabs
    of whole 64-steps, at least 8 steps each where there are several, and
    tiles x slabs fills about one block per SM unless K runs out or the
    cluster caps it.  fp32: slabs cover K once in whole 32-steps, at least
    8 each where there are several, tiles x slabs fill whole rounds of
    blocks over the SMs (within 1/16 of the best the slab counts allow,
    with as many slabs as still fit two blocks an SM), clusters of at
    most 2, and partials exist only where the slabs outnumber the
    cluster."""
    dt = getattr(torch, dtype)
    sms = 132
    p = conv1x1.plan(M, N, K, True, False, dt, sms)
    tiles = p.grid[0] * p.grid[1]
    bk = p.tile[2]
    steps = [-(-(hi - lo) // bk) for lo, hi in p.slabs()]
    assert p.kchunk % bk == 0 and max(steps) * bk <= p.kchunk
    if p.splits > 1:
        assert min(steps) >= conv1x1._MIN_SLAB_STEPS
    if dt == torch.bfloat16:
        assert bk == 64
        if p.splits > 1:
            assert tiles * (p.splits - p.cluster) < sms
        if tiles * 8 >= sms * 7 / 8 or K < 16 * 64:
            assert p.partials == 0
        if tiles < sms and K >= 16 * 64:
            assert p.splits > 1
        if tiles >= sms:
            assert p.splits == 1
        return
    assert bk == 32 and p.tile == (128, 128, 32) and p.ctas == 0
    assert sum(hi - lo for lo, hi in p.slabs()) == K
    mine, least, near = _rounds(p, sms)
    assert mine <= conv1x1._WAVE_SLACK * least and p.splits in near
    fit = [s for s in near if tiles * s <= 2 * sms]
    assert p.splits == (max(fit) if fit else min(near))
    assert p.cluster == min(p.splits, 2)
    assert (p.partials > 0) == (p.splits > p.cluster)
    if sms >= tiles * 4 and K >= 4 * 32 * 8:
        assert p.partials > 0          # one cluster of 2 would idle the card


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("M,N,K", WGRAD_SHAPES)
def test_plan_slabs_cover_k_once_in_whole_steps(M, N, K, dtype):
    """The wgrad's slabs: contiguous, in order, each starting on a K step
    (64 bf16, 32 fp32), covering [0, K) exactly once; none empty."""
    p = conv1x1.plan(M, N, K, True, False, getattr(torch, dtype))
    bk = p.tile[2]
    slabs = p.slabs()
    assert len(slabs) == p.splits
    assert slabs[0][0] == 0 and slabs[-1][1] == K
    for (lo, hi), (lo2, _) in zip(slabs, slabs[1:]):
        assert hi == lo2
    for lo, hi in slabs:
        assert lo % bk == 0 and hi > lo
        assert hi % bk == 0 or hi == K


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("sms", [132, 114, 16])
@pytest.mark.parametrize("M,N,K", WGRAD_SHAPES)
def test_plan_cluster_divides_splits(M, N, K, sms, dtype):
    """The cluster is 1 to 8 blocks (bf16) or 1 to 2 (fp32) and divides
    the slabs; partials are written only where the slabs outnumber the
    cluster, one per cluster."""
    p = conv1x1.plan(M, N, K, True, False, getattr(torch, dtype), sms)
    top = 8 if dtype == "bfloat16" else 2
    assert 1 <= p.cluster <= top and p.splits % p.cluster == 0
    if p.splits > p.cluster:
        assert p.cluster == top and p.partials == p.splits // top
    else:
        assert p.partials == 0 and p.cluster == p.splits


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("ta,tb,a_major,b_major", [
    (False, True, "K", "K"),     # forward: x [P, C], w [M, C]
    (False, False, "K", "N"),    # dgrad: gout [P, M], w [M, C]
    (True, False, "M", "N"),     # wgrad: gout [P, M], x [P, C]
    (True, True, "M", "K")])
def test_plan_majorness_per_form(ta, tb, a_major, b_major, dtype):
    """Each operand is read in its storage orientation.  bf16: K-major
    operands in boxes of 64 K x 128 rows, MN-major ones in boxes of 64 x
    64.  fp32: K-major in boxes of 32 K x 128 rows, MN-major in 128 x 32
    K, one tile a block with a 2-stage ring, never persistent."""
    dt = getattr(torch, dtype)
    p = conv1x1.plan(512, 256, 1024, ta, tb, dt)
    assert (p.a_major, p.b_major) == (a_major, b_major)
    if dt == torch.bfloat16:
        assert p.a_box == ((64, 64) if a_major == "M" else (64, 128))
        assert p.b_box == ((64, 64) if b_major == "N" else (64, 128))
        assert p.tile == (128, 128, 64) and p.stages >= 2
    else:
        assert p.a_box == ((128, 32) if a_major == "M" else (32, 128))
        assert p.b_box == ((128, 32) if b_major == "N" else (32, 128))
        assert p.tile == (128, 128, 32) and p.stages == 2 and p.ctas == 0
    if (ta, tb) != (True, False):        # split within one cluster only
        assert p.partials == 0 and p.cluster == p.splits
        assert p.splits <= (8 if dt == torch.bfloat16 else 2)
    assert conv1x1.plan(512, 256, 1024, ta, tb, dt,
                        out_stats=True).splits == 1


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


def test_plan_resnet50_fp32_step_fills_whole_waves():
    """The fp32 plans of one batch-128 ResNet-50 step at 132 SMs: every
    wgrad fills 0.9 to 1 of two blocks an SM (no 2.06-wave grid), its
    partials (written and read) are at most 0.5 GB a step (0.15 ms of
    HBM), and a reduce pass
    runs exactly where the slabs outnumber the cluster of 2: all but the
    one wgrad of 128 tiles; the forward and dgrad split only within one
    cluster."""
    f32 = torch.float32
    plans = [conv1x1.plan(M, C, P, True, False, f32) for P, C, M in
             RESNET50_WGRADS]
    for p in plans:
        assert 0.9 <= p.tiles * p.splits / 264 <= 1.0
        mine, least, _ = _rounds(p, 132)
        assert mine <= conv1x1._WAVE_SLACK * least
    assert sum(p.partial_bytes() for p in plans) <= 0.5e9
    reduce = [p for p in plans if p.partials]
    assert all(p.splits > p.cluster == 2 for p in reduce)
    assert [p.tiles for p in plans if not p.partials] == [128]
    assert len(reduce) == 28
    for P, C, M in RESNET50_WGRADS:     # forward and dgrad: one cluster
        for q in (conv1x1.plan(P, M, C, False, True, f32),
                  conv1x1.plan(P, C, M, False, False, f32)):
            assert q.partials == 0 and q.cluster == q.splits <= 2
            mine, least, _ = _rounds(q, 132, deep=False)
            assert mine <= conv1x1._WAVE_SLACK * least


@pytest.mark.parametrize("dtype,ta,tb,M,N,K,bad", [
    ("bfloat16", False, True, 256, 128, 260, "A"),    # A [M, K]: K not / 8
    ("bfloat16", True, False, 250, 128, 512, "A"),    # A [K, M]: M not / 8
    ("bfloat16", False, False, 256, 100, 512, "B"),   # B [K, N]: N not / 8
    ("bfloat16", False, True, 256, 128, 100, "A"),
    ("float32", False, True, 256, 128, 258, "A"),     # A [M, K]: K not / 4
    ("float32", True, False, 250, 128, 512, "A"),     # A [K, M]: M not / 4
    ("float32", False, False, 256, 102, 512, "B"),    # B [K, N]: N not / 4
    ("float32", True, True, 256, 128, 90, "B")])      # B [N, K]: K not / 4
def test_plan_rejects_rows_not_multiple_of_8(dtype, ta, tb, M, N, K, bad):
    """TMA needs 16-byte row strides: an operand whose storage row is not
    a multiple of 16 bytes (8 bf16, 4 fp32 elements) raises before any
    launch; the same product with rows of a multiple of 4 has an fp32
    plan, and another dtype has none."""
    dt = getattr(torch, dtype)
    with pytest.raises(ValueError, match=f"{dtype[:1]}.*operand {bad}"):
        conv1x1.plan(M, N, K, ta, tb, dt)
    p = conv1x1.plan(256, 100, 260, False, False, torch.float32)
    assert p.tile == (128, 128, 32) and p.ksteps == 9
    with pytest.raises(ValueError, match="bf16"):
        conv1x1.plan(256, 100, 260, False, False, torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        conv1x1.plan(256, 256, 256, False, True, torch.float16)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("M,N,K,sms", [(128, 256, 50176, 132),
                                       (256, 128, 8192 + 40, 16),
                                       (1000, 384, 2048, 132),
                                       (128, 256, 4096 + 96, 132)])
def test_cluster_fold_order_matches_the_product(M, N, K, sms, dtype):
    """The wgrad's fold by each dtype's plan, emulated in fp32 on the CPU:
    each slab's partial, the slabs of a cluster summed in rank order, then
    the clusters' partials in order (splitk_reduce), with a_colsum folded
    the same way, equal mm_reference."""
    p = conv1x1.plan(M, N, K, True, False, getattr(torch, dtype), sms)
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
    reduce = int(conv1x1.plan(M, C, P, True, False, dt, sms).partials > 0)
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
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("M,N,K", [(1024, 256, 25088), (128, 256, 50176)])
def test_cluster_fold_on_card(cuda_device, M, N, K, dtype):
    """The wgrad with a_colsum on a card, by each dtype's plan: a fold
    with S <= cluster (the kernel writes the output: no reduce launch)
    and one with S > cluster (one splitk_reduce over the clusters'
    partials), against the plain version."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    g = torch.randn(K, M, device=cuda_device, generator=gen).to(dt)
    x = torch.randn(K, N, device=cuda_device, generator=gen).to(dt)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    p = conv1x1.plan(M, N, K, True, False, dt, sms)
    conv1x1.reset_counts()
    dw, dsum = conv1x1.mm(g, x, True, False, a_colsum=True)
    torch.cuda.synchronize()
    assert conv1x1.mm.by_form["splitk_reduce"] == (1 if p.partials else 0)
    rdw, rds = conv1x1.mm_reference(g, x, True, False, a_colsum=True)
    rtol, atol = (1.6e-2, 1e-2) if dt == torch.bfloat16 else (1e-4, 1e-4)
    torch.testing.assert_close(dw.float(), rdw.float(), rtol=rtol,
                               atol=max(atol, 2e-7 * K))
    torch.testing.assert_close(dsum, rds, rtol=1e-4, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_wgrad_bit_equal_on_card(cuda_device, dtype):
    """Two runs of a split wgrad (clusters and a reduce pass) give the
    same bits: the fold has no atomics."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    K, M, N = 100352, 512, 128
    g = torch.randn(K, M, device=cuda_device, generator=gen).to(dt)
    x = torch.randn(K, N, device=cuda_device, generator=gen).to(dt)
    assert conv1x1.plan(M, N, K, True, False, dt).partials > 0
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
