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


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("M,N,K", WGRAD_SHAPES)
def test_split_k_rule(M, N, K, dtype):
    """Slabs cover K exactly once, are whole K steps, each holds at least
    one K value and, where K allows, _MIN_SLAB_K; tiles x slabs reaches
    about two blocks per SM (132 SMs) unless K runs out first."""
    dt = getattr(torch, dtype)
    sms = 132
    S, kc = conv1x1.split_k(M, N, K, dt, sms)
    assert kc % 32 == 0 and S >= 1
    assert (S - 1) * kc < K <= S * kc
    tile = 128 if dt == torch.bfloat16 else 64
    tiles = -(-M // tile) * -(-N // tile)
    if S > 1:
        assert kc >= conv1x1._MIN_SLAB_K - 32
        assert tiles * (S - 1) < 2 * sms
    if tiles < 2 * sms and K >= 2 * conv1x1._MIN_SLAB_K:
        assert S > 1
    if tiles >= 2 * sms:
        assert S == 1


def test_split_k_partials_sum_to_the_product():
    """The split-K decomposition the kernel uses: fp32 partials of each
    slab summed in slab order equal the product (fp32, CPU)."""
    K, M, N = 4096 + 96, 128, 256
    a = torch.from_numpy(R.randn(K, M).astype("float32"))
    b = torch.from_numpy(R.randn(K, N).astype("float32"))
    S, kc = conv1x1.split_k(M, N, K, torch.bfloat16, 132)
    assert S == 8
    total = torch.zeros(M, N)
    for z in range(S):
        total += a[z * kc:(z + 1) * kc].t() @ b[z * kc:(z + 1) * kc]
    np.testing.assert_allclose(total.numpy(),
                               conv1x1.mm_reference(a, b, True).numpy(),
                               rtol=1e-4, atol=1e-3)


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
    assert conv1x1.mm.by_form["splitk_reduce"] == 1
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
