"""The port's 1x1-conv matrix product (paddle_tpu_torch/ops/conv1x1.py)
against the JAX package's Pallas kernel run in interpret mode, as
tests/test_pallas_conv.py runs it.  On CPU tensors the wrapper computes
its plain version; the CUDA kernel itself is held against that plain
version by the ``cuda``-marked tests (and by chip_smoke.py) on a card."""
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_conv as jconv
from paddle_tpu_torch.ops import conv1x1

R = np.random.RandomState(11)
TOL = dict(rtol=1e-4, atol=1e-4)        # fp32 on both sides
TA_TB = [(False, False), (True, False), (False, True), (True, True)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("ta,tb", TA_TB)
def test_mm_matches_pallas_interpret(ta, tb):
    M, K, N = 256, 384, 128
    a = R.randn(M, K).astype("float32")
    b = R.randn(K, N).astype("float32")
    aa = a.T.copy() if ta else a
    bb = b.T.copy() if tb else b
    ref = np.asarray(jconv.pallas_matmul(jnp.asarray(aa), jnp.asarray(bb),
                                         ta, tb, 128, 128, 128, True))
    before = conv1x1.launches()
    out = conv1x1.mm(torch.from_numpy(aa), torch.from_numpy(bb), ta, tb)
    assert conv1x1.launches() == before      # CPU: plain path, no launch
    assert out.shape == (M, N) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(out.numpy(), a @ b, **TOL)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_1x1_matches_pallas_interpret(stride):
    x = R.randn(2, 128, 16, 16).astype("float32")
    w = R.randn(256, 128, 1, 1).astype("float32")
    s = (stride, stride)
    ref = np.asarray(jconv.conv2d_1x1(jnp.asarray(x), jnp.asarray(w), s,
                                      128, 128, 128, True))
    before = conv1x1.launches()
    out = conv1x1.conv2d_1x1(torch.from_numpy(x), torch.from_numpy(w), s)
    assert conv1x1.launches() == before
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    plain = conv1x1.conv2d_1x1_reference(torch.from_numpy(x),
                                         torch.from_numpy(w), s)
    np.testing.assert_allclose(plain.numpy(), ref, **TOL)


def test_mm_bf16_rounds_like_pallas():
    """bf16 operands, fp32 accumulation, bf16 output on both sides: at
    most one bf16 ulp apart (summation order)."""
    a = R.randn(128, 256).astype("float32")
    b = R.randn(128, 256).astype("float32") / 16
    ref = np.asarray(jconv.pallas_matmul(
        jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
        False, True, 128, 128, 128, True).astype(jnp.float32))
    out = conv1x1.mm(torch.from_numpy(a).bfloat16(),
                     torch.from_numpy(b).bfloat16(), False, True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=8e-3,
                               atol=8e-3)
    out32 = conv1x1.mm(torch.from_numpy(a).bfloat16(),
                       torch.from_numpy(b).bfloat16(), False, True,
                       out_dtype=torch.float32)
    assert out32.dtype == torch.float32


def _shape_grid():
    grid = []
    for x_shape in [(2, 128, 8, 8), (32, 256, 56, 56), (1, 256, 56, 56),
                    (8, 64, 56, 56), (32, 1024, 14, 14), (32, 2048, 7, 7),
                    (2, 3, 224, 224)]:
        for m in (64, 128, 256, 512):
            for k in (1, 3):
                for stride in (1, 2):
                    for pad in (0, 1):
                        grid.append((x_shape, (m, x_shape[1], k, k),
                                     (stride, stride), (pad, pad)))
    return grid


def test_eligibility_gate_agrees_with_jax():
    grid = _shape_grid()
    n_true = 0
    for x_shape, w_shape, strides, pads in grid:
        for dils, groups in (((1, 1), 1), ((2, 2), 1), ((1, 1), 2)):
            want = jconv.conv1x1_eligible(x_shape, w_shape, strides, pads,
                                          dils, groups)
            got = conv1x1.conv1x1_eligible(x_shape, w_shape, strides, pads,
                                           dils, groups)
            assert got == want, (x_shape, w_shape, strides, pads, dils,
                                 groups)
            n_true += got
    assert 0 < n_true < len(grid)


def test_mm_checks_shapes():
    with pytest.raises(ValueError, match="contraction"):
        conv1x1.mm(torch.zeros(4, 8), torch.zeros(4, 8), False, False)
    with pytest.raises(ValueError, match="2-D"):
        conv1x1.mm(torch.zeros(4, 8, 1), torch.zeros(8, 4))


def test_mm_never_falls_back_off_the_cpu():
    """A tensor that is neither on the CPU nor on a CUDA card raises; the
    plain version is for CPU tensors only."""
    a = torch.empty(128, 128, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        conv1x1.mm(a, a, False, True)


def test_build_needs_nvcc():
    if shutil.which("nvcc") is not None:
        pytest.skip("nvcc present: the build is exercised on the card")
    with pytest.raises(RuntimeError, match="nvcc"):
        conv1x1.build()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ta,tb", TA_TB)
def test_kernel_matches_plain_on_card(cuda_device, dtype, ta, tb):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    M, N, K = 1000, 384, 264          # ragged: masks every edge
    a = torch.randn((K, M) if ta else (M, K), device=cuda_device,
                    generator=g).to(dt)
    b = (torch.randn((N, K) if tb else (K, N), device=cuda_device,
                     generator=g) / K ** 0.5).to(dt)
    torch.backends.cuda.matmul.allow_tf32 = False
    before = conv1x1.launches()
    out = conv1x1.mm(a, b, ta, tb)
    torch.cuda.synchronize()
    assert conv1x1.launches() == before + 1
    ref = conv1x1.mm_reference(a, b, ta, tb)
    tol = dict(rtol=1e-4, atol=1e-4) if dt == torch.float32 else \
        dict(rtol=1.6e-2, atol=1e-2)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
