"""The port's flash attention (paddle_tpu_torch/ops/flash_attention.py)
against the JAX package's Pallas kernels run in interpret mode, as
tests/test_pallas.py runs them, on the same numpy-seeded inputs.  On CPU
tensors the wrappers compute their plain versions; the CUDA kernels
themselves are held against those plain versions by the ``cuda``-marked
tests (and by chip_smoke.py) on a card."""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_kernels as jpk
from paddle_tpu_torch.ops import cuda_build, conv1x1
from paddle_tpu_torch.ops import flash_attention as fa

R = np.random.RandomState(7)
# fp32: both sides compute exact fp32 softmax attention (the Pallas
# interpreter online over 64-key blocks, the port two-pass over all keys),
# so only the summation order differs.
TOL32 = dict(rtol=2e-5, atol=2e-5)
# bf16 inputs, fp32 math on both sides, out rounded once to bf16: at most
# a bf16 ulp (2^-8 relative) apart where the fp32 values straddle a
# rounding boundary.
TOL16 = dict(rtol=8e-3, atol=8e-3)
# gradients in fp32: as TOL32, over sums of up to 128 terms
GTOL = dict(rtol=1e-4, atol=1e-4)

# (BH, Tq, Tk, D, Dv, causal): the kernel cases of tests/test_pallas.py
KERNEL_CASES = [
    (2, 128, 128, 32, 32, False),
    (2, 128, 128, 32, 32, True),
    (2, 64, 128, 16, 32, False),          # cross-attention, Dv != D
    (1, 128, 128, 64, 64, True),
]


def _np(*shape):
    return R.randn(*shape).astype("float32")


def _qkv(BH, Tq, Tk, D, Dv):
    return _np(BH, Tq, D), _np(BH, Tk, D), _np(BH, Tk, Dv)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def _j(x, dtype=jnp.float32):
    return jnp.asarray(x, dtype)


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


# ---------------------------------------------------------------------------
# kernel level: the plain versions against _flash_fwd / _flash_bwd
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", KERNEL_CASES)
def test_forward_matches_pallas_interpret(case, dtype):
    BH, Tq, Tk, D, Dv, causal = case
    q, k, v = _qkv(BH, Tq, Tk, D, Dv)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    scale = D ** -0.5
    jout, jlse = jpk._flash_fwd(_j(q, jdt), _j(k, jdt), _j(v, jdt), causal,
                                scale, 64, 64, True)
    before = dict(fa.launches)
    out, lse = fa.flash_fwd(_t(q, tdt), _t(k, tdt), _t(v, tdt), causal,
                            scale)
    assert dict(fa.launches) == before         # CPU: plain path, no launch
    assert out.dtype == tdt and lse.dtype == torch.float32
    assert tuple(out.shape) == (BH, Tq, Dv) and tuple(lse.shape) == (BH, Tq, 1)
    tol = TOL32 if dtype == "float32" else TOL16
    np.testing.assert_allclose(_f32(out), _f32(jout), **tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL32)


@pytest.mark.parametrize("with_g_lse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", KERNEL_CASES)
def test_backward_matches_pallas_interpret(case, dtype, with_g_lse):
    """dq, dk, dv from the same (out, lse) and cotangents, with and
    without an lse cotangent."""
    BH, Tq, Tk, D, Dv, causal = case
    q, k, v = _qkv(BH, Tq, Tk, D, Dv)
    g = _np(BH, Tq, Dv)
    g_lse = _np(BH, Tq, 1) if with_g_lse else None
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    scale = D ** -0.5
    jq, jk, jv = _j(q, jdt), _j(k, jdt), _j(v, jdt)
    jout, jlse = jpk._flash_fwd(jq, jk, jv, causal, scale, 64, 64, True)
    jd = jpk._flash_bwd(jq, jk, jv, jout, jlse, _j(g, jdt), causal, scale,
                        64, 64, True,
                        g_lse=None if g_lse is None else _j(g_lse))
    # the same out and lse on the port's side
    out = _t(_f32(jout), tdt)
    lse = _t(np.asarray(jlse))
    td = fa.flash_bwd(_t(q, tdt), _t(k, tdt), _t(v, tdt), out, lse,
                      _t(g, tdt), causal, scale,
                      g_lse=None if g_lse is None else _t(g_lse))
    for name, a, b, want in zip("qkv", td, jd, (tdt, tdt, tdt)):
        assert a.dtype == want, name
        if dtype == "float32":
            np.testing.assert_allclose(_f32(a), _f32(b), err_msg=name,
                                       **GTOL)
        else:
            # bf16 cotangent and data, fp32 math, one rounding at the end
            scale_b = np.abs(_f32(b)).max()
            np.testing.assert_allclose(_f32(a), _f32(b), rtol=1e-2,
                                       atol=1e-2 * scale_b, err_msg=name)


# head sizes no multiple of 16 (D, Dv): the wrappers pad them for the
# kernels (padded_fwd / padded_bwd), here around the plain versions
PADDED_HEADS = [(40, 40), (60, 60), (72, 72), (120, 120), (40, 72),
                (120, 60)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D,Dv", PADDED_HEADS)
def test_padded_route_matches_pallas_interpret(D, Dv, causal):
    """The route a CUDA tensor with such a head size takes, with the plain
    versions in the kernels' place: q, k, v (and out, the cotangent) padded
    with zeros to the next multiple of 16, the padding sliced off out, dq,
    dk and dv.  Held against the JAX kernels in interpret mode at the true
    head size, forward and gradients, with the scale of the true D."""
    BH, T = 2, 128
    # a generator of its own: the module's R feeds the tests after these
    rs = np.random.RandomState(D * 1000 + Dv)
    q, k, g = (rs.randn(BH, T, d).astype("float32") for d in (D, D, Dv))
    v = rs.randn(BH, T, Dv).astype("float32")
    scale = D ** -0.5
    jq, jk, jv = _j(q), _j(k), _j(v)
    jout, jlse = jpk._flash_fwd(jq, jk, jv, causal, scale, 64, 64, True)
    jd = jpk._flash_bwd(jq, jk, jv, jout, jlse, _j(g), causal, scale, 64,
                        64, True)
    out, lse = fa.padded_fwd(fa.flash_fwd_reference, _t(q), _t(k), _t(v),
                             causal, scale)
    assert tuple(out.shape) == (BH, T, Dv) and out.is_contiguous()
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL32)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL32)
    td = fa.padded_bwd(fa.flash_bwd_reference, _t(q), _t(k), _t(v), out,
                       lse, _t(g), causal, scale)
    for name, a, b, d in zip("qkv", td, jd, (D, D, Dv)):
        assert tuple(a.shape) == (BH, T, d), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **GTOL)


def test_padded_head_sizes():
    assert [fa.padded_head(d) for d in (1, 8, 16, 40, 60, 72, 120, 128)] \
        == [16, 16, 16, 48, 64, 80, 128, 128]
    for d in (129, 144, 256):
        with pytest.raises(ValueError, match="ROADMAP.md Queue A"):
            fa.padded_head(d)
    # the kernels' own plans keep refusing what they do not take, naming
    # the item for the sizes above 128
    with pytest.raises(ValueError, match="multiples of 16.*129-256"):
        fa.fwd_plan(1, 64, 64, 144, 64, False)
    with pytest.raises(ValueError, match="multiples of 16.*129-256"):
        fa.bwd_plan(1, 64, 64, 64, 160, False)


def test_plain_versions_chunk_invariant(monkeypatch):
    """The plain versions give the same result whatever their query
    chunk (the full-size check on the card runs them in 2048-row
    chunks)."""
    q, k, v = _qkv(2, 96, 96, 16, 16)
    g = _np(2, 96, 16)
    tq, tk, tv = _t(q), _t(k), _t(v)
    whole = fa.flash_fwd_reference(tq, tk, tv, True)
    bw = fa.flash_bwd_reference(tq, tk, tv, whole[0], whole[1], _t(g), True)
    monkeypatch.setattr(fa, "_CHUNK", 20)
    parts = fa.flash_fwd_reference(tq, tk, tv, True)
    for a, b in zip(whole, parts):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)
    bp = fa.flash_bwd_reference(tq, tk, tv, whole[0], whole[1], _t(g), True)
    for a, b in zip(bw, bp):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# the public functions, their layouts and routes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_matches_jax(causal):
    BH, T, D = 2, 128, 32
    q, k, v = _qkv(BH, T, T, D, D)
    want = jpk.flash_attention(_j(q), _j(k), _j(v), causal=causal,
                               block_q=64, block_k=64, use_pallas=True,
                               interpret=True)
    fa.reset_counts()
    got = fa.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                             block_q=64, block_k=64)
    assert not fa.reference_route and not fa.launches
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL32)


def test_bthd_layout_matches_jax():
    B, T, H, D = 2, 64, 4, 16
    q, k, v = _np(B, T, H, D), _np(B, T, H, D), _np(B, T, H, D)
    want = jpk.flash_attention(_j(q), _j(k), _j(v), block_q=64, block_k=64,
                               use_pallas=True, interpret=True)
    got = fa.flash_attention(_t(q), _t(k), _t(v), block_q=64, block_k=64)
    assert tuple(got.shape) == (B, T, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL32)


def test_cross_attention_takes_the_kernel_route():
    BH, Tq, Tk, D, Dv = 2, 64, 128, 16, 32
    q, k, v = _qkv(BH, Tq, Tk, D, Dv)
    want = jpk.flash_attention(_j(q), _j(k), _j(v), block_q=64, block_k=64,
                               use_pallas=True, interpret=True)
    fa.reset_counts()
    got = fa.flash_attention(_t(q), _t(k), _t(v), block_q=64, block_k=64)
    assert not fa.reference_route
    assert tuple(got.shape) == (BH, Tq, Dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL32)


@pytest.mark.parametrize("route,Tq,Tk,causal", [
    ("ragged", 100, 100, False),          # not a block multiple
    ("ragged", 100, 100, True),
    ("causal_cross", 64, 128, True),      # bottom-right mask
])
def test_reference_routes_match_jax(route, Tq, Tk, causal):
    D = 16
    q, k, v = _qkv(1, Tq, Tk, D, D)
    want = jpk.flash_attention(_j(q), _j(k), _j(v), causal=causal,
                               block_q=64, block_k=64, use_pallas=True,
                               interpret=True)
    fa.reset_counts()
    got = fa.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                             block_q=64, block_k=64)
    assert dict(fa.reference_route) == {route: 1}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL32)
    np.testing.assert_allclose(
        fa.attention_reference(_t(q), _t(k), _t(v), causal).numpy(),
        np.asarray(jpk._reference_attention(_j(q), _j(k), _j(v), causal,
                                            D ** -0.5)), **TOL32)


def test_attention_reference_bf16_matches_jax():
    """The reference route computes in the inputs' dtype, as JAX's
    ``_reference_attention`` does."""
    q, k, v = _qkv(2, 64, 64, 16, 16)
    want = jpk._reference_attention(_j(q, jnp.bfloat16), _j(k, jnp.bfloat16),
                                    _j(v, jnp.bfloat16), True, 0.25)
    got = fa.attention_reference(_t(q, torch.bfloat16),
                                 _t(k, torch.bfloat16),
                                 _t(v, torch.bfloat16), True, 0.25)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=3e-2, atol=3e-2)


def test_with_lse_needs_block_divisible_lengths():
    q = torch.zeros(1, 100, 16)
    with pytest.raises(ValueError, match="block-divisible"):
        fa.flash_attention_with_lse(q, q, q, block_q=64, block_k=64)
    q2 = torch.zeros(1, 64, 16)
    with pytest.raises(ValueError, match="block-divisible"):
        fa.flash_attention_with_lse(q2, q, q, causal=True, block_q=64,
                                    block_k=64)


# ---------------------------------------------------------------------------
# gradients through _Flash and _FlashLse against jax.grad
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", [
    (2, 128, 128, 16, 16, False),
    (2, 128, 128, 16, 16, True),
    (1, 64, 128, 16, 32, False),
])
def test_flash_gradients_match_jax_grad(case):
    BH, Tq, Tk, D, Dv, causal = case
    q, k, v = _qkv(BH, Tq, Tk, D, Dv)
    w = _np(BH, Tq, Dv)

    def jloss(q, k, v):
        return jnp.sum(_j(w) * jpk.flash_attention(
            q, k, v, causal=causal, block_q=32, block_k=32, use_pallas=True,
            interpret=True))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal, block_q=32, block_k=32)
    (out * _t(w)).sum().backward()
    for name, a, b in zip("qkv", leaves, jg):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b),
                                   err_msg=name, **GTOL)


def test_bthd_gradients_match_jax_grad():
    """The [B,T,H,D] route: the cotangent reaches _Flash through the
    moveaxis as a strided view."""
    B, T, H, D = 1, 64, 2, 16
    q, k, v = _np(B, T, H, D), _np(B, T, H, D), _np(B, T, H, D)

    def jloss(q, k, v):
        return jnp.sum(jpk.flash_attention(q, k, v, causal=True, block_q=32,
                                           block_k=32, use_pallas=True,
                                           interpret=True) ** 2)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    (fa.flash_attention(*leaves, causal=True, block_q=32,
                        block_k=32) ** 2).sum().backward()
    for name, a, b in zip("qkv", leaves, jg):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b),
                                   err_msg=name, **GTOL)


@pytest.mark.parametrize("causal", [False, True])
def test_with_lse_gradients_match_jax_grad(causal):
    """Both outputs carry a cotangent: the lse one folds into delta."""
    BH, T, D = 2, 64, 16
    q, k, v = _qkv(BH, T, T, D, D)
    w, wl = _np(BH, T, D), _np(BH, T, 1)

    def jloss(q, k, v):
        out, lse = jpk.flash_attention_with_lse(q, k, v, causal=causal,
                                                block_q=32, block_k=32,
                                                interpret=True)
        return jnp.sum(_j(w) * out) + jnp.sum(_j(wl) * lse)

    jout, jlse = jpk.flash_attention_with_lse(_j(q), _j(k), _j(v), causal,
                                              block_q=32, block_k=32,
                                              interpret=True)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    out, lse = fa.flash_attention_with_lse(*leaves, causal=causal,
                                           block_q=32, block_k=32)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **TOL32)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jlse),
                               **TOL32)
    ((out * _t(w)).sum() + (lse * _t(wl)).sum()).backward()
    for name, a, b in zip("qkv", leaves, jg):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b),
                                   err_msg=name, **GTOL)


def test_reference_route_gradients_match_jax_grad():
    """A ragged length trains through the plain route (autograd)."""
    q, k, v = _qkv(1, 100, 100, 16, 16)

    def jloss(q, k, v):
        return jnp.sum(jpk.flash_attention(q, k, v, causal=True, block_q=64,
                                           block_k=64, use_pallas=True,
                                           interpret=True) ** 2)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    (fa.flash_attention(*leaves, causal=True, block_q=64,
                        block_k=64) ** 2).sum().backward()
    for name, a, b in zip("qkv", leaves, jg):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b),
                                   err_msg=name, **GTOL)


# ---------------------------------------------------------------------------
# no fallback off the CPU; the build helper
# ---------------------------------------------------------------------------
def test_never_falls_back_off_the_cpu():
    """A tensor that is neither on the CPU nor on a CUDA card raises; the
    plain versions are for CPU tensors only."""
    q = torch.empty(1, 64, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, q, q, block_q=64, block_k=64)


def test_shapes_are_checked():
    with pytest.raises(ValueError, match=r"\[BH, T, D\]"):
        fa.flash_fwd(torch.zeros(2, 4), torch.zeros(2, 4), torch.zeros(2, 4))
    with pytest.raises(ValueError, match="inconsistent"):
        fa.flash_fwd(torch.zeros(1, 8, 16), torch.zeros(1, 8, 32),
                     torch.zeros(1, 8, 16))
    with pytest.raises(ValueError, match="feature dim"):
        fa.flash_attention(torch.zeros(1, 8, 16), torch.zeros(1, 8, 32),
                           torch.zeros(1, 8, 16))


def test_build_needs_nvcc():
    if shutil.which("nvcc") is not None:
        pytest.skip("nvcc present: the build is exercised on the card")
    with pytest.raises(RuntimeError, match="nvcc"):
        fa.build()


def test_build_is_keyed_by_content_and_shared(tmp_path, monkeypatch):
    """One helper builds every kernel source: the library is named
    lib<stem>-<content hash>.so with its ptxas report beside it, a second
    build of the same content compiles nothing, and an edited source, or
    an edited header beside it, gets a new library."""
    calls = []
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\nfor a in \"$@\"; do prev=$cur; cur=$a; "
                    "if [ \"$prev\" = \"-o\" ]; then out=$a; fi; done\n"
                    "echo built > \"$out\"\necho 'ptxas info    : Used 1 "
                    "registers'\n")
    fake.chmod(0o755)
    monkeypatch.setattr(cuda_build, "_nvcc",
                        lambda: calls.append(1) or str(fake))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    src = tmp_path / "toy_kernel.cu"
    src.write_text("// v1\n")
    first = cuda_build.build(str(src))
    assert first.startswith(str(tmp_path / "build" / "libtoy_kernel-"))
    assert open(first + ".ptxas.txt").read().count("Used 1 registers") == 1
    assert cuda_build.build(str(src)) == first and len(calls) == 1
    src.write_text("// v2\n")
    second = cuda_build.build(str(src))
    assert second != first and len(calls) == 2
    # the *.cuh headers beside a source are part of its key: a new or
    # edited header alone rebuilds, an unchanged one does not
    hdr = tmp_path / "toy_shared.cuh"
    hdr.write_text("// h1\n")
    third = cuda_build.build(str(src))
    assert third not in (first, second) and len(calls) == 3
    hdr.write_text("// h2\n")
    fourth = cuda_build.build(str(src))
    assert fourth not in (first, second, third) and len(calls) == 4
    assert cuda_build.build(str(src)) == fourth and len(calls) == 4
    # both kernels of the port name their libraries the same way
    assert conv1x1.build().startswith(str(tmp_path / "build" /
                                          "libconv1x1_mm-"))
    assert fa.build().startswith(str(tmp_path / "build" / "libflash_attn-"))


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def test_smoke_rule_scales_per_tile():
    """chip_smoke.py's rule takes its scale per 64-row tile: under the
    causal mask the first rows are the largest, so a rule scaled by the
    whole tensor's maximum passes late rows 10% off; the per-tile rule
    fails them, and passes a result 1e-3 off everywhere (tol 2e-2)."""
    from chip_smoke import att_close
    q, k, v, g = (_t(_np(2, 1000, 64)) for _ in range(4))
    out, lse = fa.flash_fwd_reference(q, k, v, True)
    for want in (out, *fa.flash_bwd_reference(q, k, v, out, lse, g, True)):
        att_close("near", want * (1 + 1e-3), want, 2e-2)
        bad = want.clone()
        bad[:, 750:] *= 0.9
        wide = 2e-2 * (want.abs() + want.abs().max())
        assert bool(((bad - want).abs() <= wide).all())
        with pytest.raises(RuntimeError, match="element"):
            att_close("late rows", bad, want, 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [
    (2, 128, 128, 64, 64, True),
    (2, 100, 100, 64, 64, True),          # ragged tiles inside the kernel
    (3, 200, 130, 32, 48, False),
    (2, 256, 256, 128, 128, True),
    (2, 300, 200, 64, 32, True),          # causal, Tq != Tk (top-left)
    (2, 200, 200, 96, 128, True),         # width 128, ragged tiles
])
def test_kernels_match_plain_on_card(cuda_device, case, dtype):
    from chip_smoke import att_close
    BH, Tq, Tk, D, Dv, causal = case
    dt = getattr(torch, dtype)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def rn(*s, dtype=dt):
        return torch.randn(*s, device=cuda_device, generator=g).to(dtype)

    q, k, v = rn(BH, Tq, D), rn(BH, Tk, D), rn(BH, Tk, Dv)
    fa.reset_counts()
    out, lse = fa.flash_fwd(q, k, v, causal)
    ro, rl = fa.flash_fwd_reference(q, k, v, causal)
    gg, gl = rn(BH, Tq, Dv), rn(BH, Tq, 1, dtype=torch.float32)
    grads = fa.flash_bwd(q, k, v, out, lse, gg, causal, g_lse=gl)
    refs = fa.flash_bwd_reference(q, k, v, out, lse, gg, causal, g_lse=gl)
    torch.cuda.synchronize()
    assert dict(fa.launches) == {"fwd": 1, "bwd_dq": 1, "bwd_dkv": 1}
    tol = 1e-4 if dt == torch.float32 else 2e-2
    att_close("out", out, ro, tol)
    assert (lse - rl).abs().max().item() <= 1e-3
    for a, b in zip(grads, refs):
        assert a.dtype == dt
        att_close("grad", a, b, tol)
    # each block owns its output rows (no atomics): runs are bit-equal
    again = fa.flash_fwd(q, k, v, causal)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    again = fa.flash_bwd(q, k, v, out, lse, gg, causal, g_lse=gl)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.cuda
def test_forward_takes_a_negative_scale_on_card(cuda_device):
    """The bf16 forward keeps its running max as max(s) * scale, so the
    wrapper hands it -q and -scale for a negative scale: the same scores,
    held to the plain version."""
    from chip_smoke import att_close
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = (torch.randn(2, 256, 64, device=cuda_device,
                           generator=g).to(torch.bfloat16) for _ in range(3))
    out, lse = fa.flash_fwd(q, k, v, True, sm_scale=-0.2)
    ro, rl = fa.flash_fwd_reference(q, k, v, True, sm_scale=-0.2)
    att_close("negative scale", out, ro, 2e-2)
    assert (lse - rl).abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_kernels_refuse_other_head_sizes(cuda_device):
    """Head sizes above 128 raise on a card (24 now runs padded)."""
    q = torch.zeros(1, 64, 144, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="129-256"):
        fa.flash_fwd(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D,Dv", [(40, 40), (72, 72), (24, 120)])
def test_padded_heads_launch_the_kernels_on_card(cuda_device, D, Dv, dt):
    """A head size no multiple of 16 runs K2, K3 and K4 once each on the
    padded operands, held against the plain version at the true size."""
    from chip_smoke import att_close
    g = torch.Generator(device=cuda_device).manual_seed(3)

    def rn(*shape):
        return torch.randn(*shape, device=cuda_device, generator=g).to(dt)

    q, k, v, gg = rn(2, 512, D), rn(2, 512, D), rn(2, 512, Dv), \
        rn(2, 512, Dv)
    fa.reset_counts()
    out, lse = fa.flash_fwd(q, k, v, True)
    grads = fa.flash_bwd(q, k, v, out, lse, gg, True)
    ro, rl = fa.flash_fwd_reference(q, k, v, True)
    refs = fa.flash_bwd_reference(q, k, v, out, lse, gg, True)
    torch.cuda.synchronize()
    assert dict(fa.launches) == {"fwd": 1, "bwd_dq": 1, "bwd_dkv": 1}
    tol = 1e-4 if dt == torch.float32 else 2e-2
    att_close("out", out, ro, tol)
    assert (lse - rl).abs().max().item() <= 1e-3
    for a, b in zip(grads, refs):
        assert a.shape == b.shape and a.dtype == dt
        att_close("grad", a, b, tol)
