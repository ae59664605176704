"""1x1 convolution as a matrix product, on a hand-written CUDA kernel.

Counterpart of ``paddle_tpu/ops/pallas_conv.py``.  A 1x1 convolution IS
a matrix product over the pixel dimension: x [N,C,H,W] viewed as [P, C]
(P = N*H*W) against the filter [M, C], and its three passes are one
blocked product with transpose options::

    forward:  out[P, M] = x[P, C]    @ w[M, C]^T     (ta=False, tb=True)
    dgrad:    dx[P, C]  = gout[P, M] @ w[M, C]       (ta=False, tb=False)
    wgrad:    dw[M, C]  = gout[P, M]^T @ x[P, C]     (ta=True,  tb=False)

:func:`mm` is the wrapper of ``csrc/conv1x1_mm.cu`` (the Hopper port of
the Pallas ``_mm_kernel``, ``pallas_conv.py:69``, with its ``out_stats``
and ``a_colsum`` epilogues).  The wgrad's K = P runs to 401408 at
ResNet-50's shapes while its output is a handful of tiles, so that form
splits K across blocks (:func:`split_k`) and a second kernel sums the
slabs.  On CUDA tensors :func:`mm` launches the kernels or raises; on
CPU tensors it computes the plain PyTorch version, :func:`mm_reference`.
``mm.by_form`` counts every kernel launch by form (``forward``,
``dgrad``, ``wgrad``, ``ta_tb``, ``+out_stats``/``+a_colsum`` for the
epilogues, ``splitk_reduce`` for the second pass), never the plain path;
:func:`launches` is the number of product launches (every form but the
second pass).

:func:`matmul` is the differentiable product (``pallas_matmul``'s
counterpart): an autograd Function whose backward runs :func:`mm` with
the transposes of ``_pm_bwd`` (``pallas_conv.py:235-246``), so
:func:`conv2d_1x1` trains through the kernel.

The kernel is compiled from the package's sources with ``nvcc`` at first
use into ``build/`` at the repository root, and bound with ``ctypes``
(a plain C interface; no PyTorch headers), by ``ops/cuda_build.py``.
"""
from __future__ import annotations

import collections
import ctypes
import os

import torch

from . import cuda_build

__all__ = ["mm", "mm_reference", "matmul", "split_k", "splitk_reduce",
           "splitk_reduce_reference", "conv2d_1x1",
           "conv2d_1x1_reference", "conv2d_1x1_with_bn_stats",
           "conv2d_1x1_grad_fused", "conv1x1_eligible", "launches",
           "reset_counts",
           "build", "SOURCE"]

SOURCE = os.path.join(cuda_build.CSRC_DIR, "conv1x1_mm.cu")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TILE = {torch.bfloat16: 128, torch.float32: 64}   # the kernels' M/N tile
_MAX_GRID_Y = 65535            # the kernel puts M tiles on gridDim.y
_FORMS = {(False, True): "forward", (False, False): "dgrad",
          (True, False): "wgrad", (True, True): "ta_tb"}

# Split-K rule (the wgrad form, ta=True tb=False, only): aim for
# _BLOCKS_PER_SM blocks per SM, i.e. S = ceil(2 * SMs / tiles) slabs,
# but give every slab at least _MIN_SLAB_K of K (16 bf16 K steps) so the
# partials' extra traffic stays small against the operands'; slabs are
# whole multiples of the kernel's K step (32).  At batch 128 on an H100
# (132 SMs) this gives S = 131 slabs of 3072 for the 2-tile [128, 256]
# wgrad at P = 401408 and S = 3 for the 128-tile [2048, 1024] one at
# P = 6272.
_BLOCKS_PER_SM = 2
_MIN_SLAB_K = 512
_K_STEP = 32

_sm_counts = {}


def build() -> str:
    """Compile ``csrc/conv1x1_mm.cu`` for sm_90a into ``build/`` (keyed by
    the source's content hash, so an edited source rebuilds) and return
    the library's path; ``cuda_build.build`` keeps the ``-Xptxas -v``
    report beside it, in ``<library>.ptxas.txt``."""
    return cuda_build.build(SOURCE)


def _library():
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return cuda_build.load(SOURCE, {
        "conv1x1_mm": ([ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32,
                        i32, i32, ptr, ptr, ptr, ptr, ptr], i32),
        "conv1x1_mm_splitk_reduce": ([ptr, i32, ctypes.c_longlong, ptr, i32,
                                      ptr, ptr, i32, ptr], i32),
        "conv1x1_mm_error_string": ([i32], ctypes.c_char_p),
    })


def _dims(a, b, ta, tb):
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"mm: 2-D operands required, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    M, K = (a.shape[1], a.shape[0]) if ta else (a.shape[0], a.shape[1])
    N, Kb = (b.shape[0], b.shape[1]) if tb else (b.shape[1], b.shape[0])
    if K != Kb:
        raise ValueError(f"mm: contraction dims differ: op(A) is [{M},{K}], "
                         f"op(B) is [{Kb},{N}] (ta={ta}, tb={tb})")
    return int(M), int(N), int(K)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_k(M: int, N: int, K: int, dtype, sms: int):
    """(splits, kchunk) of the wgrad form: ``splits`` slabs of ``kchunk``
    (a multiple of 32) along K, by the rule stated at ``_BLOCKS_PER_SM``;
    every slab holds at least one K value."""
    tile = _TILE[dtype]
    tiles = _cdiv(M, tile) * _cdiv(N, tile)
    splits = max(1, min(_cdiv(_BLOCKS_PER_SM * sms, tiles),
                        K // _MIN_SLAB_K))
    kchunk = max(_K_STEP, _cdiv(_cdiv(K, splits), _K_STEP) * _K_STEP)
    return max(1, _cdiv(K, kchunk)), kchunk


def _sm_count(device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


def mm_reference(a, b, ta=False, tb=False, out_dtype=None, out_stats=False,
                 a_colsum=False):
    """Plain PyTorch version of :func:`mm`: fp32 accumulation, output
    rounded to ``out_dtype`` (default: A's dtype), as the kernel does;
    with the same epilogue outputs (fp32 sums over the fp32 product's
    rows, and over K of logical A)."""
    _dims(a, b, ta, tb)
    if a_colsum and not ta:
        raise ValueError("mm: the a_colsum epilogue is the wgrad (ta=True) "
                         "path")
    A = (a.t() if ta else a).float()
    B = (b.t() if tb else b).float()
    prod = torch.matmul(A, B)
    res = [prod.to(out_dtype or a.dtype)]
    if out_stats:
        res += [prod.sum(0), (prod * prod).sum(0)]
    if a_colsum:
        res.append(A.sum(1))
    return res[0] if len(res) == 1 else tuple(res)


def _check_rc(lib, rc, what):
    if rc != 0:
        raise RuntimeError(
            f"conv1x1_mm launch failed: CUDA error {rc} "
            f"({lib.conv1x1_mm_error_string(rc).decode()}) at {what}")


def mm(a, b, ta=False, tb=False, out_dtype=None, out_stats=False,
       a_colsum=False):
    """O[M,N] = op(A) @ op(B), op = transpose where ``ta``/``tb``.

    CUDA tensors run the hand-written kernel (fp32 or bf16 inputs of one
    dtype, contiguous, fp32 accumulation; output ``out_dtype``, default
    A's dtype) and anything it does not take raises.  CPU tensors run
    :func:`mm_reference`.  ``out_stats`` also returns the fp32 sum and
    sum of squares of each output column ([N] each); ``a_colsum`` (wgrad
    form only) the fp32 sum over K of each row of logical A ([M]).
    The result is ``O``, or a tuple ``(O, sum, sumsq)``, ``(O, csum)``
    or ``(O, sum, sumsq, csum)``."""
    M, N, K = _dims(a, b, ta, tb)
    out_dtype = out_dtype or a.dtype
    if a_colsum and not ta:
        raise ValueError("mm: the a_colsum epilogue is the wgrad (ta=True) "
                         "path")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mm_reference(a, b, ta, tb, out_dtype, out_stats, a_colsum)
    if a.device.type != "cuda" or a.device != b.device:
        raise ValueError(f"mm: operands must share one CUDA device (or both "
                         f"lie on the CPU), got {a.device} and {b.device}")
    if a.dtype not in _DTYPE_CODES or b.dtype != a.dtype:
        raise TypeError(f"mm: kernel takes fp32 or bf16 operands of one "
                        f"dtype, got {a.dtype} and {b.dtype}")
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"mm: out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("mm: kernel takes contiguous operands")
    tile = _TILE[a.dtype]
    if -(-M // tile) > _MAX_GRID_Y or max(M, N, K) >= 2 ** 31:
        raise ValueError(f"mm: shape M={M} N={N} K={K} exceeds the "
                         f"kernel's grid")
    dev = a.device
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    splits, kchunk = 1, max(K, 1)
    if ta and not tb and not out_stats:
        splits, kchunk = split_k(M, N, K, a.dtype, _sm_count(dev))
    work = torch.empty((splits, M, N), **f32) if splits > 1 else None
    col_sum = col_sq = csum = None
    if out_stats:
        col_sum = torch.empty((-(-M // tile), N), **f32)
        col_sq = torch.empty_like(col_sum)
    if a_colsum:
        csum = torch.empty((splits, M), **f32)
    if out.numel() == 0:
        return out

    def ptr(t):
        return t.data_ptr() if t is not None else None

    form = _FORMS[(bool(ta), bool(tb))] + \
        ("+out_stats" if out_stats else "") + ("+a_colsum" if a_colsum else "")
    what = (f"M={M} N={N} K={K} ta={ta} tb={tb} splits={splits} "
            f"{a.dtype}->{out_dtype}")
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.conv1x1_mm(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                            M, N, K, int(ta), int(tb), _DTYPE_CODES[a.dtype],
                            _DTYPE_CODES[out_dtype], splits, kchunk,
                            ptr(work), ptr(col_sum), ptr(col_sq), ptr(csum),
                            stream)
        _check_rc(lib, rc, what)
        mm.by_form[form] += 1
    if splits > 1:
        out, csum = splitk_reduce(work, out_dtype, csum, out=out)
    res = [out]
    if out_stats:
        res += [col_sum.sum(0), col_sq.sum(0)]
    if a_colsum:
        res.append(csum.reshape(M))
    return res[0] if len(res) == 1 else tuple(res)


mm.by_form = collections.Counter()


def splitk_reduce_reference(work, out_dtype, csum_work=None):
    """Plain PyTorch version of :func:`splitk_reduce`."""
    out = work.sum(0).to(out_dtype)
    return out, (csum_work.sum(0) if csum_work is not None else None)


def splitk_reduce(work, out_dtype, csum_work=None, out=None):
    """The split-K second pass: (out [M, N] = sum over slabs of the fp32
    partials ``work`` [S, M, N], rounded once to ``out_dtype``; the sum
    over slabs of the a_colsum partials ``csum_work`` [S, M], or None).
    Each element sums its S partials in slab order, so the result does
    not depend on the schedule.  CUDA tensors run the kernel (counted in
    ``mm.by_form["splitk_reduce"]``), CPU tensors the plain version."""
    S, M, N = work.shape
    if work.device.type == "cpu":
        return splitk_reduce_reference(work, out_dtype, csum_work)
    if work.device.type != "cuda" or work.dtype != torch.float32 or \
            not work.is_contiguous() or out_dtype not in _DTYPE_CODES:
        raise ValueError(f"splitk_reduce: takes contiguous fp32 partials on "
                         f"a CUDA device and a float32/bfloat16 output, got "
                         f"{work.dtype} on {work.device} -> {out_dtype}")
    if csum_work is not None and (csum_work.shape != (S, M) or
                                  csum_work.dtype != torch.float32 or
                                  not csum_work.is_contiguous()):
        raise ValueError(f"splitk_reduce: csum partials must be contiguous "
                         f"fp32 [{S}, {M}], got {tuple(csum_work.shape)}")
    if out is None:
        out = torch.empty((M, N), dtype=out_dtype, device=work.device)
    csum = torch.empty(M, dtype=torch.float32, device=work.device) \
        if csum_work is not None else None
    lib = _library()
    with torch.cuda.device(work.device):
        rc = lib.conv1x1_mm_splitk_reduce(
            work.data_ptr(), S, M * N, out.data_ptr(), _DTYPE_CODES[out_dtype],
            csum_work.data_ptr() if csum is not None else None,
            csum.data_ptr() if csum is not None else None, M,
            torch.cuda.current_stream(work.device).cuda_stream)
    _check_rc(lib, rc, f"splitk_reduce S={S} M={M} N={N}")
    mm.by_form["splitk_reduce"] += 1
    return out, csum


def launches() -> int:
    """Product launches of :func:`mm` since the last :func:`reset_counts`:
    the sum of ``mm.by_form`` over every form but ``splitk_reduce``."""
    return sum(n for form, n in mm.by_form.items()
               if form != "splitk_reduce")


def reset_counts():
    """Set every ``mm.by_form`` count to 0."""
    mm.by_form.clear()


# ---------------------------------------------------------------------------
# differentiable product: the backward runs the same kernel (dgrad/wgrad)
# ---------------------------------------------------------------------------
class _Matmul(torch.autograd.Function):
    """``pallas_matmul``'s custom VJP (``pallas_conv.py:220-249``): the
    gradients are the same blocked product with the transposes of
    ``_pm_bwd``, each rounded to its operand's dtype (bf16 under AMP)."""

    @staticmethod
    def forward(ctx, a, b, ta, tb):
        ctx.save_for_backward(a, b)
        ctx.ta, ctx.tb = ta, tb
        return mm(a, b, ta, tb)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ta, tb = ctx.ta, ctx.tb
        # a cotangent that arrives through a permute is a strided view
        g = g.contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            if not ta:      # da_storage [M, K] = g @ B_logical^T
                da = mm(g, b, False, not tb)
            else:           # da_storage [K, M] = B_logical @ g^T
                da = mm(b, g, tb, True)
            da = da.to(a.dtype)
        if ctx.needs_input_grad[1]:
            if not tb:      # db_storage [K, N] = A_logical^T @ g
                db = mm(a, g, not ta, False)
            else:           # db_storage [N, K] = g^T @ A_logical (wgrad)
                db = mm(g, a, True, ta)
            db = db.to(b.dtype)
        return da, db, None, None


def matmul(a, b, trans_a=False, trans_b=False):
    """O = op(A) @ op(B) through :func:`mm`, differentiable: the backward
    runs :func:`mm` too (``pallas_matmul``'s counterpart)."""
    return _Matmul.apply(a, b, bool(trans_a), bool(trans_b))


# ---------------------------------------------------------------------------
# 1x1 convolution on the matrix view
# ---------------------------------------------------------------------------
def _to_pixel_major(x):
    """[N, C, H, W] -> contiguous [N*H*W, C]."""
    N, C, H, W = x.shape
    xm = x.reshape(N, C, H * W).permute(0, 2, 1).reshape(-1, C)
    return xm.contiguous(), (N, H, W)


def _from_pixel_major(om, dims, M):
    N, H, W = dims
    return om.reshape(N, H * W, M).permute(0, 2, 1).reshape(N, M, H, W)


def _strided(x, strides):
    sh, sw = int(strides[0]), int(strides[1])
    return x[:, :, ::sh, ::sw] if (sh, sw) != (1, 1) else x


def conv2d_1x1(x, w, strides=(1, 1)):
    """NCHW 1x1 convolution (pad 0, dil 1, groups 1) through
    :func:`matmul`: stride slice, pixel-major view, kernel, back to NCHW.
    Differentiable: autograd carries the input gradient back through the
    views and the stride slice, as jnp autodiff does in the JAX wrapper."""
    xm, dims = _to_pixel_major(_strided(x, strides))
    M = w.shape[0]
    om = matmul(xm, w.reshape(M, -1).contiguous(), False, True)
    return _from_pixel_major(om, dims, M)


def conv2d_1x1_reference(x, w, strides=(1, 1)):
    """Plain PyTorch version of :func:`conv2d_1x1` (fp32 accumulation,
    output in x's dtype)."""
    xs = _strided(x, strides).float()
    wm = w.reshape(w.shape[0], -1).float()
    return torch.einsum("nchw,mc->nmhw", xs, wm).to(x.dtype)


def conv2d_1x1_with_bn_stats(x, w, strides=(1, 1)):
    """Forward 1x1 conv with the fused BN-statistics epilogue
    (``pallas_conv.py:285-301``): returns (out [N,M,H,W], csum [M],
    csumsq [M]), the per-out-channel fp32 sum and sum of squares over
    N, H, W of the fp32 product, taken before it is rounded."""
    xm, dims = _to_pixel_major(_strided(x, strides))
    M = w.shape[0]
    om, csum, csq = mm(xm, w.reshape(M, -1).contiguous(), False, True,
                       out_stats=True)
    return _from_pixel_major(om, dims, M), csum, csq


def conv2d_1x1_grad_fused(x, w, gout, strides=(1, 1)):
    """The 1x1-conv gradient pass (``pallas_conv.py:304-324``): (dx, dw,
    dsum) from one dgrad launch and one split-K wgrad launch whose
    a_colsum epilogue gives dsum = sum over N, H, W of gout (the bias /
    BN-beta gradient).  ``gout`` is [N, M, OH, OW] in the conv's output
    geometry."""
    sh, sw = int(strides[0]), int(strides[1])
    xm, dims = _to_pixel_major(_strided(x, strides))
    gm, _ = _to_pixel_major(gout)
    M, C = w.shape[0], w.shape[1]
    wm = w.reshape(M, C).contiguous()
    # dgrad: dx [P, C] = gout [P, M] @ w [M, C]
    dx = _from_pixel_major(mm(gm, wm, False, False), dims, C)
    if (sh, sw) != (1, 1):
        full = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
        full[:, :, ::sh, ::sw] = dx
        dx = full
    # wgrad (+ fused dsum): dw [M, C] = gout^T @ x, K = P split
    dw, dsum = mm(gm, xm, True, False, a_colsum=True)
    return dx, dw.reshape(w.shape).to(w.dtype), dsum.reshape(M)


def conv1x1_eligible(x_shape, w_shape, strides, pads, dils, groups) -> bool:
    """Static routing gate, the same as ``pallas_conv.conv1x1_eligible``:
    1x1 / groups 1 / pad 0 / dil 1 convolutions whose matrix-view dims
    (P, C, M) are all divisible by 128.  ResNet's 1x1 convs qualify from
    the 128-channel stage on; stage 1's 64-channel convs stay plain."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    if tuple(w_shape[2:]) != (1, 1) or int(groups or 1) != 1:
        return False
    if tuple(pads) != (0, 0) or tuple(dils) != (1, 1):
        return False
    N, C, H, W = x_shape
    M = w_shape[0]
    sh, sw = int(strides[0]), int(strides[1])
    P = N * ((H - 1) // sh + 1) * ((W - 1) // sw + 1)
    return C % 128 == 0 and M % 128 == 0 and P % 128 == 0
