"""1x1 convolution as a matrix product, on a hand-written CUDA kernel.

Counterpart of ``paddle_tpu/ops/pallas_conv.py`` (forward only).  A 1x1
convolution IS a matrix product over the pixel dimension: x [N,C,H,W]
viewed as [P, C] (P = N*H*W) against the filter [M, C]::

    out[P, M] = x[P, C] @ w[M, C]^T        (mm with ta=False, tb=True)

:func:`mm` is the wrapper of ``csrc/conv1x1_mm.cu`` (the Hopper port of
the Pallas ``_mm_kernel``, ``pallas_conv.py:69``).  On CUDA tensors it
launches that kernel or raises; on CPU tensors it computes the plain
PyTorch version, :func:`mm_reference`.  ``mm.launches`` counts kernel
launches (never the plain path).

The kernel is compiled from the package's sources with ``nvcc`` at first
use into ``build/`` at the repository root, and bound with ``ctypes``
(a plain C interface; no PyTorch headers).  The epilogues and the VJP
of the JAX kernel belong to training and are not ported yet.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

__all__ = ["mm", "mm_reference", "conv2d_1x1", "conv2d_1x1_reference",
           "conv1x1_eligible", "build", "SOURCE"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "conv1x1_mm.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535            # the kernel puts M tiles on gridDim.y
_MIN_M_TILE = 64               # the fp32 kernel's tile (bf16: 128)

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "conv1x1_mm: nvcc not found (PATH, $CUDA_HOME/bin, "
        "/usr/local/cuda/bin); the CUDA toolkit is needed to build the "
        "kernel for a CUDA tensor")


def build() -> str:
    """Compile ``csrc/conv1x1_mm.cu`` for sm_90a into ``build/`` (keyed by
    the source's content hash, so an edited source rebuilds) and return
    the library's path.  The compiler's ``-Xptxas -v`` report (registers,
    shared memory, spills per kernel) is kept beside it, in
    ``<library>.ptxas.txt``."""
    with open(SOURCE, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"libconv1x1_mm-{digest}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [_nvcc()] + NVCC_FLAGS + ["-Xptxas", "-v", "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"conv1x1_mm: nvcc failed ({proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    with open(path + ".ptxas.txt", "w") as fh:
        fh.write(proc.stdout + proc.stderr)
    os.replace(tmp, path)
    return path


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.conv1x1_mm.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            lib.conv1x1_mm.restype = ctypes.c_int
            lib.conv1x1_mm_error_string.argtypes = [ctypes.c_int]
            lib.conv1x1_mm_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


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


def mm_reference(a, b, ta=False, tb=False, out_dtype=None):
    """Plain PyTorch version of :func:`mm`: fp32 accumulation, output
    rounded to ``out_dtype`` (default: A's dtype), as the kernel does."""
    _dims(a, b, ta, tb)
    A = a.t() if ta else a
    B = b.t() if tb else b
    return torch.matmul(A.float(), B.float()).to(out_dtype or a.dtype)


def mm(a, b, ta=False, tb=False, out_dtype=None):
    """O[M,N] = op(A) @ op(B), op = transpose where ``ta``/``tb``.

    CUDA tensors run the hand-written kernel (fp32 or bf16 inputs of one
    dtype, contiguous, fp32 accumulation; output ``out_dtype``, default
    A's dtype) and anything it does not take raises.  CPU tensors run
    :func:`mm_reference`."""
    M, N, K = _dims(a, b, ta, tb)
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mm_reference(a, b, ta, tb, out_dtype)
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
    if (M + _MIN_M_TILE - 1) // _MIN_M_TILE > _MAX_GRID_Y or \
            max(M, N, K) >= 2 ** 31:
        raise ValueError(f"mm: shape M={M} N={N} K={K} exceeds the "
                         f"kernel's grid")
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.conv1x1_mm(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                            M, N, K, int(ta), int(tb), _DTYPE_CODES[a.dtype],
                            _DTYPE_CODES[out_dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"conv1x1_mm launch failed: CUDA error {rc} "
            f"({lib.conv1x1_mm_error_string(rc).decode()}) at M={M} N={N} "
            f"K={K} ta={ta} tb={tb} {a.dtype}->{out_dtype}")
    mm.launches += 1
    return out


mm.launches = 0


# ---------------------------------------------------------------------------
# 1x1 convolution on the matrix view
# ---------------------------------------------------------------------------
def _to_pixel_major(x):
    """[N, C, H, W] -> contiguous [N*H*W, C]."""
    N, C, H, W = x.shape
    return x.reshape(N, C, H * W).permute(0, 2, 1).reshape(-1, C), (N, H, W)


def _from_pixel_major(om, dims, M):
    N, H, W = dims
    return om.reshape(N, H * W, M).permute(0, 2, 1).reshape(N, M, H, W)


def conv2d_1x1(x, w, strides=(1, 1)):
    """NCHW 1x1 convolution (pad 0, dil 1, groups 1) through :func:`mm`:
    stride slice, pixel-major view, kernel, back to NCHW."""
    sh, sw = int(strides[0]), int(strides[1])
    if (sh, sw) != (1, 1):
        x = x[:, :, ::sh, ::sw]
    xm, dims = _to_pixel_major(x)
    M = w.shape[0]
    om = mm(xm, w.reshape(M, -1).contiguous(), False, True)
    return _from_pixel_major(om, dims, M)


def conv2d_1x1_reference(x, w, strides=(1, 1)):
    """Plain PyTorch version of :func:`conv2d_1x1` (fp32 accumulation,
    output in x's dtype)."""
    sh, sw = int(strides[0]), int(strides[1])
    xs = x[:, :, ::sh, ::sw].float()
    wm = w.reshape(w.shape[0], -1).float()
    return torch.einsum("nchw,mc->nmhw", xs, wm).to(x.dtype)


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
