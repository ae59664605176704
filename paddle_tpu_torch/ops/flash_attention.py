"""Flash attention on hand-written CUDA kernels (counterpart of the
flash-attention half of ``paddle_tpu/ops/pallas_kernels.py``).

:func:`flash_fwd` and :func:`flash_bwd` wrap ``csrc/flash_attn.cu``, the
Hopper port of the three Pallas kernels (:func:`flash_bwd_dq` and
:func:`flash_bwd_dkv` launch the two backward kernels one at a time):

    fwd      _flash_kernel (pallas_kernels.py:56)          -> out, lse
    bwd_dq   _flash_bwd_dq_kernel (:150)                   -> dq
    bwd_dkv  _flash_bwd_dkv_kernel (:195)                  -> dk, dv

The bf16 kernels take their launch from :func:`fwd_plan` and
:func:`bwd_plan` (rows a block owns, tile, ring stages, shared memory,
grid, the order of the blocks), and :func:`fwd_walk` and
:func:`bwd_walk` model the tiles each block visits, so the CPU tests
check them.  On CUDA tensors they launch the kernels or raise; on CPU
tensors they compute the plain versions, :func:`flash_fwd_reference` and
:func:`flash_bwd_reference`.  ``delta = rowsum(dO * out) - g_lse``
(``:254-261``) stays plain PyTorch outside the kernels, as the JAX
package leaves it to XLA.  ``launches`` counts kernel launches by name
(``fwd``, ``bwd_dq``, ``bwd_dkv``), never the plain versions, and
``launches_by_dtype`` by (name, dtype of q); ``reference_route``
counts the calls that :func:`flash_attention` routes to
:func:`attention_reference` by shape, by reason (``ragged``,
``causal_cross``).

:func:`flash_attention` and :func:`flash_attention_with_lse` keep the
JAX public layouts (``[B, T, H, D]`` or ``[BH, T, D]``; lse
``[BH, Tq, 1]``) and are differentiable through ``_Flash`` and
``_FlashLse``, whose backward runs the two backward kernels.  The
``flash_attention`` op is registered here; it has no sequence-parallel
(ring attention) routing yet, and its ``interpret`` attribute, which
runs the Pallas interpreter in the JAX package, is accepted and
ignored: CPU tensors take the plain versions.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import os

import torch
import torch.nn.functional as F

from ..core.compile_cache import register_launch_counter
from ..core.registry import register_op, register_tunable
from . import cuda_build

__all__ = ["NEG_INF", "flash_fwd", "flash_bwd", "flash_bwd_dq",
           "flash_bwd_dkv", "flash_delta", "fwd_plan", "fwd_walk",
           "bwd_plan", "bwd_walk", "FwdPlan", "BwdPlan", "KernelPlan",
           "flash_fwd_reference", "flash_bwd_reference",
           "attention_reference", "flash_attention",
           "flash_attention_with_lse", "launches", "launches_by_dtype",
           "launches_by_stages", "reference_route", "padded_head",
           "padded_fwd", "padded_bwd", "flash_attention_fwd",
           "reset_counts", "build", "SOURCE"]

NEG_INF = -1e30                     # pallas_kernels.py:38
SOURCE = os.path.join(cuda_build.CSRC_DIR, "flash_attn.cu")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# query rows per step of the plain versions: a 2048-row chunk of fp32
# scores at 8 heads x 65536 keys is 4.3 GB
_CHUNK = 2048

# The bf16 backward kernels' launch (csrc/flash_attn.cu, K3 and K4): a
# block of a producer warpgroup and two consumer warpgroups owns BWD_ROWS
# rows (64 a warpgroup); the other operands stream through a ring of up
# to BWD_MAX_STAGES stages, BWD_TILE rows a tile, in an SM's shared
# memory (SMEM_LIMIT bytes a block on an H100).
BWD_ROWS = 128
BWD_TILE = 64
BWD_MAX_STAGES = 4
# K3 fails with an unspecified launch failure on a backward ring of 1
# stage on the H100 (PERF.md): csrc/flash_attn.cu's launcher refuses a
# depth below BWD_MIN_STAGES (kBwdMinStages), and an explicit one is
# refused here before launch
BWD_MIN_STAGES = 2
SMEM_LIMIT = 232448
# The bf16 forward (K2) takes the same block: BWD_ROWS query rows, two
# consumer warpgroups, a producer warpgroup; K and V stream through a
# ring of up to FWD_MAX_STAGES stages in tiles of FWD_TILE[width] keys.
FWD_TILE = {64: 128, 128: 64}
FWD_MIN_STAGES = 2
FWD_MAX_STAGES = 4

launches = register_launch_counter(collections.Counter(), name="flash_attn")
launches_by_dtype = register_launch_counter(
    collections.Counter(), name="flash_attn.dtype", kind="detail")
# bf16 launches by (kernel, ring stages): the plan a launch took
launches_by_stages = register_launch_counter(
    collections.Counter(), name="flash_attn.stages", kind="detail")
reference_route = register_launch_counter(collections.Counter())


def reset_counts():
    """Set every count of ``launches``, ``launches_by_dtype``,
    ``launches_by_stages`` and ``reference_route`` to 0."""
    launches.clear()
    launches_by_dtype.clear()
    launches_by_stages.clear()
    reference_route.clear()


def build() -> str:
    """Compile ``csrc/flash_attn.cu`` into ``build/``; the library's path."""
    return cuda_build.build(SOURCE)


def _library():
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dims = [i32, i32, i32, i32, i32, i32, f32, i32]
    launch = [i32, i32, i32]          # a bf16 plan: rows, stages, smem
    return cuda_build.load(SOURCE, {
        "flash_attn_fwd": ([ptr] * 5 + dims + launch + [ptr], i32),
        "flash_attn_bwd_dq": ([ptr] * 7 + dims + launch + [ptr], i32),
        "flash_attn_bwd_dkv": ([ptr] * 8 + dims + launch + [ptr], i32),
        "flash_attn_error_string": ([i32], ctypes.c_char_p),
    })


def _cdiv(a, b):
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """One bf16 kernel's launch: ``rows`` a block owns (query rows for
    ``fwd`` and ``bwd_dq``, key rows for ``bwd_dkv``), ``tile`` rows of
    each streamed tile, ``stages`` of the ring, ``smem`` bytes of dynamic
    shared memory, ``grid`` blocks, and the ``order`` in which blocks take
    their rows (block b: head b % BH, row block b // BH counted from the
    longest walk)."""
    kernel: str
    rows: int
    tile: int
    stages: int
    smem: int
    grid: int
    order: str = "longest first"


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """The bf16 backward launch for one shape (see :func:`bwd_plan`):
    ``width`` the padded head size the kernels are built for (64 or 128),
    ``dq`` and ``dkv`` each kernel's :class:`KernelPlan`."""
    BH: int
    Tq: int
    Tk: int
    D: int
    Dv: int
    causal: bool
    width: int
    dq: KernelPlan
    dkv: KernelPlan


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """The bf16 forward launch for one shape (see :func:`fwd_plan`):
    ``width`` the padded head size the kernel is built for (64 or 128),
    ``fwd`` its :class:`KernelPlan`."""
    BH: int
    Tq: int
    Tk: int
    D: int
    Dv: int
    causal: bool
    width: int
    fwd: KernelPlan


_WIDE_HEADS = ("head sizes above 128 need a width-256 variant of K2-K4 "
               "(ROADMAP.md Queue A, \"flash attention at head sizes "
               "129-256\")")


def _check_heads(what, D, Dv):
    for name, d in (("D", D), ("Dv", Dv)):
        if d % 16 or not 16 <= d <= 128:
            raise ValueError(f"{what}: the kernels take head sizes that "
                             f"are multiples of 16 up to 128 (the wrappers "
                             f"pad smaller ones; {_WIDE_HEADS}), got "
                             f"{name}={d}")
    return 64 if max(D, Dv) <= 64 else 128


def padded_head(d: int) -> int:
    """The head size the kernels run for a true size ``d``: the next
    multiple of 16 (at least 16).  Raises above 128."""
    if d > 128:
        raise ValueError(f"flash attention: head size {d}: {_WIDE_HEADS}")
    return max(16, -(-int(d) // 16) * 16)


def _pad_heads(t, width):
    """``t`` [BH, T, d] with zero columns up to ``width``, contiguous."""
    return F.pad(t, (0, width - t.shape[-1])).contiguous() \
        if t.shape[-1] != width else t


def padded_fwd(fwd, q, k, v, causal, sm_scale):
    """(out, lse) of ``fwd`` (the forward kernel's wrapper, or its plain
    version) run on q and k padded with zero columns to
    ``padded_head(D)`` and v to ``padded_head(Dv)``, the padding sliced
    off ``out``.  Exact: zero columns add nothing to q.k and give zero
    output columns; ``sm_scale`` is the caller's, of the true D."""
    D, Dv = q.shape[-1], v.shape[-1]
    Dp, Dvp = padded_head(D), padded_head(Dv)
    out, lse = fwd(_pad_heads(q, Dp), _pad_heads(k, Dp), _pad_heads(v, Dvp),
                   causal, sm_scale)
    return out[..., :Dv].contiguous(), lse


def padded_bwd(bwd, q, k, v, out, lse, g, causal, sm_scale, g_lse=None):
    """(dq, dk, dv) of ``bwd`` (the backward kernels' wrapper, or its
    plain version) on operands padded as in :func:`padded_fwd`; the padded
    columns of the gradients, gradients of the added zeros, are dropped."""
    D, Dv = q.shape[-1], v.shape[-1]
    Dp, Dvp = padded_head(D), padded_head(Dv)
    dq, dk, dv = bwd(_pad_heads(q, Dp), _pad_heads(k, Dp),
                     _pad_heads(v, Dvp), _pad_heads(out, Dvp), lse,
                     _pad_heads(g, Dvp), causal, sm_scale, g_lse)
    return (dq[..., :D].contiguous(), dk[..., :D].contiguous(),
            dv[..., :Dv].contiguous())


def _fwd_stages(width, stages):
    """The forward's ring depth: the deepest of at most FWD_MAX_STAGES
    that fits in SMEM_LIMIT, or ``stages`` where it is given (the kernel
    takes FWD_MIN_STAGES..FWD_MAX_STAGES, within SMEM_LIMIT)."""
    if stages is None:
        return max(s for s in range(1, FWD_MAX_STAGES + 1)
                   if _fwd_smem(width, s) <= SMEM_LIMIT)
    s = int(stages)
    if not FWD_MIN_STAGES <= s <= FWD_MAX_STAGES or \
            _fwd_smem(width, s) > SMEM_LIMIT:
        raise ValueError(f"fwd_plan: {s} stages at width {width}: the "
                         f"kernel takes {FWD_MIN_STAGES}..{FWD_MAX_STAGES} "
                         f"within {SMEM_LIMIT} bytes of shared memory")
    return s


def _bwd_stages(kernel, width, stages):
    """A backward kernel's ring depth: the deepest of at most
    BWD_MAX_STAGES that fits in SMEM_LIMIT, or ``stages`` where it is
    given (BWD_MIN_STAGES..BWD_MAX_STAGES, within SMEM_LIMIT)."""
    if stages is None:
        return max(s for s in range(BWD_MIN_STAGES, BWD_MAX_STAGES + 1)
                   if _bwd_smem(kernel, width, s) <= SMEM_LIMIT)
    s = int(stages)
    if not BWD_MIN_STAGES <= s <= BWD_MAX_STAGES or \
            _bwd_smem(kernel, width, s) > SMEM_LIMIT:
        raise ValueError(f"bwd_plan: {s} stages of {kernel} at width "
                         f"{width}: the kernels run {BWD_MIN_STAGES}.."
                         f"{BWD_MAX_STAGES} within {SMEM_LIMIT} bytes of "
                         f"shared memory")
    return s


def _fwd_smem(width, stages):
    """Shared-memory bytes of a forward block, as the kernel lays it out
    (``fwd_smem_bytes`` in csrc/flash_attn.cu): 1 KB of alignment slack,
    the Q tile (128 rows x width bf16), per stage a K and a V tile of
    FWD_TILE[width] rows, and 8 bytes per mbarrier (K-full, V-full and
    empty per stage, one for Q)."""
    return (1024 + width * 2 * BWD_ROWS
            + stages * 2 * FWD_TILE[width] * width * 2
            + 8 * (3 * stages + 1))


@functools.lru_cache(maxsize=1024)
def fwd_plan(BH: int, Tq: int, Tk: int, D: int, Dv: int,
             causal: bool, stages=None) -> FwdPlan:
    """The bf16 forward kernel's :class:`FwdPlan`: width 64 where D and
    Dv are at most 64, else 128; key tiles of FWD_TILE[width]; the
    deepest ring of at most ``FWD_MAX_STAGES`` stages that fits in
    ``SMEM_LIMIT``, or ``stages`` (a ``cuda/flash_attention`` config's
    ``fwd_stages``); one block per ``BWD_ROWS`` query rows of each head.
    Raises ValueError for head sizes or a depth the kernel does not
    take.  Pure: the CPU tests check it."""
    width = _check_heads("fwd_plan", D, Dv)
    stages = _fwd_stages(width, stages)
    return FwdPlan(BH=BH, Tq=Tq, Tk=Tk, D=D, Dv=Dv, causal=bool(causal),
                   width=width, fwd=KernelPlan(
                       kernel="fwd", rows=BWD_ROWS, tile=FWD_TILE[width],
                       stages=stages, smem=_fwd_smem(width, stages),
                       grid=BH * _cdiv(Tq, BWD_ROWS)))


def _walk_tiles(q0, t, Tq, Tk, causal):
    """(tile, live, masked) of each key tile of ``t`` keys a block of
    query rows [q0, q0 + 128) walks: ``live`` / ``masked`` a pair, one per
    consumer warpgroup (64 rows each), as csrc/flash_attn.cu decides
    them; the causal walk ends at the tile holding the block's last
    row."""
    nkt = _cdiv(Tk, t)
    if causal:
        nkt = min(nkt, min(q0 + BWD_ROWS - 1, Tq - 1) // t + 1)
    qw = (q0, q0 + 64)
    return [(kt, tuple(w < Tq and (not causal or kt * t <= w + 63)
                       for w in qw),
             tuple((causal and kt * t + t - 1 > w) or kt * t + t > Tk
                   for w in qw))
            for kt in range(nkt)]


def fwd_walk(plan: FwdPlan):
    """The key tiles each block of the forward visits, in launch order:
    a list of (bh, first query row, [(tile, live, masked)]) with ``tile``
    the index of a key tile of ``plan.fwd.tile`` keys and ``live`` /
    ``masked`` a pair, one per consumer warpgroup: whether it computes on
    the tile, and whether it applies the per-element mask there."""
    kp, BH = plan.fwd, plan.BH
    nqb = _cdiv(plan.Tq, kp.rows)
    blocks = []
    for b in range(kp.grid):
        q0 = (nqb - 1 - b // BH) * kp.rows
        blocks.append((b % BH, q0, _walk_tiles(q0, kp.tile, plan.Tq,
                                               plan.Tk, plan.causal)))
    return blocks


def _bwd_smem(kernel, width, stages):
    """Shared-memory bytes of a backward block, as the kernel lays it out
    (``bwd_smem_bytes`` in csrc/flash_attn.cu): 1 KB of alignment slack,
    the owned tiles (two operands x 128 rows x width bf16), per stage two
    64-row tiles (and, for dk/dv, the tile's 64 lse and 64 delta in
    fp32), and 8 bytes per mbarrier (full and empty per stage, one for
    the owned tiles)."""
    rows = 512 if kernel == "bwd_dkv" else 0
    return (1024 + 2 * width * 2 * BWD_ROWS
            + stages * (2 * width * 2 * BWD_TILE + rows)
            + 8 * (2 * stages + 1))


@functools.lru_cache(maxsize=1024)
def bwd_plan(BH: int, Tq: int, Tk: int, D: int, Dv: int,
             causal: bool, stages=None) -> BwdPlan:
    """The bf16 backward kernels' :class:`BwdPlan`: width 64 where D and
    Dv are at most 64, else 128; the deepest ring of at most
    ``BWD_MAX_STAGES`` stages that fits in ``SMEM_LIMIT``, or ``stages``
    for both kernels (a ``cuda/flash_attention`` config's
    ``bwd_stages``); one block per ``BWD_ROWS`` owned rows of each head.
    Raises ValueError for head sizes or a depth the kernels do not take.
    Pure: the CPU tests check it."""
    width = _check_heads("bwd_plan", D, Dv)
    plans = {}
    for kernel, T in (("bwd_dq", Tq), ("bwd_dkv", Tk)):
        stages_k = _bwd_stages(kernel, width, stages)
        plans[kernel] = KernelPlan(
            kernel=kernel, rows=BWD_ROWS, tile=BWD_TILE, stages=stages_k,
            smem=_bwd_smem(kernel, width, stages_k),
            grid=BH * _cdiv(T, BWD_ROWS))
    return BwdPlan(BH=BH, Tq=Tq, Tk=Tk, D=D, Dv=Dv, causal=bool(causal),
                   width=width, dq=plans["bwd_dq"], dkv=plans["bwd_dkv"])


# Autotuner knob (paddle_tpu_torch.tuning) of K2-K4's launch: the ring
# depths the kernels run at (flash_attn.cu: the forward
# FWD_MIN_STAGES..FWD_MAX_STAGES, the backward
# BWD_MIN_STAGES..BWD_MAX_STAGES), the depths whose shared memory fits
# SMEM_LIMIT at both widths.  Rows stay BWD_ROWS.  The default is the
# plans' own deepest ring that fits.  layers.flash_attention resolves it
# under autotune into the op's fwd_stages/bwd_stages attrs, so a
# program's content digest sees it.
_FWD_DEPTHS = tuple(s for s in range(FWD_MIN_STAGES, FWD_MAX_STAGES + 1)
                    if all(_fwd_smem(w, s) <= SMEM_LIMIT for w in FWD_TILE))
_BWD_DEPTHS = tuple(s for s in range(BWD_MIN_STAGES, BWD_MAX_STAGES + 1)
                    if all(_bwd_smem(kn, w, s) <= SMEM_LIMIT
                           for kn in ("bwd_dq", "bwd_dkv") for w in FWD_TILE))
register_tunable(
    "cuda/flash_attention", side="device",
    space={"fwd_stages": _FWD_DEPTHS, "bwd_stages": _BWD_DEPTHS},
    default={"fwd_stages": max(_FWD_DEPTHS), "bwd_stages": max(_BWD_DEPTHS)},
    description="ring depths of the bf16 flash-attention kernels: K2's "
                "(fwd_stages) and K3's and K4's (bwd_stages); the default "
                "is the deepest ring that fits in shared memory.",
    pending_hardware=True,
    decision_rule="change the plans' depth only when the on-card longctx "
                  "sweep (tuning.search.run_trial, one forward and "
                  "backward a window, paired windows) shows >= 1.10x "
                  "median ms a step over the deepest ring at BOTH 32k and "
                  "64k tokens (8 heads, d 64, causal, bf16), spread < gain, "
                  "every depth held against the plain versions")


def bwd_walk(plan: BwdPlan, kernel: str):
    """The tiles each block of ``kernel`` ("bwd_dq" or "bwd_dkv") visits,
    in launch order, as csrc/flash_attn.cu walks them: a list of (bh,
    first owned row, [(tile, live, masked)]) with ``tile`` the index of a
    streamed 64-row tile (key tiles for dq, query tiles for dk/dv) and
    ``live`` / ``masked`` a pair, one per consumer warpgroup (64 owned
    rows each): whether it computes on the tile, and whether it applies
    the per-element mask there."""
    kp = getattr(plan, kernel[4:])
    BH, Tq, Tk, causal = plan.BH, plan.Tq, plan.Tk, plan.causal
    t = kp.tile
    blocks = []
    for b in range(kp.grid):
        bh = b % BH
        tiles = []
        if kernel == "bwd_dq":
            q0 = (_cdiv(Tq, kp.rows) - 1 - b // BH) * kp.rows
            blocks.append((bh, q0, _walk_tiles(q0, t, Tq, Tk, causal)))
        else:
            k0 = (b // BH) * kp.rows
            qt0 = k0 // t if causal else 0
            for qt in range(qt0, _cdiv(Tq, t)):
                q0 = qt * t
                kw = (k0, k0 + 64)
                tiles.append((qt, tuple(
                    w < Tk and (not causal or q0 + 63 >= w) for w in kw),
                    tuple(causal and w + 63 > q0 for w in kw)))
            blocks.append((bh, k0, tiles))
    return blocks


def _scale(q, sm_scale):
    return q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)


def _shapes(q, k, v):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"flash attention: q, k, v must be [BH, T, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    BH, Tq, D = q.shape
    _, Tk, Dv = v.shape
    if k.shape[0] != BH or v.shape[0] != BH or k.shape[1] != Tk or \
            k.shape[2] != D:
        raise ValueError(f"flash attention: inconsistent shapes q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    return int(BH), int(Tq), int(Tk), int(D), int(Dv)


def _kernel_args(what, tensors, dims):
    """Check what the kernels take; the dtype code."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors) or dev.type != "cuda":
        raise ValueError(f"{what}: tensors must share one CUDA device (or "
                         f"all lie on the CPU), got "
                         f"{sorted({str(t.device) for t in tensors})}")
    dt = tensors[0].dtype
    if dt not in _DTYPE_CODES or any(t.dtype != dt for t in tensors[:3]):
        raise TypeError(f"{what}: the kernels take q, k, v of one dtype, "
                        f"float32 or bfloat16, got "
                        f"{[t.dtype for t in tensors[:3]]}")
    _, Tq, Tk, D, Dv = dims
    for name, d in (("D", D), ("Dv", Dv)):
        if d % 16 or not 16 <= d <= 128:
            raise ValueError(f"{what}: the kernels take head sizes that are "
                             f"multiples of 16 up to 128, got {name}={d}")
    if Tq == 0 or Tk == 0:
        raise ValueError(f"{what}: empty sequence (Tq={Tq}, Tk={Tk})")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: the kernels take contiguous tensors "
                             f"aligned to 16 bytes")
    return _DTYPE_CODES[dt]


def _check_rc(lib, rc, what):
    if rc != 0:
        raise RuntimeError(
            f"flash_attn launch failed: CUDA error {rc} "
            f"({lib.flash_attn_error_string(rc).decode()}) at {what}")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _causal_keys(causal, r1, Tk):
    """Keys a chunk of query rows ending at ``r1`` can see: under the
    top-left causal test keys past its last row are masked, and their
    exp underflows to exactly 0, so they are left out."""
    return min(Tk, r1) if causal else Tk


def _scores(q32, k32, r0, r1, causal):
    """Scaled fp32 scores of query rows [r0, r1) (q32 already scaled)
    against ``k32``, masked with NEG_INF where kpos > qpos (top-left)."""
    s = torch.matmul(q32, k32.transpose(1, 2))
    if causal:
        qpos = torch.arange(r0, r1, device=s.device)[:, None]
        kpos = torch.arange(s.shape[-1], device=s.device)[None, :]
        s.masked_fill_(kpos > qpos, NEG_INF)
    return s


def flash_fwd_reference(q, k, v, causal=False, sm_scale=None):
    """Plain version of the forward kernel: (out [BH, Tq, Dv] in q's
    dtype, lse [BH, Tq, 1] fp32).  Per chunk of ``_CHUNK`` query rows, the
    fp32 scores against every key (q scaled in fp32 first, as the TPU
    kernel does), the kernel's causal mask, an exact two-pass softmax,
    ``l`` clamped at 1e-20 and ``lse = m + log(l)``."""
    sm_scale = _scale(q, sm_scale)
    BH, Tq, Tk, D, Dv = _shapes(q, k, v)
    out = torch.empty((BH, Tq, Dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((BH, Tq, 1), dtype=torch.float32, device=q.device)
    k32, v32 = k.float(), v.float()
    for r0 in range(0, Tq, _CHUNK):
        r1 = min(r0 + _CHUNK, Tq)
        kend = _causal_keys(causal, r1, Tk)
        s = _scores(q[:, r0:r1].float() * sm_scale, k32[:, :kend], r0, r1,
                    causal)
        m = s.amax(-1, keepdim=True)
        p = s.sub_(m).exp_()
        l = p.sum(-1, keepdim=True).clamp_min_(1e-20)
        out[:, r0:r1] = (torch.matmul(p, v32[:, :kend]) / l).to(q.dtype)
        lse[:, r0:r1] = m + torch.log(l)
        del s, p
    return out, lse


def flash_delta(g, out, g_lse=None):
    """delta = rowsum(dO * out) - g_lse, fp32 [BH, Tq] (``:254-261``)."""
    delta = (g.float() * out.float()).sum(-1)
    if g_lse is not None:
        delta = delta - g_lse.float().reshape(delta.shape)
    return delta


def flash_bwd_reference(q, k, v, out, lse, g, causal=False, sm_scale=None,
                        g_lse=None):
    """Plain version of the two backward kernels: (dq, dk, dv) in q's,
    k's and v's dtypes.  Per chunk of query rows: p = exp(s - lse) from
    the recomputed fp32 scores, dp = dO v^T, ds = p (dp - delta), dq =
    scale * ds k; dk and dv accumulate ds^T (scale q) and p^T dO in fp32
    across the chunks."""
    sm_scale = _scale(q, sm_scale)
    BH, Tq, Tk, D, Dv = _shapes(q, k, v)
    delta = flash_delta(g, out, g_lse)[..., None]
    lse = lse.float().reshape(BH, Tq, 1)
    k32, v32, g32 = k.float(), v.float(), g.float()
    dq = torch.empty_like(q)
    dk = torch.zeros((BH, Tk, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros((BH, Tk, Dv), dtype=torch.float32, device=q.device)
    for r0 in range(0, Tq, _CHUNK):
        r1 = min(r0 + _CHUNK, Tq)
        kend = _causal_keys(causal, r1, Tk)
        q32 = q[:, r0:r1].float() * sm_scale
        p = _scores(q32, k32[:, :kend], r0, r1, causal).sub_(
            lse[:, r0:r1]).exp_()
        ds = torch.matmul(g32[:, r0:r1], v32[:, :kend].transpose(1, 2))
        ds.sub_(delta[:, r0:r1]).mul_(p)
        dq[:, r0:r1] = (torch.matmul(ds, k32[:, :kend]) * sm_scale).to(
            q.dtype)
        dk[:, :kend] += torch.matmul(ds.transpose(1, 2), q32)
        dv[:, :kend] += torch.matmul(p.transpose(1, 2), g32[:, r0:r1])
        del p, ds
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def attention_reference(q, k, v, causal=False, sm_scale=None):
    """``_reference_attention`` (``:318-325``): exact attention in the
    inputs' dtype, with the bottom-right causal mask tril(k = Tk - Tq);
    differentiable by autograd.  The route for ragged tails and causal
    cross-attention."""
    sm_scale = _scale(q, sm_scale)
    s = torch.einsum("bqd,bkd->bqk", q * sm_scale, k)
    if causal:
        Tq, Tk = s.shape[-2], s.shape[-1]
        mask = torch.ones((Tq, Tk), dtype=torch.bool,
                          device=s.device).tril(Tk - Tq)
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def flash_fwd(q, k, v, causal=False, sm_scale=None, stages=None):
    """(out, lse [BH, Tq, 1] fp32) of the forward kernel (K2).  CUDA
    tensors launch it; CPU tensors take :func:`flash_fwd_reference`.
    ``stages``: the bf16 ring's depth (None: :func:`fwd_plan`'s deepest
    that fits; a ``cuda/flash_attention`` config's ``fwd_stages``).  The
    bf16 kernel takes a scale >= 0 (it keeps the running max as max(s) *
    scale); for a negative one it gets -q and -scale, the same scores.
    A head size (D or Dv) that is not a multiple of 16 runs padded with
    zero columns to the next one (:func:`padded_fwd`): exact, with the
    scale of the true D; above 128 it raises."""
    sm_scale = _scale(q, sm_scale)
    dims = _shapes(q, k, v)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_fwd_reference(q, k, v, causal, sm_scale)
    if (padded_head(dims[3]), padded_head(dims[4])) != dims[3:]:
        return padded_fwd(functools.partial(flash_fwd, stages=stages), q, k,
                          v, causal, sm_scale)
    dtype = _kernel_args("flash_fwd", (q, k, v), dims)
    if dtype == _DTYPE_CODES[torch.bfloat16] and sm_scale < 0:
        q, sm_scale = -q, -sm_scale
    BH, Tq, Tk, D, Dv = dims
    out = torch.empty((BH, Tq, Dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((BH, Tq, 1), dtype=torch.float32, device=q.device)
    lib = _library()
    plan = _launch_args(dims, dtype, causal, "fwd", stages)
    with torch.cuda.device(q.device):
        rc = lib.flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), *dims, int(bool(causal)), sm_scale, dtype,
            *plan, torch.cuda.current_stream(q.device).cuda_stream)
    _check_rc(lib, rc, f"fwd {dims} causal={causal} {q.dtype} "
                       f"stages={plan[1]}")
    _count("fwd", q.dtype, plan)
    return out, lse


def flash_bwd(q, k, v, out, lse, g, causal=False, sm_scale=None,
              g_lse=None, stages=None):
    """(dq, dk, dv) of the backward kernels (K3, then K4), from the
    forward's ``out`` and ``lse``, the cotangent ``g`` of out and an
    optional cotangent ``g_lse`` of lse.  CUDA tensors launch them; CPU
    tensors take :func:`flash_bwd_reference`.  Head sizes that are not
    multiples of 16 run padded, as in :func:`flash_fwd`.  ``stages``:
    both bf16 rings' depth (None: :func:`bwd_plan`'s deepest that fits;
    a ``cuda/flash_attention`` config's ``bwd_stages``)."""
    sm_scale = _scale(q, sm_scale)
    if all(t.device.type == "cpu" for t in (q, k, v, out, lse, g)):
        return flash_bwd_reference(q, k, v, out, lse, g, causal, sm_scale,
                                   g_lse)
    D, Dv = q.shape[-1], v.shape[-1]
    if (padded_head(D), padded_head(Dv)) != (D, Dv):
        return padded_bwd(functools.partial(flash_bwd, stages=stages), q, k,
                          v, out, lse, g, causal, sm_scale, g_lse)
    delta = flash_delta(g, out, g_lse)
    lse = lse.float().contiguous()
    return (flash_bwd_dq(q, k, v, g, lse, delta, causal, sm_scale, stages),
            *flash_bwd_dkv(q, k, v, g, lse, delta, causal, sm_scale,
                           stages))


def _bwd_args(what, q, k, v, g, lse, delta):
    dims = _shapes(q, k, v)
    if g.dtype != q.dtype:
        raise TypeError(f"{what}: the cotangent must be in q's dtype "
                        f"{q.dtype}, got {g.dtype}")
    if lse.dtype != torch.float32 or delta.dtype != torch.float32 or \
            lse.numel() != dims[0] * dims[1] or delta.numel() != lse.numel():
        raise ValueError(f"{what}: lse and delta must be fp32 with BH * Tq "
                         f"values")
    dtype = _kernel_args(what, (q, k, v, g, lse, delta), dims)
    return dims, dtype, torch.cuda.current_stream(q.device).cuda_stream


def _launch_args(dims, dtype, causal, kernel, stages=None):
    """(rows, stages, smem) of the bf16 kernel's plan (``kernel`` "fwd",
    "bwd_dq" or "bwd_dkv"; ``stages`` None for the plan's own depth);
    zeros for fp32, whose kernels take none."""
    if dtype != _DTYPE_CODES[torch.bfloat16]:
        return 0, 0, 0
    if kernel == "fwd":
        kp = fwd_plan(*dims, bool(causal), stages).fwd
    else:
        kp = getattr(bwd_plan(*dims, bool(causal), stages), kernel[4:])
    return kp.rows, kp.stages, kp.smem


def _count(kernel, dtype, plan):
    """Count one launch of ``kernel`` with the (rows, stages, smem) it
    took (stages 0: an fp32 kernel)."""
    launches[kernel] += 1
    launches_by_dtype[kernel, dtype] += 1
    if plan[1]:
        launches_by_stages[kernel, plan[1]] += 1


def flash_bwd_dq(q, k, v, g, lse, delta, causal=False, sm_scale=None,
                 stages=None):
    """dq from the dq kernel (K3) alone, CUDA tensors only (the entry
    point is :func:`flash_bwd`); ``lse`` and ``delta`` fp32 [BH, Tq]
    (or [BH, Tq, 1]), contiguous; ``stages`` as :func:`flash_bwd`."""
    sm_scale = _scale(q, sm_scale)
    dims, dtype, stream = _bwd_args("flash_bwd_dq", q, k, v, g, lse, delta)
    dq = torch.empty_like(q)
    lib = _library()
    plan = _launch_args(dims, dtype, causal, "bwd_dq", stages)
    with torch.cuda.device(q.device):
        rc = lib.flash_attn_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *dims,
            int(bool(causal)), sm_scale, dtype, *plan, stream)
    _check_rc(lib, rc, f"bwd_dq {dims} causal={causal} {q.dtype} "
                       f"stages={plan[1]}")
    _count("bwd_dq", q.dtype, plan)
    return dq


def flash_bwd_dkv(q, k, v, g, lse, delta, causal=False, sm_scale=None,
                  stages=None):
    """(dk, dv) from the dk/dv kernel (K4) alone, CUDA tensors only (the
    entry point is :func:`flash_bwd`); arguments as
    :func:`flash_bwd_dq`."""
    sm_scale = _scale(q, sm_scale)
    dims, dtype, stream = _bwd_args("flash_bwd_dkv", q, k, v, g, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _library()
    plan = _launch_args(dims, dtype, causal, "bwd_dkv", stages)
    with torch.cuda.device(q.device):
        rc = lib.flash_attn_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *dims, int(bool(causal)), sm_scale, dtype, *plan, stream)
    _check_rc(lib, rc, f"bwd_dkv {dims} causal={causal} {q.dtype} "
                       f"stages={plan[1]}")
    _count("bwd_dkv", q.dtype, plan)
    return dk, dv


# ---------------------------------------------------------------------------
# differentiable entry points (the custom VJPs of :328-371)
# ---------------------------------------------------------------------------
class _Flash(torch.autograd.Function):
    """``_flash``: out only; the backward runs K3 and K4.  ``stages``:
    (forward, backward) ring depths, None each for the plans' own."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, stages=(None, None)):
        out, lse = flash_fwd(q, k, v, causal, sm_scale, stages[0])
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale, ctx.stages = causal, sm_scale, stages
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        # the cotangent can arrive as a strided view (the [B,T,H,D]
        # moveaxis, the executor's casts)
        dq, dk, dv = flash_bwd(q, k, v, out, lse, g.contiguous(),
                               ctx.causal, ctx.sm_scale,
                               stages=ctx.stages[1])
        return dq, dk, dv, None, None, None


class _FlashLse(torch.autograd.Function):
    """``_flash_lse``: (out, lse); an lse cotangent folds into delta."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out, lse = flash_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, g.contiguous(),
                               ctx.causal, ctx.sm_scale, g_lse=g_lse)
        return dq, dk, dv, None, None


# ---------------------------------------------------------------------------
# the forward as one custom op: what torch.export keeps in a graph
# ---------------------------------------------------------------------------
@torch.library.custom_op("paddle_tpu_torch::flash_attention_fwd",
                         mutates_args=())
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, sm_scale: float,
                        stages: int = 0) -> torch.Tensor:
    """The forward kernel (K2) as one op of the graph, out only: what
    :func:`flash_attention` calls when no gradient is needed, so a traced
    graph (``torch.export``) holds it whole.  CUDA tensors launch
    :func:`flash_fwd` (counted in ``launches``), CPU tensors take its
    plain version.  ``stages``: the bf16 ring's depth, 0 for the plan's
    own.  No autograd: a call that records gradients goes through
    ``_Flash``, whose backward runs K3 and K4."""
    out, _ = flash_fwd(q, k, v, causal, sm_scale, stages or None)
    return out


@flash_attention_fwd.register_fake
def _flash_attention_fwd_fake(q, k, v, causal, sm_scale, stages=0):
    return q.new_empty((q.shape[0], q.shape[1], v.shape[2]))


def flash_attention_with_lse(q, k, v, causal=False, sm_scale=None,
                             block_q=128, block_k=128):
    """Fused attention returning (out, lse [BH, Tq, 1]), the residual a
    blockwise consumer (ring attention) merges.  q, k, v: [BH, T, D],
    lengths divisible by the blocks (and Tq == Tk when causal), as in
    the JAX package; differentiable in both outputs."""
    sm_scale = _scale(q, sm_scale)
    bq, bk = min(block_q, q.shape[1]), min(block_k, k.shape[1])
    if q.shape[1] % bq or k.shape[1] % bk or (causal and
                                             q.shape[1] != k.shape[1]):
        raise ValueError(
            "flash_attention_with_lse needs block-divisible lengths "
            f"(got Tq={q.shape[1]}, Tk={k.shape[1]})")
    return _FlashLse.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                           bool(causal), sm_scale)


def flash_attention(q, k, v, causal=False, sm_scale=None, block_q=128,
                    block_k=128, interpret=None, stages=(None, None)):
    """Fused attention.  q, k, v: [B, T, H, D] (or [BH, T, D]).

    ``block_q``/``block_k`` are the TPU kernel's tile sizes; here they
    only decide the route, as in the JAX wrapper: a ragged tail (a length
    not divisible by its block) or causal cross-attention (Tq != Tk) takes
    :func:`attention_reference`, counted in ``reference_route``; all else
    runs the kernels (CUDA tensors) or their plain versions (CPU
    tensors): through ``_Flash`` when a gradient is recorded, else as the
    custom op :func:`flash_attention_fwd`.  The CUDA kernels pick their
    own tiles; ``stages`` are the (forward, backward) ring depths of the
    bf16 kernels, None each for the plans' deepest that fits.
    ``interpret`` is accepted for the JAX signature and ignored."""
    sm_scale = _scale(q, sm_scale)
    squeeze_heads = q.dim() == 4
    if squeeze_heads:
        B, Tq_out, H, _ = q.shape

        def rs(x):
            b, t, h, d = x.shape
            return x.movedim(2, 1).reshape(b * h, t, d)

        q3, k3, v3 = rs(q), rs(k), rs(v)
    else:
        q3, k3, v3 = q, k, v
    if q3.shape[-1] != k3.shape[-1]:
        raise ValueError(
            f"flash_attention: q feature dim {q3.shape[-1]} != k feature "
            f"dim {k3.shape[-1]}")
    Tq, Tk = q3.shape[1], k3.shape[1]
    bq, bk = min(block_q, Tq), min(block_k, Tk)
    if Tq % bq or Tk % bk:
        reference_route["ragged"] += 1
        out = attention_reference(q3, k3, v3, causal, sm_scale)
    elif causal and Tq != Tk:
        reference_route["causal_cross"] += 1
        out = attention_reference(q3, k3, v3, causal, sm_scale)
    elif (torch.is_grad_enabled()
          and any(t.requires_grad for t in (q3, k3, v3))) or \
            q3.device.type not in ("cpu", "cuda"):
        # a gradient to record, or a device the kernels and their plain
        # versions do not take (flash_fwd raises for it)
        out = _Flash.apply(q3.contiguous(), k3.contiguous(), v3.contiguous(),
                           bool(causal), sm_scale, tuple(stages))
    else:
        out = flash_attention_fwd(q3.contiguous(), k3.contiguous(),
                                  v3.contiguous(), bool(causal),
                                  float(sm_scale), int(stages[0] or 0))
    if squeeze_heads:
        out = out.reshape(B, H, Tq_out, v.shape[-1]).movedim(1, 2)
    return out


# ---------------------------------------------------------------------------
# op registration (layer: layers.flash_attention)
# ---------------------------------------------------------------------------
@register_op("flash_attention")
def _flash_attention_op(ctx, ins, attrs):
    """``pallas_kernels.py:520-549`` without the sequence-parallel (ring
    attention) routing, which comes with the multi-GPU port; the
    ``sequence_parallel`` and ``interpret`` attrs are accepted and
    ignored.  ``fwd_stages``/``bwd_stages`` (written by
    ``layers.flash_attention`` from a replayed ``cuda/flash_attention``
    record) set the kernels' ring depths; absent, the plans' own."""
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    return {"Out": flash_attention(
        q, k, v, causal=attrs.get("causal", False),
        block_q=attrs.get("block_q", 1024),
        block_k=attrs.get("block_k", 1024),
        stages=(attrs.get("fwd_stages"), attrs.get("bwd_stages")))}


# ---------------------------------------------------------------------------
# Static shape/dtype rule (``paddle_tpu/ops/pallas_kernels.py:555-572``):
# flash_attention is shape-preserving on Q.  Sharding: batch/head
# sharding rides along (each shard attends within itself).
# ---------------------------------------------------------------------------
from ..analysis.shape_infer import ShapeError, dim_ok, first  # noqa: E402
from ..analysis.shard_prop import shard_same_as  # noqa: E402
from ..core.registry import (register_shape_fn,  # noqa: E402
                             register_shard_fn)


@register_shape_fn("flash_attention")
def _flash_attention_shape(op, ins, attrs):
    q, k, v = first(ins, "Q"), first(ins, "K"), first(ins, "V")
    for name, o in (("K", k), ("V", v)):
        if q.shape is not None and o.shape is not None:
            if len(o.shape) != len(q.shape) or \
                    not dim_ok(q.shape[-1], o.shape[-1]):
                raise ShapeError(
                    f"flash_attention: Q {list(q.shape)} vs {name} "
                    f"{list(o.shape)} (rank or head dim mismatch)")
    return {"Out": q}


register_shard_fn("flash_attention")(shard_same_as("Q"))
