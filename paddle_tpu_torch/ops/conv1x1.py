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
and ``a_colsum`` epilogues).  bf16 operands run ``mm_bf16_tma`` (a TMA
ring, ``wgmma``), fp32 operands the exact ``mm_f32_tma`` (a TMA ring
feeding 8x8 fp32 FFMA register tiles, no TF32), both by the launch
:func:`plan` makes: the tile, the ring's stages, the persistent schedule
of bf16 one-slab launches, each operand's major-ness and TMA box, and the
split of K into slabs of whole K steps folded in a thread-block cluster:
for the wgrad form, whose K = P runs to 401408 at ResNet-50's shapes
while its output is a handful of tiles, and for the other forms where
their tiles would leave SMs idle.  Where the wgrad's slabs outnumber the
cluster, a second kernel (:func:`splitk_reduce`) sums the clusters' fp32
partials.
On CUDA tensors :func:`mm` launches the kernels or raises; on CPU
tensors it computes the plain PyTorch version, :func:`mm_reference`.
``mm.by_form`` counts every kernel launch by form (``forward``,
``dgrad``, ``wgrad``, ``ta_tb``, ``+out_stats``/``+a_colsum`` for the
epilogues, ``splitk_reduce`` for the second pass), never the plain path;
:func:`launches` is the number of product launches (every form but the
second pass).

:func:`matmul` is the differentiable product (``pallas_matmul``'s
counterpart): an autograd Function whose backward runs :func:`mm` with
the transposes of ``_pm_bwd`` (``pallas_conv.py:235-246``), so
:func:`conv2d_1x1` trains through the kernel.

:func:`conv2d_1x1_op` is the 1x1 convolution as one custom op,
``paddle_tpu_torch::conv2d_1x1``: the form a graph traced by
``torch.export`` holds, deciding the route at each call's batch.

The kernel is compiled from the package's sources with ``nvcc`` at first
use into ``build/`` at the repository root, and bound with ``ctypes``
(a plain C interface; no PyTorch headers), by ``ops/cuda_build.py``.
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
from ..core.registry import register_tunable
from . import cuda_build

__all__ = ["mm", "mm_reference", "matmul", "plan", "Plan", "plan_for",
           "check_launch", "splitk_reduce",
           "splitk_reduce_reference", "conv2d_1x1",
           "conv2d_1x1_reference", "conv2d_1x1_with_bn_stats",
           "conv2d_1x1_grad_fused", "conv1x1_eligible",
           "conv1x1_static_gate", "pixels", "conv2d_1x1_op", "routes",
           "KERNEL_DTYPES",
           "launches",
           "reset_counts",
           "build", "SOURCE"]

SOURCE = os.path.join(cuda_build.CSRC_DIR, "conv1x1_mm.cu")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the operand dtypes the kernels take; another dtype never reaches them
# (ops/nn_ops.py routes it plainly, counted in ``routes["dtype"]``)
KERNEL_DTYPES = tuple(_DTYPE_CODES)
_TILE = 128                    # both kernels' M/N tile
_MAX_GRID_Y = 65535            # the kernel puts M tiles on gridDim.y
_FORMS = {(False, True): "forward", (False, False): "dgrad",
          (True, False): "wgrad", (True, True): "ta_tb"}
_FORM_NAMES = {(ta, tb, st, cs): _FORMS[(ta, tb)] + ("+out_stats" if st
                                                     else "") +
               ("+a_colsum" if cs else "")
               for ta in (False, True) for tb in (False, True)
               for st in (False, True) for cs in (False, True)}

# The bf16 kernel's launch (see :func:`plan`): 128x128 tiles, K steps of
# 64, two blocks an SM (_BLOCKS_AN_SM).  A launch of one slab with a bf16
# output and no a_colsum is persistent: _BLOCKS_AN_SM blocks an SM walk
# the tiles with a ring of _STAGES_PERSISTENT stages of 32 KB, beside
# their bf16 staging tile.  Other launches run one tile a block with a
# ring of _STAGES_ONE_TILE stages.  The
# wgrad form (ta=True, tb=False, no out_stats) splits K into S slabs so
# that tiles x S fills about one block per SM, every slab at least
# _MIN_SLAB_STEPS steps; the slabs of one tile fold in a cluster of up to
# _CLUSTER_MAX blocks.  Where S would exceed the cluster, S is capped at
# the cluster if tiles x _CLUSTER_MAX blocks still fill 7/8 of the SMs,
# and otherwise rounded up to a multiple of the cluster, whose S / cluster
# fp32 partials splitk_reduce sums.  The other forms (no out_stats) split
# only where their tiles are fewer than the SMs, within one cluster: S =
# ceil(SMs / tiles), at most _CLUSTER_MAX, every slab _MIN_SLAB_STEPS
# steps or more.
_BK = 64
_STAGES_ONE_TILE = 3
_STAGES_PERSISTENT = 2
_CLUSTER_MAX = 8
_MIN_SLAB_STEPS = 8
_BLOCKS_AN_SM = 2

# The fp32 kernel's launch (see :func:`plan`): 128x128 tiles, K steps of
# 32 through a ring of _F32_STAGES stages of 32 KB, up to two blocks an
# SM, one tile a block, slabs folded in clusters of at most
# _F32_CLUSTER_MAX (larger clusters ran slower).  The split S is chosen
# by whole rounds of blocks over the SMs: of the slab counts that the
# cluster allows (S <= _F32_CLUSTER_MAX, or a multiple of it, leaving
# S / cluster partials), every slab _MIN_SLAB_STEPS steps or more, those
# whose time ceil(tiles x S / SMs) / S (in units of one full-K tile)
# comes within _WAVE_SLACK of the least; of these the most slabs that
# still fit _BLOCKS_AN_SM blocks an SM (two blocks an SM ran faster than
# one), else the fewest.  Only the wgrad form takes S above the cluster;
# the other forms (no out_stats) split within one cluster.
_F32_BK = 32
_F32_STAGES = 2
_F32_CLUSTER_MAX = 2
_WAVE_SLACK = 1.0625

_sm_counts = {}
_lib = None


def build() -> str:
    """Compile ``csrc/conv1x1_mm.cu`` for sm_90a into ``build/`` (keyed by
    the source's content hash, so an edited source rebuilds) and return
    the library's path; ``cuda_build.build`` keeps the ``-Xptxas -v``
    report beside it, in ``<library>.ptxas.txt``."""
    return cuda_build.build(SOURCE)


def _library():
    """The kernels' ctypes library, built and bound at first use and kept
    here: every call of :func:`mm` needs it, on the host's clock."""
    global _lib
    if _lib is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        _lib = cuda_build.load(SOURCE, {
            "conv1x1_mm": ([ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
                            i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr],
                           i32),
            "conv1x1_mm_splitk_reduce": ([ptr, i32, ctypes.c_longlong, ptr,
                                          i32, ptr, ptr, i32, ptr], i32),
            "conv1x1_mm_error_string": ([i32], ctypes.c_char_p),
        })
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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernel's launch for one product (see :func:`plan`).

    ``tile`` (BM, BN, BK); ``stages`` of the TMA ring; ``ctas`` blocks of
    the bf16 persistent schedule, which walk the tiles (0: one tile a
    block); ``splits`` slabs of whole BK steps along K (:meth:`slabs`),
    the longest ``kchunk`` values long; ``cluster`` blocks fold their
    slabs' fp32 tiles in distributed shared memory; ``partials`` fp32 [M, N] partials the
    clusters write for :func:`splitk_reduce` (0: the kernel writes the
    output); ``a_major``/``b_major`` the contiguous dimension of each
    operand's storage ("K", "M" or "N"), ``a_box``/``b_box`` its TMA box
    (inner, outer) in elements."""
    M: int
    N: int
    K: int
    tile: tuple
    stages: int
    ctas: int
    splits: int
    kchunk: int
    cluster: int
    partials: int
    a_major: str
    b_major: str
    a_box: tuple
    b_box: tuple

    @property
    def ksteps(self) -> int:
        return _cdiv(self.K, self.tile[2])

    @property
    def tiles(self) -> int:
        return _cdiv(self.N, self.tile[1]) * _cdiv(self.M, self.tile[0])

    @property
    def grid(self) -> tuple:
        if self.ctas:
            return (self.ctas, 1, 1)
        return (_cdiv(self.N, self.tile[1]), _cdiv(self.M, self.tile[0]),
                self.splits)

    def slabs(self):
        """[(k_lo, k_hi)] of each slab z, as the kernel cuts them: K steps
        [z * ksteps // S, (z + 1) * ksteps // S), the last clipped at K."""
        n, bk = self.ksteps, self.tile[2]
        return [(z * n // self.splits * bk,
                 min(self.K, (z + 1) * n // self.splits * bk))
                for z in range(self.splits)]

    def partial_bytes(self) -> int:
        """fp32 partial bytes written and read again by the reduce pass."""
        return 2 * 4 * self.partials * self.M * self.N


def _f32_rounds(tiles: int, splits: int, sms: int) -> float:
    """The fp32 launch's time in units of one full-K tile: whole rounds of
    one block an SM, each 1 / ``splits`` of K."""
    return _cdiv(tiles * splits, sms) / splits


def _f32_splits(tiles: int, ksteps: int, sms: int, deep: bool) -> int:
    """Slabs S of the fp32 kernel (the rule stated at ``_F32_BK``);
    ``deep`` is the wgrad form."""
    top = max(1, ksteps // _MIN_SLAB_STEPS)
    if not deep:
        top = min(top, _F32_CLUSTER_MAX)
    cands = [s for s in range(1, top + 1)
             if s <= _F32_CLUSTER_MAX or s % _F32_CLUSTER_MAX == 0]
    least = min(_f32_rounds(tiles, s, sms) for s in cands)
    near = [s for s in cands
            if _f32_rounds(tiles, s, sms) <= _WAVE_SLACK * least]
    fit = [s for s in near if tiles * s <= _BLOCKS_AN_SM * sms]
    return max(fit) if fit else min(near)


# A bf16 slab of more than MAX_BF16_SLAB_STEPS K steps (16384 of K) is
# never launched: the tensor cores' fp32 accumulation in a slab drifts
# with its length, and its largest error grows with the outputs too.  On
# an H100 (80GB HBM3, 700 W) the largest error over its limit
# (chip_smoke.py's deep_tol) read, at ResNet-50's stage-2 wgrad (dw [128, 512], K = 100352), 0.56 at
# 392 steps, 1.05 at 784 and 2.82 at 1568, against 0.47 at plan()'s 40
# (benchmark.conv_kernel --slab-accuracy); at dw [2048, 2048] over K =
# 50176, 2.17 at 784 steps, 1.12 at 392, 0.66 at 262, 0.54 at 196 and
# 0.48-0.49 at 131 and below (PERF.md).  plan() gives a split bf16
# product at least ceil(K steps / MAX_BF16_SLAB_STEPS) slabs (above
# _CLUSTER_MAX, whole clusters), raises for an out_stats product that
# would need more than one, and check_launch refuses a tuned plan past it.
MAX_BF16_SLAB_STEPS = 256


@functools.lru_cache(maxsize=4096)
def plan(M: int, N: int, K: int, ta: bool, tb: bool, dtype=torch.bfloat16,
         sms: int = 132, out_stats: bool = False, a_colsum: bool = False,
         out_dtype=torch.bfloat16) -> Plan:
    """The :class:`Plan` for O[M,N] = op(A) @ op(B) with the given
    epilogues and output dtype, for bf16 operands by the rules stated at
    ``_BK`` and for fp32 ones by those at ``_F32_BK``.  Raises ValueError
    for another dtype and where TMA cannot read an operand: its storage
    row (A: M if ``ta`` else K; B: K if ``tb`` else N) must be 16 bytes,
    a multiple of 8 bf16 or 4 fp32 elements; and for a bf16 ``out_stats``
    product of more than MAX_BF16_SLAB_STEPS K steps (its one slab would
    drift out of tolerance).  Pure and cached: :func:`mm` asks for it on
    every call."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"plan: the kernels take bf16 or fp32, got {dtype}")
    bf16 = dtype == torch.bfloat16
    name, multiple = ("bf16", 8) if bf16 else ("fp32", 4)
    rows = {"A": M if ta else K, "B": K if tb else N}
    for op, row in rows.items():
        if row % multiple:
            raise ValueError(
                f"mm: {name} operand {op}'s contiguous row of {row} elements "
                f"is not a multiple of {multiple} (TMA needs 16-byte row "
                f"strides)")
    bm = bn = _TILE
    bk = _BK if bf16 else _F32_BK
    tiles = _cdiv(M, bm) * _cdiv(N, bn)
    ksteps = _cdiv(K, bk)
    deep = ta and not tb
    splits = 1
    if out_stats:            # one partial row per M tile: no split
        pass
    elif not bf16:
        splits = _f32_splits(tiles, ksteps, sms, deep)
    elif deep:
        want = _cdiv(sms, tiles)
        if want > _CLUSTER_MAX and 8 * tiles * _CLUSTER_MAX < 7 * sms:
            want = _cdiv(want, _CLUSTER_MAX) * _CLUSTER_MAX
        else:
            want = min(want, _CLUSTER_MAX)
        splits = max(1, min(want, ksteps // _MIN_SLAB_STEPS))
        if splits > _CLUSTER_MAX:
            splits -= splits % _CLUSTER_MAX
    elif tiles < sms:
        splits = max(1, min(_cdiv(sms, tiles), _CLUSTER_MAX,
                            ksteps // _MIN_SLAB_STEPS))
    if bf16:
        least = _cdiv(ksteps, MAX_BF16_SLAB_STEPS)
        if out_stats and least > 1:
            raise ValueError(
                f"plan: an out_stats product takes one slab, and {ksteps} K "
                f"steps of bf16 pass MAX_BF16_SLAB_STEPS = "
                f"{MAX_BF16_SLAB_STEPS} (its accumulation drifts out of "
                f"tolerance)")
        if splits < least:
            splits = least if least <= _CLUSTER_MAX else \
                _cdiv(least, _CLUSTER_MAX) * _CLUSTER_MAX
    cluster = min(splits, _CLUSTER_MAX if bf16 else _F32_CLUSTER_MAX)
    persistent = bf16 and splits == 1 and not a_colsum and \
        out_dtype == torch.bfloat16
    if bf16:
        stages = _STAGES_PERSISTENT if persistent else _STAGES_ONE_TILE
        a_box = (64, 64) if ta else (bk, bm)
        b_box = (bk, bn) if tb else (64, 64)
    else:   # K-major: 32 K x 128 rows; MN-major: 128 x 32 K
        stages = _F32_STAGES
        a_box = (bm, bk) if ta else (bk, bm)
        b_box = (bk, bn) if tb else (bn, bk)
    return Plan(
        M=M, N=N, K=K, tile=(bm, bn, bk), stages=stages,
        ctas=min(tiles, _BLOCKS_AN_SM * sms) if persistent else 0,
        splits=splits,
        kchunk=max(1, _cdiv(ksteps, splits)) * bk, cluster=cluster,
        partials=splits // cluster if splits > cluster else 0,
        a_major="M" if ta else "K", b_major="K" if tb else "N",
        a_box=a_box, b_box=b_box)


# Autotuner knob (paddle_tpu_torch.tuning) of K1's launch: the fields
# conv1x1_mm takes at run time (csrc/conv1x1_mm.cu, conv1x1_mm's splits,
# cluster and persistent_ctas); the tile and the ring's depth are
# compiled in and stay out.  "rule" is what plan() chooses, so the
# default config is plan() itself at every shape and form.  No call site
# replays it: plan() stays the rule, and the search's trial table (the
# [tune] phase of chip_smoke.py, benchmark.conv_kernel) is the finding.
RULE = "rule"
register_tunable(
    "cuda/conv1x1_plan", side="device",
    space={"splits": (RULE, 1, 2, 4, 8, 16, 24, 32, 40, 72),
           "cluster": (RULE, 1, 2, 4, 8),
           "persistent": (RULE, False)},
    default={"splits": RULE, "cluster": RULE, "persistent": RULE},
    description="K1's launch plan (ops/conv1x1.py plan): slabs of K, "
                "the cluster that folds them, and the bf16 persistent "
                "schedule; 'rule' is plan()'s own choice.  A config the "
                "kernel would refuse, or a bf16 slab too long to stay in "
                "tolerance, fails its trial before it launches "
                "(check_launch).",
    pending_hardware=True,
    decision_rule="change plan()'s rule only when the on-card "
                  "conv_kernel search (tuning.search, paired windows) "
                  "shows a non-rule plan >= 1.10x geomean faster than "
                  "the rule over ResNet-50's and GoogLeNet's eligible "
                  "1x1 shapes of its form and dtype, with no per-shape "
                  "regression > 5% and every candidate held against "
                  "mm_reference")


def plan_for(config, M: int, N: int, K: int, ta: bool, tb: bool,
             dtype=torch.bfloat16, sms: int = 132, out_stats: bool = False,
             a_colsum: bool = False, out_dtype=torch.bfloat16) -> Plan:
    """The :class:`Plan` of a ``cuda/conv1x1_plan`` config: :func:`plan`
    itself where every field is ``"rule"`` (or ``config`` is None), else
    the rule's plan with ``splits``, ``cluster`` and the persistent
    schedule replaced.  ``"rule"`` in one field keeps the rule's way of
    deriving it from the others: the cluster is ``min(splits, the
    dtype's cluster limit)``, the schedule persistent for one bf16 slab
    with a bf16 output and no ``a_colsum``.  Pure; the result may be one
    the kernel refuses (:func:`check_launch`)."""
    base = plan(M, N, K, ta, tb, dtype, sms, out_stats, a_colsum, out_dtype)
    if config is None or all(v == RULE for v in config.values()):
        return base
    bf16 = dtype == torch.bfloat16
    splits = config.get("splits", RULE)
    splits = base.splits if splits == RULE else int(splits)
    cluster = config.get("cluster", RULE)
    cluster = min(splits, _CLUSTER_MAX if bf16 else _F32_CLUSTER_MAX) \
        if cluster == RULE else int(cluster)
    persistent = config.get("persistent", RULE)
    persistent = (bf16 and splits == 1 and not a_colsum
                  and out_dtype == torch.bfloat16) if persistent == RULE \
        else bool(persistent)
    stages = base.stages
    if bf16:
        stages = _STAGES_PERSISTENT if persistent else _STAGES_ONE_TILE
    return dataclasses.replace(
        base, stages=stages,
        ctas=min(base.tiles, _BLOCKS_AN_SM * sms) if persistent else 0,
        splits=splits,
        kchunk=max(1, _cdiv(base.ksteps, max(1, splits))) * base.tile[2],
        cluster=cluster,
        partials=splits // cluster if splits > cluster else 0)


def check_launch(p: Plan, dtype=torch.bfloat16, out_stats: bool = False,
                 a_colsum: bool = False, out_dtype=torch.bfloat16):
    """Raise ValueError, before anything launches, where ``conv1x1_mm``
    (csrc/conv1x1_mm.cu) would refuse the launch of ``p`` (its checks on
    splits, cluster, the ``out_stats`` epilogue and the persistent
    schedule), where a slab would have no K step, and where a bf16 slab
    passes MAX_BF16_SLAB_STEPS.  (The operands' rows and alignment are
    :func:`plan`'s and :func:`mm`'s.)"""
    bf16 = dtype == torch.bfloat16
    problems = []
    if not 1 <= p.splits <= 65535:
        problems.append(f"splits={p.splits} outside 1..65535")
    if p.splits > p.ksteps:
        problems.append(f"splits={p.splits} > {p.ksteps} K steps (a slab "
                        f"of no K step)")
    if bf16 and 1 <= p.splits and \
            _cdiv(p.ksteps, p.splits) > MAX_BF16_SLAB_STEPS:
        problems.append(f"a bf16 slab of {_cdiv(p.ksteps, p.splits)} K "
                        f"steps > {MAX_BF16_SLAB_STEPS} (its accumulation "
                        f"drifts out of tolerance)")
    if not 1 <= p.cluster <= 8:
        problems.append(f"cluster={p.cluster} outside 1..8")
    elif p.splits % p.cluster:
        problems.append(f"splits={p.splits} not a multiple of "
                        f"cluster={p.cluster}")
    if out_stats and p.splits > 1:
        problems.append("the out_stats epilogue needs one slab")
    if p.ctas < 0:
        problems.append(f"ctas={p.ctas} < 0")
    if p.ctas > 0 and (not bf16 or p.splits != 1 or a_colsum
                       or out_dtype != torch.bfloat16):
        problems.append("the persistent schedule takes one bf16 slab with "
                        "a bf16 output and no a_colsum")
    if problems:
        raise ValueError(f"conv1x1: plan refused before launch "
                         f"(M={p.M} N={p.N} K={p.K}): "
                         + "; ".join(problems))


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
    """Raise on a launch's error code; ``what()`` names the launch."""
    if rc != 0:
        raise RuntimeError(
            f"conv1x1_mm launch failed: CUDA error {rc} "
            f"({lib.conv1x1_mm_error_string(rc).decode()}) at {what()}")


def _on_device(dev, fn):
    """fn() with ``dev`` the current CUDA device (entered only when it is
    not already: the device switch costs host time on every call)."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return fn()
    with torch.cuda.device(dev):
        return fn()


def mm(a, b, ta=False, tb=False, out_dtype=None, out_stats=False,
       a_colsum=False, config=None):
    """O[M,N] = op(A) @ op(B), op = transpose where ``ta``/``tb``.

    CUDA tensors run the hand-written kernel (fp32 or bf16 inputs of one
    dtype, contiguous, fp32 accumulation; output ``out_dtype``, default
    A's dtype) and anything it does not take raises.  CPU tensors run
    :func:`mm_reference`.  ``out_stats`` also returns the fp32 sum and
    sum of squares of each output column ([N] each); ``a_colsum`` (wgrad
    form only) the fp32 sum over K of each row of logical A ([M]).
    The result is ``O``, or a tuple ``(O, sum, sumsq)``, ``(O, csum)``
    or ``(O, sum, sumsq, csum)``.

    ``config``: a ``cuda/conv1x1_plan`` config launched in place of
    :func:`plan`'s (:func:`plan_for`; the autotuner's trials).  A plan
    :func:`check_launch` refuses raises ValueError before anything
    launches, on the CPU too (there with 132 SMs)."""
    M, N, K = _dims(a, b, ta, tb)
    out_dtype = out_dtype or a.dtype
    if a_colsum and not ta:
        raise ValueError("mm: the a_colsum epilogue is the wgrad (ta=True) "
                         "path")
    dev, bdev = a.device, b.device
    tuned = None
    if config is not None:
        tuned = plan_for(config, M, N, K, bool(ta), bool(tb), a.dtype,
                         _sm_count(dev) if dev.type == "cuda" else 132,
                         bool(out_stats), bool(a_colsum), out_dtype)
        check_launch(tuned, a.dtype, bool(out_stats), bool(a_colsum),
                     out_dtype)
    if dev.type == "cpu" and bdev.type == "cpu":
        return mm_reference(a, b, ta, tb, out_dtype, out_stats, a_colsum)
    if dev.type != "cuda" or dev != bdev:
        raise ValueError(f"mm: operands must share one CUDA device (or both "
                         f"lie on the CPU), got {dev} and {bdev}")
    if a.dtype not in _DTYPE_CODES or b.dtype != a.dtype:
        raise TypeError(f"mm: kernel takes fp32 or bf16 operands of one "
                        f"dtype, got {a.dtype} and {b.dtype}")
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"mm: out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("mm: kernel takes contiguous operands")
    if -(-M // _TILE) > _MAX_GRID_Y or max(M, N, K) >= 2 ** 31:
        raise ValueError(f"mm: shape M={M} N={N} K={K} exceeds the "
                         f"kernel's grid")
    p = tuned or plan(M, N, K, bool(ta), bool(tb), a.dtype, _sm_count(dev),
                      bool(out_stats), bool(a_colsum), out_dtype)
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("mm: operands must start on a 16-byte boundary "
                         "(TMA)")
    splits, cluster, ctas, parts = p.splits, p.cluster, p.ctas, p.partials
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    work = torch.empty((parts, M, N), **f32) if parts else None
    col_sum = col_sq = csum = None
    if out_stats:              # [sum, sum of squares] partials per M tile
        stats = torch.empty((2, -(-M // _TILE), N), **f32)
        col_sum, col_sq = stats[0], stats[1]
    if a_colsum:
        csum = torch.empty((max(parts, 1), M), **f32)
    if out.numel() == 0:
        return out

    def ptr(t):
        return t.data_ptr() if t is not None else None

    lib = _library()

    def launch():
        return lib.conv1x1_mm(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, int(ta),
            int(tb), _DTYPE_CODES[a.dtype], _DTYPE_CODES[out_dtype], splits,
            cluster, ctas, ptr(work), ptr(col_sum), ptr(col_sq),
            ptr(csum), torch.cuda.current_stream(dev).cuda_stream)
    rc = _on_device(dev, launch)
    _check_rc(lib, rc, lambda: f"M={M} N={N} K={K} ta={ta} tb={tb} "
              f"splits={splits} cluster={cluster} {a.dtype}->{out_dtype}")
    form = _FORM_NAMES[bool(ta), bool(tb), bool(out_stats), bool(a_colsum)]
    mm.by_form[form] += 1
    mm.by_plan[form, a.dtype, M, N, K, splits, cluster, ctas] += 1
    if parts:
        out, csum = splitk_reduce(work, out_dtype, csum, out=out)
    res = [out]
    if out_stats:
        res += list(stats.sum(1))
    if a_colsum:
        res.append(csum.reshape(M))
    return res[0] if len(res) == 1 else tuple(res)


mm.by_form = register_launch_counter(collections.Counter(),
                                     name="conv1x1_mm")
# launches by (form, dtype, M, N, K, splits, cluster, persistent blocks):
# the plan each launch took
mm.by_plan = register_launch_counter(collections.Counter(),
                                     name="conv1x1_mm.plan", kind="detail")


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
    rc = _on_device(work.device, lambda: lib.conv1x1_mm_splitk_reduce(
        work.data_ptr(), S, M * N, out.data_ptr(), _DTYPE_CODES[out_dtype],
        csum_work.data_ptr() if csum is not None else None,
        csum.data_ptr() if csum is not None else None, M,
        torch.cuda.current_stream(work.device).cuda_stream))
    _check_rc(lib, rc, lambda: f"splitk_reduce S={S} M={M} N={N}")
    mm.by_form["splitk_reduce"] += 1
    return out, csum


def launches() -> int:
    """Product launches of :func:`mm` since the last :func:`reset_counts`:
    the sum of ``mm.by_form`` over every form but ``splitk_reduce``."""
    return sum(n for form, n in mm.by_form.items()
               if form != "splitk_reduce")


def reset_counts():
    """Set every ``mm.by_form``, ``mm.by_plan`` and ``routes`` count to
    0."""
    mm.by_form.clear()
    mm.by_plan.clear()
    routes.clear()


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


def conv1x1_static_gate(channels, w_shape, pads, dils, groups) -> bool:
    """The part of the routing gate that a traced graph can decide without
    the batch: a 1x1 filter, groups 1, pad 0, dil 1, and C (``channels``,
    the input's) and M (the filter's) both divisible by 128."""
    if len(w_shape) != 4 or tuple(w_shape[2:]) != (1, 1):
        return False
    if int(groups or 1) != 1:
        return False
    if tuple(pads) != (0, 0) or tuple(dils) != (1, 1):
        return False
    return int(channels) % 128 == 0 and int(w_shape[0]) % 128 == 0


def pixels(x_shape, strides) -> int:
    """P = N * OH * OW, the rows of the matrix view."""
    N, _, H, W = x_shape
    sh, sw = int(strides[0]), int(strides[1])
    return N * ((H - 1) // sh + 1) * ((W - 1) // sw + 1)


def conv1x1_eligible(x_shape, w_shape, strides, pads, dils, groups) -> bool:
    """Static routing gate, the same as ``pallas_conv.conv1x1_eligible``:
    1x1 / groups 1 / pad 0 / dil 1 convolutions whose matrix-view dims
    (P, C, M) are all divisible by 128.  ResNet's 1x1 convs qualify from
    the 128-channel stage on; stage 1's 64-channel convs stay plain."""
    if len(x_shape) != 4:
        return False
    return conv1x1_static_gate(x_shape[1], w_shape, pads, dils, groups) \
        and pixels(x_shape, strides) % 128 == 0


# ---------------------------------------------------------------------------
# the 1x1 convolution as one custom op: what torch.export keeps in a graph
# ---------------------------------------------------------------------------
# conv2d_1x1_op's choice at each call's concrete shape: "kernel" (the P
# rule holds: conv2d_1x1, which launches mm on a card) or "conv2d" (it
# does not: F.conv2d); and "dtype", a gated conv whose operands the
# kernels do not take (float64), which ops/nn_ops.py convolves plainly.  Registered like mm.by_form, so a replayed graph
# counts the choices its capture made.
routes = register_launch_counter(collections.Counter())


@torch.library.custom_op("paddle_tpu_torch::conv2d_1x1", mutates_args=())
def conv2d_1x1_op(x: torch.Tensor, w: torch.Tensor, stride_h: int,
                  stride_w: int) -> torch.Tensor:
    """A 1x1 convolution that passed :func:`conv1x1_static_gate`, as one
    op of the graph: a traced graph (``torch.export``, a symbolic batch)
    holds it whole, and each call applies the rest of the gate, P divisible
    by 128, at its own batch: :func:`conv2d_1x1` (the kernel on a card,
    its plain version on the CPU) where it holds, ``F.conv2d`` where it
    does not, counted in ``routes``.  The shape function gives the
    kernel route's channels-last strides.  No autograd: a call that
    records gradients goes to :func:`conv2d_1x1` directly
    (``ops/nn_ops.py``)."""
    strides = (stride_h, stride_w)
    if pixels(tuple(x.shape), strides) % 128 == 0:
        routes["kernel"] += 1
        return conv2d_1x1(x, w, strides)
    routes["conv2d"] += 1
    return F.conv2d(x, w, stride=strides)


@conv2d_1x1_op.register_fake
def _conv2d_1x1_fake(x, w, stride_h, stride_w):
    N, _, H, W = x.shape
    return x.new_empty((N, w.shape[0], (H - 1) // stride_h + 1,
                        (W - 1) // stride_w + 1)).contiguous(
        memory_format=torch.channels_last)
