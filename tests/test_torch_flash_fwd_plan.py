"""The launch plan of the bf16 attention forward kernel (K2,
``flash_fwd_tma`` in paddle_tpu_torch/csrc/flash_attn.cu), checked on the
CPU: ``fwd_plan`` (rows a block, key tile, ring stages, shared memory,
grid, block order), ``fwd_walk`` (the key tiles each block and
warpgroup visits, and where it masks), and a plain-torch emulation of
the walk (the online softmax in the exp2 domain, P rounded to bf16 for
P V) against the JAX package's Pallas forward in interpret mode, on the
same numpy-seeded inputs."""
import collections
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_kernels as jpk
from paddle_tpu_torch.ops import flash_attention as fa
from test_torch_flash_bwd_plan import (EMULATION_CASES, LOG2E, MASKED_ARG,
                                       WALK_SHAPES, WIDTHS, _bf16, _rows)

R = np.random.RandomState(13)
LN2 = np.float32(0.6931471805599453)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("D,Dv", list(itertools.product(WIDTHS, WIDTHS)))
def test_plan_fits_every_width(D, Dv):
    """Every head-size pair the kernel takes gets a plan whose shared
    memory fits an SM (232,448 bytes on an H100), with 1 KB-aligned TMA
    destinations (128-byte swizzle), 128-key tiles at width 64 and
    64-key tiles at width 128, and one block per 128 query rows."""
    p = fa.fwd_plan(3, 1000, 700, D, Dv, False)
    assert p.width == (64 if max(D, Dv) <= 64 else 128)
    kp = p.fwd
    assert kp.kernel == "fwd" and kp.rows == 128
    assert kp.tile == {64: 128, 128: 64}[p.width]
    assert 2 <= kp.stages <= fa.FWD_MAX_STAGES
    assert kp.smem <= fa.SMEM_LIMIT == 232448
    q_tile = kp.rows * p.width * 2
    box = kp.tile * 128                  # a K or V box: 64 columns
    stage = 2 * kp.tile * p.width * 2    # a K and a V tile
    assert q_tile % 1024 == 0 and box % 1024 == 0 and stage % 1024 == 0
    assert kp.smem >= 1024 + q_tile + kp.stages * stage
    assert kp.grid == 3 * -(-1000 // 128)
    assert kp.order == "longest first"


def test_plan_takes_the_deepest_ring_that_fits():
    for width, (D, Dv) in ((64, (64, 64)), (128, (128, 128)),
                           (128, (32, 80))):
        kp = fa.fwd_plan(1, 256, 256, D, Dv, True).fwd
        deeper = fa._fwd_smem(width, kp.stages + 1)
        assert kp.stages == fa.FWD_MAX_STAGES or deeper > fa.SMEM_LIMIT
        assert kp.smem == fa._fwd_smem(width, kp.stages)


@pytest.mark.parametrize("D,Dv", [(0, 64), (8, 64), (24, 64), (144, 64),
                                  (64, 40), (64, 160)])
def test_plan_refuses_other_head_sizes(D, Dv):
    with pytest.raises(ValueError, match="multiples of 16"):
        fa.fwd_plan(1, 64, 64, D, Dv, False)


def test_wrappers_pass_the_plan_to_the_kernel():
    """The bf16 launch gets (rows, stages, smem) from the plan, which the
    C entry holds against its own layout; the fp32 form takes none."""
    for dims in ((8, 65536, 65536, 64, 64), (4, 4096, 4096, 128, 128)):
        kp = fa.fwd_plan(*dims, True).fwd
        assert fa._launch_args(dims, 1, True, "fwd") == (
            128, kp.stages, kp.smem)
        assert fa._launch_args(dims, 0, True, "fwd") == (0, 0, 0)


# ---------------------------------------------------------------------------
# the tile walk
# ---------------------------------------------------------------------------
def _kept(Tq, Tk, t, causal):
    """{(64-row query tile, key tile of t keys)} holding a pair the mask
    keeps (kpos <= qpos under causal, top-left)."""
    return {(i, j) for i in range(-(-Tq // 64)) for j in range(-(-Tk // t))
            if not causal or j * t <= min(i * 64 + 63, Tq - 1)}


@pytest.mark.parametrize("width", [64, 128])
@pytest.mark.parametrize("shape", WALK_SHAPES)
def test_walk_visits_each_kept_pair_once(shape, width):
    """Each (query tile, key tile) pair that the mask keeps is computed
    exactly once, by the warpgroup that owns the query tile; no tile
    wholly above a warpgroup's diagonal or past the sequence is computed;
    every block of the grid owns distinct rows."""
    BH, Tq, Tk, causal = shape
    plan = fa.fwd_plan(BH, Tq, Tk, width, width, causal)
    seen, owners = collections.Counter(), []
    for bh, q0, tiles in fa.fwd_walk(plan):
        owners.append((bh, q0))
        for kt, live, _ in tiles:
            for wg in (0, 1):
                if live[wg]:
                    seen[(bh, q0 // 64 + wg, kt)] += 1
    want = {(bh,) + pair for bh in range(BH)
            for pair in _kept(Tq, Tk, plan.fwd.tile, causal)}
    assert set(seen) == want
    assert set(seen.values()) == {1}
    assert len(set(owners)) == len(owners) == plan.fwd.grid


@pytest.mark.parametrize("width", [64, 128])
@pytest.mark.parametrize("shape", WALK_SHAPES)
def test_walk_masks_only_where_the_mask_bites(shape, width):
    """A live tile that holds a pair the mask removes (kpos > qpos under
    causal, or a key past Tk) applies the per-element mask; a tile wholly
    below the diagonal and inside Tk does not, and where Tq is a multiple
    of 64 the mask runs on exactly those tiles."""
    BH, Tq, Tk, causal = shape
    plan = fa.fwd_plan(BH, Tq, Tk, width, width, causal)
    t = plan.fwd.tile
    for _, q0, tiles in fa.fwd_walk(plan):
        for kt, live, masked in tiles:
            for wg in (0, 1):
                if not live[wg]:
                    continue
                qs = [q for q in range(q0 + 64 * wg, q0 + 64 * wg + 64)
                      if q < Tq]
                ks = range(kt * t, kt * t + t)
                needed = any(k >= Tk or (causal and k > q)
                             for q in qs for k in ks)
                assert masked[wg] >= needed
                assert masked[wg] <= ((causal and max(ks) > min(qs))
                                      or max(ks) >= Tk)
                if Tq % 64 == 0:
                    assert masked[wg] == needed


@pytest.mark.parametrize("T", [1000, 65536])
def test_longest_blocks_launch_first(T):
    """Under the causal mask a block's walk grows with its rows; blocks
    are numbered so that the longest walks take the lowest block
    indices, which the card starts first."""
    plan = fa.fwd_plan(8, T, T, 64, 64, True)
    walks = fa.fwd_walk(plan)
    lengths = [sum(any(live) for _, live, _ in tiles)
               for _, _, tiles in walks]
    assert lengths == sorted(lengths, reverse=True)
    assert lengths[0] > lengths[-1]
    assert walks[0][1] == (-(-T // 128) - 1) * 128
    assert [bh for bh, _, _ in walks[:8]] == list(range(8))


# ---------------------------------------------------------------------------
# the walk emulated in plain torch against the JAX Pallas forward
# ---------------------------------------------------------------------------
def emulate_fwd(plan, q, k, v, scale, rescale=True):
    """K2's walk in fp32: per block and warpgroup, S = Q K^T of each live
    key tile; on the tiles the walk marks, the scores become log2 units
    first (masked: the exp2 argument of NEG_INF) and the factor is 1;
    m2 = max(m2, max(s) f), alpha = exp2(m2_old - m2), p = exp2(s f -
    m2), l = l alpha + rowsum(p) from the fp32 p, O = O alpha + bf16(p)
    V; at the end l clamped at 1e-20, out = O / l, lse = m2 ln(2) +
    log(l).  ``rescale=False`` leaves out alpha (a wrong walk)."""
    BH, Tq, D = q.shape
    Tk, Dv = k.shape[1], v.shape[2]
    t = plan.fwd.tile
    sl = np.float32(scale) * LOG2E
    out = torch.zeros(BH, Tq, Dv)
    lse = torch.zeros(BH, Tq, 1)
    for bh, q0, tiles in fa.fwd_walk(plan):
        for wg in (0, 1):
            qw = q0 + 64 * wg
            Q = _rows(q[bh], qw)
            m2 = torch.full((64, 1), float(MASKED_ARG))
            l = torch.zeros(64, 1)
            acc = torch.zeros(64, Dv)
            for kt, live, masked in tiles:
                if not live[wg]:
                    continue
                k0 = kt * t
                K, V = _rows(k[bh], k0, t), _rows(v[bh], k0, t)
                s, f = Q @ K.T, sl
                if masked[wg]:
                    qpos = qw + torch.arange(64)[:, None]
                    key = k0 + torch.arange(t)[None, :]
                    keep = (key < Tk) & ((key <= qpos) if plan.causal
                                         else torch.ones((), dtype=bool))
                    s, f = torch.where(keep, s * sl, float(MASKED_ARG)), 1.0
                mn = torch.maximum(m2, s.amax(-1, keepdim=True) * f)
                alpha = torch.exp2(m2 - mn) if rescale else torch.ones(1)
                m2 = mn
                p = torch.exp2(s * f - m2)
                l = l * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + _bf16(p) @ V
            n = max(0, min(64, Tq - qw))
            ls = l.clamp_min(1e-20)
            out[bh, qw:qw + n] = (acc / ls)[:n]
            lse[bh, qw:qw + n] = (m2 * LN2 + torch.log(ls))[:n]
    return out, lse


def _pallas_fwd(case, dtype):
    """(q, k, v as fp32 torch tensors, out, lse) of ``_flash_fwd`` (Pallas
    in interpret mode, 64-row blocks) on numpy-seeded inputs."""
    BH, Tq, Tk, D, Dv, causal = case
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(R.randn(*s).astype("float32"), jdt)
                  for s in ((BH, Tq, D), (BH, Tk, D), (BH, Tk, Dv)))
    jout, jlse = jpk._flash_fwd(jq, jk, jv, causal, D ** -0.5, 64, 64, True)

    def t(x):
        return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))

    return t(jq), t(jk), t(jv), t(jout), t(jlse)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", EMULATION_CASES)
def test_emulated_walk_matches_pallas_interpret(case, dtype):
    """out and lse from the emulated K2 walk against ``_flash_fwd``
    (Pallas in interpret mode) on the same inputs.  Tolerance: the walk
    rounds p to bf16 for P V (2^-9 relative a term) and, in bf16, both
    sides round out once; out within 1e-2 relative plus 1e-2 of its
    largest value, as the backward's emulation; lse (fp32 on both sides,
    exp2 and log2 units against exp) within 1e-3."""
    BH, Tq, Tk, D, Dv, causal = case
    q, k, v, want, want_lse = _pallas_fwd(case, dtype)
    plan = fa.fwd_plan(BH, Tq, Tk, D, Dv, causal)
    out, lse = emulate_fwd(plan, q, k, v, D ** -0.5)
    out = out.to(getattr(torch, dtype)).float()
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-2,
                               atol=1e-2 * want.abs().max().item())
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), rtol=0,
                               atol=1e-3)


def _skip_masked_tiles(walk):
    return lambda p: [(bh, q0, [x for x in tiles if not any(x[2])])
                      for bh, q0, tiles in walk(p)]


@pytest.mark.parametrize("wrong", ["skips the diagonal tiles",
                                   "omits the rescale"])
def test_emulation_sees_a_wrong_walk(monkeypatch, wrong):
    """The emulation is held tightly enough to see a wrong walk: one that
    skips the tiles crossing the diagonal, or one that omits the rescale
    by alpha, moves out or lse far beyond the tolerance, while the plan's
    walk stays within it."""
    case = (1, 512, 512, 64, 64, True)
    q, k, v, want, want_lse = _pallas_fwd(case, "float32")
    plan = fa.fwd_plan(*case)
    lim = 1e-2 * want.abs() + 1e-2 * want.abs().max()

    def within(out, lse):
        return bool(((out - want).abs() <= lim).all()) and \
            bool(((lse - want_lse).abs() <= 1e-3).all())

    assert within(*emulate_fwd(plan, q, k, v, 64 ** -0.5))
    if wrong == "skips the diagonal tiles":
        monkeypatch.setattr(fa, "fwd_walk", _skip_masked_tiles(fa.fwd_walk))
        got = emulate_fwd(plan, q, k, v, 64 ** -0.5)
    else:
        got = emulate_fwd(plan, q, k, v, 64 ** -0.5, rescale=False)
    assert not within(*got)
