"""The launch plan of the bf16 attention backward kernels (K3 dq, K4
dk/dv in paddle_tpu_torch/csrc/flash_attn.cu), checked on the CPU:
``bwd_plan`` (rows a block, ring stages, shared memory, grid, block
order), ``bwd_walk`` (the tiles each block visits, as the kernels walk
them), and a plain-torch emulation of both walks (the transposed scores
of K4, exp2 with the scale folded in, p and ds rounded to bf16 for the
tensor cores) against the JAX package's Pallas backward in interpret
mode, on the same numpy-seeded inputs."""
import collections
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_kernels as jpk
from paddle_tpu_torch.ops import flash_attention as fa

R = np.random.RandomState(11)
WIDTHS = range(16, 129, 16)
LOG2E = np.float32(1.4426950408889634)
MASKED_ARG = np.float32(-1e30) * LOG2E


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("D,Dv", list(itertools.product(WIDTHS, WIDTHS)))
def test_plan_fits_every_width(D, Dv):
    """Every head-size pair the kernels take gets a plan whose shared
    memory fits an SM (232,448 bytes on an H100), with 1 KB-aligned TMA
    destinations (128-byte swizzle) and one block per 128 owned rows."""
    p = fa.bwd_plan(3, 1000, 700, D, Dv, False)
    assert p.width == (64 if max(D, Dv) <= 64 else 128)
    for kp, T in ((p.dq, 1000), (p.dkv, 700)):
        assert kp.rows == 128 and kp.tile == 64
        assert 1 <= kp.stages <= fa.BWD_MAX_STAGES
        assert kp.smem <= fa.SMEM_LIMIT == 232448
        owned = 2 * kp.rows * p.width * 2
        streamed = 2 * kp.tile * p.width * 2
        assert owned % 1024 == 0 and streamed % 1024 == 0
        assert kp.smem >= 1024 + owned + kp.stages * streamed
        assert kp.grid == 3 * -(-T // 128)
        assert kp.order == "longest first"


def test_plan_takes_the_deepest_ring_that_fits():
    for width, (D, Dv) in ((64, (64, 64)), (128, (128, 128))):
        p = fa.bwd_plan(1, 256, 256, D, Dv, True)
        assert p.width == width
        for kp in (p.dq, p.dkv):
            deeper = fa._bwd_smem(kp.kernel, width, kp.stages + 1)
            assert kp.stages == fa.BWD_MAX_STAGES or \
                deeper > fa.SMEM_LIMIT


@pytest.mark.parametrize("D", [0, 8, 24, 144])
def test_plan_refuses_other_head_sizes(D):
    with pytest.raises(ValueError, match="multiples of 16"):
        fa.bwd_plan(1, 64, 64, D, 64, False)


def test_wrappers_pass_the_plan_to_the_kernels():
    """The bf16 launch gets (rows, stages, smem) from the plan, which the
    C entry holds against its own layout; the fp32 forms take none."""
    dims = (8, 65536, 65536, 64, 64)
    p = fa.bwd_plan(*dims, True)
    assert fa._launch_args(dims, 1, True, "bwd_dq") == (
        128, p.dq.stages, p.dq.smem)
    assert fa._launch_args(dims, 1, True, "bwd_dkv") == (
        128, p.dkv.stages, p.dkv.smem)
    assert fa._launch_args(dims, 0, True, "bwd_dq") == (0, 0, 0)


# ---------------------------------------------------------------------------
# the tile walks
# ---------------------------------------------------------------------------
WALK_SHAPES = [          # (BH, Tq, Tk, causal)
    (2, 128, 128, False),
    (2, 128, 128, True),
    (3, 100, 100, True),         # ragged last tile, inside a block
    (1, 640, 640, True),         # several blocks, the last half empty
    (2, 200, 130, False),        # cross-attention, ragged
    (1, 64, 320, False),
    (1, 320, 192, True),         # causal, Tq > Tk (top-left)
    (1, 192, 320, True),         # causal, Tq < Tk: keys past Tq unseen
]


def _kept(Tq, Tk, causal):
    """{(query tile, key tile)} of 64-row tiles holding a pair the mask
    keeps (kpos <= qpos under causal, top-left)."""
    t = fa.BWD_TILE
    return {(i, j) for i in range(-(-Tq // t)) for j in range(-(-Tk // t))
            if not causal or j * t <= min(i * t + t - 1, Tq - 1)}


def _visited(plan, kernel):
    """Counter of (bh, query tile, key tile) that a live warpgroup
    computes on, and the blocks' (bh, owned row) in launch order."""
    seen, owners = collections.Counter(), []
    for bh, row0, tiles in fa.bwd_walk(plan, kernel):
        owners.append((bh, row0))
        for t, live, _ in tiles:
            for wg in (0, 1):
                if live[wg]:
                    own = row0 // fa.BWD_TILE + wg
                    pair = (own, t) if kernel == "bwd_dq" else (t, own)
                    seen[(bh,) + pair] += 1
    return seen, owners


@pytest.mark.parametrize("kernel", ["bwd_dq", "bwd_dkv"])
@pytest.mark.parametrize("shape", WALK_SHAPES)
def test_walk_visits_each_kept_pair_once(shape, kernel):
    """Each (query tile, key tile) that the mask keeps is computed by
    exactly one warpgroup of one block, and no tile wholly above the
    diagonal or past the sequence is computed; every block of the grid
    owns distinct rows."""
    BH, Tq, Tk, causal = shape
    plan = fa.bwd_plan(BH, Tq, Tk, 64, 64, causal)
    seen, owners = _visited(plan, kernel)
    want = {(bh,) + pair for bh in range(BH)
            for pair in _kept(Tq, Tk, causal)}
    assert set(seen) == want
    assert set(seen.values()) == {1}
    assert len(set(owners)) == len(owners) == getattr(
        plan, kernel[4:]).grid


@pytest.mark.parametrize("kernel", ["bwd_dq", "bwd_dkv"])
@pytest.mark.parametrize("shape", WALK_SHAPES)
def test_walk_masks_only_where_the_mask_bites(shape, kernel):
    """A live tile that holds a pair the mask removes (kpos > qpos under
    causal, or for dq a key past Tk) applies the per-element mask; a
    tile wholly below the diagonal does not, and where T is a multiple
    of 64 the mask runs on exactly those tiles."""
    BH, Tq, Tk, causal = shape
    t = fa.BWD_TILE
    plan = fa.bwd_plan(BH, Tq, Tk, 64, 64, causal)
    for _, row0, tiles in fa.bwd_walk(plan, kernel):
        for tile, live, masked in tiles:
            for wg in (0, 1):
                if not live[wg]:
                    continue
                own = range(row0 + 64 * wg, row0 + 64 * wg + 64)
                other = range(tile * t, tile * t + t)
                qs, ks = (own, other) if kernel == "bwd_dq" else (other, own)
                qs = [q for q in qs if q < Tq]
                needed = any((causal and k > q) or
                             (kernel == "bwd_dq" and k >= Tk)
                             for q in qs for k in ks
                             if kernel == "bwd_dq" or k < Tk)
                crosses = causal and max(ks) > min(qs)
                assert masked[wg] >= needed
                assert masked[wg] <= (crosses or (kernel == "bwd_dq" and
                                                  max(ks) >= Tk))
                if Tq % t == 0 and Tk % t == 0:
                    assert masked[wg] == needed


@pytest.mark.parametrize("kernel", ["bwd_dq", "bwd_dkv"])
@pytest.mark.parametrize("T", [1000, 65536])
def test_longest_blocks_launch_first(kernel, T):
    """Under the causal mask the blocks' walks shrink (dq) or grow (dk/dv)
    with their rows; blocks are numbered so that the longest walks take
    the lowest block indices, which the card starts first."""
    plan = fa.bwd_plan(8, T, T, 64, 64, True)
    walks = fa.bwd_walk(plan, kernel)
    lengths = [sum(any(live) for _, live, _ in tiles)
               for _, _, tiles in walks]
    assert lengths == sorted(lengths, reverse=True)
    assert lengths[0] > lengths[-1]
    first = walks[0][1]
    assert first == (0 if kernel == "bwd_dkv" else
                     (-(-T // 128) - 1) * 128)


# ---------------------------------------------------------------------------
# the walks emulated in plain torch against the JAX Pallas backward
# ---------------------------------------------------------------------------
def _rows(x, r0, n=64, fill=0.0):
    """Rows [r0, r0 + n) of [T, W], ``fill`` past T (TMA's zero fill)."""
    out = torch.full((n, x.shape[1]), fill, dtype=x.dtype)
    part = x[r0:r0 + n]
    out[:part.shape[0]] = part
    return out


def _bf16(x):
    return x.to(torch.bfloat16).float()


def emulate_dkv(plan, q, k, v, g, lse, delta, scale):
    """K4's walk in fp32: per block and warpgroup, the transposed scores
    S^T = K Q^T and dP^T = V dO^T of each live query tile, p^T =
    exp2(S^T scale log2(e) - lse log2(e)) (lse +inf past Tq), ds^T =
    p^T (dP^T - delta), dV += bf16(p^T) dO and dK += bf16(ds^T) Q; dk
    scaled once at the end."""
    BH, Tq, D = q.shape
    Tk, Dv = k.shape[1], v.shape[2]
    sl = np.float32(scale) * LOG2E
    l2 = lse.reshape(BH, Tq, 1) * LOG2E
    dk = torch.zeros(BH, Tk, D)
    dv = torch.zeros(BH, Tk, Dv)
    for bh, k0, tiles in fa.bwd_walk(plan, "bwd_dkv"):
        for wg in (0, 1):
            kw = k0 + 64 * wg
            K, V = _rows(k[bh], kw), _rows(v[bh], kw)
            acc_k, acc_v = torch.zeros(64, D), torch.zeros(64, Dv)
            for qt, live, masked in tiles:
                if not live[wg]:
                    continue
                q0 = qt * 64
                Q, O = _rows(q[bh], q0), _rows(g[bh], q0)
                L = _rows(l2[bh], q0, fill=float("inf"))[:, 0]
                De = _rows(delta[bh].reshape(Tq, 1), q0)[:, 0]
                arg = K @ Q.T * sl - L[None, :]
                if masked[wg]:
                    key = kw + torch.arange(64)[:, None]
                    qpos = q0 + torch.arange(64)[None, :]
                    arg = torch.where(key > qpos, MASKED_ARG - L[None, :],
                                      arg)
                p = torch.exp2(arg)
                ds = p * (V @ O.T - De[None, :])
                acc_v += _bf16(p) @ O
                acc_k += _bf16(ds) @ Q
            n = max(0, min(64, Tk - kw))
            dk[bh, kw:kw + n] = acc_k[:n] * np.float32(scale)
            dv[bh, kw:kw + n] = acc_v[:n]
    return dk, dv


def emulate_dq(plan, q, k, v, g, lse, delta, scale):
    """K3's walk in fp32: per block and warpgroup, S = Q K^T and dP =
    dO V^T of each live key tile, p = exp2(...) with the mask on the
    tiles the walk marks (keys past Tk too), ds = p (dP - delta), dQ +=
    bf16(ds) K; scaled once at the end."""
    BH, Tq, D = q.shape
    Tk = k.shape[1]
    sl = np.float32(scale) * LOG2E
    l2 = lse.reshape(BH, Tq) * LOG2E
    dq = torch.zeros(BH, Tq, D)
    for bh, q0, tiles in fa.bwd_walk(plan, "bwd_dq"):
        for wg in (0, 1):
            qw = q0 + 64 * wg
            Q, O = _rows(q[bh], qw), _rows(g[bh], qw)
            L = _rows(l2[bh].reshape(Tq, 1), qw)[:, 0]
            De = _rows(delta[bh].reshape(Tq, 1), qw)[:, 0]
            acc = torch.zeros(64, D)
            for kt, live, masked in tiles:
                if not live[wg]:
                    continue
                k0 = kt * 64
                K, V = _rows(k[bh], k0), _rows(v[bh], k0)
                arg = Q @ K.T * sl - L[:, None]
                if masked[wg]:
                    qpos = qw + torch.arange(64)[:, None]
                    key = k0 + torch.arange(64)[None, :]
                    cut = (key >= Tk) | ((key > qpos) if plan.causal
                                         else torch.zeros((), dtype=bool))
                    arg = torch.where(cut, MASKED_ARG - L[:, None], arg)
                ds = torch.exp2(arg) * (O @ V.T - De[:, None])
                acc += _bf16(ds) @ K
            n = max(0, min(64, Tq - qw))
            dq[bh, qw:qw + n] = acc[:n] * np.float32(scale)
    return dq


EMULATION_CASES = [      # (BH, Tq, Tk, D, Dv, causal)
    (2, 128, 128, 32, 32, False),
    (2, 128, 128, 32, 32, True),
    (2, 64, 128, 16, 32, False),          # cross-attention, Dv != D
    (1, 128, 128, 64, 64, True),
    (1, 256, 256, 64, 64, True),          # two blocks a head
    (1, 192, 192, 128, 96, True),         # width 128, Dv != D
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", EMULATION_CASES)
def test_emulated_walks_match_pallas_interpret(case, dtype):
    """dq from the emulated K3 walk and dk, dv from the emulated
    transposed K4 walk against ``_flash_bwd`` (Pallas in interpret mode,
    64-row blocks) from the same (out, lse) and cotangent.  Tolerance:
    the walks round p and ds to bf16 for the products (2^-9 relative a
    term) and, in bf16, the JAX side rounds its outputs once; 1e-2
    relative plus 1e-2 of the tensor's largest value, as the bf16
    parity test of the plain versions."""
    BH, Tq, Tk, D, Dv, causal = case
    q = R.randn(BH, Tq, D).astype("float32")
    k = R.randn(BH, Tk, D).astype("float32")
    v = R.randn(BH, Tk, Dv).astype("float32")
    g = R.randn(BH, Tq, Dv).astype("float32")
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    scale = D ** -0.5
    jq, jk, jv, jg = (jnp.asarray(x, jdt) for x in (q, k, v, g))
    jout, jlse = jpk._flash_fwd(jq, jk, jv, causal, scale, 64, 64, True)
    jd = jpk._flash_bwd(jq, jk, jv, jout, jlse, jg, causal, scale, 64, 64,
                        True)

    def t(x):
        return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))

    tq, tk, tv, tg, out = (t(x) for x in (jq, jk, jv, jg, jout))
    lse = t(jlse)
    delta = fa.flash_delta(tg.to(tdt), out.to(tdt))
    plan = fa.bwd_plan(BH, Tq, Tk, D, Dv, causal)
    got = (emulate_dq(plan, tq, tk, tv, tg, lse, delta, scale),
           *emulate_dkv(plan, tq, tk, tv, tg, lse, delta, scale))
    for name, a, b in zip("qkv", got, jd):
        want = np.asarray(jnp.asarray(b, jnp.float32))
        a = a.to(tdt).float().numpy()
        np.testing.assert_allclose(a, want, rtol=1e-2,
                                   atol=1e-2 * np.abs(want).max(),
                                   err_msg=f"d{name}")


def test_emulation_sees_a_wrong_walk(monkeypatch):
    """The emulation is held tightly enough to see a wrong walk: one that
    skipped the tiles crossing the diagonal moves dk far beyond the
    tolerance, while the plan's walk stays within it."""
    BH, T, D = 1, 256, 64
    q, k, v, g = (torch.from_numpy(R.randn(BH, T, D).astype("float32"))
                  for _ in range(4))
    out, lse = fa.flash_fwd_reference(q, k, v, True)
    delta = fa.flash_delta(g, out)
    plan = fa.bwd_plan(BH, T, T, D, D, True)
    ref = fa.flash_bwd_reference(q, k, v, out, lse, g, True)[1]
    lim = 1e-2 * ref.abs() + 1e-2 * ref.abs().max()
    right = emulate_dkv(plan, q, k, v, g, lse, delta, D ** -0.5)[0]
    assert bool(((right - ref).abs() <= lim).all())
    walk = fa.bwd_walk
    monkeypatch.setattr(fa, "bwd_walk", lambda p, kernel: [
        (bh, r0, [x for x in tiles if not any(x[2])])
        for bh, r0, tiles in walk(p, kernel)])
    wrong = emulate_dkv(plan, q, k, v, g, lse, delta, D ** -0.5)[0]
    assert not bool(((wrong - ref).abs() <= lim).all())
