// Flash attention for paddle_tpu_torch (ops/flash_attention.py),
// hand-written for Hopper (sm_90a): the forward and the two backward
// kernels, each in a bf16 tensor-core form and an fp32 form.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas_kernels.py:
//
//   flash_attn_fwd      _flash_kernel (:56, pallas_call :119)
//                       out = softmax(q k^T * scale) v, and the per-row
//                       lse = m + log(l) (fp32) that the backward reads.
//   flash_attn_bwd_dq   _flash_bwd_dq_kernel (:150, pallas_call :267)
//                       dq = scale * sum_k ds k, with p = exp(s - lse) and
//                       ds = p (dp - delta), dp = dO v^T.
//   flash_attn_bwd_dkv  _flash_bwd_dkv_kernel (:195, pallas_call :287)
//                       dv = sum_q p^T dO, dk = scale * sum_q ds^T q.
//
// q, k: [BH, Tq|Tk, D]; v: [BH, Tk, Dv]; dO and out: [BH, Tq, Dv]; lse and
// delta: [BH, Tq] fp32 (delta = rowsum(dO * out) - g_lse is computed by
// the caller, as the JAX package leaves it to XLA).  All contiguous.  D
// and Dv are multiples of 16 up to 128.  Semantics kept from the TPU
// kernels: masked scores are NEG_INF = -1e30 (not -inf); l is clamped at
// 1e-20 before the divide; lse is fp32; the causal test is kpos <= qpos,
// aligned top-left (the wrapper routes causal attention here only when
// Tq == Tk); tiles wholly above the diagonal are skipped by the loop
// bounds, not by a branch per element; out, dq, dk and dv are written in
// their input's dtype.
//
// Translation.  The TPU kernels walk a grid whose last axis (key blocks
// for the forward and dq, query blocks for dk/dv) runs in order, and
// carry the running max, sum and accumulators in VMEM scratch across it.
// CUDA blocks run in parallel in no order, so that axis is a loop inside
// each block, which owns a block of query rows (forward, dq) or key rows
// (dk/dv) and keeps its accumulators in registers while the other
// operand streams through shared memory.  Each block alone writes the
// rows it owns: no atomics anywhere, so every run gives the same bits,
// as on the TPU.  Under causal masking the last query rows walk every key
// tile and the first walk one, so the forward and dq launch their longest
// blocks first (the last query rows) and dk/dv theirs (the first keys).
//
// What bounds it on an H100.  At the long-context shape (BH 8, T 65536,
// D 64, causal) each product is 2 * BH * T(T+1)/2 * D = 2.2e12 operations
// while the tensors moved are ~0.3 GB, so all three kernels are bound by
// operations at 989 TFLOP/s of bf16: 4.4e12 for the forward (2 products,
// 4.4 ms), 6.7e12 for dq (3: s, dp, ds k; 6.7 ms) and 8.8e12 for dk/dv
// (4: s, dp, p^T dO, ds^T q; 8.9 ms).  dq and dk/dv each recompute s and
// dp, as the TPU kernels do; fusing them would save two of the seven
// products but sum dq across key blocks with atomics.
//
// bf16 kernels (K2 flash_fwd_tma, K3 flash_bwd_dq_tma, K4
// flash_bwd_dkv_tma): the tensor cores' full rate needs wgmma, and wgmma
// needs its operands in 128-byte-swizzled shared memory fed without
// stalling the math, so:
//
//   block    two consumer warpgroups own 128 rows, 64 each: query rows
//            for the forward and dq, key rows for dk/dv.  A producer
//            warpgroup (one warp works) issues the loads and setmaxnreg
//            moves its registers to the consumers (384 threads; ptxas
//            still compiles a thread to at most 168 registers, but with
//            the hint dk/dv spilled less and ran faster).  At width
//            128 dk/dv's accumulators alone take 128 registers, so
//            there warp 0 of the consumers issues the loads instead (256
//            threads, up to 255 registers): side by side, that ran dk/dv
//            at width 128 without spills and faster, and the width-64
//            forms and dq slower.  Three consumer warpgroups (192 rows)
//            ran slower.  One block an SM.
//   loads    its own tiles (forward: Q; dq: Q and dO; dk/dv: K and V)
//            arrive once by TMA; the other two stream through a ring of
//            up to 4 stages on full/empty mbarriers.  Forward: K and V
//            tiles of 128 keys at width 64 and 64 at width 128, on
//            separate full barriers, so S starts before V has landed.
//            Backward: 64-row tiles (dk/dv: with the tile's lse *
//            log2(e) and delta, which the loading warp's lanes write
//            beside the stage, +inf past Tq so p = 0 there).
//            Tensor maps are 3-D [BH, T, width], boxes of 64 columns, so
//            a ragged last tile is zero-filled within its own head; they
//            are encoded per call on the host and passed as
//            __grid_constant__ parameters (hopper.cuh).  Every tile is
//            loaded the full width (64 or 128 columns, zero past D or
//            Dv), so every product runs a fixed number of wgmma steps.
//   math     fwd:   S = Q K^T                wgmma m64n128k16 (width 64)
//                                            or m64n64k16, both operands
//                                            in shared memory, K-major;
//                   O += P V                 wgmma with P from registers,
//                                            V MN-major; it stays in
//                                            flight behind the next
//                                            tile's S.
//            dq:    S = Q K^T, dP = dO V^T   wgmma m64n64k16, both
//                                            operands in shared memory,
//                                            K-major;
//                   dQ += dS K               wgmma with dS from registers,
//                                            K MN-major (transpose 1).
//            dk/dv: S^T = K Q^T, dP^T = V dO^T, as above;
//                   dV += P^T dO, dK += dS^T Q  A from registers, dO and Q
//                                            MN-major.
//            The fp32 accumulators of p and ds become the bf16 A
//            fragments in place, without a trip through shared memory.
//            Backward: S and dP are two wgmma groups: the exponentials of
//            S run while dP is computed, and the other warpgroup's
//            products run meanwhile.  A tile's dQ product (width 64) or
//            dV and dK products (width 128) stay in flight behind the
//            next tile's S and dP.
//   softmax forward: online in the exp2 domain.  The running row max m2
//            is kept in log2 units, max(s * scale * log2(e)); p =
//            exp2(s * scale * log2(e) - m2) is one FFMA and one
//            ex2.approx a score, the rescale alpha = exp2(m2_old -
//            m2_new); l sums the fp32 p; lse = m2 ln(2) + log(l), in
//            natural log for the backward.  Backward: p = exp2(s * scale
//            * log2(e) - lse * log2(e)), lse * log2(e) computed once a
//            row.  The per-element causal test runs only on the tiles
//            that cross the diagonal (and, for the forward and dq, the
//            tile holding the last key); a warpgroup skips a tile wholly
//            above its rows' diagonal.
//   output   the accumulators are scaled (forward: divided by l) and
//            rounded to bf16 once, from registers.
//
// Products.  q k^T and dO v^T multiply bf16 data, so their products are
// exact.  p v, ds k, p^T dO and ds^T q multiply an fp32 probability (or
// its gradient) by bf16 data: here p and ds are ROUNDED TO BF16 for the
// tensor cores (the TPU's MXU rounds an f32 dot the same way at default
// precision).  The forward's row sums use the fp32 p, and so does the
// backward's ds = p (dp - delta).  So against the plain fp32 formula a
// bf16 result carries a relative error of about 2^-9 per term besides
// its own rounding;
// chip_smoke.py states the tolerance.  The scale: JAX scales q in fp32
// before the product; these kernels scale s after the bf16 product, which
// differs from that only by fp32 rounding, and not at all when the scale
// is a power of two (D = 64 or D = 16).  fp32: one warp per row on the
// CUDA cores with exact fp32 FMAs in the order of the plain formula (q
// scaled first), as the fp32 form of the 1x1-conv kernel does; it is the
// tests' form, not the training path's.
//
// A wait on an mbarrier that has not completed after about 4 s traps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;   // mbarriers, TMA, wgmma, tensor maps

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;   // NEG_INF of pallas_kernels.py:38
constexpr int kThreads = 128;       // 4 warps (fp32 forms)
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  void* out;
  float* lse_out;
  void* dq;
  void* dk;
  void* dv;
  int BH, Tq, Tk, D, Dv, causal;
  float scale;
};

// Two fp32 values rounded to bf16 and packed, the lower column in the
// lower half (the fragment order).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// bf16 kernels (K2 forward, K3 dq, K4 dk/dv): TMA ring, wgmma, warp
// specialisation
// ---------------------------------------------------------------------------
constexpr int kBwdRows = 128;            // rows a block owns: 64 a warpgroup
constexpr int kBwdTile = 64;             // rows of a streamed tile
constexpr int kBwdConsumers = 256;       // two consumer warpgroups
constexpr int kBwdProducerWarp = kBwdConsumers / 32;
// A producer warpgroup issues the loads (384 threads), except in dk/dv
// at width 128, where warp 0 of the consumers issues them (256 threads):
// a 384-thread block gets at most 168 registers a thread, and dk/dv's
// accumulators alone take 128 of them at that width.
__host__ __device__ constexpr bool bwd_folded(bool dkv, int dp) {
  return dkv && dp > 64;
}
__host__ __device__ constexpr int bwd_threads(bool dkv, int dp) {
  return bwd_folded(dkv, dp) ? kBwdConsumers : kBwdConsumers + 128;
}
// Registers a thread after setmaxnreg: the producer warpgroup gives its
// share to the consumers, 128 x (40 + 2 x 232) = 64512 of the SM's 65536.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kBwdMaxStages = 4;
constexpr uint32_t kOwnBox = kBwdRows * 128;      // 128 rows x 64 columns
constexpr uint32_t kTileBox = kBwdTile * 128;     // 64 rows x 64 columns
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskedArg = kNegInf * kLog2e;    // exp2 argument of -1e30

// Shared memory of a backward block (after aligning the base to 1 KB):
// the block's own tiles (dq: Q and dO; dk/dv: K and V), 128 rows each in
// DP / 64 boxes of 64 columns; the ring of `stages` stages, each a tile
// of 64 rows of the two streamed operands (dq: K and V; dk/dv: Q and
// dO); for dk/dv, per stage, the tile's lse * log2(e) and delta
// ([stages][2][64] fp32); then the full and empty mbarrier of each stage
// and one for the block's own tiles.  ops/flash_attention.py (bwd_plan)
// computes the same number, and the launch refuses any other.
__host__ __device__ constexpr uint32_t bwd_own_bytes(int dp) {
  return 2u * dp * 256;
}
__host__ __device__ constexpr uint32_t bwd_stage_bytes(int dp) {
  return 2u * dp * 128;
}
__host__ __device__ constexpr uint32_t bwd_rows_bytes(bool dkv) {
  return dkv ? 512u : 0u;
}
__host__ __device__ constexpr uint32_t bwd_smem_bytes(bool dkv, int dp,
                                                      int stages) {
  return 1024u + bwd_own_bytes(dp) +
         stages * (bwd_stage_bytes(dp) + bwd_rows_bytes(dkv)) +
         8u * (2 * stages + 1);
}
static_assert(bwd_smem_bytes(true, 128, kBwdMaxStages) <= 232448,
              "the deepest ring must fit in an SM's shared memory");

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A fragments of a 64 x 2N fp32 accumulator (N registers a thread)
// rounded to bf16: a[kk] is the 64x16 slice of columns 16 kk.. (the
// accumulator's n-tiles 2 kk, 2 kk + 1).
template <int N>
__device__ __forceinline__ void to_a_frags(const float (&x)[N],
                                           uint32_t (&a)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
  }
}

// Every operand tile is loaded DP columns wide (NB = DP / 64 boxes of 64
// columns, zero past the operand's width), so that each product below
// runs a fixed number of wgmma steps: a step under a runtime condition
// makes the compiler merge accumulator values between wgmmas, and ptxas
// then serialises them.

// acc (64 x DP) += A (64 x 16 KS, registers) B, B a streamed tile in
// shared memory: 16 KS rows (the contraction) in boxes of 64 columns,
// MN-major.
template <int NB, int KS>
__device__ __forceinline__ void rs_product(float (&acc)[NB][32],
                                           uint32_t (&a)[KS][4], uint32_t b) {
  constexpr uint32_t box = KS * 16 * 128;
#pragma unroll
  for (int h = 0; h < NB; ++h) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      wgmma_rs_64(acc[h], a[kk],
                  sw128_desc(b + h * box + kk * 2048, box, 1024));
    }
  }
}

// d (64 x N) = X Y^T over DP columns: X this warpgroup's 64 rows of an
// owned tile (128-row boxes, at x), Y a streamed tile (N-row boxes, at
// y); both K-major.
template <int NB, int N = 64>
__device__ __forceinline__ void ss_product(float (&d)[N / 2], uint32_t x,
                                           uint32_t y) {
  constexpr uint32_t box = N * 128;
#pragma unroll
  for (int kk = 0; kk < 4 * NB; ++kk) {
    const uint64_t dx =
        sw128_desc(x + (kk / 4) * kOwnBox + (kk % 4) * 32, 16, 1024);
    const uint64_t dy =
        sw128_desc(y + (kk / 4) * box + (kk % 4) * 32, 16, 1024);
    if constexpr (N == 128) {
      wgmma_128<false, false>(d, dx, dy, kk > 0);
    } else {
      wgmma_ss_64(d, dx, dy, kk > 0);
    }
  }
}

__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
}

// dq (K3).  A block owns 128 query rows of one head (block b takes query
// block nqb - 1 - b / BH: the longest walks first); its Q and dO tiles
// arrive once, and the key tiles that the causal mask keeps stream
// through the ring with V.  Per key tile each consumer warpgroup computes
// S = Q K^T and dP = dO V^T (wgmma, both operands in shared memory), p
// and ds in registers, and dQ += ds K (wgmma, ds from registers, K
// MN-major).  Fragment: d[4g + 2h + j] is row r + 8h, column 8g + 2c + j.
template <int DP>
__global__ void __launch_bounds__(bwd_threads(false, DP), 1)
    flash_bwd_dq_tma(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_do, Args a,
                     int stages) {
  constexpr int NB = DP / 64;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t qs = base, os = base + NB * kOwnBox;
  const uint32_t ring = base + bwd_own_bytes(DP);
  const uint32_t full = ring + stages * bwd_stage_bytes(DP);
  const uint32_t empty = full + 8 * stages, once = empty + 8 * stages;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x % a.BH;
  const int nqb = (a.Tq + kBwdRows - 1) / kBwdRows;
  const int q0 = (nqb - 1 - static_cast<int>(blockIdx.x / a.BH)) * kBwdRows;
  int nkt = (a.Tk + kBwdTile - 1) / kBwdTile;
  if (a.causal) {
    nkt = min(nkt, min(q0 + kBwdRows - 1, a.Tq - 1) / kBwdTile + 1);
  }

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kBwdConsumers / 32);
    }
    mbar_init(once, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kBwdProducerWarp) {
    producer_regs();
    if (warp != kBwdProducerWarp) return;
    if (lane == 0) {
      prefetch_tensormap(&map_q);
      prefetch_tensormap(&map_k);
      prefetch_tensormap(&map_v);
      prefetch_tensormap(&map_do);
      mbar_expect_tx(once, 2 * NB * kOwnBox);
      for (int b = 0; b < NB; ++b)
        tma_load_3d(qs + b * kOwnBox, &map_q, once, b * 64, q0, bh);
      for (int b = 0; b < NB; ++b)
        tma_load_3d(os + b * kOwnBox, &map_do, once, b * 64, q0, bh);
      for (int kt = 0; kt < nkt; ++kt) {
        const int s = kt % stages;
        mbar_wait(empty + 8 * s, ((kt / stages) & 1) ^ 1);
        const uint32_t bar = full + 8 * s;
        const uint32_t kst = ring + s * bwd_stage_bytes(DP);
        mbar_expect_tx(bar, 2 * NB * kTileBox);
        for (int b = 0; b < NB; ++b)
          tma_load_3d(kst + b * kTileBox, &map_k, bar, b * 64, kt * kBwdTile,
                      bh);
        for (int b = 0; b < NB; ++b)
          tma_load_3d(kst + (NB + b) * kTileBox, &map_v, bar, b * 64,
                      kt * kBwdTile, bh);
      }
    }
    return;
  }

  consumer_regs();
  const int wg = warp / 4;
  const int r = (warp & 3) * 16 + (lane >> 2), c = lane & 3;
  const int qw = q0 + wg * 64;          // this warpgroup's first query
  const size_t qrows = static_cast<size_t>(bh) * a.Tq;
  const float sl = a.scale * kLog2e;
  float lse2[2], delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = qw + r + 8 * h;
    lse2[h] = row < a.Tq ? a.lse_in[qrows + row] * kLog2e : 0.f;
    delta[h] = row < a.Tq ? a.delta[qrows + row] : 0.f;
  }
  float dq[NB][32];
#pragma unroll
  for (int h = 0; h < NB; ++h) {
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[h][i] = 0.f;
  }
  // A stage is released once the dq product that reads it has run.  At
  // width 64 the product of key tile i is left in flight and awaited in
  // tile i + 1, behind that tile's own products; at width 128 its
  // accumulators and operands would not fit the 168 registers a thread
  // of a 384-thread block (ptxas would serialise every wgmma), so it is
  // awaited at once.
  auto release = [&](int stage) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * stage);
  };
  int held = -1;                        // stage of the product in flight
  uint32_t ds[4][4];                    // its A operand
  mbar_wait(once, 0);
  for (int kt = 0; kt < nkt; ++kt) {
    const int s = kt % stages;
    mbar_wait(full + 8 * s, (kt / stages) & 1);
    __syncwarp();          // wgmma's .aligned forms need the warp converged
    const int k0 = kt * kBwdTile;
    const bool live = qw < a.Tq && (!a.causal || k0 <= qw + 63);
    if (!live) {
      wgmma_wait<0>();
      if (held >= 0) release(held);
      release(s);
      held = -1;
      continue;
    }
    const uint32_t kst = ring + s * bwd_stage_bytes(DP);
    const uint32_t vst = kst + NB * kTileBox;
    float sc[32], dp[32];
    wgmma_fence();
    ss_product<NB>(sc, qs + wg * 8192, kst);
    wgmma_commit();
    ss_product<NB>(dp, os + wg * 8192, vst);
    wgmma_commit();
    wgmma_wait<1>();       // the last tile's dq product and S have run
    fence_acc(sc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(ds[kk]);
    if (held >= 0) release(held);
    // p = exp(s scale - lse); the mask only on tiles that cross the
    // diagonal or the last key
    const bool masked = (a.causal && k0 + 63 > qw) || k0 + kBwdTile > a.Tk;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      float arg = fmaf(sc[i], sl, -lse2[h]);
      if (masked) {
        const int key = k0 + 8 * (i >> 2) + 2 * c + (i & 1);
        if (key >= a.Tk || (a.causal && key > qw + r + 8 * h))
          arg = kMaskedArg - lse2[h];
      }
      sc[i] = ex2(arg);
    }
    __syncwarp();
    wgmma_wait<0>();
    fence_acc(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      dp[i] = sc[i] * (dp[i] - delta[(i >> 1) & 1]);
    }
    to_a_frags(dp, ds);
    wgmma_fence();
    rs_product<NB>(dq, ds, kst);          // dq += ds K
    wgmma_commit();
    held = s;
    if constexpr (NB > 1) {
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < NB; ++h) fence_acc(dq[h]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(ds[kk]);
      release(s);
      held = -1;
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < NB; ++h) fence_acc(dq[h]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) fence_regs(ds[kk]);
  if (held >= 0) release(held);

  bf16* out = static_cast<bf16*>(a.dq) + qrows * a.D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = qw + r + 8 * h;
    if (row >= a.Tq) continue;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int col = b * 64 + 8 * g + 2 * c;
        if (col < a.D) {
          *reinterpret_cast<__nv_bfloat162*>(
              out + static_cast<size_t>(row) * a.D + col) =
              __floats2bfloat162_rn(dq[b][4 * g + 2 * h] * a.scale,
                                    dq[b][4 * g + 2 * h + 1] * a.scale);
        }
      }
    }
  }
}

// dk and dv (K4).  A block owns 128 key rows of one head (block b takes
// key block b / BH: under causal masking the first key blocks walk the
// most query tiles, so they launch first); its K and V tiles arrive
// once, and the query tiles that see them stream through the ring with
// dO, their lse * log2(e) and delta, which the loading warp's lanes
// write beside each stage (lse +inf past Tq, so p = 0 there).  Per query
// tile each consumer warpgroup computes the transposed scores S^T = K Q^T
// and dP^T = V dO^T (wgmma from shared memory), p^T and ds^T in
// registers, and dV += p^T dO, dK += ds^T Q (wgmma, A from registers, B
// MN-major).  No atomics: each block alone writes its rows of dk and dv.
template <int DP>
__global__ void __launch_bounds__(bwd_threads(true, DP), 1)
    flash_bwd_dkv_tma(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_do, Args a,
                      int stages) {
  constexpr int NB = DP / 64;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t ks = base, vs = base + NB * kOwnBox;
  const uint32_t ring = base + bwd_own_bytes(DP);
  const uint32_t rows_off = bwd_own_bytes(DP) + stages * bwd_stage_bytes(DP);
  float* rows = reinterpret_cast<float*>(smem + rows_off);   // [stages][128]
  const uint32_t full = base + rows_off + stages * bwd_rows_bytes(true);
  const uint32_t empty = full + 8 * stages, once = empty + 8 * stages;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x % a.BH;
  const int k0 = static_cast<int>(blockIdx.x / a.BH) * kBwdRows;
  const int nqt = (a.Tq + kBwdTile - 1) / kBwdTile;
  // query tiles that see this key block: under causal masking, from the
  // tile holding query row k0 on
  const int qt0 = a.causal ? k0 / kBwdTile : 0;
  const size_t qrows = static_cast<size_t>(bh) * a.Tq;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1 + 32);    // the TMA's and the lanes' rows
      mbar_init(empty + 8 * s, kBwdConsumers / 32);
    }
    mbar_init(once, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Query tile qt0 + it into stage it % stages with its dO tile, and
  // its lse * log2(e) and delta beside it; called by one whole warp.
  const int ntiles = max(nqt - qt0, 0);
  auto load = [&](int it) {
    const int qt = qt0 + it, s = it % stages;
    // this lane's rows qt * 64 + lane and + 32, read before the wait
    float l2[2], d[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = qt * kBwdTile + lane + 32 * h;
      l2[h] = qi < a.Tq ? a.lse_in[qrows + qi] * kLog2e
                        : __int_as_float(0x7f800000);
      d[h] = qi < a.Tq ? a.delta[qrows + qi] : 0.f;
    }
    mbar_wait(empty + 8 * s, ((it / stages) & 1) ^ 1);
    const uint32_t bar = full + 8 * s;
    if (lane == 0) {
      const uint32_t qst = ring + s * bwd_stage_bytes(DP);
      mbar_expect_tx(bar, 2 * NB * kTileBox);
      for (int b = 0; b < NB; ++b)
        tma_load_3d(qst + b * kTileBox, &map_q, bar, b * 64, qt * kBwdTile,
                    bh);
      for (int b = 0; b < NB; ++b)
        tma_load_3d(qst + (NB + b) * kTileBox, &map_do, bar, b * 64,
                    qt * kBwdTile, bh);
    }
    float* rs = rows + s * 128;
    rs[lane] = l2[0];
    rs[lane + 32] = l2[1];
    rs[64 + lane] = d[0];
    rs[96 + lane] = d[1];
    mbar_arrive(bar);
    __syncwarp();
  };
  auto load_owned = [&] {
    prefetch_tensormap(&map_q);
    prefetch_tensormap(&map_k);
    prefetch_tensormap(&map_v);
    prefetch_tensormap(&map_do);
    mbar_expect_tx(once, 2 * NB * kOwnBox);
    for (int b = 0; b < NB; ++b)
      tma_load_3d(ks + b * kOwnBox, &map_k, once, b * 64, k0, bh);
    for (int b = 0; b < NB; ++b)
      tma_load_3d(vs + b * kOwnBox, &map_v, once, b * 64, k0, bh);
  };
  const int ahead = stages > 2 ? stages - 2 : 1;     // as in dq
  if constexpr (bwd_folded(true, DP)) {
    if (warp == 0) {
      if (lane == 0) load_owned();
      for (int it = 0; it < min(ahead, ntiles); ++it) load(it);
    }
  } else {
    if (warp >= kBwdProducerWarp) {
      producer_regs();
      if (warp == kBwdProducerWarp) {
        if (lane == 0) load_owned();
        for (int it = 0; it < ntiles; ++it) load(it);
      }
      return;
    }
    consumer_regs();
  }
  const int wg = warp / 4;
  const int r = (warp & 3) * 16 + (lane >> 2), c = lane & 3;
  const int kw = k0 + wg * 64;          // this warpgroup's first key
  const float sl = a.scale * kLog2e;
  float dk[NB][32], dv[NB][32];
#pragma unroll
  for (int h = 0; h < NB; ++h) {
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[h][i] = dv[h][i] = 0.f;
  }
  // As in dq, a tile's dv and dk products may stay in flight until the
  // next tile's S^T and dP^T have run; only at width 128 (256 threads).
  // At width 64 their A operands would push the consumers past the 168
  // registers a thread of a 384-thread block, and ptxas would then
  // serialise every wgmma, so they are awaited at once.
  auto release = [&](int stage) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * stage);
  };
  int held = -1;                        // stage of the products in flight
  uint32_t pa[4][4], da[4][4];          // their A operands
  mbar_wait(once, 0);
  for (int qt = qt0, it = 0; qt < nqt; ++qt, ++it) {
    if constexpr (bwd_folded(true, DP)) {
      if (warp == 0 && it + ahead < ntiles) load(it + ahead);
    }
    const int s = it % stages;
    mbar_wait(full + 8 * s, (it / stages) & 1);
    __syncwarp();
    const int q0 = qt * kBwdTile;
    const bool live = kw < a.Tk && (!a.causal || q0 + 63 >= kw);
    if (!live) {
      wgmma_wait<0>();
      if (held >= 0) release(held);
      release(s);
      held = -1;
      continue;
    }
    const uint32_t qst = ring + s * bwd_stage_bytes(DP);
    const uint32_t ost = qst + NB * kTileBox;
    const float* lr = rows + s * 128;
    float st[32], dpt[32];   // transposed: rows are this warpgroup's keys
    wgmma_fence();
    ss_product<NB>(st, ks + wg * 8192, qst);
    wgmma_commit();
    ss_product<NB>(dpt, vs + wg * 8192, ost);
    wgmma_commit();
    wgmma_wait<1>();       // the last tile's products and S^T have run
    fence_acc(st);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(pa[kk]);
      fence_regs(da[kk]);
    }
    if (held >= 0) release(held);
    const bool masked = a.causal && kw + 63 > q0;
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const float2 l = *reinterpret_cast<const float2*>(lr + 8 * g + 2 * c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * g + e;
        const float lj = (e & 1) ? l.y : l.x;
        float arg = fmaf(st[i], sl, -lj);
        if (masked && kw + r + 8 * (e >> 1) > q0 + 8 * g + 2 * c + (e & 1))
          arg = kMaskedArg - lj;
        st[i] = ex2(arg);
      }
    }
    __syncwarp();
    wgmma_wait<0>();
    fence_acc(dpt);
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const float2 d =
          *reinterpret_cast<const float2*>(lr + 64 + 8 * g + 2 * c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * g + e;
        dpt[i] = st[i] * (dpt[i] - ((e & 1) ? d.y : d.x));
      }
    }
    to_a_frags(st, pa);
    to_a_frags(dpt, da);
    wgmma_fence();
    rs_product<NB>(dv, pa, ost);          // dv += p^T dO
    rs_product<NB>(dk, da, qst);          // dk += ds^T q
    wgmma_commit();
    held = s;
    if constexpr (!bwd_folded(true, DP)) {
      wgmma_wait<0>();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(pa[kk]);
        fence_regs(da[kk]);
      }
      release(s);
      held = -1;
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < NB; ++h) {
    fence_acc(dv[h]);
    fence_acc(dk[h]);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    fence_regs(pa[kk]);
    fence_regs(da[kk]);
  }
  if (held >= 0) release(held);

  const size_t krows = static_cast<size_t>(bh) * a.Tk;
  bf16* dkp = static_cast<bf16*>(a.dk) + krows * a.D;
  bf16* dvp = static_cast<bf16*>(a.dv) + krows * a.Dv;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = kw + r + 8 * h;
    if (key >= a.Tk) continue;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int col = b * 64 + 8 * g + 2 * c;
        if (col < a.D) {
          *reinterpret_cast<__nv_bfloat162*>(
              dkp + static_cast<size_t>(key) * a.D + col) =
              __floats2bfloat162_rn(dk[b][4 * g + 2 * h] * a.scale,
                                    dk[b][4 * g + 2 * h + 1] * a.scale);
        }
        if (col < a.Dv) {
          *reinterpret_cast<__nv_bfloat162*>(
              dvp + static_cast<size_t>(key) * a.Dv + col) =
              __floats2bfloat162_rn(dv[b][4 * g + 2 * h],
                                    dv[b][4 * g + 2 * h + 1]);
        }
      }
    }
  }
}

// forward (K2).  A block owns 128 query rows of one head (block b takes
// query block nqb - 1 - b / BH: the longest walks first); its Q tile
// arrives once, and the key tiles the causal mask keeps stream through
// the ring, K and V on separate full barriers so that S starts before V
// has landed.  Per key tile each consumer warpgroup computes S = Q K^T
// (wgmma, both operands in shared memory), the online softmax in the
// exp2 domain in registers, and O += P V (wgmma, P from registers, V
// MN-major), which stays in flight behind the next tile's S.  A
// warpgroup's live tiles are a prefix of the block's walk (under the
// causal mask it stops at its own diagonal), and the tiles that need the
// per-element mask are the last of them.
//
// Softmax: m2 is the running row max in log2 units, max(s scale
// log2(e)); p = exp2(s scale log2(e) - m2), one FFMA and one ex2 a score;
// the rescale is alpha = exp2(m2_old - m2_new).  A tile that needs the
// mask first turns its scores into log2 units itself (kMaskedArg where
// masked) and then runs the same code with a factor of 1.  Each thread
// sums the fp32 p of its own columns; the quad of lanes that shares a row
// adds those sums once, at the end.  The launch passes scale >= 0 (the
// wrapper negates q for a negative scale), so max(s) scale is the max of
// the scaled scores.
//
// What bounds it: at width 64 the exponentials take as long as the two
// products (an SM's ex2 rate is 16 a clock, its bf16 rate about 4096
// operations a clock, and a score costs one ex2 and 4 x 64 operations),
// so the schedule has to run one warpgroup's ex2s under the other's
// wgmmas.  Side by side at 8 x 65536 x 64 causal, this schedule ran
// fastest; slower were 64-key tiles at width 64, issuing S of tile kt
// before P V of tile kt - 1 so that the ex2s run under one's own P V,
// S in two 64-key halves so that one half's softmax runs under the
// other's products, ping-pong between the warpgroups on mbarriers, a
// tree row max, and a persistent grid in snake order (the last two
// within the noise).  A second S accumulator for the next tile does not
// fit the 168 registers a thread of a 384-thread block gets at 128-key
// tiles.  Taken apart, the softmax's instructions other than its ex2s
// cost more than the ex2s do: the kernel waits on latency, not on a
// unit's rate.
constexpr int kFwdThreads = kBwdConsumers + 128;
constexpr int kFwdMaxStages = 4;
constexpr float kLn2 = 0.6931471805599453f;

// Keys a streamed tile holds: 128 at width 64 (S is 64 x 128, 64
// registers a thread), 64 at width 128, where O alone takes 64.
__host__ __device__ constexpr int fwd_tile(int dp) {
  return dp > 64 ? 64 : 128;
}
// Shared memory of a forward block (after aligning the base to 1 KB):
// the Q tile, 128 rows in DP / 64 boxes of 64 columns; the ring of
// `stages` stages, each a K tile and a V tile of fwd_tile(DP) rows; the
// K-full, V-full and empty mbarrier of each stage and one for Q.
// ops/flash_attention.py (fwd_plan) computes the same number, and the
// launch refuses any other.
__host__ __device__ constexpr uint32_t fwd_q_bytes(int dp) {
  return dp * 256u;
}
__host__ __device__ constexpr uint32_t fwd_stage_bytes(int dp) {
  return 4u * dp * fwd_tile(dp);
}
__host__ __device__ constexpr uint32_t fwd_smem_bytes(int dp, int stages) {
  return 1024u + fwd_q_bytes(dp) + stages * fwd_stage_bytes(dp) +
         8u * (3 * stages + 1);
}
static_assert(fwd_smem_bytes(128, kFwdMaxStages) <= 232448 &&
                  fwd_smem_bytes(64, kFwdMaxStages) <= 232448,
              "the deepest ring must fit in an SM's shared memory");

template <int DP>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_fwd_tma(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v, Args a,
                  int stages) {
  constexpr int NB = DP / 64, TK = fwd_tile(DP);
  constexpr int NS = TK / 2, KS = TK / 16;   // S registers, P k-steps
  constexpr uint32_t kvbox = TK * 128;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t qs = base, ring = base + fwd_q_bytes(DP);
  const uint32_t fullk = ring + stages * fwd_stage_bytes(DP);
  const uint32_t fullv = fullk + 8 * stages, empty = fullv + 8 * stages;
  const uint32_t once = empty + 8 * stages;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x % a.BH;
  const int nqb = (a.Tq + kBwdRows - 1) / kBwdRows;
  const int q0 = (nqb - 1 - static_cast<int>(blockIdx.x / a.BH)) * kBwdRows;
  int nkt = (a.Tk + TK - 1) / TK;
  if (a.causal) nkt = min(nkt, min(q0 + kBwdRows - 1, a.Tq - 1) / TK + 1);
  auto stage_of = [&](int kt) {
    return ring + (kt % stages) * fwd_stage_bytes(DP);
  };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(fullk + 8 * s, 1);
      mbar_init(fullv + 8 * s, 1);
      mbar_init(empty + 8 * s, kBwdConsumers / 32);
    }
    mbar_init(once, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kBwdProducerWarp) {
    producer_regs();
    if (warp != kBwdProducerWarp) return;
    if (lane == 0) {
      prefetch_tensormap(&map_q);
      prefetch_tensormap(&map_k);
      prefetch_tensormap(&map_v);
      mbar_expect_tx(once, NB * kOwnBox);
      for (int b = 0; b < NB; ++b)
        tma_load_3d(qs + b * kOwnBox, &map_q, once, b * 64, q0, bh);
      for (int kt = 0; kt < nkt; ++kt) {
        const int s = kt % stages;
        mbar_wait(empty + 8 * s, ((kt / stages) & 1) ^ 1);
        const uint32_t kst = stage_of(kt);
        mbar_expect_tx(fullk + 8 * s, NB * kvbox);
        for (int b = 0; b < NB; ++b)
          tma_load_3d(kst + b * kvbox, &map_k, fullk + 8 * s, b * 64,
                      kt * TK, bh);
        mbar_expect_tx(fullv + 8 * s, NB * kvbox);
        for (int b = 0; b < NB; ++b)
          tma_load_3d(kst + (NB + b) * kvbox, &map_v, fullv + 8 * s, b * 64,
                      kt * TK, bh);
      }
    }
    return;
  }

  consumer_regs();
  const int wg = warp / 4;
  const int r = (warp & 3) * 16 + (lane >> 2), c = lane & 3;
  const int qw = q0 + wg * 64;          // this warpgroup's first query
  const uint32_t qa = qs + wg * 8192;   // its 64 rows of the Q tile
  const float sl = a.scale * kLog2e;
  // live tiles: a prefix, up to this warpgroup's diagonal
  const int nlive = qw >= a.Tq ? 0
                    : a.causal ? min(nkt, (qw + 63) / TK + 1)
                               : nkt;
  auto release = [&](int stage) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * stage);
  };
  float m2[2] = {kMaskedArg, kMaskedArg}, l[2] = {0.f, 0.f};
  float o[NB][32];
#pragma unroll
  for (int h = 0; h < NB; ++h) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[h][i] = 0.f;
  }
  uint32_t p[KS][4];                    // P, the A operand of P V
  int held = -1;                        // stage of the P V in flight
  mbar_wait(once, 0);
  for (int kt = 0; kt < nlive; ++kt) {
    const int s = kt % stages, k0 = kt * TK;
    const uint32_t ph = (kt / stages) & 1;
    float sc[NS];
    mbar_wait(fullk + 8 * s, ph);
    __syncwarp();          // wgmma's .aligned forms need the warp converged
    wgmma_fence();
    ss_product<NB, TK>(sc, qa, stage_of(kt));
    wgmma_commit();
    wgmma_wait<0>();       // S, and the last tile's P V
    fence_acc(sc);
#pragma unroll
    for (int h = 0; h < NB; ++h) fence_acc(o[h]);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) fence_regs(p[kk]);
    if (held >= 0) release(held);
    // the per-element mask only on the tiles that cross the diagonal or
    // hold the last key; there the scores turn into log2 units first
    float f = sl;
    if ((a.causal && k0 + TK - 1 > qw) || k0 + TK > a.Tk) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int key = k0 + 8 * (i >> 2) + 2 * c + (i & 1);
        const int row = qw + r + 8 * ((i >> 1) & 1);
        const bool keep = key < a.Tk && !(a.causal && key > row);
        sc[i] = keep ? sc[i] * sl : kMaskedArg;
      }
      f = 1.f;
    }
    // fragment: sc[4g + 2h + j] is row r + 8h, key k0 + 8g + 2c + j; the
    // quad of lanes with the same r holds a row
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = sc[2 * h];
#pragma unroll
      for (int i = 1; i < NS / 2; ++i)
        mx = fmaxf(mx, sc[4 * (i >> 1) + 2 * h + (i & 1)]);
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float mn = fmaxf(m2[h], mx * f);
      alpha[h] = ex2(m2[h] - mn);
      m2[h] = mn;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int h = (i >> 1) & 1;
      sc[i] = ex2(fmaf(sc[i], f, -m2[h]));
      sum[h] += sc[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
#pragma unroll
    for (int h = 0; h < NB; ++h) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[h][i] *= alpha[(i >> 1) & 1];
    }
    to_a_frags(sc, p);
    mbar_wait(fullv + 8 * s, ph);
    __syncwarp();
    wgmma_fence();
    rs_product<NB, KS>(o, p, stage_of(kt) + NB * kvbox);   // O += P V
    wgmma_commit();
    held = s;
  }
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < NB; ++h) fence_acc(o[h]);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) fence_regs(p[kk]);
  if (held >= 0) release(held);
  // the tiles past this warpgroup's diagonal: released unread
  for (int kt = nlive; kt < nkt; ++kt) {
    mbar_wait(fullk + 8 * (kt % stages), (kt / stages) & 1);
    mbar_wait(fullv + 8 * (kt % stages), (kt / stages) & 1);
    release(kt % stages);
  }

  bf16* out = static_cast<bf16*>(a.out) + static_cast<size_t>(bh) * a.Tq * a.Dv;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
    const int row = qw + r + 8 * h;
    if (row >= a.Tq) continue;
    const float ls = fmaxf(l[h], 1e-20f);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int col = b * 64 + 8 * g + 2 * c;
        if (col < a.Dv) {
          *reinterpret_cast<__nv_bfloat162*>(
              out + static_cast<size_t>(row) * a.Dv + col) =
              __floats2bfloat162_rn(o[b][4 * g + 2 * h] / ls,
                                    o[b][4 * g + 2 * h + 1] / ls);
        }
      }
    }
    if (c == 0) {
      a.lse_out[static_cast<size_t>(bh) * a.Tq + row] =
          m2[h] * kLn2 + logf(ls);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 forms: one warp per row, exact fp32 FMAs on the CUDA cores.  Each
// lane takes one key (or query) of a 32-wide chunk for the dot products
// and 4 columns (lane + 32 i) of the output row.
// ---------------------------------------------------------------------------
constexpr int kRowsF32 = kThreads / 32;
constexpr int kMaxDim = 128;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__global__ void __launch_bounds__(kThreads) flash_fwd_f32(Args a) {
  __shared__ float qs[kRowsF32][kMaxDim];
  const int groups = (a.Tq + kRowsF32 - 1) / kRowsF32;
  const int bh = blockIdx.x / groups;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = (blockIdx.x % groups) * kRowsF32 + warp;
  if (row >= a.Tq) return;
  const size_t qrow = static_cast<size_t>(bh) * a.Tq + row;
  const float* q = static_cast<const float*>(a.q) + qrow * a.D;
  const float* k = static_cast<const float*>(a.k) + static_cast<size_t>(bh) * a.Tk * a.D;
  const float* v = static_cast<const float*>(a.v) + static_cast<size_t>(bh) * a.Tk * a.Dv;
  float* qr = qs[warp];
  for (int d = lane; d < a.D; d += 32) qr[d] = q[d] * a.scale;
  __syncwarp();
  const int nkeys = a.causal ? min(a.Tk, row + 1) : a.Tk;
  float m = kNegInf, l = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < nkeys; c0 += 32) {
    const int j = c0 + lane;
    float s = kNegInf;
    if (j < nkeys) {
      const float* kr = k + static_cast<size_t>(j) * a.D;
      float dot = 0.f;
      for (int d = 0; d < a.D; ++d) dot = fmaf(qr[d], kr[d], dot);
      s = dot;
    }
    const float mx = fmaxf(m, warp_max(s));
    const float p = expf(s - mx);
    const float alpha = expf(m - mx);
    l = l * alpha + warp_sum(p);
    m = mx;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] *= alpha;
    const int n = min(32, nkeys - c0);
    for (int jj = 0; jj < n; ++jj) {
      const float pj = __shfl_sync(kFull, p, jj);
      const float* vr = v + static_cast<size_t>(c0 + jj) * a.Dv;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = lane + 32 * i;
        if (col < a.Dv) acc[i] = fmaf(pj, vr[col], acc[i]);
      }
    }
  }
  const float ls = fmaxf(l, 1e-20f);
  float* out = static_cast<float*>(a.out) + qrow * a.Dv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = lane + 32 * i;
    if (col < a.Dv) out[col] = acc[i] / ls;
  }
  if (lane == 0) a.lse_out[qrow] = m + logf(ls);
}

__global__ void __launch_bounds__(kThreads) flash_bwd_dq_f32(Args a) {
  __shared__ float qs[kRowsF32][kMaxDim];
  __shared__ float dos[kRowsF32][kMaxDim];
  const int groups = (a.Tq + kRowsF32 - 1) / kRowsF32;
  const int bh = blockIdx.x / groups;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = (blockIdx.x % groups) * kRowsF32 + warp;
  if (row >= a.Tq) return;
  const size_t qrow = static_cast<size_t>(bh) * a.Tq + row;
  const float* q = static_cast<const float*>(a.q) + qrow * a.D;
  const float* dout = static_cast<const float*>(a.dout) + qrow * a.Dv;
  const float* k = static_cast<const float*>(a.k) + static_cast<size_t>(bh) * a.Tk * a.D;
  const float* v = static_cast<const float*>(a.v) + static_cast<size_t>(bh) * a.Tk * a.Dv;
  float* qr = qs[warp];
  float* dr = dos[warp];
  for (int d = lane; d < a.D; d += 32) qr[d] = q[d] * a.scale;
  for (int d = lane; d < a.Dv; d += 32) dr[d] = dout[d];
  __syncwarp();
  const float lse = a.lse_in[qrow], delta = a.delta[qrow];
  const int nkeys = a.causal ? min(a.Tk, row + 1) : a.Tk;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < nkeys; c0 += 32) {
    const int j = c0 + lane;
    float ds = 0.f;
    if (j < nkeys) {
      const float* kr = k + static_cast<size_t>(j) * a.D;
      const float* vr = v + static_cast<size_t>(j) * a.Dv;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < a.D; ++d) s = fmaf(qr[d], kr[d], s);
      for (int d = 0; d < a.Dv; ++d) dp = fmaf(dr[d], vr[d], dp);
      ds = expf(s - lse) * (dp - delta);
    }
    const int n = min(32, nkeys - c0);
    for (int jj = 0; jj < n; ++jj) {
      const float dsj = __shfl_sync(kFull, ds, jj);
      const float* kr = k + static_cast<size_t>(c0 + jj) * a.D;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = lane + 32 * i;
        if (col < a.D) acc[i] = fmaf(dsj, kr[col], acc[i]);
      }
    }
  }
  float* dq = static_cast<float*>(a.dq) + qrow * a.D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = lane + 32 * i;
    if (col < a.D) dq[col] = acc[i] * a.scale;
  }
}

__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_f32(Args a) {
  __shared__ float ks[kRowsF32][kMaxDim];
  __shared__ float vs[kRowsF32][kMaxDim];
  const int groups = (a.Tk + kRowsF32 - 1) / kRowsF32;
  const int bh = blockIdx.x / groups;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kj = (blockIdx.x % groups) * kRowsF32 + warp;
  if (kj >= a.Tk) return;
  const size_t krow = static_cast<size_t>(bh) * a.Tk + kj;
  const size_t qrows = static_cast<size_t>(bh) * a.Tq;
  const float* q = static_cast<const float*>(a.q) + qrows * a.D;
  const float* dout = static_cast<const float*>(a.dout) + qrows * a.Dv;
  float* kr = ks[warp];
  float* vr = vs[warp];
  for (int d = lane; d < a.D; d += 32)
    kr[d] = static_cast<const float*>(a.k)[krow * a.D + d];
  for (int d = lane; d < a.Dv; d += 32)
    vr[d] = static_cast<const float*>(a.v)[krow * a.Dv + d];
  __syncwarp();
  const int qbegin = a.causal ? kj : 0;   // queries with kpos <= qpos
  float dk[4] = {0.f, 0.f, 0.f, 0.f}, dv[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = qbegin; c0 < a.Tq; c0 += 32) {
    const int i = c0 + lane;
    float p = 0.f, ds = 0.f;
    if (i < a.Tq) {
      const float* qi = q + static_cast<size_t>(i) * a.D;
      const float* di = dout + static_cast<size_t>(i) * a.Dv;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < a.D; ++d) s = fmaf(qi[d] * a.scale, kr[d], s);
      for (int d = 0; d < a.Dv; ++d) dp = fmaf(di[d], vr[d], dp);
      p = expf(s - a.lse_in[qrows + i]);
      ds = p * (dp - a.delta[qrows + i]);
    }
    const int n = min(32, a.Tq - c0);
    for (int ii = 0; ii < n; ++ii) {
      const float pi = __shfl_sync(kFull, p, ii);
      const float dsi = __shfl_sync(kFull, ds, ii);
      const float* qi = q + static_cast<size_t>(c0 + ii) * a.D;
      const float* di = dout + static_cast<size_t>(c0 + ii) * a.Dv;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = lane + 32 * c;
        if (col < a.Dv) dv[c] = fmaf(pi, di[col], dv[c]);
        if (col < a.D) dk[c] = fmaf(dsi, qi[col] * a.scale, dk[c]);
      }
    }
  }
  float* dkp = static_cast<float*>(a.dk) + krow * a.D;
  float* dvp = static_cast<float*>(a.dv) + krow * a.Dv;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int col = lane + 32 * c;
    if (col < a.D) dkp[col] = dk[c];
    if (col < a.Dv) dvp[col] = dv[c];
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
template <typename Kernel>
cudaError_t launch(Kernel kernel, long long blocks, size_t smem,
                   cudaStream_t stream, const Args& a) {
  if (blocks <= 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

bool bad_args(int BH, int Tq, int Tk, int D, int Dv, int dtype) {
  auto bad_dim = [](int d) { return d < 16 || d > kMaxDim || d % 16 != 0; };
  return BH < 0 || Tq < 0 || Tk < 0 || bad_dim(D) || bad_dim(Dv) ||
         (dtype != 0 && dtype != 1);
}

long long groups(int T) { return (T + kRowsF32 - 1) / kRowsF32; }

enum Which { kFwd, kDq, kDkv };

// The launch a bf16 kernel takes from ops/flash_attention.py (fwd_plan,
// bwd_plan): rows a block owns, stages of its ring, its shared memory.
struct Plan {
  int rows, stages, smem;
};

// The forward (K2) on its TMA ring: tensor maps of q, k and v encoded
// here, per call, as 3-D [BH, T, width] maps read in boxes of 64 columns
// and 128 (Q) or fwd_tile(DP) (K, V) rows, so a ragged last tile is
// zero-filled within its own head.
template <int DP>
cudaError_t launch_fwd(const Args& a, const Plan& p, cudaStream_t s) {
  if (p.rows != kBwdRows || p.stages < 2 || p.stages > kFwdMaxStages ||
      p.smem != static_cast<int>(fwd_smem_bytes(DP, p.stages)) ||
      !(a.scale >= 0.f)) {
    return cudaErrorInvalidValue;
  }
  const long long blocks = a.BH * ((a.Tq + kBwdRows - 1) / kBwdRows);
  if (blocks <= 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  constexpr uint32_t tk = fwd_tile(DP);
  CUtensorMap mq, mk, mv;
  if (!tensor_map_3d(&mq, a.q, a.D, a.Tq, a.BH, 64, kBwdRows) ||
      !tensor_map_3d(&mk, a.k, a.D, a.Tk, a.BH, 64, tk) ||
      !tensor_map_3d(&mv, a.v, a.Dv, a.Tk, a.BH, 64, tk)) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_tma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (e != cudaSuccess) return e;
  flash_fwd_tma<DP><<<static_cast<unsigned>(blocks), kFwdThreads, p.smem,
                      s>>>(mq, mk, mv, a, p.stages);
  return cudaGetLastError();
}

// The backward kernels (K3, K4) on their TMA ring: tensor maps of q, k,
// v and dO encoded here, per call, as 3-D [BH, T, width] maps read in
// boxes of 64 columns and 128 (owned) or 64 (streamed) rows, so a ragged
// last tile is zero-filled within its own head.
template <int DP>
cudaError_t launch_bwd(Which w, const Args& a, const Plan& p,
                       cudaStream_t s) {
  const bool dkv = w == kDkv;
  if (p.rows != kBwdRows || p.stages < 1 || p.stages > kBwdMaxStages ||
      p.smem != static_cast<int>(bwd_smem_bytes(dkv, DP, p.stages))) {
    return cudaErrorInvalidValue;
  }
  const long long blocks =
      a.BH * (((dkv ? a.Tk : a.Tq) + kBwdRows - 1) / kBwdRows);
  if (blocks <= 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const uint32_t qbox = dkv ? kBwdTile : kBwdRows;
  const uint32_t kbox = dkv ? kBwdRows : kBwdTile;
  CUtensorMap mq, mk, mv, mo;
  if (!tensor_map_3d(&mq, a.q, a.D, a.Tq, a.BH, 64, qbox) ||
      !tensor_map_3d(&mk, a.k, a.D, a.Tk, a.BH, 64, kbox) ||
      !tensor_map_3d(&mv, a.v, a.Dv, a.Tk, a.BH, 64, kbox) ||
      !tensor_map_3d(&mo, a.dout, a.Dv, a.Tq, a.BH, 64, qbox)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = dkv ? flash_bwd_dkv_tma<DP> : flash_bwd_dq_tma<DP>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (e != cudaSuccess) return e;
  kernel<<<static_cast<unsigned>(blocks), bwd_threads(dkv, DP), p.smem,
           s>>>(mq, mk, mv, mo, a, p.stages);
  return cudaGetLastError();
}

// The bf16 kernels come in two widths: head dims up to 64, and up to 128.
template <int DP>
cudaError_t launch_bf16(Which w, const Args& a, const Plan& p,
                        cudaStream_t s) {
  return w == kFwd ? launch_fwd<DP>(a, p, s) : launch_bwd<DP>(w, a, p, s);
}

int run(Which w, const Args& a, int dtype, const Plan& p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return static_cast<int>(a.D <= 64 && a.Dv <= 64
                                ? launch_bf16<64>(w, a, p, s)
                                : launch_bf16<128>(w, a, p, s));
  }
  switch (w) {
    case kFwd:
      return static_cast<int>(
          launch(flash_fwd_f32, a.BH * groups(a.Tq), 0, s, a));
    case kDq:
      return static_cast<int>(
          launch(flash_bwd_dq_f32, a.BH * groups(a.Tq), 0, s, a));
    default:
      return static_cast<int>(
          launch(flash_bwd_dkv_f32, a.BH * groups(a.Tk), 0, s, a));
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (all of q, k, v, dO and the
// outputs; lse and delta are fp32).  Each call launches one kernel on
// `stream`, does not synchronise, and returns cudaGetLastError() (0 =
// launched); arguments the kernels do not take return
// cudaErrorInvalidValue before any launch.  Each entry takes the bf16
// launch's plan (rows a block, stages, shared-memory bytes) from
// ops/flash_attention.py's fwd_plan or bwd_plan, and refuses a plan that
// differs from the kernel's own layout; the fp32 forms ignore it.  The
// bf16 forward takes scale >= 0 only.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* out, void* lse, int BH, int Tq, int Tk,
                              int D, int Dv, int causal, float scale,
                              int dtype, int rows, int stages, int smem,
                              void* stream) {
  if (bad_args(BH, Tq, Tk, D, Dv, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{q, k, v, nullptr, nullptr, nullptr, out, static_cast<float*>(lse),
         nullptr, nullptr, nullptr, BH, Tq, Tk, D, Dv, causal, scale};
  return run(kFwd, a, dtype, Plan{rows, stages, smem}, stream);
}

extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int BH, int Tq,
                                 int Tk, int D, int Dv, int causal,
                                 float scale, int dtype, int rows,
                                 int stages, int smem, void* stream) {
  if (bad_args(BH, Tq, Tk, D, Dv, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), nullptr, nullptr, dq, nullptr,
         nullptr, BH, Tq, Tk, D, Dv, causal, scale};
  return run(kDq, a, dtype, Plan{rows, stages, smem}, stream);
}

extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  int BH, int Tq, int Tk, int D, int Dv,
                                  int causal, float scale, int dtype,
                                  int rows, int stages, int smem,
                                  void* stream) {
  if (bad_args(BH, Tq, Tk, D, Dv, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), nullptr, nullptr, nullptr, dk, dv,
         BH, Tq, Tk, D, Dv, causal, scale};
  return run(kDkv, a, dtype, Plan{rows, stages, smem}, stream);
}

extern "C" const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
