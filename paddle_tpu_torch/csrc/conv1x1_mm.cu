// Blocked matrix product O[M,N] = op(A) @ op(B) for the 1x1 convolutions
// of paddle_tpu_torch (ops/conv1x1.py), hand-written for Hopper (sm_90a),
// with a split-K form for the weight gradient and the two fused epilogues.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_conv.py:69 (_mm_kernel,
// launched by _mm at :141-193) in all the forms its callers use: op(A) is
// A or A^T (storage [M,K] or [K,M]), op(B) is B or B^T (storage [K,N] or
// [N,K]), inputs fp32 or bf16, accumulation fp32, output fp32 or bf16.
// The 1x1 convolution's three passes (pallas_conv.py:16-18, 235-246):
//
//   forward  out[P,M] = x[P,C] @ w[M,C]^T      ta=0 tb=1
//   dgrad    dx[P,C]  = g[P,M] @ w[M,C]        ta=0 tb=0
//   wgrad    dw[M,C]  = g[P,M]^T @ x[P,C]      ta=1 tb=0, K = P (deep)
//
// and the epilogues of the TPU kernel:
//
//   out_stats (:120-122)  per-column fp32 sum and sum of squares of the
//                         fp32 accumulator, before rounding; one partial
//                         row per M tile ([gridDim.y, N]), which the
//                         wrapper reduces to [N].
//   a_colsum  (:104-114,  per-row sum over K of logical A (A stored
//              123-126)   [K, M]: the column sums of gout on the wgrad
//                         path, the bias / BN-beta gradient), fp32, [M].
//
// Translation.  The TPU kernel walks a (m, n, k) grid with k sequential
// and keeps the f32 accumulator in VMEM scratch across grid steps.  Here
// blocks run in parallel in no order, so the K axis is a loop inside
// each block: one block owns one 128x128 output tile and its accumulator
// stays in registers.
//
// bf16 (mm_bf16_tma), the AMP path.  What bounds it on an H100: at
// ResNet-50's shapes a product does 2*P*C*M operations over
// (P*C + M*C + P*M)*2 bytes, 100 to 616 operations a byte against the
// ~295 at which the tensor cores (989 TFLOP/s), not HBM (3.35 TB/s),
// become the limit: most shapes are bound by bytes, the deep ones
// (P = 6272, and P = 25088 with C and M >= 512) by operations.  The
// design answers both:
//
//   loads    A ring of stages of BK = 64, each 32 KB (A and B tiles),
//            filled by TMA (cp.async.bulk.tensor, 128-byte swizzle) in
//            the operands' STORAGE orientation.  One producer warp issues
//            the loads; each stage has a full mbarrier (armed with the
//            stage's bytes) and an empty one (one arrival per consumer
//            warp).  A block holds 107 KB, so two share an SM.  Ragged
//            edges are TMA's zero fill; stores are clipped.  The tensor
//            maps are encoded on the host per call
//            (cuTensorMapEncodeTiled, fetched once through
//            cudaGetDriverEntryPoint: no -lcuda) and passed as
//            __grid_constant__ parameters.
//   schedule Most launches of the forward and dgrad have K = 128-512, 2
//            to 8 steps a tile, so a block's first loads and its
//            epilogue would cost as much as its main loop.  A launch of
//            one slab is persistent: two blocks an SM walk the tiles
//            with a 2-stage ring and a bf16 staging tile of their own,
//            and the producer loads the next tile while the consumers
//            store the last.  Split launches run one tile a block with a
//            3-stage ring (they fill the card once).
//   math     wgmma.mma_async m64n128k16 bf16 -> fp32 straight from the
//            shared-memory descriptors; two consumer warpgroups own 64
//            rows each.  The transposes are the descriptors' major-ness,
//            never a copy: K-major (A stored [M,K], B stored [N,K]) or
//            MN-major (A stored [K,M], B stored [K,N]), the latter with
//            wgmma's transpose immediates and TMA boxes of 64 along M
//            or N.  The forward's A and B are K-major, the dgrad's B is
//            N-major, the wgrad's A and B are M- and N-major.  One wgmma
//            group stays in flight while the next stage is awaited.
//   epilogue The tile is staged in shared memory (bf16 in the persistent
//            schedule, fp32 over the ring otherwise) and leaves in
//            16-byte vector stores, rounded once.
//            out_stats sums the fp32 accumulators in registers, across
//            each warp with shuffles and across the 8 warps in shared
//            memory.  a_colsum sums each A stage (swizzle-aware) while
//            its wgmma runs, before the stage is released, in the
//            blocks of the first N tile only: the TPU kernel's j == 0.
//   split K  The wgrad's output dw [Cout, Cin] is 1 to 128 tiles while
//            K = P runs to 401408, so K is cut into S slabs of whole BK
//            steps on gridDim.z, and the slabs of one tile form a thread
//            block cluster of up to 8 blocks.  Each block leaves its fp32
//            tile in its own shared memory; after a cluster barrier each
//            block sums a slice of rows over the cluster's shared memory
//            (DSMEM) in rank order and writes the output, or, where S
//            exceeds the cluster, one fp32 partial [S / cluster, M, N]
//            that splitk_reduce sums in order.  No atomics: the result
//            does not depend on the schedule.  The forward and dgrad
//            split the same way, within one cluster, where fewer tiles
//            than SMs would leave the card idle.  The plan (S, cluster,
//            stages) is made in Python (ops/conv1x1.py, plan).
//
// fp32 (mm_f32_tma), the exact path (Executor() without amp): products
// are fp32 FFMAs on the CUDA cores (no TF32, so the numbers are the plain
// version's but for the summation order).  What bounds it: 67 TFLOP/s of
// fp32 is 128 FFMA lanes an SM, so at 2*P*C*M operations over
// (P*C + M*C + P*M)*4 bytes every ResNet-50 shape is bound by operations.
// The design keeps the FFMA share of issued instructions high and the
// loads off the arithmetic:
//
//   loads    A ring of 2 stages of BK = 32, each 32 KB (A and B tiles),
//            filled by TMA in the operands' storage orientation.  Thread
//            0 issues the loads and refills a stage once the 8 warps have
//            arrived on its empty mbarrier.  MN-major tiles (the wgrad's A
//            and B, the dgrad's B) arrive as 32 K rows of 128 floats,
//            unswizzled; K-major ones (the forward's A and B, the dgrad's
//            A) as 128 rows of 32 K (128 bytes) with the 128-byte swizzle.
//   K-major  TMA cannot transpose, and the products want MN-major tiles.
//            Of the two routes, reading 4 K values of each of a thread's
//            rows with one LDS.128 (32 B values live beside the 64
//            accumulators) spilled at the 128-register cap and ran
//            slower side by side; the kept route has the 256 threads copy
//            each K-major tile into an MN-major buffer (16 KB an operand,
//            read back through the swizzle's XOR: the 8 threads of a
//            phase read 8 bank groups), between two block barriers a
//            step.  The wgrad reads its stages as they come and its K
//            loop has no barrier.
//   math     256 threads, each an 8x8 tile of fp32 accumulators of a
//            128x128 output tile, as 2x2 sub-tiles of 4x4 half a tile
//            apart: one K value is 4 conflict-free LDS.128 for 64 FFMAs.
//            127 registers, no spills: two 107 KB blocks fit an SM.
//   split K  As the bf16 kernel: slabs of whole BK steps on gridDim.z,
//            folded through DSMEM in rank order, splitk_reduce where the
//            slabs outnumber the cluster, but in clusters of at most 2:
//            the same split in clusters of 4 or 8 ran the ResNet-50
//            wgrads slower side by side, as if fewer of their blocks were
//            resident at once.  The plan (ops/conv1x1.py) picks the slabs
//            by whole rounds of the card's SMs.
//   epilogue The fp32 tile is staged over the ring and leaves through the
//            fold (a cluster of one where there is no split) in 16-byte
//            stores.  out_stats sums each thread's 8 rows, then the two
//            row groups of a warp by a shuffle, then the 8 warps in order;
//            a_colsum sums the MN-major A stage before it is released, in
//            the blocks of the first N tile.
//
// TMA needs 16-byte aligned bases and row strides: every operand's
// contiguous row is a multiple of 16 bytes, 8 bf16 or 4 fp32 elements
// (the wrapper raises otherwise, and conv1x1_mm returns
// cudaErrorInvalidValue).  Ragged M, N and K edges are TMA's zero fill;
// stores are clipped.
//
// Not done here: the NCHW <-> pixel-major copies around the kernel
// (ops/conv1x1.py) move more bytes than the product itself; a
// channels-last layout removes them.
//
// The mbarrier, TMA and wgmma helpers and the tensor-map encoding are in
// hopper.cuh, shared with flash_attn.cu.  A wait on an mbarrier that has
// not completed after about 4 s of clock cycles traps (an unspecified
// launch failure) rather than hang the card.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;   // mbarriers, TMA, wgmma, tensor maps

constexpr int kThreads = 256;

__device__ __forceinline__ void store_out(void* out, size_t idx, float v,
                                          int out_bf16) {
  if (out_bf16) {
    static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16(v);
  } else {
    static_cast<float*>(out)[idx] = v;
  }
}

// Pointers of one launch.  `work` non-null: write fp32 partials (cluster
// blockIdx.z / cluster size) to work[z, M, N] instead of the output.
// `col_sum`/`col_sq` non-null: the out_stats epilogue ([gridDim.y, N]
// partials; only with one slab).  `a_csum` non-null: the a_colsum
// epilogue (row z of [S / cluster, M]).
struct Epilogue {
  void* out;
  float* work;
  float* col_sum;
  float* col_sq;
  float* a_csum;
};

// ---------------------------------------------------------------------------
// bf16 inputs: TMA ring, wgmma, split K folded in a cluster (see above).
// ---------------------------------------------------------------------------
constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kConsumerThreads = 256;              // two warpgroups
constexpr int kTmaThreads = kConsumerThreads + 32; // + one producer warp
constexpr int kProducerWarp = kConsumerThreads / 32;
constexpr uint32_t kStageBytes = 32768;            // A 16 KB + B 16 KB
constexpr uint32_t kHalfBytes = 16384;
constexpr uint32_t kBoxBytes = 8192;               // a 64 x 64 MN-major box
constexpr int kLdc = kBN + 8;                      // staging row, floats
constexpr uint32_t kStagingBytes = (kBM * kLdc + 3 * kBM) * sizeof(float);
constexpr int kLdo = kBN + 8;                      // bf16 staging row
constexpr uint32_t kOutStageBytes = kBM * kLdo * 2;
// Shared memory (after aligning the base to 1 KB): a region that holds
// the ring of a one-tile block (kStagesOneTile stages) or the ring of a
// persistent block (kStagesPersistent) and its bf16 staging tile, and
// after a one-tile block's main loop its fp32 staging tile; then the
// out_stats partials [2][8 warps][kBN] fp32 and the mbarriers.  107 KB:
// two blocks share an SM.
constexpr int kStagesOneTile = 3;
constexpr int kStagesPersistent = 2;
constexpr uint32_t kOutStageOffset = kStagesPersistent * kStageBytes;
constexpr uint32_t kRegionBytes =
    kStagesOneTile * kStageBytes > kOutStageOffset + kOutStageBytes
        ? kStagesOneTile * kStageBytes
        : kOutStageOffset + kOutStageBytes;
constexpr uint32_t kStatsOffset = kRegionBytes;
constexpr uint32_t kBarOffset = kStatsOffset + 2 * 8 * kBN * sizeof(float);
constexpr int kSmemBytes = 1024 + kBarOffset + 16 * kStagesOneTile;
static_assert(kStagingBytes <= kRegionBytes, "staging must fit");

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// 8 consecutive fp32 values at shared address `addr` of cluster rank
// `rank` (DSMEM; the block's own rank reads its own shared memory).
__device__ __forceinline__ void ld_cluster8(uint32_t addr, uint32_t rank,
                                            float (&v)[8]) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
               : "r"(r)
               : "memory");
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v[4]), "=f"(v[5]), "=f"(v[6]), "=f"(v[7])
               : "r"(r + 16)
               : "memory");
}

__device__ __forceinline__ float ld_cluster1(uint32_t addr, uint32_t rank) {
  uint32_t r;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(r)
               : "memory");
  return v;
}

// out_stats of one tile: each warp's column sums and sums of squares of
// its 16 rows of the fp32 accumulators (shuffles across the lanes that
// share columns), into stats[2][8 warps][kBN].
__device__ __forceinline__ void tile_stats(const float (&d)[64], float* stats,
                                           int warp, int lane) {
  const int c = lane & 3;
#pragma unroll
  for (int g = 0; g < kBN / 8; ++g) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float v0 = d[4 * g + j], v1 = d[4 * g + 2 + j];
      float s = v0 + v1, q = v0 * v0 + v1 * v1;
#pragma unroll
      for (int x = 4; x < 32; x <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, x);
        q += __shfl_xor_sync(0xffffffffu, q, x);
      }
      if (lane < 4) {
        stats[warp * kBN + 8 * g + 2 * c + j] = s;
        stats[(8 + warp) * kBN + 8 * g + 2 * c + j] = q;
      }
    }
  }
}

// Column `col` (tile column `tc`) of M tile `tm`: the 8 warps' partials
// summed in order, into row tm of col_sum / col_sq [M tiles, N].
__device__ __forceinline__ void stats_out(const Epilogue& ep,
                                          const float* stats, int tm, int N,
                                          int col, int tc) {
  float s = 0.f, q = 0.f;
  for (int w = 0; w < 8; ++w) {
    s += stats[w * kBN + tc];
    q += stats[(8 + w) * kBN + tc];
  }
  const size_t o = static_cast<size_t>(tm) * N + col;
  ep.col_sum[o] = s;
  ep.col_sq[o] = q;
}

// The fold of a one-tile block, after the cluster barrier that follows
// the staging of every rank's fp32 tile (at `base`, rows of kLdc floats)
// and a_colsum partials (csum_s[2 * kBM + row]): rank `rank` of the
// cluster sums the tile rows [r0, r1) over the ranks' shared memory
// (DSMEM) in rank order and writes the output, or the fp32 partial of
// cluster z / csize where ep.work is set.  Run by kThreads threads.
__device__ __forceinline__ void fold_tile(const Epilogue& ep, uint32_t base,
                                          const float* csum_s, int M, int N,
                                          int z, uint32_t rank,
                                          uint32_t csize, int tid,
                                          bool do_csum, int out_bf16) {
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int r0 = static_cast<int>(rank * kBM / csize);
  const int r1 = static_cast<int>((rank + 1) * kBM / csize);
  const int zc = z / static_cast<int>(csize);
  const bool partial = ep.work != nullptr;
  const bool vec = (N % 8) == 0;
  for (int item = tid; item < (r1 - r0) * (kBN / 8); item += kThreads) {
    const int row = r0 + item / (kBN / 8), col = (item % (kBN / 8)) * 8;
    const int gm = m0 + row, gn = n0 + col;
    if (gm >= M || gn >= N) continue;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const uint32_t addr =
        base + static_cast<uint32_t>((row * kLdc + col) * sizeof(float));
    for (uint32_t q = 0; q < csize; ++q) {
      float t[8];
      ld_cluster8(addr, q, t);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += t[e];
    }
    const size_t o = static_cast<size_t>(gm) * N + gn;
    if (partial) {
      float* w = ep.work + static_cast<size_t>(zc) * M * N + o;
      if (vec) {
        reinterpret_cast<float4*>(w)[0] = make_float4(v[0], v[1], v[2], v[3]);
        reinterpret_cast<float4*>(w)[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
        for (int e = 0; e < 8 && gn + e < N; ++e) w[e] = v[e];
      }
    } else if (vec && out_bf16) {
      __nv_bfloat162 h[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
      }
      *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(ep.out) + o) =
          *reinterpret_cast<const uint4*>(h);
    } else if (vec) {
      float* w = static_cast<float*>(ep.out) + o;
      reinterpret_cast<float4*>(w)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(w)[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
      for (int e = 0; e < 8 && gn + e < N; ++e) {
        store_out(ep.out, o + e, v[e], out_bf16);
      }
    }
  }
  if (do_csum && tid < r1 - r0 && m0 + r0 + tid < M) {
    const uint32_t addr = smem_addr(&csum_s[2 * kBM + r0 + tid]);
    float s = 0.f;
    for (uint32_t q = 0; q < csize; ++q) s += ld_cluster1(addr, q);
    ep.a_csum[static_cast<size_t>(partial ? zc : 0) * M + m0 + r0 + tid] = s;
  }
}

// Two schedules, one kernel.  Persistent (`persistent` != 0: one slab,
// bf16 output, no a_colsum; the forward's and dgrad's launches):
// gridDim.x blocks (two an SM) walk the tiles t = blockIdx.x, + gridDim.x
// (N tiles fastest) with a ring of kStagesPersistent stages, and the
// producer runs on into the next tile's stages while the consumers store
// the last tile through their own bf16 staging tile.  Otherwise: grid
// (N tiles, M tiles, S slabs), one tile a block, a ring of
// kStagesOneTile stages, clusters (1, 1, cluster) along the slabs; slab z
// runs over K steps [z * ksteps / S, (z + 1) * ksteps / S), and the fp32
// tile is staged over the ring for the fold.  Layout: kRegionBytes.
template <bool TA, bool TB>
__global__ void __launch_bounds__(kTmaThreads, 2)
    mm_bf16_tma(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b, Epilogue ep,
                int M, int N, int ksteps, int out_bf16, int persistent) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;     // 128B swizzle: 1 KB
  unsigned char* smem = smem_raw + (base - raw);
  const int stages = persistent ? kStagesPersistent : kStagesOneTile;
  const uint32_t full = base + kBarOffset;
  const uint32_t empty = full + 8 * kStagesOneTile;
  __nv_bfloat16* stage_o =
      reinterpret_cast<__nv_bfloat16*>(smem + kOutStageOffset);
  float* stage_c = reinterpret_cast<float*>(smem);
  float* csum_s = stage_c + kBM * kLdc;            // [3][kBM]
  float* stats = reinterpret_cast<float*>(smem + kStatsOffset);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tiles_n = (N + kBN - 1) / kBN;
  const int tiles = persistent ? tiles_n * ((M + kBM - 1) / kBM) : 1;
  const int t_first = persistent ? static_cast<int>(blockIdx.x) : 0;
  const int t_step = persistent ? static_cast<int>(gridDim.x) : 1;
  const int S = gridDim.z, z = blockIdx.z;
  const int k_lo = static_cast<int>(static_cast<long long>(z) * ksteps / S);
  const int nk =
      static_cast<int>(static_cast<long long>(z + 1) * ksteps / S) - k_lo;
  auto origin = [&](int t, int& m0, int& n0) {
    m0 = (persistent ? t / tiles_n : static_cast<int>(blockIdx.y)) * kBM;
    n0 = (persistent ? t % tiles_n : static_cast<int>(blockIdx.x)) * kBN;
  };
  uint32_t rank, csize;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(csize));
  const bool do_csum = TA && ep.a_csum != nullptr && blockIdx.x == 0;
  const bool do_stats = ep.col_sum != nullptr;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kProducerWarp) {
    // ---- producer: one thread keeps the ring full, tile after tile ----
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_a))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_b))
                   : "memory");
      uint32_t it = 0;                 // k steps issued, over all tiles
      for (int t = t_first; t < tiles; t += t_step) {
        int m0, n0;
        origin(t, m0, n0);
        for (int i = 0; i < nk; ++i, ++it) {
          const int s = it % stages;
          mbar_wait(empty + 8 * s, ((it / stages) & 1) ^ 1);
          const uint32_t bar = full + 8 * s;
          mbar_expect_tx(bar, kStageBytes);
          const int k0 = (k_lo + i) * kBK;
          const uint32_t a = base + s * kStageBytes, b = a + kHalfBytes;
          if (TA) {        // [K, M] storage: two 64(M) x 64(K) boxes
            tma_load(a, &map_a, bar, m0, k0);
            tma_load(a + kBoxBytes, &map_a, bar, m0 + 64, k0);
          } else {         // [M, K] storage: one 64(K) x 128(M) box
            tma_load(a, &map_a, bar, k0, m0);
          }
          if (TB) {        // [N, K] storage: one 64(K) x 128(N) box
            tma_load(b, &map_b, bar, k0, n0);
          } else {         // [K, N] storage: two 64(N) x 64(K) boxes
            tma_load(b, &map_b, bar, n0, k0);
            tma_load(b + kBoxBytes, &map_b, bar, n0 + 64, k0);
          }
        }
      }
    }
    __syncwarp();
  } else {
    // ---- consumers: warpgroup wg owns tile rows [64 wg, 64 wg + 64) ----
    const int wg = warp / 4, tw = tid % 128;
    // fragment: d[4g + 2h + j] is row r + 8h, column 8g + 2c + j
    const int r = wg * 64 + (warp & 3) * 16 + (lane >> 2), c = lane & 3;
    uint32_t it = 0;                   // k steps consumed, over all tiles
    for (int t = t_first; t < tiles; t += t_step) {
      int m0, n0;
      origin(t, m0, n0);
      float d[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) d[i] = 0.f;
      float cs = 0.f;
      for (int i = 0; i < nk; ++i, ++it) {
        const int s = it % stages;
        mbar_wait(full + 8 * s, (it / stages) & 1);
        __syncwarp();      // wgmma's .aligned forms need the warp converged
        // both layouts put this warpgroup's 64 rows of A at +8 KB * wg
        const uint32_t a = base + s * kStageBytes + wg * kBoxBytes;
        const uint32_t b = base + s * kStageBytes + kHalfBytes;
        fence_acc(d);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          // K-major: 128-byte rows, 8-row groups 1 KB apart, k16 = +32 B.
          // MN-major: 64-wide atoms (B: two, 8 KB apart), 8 K rows a
          // group 1 KB apart, k16 = +16 rows = +2 KB.
          const uint64_t da =
              TA ? sw128_desc(a + kk * 2048, kBoxBytes, 1024)
                 : sw128_desc(a + kk * 32, 16, 1024);
          const uint64_t db =
              TB ? sw128_desc(b + kk * 32, 16, 1024)
                 : sw128_desc(b + kk * 2048, kBoxBytes, 1024);
          wgmma_128<TA, !TB>(d, da, db);   // B stored [K, N] is N-major
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        fence_acc(d);
        if (do_csum) {     // column tw % 64 of the box, 32 of its K rows
          const unsigned char* box = smem + (a - base);
          const int m = tw & 63;
#pragma unroll 8
          for (int k = (tw >> 6) * 32; k < (tw >> 6) * 32 + 32; ++k) {
            const int off =
                k * 128 + (((m >> 3) ^ (k & 7)) << 4) + (m & 7) * 2;
            cs += __bfloat162float(
                *reinterpret_cast<const __nv_bfloat16*>(box + off));
          }
        }
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fence_acc(d);
        if (i > 0 && lane == 0) {
          mbar_arrive(empty + 8 * ((it - 1) % stages));
        }
        __syncwarp();
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(d);
      if (nk > 0 && lane == 0) mbar_arrive(empty + 8 * ((it - 1) % stages));
      __syncwarp();

      if (persistent) {
        // bf16 tile through the block's own staging tile, off the ring,
        // so the producer is already loading the next tile
        consumers_sync();  // the last tile's stores have read stage_o
        if (do_stats) tile_stats(d, stats, warp, lane);
#pragma unroll
        for (int g = 0; g < kBN / 8; ++g) {
          *reinterpret_cast<__nv_bfloat162*>(
              &stage_o[r * kLdo + 8 * g + 2 * c]) =
              __floats2bfloat162_rn(d[4 * g], d[4 * g + 1]);
          *reinterpret_cast<__nv_bfloat162*>(
              &stage_o[(r + 8) * kLdo + 8 * g + 2 * c]) =
              __floats2bfloat162_rn(d[4 * g + 2], d[4 * g + 3]);
        }
        consumers_sync();
        if (do_stats && tid < kBN && n0 + tid < N) {
          stats_out(ep, stats, m0 / kBM, N, n0 + tid, tid);
        }
        const bool vec = (N % 8) == 0;
        for (int item = tid; item < kBM * (kBN / 8);
             item += kConsumerThreads) {
          const int row = item / (kBN / 8), col = (item % (kBN / 8)) * 8;
          const int gm = m0 + row, gn = n0 + col;
          if (gm >= M || gn >= N) continue;
          __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(ep.out) +
                               static_cast<size_t>(gm) * N + gn;
          const __nv_bfloat16* src = &stage_o[row * kLdo + col];
          if (vec) {
            *reinterpret_cast<uint4*>(dst) =
                *reinterpret_cast<const uint4*>(src);
          } else {
            for (int e = 0; e < 8 && gn + e < N; ++e) dst[e] = src[e];
          }
        }
        continue;
      }

      // one-tile block: the fp32 tile over the ring, for the fold
      consumers_sync();    // both warpgroups are done with the ring
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (do_stats) tile_stats(d, stats, warp, lane);
#pragma unroll
      for (int g = 0; g < kBN / 8; ++g) {
        *reinterpret_cast<float2*>(&stage_c[r * kLdc + 8 * g + 2 * c]) =
            make_float2(d[4 * g], d[4 * g + 1]);
        *reinterpret_cast<float2*>(&stage_c[(r + 8) * kLdc + 8 * g + 2 * c]) =
            make_float2(d[4 * g + 2], d[4 * g + 3]);
      }
      if (do_csum) csum_s[(tw >> 6) * kBM + wg * 64 + (tw & 63)] = cs;
      consumers_sync();
      if (do_stats && tid < kBN && n0 + tid < N) {
        stats_out(ep, stats, blockIdx.y, N, n0 + tid, tid);
      }
      if (do_csum && tid < kBM) {
        csum_s[2 * kBM + tid] = csum_s[tid] + csum_s[kBM + tid];
      }
    }
  }
  if (persistent) return;

  // ---- fold: rank r of the cluster sums rows [r0, r1) over the ranks ----
  cluster_sync();
  if (warp != kProducerWarp) {
    fold_tile(ep, base, csum_s, M, N, z, rank, csize, tid, do_csum, out_bf16);
  }
  cluster_sync();          // no block leaves while another reads its tile
}

// ---------------------------------------------------------------------------
// fp32 inputs: TMA ring, 8x8 FFMA register tiles, split K folded in a
// cluster (see above).
// ---------------------------------------------------------------------------
constexpr int kFBK = 32;                           // K step, floats
constexpr int kFStages = 2;
constexpr uint32_t kFHalfBytes = kBM * kFBK * 4;   // one operand's tile, 16 KB
constexpr uint32_t kFStageBytes = 2 * kFHalfBytes;
// the ring, then the K-major operands' MN-major copies (A, then B)
constexpr uint32_t kFCopyOffset = kFStages * kFStageBytes;
constexpr uint32_t kFRegionBytes = kFCopyOffset + 2 * kFHalfBytes;   // 96 KB
constexpr uint32_t kFBarOffset = kFRegionBytes + 2 * 8 * kBN * sizeof(float);
constexpr int kFSmemBytes = 1024 + kFBarOffset + 16 * kFStages;
static_assert(kStagingBytes <= kFRegionBytes, "staging must fit");

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The MN-major copy dst [kFBK][128] of a K-major stage tile src (128 rows
// of 32 K, 128 bytes, 16-byte chunk c of row r at c ^ (r % 8)): thread
// tid reads 4 chunks of row tid % 128 (the 8 threads of a phase read 8
// rows, which the swizzle puts in 8 bank groups) and writes 16 floats of
// column tid % 128 (a warp writes 32 consecutive floats).
__device__ __forceinline__ void copy_mn_major(const float* src, float* dst,
                                              int tid) {
  const int r = tid & 127, c0 = (tid >> 7) * 4;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = c0 + q;
    const float4 v = lds4(src + r * 32 + 4 * (c ^ (r & 7)));
    float* d = dst + 4 * c * kBM + r;
    d[0] = v.x;
    d[kBM] = v.y;
    d[2 * kBM] = v.z;
    d[3 * kBM] = v.w;
  }
}

// Grid (N tiles, M tiles, S slabs), one tile a block, clusters (1, 1,
// cluster) along the slabs, slab z over K steps [z * ksteps / S,
// (z + 1) * ksteps / S).  Thread 0 keeps the ring full: it refills a
// stage once the 8 warps have released it.  Each thread (tx, ty) =
// (tid % 16, tid / 16) accumulates an 8x8 tile: rows 4 ty + i % 4 +
// 64 (i / 4), columns 4 tx + j % 4 + 64 (j / 4).  Stage layout: A then B,
// 16 KB each, in storage orientation; K-major tiles are copied MN-major
// first.
template <bool TA, bool TB>
__global__ void __launch_bounds__(kThreads, 2)
    mm_f32_tma(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_b, Epilogue ep, int M,
               int N, int ksteps, int out_bf16) {
  constexpr bool AK = !TA, BK = TB;                // K-major operands
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;     // 128B swizzle: 1 KB
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full = base + kFBarOffset;
  const uint32_t empty = full + 8 * kFStages;
  float* stage_c = reinterpret_cast<float*>(smem);
  float* csum_s = stage_c + kBM * kLdc;            // [3][kBM]
  float* stats = reinterpret_cast<float*>(smem + kFRegionBytes);
  float* copy_a = reinterpret_cast<float*>(smem + kFCopyOffset);
  float* copy_b = copy_a + kFBK * kBM;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int S = gridDim.z, z = blockIdx.z;
  const int k_lo = static_cast<int>(static_cast<long long>(z) * ksteps / S);
  const int nk =
      static_cast<int>(static_cast<long long>(z + 1) * ksteps / S) - k_lo;
  uint32_t rank, csize;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(csize));
  const bool do_csum = TA && ep.a_csum != nullptr && blockIdx.x == 0;

  if (tid == 0) {
    for (int s = 0; s < kFStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto issue = [&](int i) {        // K step k_lo + i into stage i % kFStages
    const uint32_t bar = full + 8 * (i % kFStages);
    const uint32_t a = base + (i % kFStages) * kFStageBytes;
    const int k0 = (k_lo + i) * kFBK;
    mbar_expect_tx(bar, kFStageBytes);
    if (TA) {
      tma_load(a, &map_a, bar, m0, k0);            // [K, M]: 128(M) x 32(K)
    } else {
      tma_load(a, &map_a, bar, k0, m0);            // [M, K]: 32(K) x 128(M)
    }
    if (TB) {
      tma_load(a + kFHalfBytes, &map_b, bar, k0, n0);
    } else {
      tma_load(a + kFHalfBytes, &map_b, bar, n0, k0);
    }
  };
  if (tid == 0) {
    prefetch_tensormap(&map_a);
    prefetch_tensormap(&map_b);
    for (int i = 0; i < kFStages && i < nk; ++i) issue(i);
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  float cs = 0.f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % kFStages;
    mbar_wait(full + 8 * s, (i / kFStages) & 1);
    const float* sa = reinterpret_cast<const float*>(smem + s * kFStageBytes);
    const float* sb = sa + kBM * kFBK;
    if (AK || BK) {
      __syncwarp();
      __syncthreads();             // the last step's products are done
      if (AK) copy_mn_major(sa, copy_a, tid);
      if (BK) copy_mn_major(sb, copy_b, tid);
      __syncthreads();
    }
    const float* pa = AK ? copy_a : sa;              // [kFBK][128] each
    const float* pb = BK ? copy_b : sb;
#pragma unroll
    for (int kk = 0; kk < kFBK; ++kk) {   // outer products, one K value each
      const float4 alo = lds4(pa + kk * kBM + 4 * ty);
      const float4 ahi = lds4(pa + kk * kBM + 64 + 4 * ty);
      const float4 blo = lds4(pb + kk * kBN + 4 * tx);
      const float4 bhi = lds4(pb + kk * kBN + 64 + 4 * tx);
      const float a8[8] = {alo.x, alo.y, alo.z, alo.w,
                           ahi.x, ahi.y, ahi.z, ahi.w};
      const float b8[8] = {blo.x, blo.y, blo.z, blo.w,
                           bhi.x, bhi.y, bhi.z, bhi.w};
#pragma unroll
      for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(a8[r], b8[j], acc[r][j]);
      }
    }
    if (do_csum) {                 // column tid % 128 of A, 16 of its K rows
      const float* col = sa + (tid & 127);
#pragma unroll 4
      for (int k = (tid >> 7) * 16; k < (tid >> 7) * 16 + 16; ++k) {
        cs += col[k * kBM];
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
    if (tid == 0 && i + kFStages < nk) {
      mbar_wait(empty + 8 * s, (i / kFStages) & 1);
      issue(i + kFStages);
    }
  }

  // ---- the fp32 tile over the ring, the epilogues, the fold ----
  __syncthreads();                 // every warp is done with the ring
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    float* dst = stage_c + ((r / 4) * 64 + 4 * ty + r % 4) * kLdc + 4 * tx;
    *reinterpret_cast<float4*>(dst) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    *reinterpret_cast<float4*>(dst + 64) =
        make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
  }
  if (ep.col_sum != nullptr) {     // this warp's 16 rows, column by column
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float sum = 0.f, sq = 0.f;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        sum += acc[r][j];
        sq += acc[r][j] * acc[r][j];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 16);
      sq += __shfl_xor_sync(0xffffffffu, sq, 16);
      if (lane < 16) {
        const int col = (j / 4) * 64 + 4 * tx + j % 4;
        stats[warp * kBN + col] = sum;
        stats[(8 + warp) * kBN + col] = sq;
      }
    }
  }
  if (do_csum) csum_s[(tid >> 7) * kBM + (tid & 127)] = cs;
  __syncthreads();
  if (ep.col_sum != nullptr && tid < kBN && n0 + tid < N) {
    stats_out(ep, stats, blockIdx.y, N, n0 + tid, tid);
  }
  if (do_csum && tid < kBM) {
    csum_s[2 * kBM + tid] = csum_s[tid] + csum_s[kBM + tid];
  }
  cluster_sync();
  fold_tile(ep, base, csum_s, M, N, z, rank, csize, tid, do_csum, out_bf16);
  cluster_sync();          // no block leaves while another reads its tile
}

// Second pass of the split-K product: out[i] = sum over z of work[z, i]
// in slab order, rounded once to the output type; the a_colsum partials
// [S, M], when present, ride along as M more elements.
__global__ void __launch_bounds__(kThreads)
    splitk_reduce(const float* __restrict__ work, int S, size_t mn,
                  void* __restrict__ out, int out_bf16,
                  const float* __restrict__ csum_work,
                  float* __restrict__ csum_out, int M) {
  const size_t total = mn + (csum_work ? (size_t)M : 0);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    if (i < mn) {
      for (int z = 0; z < S; ++z) s += work[(size_t)z * mn + i];
      store_out(out, i, s, out_bf16);
    } else {
      const size_t m = i - mn;
      for (int z = 0; z < S; ++z) s += csum_work[(size_t)z * M + m];
      csum_out[m] = s;
    }
  }
}


// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
// Launch one product of either kernel: grid `grid`, `threads` a block,
// `smem` bytes of dynamic shared memory, clusters of `cluster` blocks
// along z.
template <typename Kernel, typename... Args>
cudaError_t launch_ex(Kernel kernel, dim3 grid, int threads, int smem,
                      int cluster, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute la[1];
  la[0].id = cudaLaunchAttributeClusterDimension;
  la[0].val.clusterDim.x = 1;
  la[0].val.clusterDim.y = 1;
  la[0].val.clusterDim.z = cluster;
  cfg.attrs = la;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <bool TA, bool TB>
cudaError_t launch_bf16(const void* a, const void* b, const Epilogue& ep,
                        int M, int N, int K, int splits, int cluster,
                        int persistent_ctas, int out_bf16,
                        cudaStream_t stream) {
  constexpr auto bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap map_a, map_b;
  // A: [K, M] storage in 64(M) x 64(K) boxes, or [M, K] in 64(K) x 128(M)
  // B: [N, K] storage in 64(K) x 128(N) boxes, or [K, N] in 64(N) x 64(K)
  const bool ok =
      (TA ? tensor_map(&map_a, a, M, K, 64, 64, bf16)
          : tensor_map(&map_a, a, K, M, kBK, kBM, bf16)) &&
      (TB ? tensor_map(&map_b, b, K, N, kBK, kBN, bf16)
          : tensor_map(&map_b, b, N, K, 64, 64, bf16));
  if (!ok) return cudaErrorInvalidValue;
  auto kernel = mm_bf16_tma<TA, TB>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid =
      persistent_ctas > 0
          ? dim3(persistent_ctas)
          : dim3((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  return launch_ex(kernel, grid, kTmaThreads, kSmemBytes, cluster, stream,
                   map_a, map_b, ep, M, N, (K + kBK - 1) / kBK, out_bf16,
                   persistent_ctas > 0 ? 1 : 0);
}

template <bool TA, bool TB>
cudaError_t launch_f32(const void* a, const void* b, const Epilogue& ep,
                       int M, int N, int K, int splits, int cluster,
                       int out_bf16, cudaStream_t stream) {
  constexpr auto f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  constexpr auto plain = CU_TENSOR_MAP_SWIZZLE_NONE;
  CUtensorMap map_a, map_b;
  // K-major ([M, K] A, [N, K] B): 32(K) x 128 boxes, 128-byte swizzle;
  // MN-major ([K, M] A, [K, N] B): 128 x 32(K) boxes of 512-byte rows
  const bool ok =
      (TA ? tensor_map(&map_a, a, M, K, kBM, kFBK, f32, plain)
          : tensor_map(&map_a, a, K, M, kFBK, kBM, f32)) &&
      (TB ? tensor_map(&map_b, b, K, N, kFBK, kBN, f32)
          : tensor_map(&map_b, b, N, K, kBN, kFBK, f32, plain));
  if (!ok) return cudaErrorInvalidValue;
  auto kernel = mm_f32_tma<TA, TB>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFSmemBytes);
  if (attr != cudaSuccess) return attr;
  return launch_ex(kernel,
                   dim3((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits),
                   kThreads, kFSmemBytes, cluster, stream, map_a, map_b, ep,
                   M, N, (K + kFBK - 1) / kFBK, out_bf16);
}

template <bool TA, bool TB>
cudaError_t launch(const void* a, const void* b, const Epilogue& ep, int M,
                   int N, int K, int splits, int cluster, int persistent_ctas,
                   int in_bf16, int out_bf16, cudaStream_t stream) {
  if (in_bf16) {
    return launch_bf16<TA, TB>(a, b, ep, M, N, K, splits, cluster,
                               persistent_ctas, out_bf16, stream);
  }
  return launch_f32<TA, TB>(a, b, ep, M, N, K, splits, cluster, out_bf16,
                            stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.
//
// One tile a block: `splits` slabs of whole K steps (64 bf16, 32 fp32)
// along K, in clusters of `cluster` (1..8, dividing splits) blocks.  With
// splits == cluster the kernel writes `out` and `a_csum` [M]; with splits
// > cluster it writes fp32 partials to `work` [splits / cluster, M, N]
// (and `a_csum` [splits / cluster, M]) for conv1x1_mm_splitk_reduce.
// bf16 operands only: `persistent_ctas` > 0 launches that many blocks of
// the persistent schedule (one slab, bf16 output, no a_colsum).
// Every operand's row (the contiguous dimension of its storage) is a
// multiple of 16 bytes (8 bf16, 4 fp32 elements) and its base is 16-byte
// aligned.
//
// `col_sum`/`col_sq` ([ceil(M / 128), N] fp32) need one slab; they and
// `a_csum` may be null (epilogue off).  Launches on `stream` and does not
// synchronise; returns the launch's error or cudaGetLastError() (0 =
// launched).
extern "C" int conv1x1_mm(const void* a, const void* b, void* out, int M,
                          int N, int K, int ta, int tb, int in_dtype,
                          int out_dtype, int splits, int cluster,
                          int persistent_ctas, void* work, void* col_sum,
                          void* col_sq, void* a_csum, void* stream) {
  const int in_bf16 = in_dtype == 1, out_bf16 = out_dtype == 1;
  const int row = in_bf16 ? 8 : 4;   // elements in 16 bytes
  const uintptr_t pa = reinterpret_cast<uintptr_t>(a);
  const uintptr_t pb = reinterpret_cast<uintptr_t>(b);
  if ((in_dtype != 0 && in_dtype != 1) || (out_dtype != 0 && out_dtype != 1) ||
      splits < 1 || splits > 65535 || persistent_ctas < 0 ||
      (col_sum != nullptr && splits > 1) ||
      (col_sum == nullptr) != (col_sq == nullptr) || cluster < 1 ||
      cluster > 8 || splits % cluster != 0 ||
      (splits > cluster && work == nullptr) || pa % 16 != 0 || pb % 16 != 0 ||
      (ta ? M : K) % row != 0 || (tb ? K : N) % row != 0 ||
      (persistent_ctas > 0 &&
       (!in_bf16 || splits != 1 || !out_bf16 || a_csum != nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Epilogue ep{out,
                    splits > cluster ? static_cast<float*>(work) : nullptr,
                    static_cast<float*>(col_sum), static_cast<float*>(col_sq),
                    static_cast<float*>(a_csum)};
  cudaError_t e;
  if (!ta && !tb) {
    e = launch<false, false>(a, b, ep, M, N, K, splits, cluster,
                             persistent_ctas, in_bf16, out_bf16, s);
  } else if (!ta && tb) {
    e = launch<false, true>(a, b, ep, M, N, K, splits, cluster,
                            persistent_ctas, in_bf16, out_bf16, s);
  } else if (ta && !tb) {
    e = launch<true, false>(a, b, ep, M, N, K, splits, cluster,
                            persistent_ctas, in_bf16, out_bf16, s);
  } else {
    e = launch<true, true>(a, b, ep, M, N, K, splits, cluster,
                           persistent_ctas, in_bf16, out_bf16, s);
  }
  return static_cast<int>(e);
}

// The split-K second pass: out[mn] (dtype code out_dtype) = sum over the
// `splits` rows of work [splits, mn]; csum_out[M] = sum over the rows of
// csum_work [splits, M] when csum_work is not null.
extern "C" int conv1x1_mm_splitk_reduce(const void* work, int splits,
                                        long long mn, void* out,
                                        int out_dtype, const void* csum_work,
                                        void* csum_out, int M, void* stream) {
  if ((out_dtype != 0 && out_dtype != 1) || splits < 1 || mn < 0 ||
      (csum_work != nullptr && csum_out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = mn + (csum_work ? M : 0);
  const long long blocks = (total + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < 8192 ? (blocks > 0 ? blocks : 1)
                                                  : 8192);
  splitk_reduce<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(work), splits, static_cast<size_t>(mn), out,
      out_dtype == 1, static_cast<const float*>(csum_work),
      static_cast<float*>(csum_out), M);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* conv1x1_mm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
