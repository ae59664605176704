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
// each block: one block owns one output tile, its accumulator stays in
// registers (bf16: WMMA fragments; fp32: a 4x4 register tile per
// thread), and shared-memory tiles of A and B are refilled each K step.
// Every tile is staged in shared memory in its STORAGE orientation, so
// each global read runs along the contiguous dimension (16-byte vector
// loads for bf16 where the row stride allows) whatever the transpose
// flags; the transposes are absorbed by the WMMA fragment layouts
// (row_major / col_major) or by the fp32 tile indexing.  Ragged edges
// are masked here (zero-filled loads, guarded stores), although the
// routing gate only sends 128-divisible shapes.
//
// Split K.  The wgrad's output dw [Cout, Cin] is small (2 to 128 tiles of
// 128x128 at ResNet-50's shapes) while K = N*H*W runs to 401408, so one
// block per tile would leave most of the 132 SMs idle.  The TPU kernel
// carries the sum across its sequential K axis ("arbitrary", :181); a
// CUDA block cannot.  So the wrapper cuts K into S slabs of `kchunk`
// (a multiple of 32) on gridDim.z: block (x, y, z) sums its tile over
// slab z and writes an fp32 partial into the workspace W[S, M, N], and
// splitk_reduce then sums the S partials of each element in slab order
// and rounds once to the output type.  The sum is deterministic and
// needs no atomics.  The a_colsum epilogue splits the same way: slab z's
// blocks of the first N tile (blockIdx.x == 0, the `j == 0` of the TPU
// kernel) write row z of an [S, M] partial, so no two blocks write one
// element, and the same reduce pass sums it.  The rule that picks S
// lives in the wrapper (ops/conv1x1.py, split_k).
//
// What bounds it on an H100.  At the ResNet-50 shapes a bf16 product does
// 2*P*C*M operations over (P*C + M*C + P*M)*2 bytes: 100 to 200
// operations per byte, under the ~295 at which the tensor cores, not HBM
// at 3.35 TB/s, become the limit.  So the bf16 path is bound by bytes
// (the split wgrad adds its partials, 4*S*M*N bytes written and read).
// The fp32 path runs without TF32 on the CUDA cores (67 TFLOP/s peak) and
// is bound by operations.
//
// What this simple design leaves on the table: no cp.async/TMA pipeline
// (each K step loads, synchronises, then computes, so memory and math do
// not overlap), mma.sync-class WMMA instead of wgmma, 128x128 tiles with
// no persistent schedule, and a second pass over the split partials where
// a cluster reduction in distributed shared memory could fold them.  The
// NCHW <-> pixel-major copies around the kernel (ops/conv1x1.py) move
// more bytes than the product itself; a channels-last layout removes them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void store_out(void* out, size_t idx, float v,
                                          int out_bf16) {
  if (out_bf16) {
    static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16(v);
  } else {
    static_cast<float*>(out)[idx] = v;
  }
}

// Copy n (<= 8 used) consecutive bf16 values from src to dst, zero-filling
// the rest of the 8; one 16-byte load when all 8 are valid and aligned.
__device__ __forceinline__ void load8_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int n,
                                           int vec) {
  if (n >= 8 && vec) {
    *reinterpret_cast<uint4*>(dst) =
        __ldg(reinterpret_cast<const uint4*>(src));
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      dst[i] = (i < n) ? src[i] : __float2bfloat16(0.f);
    }
  }
}

// Pointers of one launch.  `work` non-null: write fp32 partials of slab
// blockIdx.z to work[z, M, N] instead of the output.  `col_sum`/`col_sq`
// non-null: the out_stats epilogue ([gridDim.y, N] partials; only with
// one slab).  `a_csum` non-null: the a_colsum epilogue (row z of [S, M]).
struct Epilogue {
  void* out;
  float* work;
  float* col_sum;
  float* col_sq;
  float* a_csum;
};

// ---------------------------------------------------------------------------
// bf16 inputs: 128x128 output tile per block, 8 warps as 2 (m) x 4 (n),
// each warp a 64x32 sub-tile of 4x2 WMMA 16x16x16 fragments, K step 32.
// ---------------------------------------------------------------------------
template <bool TA, bool TB>
__global__ void __launch_bounds__(kThreads)
    mm_bf16_wmma(const __nv_bfloat16* __restrict__ A,
                 const __nv_bfloat16* __restrict__ B, Epilogue ep, int M,
                 int N, int K, int kchunk, int out_bf16, int vec_a,
                 int vec_b) {
  constexpr int BM = 128, BN = 128, BK = 32, PAD = 8;
  // leading dimensions of the shared tiles, in storage orientation
  constexpr int LDA = TA ? BM + PAD : BK + PAD;   // [BK][BM] or [BM][BK]
  constexpr int LDB = TB ? BK + PAD : BN + PAD;   // [BN][BK] or [BK][BN]
  constexpr int A_ELEMS = TA ? BK * LDA : BM * LDA;
  constexpr int B_ELEMS = TB ? BN * LDB : BK * LDB;
  using LayoutA = typename std::conditional<TA, wmma::col_major,
                                            wmma::row_major>::type;
  using LayoutB = typename std::conditional<TB, wmma::col_major,
                                            wmma::row_major>::type;

  __shared__ __align__(128) __nv_bfloat16 As[A_ELEMS];
  __shared__ __align__(128) __nv_bfloat16 Bs[B_ELEMS];
  __shared__ __align__(128) float Cs[kThreads / 32][16 * 16];
  __shared__ float st_sum[2][BN], st_sq[2][BN];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_lo = blockIdx.z * kchunk;
  const int k_hi = min(K, k_lo + kchunk);
  // a_colsum: the first N tile's threads 0..BM-1 each own one row m
  const bool do_csum = ep.a_csum != nullptr && blockIdx.x == 0;
  float csum = 0.f;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  }

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    // A tile: BM*BK values in chunks of 8 along the storage row
#pragma unroll
    for (int c = tid; c < BM * BK / 8; c += kThreads) {
      if (!TA) {                       // storage [M][K]
        const int row = c / (BK / 8), col = (c % (BK / 8)) * 8;
        const int gm = m0 + row, gk = k0 + col;
        const int n = (gm < M) ? min(8, k_hi - gk) : 0;
        load8_bf16(&As[row * LDA + col],
                   A + (size_t)(gm < M ? gm : 0) * K + gk, n, vec_a);
      } else {                         // storage [K][M]
        const int row = c / (BM / 8), col = (c % (BM / 8)) * 8;
        const int gk = k0 + row, gm = m0 + col;
        const int n = (gk < k_hi) ? min(8, M - gm) : 0;
        load8_bf16(&As[row * LDA + col],
                   A + (size_t)(gk < k_hi ? gk : 0) * M + gm, n, vec_a);
      }
    }
    // B tile: BK*BN values
#pragma unroll
    for (int c = tid; c < BN * BK / 8; c += kThreads) {
      if (!TB) {                       // storage [K][N]
        const int row = c / (BN / 8), col = (c % (BN / 8)) * 8;
        const int gk = k0 + row, gn = n0 + col;
        const int n = (gk < k_hi) ? min(8, N - gn) : 0;
        load8_bf16(&Bs[row * LDB + col],
                   B + (size_t)(gk < k_hi ? gk : 0) * N + gn, n, vec_b);
      } else {                         // storage [N][K]
        const int row = c / (BK / 8), col = (c % (BK / 8)) * 8;
        const int gn = n0 + row, gk = k0 + col;
        const int n = (gn < N) ? min(8, k_hi - gk) : 0;
        load8_bf16(&Bs[row * LDB + col],
                   B + (size_t)(gn < N ? gn : 0) * K + gk, n, vec_b);
      }
    }
    __syncthreads();

    if (do_csum && tid < BM) {         // zero-filled edges add nothing
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        csum += __bfloat162float(TA ? As[kk * LDA + tid] : As[tid * LDA + kk]);
      }
    }

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LayoutA>
          fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LayoutB>
          fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int mm = wm * 64 + i * 16;
        const __nv_bfloat16* p =
            TA ? &As[kk * LDA + mm] : &As[mm * LDA + kk];
        wmma::load_matrix_sync(fa[i], p, LDA);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int nn = wn * 32 + j * 16;
        const __nv_bfloat16* p =
            TB ? &Bs[nn * LDB + kk] : &Bs[kk * LDB + nn];
        wmma::load_matrix_sync(fb[j], p, LDB);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: each fragment goes through the warp's own 16x16 staging
  // tile so the stores can be masked and converted to the output type.
  // Lane l always sees column l % 16 of the fragment (rows l / 16, +2,
  // ...), so it keeps that column's out_stats sums in registers.
  const bool do_stats = ep.col_sum != nullptr;
  float* work = ep.work ? ep.work + (size_t)blockIdx.z * M * N : nullptr;
  float s[2] = {0.f, 0.f}, q[2] = {0.f, 0.f};
  float* cs = Cs[warp];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r0 = m0 + wm * 64 + i * 16, c0 = n0 + wn * 32 + j * 16;
      for (int e = lane; e < 256; e += 32) {
        const int r = r0 + e / 16, cc = c0 + e % 16;
        if (r < M && cc < N) {
          const float v = cs[e];
          if (work) {
            work[(size_t)r * N + cc] = v;
          } else {
            store_out(ep.out, (size_t)r * N + cc, v, out_bf16);
          }
          s[j] += v;
          q[j] += v * v;
        }
      }
      __syncwarp();
    }
  }
  if (do_stats) {                      // uniform over the block
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      s[j] += __shfl_down_sync(0xffffffffu, s[j], 16);
      q[j] += __shfl_down_sync(0xffffffffu, q[j], 16);
      if (lane < 16) {
        st_sum[wm][wn * 32 + j * 16 + lane] = s[j];
        st_sq[wm][wn * 32 + j * 16 + lane] = q[j];
      }
    }
    __syncthreads();
    if (tid < BN && n0 + tid < N) {
      const size_t o = (size_t)blockIdx.y * N + n0 + tid;
      ep.col_sum[o] = st_sum[0][tid] + st_sum[1][tid];
      ep.col_sq[o] = st_sq[0][tid] + st_sq[1][tid];
    }
  }
  if (do_csum && tid < BM && m0 + tid < M) {
    ep.a_csum[(size_t)blockIdx.z * M + m0 + tid] = csum;
  }
}

// ---------------------------------------------------------------------------
// fp32 inputs: exact fp32 FMAs (no TF32).  64x64 output tile per block,
// each of the 256 threads a 4x4 register tile, K step 16.
// ---------------------------------------------------------------------------
template <bool TA, bool TB>
__global__ void __launch_bounds__(kThreads)
    mm_f32_simt(const float* __restrict__ A, const float* __restrict__ B,
                Epilogue ep, int M, int N, int K, int kchunk, int out_bf16) {
  constexpr int BM = 64, BN = 64, BK = 16;
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_lo = blockIdx.z * kchunk;
  const int k_hi = min(K, k_lo + kchunk);
  const bool do_csum = ep.a_csum != nullptr && blockIdx.x == 0;
  float csum = 0.f;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    // consecutive threads walk the contiguous storage dimension
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int mm = TA ? e % BM : e / BK;
      const int kk = TA ? e / BM : e % BK;
      const int gm = m0 + mm, gk = k0 + kk;
      float v = 0.f;
      if (gm < M && gk < k_hi) {
        v = TA ? A[(size_t)gk * M + gm] : A[(size_t)gm * K + gk];
      }
      As[kk][mm] = v;
    }
    for (int e = tid; e < BN * BK; e += kThreads) {
      const int nn = TB ? e / BK : e % BN;
      const int kk = TB ? e % BK : e / BN;
      const int gn = n0 + nn, gk = k0 + kk;
      float v = 0.f;
      if (gn < N && gk < k_hi) {
        v = TB ? B[(size_t)gn * K + gk] : B[(size_t)gk * N + gn];
      }
      Bs[kk][nn] = v;
    }
    __syncthreads();
    if (do_csum && tid < BM) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) csum += As[kk][tid];
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  float* work = ep.work ? ep.work + (size_t)blockIdx.z * M * N : nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (r < M && c < N) {
        if (work) {
          work[(size_t)r * N + c] = acc[i][j];
        } else {
          store_out(ep.out, (size_t)r * N + c, acc[i][j], out_bf16);
        }
      }
    }
  }
  if (ep.col_sum != nullptr) {         // uniform over the block
    // per-thread sums over its 4 rows, then over the 16 row groups
    // through shared memory (As and Bs are free after the K loop)
    float* red_s = &As[0][0];          // [16][64] within As's 16*68
    float* red_q = &Bs[0][0];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s = 0.f, q = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (m0 + ty * 4 + i < M) {
          s += acc[i][j];
          q += acc[i][j] * acc[i][j];
        }
      }
      red_s[ty * BN + tx * 4 + j] = s;
      red_q[ty * BN + tx * 4 + j] = q;
    }
    __syncthreads();
    if (tid < BN && n0 + tid < N) {
      float s = 0.f, q = 0.f;
      for (int t = 0; t < kThreads / 16; ++t) {
        s += red_s[t * BN + tid];
        q += red_q[t * BN + tid];
      }
      const size_t o = (size_t)blockIdx.y * N + n0 + tid;
      ep.col_sum[o] = s;
      ep.col_sq[o] = q;
    }
  }
  if (do_csum && tid < BM && m0 + tid < M) {
    ep.a_csum[(size_t)blockIdx.z * M + m0 + tid] = csum;
  }
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

template <bool TA, bool TB>
void launch(const void* a, const void* b, const Epilogue& ep, int M, int N,
            int K, int splits, int kchunk, int in_bf16, int out_bf16,
            cudaStream_t stream) {
  if (in_bf16) {
    const dim3 grid((N + 127) / 128, (M + 127) / 128, splits);
    const int vec_a = (reinterpret_cast<uintptr_t>(a) % 16 == 0) &&
                      ((TA ? M : K) % 8 == 0);
    const int vec_b = (reinterpret_cast<uintptr_t>(b) % 16 == 0) &&
                      ((TB ? K : N) % 8 == 0);
    mm_bf16_wmma<TA, TB><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), ep, M, N, K, kchunk, out_bf16,
        vec_a, vec_b);
  } else {
    const dim3 grid((N + 63) / 64, (M + 63) / 64, splits);
    mm_f32_simt<TA, TB><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), ep, M,
        N, K, kchunk, out_bf16);
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  `splits` slabs of `kchunk`
// along K (gridDim.z); with splits > 1 the product writes fp32 partials
// to `work` [splits, M, N] (and a_colsum partials to `a_csum` [splits,
// M]) and the caller runs conv1x1_mm_splitk_reduce.  `col_sum`/`col_sq`
// ([ceil(M / tile), N] fp32) and `a_csum` may be null (epilogue off).
// Launches on `stream` and does not synchronise; returns
// cudaGetLastError() (0 = launched).
extern "C" int conv1x1_mm(const void* a, const void* b, void* out, int M,
                          int N, int K, int ta, int tb, int in_dtype,
                          int out_dtype, int splits, int kchunk, void* work,
                          void* col_sum, void* col_sq, void* a_csum,
                          void* stream) {
  if ((in_dtype != 0 && in_dtype != 1) || (out_dtype != 0 && out_dtype != 1) ||
      splits < 1 || splits > 65535 || kchunk < 1 ||
      (splits > 1 && (work == nullptr || col_sum != nullptr)) ||
      (col_sum == nullptr) != (col_sq == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int in_bf16 = in_dtype == 1, out_bf16 = out_dtype == 1;
  const Epilogue ep{out, splits > 1 ? static_cast<float*>(work) : nullptr,
                    static_cast<float*>(col_sum), static_cast<float*>(col_sq),
                    static_cast<float*>(a_csum)};
  if (!ta && !tb) {
    launch<false, false>(a, b, ep, M, N, K, splits, kchunk, in_bf16,
                         out_bf16, s);
  } else if (!ta && tb) {
    launch<false, true>(a, b, ep, M, N, K, splits, kchunk, in_bf16, out_bf16,
                        s);
  } else if (ta && !tb) {
    launch<true, false>(a, b, ep, M, N, K, splits, kchunk, in_bf16, out_bf16,
                        s);
  } else {
    launch<true, true>(a, b, ep, M, N, K, splits, kchunk, in_bf16, out_bf16,
                       s);
  }
  return static_cast<int>(cudaGetLastError());
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
