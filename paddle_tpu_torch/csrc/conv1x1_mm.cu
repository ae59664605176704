// Blocked matrix product O[M,N] = op(A) @ op(B) for the 1x1 convolutions
// of paddle_tpu_torch (ops/conv1x1.py), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_conv.py:69 (_mm_kernel,
// launched by _mm at :141-193) in its epilogue-free form: op(A) is A or
// A^T (storage [M,K] or [K,M]), op(B) is B or B^T (storage [K,N] or
// [N,K]), inputs fp32 or bf16, accumulation fp32, output fp32 or bf16.
// The 1x1-conv forward is ta=0, tb=1: out[P,M] = x[P,C] @ w[M,C]^T.
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
// What bounds it on an H100.  At the ResNet-50 shapes (P = N*H*W pixel
// rows, C in {256..1024}, M in {128..1024}) a bf16 product does 2*P*C*M
// operations over (P*C + M*C + P*M)*2 bytes: 100 to 200 operations per
// byte, under the ~295 at which the tensor cores, not HBM at 3.35 TB/s,
// become the limit.  So the bf16 path is bound by bytes.  The fp32 path
// runs without TF32 on the CUDA cores (67 TFLOP/s peak) and is bound by
// operations.
//
// What this simple design leaves on the table: no cp.async/TMA pipeline
// (each K step loads, synchronises, then computes, so memory and math do
// not overlap), mma.sync-class WMMA instead of wgmma, 128x128 tiles with
// no persistent schedule, and no fused epilogue.  The NCHW <-> pixel-major
// copies around the kernel (ops/conv1x1.py) move more bytes than the
// product itself; a channels-last layout removes them.
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

// ---------------------------------------------------------------------------
// bf16 inputs: 128x128 output tile per block, 8 warps as 2 (m) x 4 (n),
// each warp a 64x32 sub-tile of 4x2 WMMA 16x16x16 fragments, K step 32.
// ---------------------------------------------------------------------------
template <bool TA, bool TB>
__global__ void __launch_bounds__(kThreads)
    mm_bf16_wmma(const __nv_bfloat16* __restrict__ A,
                 const __nv_bfloat16* __restrict__ B, void* __restrict__ O,
                 int M, int N, int K, int out_bf16, int vec_a, int vec_b) {
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

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: BM*BK values in chunks of 8 along the storage row
#pragma unroll
    for (int c = tid; c < BM * BK / 8; c += kThreads) {
      if (!TA) {                       // storage [M][K]
        const int row = c / (BK / 8), col = (c % (BK / 8)) * 8;
        const int gm = m0 + row, gk = k0 + col;
        const int n = (gm < M) ? min(8, K - gk) : 0;
        load8_bf16(&As[row * LDA + col],
                   A + (size_t)(gm < M ? gm : 0) * K + gk, n, vec_a);
      } else {                         // storage [K][M]
        const int row = c / (BM / 8), col = (c % (BM / 8)) * 8;
        const int gk = k0 + row, gm = m0 + col;
        const int n = (gk < K) ? min(8, M - gm) : 0;
        load8_bf16(&As[row * LDA + col],
                   A + (size_t)(gk < K ? gk : 0) * M + gm, n, vec_a);
      }
    }
    // B tile: BK*BN values
#pragma unroll
    for (int c = tid; c < BN * BK / 8; c += kThreads) {
      if (!TB) {                       // storage [K][N]
        const int row = c / (BN / 8), col = (c % (BN / 8)) * 8;
        const int gk = k0 + row, gn = n0 + col;
        const int n = (gk < K) ? min(8, N - gn) : 0;
        load8_bf16(&Bs[row * LDB + col],
                   B + (size_t)(gk < K ? gk : 0) * N + gn, n, vec_b);
      } else {                         // storage [N][K]
        const int row = c / (BK / 8), col = (c % (BK / 8)) * 8;
        const int gn = n0 + row, gk = k0 + col;
        const int n = (gn < N) ? min(8, K - gk) : 0;
        load8_bf16(&Bs[row * LDB + col],
                   B + (size_t)(gn < N ? gn : 0) * K + gk, n, vec_b);
      }
    }
    __syncthreads();

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
  // tile so the stores can be masked and converted to the output type
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
        if (r < M && cc < N) store_out(O, (size_t)r * N + cc, cs[e], out_bf16);
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 inputs: exact fp32 FMAs (no TF32).  64x64 output tile per block,
// each of the 256 threads a 4x4 register tile, K step 16.
// ---------------------------------------------------------------------------
template <bool TA, bool TB>
__global__ void __launch_bounds__(kThreads)
    mm_f32_simt(const float* __restrict__ A, const float* __restrict__ B,
                void* __restrict__ O, int M, int N, int K, int out_bf16) {
  constexpr int BM = 64, BN = 64, BK = 16;
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    // consecutive threads walk the contiguous storage dimension
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int mm = TA ? e % BM : e / BK;
      const int kk = TA ? e / BM : e % BK;
      const int gm = m0 + mm, gk = k0 + kk;
      float v = 0.f;
      if (gm < M && gk < K) {
        v = TA ? A[(size_t)gk * M + gm] : A[(size_t)gm * K + gk];
      }
      As[kk][mm] = v;
    }
    for (int e = tid; e < BN * BK; e += kThreads) {
      const int nn = TB ? e / BK : e % BN;
      const int kk = TB ? e % BK : e / BN;
      const int gn = n0 + nn, gk = k0 + kk;
      float v = 0.f;
      if (gn < N && gk < K) {
        v = TB ? B[(size_t)gn * K + gk] : B[(size_t)gk * N + gn];
      }
      Bs[kk][nn] = v;
    }
    __syncthreads();
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (r < M && c < N) store_out(O, (size_t)r * N + c, acc[i][j], out_bf16);
    }
  }
}

template <bool TA, bool TB>
void launch(const void* a, const void* b, void* out, int M, int N, int K,
            int in_bf16, int out_bf16, cudaStream_t stream) {
  if (in_bf16) {
    const dim3 grid((N + 127) / 128, (M + 127) / 128);
    const int vec_a = (reinterpret_cast<uintptr_t>(a) % 16 == 0) &&
                      ((TA ? M : K) % 8 == 0);
    const int vec_b = (reinterpret_cast<uintptr_t>(b) % 16 == 0) &&
                      ((TB ? K : N) % 8 == 0);
    mm_bf16_wmma<TA, TB><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), out, M, N, K, out_bf16, vec_a,
        vec_b);
  } else {
    const dim3 grid((N + 63) / 64, (M + 63) / 64);
    mm_f32_simt<TA, TB><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), out, M,
        N, K, out_bf16);
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Launches on `stream` and does
// not synchronise; returns cudaGetLastError() (0 = launched).
extern "C" int conv1x1_mm(const void* a, const void* b, void* out, int M,
                          int N, int K, int ta, int tb, int in_dtype,
                          int out_dtype, void* stream) {
  if ((in_dtype != 0 && in_dtype != 1) || (out_dtype != 0 && out_dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int in_bf16 = in_dtype == 1, out_bf16 = out_dtype == 1;
  if (!ta && !tb) {
    launch<false, false>(a, b, out, M, N, K, in_bf16, out_bf16, s);
  } else if (!ta && tb) {
    launch<false, true>(a, b, out, M, N, K, in_bf16, out_bf16, s);
  } else if (ta && !tb) {
    launch<true, false>(a, b, out, M, N, K, in_bf16, out_bf16, s);
  } else {
    launch<true, true>(a, b, out, M, N, K, in_bf16, out_bf16, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* conv1x1_mm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
