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
// each block: one block of 4 warps owns 64 query rows (forward, dq) or 64
// key rows (dk/dv), 16 per warp, and keeps its accumulators in registers
// while the other operand streams through shared memory in 64-row tiles,
// double-buffered with cp.async so the next tile loads while this one is
// computed.  dk/dv has one owner per key tile, so there are no atomics
// and every run gives the same bits, as on the TPU.  Under causal masking
// the last query tile walks every key tile and the first walks one, so
// the forward and dq launch the longest tiles first (block b takes query
// tile nq - 1 - b / BH) and dk/dv its longest (the first key tiles) first.
//
// Products.  bf16: every product runs on the tensor cores, mma.sync
// m16n8k16 with fp32 accumulation, operands from shared memory through
// ldmatrix.  q k^T and dO v^T multiply bf16 data, so their products are
// exact.  p v, ds k, p^T dO and ds^T q multiply an fp32 probability (or
// its gradient) by bf16 data: here p and ds are ROUNDED TO BF16 for the
// tensor cores (the TPU's MXU rounds an f32 dot the same way at default
// precision), from the accumulator registers straight into the A
// fragments.  The row sums of the softmax use the fp32 p.  So against the
// plain fp32 formula a bf16 result carries a relative error of about
// 2^-9 per term besides its own rounding; chip_smoke.py states the
// tolerance.  The scale: JAX scales q in fp32 before the product; this
// kernel scales s after the bf16 product, which differs from that only by
// fp32 rounding, and not at all when the scale is a power of two (D = 64
// or D = 16).  fp32: one warp per row on the CUDA cores with exact fp32
// FMAs in the order of the plain formula (q scaled first), as the fp32
// form of the 1x1-conv kernel does; it is the tests' form, not the
// training path's.
//
// What bounds it on an H100.  At the long-context shape (BH 8, T 65536,
// D 64, causal) each product is 2 * BH * T(T+1)/2 * D = 2.2e12 operations
// while the tensors moved are ~0.3 GB, so all three kernels are bound by
// operations (4.4e12 for the forward, 6.7e12 for dq, 8.8e12 for dk/dv, at
// 989 TFLOP/s of bf16).  What this simple design leaves on the table:
// mma.sync instead of wgmma, no TMA, no warp specialisation, exp on the
// SFU for every score, and dq and dk/dv each recompute s and dp, as the
// TPU kernels do.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;   // NEG_INF of pallas_kernels.py:38
constexpr int kThreads = 128;       // 4 warps
constexpr int kTile = 64;           // rows of a tile (query or key)
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

// ---------------------------------------------------------------------------
// primitives: cp.async, ldmatrix, mma.sync
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !valid (src-size 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c[4] += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to bf16 and packed, the lower column in the
// lower half (the fragment order).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) x[i][e] = 0.f;
  }
}

// Rows [r0, r0 + 64) of a [T, dim] bf16 matrix into a [64][DP + 8] shared
// tile, asynchronously; rows past T and columns past dim are zero.  The
// row padding of 8 elements (16 bytes) keeps ldmatrix free of bank
// conflicts.
template <int DP>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, int r0,
                                          int T, int dim) {
  constexpr int LD = DP + 8, CH = DP / 8;
  for (int i = threadIdx.x; i < kTile * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = (r0 + r < T) && (c < dim);
    cp_async16(s + r * LD + c, ok ? g + static_cast<size_t>(r0 + r) * dim + c
                                  : g,
               ok);
  }
}

// acc (16 x 64, this warp's rows xrow0.. of X) += X Y^T over `ksteps` * 16
// columns, X and Y both [64][DP + 8] shared tiles stored along the
// contraction.  acc[j] is n-tile j (columns 8j..8j+7): c0, c1 at row g,
// columns 2t, 2t+1; c2, c3 at row g + 8.
template <int DP>
__device__ __forceinline__ void mma_nt(float (&acc)[8][4], const bf16* xs,
                                       int xrow0, const bf16* ys, int ksteps) {
  constexpr int LD = DP + 8;
  const int lane = threadIdx.x & 31;
  const int mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    if (kk < ksteps) {
      uint32_t a[4];
      ldsm_x4(a, xs + (xrow0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4(b, ys + (np * 16 + r + (mi >> 1) * 8) * LD + kk * 16 +
                       (mi & 1) * 8);
        mma16816(acc[2 * np], a, b[0], b[1]);
        mma16816(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
}

// acc (16 x DP) += P (16 x 64, fp32 in the mma_nt accumulator layout,
// rounded to bf16 here) Y, Y a [64][DP + 8] shared tile whose rows are the
// contraction; `nsteps` * 16 output columns.
template <int DP>
__device__ __forceinline__ void mma_pv(float (&acc)[DP / 8][4],
                                       const float (&p)[8][4], const bf16* ys,
                                       int nsteps) {
  constexpr int LD = DP + 8;
  const int lane = threadIdx.x & 31;
  const int mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int np = 0; np < DP / 16; ++np) {
      if (np < nsteps) {
        uint32_t b[4];
        ldsm_x4_t(b, ys + (kk * 16 + r + (mi & 1) * 8) * LD + np * 16 +
                         (mi >> 1) * 8);
        mma16816(acc[2 * np], a, b[0], b[1]);
        mma16816(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
}

// Key tiles a query tile starting at q0 needs: all, or under causal
// masking those up to the tile holding its last row.
__device__ __forceinline__ int key_tiles(const Args& a, int q0) {
  int n = (a.Tk + kTile - 1) / kTile;
  if (a.causal) n = min(n, min(q0 + kTile - 1, a.Tq - 1) / kTile + 1);
  return n;
}

// ---------------------------------------------------------------------------
// bf16 forward (K2)
// ---------------------------------------------------------------------------
template <int DP>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16(Args a) {
  constexpr int TILE = kTile * (DP + 8);
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + TILE;        // 2 stages
  bf16* Vs = Ks + 2 * TILE;    // 2 stages
  const int nq = (a.Tq + kTile - 1) / kTile;
  const int bh = blockIdx.x % a.BH;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x / a.BH)) * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* q = static_cast<const bf16*>(a.q) + static_cast<size_t>(bh) * a.Tq * a.D;
  const bf16* k = static_cast<const bf16*>(a.k) + static_cast<size_t>(bh) * a.Tk * a.D;
  const bf16* v = static_cast<const bf16*>(a.v) + static_cast<size_t>(bh) * a.Tk * a.Dv;
  const int nkt = key_tiles(a, q0);

  load_tile<DP>(Qs, q, q0, a.Tq, a.D);
  load_tile<DP>(Ks, k, 0, a.Tk, a.D);
  load_tile<DP>(Vs, v, 0, a.Tk, a.Dv);
  cp_async_commit();

  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[DP / 8][4];
  zero(acc);
  for (int it = 0; it < nkt; ++it) {
    const int st = it & 1;
    if (it + 1 < nkt) {
      load_tile<DP>(Ks + (st ^ 1) * TILE, k, (it + 1) * kTile, a.Tk, a.D);
      load_tile<DP>(Vs + (st ^ 1) * TILE, v, (it + 1) * kTile, a.Tk, a.Dv);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    float s[8][4];
    zero(s);
    mma_nt<DP>(s, Qs, warp * 16, Ks + st * TILE, a.D / 16);
    const int k0 = it * kTile;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const bool keep = col < a.Tk && !(a.causal && col > row[e >> 1]);
        s[j][e] = keep ? s[j][e] * a.scale : kNegInf;
      }
    }
    // online softmax; a quad of lanes (same g) shares each row
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float alpha = expf(m[h] - mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][2 * h] = expf(s[j][2 * h] - mx);
        s[j][2 * h + 1] = expf(s[j][2 * h + 1] - mx);
        sum += s[j][2 * h] + s[j][2 * h + 1];
      }
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      l[h] = l[h] * alpha + sum;
      m[h] = mx;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        acc[n][2 * h] *= alpha;
        acc[n][2 * h + 1] *= alpha;
      }
    }
    mma_pv<DP>(acc, s, Vs + st * TILE, a.Dv / 16);
    __syncthreads();
  }
  cp_async_wait<0>();

  bf16* out = static_cast<bf16*>(a.out) + static_cast<size_t>(bh) * a.Tq * a.Dv;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= a.Tq) continue;
    const float ls = fmaxf(l[h], 1e-20f);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < a.Dv) {
        *reinterpret_cast<__nv_bfloat162*>(
            out + static_cast<size_t>(row[h]) * a.Dv + col) =
            __floats2bfloat162_rn(acc[n][2 * h] / ls, acc[n][2 * h + 1] / ls);
      }
    }
    if (t == 0)
      a.lse_out[static_cast<size_t>(bh) * a.Tq + row[h]] = m[h] + logf(ls);
  }
}

// ---------------------------------------------------------------------------
// bf16 backward, dq (K3)
// ---------------------------------------------------------------------------
template <int DP>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_bf16(Args a) {
  constexpr int TILE = kTile * (DP + 8);
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + TILE;
  bf16* Ks = dOs + TILE;       // 2 stages
  bf16* Vs = Ks + 2 * TILE;    // 2 stages
  const int nq = (a.Tq + kTile - 1) / kTile;
  const int bh = blockIdx.x % a.BH;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x / a.BH)) * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qrows = static_cast<size_t>(bh) * a.Tq;
  const bf16* q = static_cast<const bf16*>(a.q) + qrows * a.D;
  const bf16* dout = static_cast<const bf16*>(a.dout) + qrows * a.Dv;
  const bf16* k = static_cast<const bf16*>(a.k) + static_cast<size_t>(bh) * a.Tk * a.D;
  const bf16* v = static_cast<const bf16*>(a.v) + static_cast<size_t>(bh) * a.Tk * a.Dv;
  const int nkt = key_tiles(a, q0);

  load_tile<DP>(Qs, q, q0, a.Tq, a.D);
  load_tile<DP>(dOs, dout, q0, a.Tq, a.Dv);
  load_tile<DP>(Ks, k, 0, a.Tk, a.D);
  load_tile<DP>(Vs, v, 0, a.Tk, a.Dv);
  cp_async_commit();

  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse[2], delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse[h] = row[h] < a.Tq ? a.lse_in[qrows + row[h]] : 0.f;
    delta[h] = row[h] < a.Tq ? a.delta[qrows + row[h]] : 0.f;
  }
  float acc[DP / 8][4];
  zero(acc);
  for (int it = 0; it < nkt; ++it) {
    const int st = it & 1;
    if (it + 1 < nkt) {
      load_tile<DP>(Ks + (st ^ 1) * TILE, k, (it + 1) * kTile, a.Tk, a.D);
      load_tile<DP>(Vs + (st ^ 1) * TILE, v, (it + 1) * kTile, a.Tk, a.Dv);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    mma_nt<DP>(s, Qs, warp * 16, Ks + st * TILE, a.D / 16);
    mma_nt<DP>(dp, dOs, warp * 16, Vs + st * TILE, a.Dv / 16);
    const int k0 = it * kTile;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const bool keep = col < a.Tk && !(a.causal && col > row[h]);
        const float p = expf((keep ? s[j][e] * a.scale : kNegInf) - lse[h]);
        s[j][e] = p * (dp[j][e] - delta[h]);        // ds
      }
    }
    mma_pv<DP>(acc, s, Ks + st * TILE, a.D / 16);  // dq += ds k
    __syncthreads();
  }
  cp_async_wait<0>();

  bf16* dq = static_cast<bf16*>(a.dq) + qrows * a.D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= a.Tq) continue;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < a.D) {
        *reinterpret_cast<__nv_bfloat162*>(
            dq + static_cast<size_t>(row[h]) * a.D + col) =
            __floats2bfloat162_rn(acc[n][2 * h] * a.scale,
                                  acc[n][2 * h + 1] * a.scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 backward, dk and dv (K4): one block per key tile, queries stream
// ---------------------------------------------------------------------------
template <int DP>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_bf16(Args a) {
  constexpr int TILE = kTile * (DP + 8);
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + TILE;
  bf16* Qs = Vs + TILE;        // 2 stages
  bf16* dOs = Qs + 2 * TILE;   // 2 stages
  float* Ls = reinterpret_cast<float*>(dOs + 2 * TILE);   // [2][64]
  float* Ds = Ls + 2 * kTile;                             // [2][64]
  const int bh = blockIdx.x % a.BH;
  const int k0 = static_cast<int>(blockIdx.x / a.BH) * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qrows = static_cast<size_t>(bh) * a.Tq;
  const size_t krows = static_cast<size_t>(bh) * a.Tk;
  const bf16* q = static_cast<const bf16*>(a.q) + qrows * a.D;
  const bf16* dout = static_cast<const bf16*>(a.dout) + qrows * a.Dv;
  const bf16* k = static_cast<const bf16*>(a.k) + krows * a.D;
  const bf16* v = static_cast<const bf16*>(a.v) + krows * a.Dv;
  const int nqt = (a.Tq + kTile - 1) / kTile;
  // query tiles that see this key tile: under causal masking, from the
  // tile holding query row k0 on
  const int qt0 = a.causal ? k0 / kTile : 0;

  // lse (+inf past Tq, so p = 0 there) and delta of query tile qt
  auto load_rows = [&](int qt, int stage) {
    const int i = threadIdx.x & (kTile - 1);
    const int qi = qt * kTile + i;
    if (threadIdx.x < kTile) {
      Ls[stage * kTile + i] = qi < a.Tq ? a.lse_in[qrows + qi]
                                       : __int_as_float(0x7f800000);
    } else {
      Ds[stage * kTile + i] = qi < a.Tq ? a.delta[qrows + qi] : 0.f;
    }
  };

  load_tile<DP>(Ks, k, k0, a.Tk, a.D);
  load_tile<DP>(Vs, v, k0, a.Tk, a.Dv);
  if (qt0 < nqt) {
    load_tile<DP>(Qs, q, qt0 * kTile, a.Tq, a.D);
    load_tile<DP>(dOs, dout, qt0 * kTile, a.Tq, a.Dv);
    load_rows(qt0, 0);
  }
  cp_async_commit();

  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  float dk[DP / 8][4], dv[DP / 8][4];
  zero(dk);
  zero(dv);
  for (int qt = qt0; qt < nqt; ++qt) {
    const int st = (qt - qt0) & 1;
    if (qt + 1 < nqt) {
      load_tile<DP>(Qs + (st ^ 1) * TILE, q, (qt + 1) * kTile, a.Tq, a.D);
      load_tile<DP>(dOs + (st ^ 1) * TILE, dout, (qt + 1) * kTile, a.Tq, a.Dv);
      load_rows(qt + 1, st ^ 1);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    float s[8][4], dp[8][4];   // transposed: rows are this warp's keys
    zero(s);
    zero(dp);
    mma_nt<DP>(s, Ks, warp * 16, Qs + st * TILE, a.D / 16);
    mma_nt<DP>(dp, Vs, warp * 16, dOs + st * TILE, a.Dv / 16);
    const int q0 = qt * kTile;
    const float* lse = Ls + st * kTile;
    const float* delta = Ds + st * kTile;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + 2 * t + (e & 1);
        const bool keep = !(a.causal && key[e >> 1] > q0 + qc);
        const float p = expf((keep ? s[j][e] * a.scale : kNegInf) - lse[qc]);
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - delta[qc]);      // ds^T
      }
    }
    mma_pv<DP>(dv, s, dOs + st * TILE, a.Dv / 16);  // dv += p^T dO
    mma_pv<DP>(dk, dp, Qs + st * TILE, a.D / 16);   // dk += ds^T q
    __syncthreads();
  }
  cp_async_wait<0>();

  bf16* dkp = static_cast<bf16*>(a.dk) + krows * a.D;
  bf16* dvp = static_cast<bf16*>(a.dv) + krows * a.Dv;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= a.Tk) continue;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < a.D) {
        *reinterpret_cast<__nv_bfloat162*>(
            dkp + static_cast<size_t>(key[h]) * a.D + col) =
            __floats2bfloat162_rn(dk[n][2 * h] * a.scale,
                                  dk[n][2 * h + 1] * a.scale);
      }
      if (col < a.Dv) {
        *reinterpret_cast<__nv_bfloat162*>(
            dvp + static_cast<size_t>(key[h]) * a.Dv + col) =
            __floats2bfloat162_rn(dv[n][2 * h], dv[n][2 * h + 1]);
      }
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
template <int DP>
constexpr size_t tile_bytes() {
  return static_cast<size_t>(kTile) * (DP + 8) * sizeof(bf16);
}

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

long long tiles(int T) { return (T + kTile - 1) / kTile; }
long long groups(int T) { return (T + kRowsF32 - 1) / kRowsF32; }

enum Which { kFwd, kDq, kDkv };

// The bf16 kernels come in two widths: head dims up to 64, and up to 128.
template <int DP>
cudaError_t launch_bf16(Which w, const Args& a, cudaStream_t s) {
  switch (w) {
    case kFwd:
      return launch(flash_fwd_bf16<DP>, a.BH * tiles(a.Tq),
                    5 * tile_bytes<DP>(), s, a);
    case kDq:
      return launch(flash_bwd_dq_bf16<DP>, a.BH * tiles(a.Tq),
                    6 * tile_bytes<DP>(), s, a);
    default:
      return launch(flash_bwd_dkv_bf16<DP>, a.BH * tiles(a.Tk),
                    6 * tile_bytes<DP>() + 4 * kTile * sizeof(float), s, a);
  }
}

int run(Which w, const Args& a, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return static_cast<int>(a.D <= 64 && a.Dv <= 64 ? launch_bf16<64>(w, a, s)
                                                    : launch_bf16<128>(w, a, s));
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
// cudaErrorInvalidValue before any launch.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* out, void* lse, int BH, int Tq, int Tk,
                              int D, int Dv, int causal, float scale,
                              int dtype, void* stream) {
  if (bad_args(BH, Tq, Tk, D, Dv, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{q, k, v, nullptr, nullptr, nullptr, out, static_cast<float*>(lse),
         nullptr, nullptr, nullptr, BH, Tq, Tk, D, Dv, causal, scale};
  return run(kFwd, a, dtype, stream);
}

extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int BH, int Tq,
                                 int Tk, int D, int Dv, int causal,
                                 float scale, int dtype, void* stream) {
  if (bad_args(BH, Tq, Tk, D, Dv, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), nullptr, nullptr, dq, nullptr,
         nullptr, BH, Tq, Tk, D, Dv, causal, scale};
  return run(kDq, a, dtype, stream);
}

extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  int BH, int Tq, int Tk, int D, int Dv,
                                  int causal, float scale, int dtype,
                                  void* stream) {
  if (bad_args(BH, Tq, Tk, D, Dv, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), nullptr, nullptr, nullptr, dk, dv,
         BH, Tq, Tk, D, Dv, causal, scale};
  return run(kDkv, a, dtype, stream);
}

extern "C" const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
