// HBM stream copy for paddle_tpu_torch (benchmark/bandwidth.py), written
// by hand for Hopper (sm_90a) on the bulk-copy (TMA) engine.
//
// Replaces the TPU kernel _dma_copy of benchmark/bandwidth.py (:111,
// pallas_call :163): o = x moved by pure DMA, HBM -> a VMEM slot -> HBM,
// through two slots, with a DMA semaphore per slot and direction, so that
// the input DMA of chunk i + 1 is in flight while chunk i's output DMA
// drains.  No vector unit touches the data.
//
// Translation.  The TPU kernel is one program that walks every 2 MB chunk
// of the array in order.  Here the chunks are kSlotBytes long (a 2 MB
// chunk does not fit in shared memory) and split into contiguous ranges,
// one per block, over a persistent grid of as many blocks as fit on the
// card at once (three per SM: each holds 64 KB of slots).  In each block
// one thread issues every copy, and no thread moves data:
//
//   input   cp.async.bulk global -> shared slot, completing on the slot's
//           mbarrier (mbarrier::complete_tx::bytes).  The barrier plays
//           the input semaphore: the thread arms it with
//           mbarrier.arrive.expect_tx and waits with
//           mbarrier.try_wait.parity, whose parity flips on each reuse of
//           the slot.
//   output  cp.async.bulk shared slot -> global, one bulk group per chunk
//           (cp.async.bulk.commit_group).  Before a slot is refilled,
//           cp.async.bulk.wait_group.read 0 waits until the store of the
//           chunk it held has read it out: bandwidth.py:135-139, "its
//           previous chunk's output DMA must have drained".
//   drain   cp.async.bulk.wait_group 0 at the end, as bandwidth.py:150-154
//           waits on the last output DMAs.
//
// The bulk store reads shared memory that the bulk load wrote; both run
// in the async proxy, so no fence.proxy.async is needed between them.
// Nothing in the generic proxy writes a slot.
//
// The last chunk of the array may be short.  The bulk copy needs its size
// and both addresses to be multiples of 16 bytes; stream_dma_copy returns
// cudaErrorInvalidValue otherwise, before any launch.
//
// What bounds it on an H100: bytes only.  A copy of N bytes reads N and
// writes N, 2N over 3.35 TB/s (1.28 ms at 2 GB).  The design keeps one
// input chunk in flight per block beside its draining output, about 96 KB
// of loads in flight per SM, several times the 3.35 TB/s x ~1 us of
// latency that each of the 132 SMs has to cover (about 25 KB).
//
// A wait that has not completed after about 4 s of clock cycles traps
// (an unspecified launch failure) rather than hang the card.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kSlots = 2;                       // bandwidth.py:158
constexpr uint32_t kSlotBytes = 32 * 1024;
constexpr int kThreads = 32;                    // one warp; one issues
constexpr long long kTimeoutCycles = 1LL << 33;
constexpr size_t kSmemBytes = kSlots * kSlotBytes + kSlots * sizeof(uint64_t);

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > kTimeoutCycles) __trap();
  }
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
    stream_copy_kernel(const unsigned char* __restrict__ x,
                       unsigned char* __restrict__ o, size_t nbytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (threadIdx.x != 0) return;
  const uint32_t slots = smem_addr(smem);
  const uint32_t bars = slots + kSlots * kSlotBytes;
  for (int s = 0; s < kSlots; ++s) mbar_init(bars + 8 * s);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  const size_t nchunks = (nbytes + kSlotBytes - 1) / kSlotBytes;
  const size_t c0 = nchunks * blockIdx.x / gridDim.x;
  const size_t n = nchunks * (blockIdx.x + 1) / gridDim.x - c0;
  auto bytes_of = [&](size_t i) -> uint32_t {
    const size_t rest = nbytes - (c0 + i) * kSlotBytes;
    return rest < kSlotBytes ? static_cast<uint32_t>(rest) : kSlotBytes;
  };
  auto load = [&](size_t i) {
    const uint32_t s = static_cast<uint32_t>(i % kSlots);
    const uint32_t b = bytes_of(i);
    mbar_expect_tx(bars + 8 * s, b);
    bulk_load(slots + s * kSlotBytes, x + (c0 + i) * kSlotBytes, b,
              bars + 8 * s);
  };

  for (size_t i = 0; i + 1 < kSlots && i < n; ++i) load(i);
  for (size_t i = 0; i < n; ++i) {
    const size_t next = i + kSlots - 1;
    if (next < n) {
      // the slot of `next` last held chunk i - 1, stored one step ago
      if (i >= 1) {
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
      load(next);
    }
    const uint32_t s = static_cast<uint32_t>(i % kSlots);
    mbar_wait(bars + 8 * s, static_cast<uint32_t>((i / kSlots) & 1));
    bulk_store(o + (c0 + i) * kSlotBytes, slots + s * kSlotBytes,
               bytes_of(i));
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

constexpr int kMaxDevices = 64;
int g_grid[kMaxDevices];     // blocks of the persistent grid, 0 = not yet

// Blocks that fit on device `dev` at once (SMs x blocks per SM); sets the
// kernel's dynamic shared memory limit on first use.
cudaError_t grid_size(int dev, int* blocks) {
  if (dev >= 0 && dev < kMaxDevices && g_grid[dev] > 0) {
    *blocks = g_grid[dev];
    return cudaSuccess;
  }
  cudaError_t e = cudaFuncSetAttribute(
      stream_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (e != cudaSuccess) return e;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, stream_copy_kernel, kThreads, kSmemBytes);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  if (dev >= 0 && dev < kMaxDevices) g_grid[dev] = *blocks;
  return cudaSuccess;
}

}  // namespace

// o[0:nbytes] = x[0:nbytes] on `stream` (a cudaStream_t), with no
// synchronisation.  Returns cudaGetLastError() after the launch (0 =
// launched); sizes or addresses that are not multiples of 16 bytes
// return cudaErrorInvalidValue before any launch.  nbytes == 0 launches
// nothing.
extern "C" int stream_dma_copy(const void* x, void* o, size_t nbytes,
                               void* stream) {
  if (nbytes % 16 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(o) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nbytes == 0) return 0;
  int dev = 0, blocks = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = grid_size(dev, &blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t nchunks = (nbytes + kSlotBytes - 1) / kSlotBytes;
  const unsigned grid = static_cast<unsigned>(
      nchunks < static_cast<size_t>(blocks) ? nchunks : blocks);
  stream_copy_kernel<<<grid, kThreads, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(o),
      nbytes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* stream_copy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
