// E1 proto_dma: per-chain fetches into shared memory, double-buffered, with a
// checksum and dependent rounds; the microbenchmark of experiments/proto_dma.py.
//
// Replaces: experiments/proto_dma.py, the kernel in make_run (:24), which
// issues one make_async_copy per chain (128 a tile) from a scalar-prefetched
// word offset into VMEM scratch that persists across the sequential grid, so
// tile i + 1's copies fly while tile i is summed.
//
// For tile i and chain ch < 128, with al = starts[i, ch] & ~1023 (the start
// rounded down to its 1,024-word block) and sec_ch = raw[al : al + 3072]:
//   acc[r, l] = sum over g < 16, k < 16 of sec_{g*8+r}[k*128 + l]   (int32, wrapping)
// then heavy_rounds rounds of a <- a + acc[r, a[r, l] & 127] from a = acc,
// and out[i] = a. All 3,072 words of each chain are fetched; the first 2,048
// are summed. A fetch outside raw traps.
//
// What bounds it on Hopper: bytes, the 12 KB fetched per chain; the sum is 16
// adds a word column and the rounds are short dependent chains in shared
// memory.
//
// What the design does about it: a tile's 128 fetches are 1.5 MB, more than
// an SM holds, so a tile's chains are split over 16 blocks of 8 chains (chain
// group g). Each block loops over tiles i = y, y + P, ... (P blocks per group
// in flight, one block an SM) with two 96 KB slots: one thread issues the
// next tile's 8 copies as 1D bulk copies (cp.async.bulk, the TMA's raw-byte
// form) completing on the slot's mbarrier before the block sums the current
// slot. The 16 partial sums of a tile go to a scratch array, and a second
// kernel adds them and runs the dependent rounds with acc in shared memory.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int N_CHAINS = 128;
constexpr int FETCH_WORDS = 3072;
constexpr int SUM_BLOCKS = 16;  // SEC_WORDS / 128 word columns summed per chain
constexpr int GROUPS = 16;      // blocks per tile, 8 chains each
constexpr int CHAINS_PER_BLOCK = 8;
constexpr int THREADS = 1024;   // thread (r, l): chain r of the block, word column l
constexpr unsigned CHAIN_BYTES = FETCH_WORDS * 4;
constexpr unsigned SLOT_BYTES = CHAINS_PER_BLOCK * CHAIN_BYTES;  // 98,304
constexpr size_t SMEM_BYTES = 2 * SLOT_BYTES + 2 * sizeof(uint64_t);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_fetch(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

__global__ void __launch_bounds__(THREADS, 1) dma_sum_kernel(const int* __restrict__ raw, long long n_raw,
                                                            const int* __restrict__ starts, int* __restrict__ part,
                                                            int n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned* buf = reinterpret_cast<const unsigned*>(smem);  // [slot][chain][FETCH_WORDS]
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 2 * SLOT_BYTES);
  const int g = blockIdx.x, stride = gridDim.y;
  if (threadIdx.x == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int tile, int slot) {  // thread 0 only
    mbar_expect_tx(&bar[slot], SLOT_BYTES);
    for (int r = 0; r < CHAINS_PER_BLOCK; ++r) {
      const long long al = starts[(long long)tile * N_CHAINS + g * CHAINS_PER_BLOCK + r] & ~1023;
      if (al < 0 || al + FETCH_WORDS > n_raw) __trap();
      bulk_fetch(smem + slot * SLOT_BYTES + r * CHAIN_BYTES, raw + al, CHAIN_BYTES, &bar[slot]);
    }
  };
  const int r = threadIdx.x >> 7, l = threadIdx.x & 127;
  if (threadIdx.x == 0 && (int)blockIdx.y < n_tiles) issue(blockIdx.y, 0);
  int it = 0;
  for (int tile = blockIdx.y; tile < n_tiles; tile += stride, ++it) {
    const int slot = it & 1;
    if (threadIdx.x == 0 && tile + stride < n_tiles) issue(tile + stride, slot ^ 1);
    mbar_wait(&bar[slot], (it >> 1) & 1);
    const unsigned* sec = buf + (slot * CHAINS_PER_BLOCK + r) * FETCH_WORDS;
    unsigned acc = 0;
#pragma unroll
    for (int k = 0; k < SUM_BLOCKS; ++k) acc += sec[k * 128 + l];
    part[((long long)tile * GROUPS + g) * (CHAINS_PER_BLOCK * 128) + threadIdx.x] = (int)acc;
    __syncthreads();  // the slot is read before it is refilled
  }
}

__global__ void __launch_bounds__(THREADS) dma_rounds_kernel(const int* __restrict__ part, int* __restrict__ out,
                                                            int heavy_rounds) {
  __shared__ unsigned s_acc[THREADS];
  const long long tile = blockIdx.x;
  unsigned acc = 0;
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) acc += (unsigned)part[(tile * GROUPS + g) * THREADS + threadIdx.x];
  s_acc[threadIdx.x] = acc;
  __syncthreads();
  const unsigned* row = s_acc + (threadIdx.x & ~127);
  unsigned a = acc;
  for (int i = 0; i < heavy_rounds; ++i) a += row[a & 127];
  out[tile * THREADS + threadIdx.x] = (int)a;
}

}  // namespace

// part: (n_tiles, 16, 8, 128) int32 scratch; out: (n_tiles, 8, 128) int32.
extern "C" int proto_dma(const void* raw, long long n_raw, const void* starts, void* part, void* out, int n_tiles,
                         int heavy_rounds, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles < 0 || heavy_rounds < 0 || (reinterpret_cast<uintptr_t>(raw) & 15)) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dma_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int per_group = sms / GROUPS;
  per_group = per_group < 1 ? 1 : (per_group > n_tiles ? n_tiles : per_group);
  dma_sum_kernel<<<dim3(GROUPS, per_group), THREADS, SMEM_BYTES, s>>>(
      static_cast<const int*>(raw), n_raw, static_cast<const int*>(starts), static_cast<int*>(part), n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dma_rounds_kernel<<<n_tiles, THREADS, 0, s>>>(static_cast<const int*>(part), static_cast<int*>(out), heavy_rounds);
  return (int)cudaGetLastError();
}

extern "C" const char* pcodec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
