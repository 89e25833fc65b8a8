// K4 dict_join: the Dict-mode join, a clamped gather of memory bits.
//
// Replaces: pcodec_tpu/ops/pallas_decode.py::_dict_join_kernel_body and
// _dict_join_kernel_body_big (launched by _dict_join_pairs), the TPU kernels
// that gather through select trees over 128-lane planes (a full tree up to
// 8,192 entries, a hot prefix plus a cold-plane loop up to 2^15) and emit
// (lo, hi) i32 word pairs; past 2^15 entries JAX falls back to an XLA gather.
//
// out[i] = table[min(primary[i] & 0xFFFFFFFF, D - 1)], where the table holds
// each entry's memory bits with the latent -> memory bijection folded in.
//
// What bounds it on Hopper: bytes. Each number reads 8 bytes of index and
// writes 8 bytes of bits; the table is read once. The gathers are random
// but land in a table that is small beside the stream.
//
// What the design does about it: one thread per number, grid-stride over a
// grid sized to fill the card, coalesced index loads and output stores. A
// table that fits the block's opt-in shared memory (D x 8 bytes, 29,056
// entries on an H100) is copied into shared memory by every block; a larger
// one (the format allows 2^25 entries; 100,000 entries is 800 KB) is read
// from device memory through the read-only path, where it stays in L2.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;
constexpr int THREADS = 1024;

template <bool SMEM>
__global__ void __launch_bounds__(THREADS) dict_join_kernel(const u64* __restrict__ primary,
                                                           const u64* __restrict__ table, u64* __restrict__ out,
                                                           long long n, long long D) {
  extern __shared__ u64 s_tab[];
  if (SMEM) {
    for (long long i = threadIdx.x; i < D; i += THREADS) s_tab[i] = table[i];
    __syncthreads();
  }
  const u64 last = (u64)(D - 1);
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n; i += stride) {
    u64 idx = primary[i] & 0xFFFFFFFFull;
    idx = idx < last ? idx : last;
    out[i] = SMEM ? s_tab[idx] : __ldg(table + idx);
  }
}

template <bool SMEM>
cudaError_t launch(const u64* primary, const u64* table, u64* out, long long n, long long D, int device,
                   cudaStream_t s) {
  const size_t smem = SMEM ? (size_t)D * sizeof(u64) : 0;
  cudaError_t err = cudaFuncSetAttribute(dict_join_kernel<SMEM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dict_join_kernel<SMEM>, THREADS, smem);
  if (err != cudaSuccess) return err;
  const long long need = (n + THREADS - 1) / THREADS;
  const long long fill = (long long)sms * (per_sm > 0 ? per_sm : 1);
  dict_join_kernel<SMEM><<<(unsigned)(need < fill ? need : fill), THREADS, smem, s>>>(primary, table, out, n, D);
  return cudaGetLastError();
}

}  // namespace

// Largest table (entries) the shared-memory route takes on `device`.
extern "C" long long dict_join_smem_entries(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess) return 0;
  return optin / (long long)sizeof(u64);
}

extern "C" int dict_join(const void* primary, const void* table, void* out, long long n, long long D, int smem,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 0 || D < 1 || (smem && D > dict_join_smem_entries(device))) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<const u64*>(primary);
  auto t = static_cast<const u64*>(table);
  auto o = static_cast<u64*>(out);
  err = smem ? launch<true>(p, t, o, n, D, device, s) : launch<false>(p, t, o, n, D, device, s);
  return (int)err;
}

extern "C" const char* pcodec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
