// E5 proto_realign: the section realign copy of experiments/proto_realign.py.
//
// Replaces: experiments/proto_realign.py, the kernel in make_run (:23),
// which gathers each chain's 24 rows through 24 scalar-prefetched (8, 128)
// BlockSpecs and transposes them across the group's 8 chains with sublane
// rolls and selects.
//
// out[g, t, s, :] = raw2d[starts_blk[g * 8 + s] * 8 + t, :] for t < 24: the
// 24 rows (3 aligned blocks of 1,024 words) of chain (g, s), laid out
// (group, row, chain, 128) as the decode kernel of the TPU design reads them.
// A block index outside [0, n_rows / 8 - 3] traps.
//
// What bounds it on Hopper: bytes. Each output row of 512 bytes is read once
// and written once; nothing is computed.
//
// What the design does about it: one warp per output row, each lane moving
// 16 bytes in and 16 bytes out, so every load and store is a coalesced 512 B
// transaction; a block of 8 warps writes the 8 chains of one (g, t).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int FETCH_ROWS = 24;

__global__ void __launch_bounds__(256) realign_kernel(const int4* __restrict__ raw2d, long long n_rows,
                                                      const int* __restrict__ starts_blk,
                                                      int4* __restrict__ out) {
  const int g = blockIdx.x / FETCH_ROWS, t = blockIdx.x % FETCH_ROWS;
  const int s = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long blk = starts_blk[g * 8 + s];
  if (blk < 0 || blk * 8 + FETCH_ROWS > n_rows) __trap();
  out[((long long)blockIdx.x * 8 + s) * 32 + lane] = raw2d[(blk * 8 + t) * 32 + lane];
}

}  // namespace

extern "C" int proto_realign(const void* raw2d, long long n_rows, const void* starts_blk, void* out, int n_groups,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_groups < 0 || n_rows < FETCH_ROWS) return (int)cudaErrorInvalidValue;
  if (n_groups == 0) return 0;
  realign_kernel<<<(unsigned)n_groups * FETCH_ROWS, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(raw2d), n_rows, static_cast<const int*>(starts_blk), static_cast<int4*>(out));
  return (int)cudaGetLastError();
}

extern "C" const char* pcodec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
