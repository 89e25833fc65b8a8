// E1 proto_dma: a checksum of per-chain sections of raw words and dependent
// rounds over it; the microbenchmark of experiments/proto_dma.py.
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
// and out[i] = a. Only the first 2,048 words of a section are summed; a
// section outside raw (al < 0 or al + 3072 > n_raw) traps.
//
// What bounds it on Hopper: bytes, the distinct words of raw the sections
// sum (33.5 MB at the experiment's 256 tiles, whose chains cover nearly all
// of its 32 MiB). Fetching each chain's section, as the prototype does,
// reads each word about 12 times (402.7 MB at 256 tiles, from L2).
//
// What the design does about it: a section sums exactly two whole 1,024-word
// blocks, b = al >> 10 and b + 1, so the sum factors through the blocks'
// column sums C[b][l] = sum over k < 8 of raw[1024 b + 128 k + l]:
//   acc[r, l] = sum over g < 16 of C[b_{g*8+r}][l] + C[b_{g*8+r} + 1][l].
// Two kernels on the stream:
//   colsum_kernel  writes C, a warp a block, each word of the block read
//                  once by 16-byte loads, neighbouring lanes on neighbouring
//                  words. Where the chains touch fewer blocks than raw holds
//                  (2 * 128 * n_tiles < n_raw >> 10: at 32 MiB of raw, below
//                  32 tiles), a warp sums each block touch and checks its
//                  chain's start (a block touched k times is summed k times,
//                  its row written k times with the same words); else one
//                  pass sums every whole block (a trailing part-block is
//                  never needed);
//   tile_kernel    a block a tile, a warp a row r: it checks its 16 chains'
//                  starts, sums their 32 rows of C (512 bytes each, from L2,
//                  where C stays) into the row's 128 sums, 4 a lane, and runs
//                  the rounds as route lane of micro_gather.cu does, by
//                  pointer doubling (lane_doubling.cuh) with tbl = idx = acc:
//                  ceil(log2(heavy_rounds + 1)) rounds, not heavy_rounds
//                  dependent lookups. out[i] is written once.
// No kernel fetches a chain's section: raw is read by colsum_kernel alone.
#include <cstdint>
#include <cuda_runtime.h>

#include "lane_doubling.cuh"

namespace {

constexpr int N_CHAINS = 128;
constexpr int FETCH_WORDS = 3072;
constexpr int BLOCK_WORDS = 1024;                      // a block of raw, whose columns C sums
constexpr int COLSUM_THREADS = 256;                    // a warp a block of raw, 4 columns a lane
constexpr int COLSUM_BLOCKS = COLSUM_THREADS / 32;     // blocks of raw a thread block sums
constexpr int TILE_THREADS = 256;                      // a warp a row of the tile's 8

// Row b of C for each of the n_rows warps: block w, or with starts, block
// (starts[w >> 1] & ~1023) / 1024 + (w & 1), the chain's start checked first.
__global__ void __launch_bounds__(COLSUM_THREADS) colsum_kernel(const int4* __restrict__ raw4, long long n_raw,
                                                               const int* __restrict__ starts, long long n_rows,
                                                               int4* __restrict__ colsum) {
  const long long w = (long long)blockIdx.x * COLSUM_BLOCKS + (threadIdx.x >> 5);
  if (w >= n_rows) return;
  long long b = w;
  if (starts != nullptr) {
    const long long al = (long long)__ldg(starts + (w >> 1)) & ~1023ll;
    if (al < 0 || al + FETCH_WORDS > n_raw) __trap();
    b = al / BLOCK_WORDS + (w & 1);
  }
  const int t = threadIdx.x & 31;
  const int4* src = raw4 + b * (BLOCK_WORDS / 4) + t;  // columns 4t..4t+3 of the block's 8 rows of 128
  int4 v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = __ldg(src + 32 * k);
  unsigned a0 = 0, a1 = 0, a2 = 0, a3 = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    a0 += (unsigned)v[k].x;
    a1 += (unsigned)v[k].y;
    a2 += (unsigned)v[k].z;
    a3 += (unsigned)v[k].w;
  }
  colsum[b * 32 + t] = make_int4((int)a0, (int)a1, (int)a2, (int)a3);
}

__global__ void __launch_bounds__(TILE_THREADS) tile_kernel(const unsigned* __restrict__ colsum, long long n_raw,
                                                           const int* __restrict__ starts, int* __restrict__ out,
                                                           int heavy_rounds) {
  const long long tile = blockIdx.x;
  const unsigned r = threadIdx.x >> 5, lane = threadIdx.x & 31;
  long long b_mine = 0;  // lane g < 16: the first block of chain g * 8 + r
  if (lane < 16) {
    const long long al = (long long)starts[tile * N_CHAINS + lane * 8 + r] & ~1023ll;
    if (al < 0 || al + FETCH_WORDS > n_raw) __trap();
    b_mine = al / BLOCK_WORDS;
  }
  unsigned s[4] = {0, 0, 0, 0};
#pragma unroll
  for (int g = 0; g < 16; ++g) {
    const unsigned* c = colsum + __shfl_sync(LANES_FULL, b_mine, g) * 128;  // rows b and b + 1, contiguous
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j] += __ldg(c + lane + 32 * j) + __ldg(c + 128 + lane + 32 * j);
  }
  unsigned x[4] = {s[0], s[1], s[2], s[3]};
  lane_steps_doubling(s, x, (unsigned)heavy_rounds, lane);
  int* o = out + (tile * 8 + r) * 128;
#pragma unroll
  for (int j = 0; j < 4; ++j) o[lane + 32 * j] = (int)x[j];
}

}  // namespace

// colsum: (n_raw >> 10, 128) int32 scratch; out: (n_tiles, 8, 128) int32; raw
// 16-byte aligned.
extern "C" int proto_dma(const void* raw, long long n_raw, const void* starts, void* colsum, void* out, int n_tiles,
                         int heavy_rounds, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_raw < 0 || n_tiles < 0 || heavy_rounds < 0 || (reinterpret_cast<uintptr_t>(raw) & 15))
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const long long n_blocks = n_raw / BLOCK_WORDS, touches = 2ll * N_CHAINS * n_tiles;
  const bool by_starts = touches < n_blocks;  // sum only the blocks the chains touch
  const long long n_rows = by_starts ? touches : n_blocks;
  if (n_rows > 0) {
    colsum_kernel<<<(unsigned)((n_rows + COLSUM_BLOCKS - 1) / COLSUM_BLOCKS), COLSUM_THREADS, 0, s>>>(
        static_cast<const int4*>(raw), n_raw, by_starts ? static_cast<const int*>(starts) : nullptr, n_rows,
        static_cast<int4*>(colsum));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  tile_kernel<<<(unsigned)n_tiles, TILE_THREADS, 0, s>>>(static_cast<const unsigned*>(colsum), n_raw,
                                                         static_cast<const int*>(starts), static_cast<int*>(out),
                                                         heavy_rounds);
  return (int)cudaGetLastError();
}

extern "C" const char* pcodec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
