// K5 bin_ans_encode: bin search, reverse interleaved tANS and offsets of
// PCT encode chains.
//
// Replaces: pcodec_tpu/ops/pallas_encode.py::_eb_impl (launched by _eb_call),
// the TPU kernel that walks 256 chains per (8, 128) tile with select-tree
// table gathers and u64 compares done as u32 pairs.
//
// What bounds it on Hopper: bytes. Per symbol the function reads an 8-byte
// latent and writes a 4-byte p1 word and an offset (8 bytes here, where
// the bound counts 4 when no bin has over 32 offset bits: a floor of 1.25x
// the bound); the work per symbol (a binary search over at most 2^14 bins
// and one tANS step) is small beside that. Only the tANS state is serial,
// and only within one of a chain's 4 streams: the bin search and the
// offset depend on the latent alone. The earlier design (one thread a
// chain doing all of it) was bound by memory instructions instead: each
// round made five 16-byte accesses at an 8 KB stride between lanes, and
// each symbol's 8-step search sat on the chain's serial path.
//
// What the design does about it: a block of 16 chains (an eighth of the
// 128 that share one table; the plan pads each table's chains to 128)
// holds the table in dynamic shared memory when it fits (lowers as u64, t1
// and t2 as i32, nexts as u32) and walks tiles of 8 rounds (32 symbols a
// chain) from the last to the first in two steps:
//   search  a warp a chain at a time, a lane a symbol: a coalesced latent
//           load (prefetched a tile ahead, during the walk), the binary
//           search, a coalesced offset store, the bin index into shared
//           memory, and the previous tile's p1 words out of shared memory
//           to device memory in one coalesced store a chain;
//   walk    a thread a (chain, stream) steps its state back through the
//           tile's 8 symbols of its stream and writes each p1 word to
//           shared memory.
// The largest legal table (2^14 states and 2^14 bins, 320 KB) does not fit
// shared memory; then the kernel reads the table from global memory, the
// tiles still in shared memory. The route is chosen by the table's size.
//
// Per symbol k = 4r + j of stream j (r from the last round down to 0):
//   sym    = the last bin with lower <= latent (bin 0 if none); bins are
//            padded to a power of two with copies of the last bin
//   renorm = (t1 & 15) + (state >= t1 >> 11)
//   val    = state & ((1 << renorm) - 1)
//   state  = nexts[t2[sym] + (state >> renorm)], the index held to the table
//   p1     = val | renorm << 15 | ob << 19,  offset = latent - lower[sym]
// Symbols at k >= body_n give zeros and leave the state as it is.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CHAINS_PER_GROUP = 128;  // chains that share one table
constexpr int BLOCK_CHAINS = 16;  // blocks of 32 chains: 3% slower at the main path (PERF.md)
constexpr int THREADS = 4 * BLOCK_CHAINS;  // a thread a (chain, stream) in the walk
constexpr int WARPS = THREADS / 32;
constexpr int WARP_CHAINS = BLOCK_CHAINS / WARPS;  // chains a warp takes in the search
constexpr int TILE_ROUNDS = 8;
constexpr int TILE = 4 * TILE_ROUNDS;  // symbols a chain a tile: one a lane in the search
constexpr int ROW = TILE + 4;          // entries a chain row of the tiles: no bank conflicts

size_t table_bytes(int ts, int b_pad) {
  return (size_t)b_pad * (sizeof(unsigned long long) + 2 * sizeof(int)) + (size_t)ts * sizeof(uint32_t);
}

constexpr size_t TILE_BYTES = (size_t)BLOCK_CHAINS * (ROW * (sizeof(int) + sizeof(unsigned short)) + sizeof(int));

template <bool SMEM>
__global__ void __launch_bounds__(THREADS) bin_ans_encode_kernel(
    const unsigned long long* __restrict__ latents, int page_n, const long long* __restrict__ body_n,
    const long long* __restrict__ table_id, const long long* __restrict__ states0,
    const uint32_t* __restrict__ g_nexts, int ts, const unsigned long long* __restrict__ g_lowers,
    const int* __restrict__ g_t1, const int* __restrict__ g_t2, int b_pad, int* __restrict__ p1,
    unsigned long long* __restrict__ offsets, long long* __restrict__ states) {
  extern __shared__ unsigned long long smem[];
  const int tb_pad = SMEM ? b_pad : 0;
  unsigned long long* s_lowers = smem;
  int* s_t1 = reinterpret_cast<int*>(s_lowers + tb_pad);
  int* s_t2 = s_t1 + tb_pad;
  uint32_t* s_nexts = reinterpret_cast<uint32_t*>(s_t2 + tb_pad);
  int* s_p1 = reinterpret_cast<int*>(s_nexts + (SMEM ? ts : 0));
  int* s_bn = s_p1 + BLOCK_CHAINS * ROW;
  unsigned short* s_sym = reinterpret_cast<unsigned short*>(s_bn + BLOCK_CHAINS);

  const long long c0 = (long long)blockIdx.x * BLOCK_CHAINS;
  const long long tid = table_id[c0];
  g_nexts += tid * ts;
  g_lowers += tid * b_pad;
  g_t1 += tid * b_pad;
  g_t2 += tid * b_pad;
  if (SMEM) {
    for (int i = threadIdx.x; i < b_pad; i += THREADS) {
      s_lowers[i] = g_lowers[i];
      s_t1[i] = g_t1[i];
      s_t2[i] = g_t2[i];
    }
    for (int i = threadIdx.x; i < ts; i += THREADS) s_nexts[i] = g_nexts[i];
  }
  const unsigned long long* lowers = SMEM ? s_lowers : g_lowers;
  const int* t1 = SMEM ? s_t1 : g_t1;
  const int* t2 = SMEM ? s_t2 : g_t2;
  const uint32_t* nexts = SMEM ? s_nexts : g_nexts;
  if (threadIdx.x < BLOCK_CHAINS) {
    const long long bn = body_n[c0 + threadIdx.x];
    s_bn[threadIdx.x] = bn < 0 ? 0 : (int)(bn < page_n ? bn : page_n);
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_tiles = page_n / TILE;
  // the search step's latents, a tile ahead: chain warp * WARP_CHAINS + i, symbol lane
  const unsigned long long* lat = latents + (c0 + warp * WARP_CHAINS) * page_n + lane;
  unsigned long long lv[WARP_CHAINS];
#pragma unroll
  for (int i = 0; i < WARP_CHAINS; ++i) lv[i] = lat[(long long)i * page_n + (n_tiles - 1) * TILE];
  // the walk's stream: chain cw, stream j
  const int cw = threadIdx.x >> 2, j = threadIdx.x & 3;
  uint32_t st = (uint32_t)states0[c0 + cw];
  __syncthreads();  // the table and s_bn are in

  for (int t = n_tiles - 1; t >= 0; --t) {
    const int kt = t * TILE;
#pragma unroll
    for (int i = 0; i < WARP_CHAINS; ++i) {
      const int cl = warp * WARP_CHAINS + i;
      const long long at = (c0 + cl) * page_n + kt + lane;
      const unsigned long long l = lv[i];
      int sym = 0;
      for (int step = b_pad >> 1; step; step >>= 1)
        if (lowers[sym + step] <= l) sym += step;
      offsets[at] = kt + lane < s_bn[cl] ? l - lowers[sym] : 0ull;
      s_sym[cl * ROW + lane] = (unsigned short)sym;
      if (t + 1 < n_tiles) p1[at + TILE] = s_p1[cl * ROW + lane];
    }
    if (t > 0) {
#pragma unroll
      for (int i = 0; i < WARP_CHAINS; ++i) lv[i] = lat[(long long)i * page_n + kt - TILE];
    }
    __syncthreads();

    const int bn = s_bn[cw];
#pragma unroll
    for (int r = TILE_ROUNDS - 1; r >= 0; --r) {
      const int m = 4 * r + j;
      const int sym = s_sym[cw * ROW + m];
      const int a = t1[sym];
      const int renorm = (a & 15) + (st >= (uint32_t)(a >> 11) ? 1 : 0);
      const uint32_t val = st & ((1u << renorm) - 1u);
      int idx = t2[sym] + (int)(st >> renorm);
      idx = idx < 0 ? 0 : (idx > ts - 1 ? ts - 1 : idx);
      const uint32_t nx = nexts[idx];
      const bool valid = kt + m < bn;
      s_p1[cw * ROW + m] = valid ? (int)val | (renorm << 15) | (((a >> 4) & 127) << 19) : 0;
      if (valid) st = nx;
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < WARP_CHAINS; ++i) {
    const int cl = warp * WARP_CHAINS + i;
    p1[(c0 + cl) * page_n + lane] = s_p1[cl * ROW + lane];
  }
  states[(c0 + cw) * 4 + j] = st;
}

}  // namespace

extern "C" int bin_ans_encode(const void* latents, int page_n, const void* body_n,
                              const void* table_id, const void* states0, const void* nexts, int ts,
                              const void* lowers, const void* t1, const void* t2, int b_pad,
                              void* p1, void* offsets, void* states, int n_chains, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_chains % CHAINS_PER_GROUP || page_n < TILE || page_n % TILE || ts < 1 || b_pad < 1 ||
      b_pad > 65536 || (b_pad & (b_pad - 1)))
    return (int)cudaErrorInvalidValue;
  if (n_chains == 0) return 0;
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = table_bytes(ts, b_pad) + TILE_BYTES;
  auto s = static_cast<cudaStream_t>(stream);
  auto a0 = static_cast<const unsigned long long*>(latents);
  auto a2 = static_cast<const long long*>(body_n);
  auto a3 = static_cast<const long long*>(table_id);
  auto a4 = static_cast<const long long*>(states0);
  auto a5 = static_cast<const uint32_t*>(nexts);
  auto a7 = static_cast<const unsigned long long*>(lowers);
  auto a8 = static_cast<const int*>(t1);
  auto a9 = static_cast<const int*>(t2);
  auto a11 = static_cast<int*>(p1);
  auto a12 = static_cast<unsigned long long*>(offsets);
  auto a13 = static_cast<long long*>(states);
  const int blocks = n_chains / BLOCK_CHAINS;
  if (smem <= (size_t)max_smem) {
    err = cudaFuncSetAttribute(bin_ans_encode_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    bin_ans_encode_kernel<true><<<blocks, THREADS, smem, s>>>(
        a0, page_n, a2, a3, a4, a5, ts, a7, a8, a9, b_pad, a11, a12, a13);
  } else {
    bin_ans_encode_kernel<false><<<blocks, THREADS, TILE_BYTES, s>>>(
        a0, page_n, a2, a3, a4, a5, ts, a7, a8, a9, b_pad, a11, a12, a13);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* pcodec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
