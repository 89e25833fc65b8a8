// E4b proto_round_loop: the tANS round skeleton of
// experiments/proto_round_loop.py on fake data.
//
// Replaces: experiments/proto_round_loop.py::make_round_kernel (:52, launched
// by bench :143), which holds 256 chains x 4 streams of a tile in (8, 128)
// vregs (chain (s, g) on lanes 4g..4g+3 of sublane s, stream j on lane
// 4g + j) and builds every step from lane gathers, rolls and selects.
//
// Per tile and round, for chain (s, g) with 4-word window W4 (words
// (w0 + k) & 127 of section row g*8 + s, w0 = cursor >> 5; words 0..3 at the
// start) and each stream j in order (int32, wrapping, shifts logical):
//   node = node_tab[s, state_j] (state_j & 127 when state_j is outside
//   [0, 1024)), bits = node & 15, base = node >> 11;
//   cum_j = cursor + bits of the streams before j;
//   b = cum_j - 32 w0, k = b >> 5, lo = W4[k], hi = W4[min(k + 1, 3)],
//   window = (hi:lo) >> (b & 31);
//   state_j = (base + (window & ((1 << bits) - 1))) & 1023;
// then the cursor grows by the 4 streams' bits and W4 is refilled at the new
// w0. Out: state + cursor (n_tiles, 8, 128); with emit, every round's states
// (n_tiles, rounds, 8, 128).
//
// What bounds it on Hopper: operations and their latency: each round of a
// chain is a shared-memory table load, a funnel shift and a global window
// load that depend on the round before; the section bytes (128 KB a tile)
// are read once.
//
// What the design does about it: one thread per chain with its 4 streams,
// their states, the cursor and W4 in registers (as K2 chain_decode does);
// the (8, 1024) node table in shared memory, loaded once per block; a block
// of 256 threads is one tile, thread s * 32 + g holding chain (s, g) so that
// the 16-byte state, emit and output stores of a warp are contiguous.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TS = 1024;
constexpr int SUBLANES = 8;
constexpr int TILE_CHAINS = 256;
constexpr int THREADS = TILE_CHAINS;

__device__ __forceinline__ unsigned pick(const unsigned (&w)[4], unsigned k) {
  return k == 0 ? w[0] : k == 1 ? w[1] : k == 2 ? w[2] : w[3];
}

__global__ void __launch_bounds__(THREADS) round_kernel(const unsigned* __restrict__ sec,
                                                       const int4* __restrict__ node,
                                                       const int4* __restrict__ state, int4* __restrict__ out,
                                                       int4* __restrict__ emit, int rounds) {
  __shared__ int4 s_node4[SUBLANES * TS / 4];
  for (int i = threadIdx.x; i < SUBLANES * TS / 4; i += THREADS) s_node4[i] = node[i];
  __syncthreads();
  const long long tile = blockIdx.x;
  const int s = threadIdx.x >> 5, g = threadIdx.x & 31;
  const unsigned* row = sec + (tile * TILE_CHAINS + g * SUBLANES + s) * 128;
  const unsigned* ntab = reinterpret_cast<const unsigned*>(s_node4) + s * TS;
  const long long o = (tile * SUBLANES + s) * 32 + g;  // int4 index of lanes 4g..4g+3
  const int4 st4 = state[o];
  unsigned st[4] = {(unsigned)st4.x, (unsigned)st4.y, (unsigned)st4.z, (unsigned)st4.w};
  unsigned w[4] = {row[0], row[1], row[2], row[3]};
  unsigned cursor = 0;
  for (int r = 0; r < rounds; ++r) {
    const unsigned w0 = cursor >> 5;
    unsigned cum = cursor;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned x = st[j];
      const unsigned nd = ntab[x < TS ? x : (x & 127)];
      const unsigned bits = nd & 15, base = nd >> 11;
      const unsigned b = cum - (w0 << 5);
      const unsigned k = b >> 5;
      const unsigned lo = pick(w, k), hi = pick(w, k + 1 < 3 ? k + 1 : 3);
      const unsigned window = __funnelshift_r(lo, hi, b & 31);
      st[j] = (base + (window & ((1u << bits) - 1))) & (TS - 1);
      cum += bits;
    }
    cursor = cum;
    if (emit) emit[(tile * rounds + r) * (SUBLANES * 32) + s * 32 + g] = make_int4(st[0], st[1], st[2], st[3]);
    const unsigned w0n = cursor >> 5;
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = row[(w0n + k) & 127];
  }
  out[o] = make_int4(st[0] + cursor, st[1] + cursor, st[2] + cursor, st[3] + cursor);
}

}  // namespace

// sec (n_tiles, 256, 128), node (8, 1024), state and out (n_tiles, 8, 128),
// emit (n_tiles, rounds, 8, 128) or null; all int32.
extern "C" int proto_round_loop(const void* sec, const void* node, const void* state, void* out, void* emit,
                                int n_tiles, int rounds, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles < 0 || rounds < 0) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  round_kernel<<<n_tiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(sec), static_cast<const int4*>(node), static_cast<const int4*>(state),
      static_cast<int4*>(out), static_cast<int4*>(emit), rounds);
  return (int)cudaGetLastError();
}

extern "C" const char* pcodec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
