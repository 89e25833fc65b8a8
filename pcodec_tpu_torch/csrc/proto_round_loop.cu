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
// What bounds it on Hopper: the section rows' traffic through L2, then the
// round's operations. Reloading W4 every round is four 4-byte loads a chain
// on the chain, each a 32-byte sector of its own (a warp's chains are rows
// 512 bytes apart), and 1,024 tiles' 128 MB of rows do not stay in the
// 50 MB L2; the function needs each touched word read once.
//
// What the design does about it: a thread holds two chains ((s, g) and
// (s + 4, g) of one tile), their states and cursors in registers, and each
// chain's row as a ring of three 16-byte quads, words [4a, 4a + 12) mod 128
// with a = cursor >> 7. A round moves the cursor at most 60 bits, so W4 =
// words w0 .. w0 + 3 lies in the first two quads, and the quad index
// advances at most one a round: then the ring shifts and one 16-byte load
// of quad a + 2 is issued, a quad ahead of its use and off the chain. A
// round picks W4 from the ring once, funnel-shifts it to the cursor as 96
// bits (A, B, C), and each stream takes its bits from A and shifts the 96
// bits on by them (W4 reaches 77 bits past the cursor at most). The four
// node lookups of a round depend only on the round before, so they issue
// together. A block of 256 threads holds two tiles that share one 32 KB copy
// of the (8, 1024) node table in shared memory, so four blocks (1,024
// threads at <= 64 registers) fit an SM and 1,024 tiles run in one wave.
// Warp w holds chains (w & 3, g) and (w & 3 + 4, g), g its lane, of tile
// w >> 2, so its 16-byte state, emit and output stores are contiguous; the
// emitted states, written once and read by no one here, are streamed
// (__stcs).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TS = 1024;
constexpr int SUBLANES = 8;
constexpr int TILE_CHAINS = 256;
constexpr int TILES_PER_BLOCK = 2;
constexpr int THREADS = TILES_PER_BLOCK * TILE_CHAINS / 2;  // two chains a thread
constexpr int ROW_QUADS = 32;  // a section row's 128 words

__global__ void __launch_bounds__(THREADS, 4) round_kernel(const uint4* __restrict__ sec,
                                                          const int4* __restrict__ node,
                                                          const int4* __restrict__ state, int4* __restrict__ out,
                                                          int4* __restrict__ emit, int n_tiles, int rounds) {
  __shared__ int4 s_node4[SUBLANES * TS / 4];
  for (int i = threadIdx.x; i < SUBLANES * TS / 4; i += THREADS) s_node4[i] = node[i];
  __syncthreads();
  const int w = threadIdx.x >> 5, g = threadIdx.x & 31;
  const long long tile = (long long)blockIdx.x * TILES_PER_BLOCK + (w >> 2);
  if (tile >= n_tiles) return;
  const unsigned* ntab[2];
  const uint4* row[2];
  long long o[2];
  unsigned st[2][4], cursor[2] = {0, 0}, a[2] = {0, 0};
  uint4 q0[2], q1[2], q2[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int s = (w & 3) + 4 * c;
    row[c] = sec + (tile * TILE_CHAINS + g * SUBLANES + s) * ROW_QUADS;
    ntab[c] = reinterpret_cast<const unsigned*>(s_node4) + s * TS;
    o[c] = (tile * SUBLANES + s) * 32 + g;  // int4 index of lanes 4g..4g+3
    const int4 st4 = state[o[c]];
    st[c][0] = st4.x, st[c][1] = st4.y, st[c][2] = st4.z, st[c][3] = st4.w;
    q0[c] = row[c][0], q1[c] = row[c][1], q2[c] = row[c][2];
    if (rounds > 0) {  // only the first round's lookups see a state outside the table
#pragma unroll
      for (int j = 0; j < 4; ++j) st[c][j] = st[c][j] < TS ? st[c][j] : st[c][j] & 127;
    }
  }
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      // W4 = ring words sh .. sh + 3, picked by sh's two bits
      const unsigned sh = (cursor[c] >> 5) - (a[c] << 2);
      const bool s2 = sh & 2, s1 = sh & 1;
      const unsigned x0 = s2 ? q0[c].z : q0[c].x, x1 = s2 ? q0[c].w : q0[c].y, x2 = s2 ? q1[c].x : q0[c].z,
                     x3 = s2 ? q1[c].y : q0[c].w, x4 = s2 ? q1[c].z : q1[c].x;
      const unsigned W0 = s1 ? x1 : x0, W1 = s1 ? x2 : x1, W2 = s1 ? x3 : x2, W3 = s1 ? x4 : x3;
      const unsigned f = cursor[c] & 31;
      unsigned A = __funnelshift_r(W0, W1, f), B = __funnelshift_r(W1, W2, f), C = __funnelshift_r(W2, W3, f);
      unsigned nd[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) nd[j] = ntab[c][st[c][j]];
      unsigned used = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned bits = nd[j] & 15;
        st[c][j] = ((nd[j] >> 11) + (A & ((1u << bits) - 1))) & (TS - 1);
        used += bits;
        if (j < 3) A = __funnelshift_r(A, B, bits);
        if (j < 2) {
          B = __funnelshift_r(B, C, bits);
          C >>= bits;
        }
      }
      cursor[c] += used;
      if (emit)
        __stcs(emit + (tile * rounds + r) * (SUBLANES * 32) + (o[c] & (SUBLANES * 32 - 1)),
               make_int4(st[c][0], st[c][1], st[c][2], st[c][3]));
      const unsigned an = cursor[c] >> 7;
      if (an != a[c]) {  // the ring moves one quad on
        q0[c] = q1[c];
        q1[c] = q2[c];
        q2[c] = row[c][(an + 2) & (ROW_QUADS - 1)];
        a[c] = an;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 2; ++c)
    out[o[c]] = make_int4(st[c][0] + cursor[c], st[c][1] + cursor[c], st[c][2] + cursor[c], st[c][3] + cursor[c]);
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
  round_kernel<<<(n_tiles + TILES_PER_BLOCK - 1) / TILES_PER_BLOCK, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(sec), static_cast<const int4*>(node), static_cast<const int4*>(state),
      static_cast<int4*>(out), static_cast<int4*>(emit), n_tiles, rounds);
  return (int)cudaGetLastError();
}

extern "C" const char* pcodec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
