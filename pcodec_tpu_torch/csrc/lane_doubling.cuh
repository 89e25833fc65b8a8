// Pointer doubling over rows of 128 residues, a warp a row: `steps` steps of
// x <- x + tbl[r, x & 127] for each of the row's 128 chains, in
// ceil(log2(steps + 1)) rounds. Included by micro_gather.cu (route lane, E3c)
// and proto_dma.cu (E1's rounds, which are that function with tbl = idx =
// the tile's sums).
//
// The low 7 bits of x move on their own ((x + v) & 127 depends only on
// x & 127), so S_k[s], the wrapped sum of the 2^k values added from residue
// s, takes 2^k steps at once: S_0 = tbl[r], S_{k+1}[s] = S_k[s] +
// S_k[(s + S_k[s]) & 127], and for each set bit k of `steps` every chain
// takes x += S_k[x & 127] (jumps that are powers of one map commute). S and
// the chains live in registers, entry e in register e >> 5 of lane e & 31,
// and a lookup is 4 __shfl_sync and a select.
#pragma once

#include <cstdint>

namespace {

constexpr unsigned LANES_FULL = 0xFFFFFFFFu;

// tbl[r, x & 127] from the row's entries held 4 a lane.
__device__ __forceinline__ unsigned lane_take(const unsigned (&t)[4], unsigned x) {
  const int src = (int)(x & 31);
  const unsigned q = (x >> 5) & 3;
  const unsigned v0 = __shfl_sync(LANES_FULL, t[0], src), v1 = __shfl_sync(LANES_FULL, t[1], src);
  const unsigned v2 = __shfl_sync(LANES_FULL, t[2], src), v3 = __shfl_sync(LANES_FULL, t[3], src);
  return q == 0 ? v0 : q == 1 ? v1 : q == 2 ? v2 : v3;
}

// `steps` steps of the row's chains x from the row's table s (S_0), both 4 a
// lane; s is spent.
__device__ __forceinline__ void lane_steps_doubling(unsigned (&s)[4], unsigned (&x)[4], unsigned steps,
                                                    unsigned lane) {
  for (unsigned k = steps; k != 0;) {
    if (k & 1) {  // the 2^round steps of S_round
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] += lane_take(s, x[j]);
    }
    k >>= 1;
    if (k != 0) {  // S_{round + 1}[s] = S[s] + S[(s + S[s]) & 127]
      unsigned n[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) n[j] = s[j] + lane_take(s, lane + 32 * j + s[j]);
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] = n[j];
    }
  }
}

}  // namespace
