// E3a-c and E4a micro_gather: dependent table lookups by four routes; the
// microbenchmark of experiments/micro_gather.py and the one-gather check of
// experiments/proto_round_loop.py.
//
// Replaces:
//   route 0, take: micro_gather.py::pallas_take_kernel (:109, via pallas_take
//     :120), jnp.take from a flat VMEM table;
//   route 1, taa:  micro_gather.py::pallas_taa_kernel (:137, via pallas_taa
//     :146), take_along_axis from per-row VMEM tables;
//   route 2, lane: micro_gather.py::pallas_lane_kernel (:171, via pallas_lane
//     :180), lane gathers from an (8, 128) table held in vregs;
//   route 3, row:  proto_round_loop.py::taa_kernel (:26), one
//     take_along_axis(tbl, idx, axis=1).
//
// Functions (int32, wrapping):
//   routes 0, 1: `steps` rounds of idx <- (idx + table[row * ts + idx]) & (ts - 1)
//     on idx (rows, 4), table (rows, ts), ts a power of two; routes 0 and 1
//     compute the same function;
//   route 2: `steps` rounds of idx <- idx + tbl[r, idx & 127] on (rows, 128),
//     computed in ceil(log2(steps + 1)) rounds of pointer doubling;
//   route 3: out[r, l] = tbl[r, idx[r, l]] on (rows, width).
// A first index outside its table traps (routes 0, 1, 3).
//
// What bounds routes 0, 1 and 3 on Hopper: the latency of one dependent load
// a round. Each chain does `steps` loads in sequence, each address known only
// when the previous load returns; the table's bytes (8 MiB at the
// experiment's shape) and the few operations a round are far below what that
// costs. What the design does about it: one thread per dependent chain, so
// the card holds as many chains in flight as there are (8,192 at the
// experiment's shape), and each route puts the table where its name says:
// route 0 reads device memory through the read-only path, where the table
// stays in L2; route 1 stages each block's rows (8 of 4 KB) in shared memory
// first; route 3 is one load a thread.
//
// Route 2 computes its function by pointer doubling, not by `steps` serial
// lookups. The low 7 bits of x move on their own ((x + v) & 127 depends only
// on x & 127), so S_k[s], the wrapped sum of the 2^k values added from
// residue s, takes 2^k steps at once: S_0 = tbl[r], S_{k+1}[s] = S_k[s] +
// S_k[(s + S_k[s]) & 127], and for each set bit k of `steps` every chain
// takes x += S_k[x & 127] (jumps that are powers of one map commute). That
// is ceil(log2(steps + 1)) rounds, 13 at the experiment's 6,144 steps and 31
// at most, where a step loop takes 6,144 dependent lookups.
// What bounds it now: the rounds' dependent shuffles (8 lookups a lane a
// round, 4 for its chains and 4 for its S entries, each 4 __shfl_sync and a
// select, Hopper's counterpart of the TPU's lane gather) and, past them, the
// launch itself. A row is still one warp with S and its chains in
// registers, 4 a lane; a block is one warp, so the rows spread over the SMs.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xFFFFFFFFu;

__global__ void __launch_bounds__(THREADS) take_kernel(const int* __restrict__ table, const int* __restrict__ idx0,
                                                      int* __restrict__ out, int rows, int ts, int steps) {
  const long long c = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (c >= (long long)rows * 4) return;
  const int* tab = table + (c >> 2) * ts;
  const unsigned mask = (unsigned)ts - 1;
  unsigned idx = (unsigned)idx0[c];
  if (idx >= (unsigned)ts) __trap();
  for (int s = 0; s < steps; ++s) idx = (idx + (unsigned)__ldg(tab + idx)) & mask;
  out[c] = (int)idx;
}

__global__ void taa_kernel(const int* __restrict__ table, const int* __restrict__ idx0, int* __restrict__ out,
                           int rows, int ts, int steps, int rows_per_block) {
  extern __shared__ int4 s_tab4[];
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const int n = (int)(rows - row0 < rows_per_block ? rows - row0 : rows_per_block);
  const int4* src = reinterpret_cast<const int4*>(table + row0 * ts);
  for (int i = threadIdx.x; i < n * (ts >> 2); i += blockDim.x) s_tab4[i] = src[i];
  __syncthreads();
  const int c = threadIdx.x;
  if (c >= n * 4) return;
  const unsigned* tab = reinterpret_cast<const unsigned*>(s_tab4) + (c >> 2) * ts;
  const unsigned mask = (unsigned)ts - 1;
  unsigned idx = (unsigned)idx0[row0 * 4 + c];
  if (idx >= (unsigned)ts) __trap();
  for (int s = 0; s < steps; ++s) idx = (idx + tab[idx]) & mask;
  out[row0 * 4 + c] = (int)idx;
}

// tbl[r, x & 127] from the row's entries held 4 a lane (entry e in register
// e >> 5 of lane e & 31).
__device__ __forceinline__ unsigned lane_take(unsigned t0, unsigned t1, unsigned t2, unsigned t3, unsigned x) {
  const int src = (int)(x & 31);
  const unsigned q = (x >> 5) & 3;
  const unsigned v0 = __shfl_sync(FULL, t0, src), v1 = __shfl_sync(FULL, t1, src);
  const unsigned v2 = __shfl_sync(FULL, t2, src), v3 = __shfl_sync(FULL, t3, src);
  return q == 0 ? v0 : q == 1 ? v1 : q == 2 ? v2 : v3;
}

// One warp a row, a block a warp: S_k and the row's 128 chains in registers,
// entry e in register e >> 5 of lane e & 31.
__global__ void __launch_bounds__(32) lane_kernel(const int* __restrict__ tbl, const int* __restrict__ idx,
                                                 int* __restrict__ out, int steps) {
  const long long row = blockIdx.x;
  const unsigned lane = threadIdx.x;
  const unsigned* t = reinterpret_cast<const unsigned*>(tbl) + row * 128;
  const unsigned* x = reinterpret_cast<const unsigned*>(idx) + row * 128;
  unsigned s0 = t[lane], s1 = t[lane + 32], s2 = t[lane + 64], s3 = t[lane + 96];
  unsigned x0 = x[lane], x1 = x[lane + 32], x2 = x[lane + 64], x3 = x[lane + 96];
  for (unsigned k = (unsigned)steps; k != 0;) {
    if (k & 1) {  // the 2^round steps of S_round
      x0 += lane_take(s0, s1, s2, s3, x0);
      x1 += lane_take(s0, s1, s2, s3, x1);
      x2 += lane_take(s0, s1, s2, s3, x2);
      x3 += lane_take(s0, s1, s2, s3, x3);
    }
    k >>= 1;
    if (k != 0) {  // S_{round + 1}[s] = S[s] + S[(s + S[s]) & 127]
      const unsigned n0 = s0 + lane_take(s0, s1, s2, s3, lane + s0);
      const unsigned n1 = s1 + lane_take(s0, s1, s2, s3, lane + 32 + s1);
      const unsigned n2 = s2 + lane_take(s0, s1, s2, s3, lane + 64 + s2);
      const unsigned n3 = s3 + lane_take(s0, s1, s2, s3, lane + 96 + s3);
      s0 = n0;
      s1 = n1;
      s2 = n2;
      s3 = n3;
    }
  }
  int* o = out + row * 128;
  o[lane] = (int)x0;
  o[lane + 32] = (int)x1;
  o[lane + 64] = (int)x2;
  o[lane + 96] = (int)x3;
}

__global__ void __launch_bounds__(THREADS) row_kernel(const int* __restrict__ tbl, const int* __restrict__ idx,
                                                     int* __restrict__ out, long long n, int width) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const unsigned x = (unsigned)idx[i];
  if (x >= (unsigned)width) __trap();
  out[i] = tbl[i - i % width + x];
}

}  // namespace

// route 0/1: table (rows, width = ts), idx and out (rows, 4); route 2: table,
// idx and out (rows, 128), width 128; route 3: (rows, width), steps unused.
extern "C" int micro_gather(int route, const void* table, const void* idx, void* out, int rows, int width, int steps,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows < 0 || width < 1 || steps < 0 || route < 0 || route > 3) return (int)cudaErrorInvalidValue;
  if (route <= 1 && (width < 4 || (width & (width - 1)))) return (int)cudaErrorInvalidValue;
  if (route == 2 && width != 128) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto tb = static_cast<const int*>(table);
  auto ix = static_cast<const int*>(idx);
  auto o = static_cast<int*>(out);
  if (route == 0) {
    take_kernel<<<(unsigned)(((long long)rows * 4 + THREADS - 1) / THREADS), THREADS, 0, s>>>(tb, ix, o, rows, width,
                                                                                             steps);
  } else if (route == 1) {
    if (reinterpret_cast<uintptr_t>(table) & 15) return (int)cudaErrorInvalidValue;
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return (int)err;
    const long long row_bytes = (long long)width * 4;
    if (row_bytes > optin) return (int)cudaErrorInvalidValue;
    int rpb = (int)(optin / row_bytes);
    rpb = rpb > 8 ? 8 : rpb;
    const int smem = (int)(rpb * row_bytes);
    err = cudaFuncSetAttribute(taa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    taa_kernel<<<(unsigned)((rows + rpb - 1) / rpb), rpb * 4 < 32 ? 32 : rpb * 4, smem, s>>>(tb, ix, o, rows, width,
                                                                                           steps, rpb);
  } else if (route == 2) {
    lane_kernel<<<(unsigned)rows, 32, 0, s>>>(tb, ix, o, steps);
  } else {
    const long long n = (long long)rows * width;
    row_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, s>>>(tb, ix, o, n, width);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* pcodec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
