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
// What bounds routes 0 and 1 on Hopper: the latency of one dependent load
// a round. Each chain does `steps` loads in sequence, each address known only
// when the previous load returns; the table's bytes (8 MiB at the
// experiment's shape) and the few operations a round are far below what that
// costs. What the design does about it: one thread per dependent chain, so
// the card holds as many chains in flight as there are (8,192 at the
// experiment's shape), and every load a step makes is one from shared
// memory (~22 ns a step measured) rather than one through the cache
// hierarchy (~70 ns a step from L2). A row must be on chip before its
// chains' first step, so the staging copy and the launch are the rest of a
// call. The two routes stage in the card's two asynchronous forms. Route 0
// stages each block's rows (TAKE_ROWS of them, 4 of 4 KB at the
// experiment's shape, so its 2,048 rows make 512 blocks, about 4 an SM; 8
// and 16 rows a block measured 2-3% slower) by one 1D bulk copy
// (cp.async.bulk) a row, each completing on that row's mbarrier; each warp
// waits only for its own rows, so its walk starts as soon as they land. (A
// wait a chain splits the warp: its lanes leave the wait at different
// times and walk in turns.) A row larger than a block's shared memory (from
// 2^16 entries) keeps the walk through the read-only path, with the table
// in L2 or device memory (`micro_gather_take_rows` says which route a width
// takes). Route 1 has no block barrier either: each warp stages its own row
// (TAA_WARPS warps a block, fewer where their rows do not fit the block's
// shared memory) by 16-byte cp.async copies, every lane's in one commit
// group, so 2,048 rows' copies are in flight at once (~62 KB an SM); its
// lanes wait on their own copies (cp.async.wait_group 0) and meet at
// __syncwarp, all together, and then lanes 0-3 walk. Its chains' first
// indices are loaded before the copies are issued. Route 1 refuses a row
// larger than a block's shared memory.
//
// Route 3 is one gather, so what bounds it is the launch and one global
// round trip: its bytes (8 KB at the check's (8, 128)) are nothing. Rows of
// up to ROW_LANE_MAX words are a warp a row, 4 words a lane in registers as
// route lane holds its table: each lane issues the loads of its words and
// of its indices together, before it uses either, and gathers on chip by
// lane_take (4 __shfl_sync and a select), so no load waits on another.
// Wider rows are a thread an element, the index loaded before the word it
// names.
//
// Route 2 computes its function by pointer doubling (lane_doubling.cuh), not
// by `steps` serial lookups: ceil(log2(steps + 1)) rounds, 13 at the
// experiment's 6,144 steps and 31 at most, where a step loop takes 6,144
// dependent lookups.
// What bounds it now: the rounds' dependent shuffles (8 lookups a lane a
// round, 4 for its chains and 4 for its S entries, each 4 __shfl_sync and a
// select, Hopper's counterpart of the TPU's lane gather) and, past them, the
// launch itself. A row is still one warp with S and its chains in
// registers, 4 a lane; a block is one warp, so the rows spread over the SMs.
#include <cstdint>
#include <cuda_runtime.h>

#include "lane_doubling.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TAKE_ROWS = 4;         // rows a block of route take stages at most
constexpr int TAKE_BAR_BYTES = 128;  // the rows' mbarriers (room for 16), ahead of the rows in shared memory
constexpr int TAA_WARPS = 4;         // warps (a row each) a block of route taa at most
constexpr int ROW_WARPS = 4;         // rows (a warp each) a block of route row's register form
constexpr int ROW_LANE_MAX = 128;    // widest row route row holds in registers, 4 words a lane

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

// One 16-byte copy from device memory into shared memory, not through L1.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

// The calling thread's cp.async copies committed as one group and waited on.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_fetch(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// Route 0: a block's rows_per_block rows bulk-copied into shared memory, a
// row on its own mbarrier; a thread a chain walks its row once its warp's
// rows have landed.
__global__ void take_kernel(const int* __restrict__ table, const int* __restrict__ idx0, int* __restrict__ out,
                            int rows, int ts, int steps, int rows_per_block) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const unsigned* tab = reinterpret_cast<const unsigned*>(smem + TAKE_BAR_BYTES);
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const int n = (int)(rows - row0 < rows_per_block ? rows - row0 : rows_per_block);
  const unsigned row_bytes = (unsigned)ts * 4;
  if (threadIdx.x == 0) {
    for (int r = 0; r < n; ++r) mbar_init(&bar[r], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int r = 0; r < n; ++r) {
      mbar_expect_tx(&bar[r], row_bytes);
      bulk_fetch(smem + TAKE_BAR_BYTES + (size_t)r * row_bytes, table + (row0 + r) * ts, row_bytes, &bar[r]);
    }
  }
  // A warp waits for its own rows (8 at most), all lanes alike: lanes
  // waiting on different barriers would leave the wait apart and walk in
  // turns.
  const int w0 = (threadIdx.x >> 5) * 8, w1 = w0 + 8 < n ? w0 + 8 : n;
  for (int r = w0; r < w1; ++r) mbar_wait(&bar[r], 0);
  const int c = threadIdx.x;
  if (c >= n * 4) return;
  const unsigned mask = (unsigned)ts - 1;
  unsigned idx = (unsigned)idx0[row0 * 4 + c];
  if (idx >= (unsigned)ts) __trap();
  const unsigned* row = tab + (size_t)(c >> 2) * ts;
  for (int s = 0; s < steps; ++s) idx = (idx + row[idx]) & mask;
  out[row0 * 4 + c] = (int)idx;
}

// Route 0 for rows larger than a block's shared memory: the walk through the
// read-only path.
__global__ void __launch_bounds__(THREADS) take_global_kernel(const int* __restrict__ table,
                                                             const int* __restrict__ idx0, int* __restrict__ out,
                                                             int rows, int ts, int steps) {
  const long long c = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (c >= (long long)rows * 4) return;
  const int* tab = table + (c >> 2) * ts;
  const unsigned mask = (unsigned)ts - 1;
  unsigned idx = (unsigned)idx0[c];
  if (idx >= (unsigned)ts) __trap();
  for (int s = 0; s < steps; ++s) idx = (idx + (unsigned)__ldg(tab + idx)) & mask;
  out[c] = (int)idx;
}

// Route 1: a warp a row. Each warp stages its row by 16-byte cp.async
// copies, waits on them with all its lanes and meets them at __syncwarp; no
// block barrier. Lanes 0-3 then walk the row's four chains.
__global__ void taa_kernel(const int* __restrict__ table, const int* __restrict__ idx0, int* __restrict__ out,
                           int rows, int ts, int steps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= rows) return;  // the whole warp
  const bool walks = lane < 4;
  unsigned idx = walks ? (unsigned)idx0[row * 4 + lane] : 0u;
  int4* mine = reinterpret_cast<int4*>(smem) + (size_t)warp * (ts >> 2);
  const int4* src = reinterpret_cast<const int4*>(table + row * ts);
  for (int i = lane; i < (ts >> 2); i += 32) cp_async16(mine + i, src + i);
  cp_async_wait_all();
  __syncwarp();
  if (!walks) return;
  if (idx >= (unsigned)ts) __trap();
  const unsigned* tab = reinterpret_cast<const unsigned*>(mine);
  const unsigned mask = (unsigned)ts - 1;
  for (int s = 0; s < steps; ++s) idx = (idx + tab[idx]) & mask;
  out[row * 4 + lane] = (int)idx;
}

// One warp a row, a block a warp: S_k and the row's 128 chains in registers,
// entry e in register e >> 5 of lane e & 31.
__global__ void __launch_bounds__(32) lane_kernel(const int* __restrict__ tbl, const int* __restrict__ idx,
                                                 int* __restrict__ out, int steps) {
  const long long row = blockIdx.x;
  const unsigned lane = threadIdx.x;
  const unsigned* t = reinterpret_cast<const unsigned*>(tbl) + row * 128;
  const unsigned* x0 = reinterpret_cast<const unsigned*>(idx) + row * 128;
  unsigned s[4], x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s[j] = t[lane + 32 * j];
    x[j] = x0[lane + 32 * j];
  }
  lane_steps_doubling(s, x, (unsigned)steps, lane);
  int* o = out + row * 128;
#pragma unroll
  for (int j = 0; j < 4; ++j) o[lane + 32 * j] = (int)x[j];
}

// Route 3, rows of up to ROW_LANE_MAX words: a warp a row, ROW_WARPS a block.
// Each lane loads its 4 words of the row and its 4 indices together (entry
// e in register e >> 5 of lane e & 31, words past `width` masked), then
// gathers them from the warp's registers.
__global__ void __launch_bounds__(32 * ROW_WARPS) row_lane_kernel(const int* __restrict__ tbl,
                                                                 const int* __restrict__ idx,
                                                                 int* __restrict__ out, int rows, int width) {
  const long long row = (long long)blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp
  const unsigned lane = threadIdx.x & 31;
  const unsigned* t = reinterpret_cast<const unsigned*>(tbl) + row * width;
  const unsigned* x0 = reinterpret_cast<const unsigned*>(idx) + row * width;
  unsigned w[4], x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned e = lane + 32 * j;
    w[j] = e < (unsigned)width ? t[e] : 0u;
    x[j] = e < (unsigned)width ? x0[e] : 0u;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (x[j] >= (unsigned)width) __trap();
  int* o = out + row * width;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned v = lane_take(w, x[j]);
    if (lane + 32 * j < (unsigned)width) o[lane + 32 * j] = (int)v;
  }
}

// Route 3, wider rows: a thread an element, the word loaded once its index
// is in.
__global__ void __launch_bounds__(THREADS) row_kernel(const int* __restrict__ tbl, const int* __restrict__ idx,
                                                     int* __restrict__ out, long long n, int width) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const unsigned x = (unsigned)idx[i];
  if (x >= (unsigned)width) __trap();
  out[i] = tbl[i - i % width + x];
}

// Rows a block of route 0 stages in shared memory at table width ts on
// `device`: TAKE_ROWS, fewer where they do not fit the block's opt-in
// shared memory, 0 where one row does not (the read-only-path walk).
cudaError_t take_rows(int ts, int device, int* rows_per_block) {
  int optin = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const long long fit = (optin - TAKE_BAR_BYTES) / ((long long)ts * 4);
  *rows_per_block = (int)(fit < TAKE_ROWS ? fit : TAKE_ROWS);
  return cudaSuccess;
}

}  // namespace

// Rows a block of route take stages in shared memory at table width ts (a
// power of two, at least 4), or 0 for the read-only-path route; a negative
// CUDA error on failure.
extern "C" int micro_gather_take_rows(int ts, int device) {
  int rpb = 0;
  const cudaError_t err = take_rows(ts, device, &rpb);
  return err != cudaSuccess ? -(int)err : rpb;
}

// route 0/1: table (rows, width = ts), idx and out (rows, 4), the table
// 16-byte aligned where its rows are staged in shared memory (route 1
// always); route 2: table, idx and out (rows, 128), width 128; route 3:
// (rows, width), steps unused.
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
    int rpb = 0;
    err = take_rows(width, device, &rpb);
    if (err != cudaSuccess) return (int)err;
    if (rpb == 0) {
      take_global_kernel<<<(unsigned)(((long long)rows * 4 + THREADS - 1) / THREADS), THREADS, 0, s>>>(
          tb, ix, o, rows, width, steps);
    } else {
      if (reinterpret_cast<uintptr_t>(table) & 15) return (int)cudaErrorInvalidValue;
      const int smem = TAKE_BAR_BYTES + rpb * width * 4;
      err = cudaFuncSetAttribute(take_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      const int threads = (rpb * 4 + 31) & ~31;
      take_kernel<<<(unsigned)((rows + rpb - 1) / rpb), threads, smem, s>>>(tb, ix, o, rows, width, steps, rpb);
    }
  } else if (route == 1) {
    if (reinterpret_cast<uintptr_t>(table) & 15) return (int)cudaErrorInvalidValue;
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return (int)err;
    const long long row_bytes = (long long)width * 4;
    if (row_bytes > optin) return (int)cudaErrorInvalidValue;
    const int fit = (int)(optin / row_bytes);  // rows a block's shared memory holds
    const int warps = fit < TAA_WARPS ? fit : TAA_WARPS;
    const int smem = (int)(warps * row_bytes);
    err = cudaFuncSetAttribute(taa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    taa_kernel<<<(unsigned)((rows + warps - 1) / warps), 32 * warps, smem, s>>>(tb, ix, o, rows, width, steps);
  } else if (route == 2) {
    lane_kernel<<<(unsigned)rows, 32, 0, s>>>(tb, ix, o, steps);
  } else if (width <= ROW_LANE_MAX) {
    row_lane_kernel<<<(unsigned)((rows + ROW_WARPS - 1) / ROW_WARPS), 32 * ROW_WARPS, 0, s>>>(tb, ix, o, rows, width);
  } else {
    const long long n = (long long)rows * width;
    row_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, s>>>(tb, ix, o, n, width);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* pcodec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
