// K8 row_sort: ascending sort of each row of unsigned keys, a segmented LSD
// radix sort.
//
// Replaces: pcodec_tpu/ops/pallas_sort.py::_sort_kernel (launched by
// sort_rows_u32), the TPU kernel that holds one row of at most 2^16 u32 keys
// in VMEM for the whole bitonic network and does each compare-exchange as two
// rolls and a select.
//
// What bounds it on Hopper: bytes. A sort must read and write each key once;
// a radix sort reads each key twice and writes it once a digit pass (the
// tile histogram, then the scatter), so its traffic is about 3 x passes x the
// keys' bytes, and few passes: a sorting network would run
// log2(m) (log2(m) + 1) / 2 compare-exchange passes, those beyond a tile
// through device memory.
//
// What the design does about it:
// - minmax_kernel and span_kernel find each row's minimum and maximum and the
//   largest span (max - min) over the rows; the wrapper reads that one scalar
//   back. Keys are taken relative to their row's minimum, as u32 where every
//   span fits 32 bits, else u64, and only ceil(bits(span) / 8) digit passes
//   run: a pass whose digit is zero for every key is never launched, so a
//   row of equal keys is copied.
// - Each pass: hist_kernel counts the pass's 8-bit digits of each
//   (row, tile) with shared-memory atomics (tiles of 2,048 keys never
//   straddle rows); scan_kernel turns each row's counts, in (digit, tile)
//   order, into the place where each tile's keys of each digit start;
//   scatter_kernel ranks each tile's keys stably (per warp by a match of the
//   digit made of 8 ballots, then across warps), stages the tile in shared
//   memory in digit order and writes each digit's run to its place,
//   consecutive threads on consecutive addresses. Each thread loads its 8
//   keys before it ranks any, so a warp has them all in flight; 8 keys a
//   thread (not 16) keep the scatter near 60 registers, four blocks an SM.
//   The histogram's plain shared atomics ran faster on the card than a
//   warp-aggregated match, even on skewed digits. 8-bit digits keep the
//   per-tile counts at 256 (the (rows, 256, tiles) table is 1/8 of the u32
//   keys); 11-bit digits would save a pass only for spans of 17-24 or 25-32
//   bits, at 8x the counts.
// - The first pass reads the caller's rows and subtracts the row minimum as
//   it loads; the last pass adds it back as it stores the caller's type.
//   Between passes keys ping-pong through two scratch buffers the wrapper
//   allocates; rows of any length sort, with no padding.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u32 = unsigned int;
using u64 = unsigned long long;
constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;  // keys of a tile; must match ops/row_sort.py
constexpr int WARPS = THREADS / 32;
constexpr int BITS = 8;
constexpr int BINS = 1 << BITS;
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_ITEMS = 4;
constexpr u32 FULL = 0xFFFFFFFFu;
static_assert(BINS == THREADS, "a thread owns a digit in scatter_kernel and hist_kernel");

__device__ __forceinline__ u32 lanemask_lt() {
  u32 m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// The lanes of valid_mask whose 8-bit digit equals this lane's: one ballot
// a digit bit (a warp-wide match without __match_any_sync, whose throughput
// is a small fraction of a ballot's).
__device__ __forceinline__ u32 digit_peers(u32 d, u32 valid_mask) {
  u32 peers = valid_mask;
#pragma unroll
  for (int b = 0; b < BITS; ++b) {
    const bool bit = (d >> b) & 1;
    const u32 vote = __ballot_sync(FULL, bit);
    peers &= bit ? vote : ~vote;
  }
  return peers;
}

__device__ __forceinline__ int tile_keys(long long m, int tile) {
  const long long left = m - (long long)tile * TILE;
  return (int)(left < TILE ? left : TILE);
}

template <typename InT>
__global__ void __launch_bounds__(THREADS) minmax_kernel(const InT* __restrict__ in, u64* rmin, u64* rmax,
                                                        long long m, int tiles) {
  const int row = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const InT* src = in + (long long)row * m + (long long)tile * TILE;
  const int n = tile_keys(m, tile);
  u64 v[ITEMS];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int i = r * THREADS + threadIdx.x;
    v[r] = i < n ? (u64)src[i] : (u64)src[0];
  }
  u64 lo = v[0], hi = v[0];
#pragma unroll
  for (int r = 1; r < ITEMS; ++r) {
    lo = v[r] < lo ? v[r] : lo;
    hi = v[r] > hi ? v[r] : hi;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const u64 a = __shfl_xor_sync(FULL, lo, o), b = __shfl_xor_sync(FULL, hi, o);
    lo = a < lo ? a : lo;
    hi = b > hi ? b : hi;
  }
  if ((threadIdx.x & 31) == 0) {
    atomicMin(rmin + row, lo);
    atomicMax(rmax + row, hi);
  }
}

__global__ void __launch_bounds__(SCAN_THREADS) span_kernel(const u64* __restrict__ rmin,
                                                           const u64* __restrict__ rmax, u64* span, int rows) {
  __shared__ u64 s_max[SCAN_THREADS / 32];
  u64 s = 0;
  for (int r = threadIdx.x; r < rows; r += SCAN_THREADS) {
    const u64 d = rmax[r] - rmin[r];
    s = d > s ? d : s;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const u64 a = __shfl_xor_sync(FULL, s, o);
    s = a > s ? a : s;
  }
  if ((threadIdx.x & 31) == 0) s_max[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < SCAN_THREADS / 32; ++w) s = s_max[w] > s ? s_max[w] : s;
    *span = s;
  }
}

template <typename InT, typename KeyT, bool SUB>
__device__ __forceinline__ KeyT load_key(const InT* src, int i, u64 lo) {
  return (KeyT)((u64)src[i] - (SUB ? lo : 0ull));
}

// Digit counts of each (row, tile), written to hist[row][digit][tile].
template <typename InT, typename KeyT, bool SUB>
__global__ void __launch_bounds__(THREADS) hist_kernel(const InT* __restrict__ in, const u64* __restrict__ rmin,
                                                      int* __restrict__ hist, long long m, int tiles, int shift) {
  __shared__ int s_h[BINS];
  const int row = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const InT* src = in + (long long)row * m + (long long)tile * TILE;
  const int n = tile_keys(m, tile);
  const u64 lo = SUB ? rmin[row] : 0ull;
  s_h[threadIdx.x] = 0;
  KeyT k[ITEMS];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int i = r * THREADS + threadIdx.x;
    k[r] = i < n ? load_key<InT, KeyT, SUB>(src, i, lo) : 0;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const bool valid = r * THREADS + (int)threadIdx.x < n;
    const u32 d = (u32)(k[r] >> shift) & (BINS - 1);
    if (valid) atomicAdd(s_h + d, 1);
  }
  __syncthreads();
  hist[((long long)row * BINS + threadIdx.x) * tiles + tile] = s_h[threadIdx.x];
}

// Each row's len counts, in place, into their exclusive prefix sums.
__global__ void __launch_bounds__(SCAN_THREADS) scan_kernel(int* __restrict__ hist, int len) {
  __shared__ int s_warp[SCAN_THREADS / 32];
  __shared__ int s_carry;
  int* h = hist + (long long)blockIdx.x * len;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_carry = 0;
  __syncthreads();
  for (int base = 0; base < len; base += SCAN_THREADS * SCAN_ITEMS) {
    int v[SCAN_ITEMS], sum = 0;
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      const int i = base + threadIdx.x * SCAN_ITEMS + j;
      v[j] = i < len ? h[i] : 0;
      sum += v[j];
    }
    int incl = sum;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int w = s_warp[lane];
      int wi = w;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, wi, o);
        if (lane >= o) wi += y;
      }
      s_warp[lane] = wi - w;
    }
    __syncthreads();
    int run = s_carry + s_warp[warp] + incl - sum;
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      const int i = base + threadIdx.x * SCAN_ITEMS + j;
      if (i < len) h[i] = run;
      run += v[j];
    }
    __syncthreads();
    if (threadIdx.x == SCAN_THREADS - 1) s_carry = run;
    __syncthreads();
  }
}

// One digit pass over one (row, tile): stable within the row.
template <typename InT, typename KeyT, typename OutT, bool SUB, bool ADD>
__global__ void __launch_bounds__(THREADS) scatter_kernel(const InT* __restrict__ in, OutT* __restrict__ out,
                                                         const u64* __restrict__ rmin, const int* __restrict__ gpos,
                                                         long long m, int tiles, int shift) {
  __shared__ KeyT s_keys[TILE];
  __shared__ int s_cnt[WARPS][BINS];  // a warp's count of each digit, then where its keys of it start
  __shared__ int s_dst[BINS];         // a digit's place in the row less its place in the staged tile
  __shared__ int s_wsum[WARPS];
  const int row = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const InT* src = in + (long long)row * m + (long long)tile * TILE;
  const int n = tile_keys(m, tile);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const u64 lo = (SUB || ADD) ? rmin[row] : 0ull;
  for (int i = threadIdx.x; i < WARPS * BINS; i += THREADS) (&s_cnt[0][0])[i] = 0;
  __syncthreads();

  // Warp w holds keys [w * 32 * ITEMS, (w + 1) * 32 * ITEMS) of the tile, 32
  // consecutive keys a round; a key's rank counts the keys of its digit
  // before it in the warp's earlier rounds and in its own round.
  const u32 lt = lanemask_lt();
  KeyT key[ITEMS];
  int rank[ITEMS];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int i = warp * 32 * ITEMS + r * 32 + lane;
    key[r] = i < n ? load_key<InT, KeyT, SUB>(src, i, lo) : 0;
  }
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const bool valid = warp * 32 * ITEMS + r * 32 + lane < n;
    const u32 d = (u32)(key[r] >> shift) & (BINS - 1);
    const u32 peers = digit_peers(d, __ballot_sync(FULL, valid));
    const int before = valid ? s_cnt[warp][d] : 0;
    __syncwarp();
    if (valid && (peers & lt) == 0) s_cnt[warp][d] = before + __popc(peers);
    __syncwarp();
    rank[r] = before + __popc(peers & lt);
  }
  __syncthreads();

  // Thread t owns digit t: where each warp's keys of it start among the
  // tile's, then where the digit starts in the staged tile and in the row.
  const int t = threadIdx.x;
  int total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int c = s_cnt[w][t];
    s_cnt[w][t] = total;
    total += c;
  }
  int incl = total;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_wsum[warp] = incl;
  __syncthreads();
  int dstart = incl - total;
  for (int w = 0; w < warp; ++w) dstart += s_wsum[w];
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s_cnt[w][t] += dstart;
  s_dst[t] = gpos[((long long)row * BINS + t) * tiles + tile] - dstart;
  __syncthreads();

#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int i = warp * 32 * ITEMS + r * 32 + lane;
    if (i < n) s_keys[s_cnt[warp][(int)((key[r] >> shift) & (BINS - 1))] + rank[r]] = key[r];
  }
  __syncthreads();

  OutT* dst = out + (long long)row * m;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const KeyT k = s_keys[i];
    dst[s_dst[(int)((k >> shift) & (BINS - 1))] + i] = (OutT)((u64)k + (ADD ? lo : 0ull));
  }
}

// passes >= 1 digit passes of rows x m keys of type InT into out (the same
// type); keys holds one (passes 2) or two (passes 3 and more) scratch rows
// sets of KeyT.
template <typename InT, typename KeyT>
cudaError_t sort_passes(const InT* in, InT* out, const u64* rmin, KeyT* keys, int* hist, int rows, long long m,
                        int passes, cudaStream_t s) {
  const int tiles = (int)((m + TILE - 1) / TILE);
  const unsigned grid = (unsigned)((long long)rows * tiles);
  KeyT* buf[2] = {keys, keys + (long long)rows * m};
  for (int p = 0; p < passes; ++p) {
    const int shift = p * BITS;
    const bool first = p == 0, last = p == passes - 1;
    const KeyT* from = first ? nullptr : buf[(p - 1) & 1];
    if (first)
      hist_kernel<InT, KeyT, true><<<grid, THREADS, 0, s>>>(in, rmin, hist, m, tiles, shift);
    else
      hist_kernel<KeyT, KeyT, false><<<grid, THREADS, 0, s>>>(from, rmin, hist, m, tiles, shift);
    scan_kernel<<<rows, SCAN_THREADS, 0, s>>>(hist, BINS * tiles);
    if (first && last)
      scatter_kernel<InT, KeyT, InT, true, true><<<grid, THREADS, 0, s>>>(in, out, rmin, hist, m, tiles, shift);
    else if (first)
      scatter_kernel<InT, KeyT, KeyT, true, false><<<grid, THREADS, 0, s>>>(in, buf[0], rmin, hist, m, tiles, shift);
    else if (last)
      scatter_kernel<KeyT, KeyT, InT, false, true><<<grid, THREADS, 0, s>>>(from, out, rmin, hist, m, tiles, shift);
    else
      scatter_kernel<KeyT, KeyT, KeyT, false, false><<<grid, THREADS, 0, s>>>(from, buf[p & 1], rmin, hist, m,
                                                                               tiles, shift);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
}

bool bad_shape(int rows, long long m) {
  return rows < 1 || m < 1 || m > 0x7FFFFFFFLL || (long long)rows * ((m + TILE - 1) / TILE) > 0x7FFFFFFFLL;
}

}  // namespace

// Each row's minimum and maximum and the largest span over the rows, into
// mm: rows u64 minima, rows maxima, then the span.
extern "C" int row_sort_span(const void* in, int rows, long long m, int in_bytes, void* mm, int device,
                             void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(rows, m) || (in_bytes != 4 && in_bytes != 8)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  u64* rmin = static_cast<u64*>(mm);
  u64* rmax = rmin + rows;
  if ((err = cudaMemsetAsync(rmin, 0xFF, (size_t)rows * sizeof(u64), s)) != cudaSuccess) return (int)err;
  if ((err = cudaMemsetAsync(rmax, 0, (size_t)rows * sizeof(u64), s)) != cudaSuccess) return (int)err;
  const int tiles = (int)((m + TILE - 1) / TILE);
  const unsigned grid = (unsigned)((long long)rows * tiles);
  if (in_bytes == 8)
    minmax_kernel<u64><<<grid, THREADS, 0, s>>>(static_cast<const u64*>(in), rmin, rmax, m, tiles);
  else
    minmax_kernel<u32><<<grid, THREADS, 0, s>>>(static_cast<const u32*>(in), rmin, rmax, m, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  span_kernel<<<1, SCAN_THREADS, 0, s>>>(rmin, rmax, rmax + rows, rows);
  return (int)cudaGetLastError();
}

// Sort each row of `in` (rows x m keys of in_bytes) into `out`, in `passes`
// 8-bit digit passes of key_bytes keys relative to the row minima of mm
// (row_sort_span's). keys: scratch for min(passes - 1, 2) x rows x m keys;
// hist: rows x 256 x ceil(m / 4096) ints. passes 0 copies.
extern "C" int row_sort(const void* in, void* out, int rows, long long m, int in_bytes, int key_bytes, int passes,
                        const void* mm, void* keys, void* hist, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(rows, m) || passes < 0 || passes > (key_bytes * 8) / BITS || (in_bytes != 4 && in_bytes != 8) ||
      (key_bytes != 4 && key_bytes != 8) || key_bytes > in_bytes)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (passes == 0) return (int)cudaMemcpyAsync(out, in, (size_t)rows * m * in_bytes, cudaMemcpyDeviceToDevice, s);
  auto rmin = static_cast<const u64*>(mm);
  auto h = static_cast<int*>(hist);
  if (in_bytes == 4)
    err = sort_passes<u32, u32>(static_cast<const u32*>(in), static_cast<u32*>(out), rmin, static_cast<u32*>(keys),
                                h, rows, m, passes, s);
  else if (key_bytes == 4)
    err = sort_passes<u64, u32>(static_cast<const u64*>(in), static_cast<u64*>(out), rmin, static_cast<u32*>(keys),
                                h, rows, m, passes, s);
  else
    err = sort_passes<u64, u64>(static_cast<const u64*>(in), static_cast<u64*>(out), rmin, static_cast<u64*>(keys),
                                h, rows, m, passes, s);
  return (int)err;
}

extern "C" const char* pcodec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
