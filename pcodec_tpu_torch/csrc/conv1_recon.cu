// B1 conv1_recon: the conv1 (linear-prediction) delta reconstruction of
// every conv1 var of a container in one call, a warp or a thread a row.
//
// Replaces: pcodec_tpu/ops/decode.py::_conv1_decode, the lax.scan that the
// JAX package runs vmapped over a chunk's pages
// (pcodec_tpu/ops/pallas_decode.py::_reconstruct_var), and the host's serial
// conv1_decode_in_place that its standalone planner runs over a whole chunk
// to find each chain's first numbers. Not a Pallas kernel: XLA compiles the
// scan on the TPU.
//
// The recurrence, on each row of N numbers with stored state m[0..K): the
// first K outputs are m & mask; after them
//   v[p] = (delta[p - K] + mid + (max(bias + sum_j w_j v[p - K + j], 0) >> q)) & mask
// in wrapping 64-bit arithmetic, the window starting from the state
// unmasked (as the JAX scan and the port's plain version do).
//
// One descriptor row (DESC_COLS int64, fixed by the host plan and uploaded
// once) describes one conv1 var of one chunk: where its latents (a base
// tensor and a start, or a constant for a trivial var), its stored state
// (K numbers a row) and its output lie; its rows, row length and count of
// valid numbers (a ragged last row); K, q, bias, latent bits, its first row
// in the call, whether it is narrow, and the 32 weights (the first K used).
// A PCT chunk's rows are its pages; a standalone chunk is one row over the
// whole chunk, from the page's one stored state.
//
// What bounds it on Hopper: the dependent chain. Each row is serial: v[p]
// needs v[p - 1]. Bytes (8 in, 8 out a number) and operations (K
// multiply-adds a number) are far below what a row's steps take; a
// standalone chunk of 262,144 numbers is 262,144 dependent steps however
// wide the card is. A step's time is its chain's latency or, where that is
// shorter, the issue of every instruction the step carries.
//
// What the design does about it:
// - On the warp route, narrow arithmetic where the descriptor allows it
//   (NARROW, set by the host from ChunkMeta's own limits and checked here): with the window's
//   values below 2^bits, every partial sum of a row whose |bias| + 2^bits *
//   sum|w| < 2^(conv_bits - 1) fits conv_bits - 1 signed bits (conv_bits 16,
//   32, 64 for 8-, 16-, 32-bit latents). 8- and 16-bit latents step in
//   32-bit arithmetic; 32-bit latents keep a centred 32-bit window (v -
//   2^31, 2^31 * sum w folded into the bias), each term one widening
//   32 x 32 -> 64 multiply-add, the prediction's low word by one 64-bit
//   funnel shift and its sign from the high word, mid and the centring
//   cancelling in the delta. The first K steps, whose window reads the
//   stored state (any 64-bit value), and every other row (64-bit latents,
//   weights past the bound) take the 64-bit step.
// - Only the newest value's term sits on the chain: the sum of the older
//   K - 1 terms for the next step is formed while the current value is
//   computed. K is a template argument (1..32, one launch for each order
//   present), so the window and the weights stay in registers and the
//   steps unroll with constant window indices.
// - Where there are no more rows than the card has warp schedulers (a
//   standalone file's few long rows), a warp a row: every lane runs the
//   chain; lane l loads latent i0 + l of each block of 32 steps into a
//   register a block ahead of the chain; each step takes its latent from
//   its lane by a shuffle, step u's value goes to the warp's entry u in
//   shared memory, and lane u stores it after the block, the 32 values
//   together: no load index, store address or lane select on a step. (A
//   ring of cp.async copies several blocks ahead measured slower, 37.5
//   against 36.3 ns a step; a compare and select a step into lane u's
//   register 28.8 against 26.5, H100.)
// - More rows (a PCT chunk's pages): a thread a row, a block of
//   TILE_THREADS rows staging TILE steps of every row by coalesced cp.async
//   copies into shared memory, the next tile in flight while one is walked;
//   each thread walks its row there in the 64-bit step, writes its values
//   back in place, and the block stores the tile coalesced. (The narrow
//   steps bought nothing here: 0.1846 ms against 0.1840 with every row
//   64-bit on 8,192 rows of 1,024, H100.)
//
// The orders are built in parts: ops/kernels.py compiles this source in
// BUILD_PARTS nvcc processes at once (-DBUILD_PART=p -DBUILD_PARTS=n) and
// links them. Part p holds the kernels of the orders K with (K - 1) % n ==
// p and enters their launches in g_launch as the library loads; part 0
// holds the C entry. Compiled alone, the source is one part of every order.
#include <cstdint>
#include <cuda_runtime.h>
#include <utility>

#ifndef BUILD_PARTS
#define BUILD_PART 0
#define BUILD_PARTS 1
#endif

namespace c1 {  // shared by the parts

using u32 = unsigned;
using u64 = unsigned long long;
constexpr int THREADS = 128;  // the warp route's block: four rows
constexpr int MAX_ORDER = 32;
constexpr int MAX_BASES = 64;  // tensors one call reads and writes (the launch outputs, the states, the scratch); must match ops/kernels.py
constexpr int DESC_COLS = 47;  // must match ops/decode.py
constexpr int TILE_THREADS = 64;  // the page route's block: a row a thread
constexpr int TILE = 32;  // steps of each row a tile
constexpr int TILE_PAD = TILE + 1;  // a row's stride in a tile, in u64: odd, so a half-warp's rows hit distinct banks
constexpr int TILE_STAGES = 2;  // tiles in shared memory: one walked, one in flight

// descriptor columns, then the 32 weights at WEIGHTS
enum Col {
  LAT_BASE, LAT_START, MOM_BASE, MOM_START, OUT_BASE, OUT_START, N_ROWS, ROW_N, N_VALID, ORDER, QUANT, BIAS, BITS,
  ROW0, NARROW, WEIGHTS
};

// a row's arithmetic after its first K steps
enum Form { FORM_WIDE, FORM_S32, FORM_S64 };

struct Bases {
  u64 p[MAX_BASES];  // addresses of the int64 tensors the rows name
};

struct Row {
  const long long* d;  // its descriptor row
  const u64* lat;      // latent i at lat[i & smask]
  long long smask;     // 0 for a trivial var: its one latent read for every i
  const u64* mom;      // its K stored numbers
  u64* out;            // its count numbers
  long long count;
};

// Call row t's descriptor and row; false where the row is of another order
// than K or holds no number.
template <int K>
__device__ __forceinline__ bool find_row(const Bases& bs, const long long* desc, int n_desc, long long t,
                                         Row& row) {
  int lo = 0, hi = n_desc - 1;  // the last descriptor whose first row is <= t
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(desc + (long long)mid * DESC_COLS + ROW0) <= t) lo = mid;
    else hi = mid - 1;
  }
  const long long* d = desc + (long long)lo * DESC_COLS;
  if (__ldg(d + ORDER) != K) return false;
  const long long r = t - __ldg(d + ROW0);
  const long long N = __ldg(d + ROW_N);
  long long count = __ldg(d + N_VALID) - r * N;
  if (count > N) count = N;
  if (count <= 0) return false;
  const long long lat_base = __ldg(d + LAT_BASE);
  row.d = d;
  row.lat = lat_base < 0 ? reinterpret_cast<const u64*>(d + LAT_START)
                         : reinterpret_cast<const u64*>(bs.p[lat_base]) + __ldg(d + LAT_START) + r * N;
  row.smask = lat_base < 0 ? 0 : -1;
  row.mom = reinterpret_cast<const u64*>(bs.p[__ldg(d + MOM_BASE)]) + __ldg(d + MOM_START) + r * K;
  row.out = reinterpret_cast<u64*>(bs.p[__ldg(d + OUT_BASE)]) + __ldg(d + OUT_START) + r * N;
  row.count = count;
  return true;
}

__device__ __forceinline__ int row_form(const long long* d) {
  return !__ldg(d + NARROW) ? FORM_WIDE : __ldg(d + BITS) <= 16 ? FORM_S32 : FORM_S64;
}

// The 64-bit step: the first K steps of every row, and every step of a wide
// row. One step: v[K] from the window v (oldest first), whose older terms'
// sum `part` (bias included) was formed in the step before; only w[K - 1] *
// v[K - 1] and what follows it wait on the previous step.
template <int K>
struct Wide {
  static constexpr int FORM = FORM_WIDE;
  using D = u64;  // a latent as a step takes it
  using V = u64;  // a value in the window
  u64 w[K], v[K], part, bias, mid, mask;
  int q;

  __device__ __forceinline__ void init(const Row& r) {
    const int bits = (int)__ldg(r.d + BITS);
    q = (int)__ldg(r.d + QUANT);
    mask = bits >= 64 ? ~0ull : (1ull << bits) - 1;
    mid = 1ull << (bits - 1);
    bias = (u64)__ldg(r.d + BIAS);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      w[j] = (u64)__ldg(r.d + WEIGHTS + j);
      v[j] = __ldg(r.mom + j);
    }
    part = bias;
#pragma unroll
    for (int j = 0; j + 1 < K; ++j) part += w[j] * v[j];
  }
  __device__ __forceinline__ D prep(u64 delta) const { return delta + mid; }
  __device__ __forceinline__ V step(D dm) {
    const long long s = (long long)(part + w[K - 1] * v[K - 1]);
    u64 next = bias;
#pragma unroll
    for (int j = 0; j + 1 < K; ++j) next += w[j] * v[j + 1];
    const u64 val = (dm + (s >= 0 ? (u64)s >> q : 0ull)) & mask;  // a zero sum shifts to 0 too
#pragma unroll
    for (int j = 0; j + 1 < K; ++j) v[j] = v[j + 1];
    v[K - 1] = val;
    part = next;
    return val;
  }
  static __device__ __forceinline__ u64 value(V x) { return x; }
};

// 8- and 16-bit latents in the domain (the warp route): the sums fit 31 bits, so the step is
// 32-bit multiply-adds, max, shift, add and mask (wrapping unsigned sums
// whose true values are the signed ones).
template <int K>
struct Narrow16 {
  static constexpr int FORM = FORM_S32;
  using D = u32;
  using V = u32;
  u32 w[K], v[K], part, bias, mid, mask;
  int q;

  __device__ __forceinline__ void init(const Wide<K>& f) {
    q = f.q;
    mask = (u32)f.mask;
    mid = (u32)f.mid;
    bias = (u32)f.bias;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      w[j] = (u32)f.w[j];
      v[j] = (u32)f.v[j];
    }
    part = bias;
#pragma unroll
    for (int j = 0; j + 1 < K; ++j) part += w[j] * v[j];
  }
  __device__ __forceinline__ D prep(u64 delta) const { return (u32)delta + mid; }
  __device__ __forceinline__ V step(D dm) {
    const u32 s = part + w[K - 1] * v[K - 1];
    u32 next = bias;
#pragma unroll
    for (int j = 0; j + 1 < K; ++j) next += w[j] * v[j + 1];
    const u32 val = (dm + ((int)s >= 0 ? s >> q : 0u)) & mask;
#pragma unroll
    for (int j = 0; j + 1 < K; ++j) v[j] = v[j + 1];
    v[K - 1] = val;
    part = next;
    return val;
  }
  static __device__ __forceinline__ u64 value(V x) { return x; }
};

// a * b + c, the product widened to 64 bits: one IMAD.WIDE (written out,
// as nvcc otherwise multiplies the sign-extended operands in 64 bits)
__device__ __forceinline__ long long mad_wide(int a, int b, long long c) {
  long long d;
  asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(c));
  return d;
}

// 32-bit latents in the domain (the warp route): every |w| < 2^31, so the window is kept
// centred (c = v - 2^31, a signed 32-bit value), bias + 2^31 * sum w is the
// bias, and each term is one widening multiply-add into a 64-bit sum. The
// new value's centred form is delta + pred mod 2^32 (mid and the centring
// cancel), and q may be up to 63.
template <int K>
struct Narrow32 {
  static constexpr int FORM = FORM_S64;
  using D = u32;
  using V = int;
  int w[K], c[K];
  long long part, bias;
  int q;

  __device__ __forceinline__ void init(const Wide<K>& f) {
    q = f.q;
    long long sw = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      w[j] = (int)(u32)f.w[j];
      c[j] = (int)((u32)f.v[j] ^ 0x80000000u);
      sw += w[j];
    }
    bias = (long long)f.bias + sw * (1ll << 31);
    part = bias;
#pragma unroll
    for (int j = 0; j + 1 < K; ++j) part = mad_wide(w[j], c[j], part);
  }
  __device__ __forceinline__ D prep(u64 delta) const { return (u32)delta; }
  __device__ __forceinline__ V step(D d) {
    const long long s = mad_wide(w[K - 1], c[K - 1], part);
    long long next = bias;
#pragma unroll
    for (int j = 0; j + 1 < K; ++j) next = mad_wide(w[j], c[j + 1], next);
    // the prediction's low word (one funnel shift of the pair), kept
    // where the high word's sign says the sum is not negative
    const u32 pred = (int)(s >> 32) >= 0 ? (u32)((u64)s >> q) : 0u;
    const int val = (int)(d + pred);
#pragma unroll
    for (int j = 0; j + 1 < K; ++j) c[j] = c[j + 1];
    c[K - 1] = val;
    part = next;
    return val;
  }
  static __device__ __forceinline__ u64 value(V x) { return (u32)x ^ 0x80000000u; }
};

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A row's first min(K, S) steps, whose window reads the stored state, in
// 64-bit arithmetic; their latents' indices clamped into the row, the steps
// past S computed and not stored.
template <int K>
__device__ __forceinline__ void wide_prefix(Wide<K>& f, const Row& r, long long S, bool store) {
  u64 lat[K];
#pragma unroll
  for (int i = 0; i < K; ++i) lat[i] = __ldg(r.lat + ((i < S ? i : S - 1) & r.smask));
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const u64 val = f.step(f.prep(lat[i]));
    if (store && i < S) r.out[K + i] = val;
  }
}

// The warp route's steps K..S-1 of one row, every lane running the chain.
template <int K, class F>
__device__ __forceinline__ void warp_walk(F& f, const Row& r, long long S, int lane) {
  // latent i into lane i % 32, 0 past the row (its steps computed, not stored)
  auto load = [&](long long i) { return i < S ? __ldg(r.lat + (i & r.smask)) : 0ull; };
  // step u of a block stored by every lane to the warp's entry u (one
  // address) and read back by lane u after the block: no compare and
  // select on a step
  __shared__ typename F::V warp_vals[THREADS / 32][32];
  typename F::V* vals = warp_vals[threadIdx.x >> 5];
  u64 ahead = load(K + lane);
  u64* o = r.out + K;  // step i's value at o[i]
  for (long long i0 = K; i0 < S; i0 += 32) {
    const typename F::D cur = f.prep(ahead);
    ahead = load(i0 + 32 + lane);  // the next block's, a block ahead of the chain
#pragma unroll
    for (int u = 0; u < 32; ++u) vals[u] = f.step(__shfl_sync(0xffffffffu, cur, u));
    __syncwarp();
    if (i0 + lane < S) o[i0 + lane] = F::value(vals[lane]);
    __syncwarp();  // every lane's read done before the next block's stores
  }
}

// A row a warp (a standalone file's few long rows).
template <int K>
__global__ void __launch_bounds__(THREADS) conv1_warp_kernel(const __grid_constant__ Bases bs,
                                                            const long long* __restrict__ desc, int n_desc,
                                                            long long total_rows) {
  const int lane = threadIdx.x & 31;
  const long long t = ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
  Row r;
  if (t >= total_rows || !find_row<K>(bs, desc, n_desc, t, r)) return;  // the warp together
  Wide<K> f;
  f.init(r);
  if (lane < K && lane < r.count) r.out[lane] = __ldg(r.mom + lane) & f.mask;
  const long long S = r.count - K;  // steps: v[K + i] from latent i, i < S
  if (S <= 0) return;
  wide_prefix<K>(f, r, S, lane == 0);
  if (S <= K) return;
  const int form = row_form(r.d);
  if (form == FORM_WIDE) {
    warp_walk<K>(f, r, S, lane);
  } else if (form == FORM_S32) {
    Narrow16<K> n;
    n.init(f);
    warp_walk<K>(n, r, S, lane);
  } else {
    Narrow32<K> n;
    n.init(f);
    warp_walk<K>(n, r, S, lane);
  }
}

struct alignas(16) TileRow {  // a page-route row as the block's copies (lat to len) and stores (len, out) read it
  const u64* lat;
  long long smask;
  long long len;  // its steps walked in the tiles, 0 where it walks none
  u64* out;       // step i's value at out[i]
};

// A row a thread (a PCT chunk's pages), every step 64-bit: the block's rows
// stepped from K to their ends, TILE steps a tile. Element k of a thread's
// copies and stores is step e of row `row` of the tile, consecutive threads
// on consecutive steps.
template <int K>
__global__ void __launch_bounds__(TILE_THREADS) conv1_tile_kernel(const __grid_constant__ Bases bs,
                                                                 const long long* __restrict__ desc, int n_desc,
                                                                 long long total_rows) {
  __shared__ u64 tiles[TILE_STAGES * TILE_THREADS * TILE_PAD];
  __shared__ TileRow rows[TILE_THREADS];
  const int tid = threadIdx.x;
  const long long t = (long long)blockIdx.x * TILE_THREADS + tid;
  Row r{};
  Wide<K> f{};
  long long S = 0;
  if (t < total_rows && find_row<K>(bs, desc, n_desc, t, r)) {
    f.init(r);
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (j < r.count) r.out[j] = f.v[j] & f.mask;
    S = r.count - K;
    if (S > 0) wide_prefix<K>(f, r, S, true);
  }
  const bool mine = S > K;
  rows[tid] = TileRow{r.lat, r.smask, mine ? S : 0, r.out + K};
  if (!__syncthreads_or(mine)) return;
  auto stage = [&](long long tt) {
    u64* slot = tiles + (int)(tt % TILE_STAGES) * (TILE_THREADS * TILE_PAD);
    const long long i0 = K + tt * TILE;
#pragma unroll 8
    for (int k = 0; k < TILE; ++k) {
      const int q = tid + TILE_THREADS * k, row = q / TILE, e = q % TILE;
      const TileRow& x = rows[row];
      if (i0 + e < x.len) cp_async8(slot + row * TILE_PAD + e, x.lat + ((i0 + e) & x.smask));
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s + 1 < TILE_STAGES; ++s) stage(s);
  for (long long tt = 0;; ++tt) {
    cp_async_wait<TILE_STAGES - 2>();  // the thread's copies of tile tt have landed
    const long long i0 = K + tt * TILE;
    const bool active = mine && i0 < S;
    // every thread's copies of tile tt landed, every store of tile tt - 1 done
    if (!__syncthreads_or(active)) break;
    stage(tt + TILE_STAGES - 1);  // into tile tt - 1's slot
    u64* slot = tiles + (int)(tt % TILE_STAGES) * (TILE_THREADS * TILE_PAD);
    if (active) {  // steps past S computed on stale entries, not stored
      u64* x = slot + tid * TILE_PAD;
#pragma unroll
      for (int e = 0; e < TILE; ++e) x[e] = f.step(f.prep(x[e]));
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < TILE; ++k) {
      const int q = tid + TILE_THREADS * k, row = q / TILE, e = q % TILE;
      const TileRow& x = rows[row];
      if (i0 + e < x.len) x.out[i0 + e] = slot[row * TILE_PAD + e];
    }
  }
  cp_async_wait<0>();  // no copy still lands in shared memory as the block exits
}

template <int K>
cudaError_t launch(const Bases& bs, const long long* desc_dev, int n_desc, long long rows, bool warp_route,
                   cudaStream_t s) {
  if (warp_route) {
    const unsigned grid = (unsigned)((rows * 32 + THREADS - 1) / THREADS);
    conv1_warp_kernel<K><<<grid, THREADS, 0, s>>>(bs, desc_dev, n_desc, rows);
  } else {
    const unsigned grid = (unsigned)((rows + TILE_THREADS - 1) / TILE_THREADS);
    conv1_tile_kernel<K><<<grid, TILE_THREADS, 0, s>>>(bs, desc_dev, n_desc, rows);
  }
  return cudaGetLastError();
}

// order K's launch, entered by its part as the library loads (null for an
// order no part holds)
using Launch = cudaError_t (*)(const Bases&, const long long*, int, long long, bool, cudaStream_t);
extern Launch g_launch[MAX_ORDER + 1];

}  // namespace c1

using namespace c1;

namespace {

template <int K>
void enter_order() {
  if constexpr ((K - 1) % BUILD_PARTS == BUILD_PART) g_launch[K] = &launch<K>;
}

template <int... Is>
bool enter_orders(std::integer_sequence<int, Is...>) {
  (enter_order<Is + 1>(), ...);
  return true;
}

[[maybe_unused]] const bool g_entered = enter_orders(std::make_integer_sequence<int, MAX_ORDER>());

}  // namespace

#if BUILD_PART == 0

Launch c1::g_launch[MAX_ORDER + 1] = {};

namespace {

cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
}

bool in_base(long long base, long long start, long long n, const long long* numels, int n_bases) {
  return base >= 0 && base < n_bases && start >= 0 && n >= 0 && start + n <= numels[base];
}

// Whether a row lies in the narrow domain, exactly: latents of 8, 16 or 32
// bits, q <= conv_bits - 1 and |bias| + 2^bits * sum|w| < 2^(conv_bits - 1).
bool narrow_ok(const long long* d) {
  const long long bits = d[BITS];
  const int conv_bits = bits == 8 ? 16 : bits == 16 ? 32 : bits == 32 ? 64 : 0;
  if (!conv_bits || d[QUANT] > conv_bits - 1) return false;
  using u128 = unsigned __int128;
  auto mag = [](long long x) { return x < 0 ? (u128)(0ull - (u64)x) : (u128)x; };
  u128 sum = 0;
  for (long long j = 0; j < d[ORDER]; ++j) sum += mag(d[WEIGHTS + j]);
  return mag(d[BIAS]) + (sum << bits) < ((u128)1 << (conv_bits - 1));
}

constexpr int MAX_DEVICES = 64;
constexpr int SCHEDULERS_PER_SM = 4;  // warp schedulers of a Hopper SM
int g_sms[MAX_DEVICES];  // the device's SMs, 0 until read

cudaError_t sm_count(int device, int* out) {
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!g_sms[device]) {
    cudaError_t err = cudaDeviceGetAttribute(&g_sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  *out = g_sms[device];
  return cudaSuccess;
}

}  // namespace

// Every row of a container's conv1 table. bases, numels: the n_bases int64
// tensors the rows name, as addresses and element counts; desc: the n_desc
// rows on the host (checked here against the bases, a row marked narrow
// against the narrow domain) and desc_dev the same rows on the device (read
// by the kernels). *launched gets the kernels launched: one for each order
// the rows hold (0 where they hold no row).
extern "C" int conv1_recon(const u64* bases, const long long* numels, int n_bases, const long long* desc,
                           const void* desc_dev, int n_desc, int* launched, int device, void* stream) {
  *launched = 0;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (n_desc < 0 || n_bases < 0 || n_bases > MAX_BASES) return (int)cudaErrorInvalidValue;
  long long rows = 0;
  unsigned long long orders = 0;  // bit K - 1 for each order with rows
  for (int i = 0; i < n_desc; ++i) {
    const long long* d = desc + (long long)i * DESC_COLS;
    const long long R = d[N_ROWS], N = d[ROW_N], nv = d[N_VALID], K = d[ORDER];
    if (R < 0 || N < 1 || nv < 0 || nv > R * N || K < 1 || K > MAX_ORDER || d[QUANT] < 0 || d[QUANT] > 63 ||
        d[BITS] < 1 || d[BITS] > 64 || d[ROW0] != rows || d[NARROW] < 0 || d[NARROW] > 1 ||
        (d[NARROW] && !narrow_ok(d)) ||
        (d[LAT_BASE] >= 0 && !in_base(d[LAT_BASE], d[LAT_START], nv, numels, n_bases)) ||
        !in_base(d[MOM_BASE], d[MOM_START], R * K, numels, n_bases) ||
        !in_base(d[OUT_BASE], d[OUT_START], nv, numels, n_bases))
      return (int)cudaErrorInvalidValue;
    rows += R;
    if (nv > 0) orders |= 1ull << (K - 1);
  }
  if (!orders) return 0;
  if (rows > 0x7FFFFFFFLL * THREADS / 32 || !desc_dev) return (int)cudaErrorInvalidValue;
  // a row a warp where each row's warp can have a scheduler to itself (a
  // standalone file's few long rows); more rows a row a thread, a warp's
  // instructions serving 32 rows (8,192 rows of 1,024 took 0.21 ms against
  // 0.72 a warp a row before the tiles, H100)
  int sms = 0;
  if ((err = sm_count(device, &sms)) != cudaSuccess) return (int)err;
  const bool warp_route = rows <= (long long)sms * SCHEDULERS_PER_SM;
  Bases bs;
  for (int b = 0; b < n_bases; ++b) bs.p[b] = bases[b];
  auto s = static_cast<cudaStream_t>(stream);
  auto dd = static_cast<const long long*>(desc_dev);
  for (int k = 1; k <= MAX_ORDER; ++k) {
    if (!(orders >> (k - 1) & 1)) continue;
    // an order no part holds (a build of some orders only) is refused
    err = g_launch[k] ? g_launch[k](bs, dd, n_desc, rows, warp_route, s) : cudaErrorInvalidDeviceFunction;
    if (err != cudaSuccess) return (int)err;
    ++*launched;
  }
  return 0;
}

extern "C" const char* pcodec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#endif  // BUILD_PART == 0
