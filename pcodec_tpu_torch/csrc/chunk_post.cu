// B3 chunk_post: the decode post of every chunk that the fused launches,
// K3's Classic joins and K4's launch-read Dict chunks leave, in one launch:
// each latent var's consecutive delta undone page by page, the ragged last
// page trimmed, the mode join, the memory bits written into the container's
// output (a Dict chunk's latents into the scratch K4 reads).
//
// Replaces: the XLA post of pcodec_tpu/ops/pallas_decode.py::_post_chunks
// (its consecutive branch of _reconstruct_var through
// _consecutive_decode_batched, the trim and _join_mem), which the JAX package
// traces with the kernels into the one jitted program of
// _decode_plan_device. Not a Pallas kernel. B2's per-number FloatMult join
// (softfloat.cuh's float_mult_join_bits) runs inside it.
//
// One descriptor row (DESC_COLS int64, fixed by the host plan and uploaded
// once) describes one chunk: for its primary and secondary var, where the
// latents lie (a base tensor and a start, the chunk's number i at start + i,
// whether launch rows of whole pages or a flat scratch of K3, B1 or the
// per-chunk lookback route), or the constant of a trivial var; the var's
// consecutive order (0: no delta) and where its stored moments start in the
// moments base (page p's K moments at mom + p * K); the var's latent bits;
// where the output goes; the chunk's valid numbers, page length, the
// numbers an item takes (seg_n: the page length where a var has a delta,
// else a fixed span) and its first item in the launch; the mode, the join
// kind (JOIN_LATENTS: the primary's values as they are) and the mode's
// scalar (IntMult base, FloatQuant k, FloatMult base latent).
//
// The delta of order K on a page: x = latent + 2^(bits - 1), then for each
// level j = K - 1 .. 0 the value at p is m_j + sum_{q < p} x[q], in u64
// wrapping mod 2^64 (delta/consecutive.rs decode; the JAX
// _consecutive_decode_batched).
//
// What bounds it on Hopper: bytes. 8 bytes read a var and 8 written a
// number; the scans and joins (a softfloat multiply for FloatMult, ~150
// integer operations) stay under the card's integer rate at the memory's
// pace.
//
// What the design does about it: a warp an item (a page, or a span of a
// chunk without a delta), the items of every chunk of the container in one
// launch, so 1,024-number pages do not take a block each. A warp walks its
// item in tiles of 32 x ITEMS numbers, lane l holding numbers k * 32 + l so
// every load and store is coalesced, each var's ITEMS loads issued before
// the first scan. The cascade's K levels keep a running carry each in
// registers (the carry array indexed only by unrolled constants); each
// level of a 32-number step is one warp inclusive scan by shuffles (five
// 64-bit steps). No finished scan and no shared memory. A page of any
// length works; a long page is walked by its one warp. Registers bound
// the warps an SM holds, and with them the loads in flight, so the kernel
// is a template on the carries the launch's rows need (1, 3 or 7 levels)
// and on whether a row is FloatMult (the softfloat's registers): on an
// H100 80GB HBM3 at 700 W, 128 Classic f64 chunks of 256 pages of 1,024
// under an order-1 delta took 0.2412 ms so, 0.3968 with every row's
// carries and the softfloat (tools/torch_kernel_variants.py --only b3).
// ITEMS 2 and 8 came within 5% of ITEMS 4 in the same sweep.
#include <cstdint>
#include <cuda_runtime.h>

#include "softfloat.cuh"

namespace {

using u64 = unsigned long long;
constexpr int WARPS = 4;  // warps (items) a block
constexpr int THREADS = WARPS * 32;
constexpr int ITEMS = 4;       // numbers a lane holds of a tile
constexpr int MAX_ORDER = 7;   // must match constants.MAX_CONSECUTIVE_DELTA_ORDER
constexpr int MAX_BASES = 64;  // tensors one launch reads and writes; must match ops/kernels.py
constexpr int DESC_COLS = 21;  // must match ops/decode.py
// the modes, in the order of ops/decode.py's POST_MODES
constexpr int MODE_CLASSIC = 0;
constexpr int MODE_INT_MULT = 1;
constexpr int MODE_FLOAT_QUANT = 2;
constexpr int MODE_FLOAT_MULT = 3;
// the join kinds (must match ops/decode.py and csrc/lookback_recon.cu)
constexpr int JOIN_LATENTS = 0;
constexpr int JOIN_UNSIGNED = 1;
constexpr int JOIN_SIGNED = 2;
constexpr int JOIN_FLOAT = 3;

enum Col {
  PRIM_BASE, PRIM_START, PRIM_ORDER, PRIM_MOM, PRIM_BITS, SEC_BASE, SEC_START, SEC_ORDER, SEC_MOM, SEC_BITS, MOM_BASE,
  OUT_BASE, OUT_START, N_VALID, PAGE_N, SEG_N, ITEM0, MODE, JOIN, BITS, SCALAR
};

struct Bases {
  u64 p[MAX_BASES];  // addresses of the int64 tensors the rows name
};

// one var of an item: its latents (or a trivial var's constant), its
// delta's order and middle, and the running carry of each level (MAXO:
// the most levels any row of the launch has)
template <int MAXO>
struct Var {
  const u64* src;  // the item's first latent; nullptr for a trivial var
  u64 cst;
  int order;
  u64 mid;
  u64 c[MAXO];
};

template <int MAXO>
__device__ __forceinline__ Var<MAXO> make_var(const Bases& bs, const long long* d, int base_col, long long i0,
                                              long long page, const u64* mom) {
  Var<MAXO> v;
  const long long base = __ldg(d + base_col);
  const long long start = __ldg(d + base_col + 1);
  v.src = base < 0 ? nullptr : reinterpret_cast<const u64*>(bs.p[base]) + start + i0;
  v.cst = (u64)start;
  v.order = (int)__ldg(d + base_col + 2);
  const int bits = (int)__ldg(d + base_col + 4);
  v.mid = 1ull << (bits - 1);
  const u64* m = v.order ? mom + __ldg(d + base_col + 3) + page * v.order : nullptr;
#pragma unroll
  for (int j = 0; j < MAXO; ++j) v.c[j] = j < v.order ? __ldg(m + j) : 0;
  return v;
}

template <int MAXO>
__device__ __forceinline__ u64 load(const Var<MAXO>& v, long long i, long long count) {
  if (!v.src) return v.cst;
  return i < count ? __ldcs(v.src + i) : 0;
}

__device__ __forceinline__ u64 warp_inclusive_scan(u64 x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const u64 t = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += t;
  }
  return x;
}

// 32 consecutive latents of a var, one a lane, through its delta: each
// level's exclusive prefix sum plus its carry, the carry then advanced by
// the level's 32 values. Lanes past the item hold values that only later
// lanes and the carry past the item see.
template <int MAXO>
__device__ __forceinline__ u64 undo_delta(Var<MAXO>& v, u64 x, int lane) {
  if (v.order == 0) return x;
  x += v.mid;
#pragma unroll
  for (int j = MAXO - 1; j >= 0; --j) {
    if (j < v.order) {
      const u64 incl = warp_inclusive_scan(x, lane);
      const u64 total = __shfl_sync(0xffffffffu, incl, 31);
      x = v.c[j] + (incl - x);
      v.c[j] += total;
    }
  }
  return x;
}

// latent -> memory bits of a number of `bits` bits whose kind is the join
// kind (JOIN_LATENTS: the latent as it is)
__device__ __forceinline__ u64 ordered_join(int join, int bits, u64 lat) {
  if (join == JOIN_LATENTS) return lat;
  const u64 mask = bits >= 64 ? ~0ull : (1ull << bits) - 1;
  lat &= mask;
  if (join == JOIN_UNSIGNED) return lat;
  const u64 mid = 1ull << (bits - 1);
  if (join == JOIN_SIGNED) return (lat ^ mid) & mask;
  return (lat & mid) ? lat ^ mid : (~lat) & mask;
}

// the mode join of one number (ops/decode.py::join_mem); FM: whether the
// launch has a FloatMult row
template <bool FM>
__device__ __forceinline__ u64 join_of(int mode, int join, int bits, u64 scalar, u64 p, u64 s) {
  const u64 mask = bits >= 64 ? ~0ull : (1ull << bits) - 1;
  u64 u = p;
  if (mode == MODE_INT_MULT) {
    u = ((p & mask) * scalar + (s & mask)) & mask;
  } else if (mode == MODE_FLOAT_QUANT) {
    const int k = (int)scalar;
    const u64 y = p & mask, m = s & mask;
    const u64 cutoff = k >= 64 ? 0 : (1ull << (bits - 1)) >> k;
    const u64 low_max = (k >= 64 ? ~0ull : (1ull << k) - 1) & mask;
    const u64 lowest = y < cutoff ? low_max - m : m;
    u = ((k >= 64 ? 0 : y << k) + lowest) & mask;
  } else if constexpr (FM) {
    if (mode == MODE_FLOAT_MULT) {
      const u64 base = ordered_join(JOIN_FLOAT, bits, scalar);
      if (bits == 16) return softfloat::float_mult_join_bits<16, 5, 11>(p, s, base);
      if (bits == 32) return softfloat::float_mult_join_bits<32, 8, 24>(p, s, base);
      return softfloat::float_mult_join_bits<64, 11, 53>(p, s, base);
    }
  }
  return ordered_join(join, bits, u);
}

template <int MAXO, bool FM>
__global__ void __launch_bounds__(THREADS) chunk_post_kernel(const __grid_constant__ Bases bs,
                                                            const long long* __restrict__ desc, int n_desc,
                                                            long long total_items) {
  const int lane = threadIdx.x & 31;
  const long long t = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (t >= total_items) return;  // a whole warp
  int lo = 0, hi = n_desc - 1;  // the last row whose first item is <= t
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(desc + (long long)mid * DESC_COLS + ITEM0) <= t) lo = mid;
    else hi = mid - 1;
  }
  const long long* d = desc + (long long)lo * DESC_COLS;
  const long long seg = __ldg(d + SEG_N);
  const long long i0 = (t - __ldg(d + ITEM0)) * seg;
  long long count = __ldg(d + N_VALID) - i0;
  if (count > seg) count = seg;
  if (count <= 0) return;
  const long long page = i0 / __ldg(d + PAGE_N);  // read only where a var has a delta (seg_n is the page)
  const long long mom_base = __ldg(d + MOM_BASE);
  const u64* mom = mom_base < 0 ? nullptr : reinterpret_cast<const u64*>(bs.p[mom_base]);
  const int mode = (int)__ldg(d + MODE), join = (int)__ldg(d + JOIN), bits = (int)__ldg(d + BITS);
  const u64 scalar = (u64)__ldg(d + SCALAR);
  const bool two = mode != MODE_CLASSIC;
  Var<MAXO> pv = make_var<MAXO>(bs, d, PRIM_BASE, i0, page, mom);
  Var<MAXO> sv = two ? make_var<MAXO>(bs, d, SEC_BASE, i0, page, mom) : pv;
  u64* out = reinterpret_cast<u64*>(bs.p[__ldg(d + OUT_BASE)]) + __ldg(d + OUT_START) + i0;

  for (long long k0 = 0; k0 < count; k0 += 32 * ITEMS) {
    u64 px[ITEMS], sx[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const long long i = k0 + k * 32 + lane;
      px[k] = load(pv, i, count);
      sx[k] = two ? load(sv, i, count) : 0;
    }
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if (k0 + k * 32 >= count) break;  // the whole warp
      const long long i = k0 + k * 32 + lane;
      const u64 p = undo_delta(pv, px[k], lane);
      const u64 s = two ? undo_delta(sv, sx[k], lane) : 0;
      if (i < count) out[i] = join_of<FM>(mode, join, bits, scalar, p, s);
    }
  }
}

cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
}

bool in_base(long long base, long long start, long long n, const long long* numels, int n_bases) {
  return base >= 0 && base < n_bases && start >= 0 && n >= 0 && start + n <= numels[base];
}

// a var's source and moments against the bases: its latents (unless
// trivial) and, under a delta, its pages' moments
bool var_ok(const long long* d, int base_col, long long n, long long pages, const long long* numels, int n_bases) {
  const long long base = d[base_col], start = d[base_col + 1], order = d[base_col + 2], bits = d[base_col + 4];
  if (order < 0 || order > MAX_ORDER || bits < 1 || bits > 64) return false;
  if (base >= 0 && !in_base(base, start, n, numels, n_bases)) return false;
  return order == 0 || in_base(d[MOM_BASE], d[base_col + 3], pages * order, numels, n_bases);
}

}  // namespace

// Every row of a container's post table in one launch. bases, numels: the
// n_bases int64 tensors the rows name, as addresses and element counts;
// desc: the n_desc rows on the host (checked here against the bases) and
// desc_dev the same rows on the device (read by the kernel). *launched gets
// the kernels launched (0 where the rows hold no number).
extern "C" int chunk_post(const u64* bases, const long long* numels, int n_bases, const long long* desc,
                          const void* desc_dev, int n_desc, int* launched, int device, void* stream) {
  *launched = 0;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (n_desc < 0 || n_bases < 0 || n_bases > MAX_BASES) return (int)cudaErrorInvalidValue;
  long long items = 0;
  int levels = 0;   // the most levels of any var of the rows
  bool fm = false;  // a FloatMult row
  for (int i = 0; i < n_desc; ++i) {
    const long long* d = desc + (long long)i * DESC_COLS;
    const long long n = d[N_VALID], N = d[PAGE_N], seg = d[SEG_N], mode = d[MODE], join = d[JOIN], bits = d[BITS];
    if (n < 0 || N < 1 || seg < 1 || d[ITEM0] != items || mode < MODE_CLASSIC || mode > MODE_FLOAT_MULT ||
        join < JOIN_LATENTS || join > JOIN_FLOAT || bits < 1 || bits > 64)
      return (int)cudaErrorInvalidValue;
    if ((d[PRIM_ORDER] || (mode != MODE_CLASSIC && d[SEC_ORDER])) && seg != N) return (int)cudaErrorInvalidValue;
    if (mode == MODE_FLOAT_MULT && (join != JOIN_FLOAT || (bits != 16 && bits != 32 && bits != 64)))
      return (int)cudaErrorInvalidValue;
    const long long pages = (n + N - 1) / N;
    if (!var_ok(d, PRIM_BASE, n, pages, numels, n_bases) ||
        (mode != MODE_CLASSIC && !var_ok(d, SEC_BASE, n, pages, numels, n_bases)) ||
        !in_base(d[OUT_BASE], d[OUT_START], n, numels, n_bases))
      return (int)cudaErrorInvalidValue;
    items += (n + seg - 1) / seg;
    levels = (int)(d[PRIM_ORDER] > levels ? d[PRIM_ORDER] : levels);
    if (mode != MODE_CLASSIC && d[SEC_ORDER] > levels) levels = (int)d[SEC_ORDER];
    fm = fm || mode == MODE_FLOAT_MULT;
  }
  if (!items) return 0;
  if (items > 0x7FFFFFFFLL * WARPS || !desc_dev) return (int)cudaErrorInvalidValue;
  Bases bs;
  for (int b = 0; b < n_bases; ++b) bs.p[b] = bases[b];
  const unsigned grid = (unsigned)((items + WARPS - 1) / WARPS);
  auto s = static_cast<cudaStream_t>(stream);
  auto dd = static_cast<const long long*>(desc_dev);
  // the carries and the softfloat only where the rows need them: fewer
  // registers, more warps an SM
  if (levels <= 1 && !fm) chunk_post_kernel<1, false><<<grid, THREADS, 0, s>>>(bs, dd, n_desc, items);
  else if (levels <= 1) chunk_post_kernel<1, true><<<grid, THREADS, 0, s>>>(bs, dd, n_desc, items);
  else if (levels <= 3 && !fm) chunk_post_kernel<3, false><<<grid, THREADS, 0, s>>>(bs, dd, n_desc, items);
  else if (levels <= 3) chunk_post_kernel<3, true><<<grid, THREADS, 0, s>>>(bs, dd, n_desc, items);
  else if (!fm) chunk_post_kernel<MAX_ORDER, false><<<grid, THREADS, 0, s>>>(bs, dd, n_desc, items);
  else chunk_post_kernel<MAX_ORDER, true><<<grid, THREADS, 0, s>>>(bs, dd, n_desc, items);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}

extern "C" const char* pcodec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
