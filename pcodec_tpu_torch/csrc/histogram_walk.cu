// K9 histogram_walk: the quantile-histogram walk of the encoder's training.
//
// Replaces: pcodec_tpu/ops/pallas_walk.py::_walk_kernel (launched by
// walk_emissions), the TPU kernel behind device_train._walk_bins_device, and
// that function's lax.scan twin. Both compute the same bins.
//
// Each lane (one sorted row: a chunk, or one auto-delta candidate of a
// chunk's sample) walks at most nb = 2^nb_log bins of the reference's
// histogram builder (histograms.rs:132-206) over the row's quantile extracts:
// V[j] the value at bin j's quantile, L[j]/R[j] the first index of that value
// and one past its last (R clamped to the row's n), SL1[j] the value before
// L[j], SR[j] the value at R[j]; s0 is the row's smallest value. Every step
// either takes the rest of the row as one bin (and stops) or applies the run
// of V[j], which moves bin_idx(pos) = (pos << nb_log) / n past j, so nb steps
// always suffice. All arithmetic is integer, so the bins are exact.
//
// The lane writes its bins (count, lower, upper) packed to the front of its
// row in emission order, zeros after them, and n_bins: the TPU version's
// separate pack of step-major emissions (_pack_walk_emissions) folds into
// the kernel, since one thread emits its bins in order.
//
// What bounds it on Hopper: neither bytes nor operations. The tables are
// 40 bytes a bin and a step is some thirty integer operations; the time is
// the latency of up to nb dependent steps: each step's table loads wait on
// its bin index, and the next step's position is one of those loads.
//
// What the design does about it: a block (one warp) a lane, so the lanes
// spread over the SMs. The warp stages the lane's five tables in shared
// memory with 16-byte loads, then one thread walks, so each step's loads
// are shared-memory loads; a lane whose tables exceed the opt-in shared
// memory reads them in device memory instead, so no nb_log the wrapper
// admits is refused. bin_idx divides by the lane's fixed n with a multiply:
// m = floor((2^w - 1) / n) once a lane, then q = umulhi(x, m) is floor(x /
// n) or one less, and one compare corrects it (the TPU kernel's f32
// reciprocal with fix-ups, pallas_walk.py:71-82, does the same job; a
// native 64-bit division is a long software routine on Hopper). A lane
// whose values all fit 32 bits ((n + 1) << nb_log at most 2^32, as at
// every chunk of under 2^24 numbers at 256 bins) walks in 32-bit
// arithmetic, each step a chain of single instructions where 64-bit ones
// take two to four.
// A step's position is the last step's R load, so the walk issues the next
// step's bin index and five table loads before this step's bookkeeping,
// which then runs while they are in flight. The walking thread stores each
// bin as it is emitted (stores sit on no step's dependency chain); the warp
// then zeroes the rest of the row coalesced.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;
using i64 = long long;
constexpr int THREADS = 32;
constexpr int TABLES = 5;       // V, L, R, SL1, SR: 8 bytes a bin each
constexpr int NB_LOG_MAX = 24;  // the largest nb_log the entry admits
// a lane admits n < 2^(X_BITS - nb_log): then x = c << nb_log (c < n) and
// every product (bi + 1) * n + nb - 1 of the walk stay below 2^63
constexpr int X_BITS = 63;
// a lane with (n + 1) << nb_log <= 2^NARROW_BITS walks in 32-bit arithmetic
// (every such value then fits), the others in 64-bit
constexpr int NARROW_BITS = 32;

__device__ __forceinline__ unsigned mulhi(unsigned a, unsigned b) { return __umulhi(a, b); }
__device__ __forceinline__ u64 mulhi(u64 a, u64 b) { return __umul64hi(a, b); }

// floor(x / n) for x < 2^w (w the width of T) and n >= 1 by a multiply and
// one correction: m * n = 2^w - e with 1 <= e <= n, so x * m / 2^w lies in
// (x/n - 1, x/n]
template <typename T>
struct Divider {
  T n, m;
  __device__ explicit Divider(T n_) : n(n_), m((T)~T(0) / n_) {}
  __device__ T operator()(T x) const {
    T q = mulhi(x, m);
    if (x - q * n >= n) q++;
    return q;
  }
};

// copy one lane's row of nb u64 into shared memory, 16 bytes a lane where
// the row is 16-byte aligned
__device__ void stage(u64* dst, const u64* __restrict__ src, i64 nb, int t) {
  if (nb >= 2 && ((reinterpret_cast<uintptr_t>(src) & 15) == 0)) {
    const ulonglong2* s2 = reinterpret_cast<const ulonglong2*>(src);
    ulonglong2* d2 = reinterpret_cast<ulonglong2*>(dst);
    for (i64 i = t; i < nb / 2; i += THREADS) d2[i] = __ldg(s2 + i);
  } else {
    for (i64 i = t; i < nb; i += THREADS) dst[i] = __ldg(src + i);
  }
}

// one lane's walk in T arithmetic (every value it takes is at most (n + 1)
// << nb_log, and no difference it takes is negative); its bins stored as
// they are emitted. Returns the number emitted.
template <typename T>
__device__ i64 walk(const u64* v, const i64* l_, const i64* r_, const u64* sl1, const u64* sr, u64 s0, T n,
                    int nb_log, u64* __restrict__ counts, u64* __restrict__ lowers, u64* __restrict__ uppers) {
  const T nb = (T)1 << nb_log;
  const Divider<T> div(n);
  i64 n_out = 0;
  T next_avail = 0, inc_count = 0;
  u64 inc_lower = 0, inc_upper = 0;
  bool has_inc = false;
  const u64 slast = v[nb - 1];
  auto bin_idx = [&](T c) { return div(c << nb_log); };
  auto c_count = [&](T bi) { return ((bi + 1) * n + nb - 1) >> nb_log; };
  auto apply_incomplete = [&](T count, u64 lower, u64 upper) {
    if (count == 0) return;
    if (!has_inc) {
      inc_lower = lower;
      inc_count = 0;
    }
    has_inc = true;
    inc_count += count;
    inc_upper = upper;
  };
  auto complete_bin = [&](T bi) {
    if (!has_inc) return false;
    next_avail = bi + 1;
    if (n_out < (i64)nb) {
      counts[n_out] = (u64)inc_count;
      lowers[n_out] = inc_lower;
      uppers[n_out] = inc_upper;
    }
    n_out++;
    has_inc = false;
    return true;
  };

  // software-pipelined: a step's bin index and table loads for the next
  // position are issued before its bookkeeping, which then overlaps them
  T pos = 0, j = 0;  // bin_idx(0)
  u64 tx = v[0], s1 = sl1[0], sr_j = sr[0];
  T lj = (T)l_[0], r = (T)r_[0];
  u64 cur_lower = s0;
  for (T step = 0; step < nb && pos < n; step++) {
    const T ti = c_count(j) - pos;
    if (ti >= n - pos) {  // the rest of the row is the last bin
      apply_incomplete(n - pos, cur_lower, slast);
      if (ti == n - pos) complete_bin(j);
      break;
    }
    const T jn = r < n ? bin_idx(r) : 0;  // r == n ends the walk: row 0 is loaded and not used
    const u64 tx_n = v[jn], s1_n = sl1[jn], sr_n = sr[jn];
    const T lj_n = (T)l_[jn], r_n = (T)r_[jn];
    const T l = lj > pos ? lj : pos;
    apply_incomplete(l - pos, cur_lower, s1);
    // apply_constant_run(r - l, tx); pos == l here
    const T cnt = r - l;
    T bi = bin_idx(l + cnt / 2);
    if (bi > next_avail && !complete_bin(bi - 1)) bi -= 1;
    apply_incomplete(cnt, tx, tx);
    if (l + cnt >= c_count(bi)) complete_bin(bi);
    pos = r;
    cur_lower = sr_j;
    j = jn;
    tx = tx_n;
    s1 = s1_n;
    sr_j = sr_n;
    lj = lj_n;
    r = r_n;
  }
  return n_out < (i64)nb ? n_out : (i64)nb;
}

template <bool SMEM>
__global__ void __launch_bounds__(THREADS) histogram_walk_kernel(
    const u64* __restrict__ V, const i64* __restrict__ L, const i64* __restrict__ R, const u64* __restrict__ SL1,
    const u64* __restrict__ SR, const u64* __restrict__ s0, const i64* __restrict__ n_lane, int nb_log,
    u64* __restrict__ counts, u64* __restrict__ lowers, u64* __restrict__ uppers, i64* __restrict__ n_bins) {
  extern __shared__ __align__(16) u64 tabs[];
  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  const i64 nb = 1LL << nb_log;
  const size_t row = (size_t)lane * (size_t)nb;
  const u64* v = V + row;
  const i64* l_ = L + row;
  const i64* r_ = R + row;
  const u64* sl1 = SL1 + row;
  const u64* sr = SR + row;
  if (SMEM) {
    stage(tabs, v, nb, t);
    stage(tabs + nb, reinterpret_cast<const u64*>(l_), nb, t);
    stage(tabs + 2 * nb, reinterpret_cast<const u64*>(r_), nb, t);
    stage(tabs + 3 * nb, sl1, nb, t);
    stage(tabs + 4 * nb, sr, nb, t);
    __syncwarp();
    v = tabs;
    l_ = reinterpret_cast<const i64*>(tabs + nb);
    r_ = reinterpret_cast<const i64*>(tabs + 2 * nb);
    sl1 = tabs + 3 * nb;
    sr = tabs + 4 * nb;
  }
  counts += row;
  lowers += row;
  uppers += row;

  const i64 n = n_lane[lane];
  i64 n_out = 0;
  if (t == 0 && n > 0) {
    if ((u64)n >= (1ull << (X_BITS - nb_log))) __trap();  // past what the wrapper admits
    if (((u64)n + 1) << nb_log <= (1ull << NARROW_BITS)) {
      n_out = walk<unsigned>(v, l_, r_, sl1, sr, s0[lane], (unsigned)n, nb_log, counts, lowers, uppers);
    } else {
      n_out = walk<u64>(v, l_, r_, sl1, sr, s0[lane], (u64)n, nb_log, counts, lowers, uppers);
    }
  }
  n_out = __shfl_sync(0xffffffffu, n_out, 0);
  for (i64 k = n_out + t; k < nb; k += THREADS) {
    counts[k] = 0;
    lowers[k] = 0;
    uppers[k] = 0;
  }
  if (t == 0) n_bins[lane] = n_out;
}

}  // namespace

extern "C" int histogram_walk(const void* V, const void* L, const void* R, const void* SL1, const void* SR,
                              const void* s0, const void* n, int nb_log, int lanes, void* counts, void* lowers,
                              void* uppers, void* n_bins, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nb_log < 0 || nb_log > NB_LOG_MAX || lanes < 0) return (int)cudaErrorInvalidValue;
  if (lanes == 0) return 0;
  static int optin[64] = {0};  // the opt-in shared memory of each device, set once a process
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!optin[device]) {
    int bytes = 0;
    err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(histogram_walk_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    optin[device] = bytes;
  }
  const long long smem = (long long)TABLES * 8 << nb_log;
  auto s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel, size_t bytes) {
    kernel<<<lanes, THREADS, bytes, s>>>(
        static_cast<const u64*>(V), static_cast<const i64*>(L), static_cast<const i64*>(R),
        static_cast<const u64*>(SL1), static_cast<const u64*>(SR), static_cast<const u64*>(s0),
        static_cast<const i64*>(n), nb_log, static_cast<u64*>(counts), static_cast<u64*>(lowers),
        static_cast<u64*>(uppers), static_cast<i64*>(n_bins));
  };
  if (smem <= optin[device]) {
    launch(histogram_walk_kernel<true>, (size_t)smem);
  } else {
    launch(histogram_walk_kernel<false>, 0);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* pcodec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
