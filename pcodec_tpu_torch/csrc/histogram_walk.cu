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
// the latency of up to nb dependent steps, each a 64-bit division and a few
// loads that depend on it.
//
// What the design does about it: one thread per lane, a warp per block so
// lanes spread over the SMs, the tables read through the read-only path.
// bin_idx is a native 64-bit division; the TPU kernel's f32-reciprocal
// fix-ups, and its nb <= 256 and n < 2^(31 - nb_log) limits, are gone.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;
using i64 = long long;
constexpr int THREADS = 32;

__global__ void __launch_bounds__(THREADS) histogram_walk_kernel(
    const u64* __restrict__ V, const i64* __restrict__ L, const i64* __restrict__ R, const u64* __restrict__ SL1,
    const u64* __restrict__ SR, const u64* __restrict__ s0, const i64* __restrict__ n_lane, int nb_log, int lanes,
    u64* __restrict__ counts, u64* __restrict__ lowers, u64* __restrict__ uppers, i64* __restrict__ n_bins) {
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= lanes) return;
  const i64 nb = 1LL << nb_log;
  const size_t row = (size_t)lane * (size_t)nb;
  V += row;
  L += row;
  R += row;
  SL1 += row;
  SR += row;
  counts += row;
  lowers += row;
  uppers += row;

  const i64 n = n_lane[lane];
  i64 n_out = 0;
  if (n > 0) {
    i64 next_avail = 0, inc_count = 0;
    u64 inc_lower = 0, inc_upper = 0;
    bool has_inc = false;
    const u64 slast = __ldg(V + nb - 1);
    auto bin_idx = [&](i64 c) { return (c << nb_log) / n; };
    auto c_count = [&](i64 bi) { return ((bi + 1) * n + nb - 1) >> nb_log; };
    auto apply_incomplete = [&](i64 count, u64 lower, u64 upper) {
      if (count <= 0) return;
      if (!has_inc) {
        inc_lower = lower;
        inc_count = 0;
      }
      has_inc = true;
      inc_count += count;
      inc_upper = upper;
    };
    auto complete_bin = [&](i64 bi) {
      if (!has_inc) return false;
      next_avail = bi + 1;
      if (n_out < nb) {
        counts[n_out] = (u64)inc_count;
        lowers[n_out] = inc_lower;
        uppers[n_out] = inc_upper;
      }
      n_out++;
      has_inc = false;
      return true;
    };

    i64 pos = 0;
    u64 cur_lower = s0[lane];
    for (i64 step = 0; step < nb && pos < n; step++) {
      const i64 j = bin_idx(pos);
      const i64 ti = c_count(j) - pos;
      if (ti >= n - pos) {  // the rest of the row is the last bin
        apply_incomplete(n - pos, cur_lower, slast);
        if (ti == n - pos) complete_bin(j);
        break;
      }
      const u64 tx = __ldg(V + j);
      const i64 lj = __ldg(L + j);
      const i64 l = lj > pos ? lj : pos;
      const i64 r = __ldg(R + j);
      apply_incomplete(l - pos, cur_lower, __ldg(SL1 + j));
      // apply_constant_run(r - l, tx); pos == l here
      const i64 cnt = r - l;
      i64 bi = bin_idx(l + cnt / 2);
      if (bi > next_avail && !complete_bin(bi - 1)) bi -= 1;
      apply_incomplete(cnt, tx, tx);
      if (l + cnt >= c_count(bi)) complete_bin(bi);
      pos = r;
      cur_lower = __ldg(SR + j);
    }
  }
  for (i64 k = n_out; k < nb; k++) {
    counts[k] = 0;
    lowers[k] = 0;
    uppers[k] = 0;
  }
  n_bins[lane] = n_out < nb ? n_out : nb;
}

}  // namespace

extern "C" int histogram_walk(const void* V, const void* L, const void* R, const void* SL1, const void* SR,
                              const void* s0, const void* n, int nb_log, int lanes, void* counts, void* lowers,
                              void* uppers, void* n_bins, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nb_log < 0 || nb_log > 24 || lanes < 0) return (int)cudaErrorInvalidValue;
  if (lanes == 0) return 0;
  histogram_walk_kernel<<<(lanes + THREADS - 1) / THREADS, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(V), static_cast<const i64*>(L), static_cast<const i64*>(R),
      static_cast<const u64*>(SL1), static_cast<const u64*>(SR), static_cast<const u64*>(s0),
      static_cast<const i64*>(n), nb_log, lanes, static_cast<u64*>(counts), static_cast<u64*>(lowers),
      static_cast<u64*>(uppers), static_cast<i64*>(n_bins));
  return (int)cudaGetLastError();
}

extern "C" const char* pcodec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
