// B6 mode_split: the mode split of the encoder's training, one pass over
// the units (the page rows of a training's latents, or its sampled
// numbers), each unit with its chunk's split parameters.
//
// Replaces: the mode split of pcodec_tpu/ops/device_train.py, which XLA
// compiles into the jitted training programs: the split of
// _phase_delta_sort (the primaries before the delta), of the auto-delta
// samples and _phase_secondary, built on
// pcodec_tpu/ops/softfloat.py::float_mult_primary and
// float_mult_adjustment. Not a Pallas kernel.
//
// Each unit u reads its chunk c = owner[u] and the chunk's row of the
// parameter table (div, flip, invb, base; div 1 and invb 0 where the chunk
// does not split). For each latent x of the unit:
//   primary    FloatMult (invb != 0): round_half_away_latent(
//                sf_mul_bits(bits_from_ordered(x), invb)), the integer
//                softfloat; IntMult and FloatQuant (div != 1): x / div,
//                unsigned; else x
//   secondary  x % div, flipped to div - 1 - r where flip holds and x is
//                below the middle (FloatQuant's negative floats); FloatMult:
//                x - ordered_from_bits(sf_mul_bits(int_float_latent_to_bits(
//                prim), base)) + mid, masked at W bits (prim: the unit's
//                primary)
// The division is the card's native unsigned 64-bit one, exact for every
// divisor (the plain version's udivmod special-cases those from 2^63).
// Every multiply is the integer softfloat of csrc/softfloat.cuh, never the
// card's float unit, which drops NaN payloads the host keeps.
//
// What bounds it on Hopper: bytes. 8 bytes read and 8 written a latent (16
// with the primary for FloatMult's secondary); the softfloat's ~150 and the
// division's ~60 integer operations stay under the card's integer rate at
// the memory's pace.
//
// What the design does about it: one elementwise pass where the plain
// version's ~80 torch calls each read and wrote every row. A thread takes
// ITEMS latents, a block's loads coalesced and all in flight before the
// first split, streamed (.cs) since nothing reads them again. The float
// width is a template argument (0 for integer types).
#include <cstdint>
#include <cuda_runtime.h>

#include "softfloat.cuh"

namespace {

using u64 = unsigned long long;
constexpr int THREADS = 256;
constexpr int ITEMS = 4;       // latents a thread splits
constexpr int TABLE_COLS = 4;  // div, flip, invb, base; must match ops/device_train.py

template <int W, int E, int P>
__global__ void __launch_bounds__(THREADS) mode_split_kernel(const u64* __restrict__ lat, const u64* __restrict__ prim,
                                                            u64* __restrict__ out, long long n, long long m,
                                                            const long long* __restrict__ owner,
                                                            const long long* __restrict__ table, int secondary,
                                                            u64 mid) {
  const long long i0 = (long long)blockIdx.x * THREADS * ITEMS + threadIdx.x;
  const bool with_prim = W != 0 && secondary && prim;  // FloatMult's secondary reads the primaries
  u64 x[ITEMS], pr[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = i0 + (long long)k * THREADS;
    x[k] = i < n ? __ldcs(lat + i) : 0;
    pr[k] = with_prim && i < n ? __ldcs(prim + i) : 0;
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = i0 + (long long)k * THREADS;
    if (i >= n) break;
    const long long* row = table + __ldg(owner + i / m) * TABLE_COLS;
    u64 r = 0;
    bool split = false;
    if constexpr (W != 0) {
      const u64 invb = (u64)__ldg(row + 2);
      if (invb) {  // FloatMult
        split = true;
        if (!secondary) {
          r = softfloat::round_half_away_latent<W, E, P>(
              softfloat::sf_mul_bits<W, E, P>(softfloat::bits_from_ordered<W>(x[k]), invb));
        } else {
          constexpr u64 mask = W >= 64 ? ~0ull : (1ull << W) - 1;
          const u64 prod = softfloat::sf_mul_bits<W, E, P>(softfloat::int_float_latent_to_bits<W, E, P>(pr[k]),
                                                            (u64)__ldg(row + 3));
          r = (x[k] - softfloat::ordered_from_bits<W>(prod) + (1ull << (W - 1))) & mask;
        }
      }
    }
    if (!split) {  // IntMult and FloatQuant divide; div 1 leaves the latent (its remainder 0)
      const u64 div = (u64)__ldg(row);
      if (!secondary) {
        r = div != 1 ? x[k] / div : x[k];
      } else {
        r = x[k] % div;
        if (__ldg(row + 1) && x[k] < mid) r = div - 1 - r;
      }
    }
    __stcs(out + i, r);
  }
}

cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
}

}  // namespace

// The split of n latents in units of m: lat, out (n,) int64; prim (n,)
// int64, the units' primaries (read for FloatMult's secondary; may be null
// where no chunk is FloatMult); owner (n / m,) int64 chunk of each unit;
// table (chunks, TABLE_COLS) int64 rows; secondary 0 for the primary, 1
// for the secondary; W the float's width (16, 32, 64), 0 for integers;
// bits the latents' width (the secondary's middle).
extern "C" int mode_split(const void* lat, const void* prim, void* out, long long n, long long m, const void* owner,
                          const void* table, int secondary, int W, int bits, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 0 || m < 1 || n % m || bits < 1 || bits > 64 || (n > 0 && (!lat || !out || !owner || !table)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const long long per_block = (long long)THREADS * ITEMS;
  const long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const u64*>(lat);
  auto p = static_cast<const u64*>(prim);
  auto o = static_cast<u64*>(out);
  auto ow = static_cast<const long long*>(owner);
  auto tb = static_cast<const long long*>(table);
  const u64 mid = 1ull << (bits - 1);
  const unsigned g = (unsigned)blocks;
  if (W == 0) mode_split_kernel<0, 11, 53><<<g, THREADS, 0, s>>>(x, p, o, n, m, ow, tb, secondary, mid);
  else if (W == 16) mode_split_kernel<16, 5, 11><<<g, THREADS, 0, s>>>(x, p, o, n, m, ow, tb, secondary, mid);
  else if (W == 32) mode_split_kernel<32, 8, 24><<<g, THREADS, 0, s>>>(x, p, o, n, m, ow, tb, secondary, mid);
  else if (W == 64) mode_split_kernel<64, 11, 53><<<g, THREADS, 0, s>>>(x, p, o, n, m, ow, tb, secondary, mid);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* pcodec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
