// B8 triple_gcd: the IntMult screening's triple GCDs of the encoder's
// training, a thread a triple.
//
// Replaces: pcodec_tpu/ops/device_train.py::_gcd_u64 (:177) inside the
// jitted _phase_int_gcd (:212), not a Pallas kernel: Stein's binary GCD of
// every sorted triple's two differences as one lax.while_loop over all
// triples at once, which runs until the slowest triple has ended.
//
// Each chunk's sample is a row of m u64 latents (sm, int64 bits) with its
// valid mask; consecutive positions 3j, 3j + 1, 3j + 2 are a triple. The
// triple is sorted unsigned (lo <= mid <= hi), g = gcd(mid - lo, hi - lo)
// with gcd(0, b) = b, and out[row, j] is g where the triple's three
// positions are valid and g > 1, else 0 (int_mult.rs:114-136).
//
// What bounds it on Hopper: operations, by a little. 24 bytes and 3 flags
// read and 8 bytes written a triple; Stein's loop takes up to ~2 x 64
// iterations of ~6 integer operations for random 64-bit differences, and
// a step or a few for the screening's usual samples (multiples of a base).
//
// What the design does about it: one launch where the plain version's
// loop took a host sync and ~12 torch calls an iteration, each over every
// triple. Each thread runs its own loop to its own end; the trailing zeros
// come from __ffsll.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;
constexpr int THREADS = 256;

// trailing zeros, 63 for 0 (the JAX ctz63)
__device__ __forceinline__ int ctz63(u64 x) { return x ? __ffsll((long long)x) - 1 : 63; }

// Stein's binary GCD, shifts and subtractions only; gcd(0, b) = b
__device__ __forceinline__ u64 gcd_u64(u64 a, u64 b) {
  if (a == 0 || b == 0) return a | b;
  const int ca = ctz63(a), cb = ctz63(b);
  u64 x = a >> ca, y = b >> cb;  // both odd
  while (y != 0) {
    const u64 small = x < y ? x : y;
    const u64 diff = (x < y ? y : x) - small;
    y = diff == 0 ? 0 : diff >> ctz63(diff);
    x = small;
  }
  return x << (ca < cb ? ca : cb);
}

__global__ void __launch_bounds__(THREADS) triple_gcd_kernel(const u64* __restrict__ sm,
                                                             const unsigned char* __restrict__ valid,
                                                             long long triples, long long nt3, long long m,
                                                             u64* __restrict__ out) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= triples) return;
  const long long at = i / nt3 * m + i % nt3 * 3;
  const u64 a = sm[at], b = sm[at + 1], c = sm[at + 2];
  const bool ok = valid[at] && valid[at + 1] && valid[at + 2];
  const u64 ab_lo = a < b ? a : b, ab_hi = a < b ? b : a;
  const u64 lo = ab_lo < c ? ab_lo : c;
  const u64 hi = ab_hi < c ? c : ab_hi;
  const u64 mid = a + b + c - lo - hi;
  const u64 g = gcd_u64(mid - lo, hi - lo);
  __stcs(out + i, ok && g > 1 ? g : 0ull);
}

cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
}

}  // namespace

// The triple GCDs of rows samples of m numbers: sm (rows, m) int64 u64
// bits, valid (rows, m) bool, out (rows, m / 3) int64.
extern "C" int triple_gcd(const void* sm, const void* valid, long long rows, long long m, void* out, int device,
                          void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (rows < 0 || m < 0) return (int)cudaErrorInvalidValue;
  const long long nt3 = m / 3, triples = rows * nt3;
  if (triples == 0) return 0;
  const long long blocks = (triples + THREADS - 1) / THREADS;
  if (!sm || !valid || !out || blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  triple_gcd_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(sm), static_cast<const unsigned char*>(valid), triples, nt3, m,
      static_cast<u64*>(out));
  return (int)cudaGetLastError();
}

extern "C" const char* pcodec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
