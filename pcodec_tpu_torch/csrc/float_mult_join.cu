// B2 float_mult_join: the FloatMult mode join of one chunk, fused into one
// elementwise pass that writes the chunk's memory bits straight into its
// slice of the container's output.
//
// Replaces: the FloatMult branch of pcodec_tpu/ops/pallas_decode.py::_join_mem,
// which XLA compiles into one computation on the TPU (the integer softfloat
// of pcodec_tpu/ops/softfloat.py::sf_mul_bits for f64, the TPU's float
// multiply for f16 and f32). Not a Pallas kernel.
//
// For each number i of the chunk, its primary latent p (the multiplier) and
// secondary latent a (the adjustment), W-bit latents in int64:
//   mult  = int_float_latent_to_bits(p & mask)       the integer-valued float
//   prod  = sf_mul_bits(mult, base)                   mult * base, softfloat
//   lat   = (ordered_from_bits(prod) + (a & mask) + mid) & mask
//   out[i] = lat's memory bits (the float bijection's inverse)
// base is the chunk's base float's memory bits (softfloat.cuh's
// float_mult_join_bits, which B3, csrc/chunk_post.cu, runs for every
// FloatMult chunk of a decode, so no decode launches this kernel). Every
// width multiplies in the integer softfloat (csrc/softfloat.cuh): the
// card's f16 and f32 multiplies drop NaN payloads the host keeps, and the
// decode must give the host's numbers bit for bit.
//
// What bounds it on Hopper: bytes. 8 bytes of primary and 8 of secondary
// read and 8 of bits written a number; the softfloat's ~100 integer
// operations a number are under a sixth of the card's integer rate at the
// memory's pace.
//
// What the design does about it: one pass, the whole chain of the join in
// registers (the plain version's ~80 torch calls each read and wrote the
// chunk). W is a template argument. A thread handles ITEMS numbers, a
// block's loads coalesced and all in flight before the first multiply,
// streamed (.cs) since nothing reads them again.
#include <cstdint>
#include <cuda_runtime.h>

#include "softfloat.cuh"

namespace {

using u64 = unsigned long long;
constexpr int THREADS = 256;
constexpr int ITEMS = 4;  // numbers a thread joins

template <int W, int E, int P>
__global__ void __launch_bounds__(THREADS) float_mult_join_kernel(const u64* __restrict__ prim,
                                                                 const u64* __restrict__ sec, u64 base,
                                                                 u64* __restrict__ out, long long n) {
  const long long i0 = (long long)blockIdx.x * THREADS * ITEMS + threadIdx.x;
  u64 p[ITEMS], a[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = i0 + (long long)k * THREADS;
    p[k] = i < n ? __ldcs(prim + i) : 0;
    a[k] = i < n ? __ldcs(sec + i) : 0;
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = i0 + (long long)k * THREADS;
    if (i >= n) break;
    __stcs(out + i, softfloat::float_mult_join_bits<W, E, P>(p[k], a[k], base));
  }
}

cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
}

}  // namespace

// The FloatMult join of n numbers: prim, sec (n,) int64 latents, base the
// base float's memory bits, out (n,) int64 memory bits; W the float's width
// (16, 32 or 64).
extern "C" int float_mult_join(const void* prim, const void* sec, unsigned long long base, void* out, long long n,
                               int W, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 0 || (n > 0 && (!prim || !sec || !out))) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const long long per_block = (long long)THREADS * ITEMS;
  const long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<const u64*>(prim);
  auto a = static_cast<const u64*>(sec);
  auto o = static_cast<u64*>(out);
  if (W == 16) float_mult_join_kernel<16, 5, 11><<<(unsigned)blocks, THREADS, 0, s>>>(p, a, base, o, n);
  else if (W == 32) float_mult_join_kernel<32, 8, 24><<<(unsigned)blocks, THREADS, 0, s>>>(p, a, base, o, n);
  else if (W == 64) float_mult_join_kernel<64, 11, 53><<<(unsigned)blocks, THREADS, 0, s>>>(p, a, base, o, n);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* pcodec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
