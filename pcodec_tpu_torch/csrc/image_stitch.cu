// K7 image_stitch: places the pre-shifted row streams of a PCT file image
// into its body.
//
// Replaces: pcodec_tpu/ops/assemble.py::_stitch_pass_kernel (launched by
// _stitch_pass through stitch_pallas), the TPU kernel that cuts the body
// into superblocks and runs two passes so that every grid step owns a
// private output region, placing rows with lane rolls.
//
// What bounds it on Hopper: bytes. Each row word is read once and ORed into
// the body once; there is no other work.
//
// What the design does about it: blocks run in parallel on Hopper, so the
// superblock split, its row caps and its guard histogram go. Word w < lenW[r]
// of row r lands at body word F0[r] + w. Rows cover disjoint byte ranges of
// the body, so only a row's first and last words can share a word with a
// neighbouring row: those two go in with atomicOr, the interior words with
// plain stores. One warp per row, lanes on consecutive words (coalesced
// loads and stores); rows of stream A (pages) come first, then stream C
// (chunk prefixes), in one launch. The body is zeroed by the caller. A word
// whose destination lies outside the body is the caller's fault and stops
// the kernel with a device error rather than vanish.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS_PER_BLOCK = 8;

__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK) image_stitch_kernel(
    const uint32_t* __restrict__ rowsA, int WA, const long long* __restrict__ F0A,
    const long long* __restrict__ lenA, int RA, const uint32_t* __restrict__ rowsC, int WC,
    const long long* __restrict__ F0C, const long long* __restrict__ lenC, int RC,
    uint32_t* __restrict__ body, long long body_words) {
  long long r = (long long)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const uint32_t* row;
  long long f0, len;
  if (r < RA) {
    row = rowsA + r * WA;
    f0 = F0A[r];
    len = lenA[r] < WA ? lenA[r] : WA;
  } else if (r - RA < RC) {
    r -= RA;
    row = rowsC + r * WC;
    f0 = F0C[r];
    len = lenC[r] < WC ? lenC[r] : WC;
  } else {
    return;
  }
  for (long long w = lane; w < len; w += 32) {
    const long long dst = f0 + w;
    if (dst < 0 || dst >= body_words) __trap();
    const uint32_t v = row[w];
    if (w == 0 || w == len - 1) {
      if (v) atomicOr(body + dst, v);
    } else {
      body[dst] = v;
    }
  }
}

}  // namespace

extern "C" int image_stitch(const void* rowsA, int WA, const void* F0A, const void* lenA, int RA,
                            const void* rowsC, int WC, const void* F0C, const void* lenC, int RC,
                            void* body, long long body_words, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (RA < 0 || RC < 0) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)RA + RC;
  if (rows == 0 || body_words == 0) return 0;
  const long long blocks = (rows + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  image_stitch_kernel<<<(unsigned)blocks, 32 * WARPS_PER_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rowsA), WA, static_cast<const long long*>(F0A),
      static_cast<const long long*>(lenA), RA, static_cast<const uint32_t*>(rowsC), WC,
      static_cast<const long long*>(F0C), static_cast<const long long*>(lenC), RC,
      static_cast<uint32_t*>(body), body_words);
  return (int)cudaGetLastError();
}

extern "C" const char* pcodec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
