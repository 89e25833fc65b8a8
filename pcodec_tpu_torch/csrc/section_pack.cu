// K6 section_pack: bit-packs each PCT encode chain's ANS values and
// offsets into its page body.
//
// Replaces: pcodec_tpu/ops/pallas_encode.py::_ec_impl (launched by _ec_call),
// the TPU kernel that deposits each round's 4 values into per-quad vreg
// accumulators, retires words into a circular 128-word window per group and
// OR-merges the window into the section buffer on a static schedule.
//
// What bounds it on Hopper: bytes. It reads 12 bytes of K5 output per symbol
// (p1 and the offset) and writes the packed body, a few bits per symbol; the
// bit arithmetic per symbol is a handful of 64-bit operations.
//
// What the design does about it: the TPU's window, dump schedule and
// accumulator vregs exist for VMEM and lane layout and go. One thread per
// chain walks its page forward, batch by batch: it seeks to the batch's
// ANS cursor, appends the 256 ANS values (renorm bits each), seeks to the
// offset cursor and appends the 256 offsets (ob bits each; one above 32
// bits goes in as two deposits), LSB first, through a 64-bit accumulator
// that stores each completed 32-bit word. Each word of a row has one
// writer, so there are no atomics; a word left partial at a seek that
// skips bits is ORed in, the others are plain stores into the zeroed row.
// Symbols are read as 16-byte vectors, four at a time.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int BATCH = 256;

struct BitSink {
  uint32_t* row;
  int W;
  long long w;             // word of the first pending bit
  int n;                   // pending bits in acc
  unsigned long long acc;  // pending bits, LSB first
  bool merge;              // the word at w holds bits of an earlier section

  __device__ void store(uint32_t v) {
    if (w < W) row[w] = merge ? (row[w] | v) : v;
    merge = false;
    ++w;
  }
  __device__ void flush() {
    if (n > 0) {
      if (w < W) row[w] |= (uint32_t)acc;
      merge = true;
    }
  }
  __device__ void seek(long long bit) {
    if (bit == 32 * w + n) return;
    flush();
    w = bit >> 5;
    n = (int)(bit & 31);
    acc = 0ull;
    merge = n > 0;
  }
  __device__ void put(uint32_t v, int width) {  // v < 2^width, width <= 32
    acc |= (unsigned long long)v << n;
    n += width;
    if (n >= 32) {
      store((uint32_t)acc);
      acc >>= 32;
      n -= 32;
    }
  }
};

__global__ void __launch_bounds__(THREADS) section_pack_kernel(
    const int* __restrict__ p1, const unsigned long long* __restrict__ offsets, int page_n,
    const long long* __restrict__ curs, uint32_t* __restrict__ out, int W, int n_chains) {
  const long long c = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (c >= n_chains) return;
  const int* pr = p1 + c * page_n;
  const unsigned long long* orow = offsets + c * page_n;
  const long long* cc = curs + c * 2 * (page_n / BATCH);
  BitSink sink{out + c * W, W, 0, 0, 0ull, false};
  for (int b = 0; b < page_n / BATCH; ++b) {
    sink.seek(cc[2 * b]);
    for (int k = b * BATCH; k < (b + 1) * BATCH; k += 4) {
      const int4 q = reinterpret_cast<const int4*>(pr + k)[0];
      const int v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) sink.put((uint32_t)(v[j] & 0x7FFF), (v[j] >> 15) & 15);
    }
    sink.seek(cc[2 * b + 1]);
    for (int k = b * BATCH; k < (b + 1) * BATCH; k += 4) {
      const int4 q = reinterpret_cast<const int4*>(pr + k)[0];
      const int ob[4] = {(q.x >> 19) & 127, (q.y >> 19) & 127, (q.z >> 19) & 127, (q.w >> 19) & 127};
      if ((ob[0] | ob[1] | ob[2] | ob[3]) == 0) continue;
      const ulonglong2 o01 = reinterpret_cast<const ulonglong2*>(orow + k)[0];
      const ulonglong2 o23 = reinterpret_cast<const ulonglong2*>(orow + k)[1];
      const unsigned long long o[4] = {o01.x, o01.y, o23.x, o23.y};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (ob[j] > 32) {
          sink.put((uint32_t)o[j], 32);
          sink.put((uint32_t)(o[j] >> 32), ob[j] - 32);
        } else {
          sink.put((uint32_t)o[j], ob[j]);
        }
      }
    }
  }
  sink.flush();
}

}  // namespace

extern "C" int section_pack(const void* p1, const void* offsets, int page_n, const void* curs,
                            void* out, int sec_words, int n_chains, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (page_n % BATCH || sec_words < 1) return (int)cudaErrorInvalidValue;
  if (n_chains == 0) return 0;
  const int blocks = (n_chains + THREADS - 1) / THREADS;
  section_pack_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(p1), static_cast<const unsigned long long*>(offsets), page_n,
      static_cast<const long long*>(curs), static_cast<uint32_t*>(out), sec_words, n_chains);
  return (int)cudaGetLastError();
}

extern "C" const char* pcodec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
