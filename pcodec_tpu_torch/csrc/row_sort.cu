// K8 row_sort: ascending sort of each row of unsigned keys, in place.
//
// Replaces: pcodec_tpu/ops/pallas_sort.py::_sort_kernel (launched by
// sort_rows_u32), the TPU kernel that holds one row of at most 2^16 u32 keys
// in VMEM for the whole bitonic network and does each compare-exchange as
// two rolls and a select.
//
// What bounds it on Hopper: a sort must read and write each key once, but a
// bitonic network over m keys runs log2(m) (log2(m) + 1) / 2 compare-exchange
// passes. Passes that stay in shared memory cost no device-memory traffic;
// each pass at a distance beyond one block's tile reads and writes the whole
// row (from L2 for rows of a few MB).
//
// What the design does about it: rows are padded by the caller to a power of
// two m_pad with the largest key. A block owns a 32 KB tile (8,192 u32 or
// 4,096 u64 keys) in shared memory: the first launch sorts every tile, each in
// the direction the bitonic pattern gives it. Then every merge stage k beyond
// the tile runs its distances j >= tile as one global pass each (one thread
// per compare-exchange pair) and its distances below the tile in one
// shared-memory launch. Rows of at most one tile (the TPU kernel's sample rows)
// take a single launch; rows longer than 2^16 keys, which VMEM refused, take
// the global passes. Keys are u32 or u64 (a template); the wrapper narrows
// u64 rows whose span fits 32 bits to u32 keys relative to the row minimum,
// as the JAX package's sort32 does.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE_BYTES = 32768;
constexpr int THREADS = 512;

template <typename T>
__device__ __forceinline__ void cmpx(T* a, long long i, long long l, bool asc) {
  const T x = a[i], y = a[l];
  if ((x > y) == asc) {
    a[i] = y;
    a[l] = x;
  }
}

// Stages k_first..k_last (powers of two) of the network inside each tile,
// distances min(k, tile) / 2 down to 1.
template <typename T>
__global__ void __launch_bounds__(THREADS) tile_kernel(T* __restrict__ data, long long m_pad, int tile,
                                                      long long k_first, long long k_last) {
  __shared__ T s[TILE_BYTES / sizeof(T)];
  const long long base = (long long)blockIdx.x * tile;
  T* row = data + (long long)blockIdx.y * m_pad + base;
  for (int i = threadIdx.x; i < tile; i += THREADS) s[i] = row[i];
  __syncthreads();
  for (long long k = k_first; k <= k_last; k <<= 1) {
    for (int j = (int)((k < tile ? k : tile) >> 1); j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < tile / 2; p += THREADS) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        cmpx(s, i, i + j, ((base + i) & k) == 0);
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < tile; i += THREADS) row[i] = s[i];
}

// One compare-exchange pass of stage k at distance j over whole rows.
template <typename T>
__global__ void __launch_bounds__(THREADS) global_pass(T* __restrict__ data, long long m_pad, long long k,
                                                      long long j) {
  const long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (p >= m_pad / 2) return;
  const long long i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
  cmpx(data + (long long)blockIdx.y * m_pad, i, i + j, (i & k) == 0);
}

template <typename T>
cudaError_t run(void* ptr, int rows, long long m_pad, cudaStream_t s) {
  constexpr long long TILE = TILE_BYTES / sizeof(T);
  T* d = static_cast<T*>(ptr);
  const int tile = (int)(m_pad < TILE ? m_pad : TILE);
  const dim3 tiles((unsigned)(m_pad / tile), (unsigned)rows);
  const dim3 pairs((unsigned)((m_pad / 2 + THREADS - 1) / THREADS), (unsigned)rows);
  tile_kernel<T><<<tiles, THREADS, 0, s>>>(d, m_pad, tile, 2, tile);
  cudaError_t err = cudaGetLastError();
  for (long long k = 2LL * tile; k <= m_pad && err == cudaSuccess; k <<= 1) {
    for (long long j = k >> 1; j >= tile; j >>= 1) global_pass<T><<<pairs, THREADS, 0, s>>>(d, m_pad, k, j);
    tile_kernel<T><<<tiles, THREADS, 0, s>>>(d, m_pad, tile, k, k);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

extern "C" int row_sort(void* data, int rows, long long m_pad, int key_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows < 0 || rows > 65535 || m_pad < 2 || (m_pad & (m_pad - 1)) || (key_bytes != 4 && key_bytes != 8))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  err = key_bytes == 4 ? run<uint32_t>(data, rows, m_pad, s) : run<unsigned long long>(data, rows, m_pad, s);
  return (int)err;
}

extern "C" const char* pcodec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
