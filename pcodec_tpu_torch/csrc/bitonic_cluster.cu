// E2 bitonic_cluster: ascending sort of each row of u32 keys, in place, the
// row held on chip for the whole network.
//
// Replaces: experiments/pallas_bitonic.py::_sort_kernel (:42, launched by
// sort_rows_u32 :66), which keeps an (8, m) row block in VMEM across all
// p(p + 1) / 2 stages of the XOR network (partner i ^ j, ascending where
// (i & k) == 0), with one read and one write of HBM.
//
// What bounds it on Hopper: a sort must read and write each key once; the
// network's log2(m) (log2(m) + 1) / 2 compare-exchange passes cost nothing in
// device memory as long as the row stays on chip.
//
// What the design does about it: one thread-block cluster per row. Each of
// C <= 8 blocks holds B = min(m, 2^15) keys (128 KB of dynamic shared memory,
// by opt-in), so rows of up to 2^18 keys stay on chip: the row is read once
// and written once. Stages at distances j < B compare within a block between
// __syncthreads; stages at j >= B pair block rank q with rank q ^ (j / B) and
// go through distributed shared memory (map_shared_rank), the lower block
// taking the pairs of the first half of its offsets and the upper block the
// rest, with cluster.sync() before and after. A row longer than 2^18 keys
// (more than a portable cluster's shared memory) is refused; K8 row_sort
// (csrc/row_sort.cu) sorts those through device memory.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr long long BLOCK_KEYS = 1 << 15;
constexpr int MAX_CLUSTER = 8;

__global__ void __launch_bounds__(THREADS) bitonic_cluster_kernel(unsigned* __restrict__ data, long long m, int B) {
  extern __shared__ unsigned s_keys[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned C = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const long long base = (long long)rank * B;
  unsigned* src = data + (long long)(blockIdx.x / C) * m + base;
  for (int i = threadIdx.x; i < B; i += THREADS) s_keys[i] = src[i];
  __syncthreads();
  const int half = B >> 1;
  for (long long k = 2; k <= m; k <<= 1) {
    for (long long j = k >> 1; j > 0; j >>= 1) {
      if (j >= B) {
        const unsigned bit = (unsigned)(j / B);
        const unsigned prank = rank ^ bit;
        const bool lower = (rank & bit) == 0;
        cluster.sync();  // every block has finished the stage before
        unsigned* other = cluster.map_shared_rank(s_keys, prank);
        unsigned* lo_keys = lower ? s_keys : other;
        unsigned* hi_keys = lower ? other : s_keys;
        const long long lo_base = (long long)(lower ? rank : prank) * B;
        const int o0 = lower ? 0 : half;
        for (int o = o0 + threadIdx.x; o < o0 + half; o += THREADS) {
          const unsigned x = lo_keys[o], y = hi_keys[o];
          if ((x > y) == (((lo_base + o) & k) == 0)) {
            lo_keys[o] = y;
            hi_keys[o] = x;
          }
        }
        cluster.sync();  // the exchanges are visible before anyone reads on
      } else {
        const int jj = (int)j;
        for (int p = threadIdx.x; p < half; p += THREADS) {
          const int i = ((p & ~(jj - 1)) << 1) | (p & (jj - 1));
          const unsigned x = s_keys[i], y = s_keys[i + jj];
          if ((x > y) == (((base + i) & k) == 0)) {
            s_keys[i] = y;
            s_keys[i + jj] = x;
          }
        }
        __syncthreads();
      }
    }
  }
  for (int i = threadIdx.x; i < B; i += THREADS) src[i] = s_keys[i];
}

}  // namespace

extern "C" long long bitonic_cluster_max_keys() { return BLOCK_KEYS * MAX_CLUSTER; }

// keys: (rows, m) u32, m a power of two in [2, 2^18]; sorted in place.
extern "C" int bitonic_cluster(void* keys, int rows, long long m, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows < 0 || m < 2 || (m & (m - 1)) || m > BLOCK_KEYS * MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int B = (int)(m < BLOCK_KEYS ? m : BLOCK_KEYS);
  const unsigned C = (unsigned)(m / B);
  const size_t smem = (size_t)B * sizeof(unsigned);
  err = cudaFuncSetAttribute(bitonic_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)rows * C);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, bitonic_cluster_kernel, static_cast<unsigned*>(keys), m, B);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* pcodec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
