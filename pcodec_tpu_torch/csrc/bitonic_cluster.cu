// E2 bitonic_cluster: ascending sort of each row of u32 keys, in place, by
// the bitonic network, its stages in registers.
//
// Replaces: experiments/pallas_bitonic.py::_sort_kernel (:42, launched by
// sort_rows_u32 :66), which keeps an (8, m) row block in VMEM across all
// p(p + 1) / 2 stages of the XOR network (partner i ^ j, ascending where
// (i & k) == 0), with one read and one write of HBM.
//
// What bounds it on Hopper: the network's compare-exchanges (m log2(m)
// (log2(m) + 1) / 4 a row, two integer min/max each) and the traffic that
// brings each stage's partners together. A stage done as a round trip
// through shared memory moves every key twice, so the first design, 136 such
// stages at 2^16 keys, was bound by shared memory's bandwidth.
//
// What the design does about it:
// - A thread holds a set of 32 keys in registers: the keys whose indices
//   differ in 5 bits a .. a + 4. It does the network's stages at those bits
//   with no memory traffic (`stages`), so the stages of a run length 2^q
//   take ceil(q / 5) passes, each one load and one store of every key in
//   shared memory: 30 passes at 2^16 keys, where the stages number 136. The
//   first pass sorts each run of 32 keys in registers.
// - All compare-exchanges put the smaller key first. A run that the network
//   leaves descending (bit q of its index set, after the merge of 2^q) is
//   held complemented, which reverses the u32 order; the first pass of each
//   merge complements the keys whose index bits q - 1 and q differ. So no
//   compare-exchange needs a direction.
// - Shared memory holds a tile, padded by one word every 32 (key i at
//   i + i / 32), so the 32 lanes of a warp, which hold sets with neighbouring
//   indices, read and write 32 banks at every step of every layout.
// - A tile of T <= 2^17 keys is held by a cluster of C <= 8 blocks of
//   B = min(T, 2^14) keys (67.6 KB with the padding), 3 blocks an SM, so
//   (96, 2^16)'s 384 blocks run in one wave on 132 SMs. A set whose bits
//   reach the block's rank bits is read and written through distributed
//   shared memory (mapa, ld/st.shared::cluster), between cluster.sync()s;
//   there is one such pass a merge past B keys.
// - 256 threads a block, 2 sets each a pass, at most 80 registers (3 blocks
//   an SM): ptxas spills 140 bytes. Whether a spill-free layout (128
//   threads a block, or 256 at 2 blocks an SM) is faster is not measured.
// - Rows longer than a tile are cut into tiles of 2^17, each sorted on chip
//   with its direction; then for each run length 2^q past the tile, the
//   stages at index bits of the tile or above go through device memory, r <=
//   5 bits a pass (`global_kernel`: a thread loads 2^r runs of 32 >> r
//   consecutive keys, coalesced, up to 16 bytes a load, does the r stages in
//   registers and stores them back), then the stages below the tile in one
//   on-chip pass over each tile (`tile_kernel` from q). At (32, 2^21) that
//   is 9 reads and writes of the keys: the tile sort, 4 device-memory passes
//   and 4 tile merges. Tiles of 2^18 (8 blocks of 2^15, one an SM) would
//   take 7, but hold one block an SM, not 3. The tile is fixed: every row
//   of more than 2^17 keys is cut into tiles of 2^17.
// - Rows under 32 keys are sorted a thread a row, padded with 0xFFFFFFFF.
// pcodec_tpu_torch/experiments/pallas_bitonic.py's sort_plan and
// sort_rows_u32_tiled_plain are this schedule in Python.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int KEYS = 32;  // keys a thread holds: 5 index bits of stages a pass
constexpr int THREADS = 256;  // a block's threads; fewer for a tile under 2^13 keys
constexpr int BLOCK_LOG = 14;  // most keys a block holds
constexpr int MAX_CLUSTER = 8;
constexpr int TILE_LOG = 17;  // longest tile: MAX_CLUSTER blocks of 2^BLOCK_LOG keys
constexpr int MAX_LOG = 31;  // longest row

__device__ __forceinline__ void cas(unsigned& x, unsigned& y) {
  const unsigned lo = min(x, y);
  y = max(x, y);
  x = lo;
}

// One ascending stage on a set: key e against key e + 2^J.
template <int J>
__device__ __forceinline__ void stage(unsigned (&x)[KEYS]) {
#pragma unroll
  for (int e = 0; e < KEYS; ++e)
    if (!(e & (1 << J))) cas(x[e], x[e | (1 << J)]);
}

// The stages at the set's bits g - 1 .. 0 (1 <= g <= 5).
__device__ __forceinline__ void stages(unsigned (&x)[KEYS], int g) {
  if (g > 4) stage<4>(x);
  if (g > 3) stage<3>(x);
  if (g > 2) stage<2>(x);
  if (g > 1) stage<1>(x);
  stage<0>(x);
}

// The 32 keys ascending: the bitonic network, k = 2 .. 32, descending where e & k.
__device__ __forceinline__ void sort32(unsigned (&x)[KEYS]) {
#pragma unroll
  for (int k = 2; k <= KEYS; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1)
#pragma unroll
      for (int e = 0; e < KEYS; ++e)
        if (!(e & j)) {
          if (e & k)
            cas(x[e | j], x[e]);
          else
            cas(x[e], x[e | j]);
        }
}

__host__ __device__ __forceinline__ unsigned pad(unsigned i) { return i + (i >> 5); }

// Word offset of key e of a set whose bits are a .. a + 4, a = A < 5, from
// its first key's padded offset.
template <int A>
__device__ __forceinline__ unsigned small_off(int e) {
  return ((unsigned)e << A) + ((unsigned)e >> (5 - A));
}

__device__ __forceinline__ unsigned mapa(unsigned addr, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ unsigned ld_cluster(unsigned addr) {
  unsigned v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void st_cluster(unsigned addr, unsigned v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

enum PassKind { FIRST = 0, MERGE = 1, FLIP = 2 };

// Key e's word in shared memory (L < 6) or its shared::cluster address (L == 6).
template <int L>
__device__ __forceinline__ unsigned key_at(unsigned base, int e, int a, int lb, unsigned stride, unsigned s_base) {
  const unsigned bmask = (1u << lb) - 1;
  if constexpr (L < 5) {
    return pad(base & bmask) + small_off<L>(e);
  } else if constexpr (L == 5) {
    return pad(base & bmask) + (unsigned)e * stride;
  } else {
    const unsigned i = base | ((unsigned)e << a);
    return mapa(s_base + 4 * pad(i & bmask), i >> lb);
  }
}

// One pass over the sets [s0, s1) of a tile: a set is the 32 keys whose tile
// index differs in bits a .. a + 4 (its other bits from s: the low a bits,
// then above a + 4). Layout L: a when a < 5, 5 for any a >= 5 with the set
// in this block, 6 for a set across the cluster. FIRST sorts each run of 32
// (a = 0) and complements it where bit 5 of its row index is set; MERGE does
// the stages at set bits g - 1 .. 0; FLIP first complements the keys whose
// row index bits q - 1 (set bit 4) and q differ.
template <int L>
__device__ void pass(unsigned* s_keys, int lb, unsigned s0, unsigned s1, int a, int g, int q, PassKind kind,
                     unsigned long long tile_off) {
  const unsigned s_base = (unsigned)__cvta_generic_to_shared(s_keys);
  const unsigned stride = L == 5 ? (1u << a) + (1u << (a - 5)) : 0;
  for (unsigned s = s0 + threadIdx.x; s < s1; s += blockDim.x) {
    const unsigned base = (s & ((1u << a) - 1)) | ((s >> a) << (a + 5));
    unsigned x[KEYS];
#pragma unroll
    for (int e = 0; e < KEYS; ++e) {
      const unsigned w = key_at<L>(base, e, a, lb, stride, s_base);
      if constexpr (L == 6)
        x[e] = ld_cluster(w);
      else
        x[e] = s_keys[w];
    }
    if (L == 0 && kind == FIRST) {
      const unsigned cm = ((tile_off + base) >> 5) & 1 ? ~0u : 0u;
#pragma unroll
      for (int e = 0; e < KEYS; ++e) x[e] ^= cm;
      sort32(x);
    } else {
      if (kind == FLIP) {
        const unsigned cm = ((tile_off + base) >> q) & 1 ? ~0u : 0u;
#pragma unroll
        for (int e = 0; e < KEYS; ++e) x[e] ^= (e & 16) ? ~cm : cm;
      }
      stages(x, g);
    }
#pragma unroll
    for (int e = 0; e < KEYS; ++e) {
      const unsigned w = key_at<L>(base, e, a, lb, stride, s_base);
      if constexpr (L == 6)
        st_cluster(w, x[e]);
      else
        s_keys[w] = x[e];
    }
  }
}

// A cluster a tile of 2^lt keys, each block 2^lb of them in shared memory.
// q0 == 5: the tile's whole network (runs of 32, then the merges of 2^6 ..
// 2^q1); q0 > lt: the stages below lt of the merge of 2^q0 (q1 == q0).
__global__ void __launch_bounds__(THREADS, 3) tile_kernel(unsigned* __restrict__ data, long long m, int lb, int lt,
                                                          int q0, int q1) {
  extern __shared__ unsigned s_keys[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned C = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const long long tile = blockIdx.x / C;
  const long long tiles_a_row = m >> lt;
  const unsigned long long tile_off = (unsigned long long)(tile % tiles_a_row) << lt;
  const unsigned B = 1u << lb;
  unsigned* g = data + (tile / tiles_a_row) * m + (long long)tile_off + (long long)rank * B;
  for (unsigned v = threadIdx.x; v < B / 4; v += blockDim.x) {
    const uint4 w = reinterpret_cast<const uint4*>(g)[v];
    unsigned* d = s_keys + pad(4 * v);
    d[0] = w.x;
    d[1] = w.y;
    d[2] = w.z;
    d[3] = w.w;
  }
  const unsigned s0 = rank << (lb - 5), s1 = s0 + (B >> 5);
  bool prev_cluster = false;
  int q = q0;
  if (q == 5) {
    __syncthreads();
    pass<0>(s_keys, lb, s0, s1, 0, 5, 5, FIRST, tile_off);
    ++q;
  }
  for (; q <= q1; ++q) {
    PassKind kind = q <= lt ? FLIP : MERGE;
    for (int hi = q < lt ? q : lt; hi > 0;) {
      const int a = hi > 5 ? hi - 5 : 0;
      const bool across = a + 5 > lb;
      if (across || prev_cluster)
        cluster.sync();
      else
        __syncthreads();
      if (across) {
        pass<6>(s_keys, lb, s0, s1, a, hi - a, q, kind, tile_off);
      } else if (a >= 5) {
        pass<5>(s_keys, lb, s0, s1, a, hi - a, q, kind, tile_off);
      } else {
        switch (a) {
          case 0: pass<0>(s_keys, lb, s0, s1, a, hi - a, q, kind, tile_off); break;
          case 1: pass<1>(s_keys, lb, s0, s1, a, hi - a, q, kind, tile_off); break;
          case 2: pass<2>(s_keys, lb, s0, s1, a, hi - a, q, kind, tile_off); break;
          case 3: pass<3>(s_keys, lb, s0, s1, a, hi - a, q, kind, tile_off); break;
          default: pass<4>(s_keys, lb, s0, s1, a, hi - a, q, kind, tile_off); break;
        }
      }
      kind = MERGE;
      prev_cluster = across;
      hi = a;
    }
  }
  if (prev_cluster)
    cluster.sync();
  else
    __syncthreads();
  for (unsigned v = threadIdx.x; v < B / 4; v += blockDim.x) {
    const unsigned* d = s_keys + pad(4 * v);
    reinterpret_cast<uint4*>(g)[v] = make_uint4(d[0], d[1], d[2], d[3]);
  }
}

// The merge of 2^q's stages at row index bits a + R - 1 .. a (a >= the
// tile's bits) through device memory: a thread a set of 2^R runs of 32 >> R
// consecutive keys, its other bits from the thread's index (the low ones
// first, so a warp reads and writes whole lines). flip: the merge's first
// pass (a + R == q), which first complements the keys whose bits q - 1 and
// q differ.
template <int R>
__global__ void __launch_bounds__(THREADS) global_kernel(unsigned* __restrict__ data, long long m, int a, int q,
                                                         bool flip, long long n_sets) {
  constexpr int V = KEYS >> R;
  constexpr int LV = 5 - R;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n_sets) return;
  const int lo = a - LV;
  const unsigned long long base = ((unsigned long long)(t & ((1LL << lo) - 1)) << LV) |
                                  ((unsigned long long)(t >> lo) << (a + R));
  unsigned x[KEYS];  // key v of run e in x[e * V + v]
#pragma unroll
  for (int e = 0; e < (1 << R); ++e) {
    unsigned* p = data + base + ((unsigned long long)e << a);
    if constexpr (V >= 4) {
#pragma unroll
      for (int w = 0; w < V / 4; ++w) {
        const uint4 u = reinterpret_cast<const uint4*>(p)[w];
        x[e * V + 4 * w] = u.x;
        x[e * V + 4 * w + 1] = u.y;
        x[e * V + 4 * w + 2] = u.z;
        x[e * V + 4 * w + 3] = u.w;
      }
    } else if constexpr (V == 2) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      x[e * V] = u.x;
      x[e * V + 1] = u.y;
    } else {
      x[e] = *p;
    }
  }
  if (flip) {
    const unsigned cm = ((base & (unsigned long long)(m - 1)) >> q) & 1 ? ~0u : 0u;
#pragma unroll
    for (int e = 0; e < (1 << R); ++e)
#pragma unroll
      for (int v = 0; v < V; ++v) x[e * V + v] ^= (e >> (R - 1)) & 1 ? ~cm : cm;
  }
#pragma unroll
  for (int b = R - 1; b >= 0; --b)
#pragma unroll
    for (int e = 0; e < (1 << R); ++e)
      if (!(e & (1 << b)))
#pragma unroll
        for (int v = 0; v < V; ++v) cas(x[e * V + v], x[(e | (1 << b)) * V + v]);
#pragma unroll
  for (int e = 0; e < (1 << R); ++e) {
    unsigned* p = data + base + ((unsigned long long)e << a);
    if constexpr (V >= 4) {
#pragma unroll
      for (int w = 0; w < V / 4; ++w)
        reinterpret_cast<uint4*>(p)[w] =
            make_uint4(x[e * V + 4 * w], x[e * V + 4 * w + 1], x[e * V + 4 * w + 2], x[e * V + 4 * w + 3]);
    } else if constexpr (V == 2) {
      *reinterpret_cast<uint2*>(p) = make_uint2(x[e * V], x[e * V + 1]);
    } else {
      *p = x[e];
    }
  }
}

// Rows under 32 keys: a thread a row, padded to 32 with the largest key.
__global__ void __launch_bounds__(THREADS) rows_kernel(unsigned* __restrict__ data, long long rows, int m) {
  const long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (r >= rows) return;
  unsigned* p = data + r * m;
  unsigned x[KEYS];
#pragma unroll
  for (int e = 0; e < KEYS; ++e) x[e] = e < m ? p[e] : 0xFFFFFFFFu;
  sort32(x);
#pragma unroll
  for (int e = 0; e < KEYS; ++e)
    if (e < m) p[e] = x[e];
}

int log2_of(long long v) {
  int l = 0;
  while ((1LL << l) < v) ++l;
  return l;
}

cudaError_t launch_tile(unsigned* keys, long long n_tiles, long long m, int lb, int lt, int q0, int q1,
                        cudaStream_t s) {
  const unsigned B = 1u << lb;
  const unsigned C = 1u << (lt - lb);
  const size_t smem = (size_t)pad(B) * sizeof(unsigned);
  cudaError_t err = cudaFuncSetAttribute(tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned sets = B / KEYS;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_tiles * C));
  cfg.blockDim = dim3(sets < THREADS ? (sets < 32 ? 32 : sets) : THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, tile_kernel, keys, m, lb, lt, q0, q1);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_global(unsigned* keys, long long rows, long long m, int a, int q, cudaStream_t s) {
  const long long n_sets = rows * m / KEYS;
  global_kernel<R><<<(unsigned)((n_sets + THREADS - 1) / THREADS), THREADS, 0, s>>>(keys, m, a, q, a + R == q,
                                                                                    n_sets);
  return cudaGetLastError();
}

}  // namespace

// keys: (rows, m) u32, m a power of two in [2, 2^31]; sorted in place.
extern "C" int bitonic_cluster(void* keys, int rows, long long m, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows < 0 || m < 2 || (m & (m - 1)) || m > (1LL << MAX_LOG)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  auto k = static_cast<unsigned*>(keys);
  auto s = static_cast<cudaStream_t>(stream);
  if (m < KEYS) {
    rows_kernel<<<(unsigned)((rows + THREADS - 1) / THREADS), THREADS, 0, s>>>(k, rows, (int)m);
    return (int)cudaGetLastError();
  }
  const int L = log2_of(m);
  const int lt = L < TILE_LOG ? L : TILE_LOG;
  const int lb = lt < BLOCK_LOG ? lt : BLOCK_LOG;
  const long long n_tiles = (long long)rows * (m >> lt);
  err = launch_tile(k, n_tiles, m, lb, lt, 5, lt, s);
  for (int q = lt + 1; q <= L && err == cudaSuccess; ++q) {
    for (int hi = q; hi > lt && err == cudaSuccess;) {
      const int r = hi - lt < 5 ? hi - lt : 5;
      switch (r) {
        case 1: err = launch_global<1>(k, rows, m, hi - r, q, s); break;
        case 2: err = launch_global<2>(k, rows, m, hi - r, q, s); break;
        case 3: err = launch_global<3>(k, rows, m, hi - r, q, s); break;
        case 4: err = launch_global<4>(k, rows, m, hi - r, q, s); break;
        default: err = launch_global<5>(k, rows, m, hi - r, q, s); break;
      }
      hi -= r;
    }
    if (err == cudaSuccess) err = launch_tile(k, n_tiles, m, lb, lt, q, q, s);
  }
  return (int)err;
}

extern "C" const char* pcodec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
