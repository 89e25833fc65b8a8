// K4 dict_join: the Dict-mode join of every Dict chunk of a container, one
// launch, a clamped gather of memory bits.
//
// Replaces: pcodec_tpu/ops/pallas_decode.py::_dict_join_kernel_body and
// _dict_join_kernel_body_big (launched by _dict_join_pairs once per chunk),
// the TPU kernels that gather through select trees over 128-lane planes (a
// full tree up to 8,192 entries, a hot prefix plus a cold-plane loop up to
// 2^15) and emit (lo, hi) i32 word pairs; past 2^15 entries JAX falls back to
// an XLA gather.
//
// For each chunk c (its index latents src_c, its place out_c in the
// container's output, its table offset toff_c and D_c) and each i < n_c:
//   out[out_c + i] = table[toff_c + min(src_c[i] & 0xFFFFFFFF, D_c - 1)]
// where the table holds every Dict chunk's entries back to back, each as its
// memory bits with the latent -> memory bijection folded in.
//
// What bounds it on Hopper: bytes. Each number reads 8 bytes of index and
// writes 8 bytes of bits; the table is read once. The gathers are random but
// land in a table that is small beside the stream. A chunk is 1M numbers
// (5 us of bytes), so one launch a chunk was bound by the host's cost of a
// launch, not by the card.
//
// What the design does about it: one launch for the whole container. The
// chunks' descriptors travel by value in the launch's parameters (up to
// MAX_CHUNKS a launch, __grid_constant__, so nothing is copied to the card
// first); the host side reads the device attributes once per device. The
// chunks are laid end to end in a joined index space of tiles of TILE
// numbers, a block a tile, or, where the caller asks it to walk (each block
// copying a large table into shared memory), a grid that fills the card
// walking the tiles, so the copy is paid once a block. A tile inside one
// chunk whose index and output lie on 16 bytes (every tile but a chunk's
// edges, as a rule) moves two numbers a thread a load and a store, streaming
// (.cs), so the table keeps its place in L2; other tiles go number by number,
// each thread finding its chunk by a binary search over the starts. A
// concatenated table that fits the block's opt-in shared memory (29,056
// entries on an H100) is copied into shared memory by every block; a larger
// one (the format allows 2^25 entries a chunk) is read through the read-only
// path from L2.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;
constexpr int THREADS = 512;
constexpr int PAIRS = 4;                    // 16-byte pairs a thread moves a tile
constexpr int TILE = THREADS * PAIRS * 2;   // numbers a tile
constexpr int MAX_CHUNKS = 96;              // descriptors a launch: 3,840 bytes of its 4 KB of parameters
constexpr int MAX_DEVICES = 64;

// One chunk, rebased so that number e of the launch's joined index space
// reads src[e] and writes out[out + e].
struct Desc {
  u64 src;         // address of the chunk's index latents, less 8 * start
  long long start; // the chunk's first number in the joined index space
  long long out;   // the chunk's place in the output, less start
  long long toff;  // the chunk's first table entry
  u64 dmax;        // D - 1
};

struct Descs {
  Desc d[MAX_CHUNKS];
  int count;
};

__device__ __forceinline__ int chunk_of(const Descs& ds, long long e) {
  int lo = 0, hi = ds.count - 1;  // the last chunk whose start is <= e
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (ds.d[mid].start <= e) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

template <bool SMEM>
__device__ __forceinline__ u64 lookup(const u64* __restrict__ table, const u64* s_tab, u64 v, long long toff,
                                      u64 dmax) {
  u64 idx = v & 0xFFFFFFFFull;
  idx = (u64)toff + (idx < dmax ? idx : dmax);
  return SMEM ? s_tab[idx] : __ldg(table + idx);
}

__device__ __forceinline__ void load2_cs(const void* p, u64& a, u64& b) {
  asm volatile("ld.global.cs.v2.u64 {%0, %1}, [%2];" : "=l"(a), "=l"(b) : "l"(p));
}

__device__ __forceinline__ void store2_cs(void* p, u64 a, u64 b) {
  asm volatile("st.global.cs.v2.u64 [%0], {%1, %2};" ::"l"(p), "l"(a), "l"(b) : "memory");
}

template <bool SMEM>
__global__ void __launch_bounds__(THREADS) dict_join_kernel(const __grid_constant__ Descs ds,
                                                           const u64* __restrict__ table, long long n_table,
                                                           u64* __restrict__ out, long long n) {
  extern __shared__ u64 s_tab[];
  if (SMEM) {
    for (long long i = threadIdx.x; i < n_table; i += THREADS) s_tab[i] = table[i];
    __syncthreads();
  }
  for (long long base = (long long)blockIdx.x * TILE; base < n; base += (long long)gridDim.x * TILE) {
    int c = chunk_of(ds, base);  // the same for the whole block
    long long next = c + 1 < ds.count ? ds.d[c + 1].start : n;
    const u64 src_t = ds.d[c].src + 8ull * (u64)base;
    u64* out_t = out + ds.d[c].out + base;
    if (base + TILE <= next && ((src_t | (u64)out_t) & 15) == 0) {
      const long long toff = ds.d[c].toff;
      const u64 dmax = ds.d[c].dmax;
      u64 a[PAIRS], b[PAIRS];
#pragma unroll
      for (int k = 0; k < PAIRS; ++k) load2_cs((const char*)src_t + 16 * (k * THREADS + threadIdx.x), a[k], b[k]);
#pragma unroll
      for (int k = 0; k < PAIRS; ++k)
        store2_cs(out_t + 2 * (k * THREADS + threadIdx.x), lookup<SMEM>(table, s_tab, a[k], toff, dmax),
                  lookup<SMEM>(table, s_tab, b[k], toff, dmax));
      continue;
    }
    for (int k = 0; k < 2 * PAIRS; ++k) {
      const long long e = base + (long long)k * THREADS + threadIdx.x;
      if (e >= n) break;
      while (e >= next) {
        ++c;
        next = c + 1 < ds.count ? ds.d[c + 1].start : n;
      }
      const u64 v = __ldcs(reinterpret_cast<const u64*>(ds.d[c].src + 8ull * (u64)e));
      __stcs(out + ds.d[c].out + e, lookup<SMEM>(table, s_tab, v, ds.d[c].toff, ds.d[c].dmax));
    }
  }
}

struct DeviceInfo {
  bool ready = false;
  int sms = 0;
  int optin = 0;      // opt-in shared memory of a block, bytes
  int smem_sm = 0;    // shared memory of an SM, bytes
  int reserved = 0;   // shared memory the system keeps per block, bytes
  int blocks_sm = 0;  // blocks of the kernel an SM holds, registers and threads allowing
};

DeviceInfo g_info[MAX_DEVICES];

cudaError_t device_info(int device, const DeviceInfo** out) {
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  DeviceInfo& d = g_info[device];
  if (!d.ready) {
    cudaError_t err;
    if ((err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&d.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) != cudaSuccess)
      return err;
    if ((err = cudaDeviceGetAttribute(&d.smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device)) !=
        cudaSuccess)
      return err;
    if ((err = cudaDeviceGetAttribute(&d.reserved, cudaDevAttrReservedSharedMemoryPerBlock, device)) != cudaSuccess)
      return err;
    if ((err = cudaFuncSetAttribute(dict_join_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    d.optin)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&d.blocks_sm, dict_join_kernel<false>, THREADS, 0)) !=
        cudaSuccess)
      return err;
    if (d.blocks_sm < 1) d.blocks_sm = 1;
    d.ready = true;
  }
  *out = &d;
  return cudaSuccess;
}

cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
}

}  // namespace

// Largest concatenated table (entries) the shared-memory route takes on `device`.
extern "C" long long dict_join_smem_entries(int device) {
  const DeviceInfo* d = nullptr;
  if (use_device(device) != cudaSuccess || device_info(device, &d) != cudaSuccess) return 0;
  return d->optin / (long long)sizeof(u64);
}

// bases, numels: the n_bases int64 tensors the chunks read, as addresses and
// element counts. desc: n_chunks rows (base, start, n, output offset, table
// offset, D): chunk c reads elements [start, start + n) of its base. Chunks
// of no numbers are skipped. Every row is checked against its base, the
// output (n_out numbers) and the table (n_table entries). smem: the table in
// shared memory; walk: with smem, a grid that fills the card, each block
// walking tiles, else a block a tile. *launched gets the kernels launched.
extern "C" int dict_join(const u64* bases, const long long* numels, int n_bases, const long long* desc,
                         int n_chunks, const void* table, long long n_table, void* out, long long n_out, int smem,
                         int walk, int* launched, int device, void* stream) {
  *launched = 0;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const DeviceInfo* info = nullptr;
  if ((err = device_info(device, &info)) != cudaSuccess) return (int)err;
  if (n_chunks < 0 || n_table < 1 || (smem && n_table * (long long)sizeof(u64) > info->optin))
    return (int)cudaErrorInvalidValue;
  for (int c = 0; c < n_chunks; ++c) {
    const long long* r = desc + 6 * c;  // base, start, n, off, toff, D
    if (r[0] < 0 || r[0] >= n_bases || r[1] < 0 || r[2] < 0 || r[1] + r[2] > numels[r[0]] || r[3] < 0 ||
        r[3] + r[2] > n_out || r[5] < 1 || r[4] < 0 || r[4] + r[5] > n_table)
      return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  const size_t smem_bytes = smem ? (size_t)n_table * sizeof(u64) : 0;
  int per_sm = info->blocks_sm;
  if (smem) {
    const int by_smem = info->smem_sm / (int)(smem_bytes + info->reserved);
    per_sm = by_smem < per_sm ? by_smem : per_sm;
    if (per_sm < 1) per_sm = 1;
  }
  auto t = static_cast<const u64*>(table);
  auto o = static_cast<u64*>(out);
  Descs ds;
  int c = 0;
  while (c < n_chunks) {  // one launch for every MAX_CHUNKS chunks of numbers
    ds.count = 0;
    long long n = 0;
    for (; c < n_chunks && ds.count < MAX_CHUNKS; ++c) {
      const long long* r = desc + 6 * c;
      if (r[2] == 0) continue;
      Desc& d = ds.d[ds.count++];
      d.src = bases[r[0]] + 8ull * (u64)r[1] - 8ull * (u64)n;
      d.start = n;
      d.out = r[3] - n;
      d.toff = r[4];
      d.dmax = (u64)(r[5] - 1);
      n += r[2];
    }
    if (n == 0) break;
    const long long need = (n + TILE - 1) / TILE;
    const long long fill = smem && walk ? (long long)info->sms * per_sm : 0x7FFFFFFFLL;
    const unsigned grid = (unsigned)(need < fill ? need : fill);
    if (smem)
      dict_join_kernel<true><<<grid, THREADS, smem_bytes, s>>>(ds, t, n_table, o, n);
    else
      dict_join_kernel<false><<<grid, THREADS, 0, s>>>(ds, t, n_table, o, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ++*launched;
  }
  return 0;
}

extern "C" const char* pcodec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
