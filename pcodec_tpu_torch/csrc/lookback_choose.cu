// B5 lookback_choose: the lookback delta's 16-candidate chooser of the
// encoder's training, with the chunk's stored rows written in the same pass.
//
// Replaces: pcodec_tpu/ops/device_train.py::_choose_lookbacks_device (an XLA
// lax.scan over a page's positions, not a Pallas kernel) and the store of
// _phase_lookback (:1180-1202). It computes what the native chooser computes
// (delta/lookback.rs:101-164): per position i of a page, 16 proposed
// lookbacks (the brute slot min(i, 16), four repeating slots holding the
// last distinct choices, six hash slots: for coarseness 0 and 8 the last
// position whose value bucket hashed like bucket - 1, bucket and bucket + 1),
// each scored bitlen(count of its past choices) + bits - bitlen(min(|x[i] -
// x[i - lb]| both ways)); the first best wins. Lanes are pages: each page
// chooses on its own, from zeroed tables.
//
// Outputs of one call over `lanes` page rows of m latents (u64 bits):
//   lbs     (lanes, m - state_n) u32: the lookbacks, 0 past len - state_n
//   prim    (lanes, m) u64: the toggled deltas ((x[i] - x[i - lb]) +
//           2^(bits-1)) mod 2^bits on the page's body [state_n, len), the
//           latents as they are elsewhere (the state_n front, the padding)
//   states  (lanes, state_n) u64: the page's front latents, its delta state
//
// What bounds it on Hopper: neither bytes (8 bytes read, 12 written a
// number) nor operations, but the page's chain of len - state_n dependent
// steps: a step's proposals read the counts and the hash tables its
// predecessor updated.
//
// What the design does about it: a warp a page, its 16 low lanes a proposal
// each, so a step's 16 scores are one round of loads and arithmetic; lanes
// 10-15 form the six hash queries; the first best is one __reduce_max_sync
// over (goodness << 4 | 15 - slot) and two shuffles. The reference's hash
// tables have 2^(window_n_log + 1) slots (65,536 at window_n_log 15), too
// large for a page's shared memory; a page inserts at most m keys, so each
// table is an open-address map keyed by the masked hash, of cap >= 2m slots
// (linear probing, at most half full): a query finds its key's last
// position or an empty slot (the reference's zero), and the query of the
// bucket itself also finds the slot its insert writes, after the three
// queries, as the reference orders them. A slot packs key and position
// (position >= state_n >= 1, so 0 is empty). Pages of at most SMEM_MAX_N
// numbers keep both maps and the counts in shared memory (a block a page);
// longer pages keep them in device memory, `blocks` blocks walking the pages
// with a region of the wrapper's scratch each (positions past 2^16 in 64-bit
// slots). Simple and right first: the speed of the dependent chain is a
// later change's.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;
using u32 = unsigned int;
constexpr int THREADS = 32;
constexpr unsigned FULL = 0xffffffffu;
// longest page whose maps and counts sit in shared memory; must match
// pcodec_tpu_torch/ops/kernels.py
constexpr long long SMEM_MAX_N = 8192;
// longest page whose positions fit the 16 bits of a 32-bit slot
constexpr long long NARROW_MAX_N = 1 << 16;
constexpr int WINDOW_N_LOG_MAX = 15;  // the masked hash then fits 16 bits

__device__ __forceinline__ u64 hash_u64(u64 x) {
  x = (x ^ (x >> 32)) * 11400714819323197441ull;
  return x ^ (x >> 32);
}

template <typename Slot, bool SMEM>
__global__ void __launch_bounds__(THREADS)
    lookback_choose_kernel(const u64* __restrict__ x, const long long* __restrict__ lens, int lanes, long long m,
                           int bits, int window_n_log, int state_n, long long cap, long long cnt_n,
                           u32* __restrict__ lbs, u64* __restrict__ prim, u64* __restrict__ states,
                           unsigned char* __restrict__ scratch, long long scratch_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int VBITS = sizeof(Slot) * 4;  // the position's bits in a slot, the key above them
  unsigned char* base = SMEM ? smem : scratch + (size_t)blockIdx.x * scratch_per_block;
  Slot* tab = reinterpret_cast<Slot*>(base);  // 2 * cap slots: coarseness 0, then 8
  u32* counts = reinterpret_cast<u32*>(base + 2 * cap * sizeof(Slot));
  const int t = threadIdx.x;
  const u64 mask = bits == 64 ? ~0ull : (1ull << bits) - 1;
  const u64 mid = 1ull << (bits - 1);
  const u64 hmask = (2ull << window_n_log) - 1;
  const long long window_n = 1ll << window_n_log;
  const long long out_w = m - state_n;
  // lanes 10-12 query coarseness 0's map, 13-15 coarseness 8's; 11 and 14
  // (the bucket itself) insert
  Slot* my_tab = tab + (t < 13 ? 0 : cap);
  for (int p = blockIdx.x; p < lanes; p += gridDim.x) {
    const u64* row = x + (size_t)p * m;
    u64* prow = prim + (size_t)p * m;
    u32* lrow = lbs + (size_t)p * out_w;
    const long long len = min(max(lens[p], 0ll), m);
    for (long long k = t; k < 2 * cap; k += THREADS) tab[k] = 0;
    for (long long k = t; k < cnt_n; k += THREADS) counts[k] = 1;
    for (int k = t; k < state_n; k += THREADS) states[(size_t)p * state_n + k] = row[k];
    for (long long k = t; k < m; k += THREADS) {
      if (k < state_n || k >= len) prow[k] = row[k];
    }
    for (long long k = max(len - state_n, 0ll) + t; k < out_w; k += THREADS) lrow[k] = 0;
    __syncwarp();
    long long prop = min((long long)t + 1, (long long)state_n);  // this lane's proposal slot
    long long best_lb = 1;
    unsigned rep = 0;
    for (long long i = state_n; i < len; ++i) {
      const u64 l = row[i];
      const long long nb = min(i, 16ll);
      if (t == nb - 1) prop = nb;
      u32 hkey = 0;
      long long hslot = 0;
      if (t >= 10 && t < 16) {
        const int k = t - 10;
        const u64 bucket = (l >> (k < 3 ? 0 : 8)) + (u64)(long long)(k % 3 - 1);
        hkey = (u32)(hash_u64(bucket) & hmask);
        long long s = hkey & (cap - 1);
        long long v = 0;
        while (true) {
          const Slot e = my_tab[s];
          if (e == 0) break;
          if ((u32)(e >> VBITS) == hkey) {
            v = (long long)(e & ((Slot(1) << VBITS) - 1));
            break;
          }
          s = (s + 1) & (cap - 1);
        }
        hslot = s;
        const long long lb_last = i - v;
        prop = lb_last <= window_n ? lb_last : min((long long)t, i);
      }
      __syncwarp();
      if (t == 11 || t == 14) my_tab[hslot] = (Slot(hkey) << VBITS) | (Slot)i;
      const long long lb = min(max(prop, 1ll), max(i, 1ll));
      const u32 cnt = counts[lb - 1];
      const u64 other = row[i - lb];
      const u64 d1 = (l - other) & mask, d2 = (other - l) & mask;
      const u64 dd = d1 < d2 ? d1 : d2;
      const int good = (32 - __clz(cnt)) + bits - (64 - __clzll(dd));
      const unsigned key = t < 16 ? ((unsigned)good << 4) | (unsigned)(15 - t) : 0u;
      const int ks = 15 - (int)(__reduce_max_sync(FULL, key) & 15);
      const long long best = __shfl_sync(FULL, lb, ks);
      const u64 dbest = __shfl_sync(FULL, d1, ks);
      if (best != best_lb) ++rep;
      if (t == 6 + (int)(rep & 3)) prop = best;
      best_lb = best;
      if (t == 0) {
        counts[best - 1] += 1;
        lrow[i - state_n] = (u32)best;
        prow[i] = (dbest + mid) & mask;
      }
      __syncwarp();
    }
  }
}

long long slots_of(long long m) {
  long long cap = 1;
  while (cap < 2 * m) cap <<= 1;
  return cap;
}

}  // namespace

// Bytes of one page's maps and counts: the dynamic shared memory of a block
// (m <= SMEM_MAX_N) or the scratch region of each of `blocks` blocks.
extern "C" long long lookback_choose_page_bytes(long long m, int window_n_log) {
  const long long slot = m <= NARROW_MAX_N ? 4 : 8;
  const long long cnt_n = (1ll << window_n_log) < m ? (1ll << window_n_log) : m;
  return (2 * slots_of(m) * slot + 4 * cnt_n + 15) / 16 * 16;
}

extern "C" int lookback_choose(const void* x, const void* lens, int lanes, long long m, int bits, int window_n_log,
                               int state_n, void* lbs, void* prim, void* states, void* scratch,
                               long long scratch_per_block, int blocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (lanes < 0 || m < 1 || state_n < 1 || state_n >= m || (bits != 8 && bits != 16 && bits != 32 && bits != 64) ||
      window_n_log < 4 || window_n_log > WINDOW_N_LOG_MAX)
    return (int)cudaErrorInvalidValue;
  if (lanes == 0) return 0;
  static int optin[64] = {0};  // set once a process for each device
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!optin[device]) {
    int bytes = 0;
    err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(lookback_choose_kernel<u32, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return (int)err;
    optin[device] = bytes;
  }
  const long long cap = slots_of(m);
  const long long cnt_n = (1ll << window_n_log) < m ? (1ll << window_n_log) : m;
  const long long need = lookback_choose_page_bytes(m, window_n_log);
  auto s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel, int grid, size_t smem_bytes) {
    kernel<<<grid, THREADS, smem_bytes, s>>>(
        static_cast<const u64*>(x), static_cast<const long long*>(lens), lanes, m, bits, window_n_log, state_n,
        cap, cnt_n, static_cast<u32*>(lbs), static_cast<u64*>(prim), static_cast<u64*>(states),
        static_cast<unsigned char*>(scratch), scratch_per_block);
  };
  if (m <= SMEM_MAX_N) {
    if (need > optin[device]) return (int)cudaErrorInvalidValue;
    launch(lookback_choose_kernel<u32, true>, lanes, (size_t)need);
  } else {
    if (blocks < 1 || scratch == nullptr || scratch_per_block < need) return (int)cudaErrorInvalidValue;
    const int grid = blocks < lanes ? blocks : lanes;
    if (m <= NARROW_MAX_N) {
      launch(lookback_choose_kernel<u32, false>, grid, 0);
    } else {
      launch(lookback_choose_kernel<u64, false>, grid, 0);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" const char* pcodec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
