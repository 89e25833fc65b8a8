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
// steps: a step's choice feeds the next step's counts and repeat slots.
//
// What the design does about it: the hash tables depend on no choice (every
// position is inserted, after its own queries), so pages of at most
// SMEM_MAX_N numbers take them off the chain, as the JAX function does
// (:776-802). Two kernels a batch of pages:
//   pass 1, the hash reads: each coarseness's inserts (hash << POS_BITS |
//     position, position in [state_n, len)) sorted, by a warp in registers
//     (32 keys a lane) for pages of at most WARP_SORT_N numbers, else by a
//     block in shared memory; an insert's own bucket query is answered by
//     its neighbour in the sorted order, the others by binary search (the
//     last insert j < i with the query's hash; none: j = 0); each hash
//     slot's proposal (i - j within the window, else min(slot, i)) is
//     written as u16 to the wrapper's scratch, HASH_SLOTS rows a page, each
//     padded to PROP_ALIGN positions;
//   pass 2, the chain: a half-warp a page (CHAIN_PAGES pages a block of one
//     warp), the page's latents (as u32 when bits <= 32) and its u16 counts
//     staged in shared memory; lanes 10-15 stream their proposals in 16-byte
//     groups of 8 positions, a group ahead; a step is two shared-memory
//     loads a lane (x[i - lb], the count), the score, one full-warp
//     __reduce_max_sync for each half over the keys (goodness << 17 |
//     15 - slot << 13 | lookback: the first best and its lookback at once),
//     and a branch-free update: the winning lane bumps the count it loaded,
//     lane i % 16 keeps the choice, and every 16 positions the half stores
//     their lookbacks and toggled deltas coalesced.
// Longer pages keep both tables on the chain as open-address maps keyed by
// the masked hash, of cap >= 2m slots (linear probing, at most half full): a
// query finds its key's last position or an empty slot (the reference's
// zero), and the query of the bucket itself also finds the slot its insert
// writes, after the three queries, as the reference orders them. A slot packs
// key and position (position >= state_n >= 1, so 0 is empty); the maps and
// counts sit in device memory, `blocks` blocks walking the pages with a
// region of the wrapper's scratch each (positions past 2^16 in 64-bit slots),
// a warp a page.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;
using u32 = unsigned int;
using u16 = unsigned short;
constexpr int THREADS = 32;  // the device-memory route: a warp a page
constexpr unsigned FULL = 0xffffffffu;
// longest page of the two-pass route (its latents and counts in shared
// memory); must match pcodec_tpu_torch/ops/kernels.py
constexpr long long SMEM_MAX_N = 8192;
// longest page whose positions fit the 16 bits of a 32-bit slot
constexpr long long NARROW_MAX_N = 1 << 16;
constexpr int WINDOW_N_LOG_MAX = 15;  // the masked hash then fits 16 bits
constexpr int POS_BITS = 13;          // a position of a page of at most SMEM_MAX_N numbers
constexpr u32 POS_MASK = (1u << POS_BITS) - 1;
constexpr int HASH_SLOTS = 6;  // proposal slots 10-15; must match pcodec_tpu_torch/ops/device_train.py
constexpr int PROP_ALIGN = 8;  // positions of a 16-byte group of u16 proposals
constexpr int HASH_THREADS = 256;   // the block of a page of pass 1 past WARP_SORT_N numbers
constexpr int WARP_SORT_N = 1024;   // keys a warp sorts in registers, 32 a lane
constexpr int CHAIN_PAGES = 2;  // pages a block of the chain: a half-warp each

__device__ __forceinline__ u64 hash_u64(u64 x) {
  x = (x ^ (x >> 32)) * 11400714819323197441ull;
  return x ^ (x >> 32);
}

__host__ __device__ long long prop_stride(long long m) { return (m + PROP_ALIGN - 1) / PROP_ALIGN * PROP_ALIGN; }

__host__ __device__ long long pow2_at_least(long long m) {
  long long n = 1;
  while (n < m) n <<= 1;
  return n;
}

__host__ __device__ long long count_slots(long long m, int window_n_log) {
  return (1ll << window_n_log) < m ? (1ll << window_n_log) : m;
}

__host__ __device__ long long align16(long long b) { return (b + 15) / 16 * 16; }

// Shared memory of one page of the chain: its latents as L, then its counts.
long long chain_page_bytes(long long m, int bits, int window_n_log) {
  return align16(m * (bits <= 32 ? 4 : 8)) + align16(2 * count_slots(m, window_n_log));
}

// The six proposals of position i from its page's two sorted key halves
// (seg(c, e): key e of coarseness c's half, ascending; the last key of each
// half is a sentinel, position 0 < state_n being no insert, so the search's
// j stays in bounds).
template <int LOG_N, typename Seg, typename Same>
__device__ __forceinline__ void hash_queries(Seg seg, Same same, u64 v, long long i, u64 hmask, long long window_n,
                                             u16* out, long long stride) {
#pragma unroll
  for (int q = 0; q < HASH_SLOTS; ++q) {
    const int c = q < 3 ? 0 : 1;
    const u32 qh = (u32)(hash_u64((v >> (8 * c)) + (u64)(long long)(q % 3 - 1)) & hmask);
    const u32 key = qh << POS_BITS | (u32)i;
    long long pred = q % 3 == 1 ? same(c, i) : -1;  // the bucket's own query, where the sort answered it
    if (pred < 0) {
      int j = -1;  // the last key below the query's
#pragma unroll
      for (int s = 1 << (LOG_N - 1); s > 0; s >>= 1) {
        if (seg(c, j + s) < key) j += s;
      }
      pred = 0;
      if (j >= 0) {
        const u32 e = seg(c, j);
        if (e >> POS_BITS == qh) pred = e & POS_MASK;
      }
    }
    const long long lb_last = i - pred;
    out[q * stride + i] = (u16)(lb_last <= window_n ? lb_last : min((long long)(10 + q), i));
  }
}

__device__ __forceinline__ u32 insert_key(const u64* row, int e, int c, long long state_n, long long len,
                                          u64 hmask) {
  return e >= state_n && e < len ? (u32)(hash_u64(row[e] >> (8 * c)) & hmask) << POS_BITS | (u32)e : 0xffffffffu;
}

// Sorts a warp's WARP_SORT_N keys ascending in registers, key e = lane * 32
// + r in k[r]: stages whose partner is 32 or more keys away exchange
// through shuffles, the others inside the lane.
__device__ __forceinline__ void warp_sort(u32 (&k)[32], int lane) {
#pragma unroll
  for (int kk = 2; kk <= WARP_SORT_N; kk <<= 1) {
#pragma unroll
    for (int j = kk >> 1; j > 0; j >>= 1) {
      if (j >= 32) {
        const bool keep_min = (((lane << 5) & kk) == 0) == ((lane & (j >> 5)) == 0);
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          const u32 o = __shfl_xor_sync(FULL, k[r], j >> 5);
          k[r] = keep_min ? min(k[r], o) : max(k[r], o);
        }
      } else {
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          if (r & j) continue;
          const bool up = kk >= 32 ? ((lane << 5) & kk) == 0 : (r & kk) == 0;
          const u32 a = min(k[r], k[r | j]), b = max(k[r], k[r | j]);
          k[r] = up ? a : b;
          k[r | j] = up ? b : a;
        }
      }
    }
  }
}

// Pass 1, pages of at most WARP_SORT_N numbers: a block of two warps a
// page, warp c sorting coarseness 8c's keys in registers. An insert's own
// bucket query is answered by its neighbour in the sorted order; both warps
// then answer the other queries from the sorted halves in shared memory.
__global__ void __launch_bounds__(64)
    hash_reads_warp_kernel(const u64* __restrict__ x, const long long* __restrict__ lens, long long m,
                           int window_n_log, int state_n, long long page0, u16* __restrict__ props, long long stride) {
  __shared__ u32 keys[2][WARP_SORT_N + WARP_SORT_N / 32];  // key e at e + e / 32: conflict-free stores
  __shared__ u16 own[2][WARP_SORT_N];                      // an insert's own bucket query's answer
  const int lane = threadIdx.x & 31, c = threadIdx.x >> 5;
  const long long p = page0 + blockIdx.x;
  const u64* row = x + (size_t)p * m;
  const long long len = min(max(lens[p], 0ll), m);
  const u64 hmask = (2ull << window_n_log) - 1;
  u32 k[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) k[r] = insert_key(row, lane * 32 + r, c, state_n, len, hmask);
  warp_sort(k, lane);
  const u32 before = __shfl_up_sync(FULL, k[31], 1);
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    keys[c][lane * 33 + r] = k[r];
    const u32 pv = r ? k[r - 1] : lane ? before : 0xffffffffu;  // a sentinel's hash matches no insert's
    if (k[r] != 0xffffffffu) own[c][k[r] & POS_MASK] = pv >> POS_BITS == k[r] >> POS_BITS ? pv & POS_MASK : 0;
  }
  __syncthreads();
  u16* out = props + (size_t)blockIdx.x * HASH_SLOTS * stride;
  auto seg = [&](int cc, int e) { return keys[cc][e + (e >> 5)]; };
  auto same = [&](int cc, long long i) { return i >= state_n && i < len ? (long long)own[cc][i] : -1ll; };
  for (long long i = threadIdx.x; i < m; i += 64)
    hash_queries<10>(seg, same, row[i], i, hmask, 1ll << window_n_log, out, stride);
}

// Pass 1, longer pages: a block a page, both halves of n2 keys bitonic-sorted
// in shared memory by the whole block (pair t of a stage is (i, i | j)).
__global__ void __launch_bounds__(HASH_THREADS)
    hash_reads_kernel(const u64* __restrict__ x, const long long* __restrict__ lens, long long m, int log_n2,
                      int window_n_log, int state_n, long long page0, u16* __restrict__ props, long long stride) {
  extern __shared__ u32 skeys[];
  const int n2 = 1 << log_n2;
  const long long p = page0 + blockIdx.x;
  const u64* row = x + (size_t)p * m;
  const long long len = min(max(lens[p], 0ll), m);
  const u64 hmask = (2ull << window_n_log) - 1;
  for (int e = threadIdx.x; e < n2; e += HASH_THREADS) {
    skeys[e] = insert_key(row, e, 0, state_n, len, hmask);
    skeys[n2 + e] = insert_key(row, e, 1, state_n, len, hmask);
  }
  for (int kk = 2; kk <= n2; kk <<= 1) {
    for (int j = kk >> 1; j > 0; j >>= 1) {
      __syncthreads();
      for (int t = threadIdx.x; t < n2; t += HASH_THREADS) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const u32 a = skeys[i], b = skeys[i | j];
        const bool up = (i & (n2 - 1) & kk) == 0;
        skeys[i] = up ? min(a, b) : max(a, b);
        skeys[i | j] = up ? max(a, b) : min(a, b);
      }
    }
  }
  __syncthreads();
  u16* out = props + (size_t)blockIdx.x * HASH_SLOTS * stride;
  auto seg = [&](int cc, int e) { return skeys[cc * n2 + e]; };
  auto searched = [](int, long long) { return -1ll; };
  const long long window_n = 1ll << window_n_log;
  for (long long i = threadIdx.x; i < m; i += HASH_THREADS) {
    switch (log_n2) {  // the search unrolled for each half length (pages of WARP_SORT_N + 1 to SMEM_MAX_N)
      case 11: hash_queries<11>(seg, searched, row[i], i, hmask, window_n, out, stride); break;
      case 12: hash_queries<12>(seg, searched, row[i], i, hmask, window_n, out, stride); break;
      default: hash_queries<13>(seg, searched, row[i], i, hmask, window_n, out, stride); break;
    }
  }
}

// Pass 2. L: the latents' type in shared memory (u32 when bits <= 32).
template <typename L>
__global__ void __launch_bounds__(32)
    chain_kernel(const u64* __restrict__ x, const long long* __restrict__ lens, long long m, int bits,
                 int window_n_log, int state_n, long long page0, long long pages, const u16* __restrict__ props,
                 long long stride, long long page_smem, u32* __restrict__ lbs, u64* __restrict__ prim,
                 u64* __restrict__ states) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x, half = lane >> 4, t = lane & 15;
  const long long b = (long long)blockIdx.x * CHAIN_PAGES + half;  // page in the batch
  const bool page_ok = b < pages;
  const long long p = page0 + b;
  L* xs = reinterpret_cast<L*>(smem + half * page_smem);
  u16* cs = reinterpret_cast<u16*>(smem + half * page_smem + align16(m * (long long)sizeof(L)));
  const long long cnt_n = count_slots(m, window_n_log);
  const long long out_w = m - state_n;
  const long long len = page_ok ? min(max(lens[p], 0ll), m) : 0;
  const u64* row = x + (size_t)p * m;
  u64* prow = prim + (size_t)p * m;
  u32* lrow = lbs + (size_t)p * out_w;
  if (page_ok) {
    for (long long k = t; k < m; k += 16) {
      const u64 v = row[k];
      xs[k] = (L)v;
      if (k < state_n || k >= len) prow[k] = v;
    }
    for (long long k = t; k < cnt_n; k += 16) cs[k] = 1;
    for (int k = t; k < state_n; k += 16) states[(size_t)p * state_n + k] = row[k];
    for (long long k = max(len - state_n, 0ll) + t; k < out_w; k += 16) lrow[k] = 0;
  }
  __syncwarp();
  const int ilen = (int)len;
  const int iend = max(ilen, (int)__shfl_xor_sync(FULL, (unsigned)len, 16));
  const L mask = bits == 8 * (int)sizeof(L) ? ~L(0) : (L(1) << bits) - 1;
  const L mid = L(1) << (bits - 1);
  // lanes 10-15 stream their slot's proposals, a 16-byte group of 8
  // positions at a time, the next group in flight; the steps of a group are
  // unrolled, so each takes its proposal from a fixed 16 bits of the group
  const bool streams = page_ok && t >= 10;
  const uint4* grp =
      reinterpret_cast<const uint4*>(props + ((size_t)b * HASH_SLOTS + (t >= 10 ? t - 10 : 0)) * stride);
  const int n_grp = (int)(stride / PROP_ALIGN);
  const int g0 = state_n / PROP_ALIGN;
  uint4 cur = make_uint4(0, 0, 0, 0), nxt = cur;
  if (streams) nxt = grp[g0];
  u32 prop = (u32)min(t + 1, state_n);  // this lane's proposal slot
  u32 best_lb = 1, rep = 0;
  u32 mine = 0;  // the choice at position i with i % 16 == t, stored 16 positions at a time
  for (int g = g0; g * PROP_ALIGN < iend; ++g) {
    cur = nxt;
    if (streams && g + 1 < n_grp) nxt = grp[g + 1];
    const u32 gw[4] = {cur.x, cur.y, cur.z, cur.w};
#pragma unroll
    for (int e = 0; e < PROP_ALIGN; ++e) {
      const int i = g * PROP_ALIGN + e;
      if (i < state_n || i >= iend) continue;  // the same for the whole warp
      const u32 nb = (u32)min(i, 16);
      prop = t >= 10 ? (gw[e >> 1] >> (16 * (e & 1))) & 0xffffu : (u32)t == nb - 1 ? nb : prop;
      // the repeat slot a new choice fills, whether or not the choice moves
      const u32 same_slot = 6 + (rep & 3), moved_slot = 6 + ((rep + 1) & 3);
      const u32 lb = min(max(prop, 1u), (u32)i);
      const L l = xs[i], other = xs[i - lb];
      const u32 cnt = cs[lb - 1];
      const L d1 = (L)(l - other) & mask, d2 = (L)(other - l) & mask;
      const L dd = d1 < d2 ? d1 : d2;
      const int dbits = sizeof(L) == 8 ? 64 - __clzll((long long)dd) : 32 - __clz((int)dd);
      const u32 good = (u32)((32 - __clz((int)cnt)) + bits - dbits);
      const u32 key = good << (POS_BITS + 4) | (u32)(15 - t) << POS_BITS | lb;
      // the first best of each half-warp: a full-warp reduction a half (a
      // mask of one half would take the divergent path)
      const u32 k0 = __reduce_max_sync(FULL, half ? 0u : key), k1 = __reduce_max_sync(FULL, half ? key : 0u);
      const u32 kmax = half ? k1 : k0, best = kmax & POS_MASK;
      const bool active = i < ilen, moved = best != best_lb;
      rep += active && moved;
      prop = active && (u32)t == (moved ? moved_slot : same_slot) ? best : prop;
      best_lb = active ? best : best_lb;
      if (active && key == kmax) cs[lb - 1] = (u16)(cnt + 1);
      if ((i & 15) == t) mine = best;
      if ((i & 15) == 15 || i == iend - 1) {  // the lookbacks and toggled deltas of positions i & ~15 .. i
        const int k = (i & ~15) + t;
        if (k >= state_n && k <= i && k < ilen) {
          lrow[k - state_n] = mine;
          prow[k] = (u64)((L)((L)(xs[k] - xs[k - mine]) + mid) & mask);
        }
      }
      __syncwarp();
    }
  }
}

// The device-memory route (pages over SMEM_MAX_N numbers): the maps on the
// chain, a warp a page.
template <typename Slot>
__global__ void __launch_bounds__(THREADS)
    map_chain_kernel(const u64* __restrict__ x, const long long* __restrict__ lens, int lanes, long long m,
                     int bits, int window_n_log, int state_n, long long cap, long long cnt_n,
                     u32* __restrict__ lbs, u64* __restrict__ prim, u64* __restrict__ states,
                     unsigned char* __restrict__ scratch, long long scratch_per_block) {
  constexpr int VBITS = sizeof(Slot) * 4;  // the position's bits in a slot, the key above them
  unsigned char* base = scratch + (size_t)blockIdx.x * scratch_per_block;
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

template <typename L>
cudaError_t chain_optin(int bytes) {
  cudaError_t err = cudaFuncSetAttribute(chain_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(chain_kernel<L>, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

int optin_bytes(int device) {  // the opt-in shared memory of a block, set once a process for each device
  static int optin[64] = {0};
  if (device < 0 || device >= 64) return -(int)cudaErrorInvalidDevice;
  if (!optin[device]) {
    int bytes = 0;
    cudaError_t err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess) err = cudaFuncSetAttribute(hash_reads_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) err = chain_optin<u32>(bytes);
    if (err == cudaSuccess) err = chain_optin<u64>(bytes);
    if (err != cudaSuccess) return -(int)err;
    optin[device] = bytes;
  }
  return optin[device];
}

}  // namespace

// Scratch bytes of one page: its HASH_SLOTS rows of u16 proposals (m <=
// SMEM_MAX_N), or its maps and counts (longer pages; a region of each of
// `blocks` blocks).
extern "C" long long lookback_choose_page_bytes(long long m, int window_n_log) {
  if (m <= SMEM_MAX_N) return HASH_SLOTS * prop_stride(m) * 2;
  const long long slot = m <= NARROW_MAX_N ? 4 : 8;
  return align16(2 * slots_of(m) * slot + 4 * count_slots(m, window_n_log));
}

// Pages of m numbers the chain kernel holds on an SM at once (m <=
// SMEM_MAX_N), or a negative CUDA error.
extern "C" int lookback_choose_resident_pages(long long m, int bits, int window_n_log, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  const int optin = optin_bytes(device);
  if (optin < 0) return optin;
  const size_t smem = (size_t)(CHAIN_PAGES * chain_page_bytes(m, bits, window_n_log));
  int blocks = 0;
  err = bits <= 32 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, chain_kernel<u32>, 32, smem)
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, chain_kernel<u64>, 32, smem);
  return err != cudaSuccess ? -(int)err : blocks * CHAIN_PAGES;
}

// The scratch holds `blocks` regions of scratch_per_block >=
// lookback_choose_page_bytes bytes: the proposals of a batch of `blocks`
// pages (the batches walked in turn, the hash reads then the chain), or each
// longer-page block's maps.
extern "C" int lookback_choose(const void* x, const void* lens, int lanes, long long m, int bits, int window_n_log,
                               int state_n, void* lbs, void* prim, void* states, void* scratch,
                               long long scratch_per_block, int blocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (lanes < 0 || m < 1 || state_n < 1 || state_n >= m || (bits != 8 && bits != 16 && bits != 32 && bits != 64) ||
      window_n_log < 4 || window_n_log > WINDOW_N_LOG_MAX)
    return (int)cudaErrorInvalidValue;
  if (lanes == 0) return 0;
  const int optin = optin_bytes(device);
  if (optin < 0) return -optin;
  const long long need = lookback_choose_page_bytes(m, window_n_log);
  if (blocks < 1 || scratch == nullptr || scratch_per_block < need) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const u64*>(x);
  const auto* lp = static_cast<const long long*>(lens);
  if (m <= SMEM_MAX_N) {
    const long long n2 = pow2_at_least(m);
    const long long page_smem = chain_page_bytes(m, bits, window_n_log);
    int log_n2 = 0;
    while ((1ll << log_n2) < n2) ++log_n2;
    if (2 * n2 * 4 > optin || CHAIN_PAGES * page_smem > optin) return (int)cudaErrorInvalidValue;
    const long long stride = prop_stride(m);  // a row of u16 proposals, HASH_SLOTS rows a page
    auto* props = static_cast<u16*>(scratch);
    for (long long page0 = 0; page0 < lanes; page0 += blocks) {
      const long long pages = lanes - page0 < blocks ? lanes - page0 : blocks;
      if (m <= WARP_SORT_N)
        hash_reads_warp_kernel<<<(unsigned)pages, 64, 0, s>>>(xp, lp, m, window_n_log, state_n, page0, props,
                                                             stride);
      else
        hash_reads_kernel<<<(unsigned)pages, HASH_THREADS, (size_t)(2 * n2 * 4), s>>>(
            xp, lp, m, log_n2, window_n_log, state_n, page0, props, stride);
      const unsigned grid = (unsigned)((pages + CHAIN_PAGES - 1) / CHAIN_PAGES);
      const size_t smem = (size_t)(CHAIN_PAGES * page_smem);
      if (bits <= 32)
        chain_kernel<u32><<<grid, 32, smem, s>>>(xp, lp, m, bits, window_n_log, state_n, page0, pages, props,
                                                 stride, page_smem, static_cast<u32*>(lbs), static_cast<u64*>(prim),
                                                 static_cast<u64*>(states));
      else
        chain_kernel<u64><<<grid, 32, smem, s>>>(xp, lp, m, bits, window_n_log, state_n, page0, pages, props,
                                                 stride, page_smem, static_cast<u32*>(lbs), static_cast<u64*>(prim),
                                                 static_cast<u64*>(states));
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    return 0;
  }
  const long long cap = slots_of(m);
  const int grid = blocks < lanes ? blocks : lanes;
  auto launch = [&](auto kernel) {
    kernel<<<grid, THREADS, 0, s>>>(xp, lp, lanes, m, bits, window_n_log, state_n, cap,
                                    count_slots(m, window_n_log), static_cast<u32*>(lbs), static_cast<u64*>(prim),
                                    static_cast<u64*>(states), static_cast<unsigned char*>(scratch),
                                    scratch_per_block);
  };
  if (m <= NARROW_MAX_N) {
    launch(map_chain_kernel<u32>);
  } else {
    launch(map_chain_kernel<u64>);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* pcodec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
