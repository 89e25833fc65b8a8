// K3 lookback_recon: lookback delta reconstruction by pointer doubling, for
// every lookback var of a container in one launch, the Classic join folded
// into the store; and B7 (lb_tiles_kernel), the pages longer than K3's
// shared memory, every one of a container in one launch.
//
// Replaces: pcodec_tpu/ops/pallas_decode.py::_lb_recon_kernel_body (launched
// by _lookback_decode_pages_pallas once per chunk), the TPU kernel that runs
// the doubling rounds over (R, 128) sublane planes with lane-gather select
// trees, u64 as i32 pairs with a hand carry, after an XLA prologue that
// builds the initial sums and pointers in device memory; and the per-chunk
// XLA trim, Classic join and concatenation after it. B7 replaces the flat
// branch of _reconstruct_var (pallas_decode.py:1354-1368,
// pcodec_tpu/ops/decode.py::_lookback_decode: the same rounds as XLA
// gathers over a whole standalone chunk) and its Pallas branch on pages
// past a block's memory.
//
// The recurrence, on each page of N numbers: position p < state_n is the
// page's stored state; after it value[p] = (latent[p - state_n] + mid) +
// value[p - lb], lb the `delta` var's latent at p - state_n clipped to [1,
// window_n], a pointer before the page start meaning the zero prefill (-1).
// Pointer doubling resolves it in bit_length(max(N - 1, 1)) synchronous
// rounds: add += add[ptr], ptr = ptr[ptr] where ptr >= 0.
//
// One descriptor row (DESC_COLS int64, fixed by the host plan and uploaded
// once) describes one lookback var of one chunk: where its latents, its
// lookbacks (a base tensor and a start, or a constant for a trivial var),
// its stored state and its output lie; its pages, page length, count of
// valid numbers (a ragged last page), state_n, window_n and latent bits; a
// join kind; and its first page in the launch's pages. A Classic chunk's
// row stores memory bits (the latent -> memory bijection of its number type,
// unsigned, signed or float) straight into the container's output at the
// chunk's offset; other rows store the latents for the mode's join.
//
// What bounds it on Hopper: bytes. Each number reads 8 bytes of latent and
// 8 of lookback and writes 8 bytes; the rounds are gathers inside one page,
// cheap once the page is on chip. A container of 1M-number chunks decoded a
// chunk a launch, its join in torch ops after each, was bound by the host's
// enqueue of those launches, not by the card.
//
// What the design does about it: one launch for every lookback var of the
// container whose pages fit shared memory, a block a page, each block
// finding its row by a binary search over the rows' first pages. The page
// is loaded with 16-byte loads with the prologue folded in (read once,
// written once), a thread's loads (up to LOAD_PAIRS pairs) all in flight
// before the first is used. Blocks of K3_THREADS threads (several
// positions a thread) keep more independent gathers in flight and cost
// less a barrier than a 1,024-thread block a page. Each thread keeps the
// sums and pointers of the positions it owns in registers: a round gathers
// add[ptr] and ptr[ptr] from shared memory for each of them that has a
// pointer, the block synchronises, then each position that moved is
// written back; the rounds stop once no pointer is left
// (__syncthreads_or), which changes no result. Positions past a ragged
// last page's valid numbers are neither reconstructed nor stored: no valid
// position points past itself. Pages of up to 16,384 numbers (192 KB) run
// this way.
//
// B7 cuts each longer page into tiles of 16,384 and runs the same
// prologue and rounds on each tile, a pointer before the tile left as it
// is; a tile then waits for the page's earlier tiles and adds the final
// value its pointer names (lb_tiles_kernel). Each number is read once (16
// bytes), written once (8) and, where its pointer left the tile, reads one
// final value (8): one pass where the rounds in device memory took one a
// round.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_EPT = 16;
constexpr int LOAD_PAIRS = 4;  // 16-byte pairs of latents and of lookbacks a thread loads at once
constexpr long long SMEM_MAX_N = (long long)MAX_THREADS * MAX_EPT;  // must match ops/kernels.py
constexpr long long MAX_PAGE_N = (long long)1 << 30;  // longest page B7 takes: its pointers are int
constexpr size_t TILE_SMEM = SMEM_MAX_N * (sizeof(unsigned long long) + sizeof(int));  // B7's dynamic shared memory
constexpr int DESC_COLS = 16;  // must match ops/container_decode.py
constexpr int MAX_BASES = 68;  // every page length <= SMEM_MAX_N (64), the output, the scratch, the state
constexpr int MAX_DEVICES = 64;
// join kinds (must match ops/decode.py): latents out, or memory bits of an
// unsigned, signed or float number
constexpr int JOIN_LATENTS = 0;
constexpr int JOIN_UNSIGNED = 1;
constexpr int JOIN_SIGNED = 2;
constexpr int JOIN_FLOAT = 3;

// descriptor columns
enum Col {
  LAT_BASE, LAT_START, LB_BASE, LB_START, MOM_BASE, MOM_START, OUT_BASE, OUT_START,
  N_PAGES, PAGE_N, N_VALID, STATE_N, WINDOW_N, BITS, JOIN, PAGE0
};

struct Bases {
  u64 p[MAX_BASES];  // addresses of the int64 tensors the rows name
};

__device__ __forceinline__ u64 join_bits(u64 v, int join, int bits) {
  if (join == JOIN_LATENTS) return v;
  const u64 mask = bits >= 64 ? ~0ull : (1ull << bits) - 1;
  const u64 mid = 1ull << (bits - 1);
  v &= mask;
  if (join == JOIN_UNSIGNED) return v;
  if (join == JOIN_SIGNED) return (v ^ mid) & mask;
  return (v & mid) ? (v ^ mid) : (~v & mask);  // JOIN_FLOAT
}

// numbers k and k + 1 (< n) of a page's latents or lookbacks: a constant,
// a 16-byte load where the page lies on 16 bytes, else one or two loads
__device__ __forceinline__ void load_pair(const u64* src, bool is_const, u64 c, int k, int n, bool vec, u64 out[2]) {
  out[0] = out[1] = c;
  if (is_const || k >= n) return;
  if (vec && k + 1 < n) {
    const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(src + k);
    out[0] = v.x;
    out[1] = v.y;
  } else {
    out[0] = src[k];
    if (k + 1 < n) out[1] = src[k + 1];
  }
}

// The row whose first page is the last at or before launch page g: a
// binary search over the rows' first pages.
__device__ __forceinline__ const long long* row_of(const long long* desc, int n_rows, long long g) {
  int lo = 0, hi = n_rows - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (desc[(long long)mid * DESC_COLS + PAGE0] <= g) lo = mid;
    else hi = mid - 1;
  }
  return desc + (long long)lo * DESC_COLS;
}

// One page of a row: its latents and lookbacks from the page's first
// number (or a trivial var's constant), its stored state and its output.
struct PageRefs {
  const u64* lat;
  const long long* lb;
  const u64* mom;
  u64* out;
  u64 lat_c, lb_c;  // a trivial var's constant
  bool lat_const, lb_const;
  int N;  // valid positions of the page
  int s;  // positions of the stored state, min(state_n, N)
  long long window_n;
  u64 mid;
};

__device__ __forceinline__ PageRefs page_refs(const Bases& bs, const long long* d, long long page, int N) {
  const long long first = page * d[PAGE_N];
  const int state_n = (int)d[STATE_N];
  PageRefs a;
  a.lat_const = d[LAT_BASE] < 0;
  a.lb_const = d[LB_BASE] < 0;
  a.lat_c = (u64)d[LAT_START];
  a.lb_c = (u64)d[LB_START];
  a.lat = a.lat_const ? nullptr : reinterpret_cast<const u64*>(bs.p[d[LAT_BASE]]) + d[LAT_START] + first;
  a.lb = a.lb_const ? nullptr : reinterpret_cast<const long long*>(bs.p[d[LB_BASE]]) + d[LB_START] + first;
  a.mom = reinterpret_cast<const u64*>(bs.p[d[MOM_BASE]]) + d[MOM_START] + page * state_n;
  a.out = reinterpret_cast<u64*>(bs.p[d[OUT_BASE]]) + d[OUT_START] + first;
  a.N = N;
  a.s = state_n < N ? state_n : N;
  a.window_n = d[WINDOW_N];
  a.mid = 1ull << ((int)d[BITS] - 1);
  return a;
}

// Positions of the stored state among a tile's: the tile [t0, t0 + L) of
// a page whose first s positions are its state.
__device__ __forceinline__ int tile_state(const PageRefs& a, long long t0, int L) {
  const long long s = a.s - t0;
  return s <= 0 ? 0 : (s < L ? (int)s : L);
}

// The doubling of one tile, positions [t0, t0 + L) of a page (K3's page is
// one tile at t0 = 0). The prologue: the tile's stored state, then (latent
// + mid, pointer) of its latent positions s_t + k the thread owns, k = 2 *
// (tid + q * T) + h, kept in registers and shared; up to LOAD_PAIRS pairs
// of loads of a thread in flight before the first is used. A pointer is a
// tile index, -1 for the zero prefill (or a stored state), or -2 - q for a
// page position q before the tile: terminal, neither followed nor doubled.
// The rounds: each owned position with a pointer gathers add[ptr] and
// ptr[ptr] into its registers; after the barrier, those that moved are
// shared. After bit_length(L - 1) rounds (fewer once no pointer moved)
// every pointer is -1 or terminal.
template <int EPT>
__device__ __forceinline__ void tile_rounds(const PageRefs& a, long long t0, int L, u64* s_add, int* s_ptr,
                                            u64 (&own_add)[(EPT + 1) / 2][2], int (&own_ptr)[(EPT + 1) / 2][2]) {
  constexpr int PAIRS = (EPT + 1) / 2;
  constexpr int GROUP = PAIRS < LOAD_PAIRS ? PAIRS : LOAD_PAIRS;
  const int T = blockDim.x;
  const int s = tile_state(a, t0, L);
  const int n_lat = L - s;
  const long long k0 = t0 + s - a.s;  // the tile's first latent in the page's
  const u64* lat = a.lat_const ? nullptr : a.lat + k0;
  const long long* lb = a.lb_const ? nullptr : a.lb + k0;
  const bool vec = ((reinterpret_cast<u64>(lat) | reinterpret_cast<u64>(lb)) & 15) == 0;
#pragma unroll
  for (int q0 = 0; q0 < PAIRS; q0 += GROUP) {
    u64 x[GROUP][2], y[GROUP][2];
#pragma unroll
    for (int q = 0; q < GROUP; ++q) {
      const int k = 2 * (threadIdx.x + (q0 + q) * T);
      load_pair(lat, a.lat_const, a.lat_c, k, n_lat, vec, x[q]);
      load_pair(reinterpret_cast<const u64*>(lb), a.lb_const, a.lb_c, k, n_lat, vec, y[q]);
    }
    if (q0 == 0) {
      for (int i = threadIdx.x; i < s; i += T) {
        s_add[i] = a.mom[t0 + i];
        s_ptr[i] = -1;
      }
    }
#pragma unroll
    for (int q = 0; q < GROUP; ++q) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 2 * (threadIdx.x + (q0 + q) * T) + h;
        const long long lbk = (long long)y[q][h];
        const long long step = lbk < 1 ? 1 : (lbk > a.window_n ? a.window_n : lbk);
        const long long p = t0 + s + k - step;  // a page position
        own_add[q0 + q][h] = x[q][h] + a.mid;
        own_ptr[q0 + q][h] = k >= n_lat || p < 0 ? -1 : (p < t0 ? (int)(-2 - p) : (int)(p - t0));
        if (k < n_lat) {
          s_add[s + k] = own_add[q0 + q][h];
          s_ptr[s + k] = own_ptr[q0 + q][h];
        }
      }
    }
  }
  __syncthreads();

  const int rounds = 32 - __clz(L - 1 > 1 ? L - 1 : 1);
  for (int r = 0; r < rounds; ++r) {
    unsigned moved = 0;
#pragma unroll
    for (int q = 0; q < PAIRS; ++q) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = own_ptr[q][h];
        if (p >= 0) {
          own_add[q][h] += s_add[p];
          own_ptr[q][h] = s_ptr[p];
          moved |= 1u << (2 * q + h);
        }
      }
    }
    if (!__syncthreads_or(moved != 0)) break;  // every pointer resolved: later rounds change nothing
#pragma unroll
    for (int q = 0; q < PAIRS; ++q) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (moved >> (2 * q + h) & 1) {
          const int k = 2 * (threadIdx.x + q * T) + h;
          s_add[s + k] = own_add[q][h];
          s_ptr[s + k] = own_ptr[q][h];
        }
      }
    }
    __syncthreads();
  }
}

// K3: a block a page, the page one tile in shared memory, its numbers
// stored through the row's join.
template <int EPT>
__global__ void __launch_bounds__(MAX_THREADS) lb_chunks_kernel(const __grid_constant__ Bases bs,
                                                                const long long* __restrict__ desc, int n_rows) {
  extern __shared__ u64 smem[];
  const long long g = blockIdx.x;
  const long long* d = row_of(desc, n_rows, g);
  const long long page = g - d[PAGE0];
  const long long page_n = d[PAGE_N];
  const long long rest = d[N_VALID] - page * page_n;
  if (rest <= 0) return;
  const PageRefs a = page_refs(bs, d, page, (int)(rest < page_n ? rest : page_n));
  constexpr int PAIRS = (EPT + 1) / 2;
  u64 own_add[PAIRS][2];
  int own_ptr[PAIRS][2];
  u64* s_add = smem;
  tile_rounds<EPT>(a, 0, a.N, s_add, reinterpret_cast<int*>(smem + page_n), own_add, own_ptr);
  const int T = blockDim.x;
  const int s = a.s, n_lat = a.N - a.s;
  const int join = (int)d[JOIN];
  const int bits = (int)d[BITS];
  for (int i = threadIdx.x; i < s; i += T) __stcs(a.out + i, join_bits(s_add[i], join, bits));
#pragma unroll
  for (int q = 0; q < PAIRS; ++q) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 2 * (threadIdx.x + q * T) + h;
      if (k < n_lat) __stcs(a.out + s + k, join_bits(own_add[q][h], join, bits));
    }
  }
}

// B7: the pages longer than a block's shared memory, cut into tiles of
// SMEM_MAX_N positions, every tile of every row in one launch. A block
// takes ticket t from sync[0] (zeroed before the launch): tile t / pages
// of launch page t % pages, so tickets run tile-major across the pages.
// It runs the tile's doubling in shared memory, then waits until the
// page's previous tile has published (sync[1 + t - pages]), which that
// tile does only once its own previous tile had: every position before
// the tile is final in the output. Each terminal pointer then adds its
// position's final value, the tile is stored, fenced, and published at
// sync[1 + t]. A block waits only on a lower ticket, held by a block that
// took it before: no deadlock, however many blocks are resident. The
// output holds latents (JOIN_LATENTS rows only): the later tiles read
// them back.
__global__ void __launch_bounds__(MAX_THREADS) lb_tiles_kernel(const __grid_constant__ Bases bs,
                                                               const long long* __restrict__ desc, int n_rows,
                                                               long long pages, unsigned* sync) {
  extern __shared__ u64 smem[];
  __shared__ unsigned s_ticket;
  if (threadIdx.x == 0) s_ticket = atomicAdd(sync, 1u);
  __syncthreads();
  const long long t = s_ticket;
  const long long tile = t / pages, g = t % pages;
  const long long* d = row_of(desc, n_rows, g);
  const long long page = g - d[PAGE0];
  const long long page_n = d[PAGE_N];
  const long long rest = d[N_VALID] - page * page_n;
  const long long N = rest < page_n ? rest : page_n;
  const long long t0 = tile * SMEM_MAX_N;
  if (t0 >= N) return;  // past the page's tiles (a shorter or ragged page)
  const int L = (int)(N - t0 < SMEM_MAX_N ? N - t0 : SMEM_MAX_N);
  const PageRefs a = page_refs(bs, d, page, (int)N);
  constexpr int PAIRS = (MAX_EPT + 1) / 2;
  u64 own_add[PAIRS][2];
  int own_ptr[PAIRS][2];
  u64* s_add = smem;
  tile_rounds<MAX_EPT>(a, t0, L, s_add, reinterpret_cast<int*>(smem + SMEM_MAX_N), own_add, own_ptr);
  if (tile > 0) {
    if (threadIdx.x == 0) {
      const volatile unsigned* flag = sync + 1 + (t - pages);
      while (*flag == 0) __nanosleep(64);
      __threadfence();
    }
    __syncthreads();
  }
  const int T = blockDim.x;
  const int s = tile_state(a, t0, L), n_lat = L - s;
  u64* o = a.out + t0;
  for (int i = threadIdx.x; i < s; i += T) o[i] = s_add[i];
#pragma unroll
  for (int q = 0; q < PAIRS; ++q) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 2 * (threadIdx.x + q * T) + h;
      if (k < n_lat) {
        const int p = own_ptr[q][h];
        o[s + k] = own_add[q][h] + (p <= -2 ? __ldcg(a.out + (-2 - (long long)p)) : 0ull);
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicExch(sync + 1 + t, 1u);
}

struct DeviceInfo {
  bool ready = false;
  int optin = 0;  // opt-in shared memory of a block, bytes
};

DeviceInfo g_info[MAX_DEVICES];

template <int EPT>
cudaError_t allow_smem(int bytes) {
  return cudaFuncSetAttribute(lb_chunks_kernel<EPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The device's opt-in shared memory, and every shared-memory kernel allowed
// it, once a process.
cudaError_t device_info(int device, const DeviceInfo** out) {
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  DeviceInfo& d = g_info[device];
  if (!d.ready) {
    cudaError_t err;
    if ((err = cudaDeviceGetAttribute(&d.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) != cudaSuccess)
      return err;
    if ((err = allow_smem<1>(d.optin)) != cudaSuccess || (err = allow_smem<2>(d.optin)) != cudaSuccess ||
        (err = allow_smem<4>(d.optin)) != cudaSuccess || (err = allow_smem<8>(d.optin)) != cudaSuccess ||
        (err = allow_smem<16>(d.optin)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(lb_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)TILE_SMEM)) != cudaSuccess)
      return err;
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

bool in_base(long long base, long long start, long long n, const long long* numels, int n_bases) {
  return base >= 0 && base < n_bases && start >= 0 && n >= 0 && start + n <= numels[base];
}

// Every row checked against its bases: pages of 1 to max_page_n numbers,
// rows following each other in the launch's pages, a join K3 knows (only
// JOIN_LATENTS where latents_only). *pages gets the rows' pages, *max_n
// their longest page.
bool check_rows(const long long* desc, int n_rows, const long long* numels, int n_bases, long long max_page_n,
                bool latents_only, long long* pages, long long* max_n) {
  *pages = 0;
  *max_n = 1;
  if (n_rows < 0 || n_bases < 0 || n_bases > MAX_BASES) return false;
  for (int r = 0; r < n_rows; ++r) {
    const long long* d = desc + (long long)r * DESC_COLS;
    const long long P = d[N_PAGES], N = d[PAGE_N], nv = d[N_VALID];
    const long long join_max = latents_only ? JOIN_LATENTS : JOIN_FLOAT;
    if (P < 0 || N < 1 || N > max_page_n || nv < 0 || nv > P * N || d[STATE_N] < 0 || d[WINDOW_N] < 1 ||
        d[BITS] < 1 || d[BITS] > 64 || d[JOIN] < JOIN_LATENTS || d[JOIN] > join_max || d[PAGE0] != *pages ||
        (d[LAT_BASE] >= 0 && !in_base(d[LAT_BASE], d[LAT_START], nv, numels, n_bases)) ||
        (d[LB_BASE] >= 0 && !in_base(d[LB_BASE], d[LB_START], nv, numels, n_bases)) ||
        !in_base(d[MOM_BASE], d[MOM_START], P * d[STATE_N], numels, n_bases) ||
        !in_base(d[OUT_BASE], d[OUT_START], nv, numels, n_bases))
      return false;
    *pages += P;
    if (N > *max_n) *max_n = N;
  }
  return true;
}

}  // namespace

// Every row of a container's lookback table in one launch. bases, numels:
// the n_bases int64 tensors the rows name, as addresses and element counts;
// desc: the n_rows rows on the host (checked here against the bases) and
// desc_dev the same rows on the device (read by the kernel). threads: a
// block's threads, raised where a page needs more than MAX_EPT positions a
// thread. *launched gets the kernels launched (0 for no pages, else 1).
extern "C" int lookback_chunks(const u64* bases, const long long* numels, int n_bases, const long long* desc,
                               const void* desc_dev, int n_rows, int threads, int* launched, int device,
                               void* stream) {
  *launched = 0;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const DeviceInfo* info = nullptr;
  if ((err = device_info(device, &info)) != cudaSuccess) return (int)err;
  long long pages, max_n;
  if (threads < 32 || threads > MAX_THREADS || threads % 32 ||
      !check_rows(desc, n_rows, numels, n_bases, SMEM_MAX_N, false, &pages, &max_n))
    return (int)cudaErrorInvalidValue;
  if (pages == 0) return 0;
  if (pages > 0x7FFFFFFFLL || !desc_dev) return (int)cudaErrorInvalidValue;
  Bases bs;
  for (int b = 0; b < n_bases; ++b) bs.p[b] = bases[b];
  long long T = threads;
  const long long need = (max_n + MAX_EPT - 1) / MAX_EPT;
  if (T < need) T = (need + 31) / 32 * 32;
  const long long ept = (max_n + T - 1) / T;
  const size_t smem = (size_t)max_n * (sizeof(u64) + sizeof(int));
  if ((long long)smem > info->optin) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto dd = static_cast<const long long*>(desc_dev);
  const unsigned grid = (unsigned)pages;
  if (ept <= 1) lb_chunks_kernel<1><<<grid, (unsigned)T, smem, s>>>(bs, dd, n_rows);
  else if (ept <= 2) lb_chunks_kernel<2><<<grid, (unsigned)T, smem, s>>>(bs, dd, n_rows);
  else if (ept <= 4) lb_chunks_kernel<4><<<grid, (unsigned)T, smem, s>>>(bs, dd, n_rows);
  else if (ept <= 8) lb_chunks_kernel<8><<<grid, (unsigned)T, smem, s>>>(bs, dd, n_rows);
  else lb_chunks_kernel<16><<<grid, (unsigned)T, smem, s>>>(bs, dd, n_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}

// B7: every row of a lookback table, pages of any length up to MAX_PAGE_N,
// in one launch of lb_tiles_kernel, a block a tile of SMEM_MAX_N numbers;
// the rows store latents (JOIN_LATENTS). Arguments as lookback_chunks;
// sync: 1 + tickets int32 words of device memory (zeroed here on the
// stream before the launch). *launched gets the kernels launched (0 for
// no pages, else 1).
extern "C" int lookback_tiles(const u64* bases, const long long* numels, int n_bases, const long long* desc,
                              const void* desc_dev, int n_rows, void* sync, long long sync_n, int* launched,
                              int device, void* stream) {
  *launched = 0;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const DeviceInfo* info = nullptr;
  if ((err = device_info(device, &info)) != cudaSuccess) return (int)err;
  long long pages, max_n;
  if (!check_rows(desc, n_rows, numels, n_bases, MAX_PAGE_N, true, &pages, &max_n))
    return (int)cudaErrorInvalidValue;
  const long long tickets = pages * ((max_n + SMEM_MAX_N - 1) / SMEM_MAX_N);
  if (tickets == 0) return 0;
  if (tickets > 0x7FFFFFFFLL || !desc_dev || !sync || sync_n < 1 + tickets) return (int)cudaErrorInvalidValue;
  Bases bs;
  for (int b = 0; b < n_bases; ++b) bs.p[b] = bases[b];
  auto s = static_cast<cudaStream_t>(stream);
  if ((err = cudaMemsetAsync(sync, 0, (size_t)(1 + tickets) * sizeof(unsigned), s)) != cudaSuccess) return (int)err;
  lb_tiles_kernel<<<(unsigned)tickets, MAX_THREADS, TILE_SMEM, s>>>(bs, static_cast<const long long*>(desc_dev), n_rows,
                                                               pages, static_cast<unsigned*>(sync));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}

extern "C" const char* pcodec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
