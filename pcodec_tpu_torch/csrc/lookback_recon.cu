// K3 lookback_recon: lookback delta reconstruction by pointer doubling, for
// every lookback var of a container in one launch, the Classic join folded
// into the store.
//
// Replaces: pcodec_tpu/ops/pallas_decode.py::_lb_recon_kernel_body (launched
// by _lookback_decode_pages_pallas once per chunk), the TPU kernel that runs
// the doubling rounds over (R, 128) sublane planes with lane-gather select
// trees, u64 as i32 pairs with a hand carry, after an XLA prologue that
// builds the initial sums and pointers in device memory; and the per-chunk
// XLA trim, Classic join and concatenation after it.
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
// this way; longer pages run the same rounds in device memory, ping-pong
// buffers and one launch a round, a call a chunk.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_EPT = 16;
constexpr int LOAD_PAIRS = 4;  // 16-byte pairs of latents and of lookbacks a thread loads at once
constexpr long long SMEM_MAX_N = (long long)MAX_THREADS * MAX_EPT;  // must match ops/kernels.py
constexpr int GLOBAL_THREADS = 256;
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

template <int EPT>
__global__ void __launch_bounds__(MAX_THREADS) lb_chunks_kernel(const __grid_constant__ Bases bs,
                                                                const long long* __restrict__ desc, int n_rows) {
  extern __shared__ u64 smem[];
  const long long g = blockIdx.x;
  int lo = 0, hi = n_rows - 1;  // the last row whose first page is <= g
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (desc[(long long)mid * DESC_COLS + PAGE0] <= g) lo = mid;
    else hi = mid - 1;
  }
  const long long* d = desc + (long long)lo * DESC_COLS;
  const long long page = g - d[PAGE0];
  const long long page_n = d[PAGE_N];
  const long long first = page * page_n;  // the page's first number in the row
  const long long rest = d[N_VALID] - first;
  if (rest <= 0) return;
  const int N = (int)(rest < page_n ? rest : page_n);
  const int state_n = (int)d[STATE_N];
  const int s = state_n < N ? state_n : N;
  const int n_lat = N - s;
  const long long window_n = d[WINDOW_N];
  const int bits = (int)d[BITS];
  const u64 mid = 1ull << (bits - 1);
  const bool lat_const = d[LAT_BASE] < 0, lb_const = d[LB_BASE] < 0;
  const u64* lat = lat_const ? nullptr : reinterpret_cast<const u64*>(bs.p[d[LAT_BASE]]) + d[LAT_START] + first;
  const long long* lb =
      lb_const ? nullptr : reinterpret_cast<const long long*>(bs.p[d[LB_BASE]]) + d[LB_START] + first;
  const u64* mom = reinterpret_cast<const u64*>(bs.p[d[MOM_BASE]]) + d[MOM_START] + page * state_n;
  u64* s_add = smem;
  int* s_ptr = reinterpret_cast<int*>(smem + page_n);
  const int T = blockDim.x;

  // prologue: the stored state, then (latent + mid, position - clipped
  // lookback) of the latent positions s + k the thread owns, k = 2 * (tid +
  // q * T) + h, kept in registers and shared; up to LOAD_PAIRS pairs of
  // loads of a thread in flight before the first is used
  constexpr int PAIRS = (EPT + 1) / 2;
  constexpr int GROUP = PAIRS < LOAD_PAIRS ? PAIRS : LOAD_PAIRS;
  const bool vec = ((reinterpret_cast<u64>(lat) | reinterpret_cast<u64>(lb)) & 15) == 0;
  u64 own_add[PAIRS][2];
  int own_ptr[PAIRS][2];
#pragma unroll
  for (int q0 = 0; q0 < PAIRS; q0 += GROUP) {
    u64 a[GROUP][2], b[GROUP][2];
#pragma unroll
    for (int q = 0; q < GROUP; ++q) {
      const int k = 2 * (threadIdx.x + (q0 + q) * T);
      load_pair(lat, lat_const, (u64)d[LAT_START], k, n_lat, vec, a[q]);
      load_pair(reinterpret_cast<const u64*>(lb), lb_const, (u64)d[LB_START], k, n_lat, vec, b[q]);
    }
    if (q0 == 0) {
      for (int i = threadIdx.x; i < s; i += T) {
        s_add[i] = mom[i];
        s_ptr[i] = -1;
      }
    }
#pragma unroll
    for (int q = 0; q < GROUP; ++q) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 2 * (threadIdx.x + (q0 + q) * T) + h;
        const long long lbk = (long long)b[q][h];
        const long long step = lbk < 1 ? 1 : (lbk > window_n ? window_n : lbk);
        const long long p = s + k - step;
        own_add[q0 + q][h] = a[q][h] + mid;
        own_ptr[q0 + q][h] = k < n_lat && p >= 0 ? (int)p : -1;
        if (k < n_lat) {
          s_add[s + k] = own_add[q0 + q][h];
          s_ptr[s + k] = own_ptr[q0 + q][h];
        }
      }
    }
  }
  __syncthreads();

  // rounds: each owned position with a pointer gathers add[ptr] and ptr[ptr]
  // into its registers; after the barrier, those that moved are shared
  const int rounds = 32 - __clz(N - 1 > 1 ? N - 1 : 1);
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
  u64* o = reinterpret_cast<u64*>(bs.p[d[OUT_BASE]]) + d[OUT_START] + first;
  const int join = (int)d[JOIN];
  for (int i = threadIdx.x; i < s; i += T) __stcs(o + i, join_bits(s_add[i], join, bits));
#pragma unroll
  for (int q = 0; q < PAIRS; ++q) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 2 * (threadIdx.x + q * T) + h;
      if (k < n_lat) __stcs(o + s + k, join_bits(own_add[q][h], join, bits));
    }
  }
}

struct Page {
  const u64* lat;       // (P, N) var latents
  const long long* lb;  // (P, N) lookbacks (the delta var's latents)
  const u64* mom;       // (P, state_n) stored state
  long long N;
  int state_n;
  long long window_n;
  u64 mid;
};

// initial (add, ptr) of position i of page `page`: the XLA prologue
__device__ __forceinline__ void init_elem(const Page& a, long long page, long long i, u64& add, long long& ptr) {
  if (i < a.state_n) {
    add = a.mom[page * a.state_n + i];
    ptr = -1;
  } else {
    const long long k = page * a.N + (i - a.state_n);
    add = a.lat[k] + a.mid;
    long long lb = a.lb[k];
    lb = lb < 1 ? 1 : (lb > a.window_n ? a.window_n : lb);
    const long long p = i - lb;
    ptr = p < 0 ? -1 : p;
  }
}

__global__ void __launch_bounds__(GLOBAL_THREADS) lb_init_kernel(Page a, long long total, u64* __restrict__ add,
                                                                 int* __restrict__ ptr) {
  const long long idx = (long long)blockIdx.x * GLOBAL_THREADS + threadIdx.x;
  if (idx >= total) return;
  u64 v;
  long long p;
  init_elem(a, idx / a.N, idx % a.N, v, p);
  add[idx] = v;
  ptr[idx] = (int)p;
}

__global__ void __launch_bounds__(GLOBAL_THREADS) lb_round_kernel(const u64* __restrict__ add_in,
                                                                  const int* __restrict__ ptr_in,
                                                                  u64* __restrict__ add_out,
                                                                  int* __restrict__ ptr_out, long long total,
                                                                  long long N) {
  const long long idx = (long long)blockIdx.x * GLOBAL_THREADS + threadIdx.x;
  if (idx >= total) return;
  const int p = ptr_in[idx];
  if (p >= 0) {
    const long long j = idx - idx % N + p;
    add_out[idx] = add_in[idx] + add_in[j];
    ptr_out[idx] = ptr_in[j];
  } else {
    add_out[idx] = add_in[idx];
    ptr_out[idx] = p;
  }
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
        (err = allow_smem<16>(d.optin)) != cudaSuccess)
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
  if (n_rows < 0 || n_bases < 0 || n_bases > MAX_BASES || threads < 32 || threads > MAX_THREADS || threads % 32)
    return (int)cudaErrorInvalidValue;
  long long pages = 0, max_n = 1;
  for (int r = 0; r < n_rows; ++r) {
    const long long* d = desc + (long long)r * DESC_COLS;
    const long long P = d[N_PAGES], N = d[PAGE_N], nv = d[N_VALID];
    if (P < 0 || N < 1 || N > SMEM_MAX_N || nv < 0 || nv > P * N || d[STATE_N] < 0 || d[WINDOW_N] < 1 ||
        d[BITS] < 1 || d[BITS] > 64 || d[JOIN] < JOIN_LATENTS || d[JOIN] > JOIN_FLOAT || d[PAGE0] != pages ||
        (d[LAT_BASE] >= 0 && !in_base(d[LAT_BASE], d[LAT_START], nv, numels, n_bases)) ||
        (d[LB_BASE] >= 0 && !in_base(d[LB_BASE], d[LB_START], nv, numels, n_bases)) ||
        !in_base(d[MOM_BASE], d[MOM_START], P * d[STATE_N], numels, n_bases) ||
        !in_base(d[OUT_BASE], d[OUT_START], nv, numels, n_bases))
      return (int)cudaErrorInvalidValue;
    pages += P;
    if (N > max_n) max_n = N;
  }
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

// The device-memory route for one chunk's pages (any page length): lat, lb
// (P, N), mom (P, state_n), out (P, N) and scratch add (P, N) and ptr (2, P,
// N). *launched gets the kernels launched: the prologue and one a round.
extern "C" int lookback_recon(const void* lat, const void* lb, const void* mom, void* out, int P, long long N,
                              int state_n, long long window_n, long long mid, int rounds, void* add_scratch,
                              void* ptr_scratch, int* launched, int device, void* stream) {
  *launched = 0;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (P < 0 || N < 1 || N > 0x7FFFFFFFLL || state_n < 0 || window_n < 1 || rounds < 0 || !add_scratch ||
      !ptr_scratch)
    return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const Page a{static_cast<const u64*>(lat), static_cast<const long long*>(lb), static_cast<const u64*>(mom),
               N, state_n, window_n, (u64)mid};
  // ping-pong between `out` and the scratch add buffer, starting where an
  // even or odd round count ends in `out`
  const long long total = (long long)P * N;
  u64* add[2] = {static_cast<u64*>(out), static_cast<u64*>(add_scratch)};
  int* ptr[2] = {static_cast<int*>(ptr_scratch), static_cast<int*>(ptr_scratch) + total};
  if (rounds % 2) {
    u64* t = add[0];
    add[0] = add[1];
    add[1] = t;
  }
  const unsigned blocks = (unsigned)((total + GLOBAL_THREADS - 1) / GLOBAL_THREADS);
  lb_init_kernel<<<blocks, GLOBAL_THREADS, 0, s>>>(a, total, add[0], ptr[0]);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*launched;
  for (int r = 0; r < rounds; ++r) {
    const int i = r % 2;
    lb_round_kernel<<<blocks, GLOBAL_THREADS, 0, s>>>(add[i], ptr[i], add[1 - i], ptr[1 - i], total, N);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ++*launched;
  }
  return 0;
}

extern "C" const char* pcodec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
