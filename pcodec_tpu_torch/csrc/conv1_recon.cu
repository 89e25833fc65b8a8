// B1 conv1_recon: the conv1 (linear-prediction) delta reconstruction of
// every conv1 var of a container in one call, a thread or a warp a row.
//
// Replaces: pcodec_tpu/ops/decode.py::_conv1_decode, the lax.scan that the
// JAX package runs vmapped over a chunk's pages
// (pcodec_tpu/ops/pallas_decode.py::_reconstruct_var), and the host's serial
// conv1_decode_in_place that its standalone planner runs over a whole chunk
// to find each chain's first numbers. Not a Pallas kernel: XLA compiles the
// scan on the TPU.
//
// The recurrence, on each row of N numbers with stored state m[0..K): the
// first K outputs are m & mask; after them
//   v[p] = (delta[p - K] + mid + (max(bias + sum_j w_j v[p - K + j], 0) >> q)) & mask
// in wrapping 64-bit arithmetic, the window starting from the state
// unmasked (as the JAX scan and the port's plain version do).
//
// One descriptor row (DESC_COLS int64, fixed by the host plan and uploaded
// once) describes one conv1 var of one chunk: where its latents (a base
// tensor and a start, or a constant for a trivial var), its stored state
// (K numbers a row) and its output lie; its rows, row length and count of
// valid numbers (a ragged last row); K, q, bias, latent bits, its first row
// in the call, and the 32 weights (the first K used). A PCT chunk's rows are
// its pages; a standalone chunk is one row over the whole chunk, from the
// page's one stored state.
//
// What bounds it on Hopper: the dependent chain. Each row is serial: v[p]
// needs v[p - 1]. Bytes (8 in, 8 out a number) and operations (K
// multiply-adds a number) are far below what a row's steps take; a
// standalone chunk of 262,144 numbers is 262,144 dependent steps however
// wide the card is.
//
// What the design does about it: a thread a row, the rows of every chunk of
// the container in one launch (a launch for each order present), so the
// chunks' chains run side by side; where there are no more rows than the
// card has warp schedulers, a warp a row (its lane 0), so that no load
// gathers 32 rows. K is a template argument (1..32, a
// switch), so the window and the weights stay in registers. Only the newest
// value's term sits on the chain: the sum of the older K - 1 terms for the
// next step is formed while the current value is computed, so a step's
// chain is one 64-bit multiply-add, a max, a shift, an add and a mask. The
// row's latents are read through a ring of AHEAD registers, each slot
// refilled as soon as it is used, so the loads run AHEAD steps ahead of
// the chain, their indices clamped into the row rather than guarded (a
// guard made each load a branch: 67 ns a step against 51, and 40 without
// loads, on an H100); the steps are unrolled AHEAD at a time, so ring and
// window indices are constants (the last round's steps past the row
// computed and not stored).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;
constexpr int THREADS = 128;
constexpr int MAX_ORDER = 32;
constexpr int AHEAD = 32;      // latents loaded ahead of the chain
constexpr int MAX_BASES = 64;  // tensors one call reads and writes (the launch outputs, the states, the scratch); must match ops/kernels.py
constexpr int DESC_COLS = 46;  // must match ops/decode.py

// descriptor columns, then the 32 weights at WEIGHTS
enum Col {
  LAT_BASE, LAT_START, MOM_BASE, MOM_START, OUT_BASE, OUT_START, N_ROWS, ROW_N, N_VALID, ORDER, QUANT, BIAS, BITS,
  ROW0, WEIGHTS
};

struct Bases {
  u64 p[MAX_BASES];  // addresses of the int64 tensors the rows name
};

// One step of a row: v[K] from the window v (oldest first), whose older
// terms' sum `part` (bias included) was formed in the step before. Only
// w[K - 1] * v[K - 1] and what follows it wait on the previous step; the
// next step's `part` is formed from values already known.
template <int K>
__device__ __forceinline__ u64 step(u64 (&v)[K], const u64 (&w)[K], u64& part, u64 bias, u64 dm, int q, u64 mask) {
  const long long s = (long long)(part + w[K - 1] * v[K - 1]);
  u64 next = bias;
#pragma unroll
  for (int j = 0; j + 1 < K; ++j) next += w[j] * v[j + 1];
  const u64 val = (dm + (s > 0 ? (u64)s >> q : 0ull)) & mask;
#pragma unroll
  for (int j = 0; j + 1 < K; ++j) v[j] = v[j + 1];
  v[K - 1] = val;
  part = next;
  return val;
}

template <int K>
__global__ void __launch_bounds__(THREADS) conv1_kernel(const __grid_constant__ Bases bs,
                                                       const long long* __restrict__ desc, int n_desc,
                                                       long long total_rows, int lane_shift) {
  // a row a thread, or a row a warp (lane_shift 5: lane 0 walks it)
  if (threadIdx.x & ((1 << lane_shift) - 1)) return;
  const long long t = ((long long)blockIdx.x * THREADS + threadIdx.x) >> lane_shift;
  if (t >= total_rows) return;
  int lo = 0, hi = n_desc - 1;  // the last descriptor whose first row is <= t
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(desc + (long long)mid * DESC_COLS + ROW0) <= t) lo = mid;
    else hi = mid - 1;
  }
  const long long* d = desc + (long long)lo * DESC_COLS;
  if (__ldg(d + ORDER) != K) return;
  const long long r = t - __ldg(d + ROW0);
  const long long N = __ldg(d + ROW_N);
  long long count = __ldg(d + N_VALID) - r * N;
  if (count > N) count = N;
  if (count <= 0) return;
  const int bits = (int)__ldg(d + BITS);
  const int q = (int)__ldg(d + QUANT);
  const u64 mask = bits >= 64 ? ~0ull : (1ull << bits) - 1;
  const u64 mid = 1ull << (bits - 1);
  const u64 bias = (u64)__ldg(d + BIAS);
  // a trivial var's latents all read its descriptor's LAT_START: stride 0
  const long long lat_base = __ldg(d + LAT_BASE);
  const bool is_const = lat_base < 0;
  const u64* lat = is_const ? reinterpret_cast<const u64*>(d + LAT_START)
                            : reinterpret_cast<const u64*>(bs.p[lat_base]) + __ldg(d + LAT_START) + r * N;
  const long long stride_mask = is_const ? 0 : -1;
  const u64* mom = reinterpret_cast<const u64*>(bs.p[__ldg(d + MOM_BASE)]) + __ldg(d + MOM_START) + r * K;
  u64* out = reinterpret_cast<u64*>(bs.p[__ldg(d + OUT_BASE)]) + __ldg(d + OUT_START) + r * N;

  u64 w[K], v[K];  // weights; the window, oldest first
#pragma unroll
  for (int j = 0; j < K; ++j) {
    w[j] = (u64)__ldg(d + WEIGHTS + j);
    v[j] = __ldg(mom + j);
    if (j < count) out[j] = v[j] & mask;
  }
  const long long S = count - K;  // steps: v[K + i] from delta[i], i < S
  if (S <= 0) return;
  out += K;
  u64 part = bias;
#pragma unroll
  for (int j = 0; j + 1 < K; ++j) part += w[j] * v[j];

  // delta[i0 + u] in slot u; every load's index clamped into the row, so
  // no load waits on a branch (the slots past S are read and never used)
  u64 ring[AHEAD];
#pragma unroll
  for (int u = 0; u < AHEAD; ++u) ring[u] = __ldg(lat + ((u < S ? u : S - 1) & stride_mask));
  for (long long i0 = 0; i0 < S; i0 += AHEAD) {
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      const u64 dm = ring[u] + mid;
      const long long ahead = i0 + AHEAD + u;
      ring[u] = __ldg(lat + ((ahead < S ? ahead : S - 1) & stride_mask));
      const u64 val = step<K>(v, w, part, bias, dm, q, mask);  // past S: computed, not stored
      if (i0 + u < S) out[i0 + u] = val;
    }
  }
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

template <int K>
cudaError_t launch(const Bases& bs, const long long* desc_dev, int n_desc, long long rows, int lane_shift,
                   cudaStream_t s) {
  const unsigned grid = (unsigned)(((rows << lane_shift) + THREADS - 1) / THREADS);
  conv1_kernel<K><<<grid, THREADS, 0, s>>>(bs, desc_dev, n_desc, rows, lane_shift);
  return cudaGetLastError();
}

template <int... Ks>
cudaError_t launch_order(int k, const Bases& bs, const long long* desc_dev, int n_desc, long long rows,
                         int lane_shift, cudaStream_t s) {
  cudaError_t err = cudaErrorInvalidValue;
  ((k == Ks ? (err = launch<Ks>(bs, desc_dev, n_desc, rows, lane_shift, s), 0) : 0), ...);
  return err;
}

constexpr int MAX_DEVICES = 64;
constexpr int SCHEDULERS_PER_SM = 4;  // warp schedulers of a Hopper SM
int g_sms[MAX_DEVICES];  // the device's SMs, 0 until read

cudaError_t sm_count(int device, int* out) {
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!g_sms[device]) {
    cudaError_t err = cudaDeviceGetAttribute(&g_sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  *out = g_sms[device];
  return cudaSuccess;
}

}  // namespace

// Every row of a container's conv1 table. bases, numels: the n_bases int64
// tensors the rows name, as addresses and element counts; desc: the n_desc
// rows on the host (checked here against the bases) and desc_dev the same
// rows on the device (read by the kernels). *launched gets the kernels
// launched: one for each order the rows hold (0 where they hold no row).
extern "C" int conv1_recon(const u64* bases, const long long* numels, int n_bases, const long long* desc,
                           const void* desc_dev, int n_desc, int* launched, int device, void* stream) {
  *launched = 0;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (n_desc < 0 || n_bases < 0 || n_bases > MAX_BASES) return (int)cudaErrorInvalidValue;
  long long rows = 0;
  unsigned long long orders = 0;  // bit K - 1 for each order with rows
  for (int i = 0; i < n_desc; ++i) {
    const long long* d = desc + (long long)i * DESC_COLS;
    const long long R = d[N_ROWS], N = d[ROW_N], nv = d[N_VALID], K = d[ORDER];
    if (R < 0 || N < 1 || nv < 0 || nv > R * N || K < 1 || K > MAX_ORDER || d[QUANT] < 0 || d[QUANT] > 63 ||
        d[BITS] < 1 || d[BITS] > 64 || d[ROW0] != rows ||
        (d[LAT_BASE] >= 0 && !in_base(d[LAT_BASE], d[LAT_START], nv, numels, n_bases)) ||
        !in_base(d[MOM_BASE], d[MOM_START], R * K, numels, n_bases) ||
        !in_base(d[OUT_BASE], d[OUT_START], nv, numels, n_bases))
      return (int)cudaErrorInvalidValue;
    rows += R;
    if (nv > 0) orders |= 1ull << (K - 1);
  }
  if (!orders) return 0;
  if (rows > 0x7FFFFFFFLL * THREADS / 32 || !desc_dev) return (int)cudaErrorInvalidValue;
  // a row a warp where each row's warp can have a scheduler to itself: its
  // loads then ask for one line, not 32 rows' lines (a standalone file's 32
  // rows of 262,144, H100: 53 against 74 ns a step). More rows keep a row
  // a thread, a warp's instructions serving 32 rows (8,192 rows of 1,024:
  // 0.21 ms against 0.72 a warp a row, whose warps share the schedulers)
  int sms = 0;
  if ((err = sm_count(device, &sms)) != cudaSuccess) return (int)err;
  const int lane_shift = rows <= (long long)sms * SCHEDULERS_PER_SM ? 5 : 0;
  Bases bs;
  for (int b = 0; b < n_bases; ++b) bs.p[b] = bases[b];
  auto s = static_cast<cudaStream_t>(stream);
  auto dd = static_cast<const long long*>(desc_dev);
  for (int k = 1; k <= MAX_ORDER; ++k) {
    if (!(orders >> (k - 1) & 1)) continue;
    err = launch_order<1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
                       26, 27, 28, 29, 30, 31, 32>(k, bs, dd, n_desc, rows, lane_shift, s);
    if (err != cudaSuccess) return (int)err;
    ++*launched;
  }
  return 0;
}

extern "C" const char* pcodec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
