// K3 lookback_recon: per-page lookback delta reconstruction by pointer
// doubling.
//
// Replaces: pcodec_tpu/ops/pallas_decode.py::_lb_recon_kernel_body (launched
// by _lookback_decode_pages_pallas), the TPU kernel that runs the doubling
// rounds over (R, 128) sublane planes with lane-gather select trees, u64 as
// i32 pairs with a hand carry, after an XLA prologue that builds the
// initial sums and pointers in device memory.
//
// The recurrence: position p < state_n is the page's stored state; after
// it value[p] = (latent[p - state_n] + mid) + value[p - lb], lb the `delta`
// var's latent at p - state_n clipped to [1, window_n], a pointer before
// the page start meaning the zero prefill (-1). Pointer doubling resolves it
// in bit_length(max(N - 1, 1)) synchronous rounds: add += add[ptr],
// ptr = ptr[ptr] where ptr >= 0.
//
// What bounds it on Hopper: the function reads 8 bytes of latent and 8 of
// lookback and writes 8 bytes per number; the rounds are gathers inside one
// page, which are cheap once the page is on chip. Done in device memory the
// rounds would read and write 12 bytes per number each, about 10x the
// unavoidable traffic at page_n 1024.
//
// What the design does about it: one block reconstructs one page in shared
// memory (u64 add + i32 ptr, 12 bytes per number: 12 KB at page_n 1024).
// The prologue is folded into the load, so the page is read once and
// written once. Each round every thread gathers add[ptr] and ptr[ptr] for
// its positions into registers, the block synchronises, then writes; the
// rounds stop early once no pointer is left (__syncthreads_or), which
// changes no result. Pages of up to 16,384 numbers (192 KB) run this way;
// longer pages run the same rounds in device memory, ping-pong buffers and
// one launch per round.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_EPT = 16;
constexpr long long SMEM_MAX_N = (long long)MAX_THREADS * MAX_EPT;  // must match ops/kernels.py
constexpr int GLOBAL_THREADS = 256;

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
__device__ __forceinline__ void init_elem(const Page& a, long long page, long long i, u64& add, int& ptr) {
  if (i < a.state_n) {
    add = a.mom[page * a.state_n + i];
    ptr = -1;
  } else {
    const long long k = page * a.N + (i - a.state_n);
    add = a.lat[k] + a.mid;
    long long lb = a.lb[k];
    lb = lb < 1 ? 1 : (lb > a.window_n ? a.window_n : lb);
    const long long p = i - lb;
    ptr = p < 0 ? -1 : (int)p;
  }
}

template <int EPT>
__global__ void __launch_bounds__(MAX_THREADS) lb_smem_kernel(Page a, u64* __restrict__ out, int rounds) {
  extern __shared__ u64 smem[];
  const int N = (int)a.N;
  u64* s_add = smem;
  int* s_ptr = reinterpret_cast<int*>(smem + N);
  const long long page = blockIdx.x;
  const int T = blockDim.x;
  for (int i = threadIdx.x; i < N; i += T) {
    u64 add;
    int ptr;
    init_elem(a, page, i, add, ptr);
    s_add[i] = add;
    s_ptr[i] = ptr;
  }
  __syncthreads();
  for (int r = 0; r < rounds; ++r) {
    u64 ga[EPT];
    int gp[EPT];
    int any = 0;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int i = threadIdx.x + e * T;
      ga[e] = 0;
      gp[e] = -1;
      if (i < N) {
        const int p = s_ptr[i];
        if (p >= 0) {
          ga[e] = s_add[p];
          gp[e] = s_ptr[p];
          any = 1;
        }
      }
    }
    if (!__syncthreads_or(any)) break;  // every pointer resolved: later rounds change nothing
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int i = threadIdx.x + e * T;
      if (i < N && s_ptr[i] >= 0) {
        s_add[i] += ga[e];
        s_ptr[i] = gp[e];
      }
    }
    __syncthreads();
  }
  u64* o = out + page * a.N;
  for (int i = threadIdx.x; i < N; i += T) o[i] = s_add[i];
}

__global__ void __launch_bounds__(GLOBAL_THREADS) lb_init_kernel(Page a, long long total, u64* __restrict__ add,
                                                                 int* __restrict__ ptr) {
  const long long idx = (long long)blockIdx.x * GLOBAL_THREADS + threadIdx.x;
  if (idx >= total) return;
  u64 v;
  int p;
  init_elem(a, idx / a.N, idx % a.N, v, p);
  add[idx] = v;
  ptr[idx] = p;
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

template <int EPT>
cudaError_t launch_smem(const Page& a, u64* out, int P, int rounds, cudaStream_t s) {
  const size_t smem = (size_t)a.N * (sizeof(u64) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(lb_smem_kernel<EPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int T = (int)((a.N + EPT - 1) / EPT);
  T = (T + 31) / 32 * 32;
  lb_smem_kernel<EPT><<<P, T, smem, s>>>(a, out, rounds);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lookback_recon(const void* lat, const void* lb, const void* mom, void* out, int P, long long N,
                              int state_n, long long window_n, long long mid, int rounds, void* add_scratch,
                              void* ptr_scratch, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (P < 0 || N < 1 || N > 0x7FFFFFFFLL || state_n < 0 || window_n < 1 || rounds < 0)
    return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const Page a{static_cast<const u64*>(lat), static_cast<const long long*>(lb), static_cast<const u64*>(mom),
               N, state_n, window_n, (u64)mid};
  auto o = static_cast<u64*>(out);
  if (N <= SMEM_MAX_N) {
    const long long ept = (N + MAX_THREADS - 1) / MAX_THREADS;
    if (ept <= 1) return (int)launch_smem<1>(a, o, P, rounds, s);
    if (ept <= 2) return (int)launch_smem<2>(a, o, P, rounds, s);
    if (ept <= 4) return (int)launch_smem<4>(a, o, P, rounds, s);
    if (ept <= 8) return (int)launch_smem<8>(a, o, P, rounds, s);
    return (int)launch_smem<16>(a, o, P, rounds, s);
  }
  // device-memory route: ping-pong between `out` and the scratch add buffer,
  // starting where an even or odd round count ends in `out`
  if (!add_scratch || !ptr_scratch) return (int)cudaErrorInvalidValue;
  const long long total = (long long)P * N;
  u64* add[2] = {o, static_cast<u64*>(add_scratch)};
  int* ptr[2] = {static_cast<int*>(ptr_scratch), static_cast<int*>(ptr_scratch) + total};
  if (rounds % 2) {
    u64* t = add[0];
    add[0] = add[1];
    add[1] = t;
  }
  const unsigned blocks = (unsigned)((total + GLOBAL_THREADS - 1) / GLOBAL_THREADS);
  lb_init_kernel<<<blocks, GLOBAL_THREADS, 0, s>>>(a, total, add[0], ptr[0]);
  err = cudaGetLastError();
  for (int r = 0; r < rounds && err == cudaSuccess; ++r) {
    const int i = r % 2;
    lb_round_kernel<<<blocks, GLOBAL_THREADS, 0, s>>>(add[i], ptr[i], add[1 - i], ptr[1 - i], total, N);
    err = cudaGetLastError();
  }
  return (int)err;
}

extern "C" const char* pcodec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
