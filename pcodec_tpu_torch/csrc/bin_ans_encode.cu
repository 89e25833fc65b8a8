// K5 bin_ans_encode: bin search, reverse interleaved tANS and offsets of
// PCT encode chains.
//
// Replaces: pcodec_tpu/ops/pallas_encode.py::_eb_impl (launched by _eb_call),
// the TPU kernel that walks 256 chains per (8, 128) tile with select-tree
// table gathers and u64 compares done as u32 pairs.
//
// What bounds it on Hopper: bytes. Per symbol it reads an 8-byte latent and
// writes a 4-byte p1 word and an 8-byte offset; the work per symbol (a
// binary search over a few bins and one tANS step) is small beside that.
// Each chain's state is a serial chain of dependent table lookups, so one
// chain alone is latency bound.
//
// What the design does about it: one thread per chain walks its rounds in
// reverse, with the 4 interleaved streams unrolled as instruction-level
// parallelism, native 64-bit compares and subtraction, and 16-byte loads
// and stores of each round's 4 symbols. A block of 128 chains shares one
// chunk's table (the plan pads each table's chains to 128), held in dynamic
// shared memory when it fits (nexts as u32, lowers as u64, t1 and t2 as
// i32); the largest legal table (2^14 states and 2^14 bins, 320 KB) does
// not, and then the kernel reads the table from global memory instead.
//
// Per symbol k = 4r + j of stream j (r from the last round down to 0):
//   sym    = the last bin with lower <= latent (bin 0 if none); bins are
//            padded to a power of two with copies of the last bin
//   renorm = (t1 & 15) + (state >= t1 >> 11)
//   val    = state & ((1 << renorm) - 1)
//   state  = nexts[t2[sym] + (state >> renorm)]
//   p1     = val | renorm << 15 | ob << 19,  offset = latent - lower[sym]
// Symbols at k >= body_n give zeros and leave the state as it is.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CHAINS_PER_BLOCK = 128;

struct Table {
  const uint32_t* nexts;
  const unsigned long long* lowers;
  const int* t1;
  const int* t2;
};

template <bool SMEM>
__global__ void __launch_bounds__(CHAINS_PER_BLOCK) bin_ans_encode_kernel(
    const unsigned long long* __restrict__ latents, int page_n, const long long* __restrict__ body_n,
    const long long* __restrict__ table_id, const long long* __restrict__ states0,
    const uint32_t* __restrict__ nexts, int ts, const unsigned long long* __restrict__ lowers,
    const int* __restrict__ t1, const int* __restrict__ t2, int b_pad, int* __restrict__ p1,
    unsigned long long* __restrict__ offsets, long long* __restrict__ states) {
  extern __shared__ unsigned long long smem[];
  const long long c = (long long)blockIdx.x * CHAINS_PER_BLOCK + threadIdx.x;
  const long long tid = table_id[(long long)blockIdx.x * CHAINS_PER_BLOCK];
  Table tb{nexts + tid * ts, lowers + tid * b_pad, t1 + tid * b_pad, t2 + tid * b_pad};
  if (SMEM) {
    unsigned long long* s_lowers = smem;
    int* s_t1 = reinterpret_cast<int*>(smem + b_pad);
    int* s_t2 = s_t1 + b_pad;
    uint32_t* s_nexts = reinterpret_cast<uint32_t*>(s_t2 + b_pad);
    for (int i = threadIdx.x; i < b_pad; i += CHAINS_PER_BLOCK) {
      s_lowers[i] = tb.lowers[i];
      s_t1[i] = tb.t1[i];
      s_t2[i] = tb.t2[i];
    }
    for (int i = threadIdx.x; i < ts; i += CHAINS_PER_BLOCK) s_nexts[i] = tb.nexts[i];
    __syncthreads();
    tb = Table{s_nexts, s_lowers, s_t1, s_t2};
  }

  const unsigned long long* lat = latents + c * page_n;
  int* o1 = p1 + c * page_n;
  unsigned long long* oo = offsets + c * page_n;
  const long long bn = body_n[c];
  uint32_t st[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) st[j] = (uint32_t)states0[c];

  for (int r = page_n / 4 - 1; r >= 0; --r) {
    const int k0 = 4 * r;
    const ulonglong2 l01 = reinterpret_cast<const ulonglong2*>(lat + k0)[0];
    const ulonglong2 l23 = reinterpret_cast<const ulonglong2*>(lat + k0)[1];
    const unsigned long long l[4] = {l01.x, l01.y, l23.x, l23.y};
    int pv[4];
    unsigned long long ov[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      pv[j] = 0;
      ov[j] = 0ull;
      if (k0 + j < bn) {
        int sym = 0;
        for (int step = b_pad >> 1; step; step >>= 1)
          if (tb.lowers[sym + step] <= l[j]) sym += step;
        const int a = tb.t1[sym];
        const int renorm = (a & 15) + (st[j] >= (uint32_t)(a >> 11) ? 1 : 0);
        const uint32_t val = st[j] & ((1u << renorm) - 1u);
        st[j] = tb.nexts[tb.t2[sym] + (int)(st[j] >> renorm)];
        pv[j] = (int)val | (renorm << 15) | (((a >> 4) & 127) << 19);
        ov[j] = l[j] - tb.lowers[sym];
      }
    }
    reinterpret_cast<int4*>(o1 + k0)[0] = make_int4(pv[0], pv[1], pv[2], pv[3]);
    reinterpret_cast<ulonglong2*>(oo + k0)[0] = make_ulonglong2(ov[0], ov[1]);
    reinterpret_cast<ulonglong2*>(oo + k0)[1] = make_ulonglong2(ov[2], ov[3]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) states[c * 4 + j] = st[j];
}

}  // namespace

extern "C" int bin_ans_encode(const void* latents, int page_n, const void* body_n,
                              const void* table_id, const void* states0, const void* nexts, int ts,
                              const void* lowers, const void* t1, const void* t2, int b_pad,
                              void* p1, void* offsets, void* states, int n_chains, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_chains % CHAINS_PER_BLOCK || page_n % 4 || ts < 1 || b_pad < 1 || (b_pad & (b_pad - 1)))
    return (int)cudaErrorInvalidValue;
  if (n_chains == 0) return 0;
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)b_pad * (sizeof(unsigned long long) + 2 * sizeof(int)) +
                      (size_t)ts * sizeof(uint32_t);
  auto s = static_cast<cudaStream_t>(stream);
  auto a0 = static_cast<const unsigned long long*>(latents);
  auto a2 = static_cast<const long long*>(body_n);
  auto a3 = static_cast<const long long*>(table_id);
  auto a4 = static_cast<const long long*>(states0);
  auto a5 = static_cast<const uint32_t*>(nexts);
  auto a7 = static_cast<const unsigned long long*>(lowers);
  auto a8 = static_cast<const int*>(t1);
  auto a9 = static_cast<const int*>(t2);
  auto a11 = static_cast<int*>(p1);
  auto a12 = static_cast<unsigned long long*>(offsets);
  auto a13 = static_cast<long long*>(states);
  const int blocks = n_chains / CHAINS_PER_BLOCK;
  if (smem <= (size_t)max_smem) {
    err = cudaFuncSetAttribute(bin_ans_encode_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    bin_ans_encode_kernel<true><<<blocks, CHAINS_PER_BLOCK, smem, s>>>(
        a0, page_n, a2, a3, a4, a5, ts, a7, a8, a9, b_pad, a11, a12, a13);
  } else {
    bin_ans_encode_kernel<false><<<blocks, CHAINS_PER_BLOCK, 0, s>>>(
        a0, page_n, a2, a3, a4, a5, ts, a7, a8, a9, b_pad, a11, a12, a13);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* pcodec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
