// K6 section_pack: the section cursors and the bit-packing of each PCT
// encode chain's ANS values and offsets into its page body.
//
// Replaces: pcodec_tpu/ops/pallas_encode.py::_ec_impl (launched by _ec_call),
// the TPU kernel that deposits each round's 4 values into per-quad vreg
// accumulators, retires words into a circular 128-word window per group and
// OR-merges the window into the section buffer on a static schedule, and the
// XLA glue before it (encode_container_device) that sums each batch's ANS
// and offset bits into the section cursors.
//
// For each chain c and batch b of 256 symbols, p1's fields give each
// symbol's ANS value (bits 0-14), its renormalisation bits ren (15-18) and
// its offset bits ob (19-25). The batch's sections are [its ANS values, ren
// bits each][its offsets, ob bits each], LSB first, batch after batch from
// bit 0 of the chain's row; ans_len and off_len are the two sections' bits
// and total_bits the chain's.
//
// A row is one chain, or (row_chains) a page of a chunk of several latent
// vars: the page body interleaves its vars' sections batch by batch, var by
// var in file order, each [ANS][offsets] (ref:
// pco/src/wrapped/chunk_compressor.rs:657-693), so the row's cursors are
// joint: one running cursor over (batch, var), as the JAX package's
// _multi_glue scans them. ans_len and off_len are then per (row, var,
// batch), zero for a var without a chain, and total_bits the page's.
//
// What bounds it on Hopper: bytes. It reads 4 bytes of p1 a symbol and the
// 8-byte offset of each symbol with offset bits, and writes the row (its
// zero tail included) and the lengths; the bit arithmetic is a handful of
// operations a symbol.
//
// What the design does about it: one warp packs one row, so every load
// and store of a warp is contiguous. For each batch the lanes load its 256
// p1 words, 8 a lane, as two 16-byte vectors (1 KB a warp); one warp scan of
// (ANS bits << 16 | offset bits) gives every lane its two bit positions and
// the batch's lengths, which are the cursors' own numbers (the glue this
// kernel takes in); a page of several vars runs these steps for each var's
// chain in turn inside each batch, the one cursor carried across. Each
// lane then deposits its 8 ANS values, and its 8 offsets (loaded as
// 16-byte pairs only where a pair has offset bits), as one contiguous run
// each through a 64-bit accumulator, ORing each retired word into the row
// staged in shared memory (atomicOr: lanes share
// only the words at the edges of their runs). The warp zeroes the row
// first and stores the whole row, its zero tail included, with 16-byte
// stores at the end, so the output needs no memset. A row too large for the
// block's opt-in shared memory is zeroed and ORed into device memory by the
// same warp instead (a route no format input is refused).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;
constexpr int BATCH = 256;
constexpr int LANE_SYMS = BATCH / 32;  // symbols a lane deposits a batch
constexpr int MAX_WARPS = 32;          // rows a block
constexpr int MAX_VARS = 3;            // latent vars a row interleaves
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xFFFFFFFFu;

// Bits appended LSB first from a bit position; every retired word is ORed
// into the row (words past W are dropped).
struct Run {
  uint32_t* row;
  int W;
  int w;    // word of the first pending bit
  int n;    // pending bits in acc
  u64 acc;  // pending bits, LSB first

  __device__ void start(long long bit) {
    const long long w0 = bit >> 5;
    w = w0 < W ? (int)w0 : W;
    n = (int)(bit & 31);
    acc = 0ull;
  }
  __device__ void emit() {
    if (w < W && (uint32_t)acc) atomicOr(row + w, (uint32_t)acc);
  }
  __device__ void put(uint32_t v, int width) {  // v < 2^width, width <= 32
    acc |= (u64)v << n;
    n += width;
    if (n >= 32) {
      emit();
      acc >>= 32;
      n -= 32;
      ++w;
    }
  }
  __device__ void finish() {
    if (n > 0) emit();
  }
};

// one batch of a chain (its p1 and offsets pc, oc) deposited from bit `cur`
// of the row; *A, *O get the batch's ANS and offset bits
__device__ __forceinline__ void pack_batch(const int* __restrict__ pc, const u64* __restrict__ oc, int b, int lane,
                                           Run& run, long long cur, long long* A_out, long long* O_out) {
  const int k0 = b * BATCH + lane * LANE_SYMS;
  const int4 q0 = reinterpret_cast<const int4*>(pc + k0)[0];
  const int4 q1 = reinterpret_cast<const int4*>(pc + k0)[1];
  const int v[LANE_SYMS] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
  unsigned a = 0, o = 0;
#pragma unroll
  for (int j = 0; j < LANE_SYMS; ++j) {
    a += (v[j] >> 15) & 15;
    o += (v[j] >> 19) & 127;
  }
  // ANS bits of a batch <= 256 * 15 and offset bits <= 256 * 127: both fit 16 bits
  const unsigned mine = (a << 16) | o;
  unsigned incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned t = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += t;
  }
  const unsigned tot = __shfl_sync(FULL, incl, 31);
  const unsigned excl = incl - mine;
  const long long A = tot >> 16, O = tot & 0xFFFF;
  run.start(cur + (excl >> 16));
#pragma unroll
  for (int j = 0; j < LANE_SYMS; ++j) run.put((uint32_t)(v[j] & 0x7FFF), (v[j] >> 15) & 15);
  run.finish();
  if (o) {
    run.start(cur + A + (excl & 0xFFFF));
#pragma unroll
    for (int j = 0; j < LANE_SYMS; j += 2) {
      const int ob0 = (v[j] >> 19) & 127, ob1 = (v[j + 1] >> 19) & 127;
      if ((ob0 | ob1) == 0) continue;
      const ulonglong2 op = reinterpret_cast<const ulonglong2*>(oc + k0 + j)[0];
      const u64 ov[2] = {op.x, op.y};
      const int obs[2] = {ob0, ob1};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (obs[h] > 32) {
          run.put((uint32_t)ov[h], 32);
          run.put((uint32_t)(ov[h] >> 32), obs[h] - 32);
        } else {
          run.put((uint32_t)ov[h], obs[h]);
        }
      }
    }
    run.finish();
  }
  *A_out = A;
  *O_out = O;
}

// a warp a row: row r is chain r (row_chains null, V = 1), or the page
// whose V vars' chains row_chains[r] names (-1: a var without a chain)
template <bool SMEM>
__global__ void __launch_bounds__(MAX_WARPS * 32) section_pack_kernel(
    const int* __restrict__ p1, const u64* __restrict__ offsets, int page_n, const long long* __restrict__ row_chains,
    int V, uint32_t* __restrict__ out, int W, long long* __restrict__ ans_len, long long* __restrict__ off_len,
    long long* __restrict__ total_bits, int n_rows) {
  extern __shared__ uint4 s_rows[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long r = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= n_rows) return;
  uint4* grow = reinterpret_cast<uint4*>(out + r * W);
  uint4* row4 = SMEM ? s_rows + (long long)warp * (W >> 2) : grow;
  for (int i = lane; i < (W >> 2); i += 32) row4[i] = make_uint4(0, 0, 0, 0);
  __syncwarp();
  Run run{reinterpret_cast<uint32_t*>(row4), W, 0, 0, 0ull};
  const int B = page_n / BATCH;
  long long chain[MAX_VARS];
#pragma unroll
  for (int v = 0; v < MAX_VARS; ++v) chain[v] = v >= V ? -1 : row_chains ? __ldg(row_chains + r * V + v) : r;
  long long cur = 0;
  for (int b = 0; b < B; ++b) {
#pragma unroll
    for (int v = 0; v < MAX_VARS; ++v) {
      if (v >= V) break;
      const long long c = chain[v];
      long long A = 0, O = 0;
      if (c >= 0) pack_batch(p1 + c * page_n, offsets + c * page_n, b, lane, run, cur, &A, &O);
      if (lane == 0) {
        ans_len[(r * V + v) * B + b] = A;
        off_len[(r * V + v) * B + b] = O;
      }
      cur += A + O;
    }
  }
  if (lane == 0) total_bits[r] = cur;
  if (SMEM) {
    __syncwarp();
    for (int i = lane; i < (W >> 2); i += 32) grow[i] = row4[i];
  }
}

struct DeviceInfo {
  bool ready = false;
  int optin = 0;  // opt-in shared memory of a block, bytes
};

DeviceInfo g_info[MAX_DEVICES];

cudaError_t device_info(int device, const DeviceInfo** out) {
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  DeviceInfo& d = g_info[device];
  if (!d.ready) {
    cudaError_t err;
    if ((err = cudaDeviceGetAttribute(&d.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) != cudaSuccess)
      return err;
    if ((err = cudaFuncSetAttribute(section_pack_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    d.optin)) != cudaSuccess)
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

}  // namespace

// Longest row (words) the shared-memory route stages on `device`; 0 if the
// device cannot be read.
extern "C" long long section_pack_smem_words(int device) {
  const DeviceInfo* info = nullptr;
  if (use_device(device) != cudaSuccess || device_info(device, &info) != cudaSuccess) return 0;
  return info->optin / 4;
}

// p1 (n_chains, page_n) int32 and offsets (n_chains, page_n) u64 from K5,
// row_chains (n_rows, V) int64 or null (a row a chain, n_rows = n_chains,
// V = 1) -> out (n_rows, sec_words) u32 rows, ans_len and off_len (n_rows,
// V, page_n / 256) and total_bits (n_rows,) int64. warps: rows a block.
extern "C" int section_pack(const void* p1, const void* offsets, int page_n, const void* row_chains, int V, void* out,
                            int sec_words, void* ans_len, void* off_len, void* total_bits, int n_rows, int warps,
                            int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const DeviceInfo* info = nullptr;
  if ((err = device_info(device, &info)) != cudaSuccess) return (int)err;
  if (page_n < BATCH || page_n % BATCH || sec_words < 4 || sec_words % 4 || sec_words > (1 << 26) ||
      warps < 1 || warps > MAX_WARPS || n_rows < 0 || V < 1 || V > MAX_VARS || (!row_chains && V != 1))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const long long fit = info->optin / (4LL * sec_words);
  const int per_block = (int)(fit < warps ? (fit < 1 ? warps : fit) : warps);
  const unsigned blocks = (unsigned)((n_rows + per_block - 1) / per_block);
  const auto a = static_cast<const int*>(p1);
  const auto o = static_cast<const u64*>(offsets);
  const auto rc = static_cast<const long long*>(row_chains);
  auto r = static_cast<uint32_t*>(out);
  auto al = static_cast<long long*>(ans_len);
  auto ol = static_cast<long long*>(off_len);
  auto tb = static_cast<long long*>(total_bits);
  if (fit >= 1)
    section_pack_kernel<true><<<blocks, per_block * 32, (size_t)per_block * sec_words * 4, s>>>(
        a, o, page_n, rc, V, r, sec_words, al, ol, tb, n_rows);
  else
    section_pack_kernel<false><<<blocks, per_block * 32, 0, s>>>(a, o, page_n, rc, V, r, sec_words, al, ol, tb,
                                                                  n_rows);
  return (int)cudaGetLastError();
}

extern "C" const char* pcodec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
