// K2 chain_decode: interleaved tANS decode of PCT container chains.
//
// Replaces: pcodec_tpu/ops/pallas_decode.py::_decode_kernel_impl (launched
// by _decode_call), the TPU kernel that decodes 256 chains per (8, 128) tile
// with lane gathers and u32-pair arithmetic.
//
// What bounds it on Hopper: the function is bound by bytes (the staged
// sections read once, 8 bytes per decoded number written once), but each
// chain is a serial chain of dependent table lookups and bit reads (a
// symbol's ANS bits and offset width follow from its state, the next
// state from those bits), and the main path has one chain a thread:
// 65,536 threads, 16 warps an SM. The earlier design was bound by memory
// instructions instead: every symbol re-read its ANS and offset
// bits with 4-5 scattered 4-byte loads from the chain's staging row (a
// number codes about 7 bits, so each word was loaded about four times),
// and every round stored 32 bytes at an 8 KB stride between lanes, so
// each warp instruction touched 32 lines. What bounds this design is the
// chain's latency at that occupancy (PERF.md).
//
// What the design does about it: one thread a chain, the 4 interleaved
// streams unrolled, reads each of a batch's two sections once and in
// order, a round at a time. A round's 4 ANS widths and 4 offset widths are
// known once its 4 node loads return, so its ANS bits (at most 60) are
// read at once from the 64 at the ANS cursor, each stream's at the sum of
// the widths before it, and so are its offsets when they total at most 64
// bits (else one by one); each reader then advances once a round. Each
// reader keeps the three staging words that hold its cursor in registers;
// the ANS reader loads its next word an advance ahead, the offset reader
// its next 12 words into a per-thread ring in shared memory by cp.async
// (words shifted through registers would make each copy wait on its
// load). Bit positions are 32-bit, and rounds whose symbols are all valid
// skip the validity selects. A block of 128 chains shares one chunk table
// in dynamic shared memory (u64 lower + u32 node per state, at most 2^14
// states = 192 KB) and stages each tile of 4 rounds (16 numbers a chain)
// in shared memory; the block then stores the tile two chain rows a warp
// store, a lane a number, so a store is two 128-byte runs. In the fused
// forms (FUSE 1/2) the order-1 delta and the Classic join run here, so
// the kernel writes the numbers' final memory bits.
//
// Round order follows the JAX kernel: at each batch the ANS and offset
// cursors restart from the directory cursors; within a round stream j
// reads after streams < j, so each of a batch's two sections is one
// stream in symbol order; symbols at k >= body_n read nothing and leave
// the state as it was (and decode lower[state] with no offset); words
// outside the row read as its first or last word.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CHAINS_PER_BLOCK = 128;
constexpr int BATCH = 256;
constexpr int TILE_ROUNDS = 4;
constexpr int TILE = 4 * TILE_ROUNDS;  // numbers a chain stages in shared memory before the block stores them
constexpr int TILES_PER_BATCH = BATCH / TILE;
constexpr int OUT_ROW = TILE + 1;  // u64 a chain row of the staging; odd: no bank conflicts
constexpr int WARPS = CHAINS_PER_BLOCK / 32;
constexpr int TILE_CHAINS = 32 / TILE;  // chain rows a warp stores at once
constexpr int RING = 16;        // words of a thread's offset ring in shared memory
constexpr int RING_STRIDE = RING + 1;  // odd: no bank conflicts between threads
constexpr int RING_AHEAD = 12;  // offset words in flight ahead of the window
constexpr unsigned long long TOP = 0x8000000000000000ull;

__device__ __forceinline__ uint32_t word_at(const uint32_t* row, int w, int W) {
  w = w < 0 ? 0 : (w > W - 1 ? W - 1 : w);
  return row[w];
}

// A directory cursor as a 32-bit bit position. Past +-2^30 a whole batch
// (at most 256 x 127 bits) reads only the row's last or first word, as
// the cursor itself would (rows hold under 2^25 words), so the position
// is moved to +-2^30 keeping its low 5 bits.
__device__ __forceinline__ int bit_pos(long long bit) {
  constexpr long long FAR = 1ll << 30;
  return (int)(bit > FAR ? FAR + (bit & 31) : bit < -FAR ? -FAR + (bit & 31) : bit);
}

// The 64 bits at bit `sh` of the word triple (w0, w1, w2).
__device__ __forceinline__ unsigned long long bits64(uint32_t w0, uint32_t w1, uint32_t w2, int sh) {
  return ((unsigned long long)__funnelshift_r(w1, w2, sh) << 32) | __funnelshift_r(w0, w1, sh);
}

// ANS bits of one batch, in order: the staging words at pos >> 5 and the
// two after it in registers (a round's at most 60 bits lie in the 64 at
// the cursor), the next word loaded one advance ahead
struct AnsReader {
  int pos;
  int next;  // index of the word held in `pre`
  uint32_t w0, w1, w2, pre;

  __device__ __forceinline__ void start(const uint32_t* row, int bit, int W) {
    pos = bit;
    const int w = bit >> 5;
    w0 = word_at(row, w, W);
    w1 = word_at(row, w + 1, W);
    w2 = word_at(row, w + 2, W);
    next = w + 3;
    pre = word_at(row, next, W);
  }

  __device__ __forceinline__ unsigned long long peek() const { return bits64(w0, w1, w2, pos & 31); }

  // past n (at most 64) bits
  __device__ __forceinline__ void advance(const uint32_t* row, int n, int W) {
    const int adv = ((pos & 31) + n) >> 5;  // words passed
    pos += n;
    if (adv == 1) {
      w0 = w1;
      w1 = w2;
      w2 = pre;
      pre = word_at(row, ++next, W);
    } else if (adv == 2) {
      w0 = w2;
      w1 = pre;
      w2 = word_at(row, next + 1, W);
      next += 2;
      pre = word_at(row, next, W);
    }
  }
};

__device__ __forceinline__ void cp_async_word(uint32_t* dst, const uint32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// offset bits of one batch, in order: the staging words at pos >> 5 and the
// two after it (the 95 bits an offset of up to 64 bits can span) in
// registers, the next RING_AHEAD words on their way into the thread's ring
// in shared memory (cp.async, a group a word, so that no register waits on
// a load until the word is due)
struct OffsetReader {
  int pos;
  int next;  // index of the next word to fetch
  uint32_t w0, w1, w2;
  uint32_t* ring;  // RING words, word x at x % RING

  __device__ __forceinline__ void fetch(const uint32_t* row, int W) {
    cp_async_word(ring + (next & (RING - 1)), row + (next < 0 ? 0 : (next > W - 1 ? W - 1 : next)));
    ++next;
  }

  __device__ __forceinline__ void start(const uint32_t* row, int bit, int W) {
    cp_async_wait<0>();  // no copy of the last batch still lands in the ring
    pos = bit;
    const int w = bit >> 5;
    w0 = word_at(row, w, W);
    w1 = word_at(row, w + 1, W);
    w2 = word_at(row, w + 2, W);
    next = w + 3;
#pragma unroll
    for (int i = 0; i < RING_AHEAD; ++i) fetch(row, W);
  }

  __device__ __forceinline__ unsigned long long peek() const { return bits64(w0, w1, w2, pos & 31); }

  // past n bits (n over 64, from no valid table, reloads the window)
  __device__ __forceinline__ void advance(const uint32_t* row, int n, int W) {
    const int adv = ((pos & 31) + n) >> 5;  // words passed
    pos += n;
    if (adv == 1) {
      cp_async_wait<RING_AHEAD - 1>();  // the oldest word in flight has landed
      w0 = w1;
      w1 = w2;
      w2 = ring[(next - RING_AHEAD) & (RING - 1)];
      fetch(row, W);
    } else if (adv == 2) {
      cp_async_wait<RING_AHEAD - 2>();
      w0 = w2;
      w1 = ring[(next - RING_AHEAD) & (RING - 1)];
      w2 = ring[(next - RING_AHEAD + 1) & (RING - 1)];
      fetch(row, W);
      fetch(row, W);
    } else if (adv > 2) {
      start(row, pos, W);
    }
  }

  // the next `ob` bits (all 64 for ob >= 64)
  __device__ __forceinline__ unsigned long long take(const uint32_t* row, int ob, int W) {
    unsigned long long v = peek();
    if (ob < 64) v &= (1ull << ob) - 1ull;
    advance(row, ob, W);
    return v;
  }
};

// One round of a chain: symbol k0 + j of stream j, j = 0..3, its number
// into dst[j]. The round's ANS bits (at most 4 x 15) are read at once from
// the 64 at the ANS cursor, each stream's at the sum of the widths before
// it; so are its offsets when they total at most 64 bits, else one by
// one. CHECK: some symbol of the round may be at k >= bn.
template <int FUSE, bool CHECK>
__device__ __forceinline__ void decode_round(const uint32_t* row, int W, int ts, const uint32_t* s_node,
                                             const unsigned long long* s_lower, uint32_t (&st)[4],
                                             AnsReader& ans, OffsetReader& offs, unsigned long long& acc,
                                             unsigned long long* dst, int k0, long long bn) {
  uint32_t s[4], nd[4];
  int bits[4], ob[4];
  bool valid[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s[j] = st[j] < (uint32_t)ts ? st[j] : (uint32_t)(ts - 1);
    nd[j] = s_node[s[j]];
  }
  int n_ans = 0, n_off = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    valid[j] = !CHECK || k0 + j < bn;
    bits[j] = valid[j] ? (int)(nd[j] & 15u) : 0;
    ob[j] = valid[j] ? (int)((nd[j] >> 4) & 127u) : 0;
    n_off += ob[j];
  }
  const unsigned long long ua = ans.peek();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t aval = (uint32_t)(ua >> n_ans) & ((1u << bits[j]) - 1u);
    n_ans += bits[j];
    if (valid[j]) st[j] = (nd[j] >> 11) + aval;
  }
  ans.advance(row, n_ans, W);
  unsigned long long off[4];
  if (n_off <= 64) {
    const unsigned long long uo = offs.peek();
    int at = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      off[j] = ob[j] == 0 ? 0ull : (uo >> at) & (ob[j] < 64 ? (1ull << ob[j]) - 1ull : ~0ull);
      at += ob[j];
    }
    offs.advance(row, n_off, W);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) off[j] = offs.take(row, ob[j], W);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned long long lat = s_lower[s[j]] + off[j];
    if (FUSE) {
      // order-1 delta: number k = moment + sum_{i<k} (latent_i + 2^63)
      dst[j] = FUSE == 1 ? (acc ^ TOP) : acc;
      if (valid[j]) acc += lat + TOP;
    } else {
      dst[j] = lat;
    }
  }
}

template <int FUSE>
__global__ void __launch_bounds__(CHAINS_PER_BLOCK) chain_decode_kernel(
    const uint32_t* __restrict__ stg, int W, const long long* __restrict__ word0,
    const long long* __restrict__ curs, int n_batches, const long long* __restrict__ states0,
    const long long* __restrict__ body_n, const long long* __restrict__ table_id,
    const uint32_t* __restrict__ node, const unsigned long long* __restrict__ lower, int ts,
    const unsigned long long* __restrict__ moment0, unsigned long long* __restrict__ out) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* s_lower = smem;
  unsigned long long* s_out = s_lower + ts;  // each chain's numbers of the tile
  uint32_t* s_node = reinterpret_cast<uint32_t*>(s_out + CHAINS_PER_BLOCK * OUT_ROW);
  uint32_t* s_ring = s_node + ts;

  const long long c0 = (long long)blockIdx.x * CHAINS_PER_BLOCK;
  const long long tbl = table_id[c0] * ts;
  for (int i = threadIdx.x; i < ts; i += CHAINS_PER_BLOCK) {
    s_lower[i] = lower[tbl + i];
    s_node[i] = node[tbl + i];
  }
  const int page_n = n_batches * BATCH;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const long long c = c0 + threadIdx.x;
  const uint32_t* row = stg + c * W;
  const long long base = word0[c] << 5;
  const long long bn = body_n[c];
  const long long* cc = curs + c * 2 * n_batches;
  uint32_t st[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) st[j] = (uint32_t)states0[c * 4 + j];
  unsigned long long acc = FUSE ? moment0[c] : 0ull;
  unsigned long long* mine = s_out + threadIdx.x * OUT_ROW;
  AnsReader ans;
  OffsetReader offs;
  offs.ring = s_ring + threadIdx.x * RING_STRIDE;
  __syncthreads();  // the table is in

  for (int t = 0; t < n_batches * TILES_PER_BATCH; ++t) {
    const int kt = t * TILE;
    if (t % TILES_PER_BATCH == 0) {
      const int b = t / TILES_PER_BATCH;
      ans.start(row, bit_pos(cc[2 * b] - base), W);
      offs.start(row, bit_pos(cc[2 * b + 1] - base), W);
    }
    if (kt + TILE <= bn) {
#pragma unroll 2
      for (int r = 0; r < TILE_ROUNDS; ++r)
        decode_round<FUSE, false>(row, W, ts, s_node, s_lower, st, ans, offs, acc, mine + 4 * r, kt + 4 * r, bn);
    } else {
      for (int r = 0; r < TILE_ROUNDS; ++r)
        decode_round<FUSE, true>(row, W, ts, s_node, s_lower, st, ans, offs, acc, mine + 4 * r, kt + 4 * r, bn);
    }
    __syncthreads();
    // store: a warp TILE_CHAINS chain rows of the tile at a time, a lane a number
    for (int cl = warp * TILE_CHAINS + lane / TILE; cl < CHAINS_PER_BLOCK; cl += WARPS * TILE_CHAINS)
      out[(c0 + cl) * page_n + kt + lane % TILE] = s_out[cl * OUT_ROW + lane % TILE];
    __syncthreads();
  }
  cp_async_wait<0>();
}

template <int FUSE>
cudaError_t launch(const uint32_t* stg, int W, const long long* word0, const long long* curs,
                   int n_batches, const long long* states0, const long long* body_n,
                   const long long* table_id, const uint32_t* node,
                   const unsigned long long* lower, int ts, const unsigned long long* moment0,
                   unsigned long long* out, int n_chains, cudaStream_t stream) {
  const size_t smem = (size_t)ts * (sizeof(unsigned long long) + sizeof(uint32_t)) +
                      (size_t)CHAINS_PER_BLOCK * (OUT_ROW * sizeof(unsigned long long) + RING_STRIDE * sizeof(uint32_t));
  cudaError_t err = cudaFuncSetAttribute(chain_decode_kernel<FUSE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  chain_decode_kernel<FUSE><<<n_chains / CHAINS_PER_BLOCK, CHAINS_PER_BLOCK, smem, stream>>>(
      stg, W, word0, curs, n_batches, states0, body_n, table_id, node, lower, ts, moment0, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int chain_decode(const void* stg, int W, const void* word0, const void* curs,
                            int n_batches, const void* states0, const void* body_n,
                            const void* table_id, const void* node, const void* lower, int ts,
                            const void* moment0, void* out, int n_chains, int fuse, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_chains % CHAINS_PER_BLOCK || W < 1 || W > (1 << 25) || ts < 1 || fuse < 0 || fuse > 2)
    return (int)cudaErrorInvalidValue;
  if (n_chains == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto a0 = static_cast<const uint32_t*>(stg);
  auto a2 = static_cast<const long long*>(word0);
  auto a3 = static_cast<const long long*>(curs);
  auto a5 = static_cast<const long long*>(states0);
  auto a6 = static_cast<const long long*>(body_n);
  auto a7 = static_cast<const long long*>(table_id);
  auto a8 = static_cast<const uint32_t*>(node);
  auto a9 = static_cast<const unsigned long long*>(lower);
  auto a11 = static_cast<const unsigned long long*>(moment0);
  auto a12 = static_cast<unsigned long long*>(out);
  if (fuse == 1)
    err = launch<1>(a0, W, a2, a3, n_batches, a5, a6, a7, a8, a9, ts, a11, a12, n_chains, s);
  else if (fuse == 2)
    err = launch<2>(a0, W, a2, a3, n_batches, a5, a6, a7, a8, a9, ts, a11, a12, n_chains, s);
  else
    err = launch<0>(a0, W, a2, a3, n_batches, a5, a6, a7, a8, a9, ts, a11, a12, n_chains, s);
  return (int)err;
}

extern "C" const char* pcodec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
