// K7 image_stitch: the file image of a PCT container from the encode's
// sections, final tANS states and page moments: the body (every chunk's
// prefix, then its pages, each [page meta | sections], at arbitrary byte
// offsets) and the head's device part (each page's bytes and each batch's
// u16 ANS and offset lengths).
//
// Replaces: pcodec_tpu/ops/assemble.py::_stitch_pass_kernel (launched by
// _stitch_pass through stitch_pallas), the TPU kernel that places
// pre-shifted row streams into superblocks of the body, and with it the XLA
// glue in front of it that builds those rows (_prepare_image, _core_prep):
// the page metas bit-packed field by field, the sections merged behind them,
// both byte-shifted to their destinations, the page offsets and the head.
//
// What bounds it on Hopper: bytes. The function reads each page's payload
// words once (its sections up to its total bits), the states, moments and
// lengths, and writes each body and head word once. Building rows first, as
// the reference does, moves several times that through temporaries as wide
// as the widest page.
//
// What the design does about it: no rows. Two C calls, three kernels.
//   image_offsets: a thread a page writes its head words (page bytes, the
//     u16 entries of its batches), its record (chunk, K6 row, prefix and meta
//     bytes) and its row's first 4 bytes, and a block's exclusive scan of
//     the pages' byte lengths (prefix + meta + sections) gives each page its
//     offset within its block; one block then scans the blocks' sums. The
//     wrapper reads the body's byte count back (the one host sync) and sizes
//     the body.
//   image_stitch: each body word is written once, by the page that holds
//     its first byte, so the body needs no memset and no atomics: a lane
//     builds word w from the page's sources (the chunk prefix on a chunk's
//     first page, the meta, the section words), each funnel-shifted to its
//     byte offset; the last word, when the page ends inside it, also takes
//     the next page's first 4 bytes. A page is some 900 bytes, so the kernel
//     is latency-bound before it is bytes-bound: a warp places a run of
//     consecutive pages (kernels.K7_PAGES_PER_WARP, from chip_smoke.py's
//     sweep), a page at a time, and what a page needs before its section
//     words (its bounds and record, the next page's first bytes) is one
//     round of independent loads, issued while the page before is placed;
//     the meta is packed a word a lane beside the section loads and reaches
//     its body words by shuffles; a lane has 4 body words' section words in
//     flight (coalesced across the warp), each loaded once (the word before
//     a lane's is its neighbour's, by a shuffle); registers are capped for
//     32 warps an SM. Only a chunk's first page (its prefix) and a page
//     followed by pages shorter than 4 bytes call out-of-line code. A word
//     outside the body stops the kernel with a device error.
// Meta groups (chunks of different order, bits or ANS size log) and trivial
// chunks (no chain: a meta of zero indices, no sections) are rows of one
// descriptor table, so one launch places every page. A chunk of several
// latent vars (a lookback delta's lookbacks, IntMult's and the float
// modes' secondary) is a row too: its pages' sections are K6's rows of the
// page, its vars interleaved already, and its meta and directory entries
// are every var's in file order (per var: its delta states, then its 4
// state indices; per page, per var, its batches' lengths), each var's
// states read from its own chains. Nothing is staged in
// shared memory, so a page of any width takes the same path.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u32 = unsigned int;
using u64 = unsigned long long;
using i64 = long long;
constexpr unsigned FULL = 0xffffffffu;

// a row a chunk (assemble.IMAGE_COLS): a page's sections are K6's row ROW0
// plus the page's index in the chunk (-1: none), and per var (up to
// MAX_VARS, VAR_COLS columns each from CHAIN0_0) its final states are those
// of its chain CHAIN0_v plus the page's index (-1: a trivial var)
enum Col {
  FIRST_PAGE, N_PAGES, ROW0, N_VARS, META_BITS, META_BYTES, PFX_BYTES, PFX_WORD, FIRST_ENTRY, BATCHES,
  LAST_BATCHES,
  CHAIN0_0, N_STATE_0, STATE_BITS_0, SL_0, TS_0, MOM_COL_0,
  CHAIN0_1, N_STATE_1, STATE_BITS_1, SL_1, TS_1, MOM_COL_1,
  CHAIN0_2, N_STATE_2, STATE_BITS_2, SL_2, TS_2, MOM_COL_2,
  COLS
};
constexpr int MAX_VARS = 3;  // latent vars a chunk's row names
constexpr int VAR_COLS = CHAIN0_1 - CHAIN0_0;
constexpr int SCAN_THREADS = 256;  // pages a block of image_offsets scans
constexpr int LAST_THREADS = 1024;  // threads of the block that scans the blocks' sums
constexpr int WARPS = 8;           // pages (warps) a block of image_stitch

// the last chunk whose first page is <= p
__device__ int find_chunk(const i64* __restrict__ desc, int n_chunks, i64 p) {
  int lo = 0, hi = n_chunks - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(desc + (i64)mid * COLS + FIRST_PAGE) <= p) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// exclusive scan of v over the block; *total gets the block's sum
__device__ i64 block_excl_scan(i64 v, i64* total) {
  __shared__ i64 warp_sum[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  i64 x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const i64 y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    i64 t = lane < warps ? warp_sum[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const i64 y = __shfl_up_sync(FULL, t, o);
      if (lane >= o) t += y;
    }
    warp_sum[lane] = t;
  }
  __syncthreads();
  const i64 before = warp ? warp_sum[warp - 1] : 0;
  *total = warp_sum[warps - 1];
  __syncthreads();  // warp_sum is free for the next call
  return before + x - v;
}

// word i of the meta of page j of a chunk, LSB first: per var its N_STATE
// delta states (from the page's states at MOM_COL) at STATE_BITS each, then
// its 4 final state indices (state - table size, zero for a trivial var)
// at SL bits. Where K6's rows are the chains (VK == 1: one var a chunk),
// the var's chain is the page's row, known from its record, so its states
// load beside its fields; var 0's fields load before the loop over the
// others (a placement is latency-bound: one round of loads, not two)
__device__ u32 meta_word(const i64* __restrict__ d, const i64* __restrict__ mom, const i64* __restrict__ states,
                         i64 j, i64 row, int VK, i64 i) {
  u32 w = 0;
  i64 cur = -32 * i;
  auto field = [&](u64 val, int len) {
    if (len && cur < 32 && cur + len > 0) {
      if (len < 64) val &= (1ull << len) - 1;
      w |= (u32)(cur >= 0 ? val << cur : val >> -cur);
    }
    cur += len;
  };
  auto var = [&](const i64* f, i64 chain) {
    const int ns = (int)__ldg(f + N_STATE_0 - CHAIN0_0), bits = (int)__ldg(f + STATE_BITS_0 - CHAIN0_0);
    const int sl = (int)__ldg(f + SL_0 - CHAIN0_0);
    const i64 ts = __ldg(f + TS_0 - CHAIN0_0);
    const i64* m = mom + __ldg(f + MOM_COL_0 - CHAIN0_0);
    const i64* st = chain >= 0 ? states + chain * 4 : nullptr;
    for (int k = 0; k < ns; k++) field((u64)__ldg(m + k), bits);
    for (int k = 0; k < 4; k++) field(st ? (u64)(__ldg(st + k) - ts) : 0, sl);
  };
  auto chain_of = [&](const i64* f) {
    const i64 c0 = __ldg(f);
    return c0 >= 0 ? c0 + j : -1;
  };
  const int nv = (int)__ldg(d + N_VARS);
  var(d + CHAIN0_0, VK == 1 ? row : chain_of(d + CHAIN0_0));  // every chunk has its primary
  for (int v = 1; v < nv; v++) var(d + CHAIN0_0 + v * VAR_COLS, chain_of(d + CHAIN0_0 + v * VAR_COLS));
  return w;
}

// per page: its chunk, its row of K6's (-1: none), the prefix bytes before
// it (0 but on a chunk's first page) and its meta bytes
struct PageRec {
  int chunk, row, pfx, meta;
};

__global__ void __launch_bounds__(SCAN_THREADS) image_sums_kernel(
    const i64* __restrict__ desc, int n_chunks, const i64* __restrict__ total_bits, const i64* __restrict__ ans_len,
    const i64* __restrict__ off_len, int VK, int B, const u32* __restrict__ sections, int W,
    const i64* __restrict__ states, const i64* __restrict__ moments, int MO, const u32* __restrict__ pfx_words,
    const u32* __restrict__ head_host, int H, i64 R, i64 E, u32* __restrict__ head, i64* __restrict__ local,
    i64* __restrict__ block_sum, PageRec* __restrict__ rec, u32* __restrict__ first_word) {
  const i64 p = (i64)blockIdx.x * SCAN_THREADS + threadIdx.x;
  for (i64 i = p; i < H; i += (i64)gridDim.x * SCAN_THREADS) head[i] = head_host[i];
  i64 row = 0;
  if (p < R) {
    const int c = find_chunk(desc, n_chunks, p);
    const i64* d = desc + (i64)c * COLS;
    const i64 j = p - d[FIRST_PAGE];
    const i64 krow = d[ROW0] >= 0 ? d[ROW0] + j : -1;
    const i64 tb = krow >= 0 ? total_bits[krow] : 0;
    const i64 mb = d[META_BYTES], pfx = j == 0 ? d[PFX_BYTES] : 0;
    const i64 page_bytes = mb + ((tb + 7) >> 3);
    head[H + p] = (u32)page_bytes;
    row = page_bytes + pfx;
    // the directory's u16 entries: every batch's ANS lengths, then every
    // batch's offset lengths, in (page, var, batch) order; K6's lengths are
    // per (row, var < VK, batch)
    unsigned short* h16 = reinterpret_cast<unsigned short*>(head + H + R);
    const i64 nv = d[N_VARS];
    const i64 e0 = d[FIRST_ENTRY] + j * nv * d[BATCHES];
    const i64 nbat = j == d[N_PAGES] - 1 ? d[LAST_BATCHES] : d[BATCHES];
    for (i64 v = 0; v < nv; v++) {
      const i64* al = ans_len + (krow * VK + v) * B;
      const i64* ol = off_len + (krow * VK + v) * B;
      for (i64 b = 0; b < nbat; b++) {
        h16[e0 + v * nbat + b] = krow >= 0 ? (unsigned short)al[b] : 0;
        h16[E + e0 + v * nbat + b] = krow >= 0 ? (unsigned short)ol[b] : 0;
      }
    }
    // the row's first 4 bytes, for the page before it whose last word
    // they complete: prefix, meta and sections, each zero past its bytes
    u32 w0 = pfx ? pfx_words[d[PFX_WORD]] : 0;
    if (pfx < 4 && mb) w0 |= meta_word(d, moments + p * MO, states, j, krow, VK, 0) << (8 * pfx);
    if (pfx + mb < 4 && tb) w0 |= sections[krow * W] << (8 * (pfx + mb));
    rec[p] = PageRec{c, (int)krow, (int)pfx, (int)mb};
    first_word[p] = w0;
  }
  i64 total;
  const i64 before = block_excl_scan(row, &total);
  if (p < R) local[p] = before;
  if (threadIdx.x == 0) block_sum[blockIdx.x] = total;
}

__global__ void __launch_bounds__(LAST_THREADS) image_blocks_kernel(const i64* __restrict__ block_sum, i64 nblk,
                                                                    i64* __restrict__ block_start) {
  i64 carry = 0;
  for (i64 base = 0; base < nblk; base += LAST_THREADS) {
    const i64 i = base + threadIdx.x;
    i64 total;
    const i64 before = block_excl_scan(i < nblk ? block_sum[i] : 0, &total);
    if (i < nblk) block_start[i] = carry + before;
    carry += total;
  }
  if (threadIdx.x == 0) block_start[nblk] = carry;  // the body's bytes
}

struct Offsets {
  const i64* local;
  const i64* block_start;
  i64 R, nblk;
  // first byte of page q's row (its chunk's prefix first); R: the body's end
  __device__ i64 operator()(i64 q) const {
    return q < R ? __ldg(local + q) + __ldg(block_start + q / SCAN_THREADS) : __ldg(block_start + nblk);
  }
};

// body word w's bits from the prefix words of a chunk's first page, which
// begin at byte `at` (out of line: 1 page a chunk takes it)
__device__ __noinline__ u32 prefix_bits(const u32* __restrict__ pfx, i64 nw, i64 at, i64 w) {
  const i64 i = w - (at >> 2);
  const u32 hi = i >= 0 && i < nw ? __ldg(pfx + i) : 0;
  const u32 lo = i >= 1 && i <= nw ? __ldg(pfx + i - 1) : 0;
  return __funnelshift_l(lo, hi, 8 * (int)(at & 3));
}

// body word w's bits from the pages from q on that begin inside it (out of
// line: only pages shorter than 4 bytes leave a word to more than one next)
__device__ __noinline__ u32 later_pages_bits(i64 q, i64 w, const u32* __restrict__ first_word, Offsets start) {
  u32 v = 0;
  for (; q < start.R; q++) {
    const i64 sq = start(q);
    if (sq >= 4 * (w + 1)) break;
    v |= __ldg(first_word + q) << (8 * (int)(sq - 4 * w));
  }
  return v;
}

constexpr int UNROLL = 4;  // body words a lane has in flight

// what placing page q needs besides its first byte: its end, the next
// page's end and first 4 bytes, its record
struct Bounds {
  i64 e, e_next;
  u32 w0_next;
  PageRec r;
};

__device__ __forceinline__ Bounds bounds(i64 q, Offsets start, const PageRec* __restrict__ rec,
                                         const u32* __restrict__ first_word) {
  const bool next = q + 1 < start.R;
  Bounds b;
  b.e = start(q + 1);
  b.e_next = next ? start(q + 2) : b.e;
  b.w0_next = next ? __ldg(first_word + q + 1) : 0;
  b.r = rec[q];
  return b;
}

// page p's words: those whose first byte is the page's, from its bytes
// [s, b.e) and the first bytes of the pages after it
__device__ __forceinline__ void place_page(i64 p, i64 s, const Bounds& b, int lane, const i64* __restrict__ desc,
                                           const u32* __restrict__ first_word, Offsets start,
                                           const u32* __restrict__ sections, int W, const i64* __restrict__ states,
                                           const i64* __restrict__ moments, int MO, int VK,
                                           const u32* __restrict__ pfx_words, u32* __restrict__ body, i64 body_words) {
  const i64 e = b.e;
  const PageRec r = b.r;
  const i64 w_first = (s + 3) >> 2, w_last = (e - 1) >> 2;
  if (e <= s || w_first > w_last) return;
  const i64 meta_at = s + r.pfx, sec_at = meta_at + r.meta;
  const i64 sec_bytes_words = (e - sec_at + 3) >> 2;
  const i64 sec_n = sec_bytes_words < W ? sec_bytes_words : W;
  const u32* sec = sections + (r.row >= 0 ? (i64)r.row * W : 0);
  const i64 head_end = (sec_at - 1) >> 2;  // the last word holding prefix or meta bytes
  const i64 q_sec = sec_at >> 2, q_meta = meta_at >> 2;
  const int sh_sec = 8 * (int)(sec_at & 3), sh_meta = 8 * (int)(meta_at & 3);
  u32 hi[UNROLL];
  auto load = [&](i64 base) {  // the section words of a lane's next UNROLL body words, all in flight
#pragma unroll
    for (int k = 0; k < UNROLL; k++) {
      const i64 i = base + 32 * k + lane - q_sec;
      hi[k] = i >= 0 && i < sec_n ? __ldg(sec + i) : 0;
    }
  };
  load(w_first);
  // the section word before the first one loaded (the warp's first lane
  // takes its low bits), then each batch's last
  const i64 i0 = w_first - 1 - q_sec;
  u32 carry = i0 >= 0 && i0 < sec_n ? __ldg(sec + i0) : 0;
  // the page meta, word `lane` in lane `lane` (a meta of over 32 words,
  // conv1's of order 31 or 32, also word 32 + `lane` in mword2), packed
  // while the first loads are in flight (the wrapper admits metas of up to
  // 64 words)
  const i64* d = desc + (i64)r.chunk * COLS;
  const int meta_n = r.meta ? (int)((d[META_BITS] + 31) >> 5) : 0;
  const i64 j = p - d[FIRST_PAGE];
  const u32 mword = lane < meta_n ? meta_word(d, moments + p * MO, states, j, r.row, VK, lane) : 0;
  const bool wide = meta_n > 32;  // the warp's page: uniform
  const u32 mword2 = wide && lane + 32 < meta_n ? meta_word(d, moments + p * MO, states, j, r.row, VK, lane + 32) : 0;
  for (i64 base = w_first;;) {
#pragma unroll
    for (int k = 0; k < UNROLL; k++) {
      const i64 w = base + 32 * k + lane;
      // the section word before a lane's is its left neighbour's
      const u32 left = __shfl_up_sync(FULL, hi[k], 1);
      u32 v = __funnelshift_l(lane ? left : carry, hi[k], sh_sec);
      carry = __shfl_sync(FULL, hi[k], 31);
      if (base + 32 * k <= head_end) {  // the warp's words that hold prefix or meta bytes
        const i64 i = w - q_meta;
        u32 m_hi = __shfl_sync(FULL, mword, (int)(i & 31));
        u32 m_lo = __shfl_sync(FULL, mword, (int)((i - 1) & 31));
        if (wide) {  // meta words 32-63 from mword2 (i < 0 or i >= meta_n are masked below)
          const u32 h2 = __shfl_sync(FULL, mword2, (int)(i & 31));
          const u32 l2 = __shfl_sync(FULL, mword2, (int)((i - 1) & 31));
          if (i & 32) m_hi = h2;
          if ((i - 1) & 32) m_lo = l2;
        }
        v |= __funnelshift_l(i >= 1 && i <= meta_n ? m_lo : 0, i >= 0 && i < meta_n ? m_hi : 0, sh_meta);
        if (r.pfx && w <= w_last) v |= prefix_bits(pfx_words + d[PFX_WORD], (r.pfx + 3) >> 2, s, w);
      }
      if (w == w_last && (e & 3)) {  // the page ends inside w: the rest is the next pages' first bytes
        v |= b.w0_next << (8 * (int)(e - 4 * w_last));
        if (b.e_next < 4 * (w_last + 1) && p + 1 < start.R) v |= later_pages_bits(p + 2, w_last, first_word, start);
      }
      if (w <= w_last) {
        if (w >= body_words) __trap();
        body[w] = v;
      }
    }
    base += 32 * UNROLL;
    if (base > w_last) break;
    load(base);
  }
}

// a warp a run of `ppw` consecutive pages: the next page's bounds and
// record are loaded while a page is placed
__global__ void __launch_bounds__(32 * WARPS, 4) image_stitch_kernel(
    const i64* __restrict__ desc, const PageRec* __restrict__ rec, const u32* __restrict__ first_word, Offsets start,
    int ppw, const u32* __restrict__ sections, int W, const i64* __restrict__ states,
    const i64* __restrict__ moments, int MO, int VK, const u32* __restrict__ pfx_words, u32* __restrict__ body,
    i64 body_words) {
  const i64 p0 = ((i64)blockIdx.x * WARPS + (threadIdx.x >> 5)) * ppw;
  const int lane = threadIdx.x & 31;
  if (p0 >= start.R) return;
  const i64 p1 = p0 + ppw < start.R ? p0 + ppw : start.R;
  i64 s = start(p0);
  Bounds b = bounds(p0, start, rec, first_word);
  for (i64 p = p0; p < p1; p++) {
    const Bounds cur = b;
    if (p + 1 < p1) b = bounds(p + 1, start, rec, first_word);
    place_page(p, s, cur, lane, desc, first_word, start, sections, W, states, moments, MO, VK, pfx_words, body,
               body_words);
    s = cur.e;
  }
}

}  // namespace

// ans_len, off_len: K6's (rows, VK, B) section lengths. head (H + R + E
// words): the host words, then each page's bytes and the 2E u16 directory
// entries; scan (R + 2 nblk + 1 int64, nblk = ceil(R /
// SCAN_THREADS)): the pages' offsets within their blocks, each block's first
// byte and then the body's byte count, the blocks' sums; pages (5 R int32):
// each page's record (chunk, K6's row, prefix bytes, meta bytes), then its
// row's first 4 bytes
extern "C" int image_offsets(const void* desc, int n_chunks, const void* total_bits, const void* ans_len,
                             const void* off_len, int VK, int B, const void* sections, int W, const void* states,
                             const void* moments, int MO, const void* pfx_words, const void* head_host, int H,
                             long long R, long long E, void* head, void* scan, void* pages, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_chunks < 1 || R < 1 || H < 0 || E < 0 || VK < 1 || VK > MAX_VARS || B < 0 || W < 0 || MO < 0)
    return (int)cudaErrorInvalidValue;
  const long long nblk = (R + SCAN_THREADS - 1) / SCAN_THREADS;
  auto s = static_cast<cudaStream_t>(stream);
  i64* local = static_cast<i64*>(scan);
  PageRec* rec = static_cast<PageRec*>(pages);
  image_sums_kernel<<<(unsigned)nblk, SCAN_THREADS, 0, s>>>(
      static_cast<const i64*>(desc), n_chunks, static_cast<const i64*>(total_bits), static_cast<const i64*>(ans_len),
      static_cast<const i64*>(off_len), VK, B, static_cast<const u32*>(sections), W, static_cast<const i64*>(states),
      static_cast<const i64*>(moments), MO, static_cast<const u32*>(pfx_words), static_cast<const u32*>(head_host),
      H, R, E, static_cast<u32*>(head), local, local + R + nblk + 1, rec, reinterpret_cast<u32*>(rec + R));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  image_blocks_kernel<<<1, LAST_THREADS, 0, s>>>(local + R + nblk + 1, nblk, local + R);
  return (int)cudaGetLastError();
}

// VK: K6's var slots a row (1: K6's rows are the chains)
extern "C" int image_stitch(const void* desc, const void* pages, const void* scan, long long R, const void* sections,
                            int W, const void* states, const void* moments, int MO, int VK, const void* pfx_words,
                            void* body, long long body_words, int ppw, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R < 1 || W < 0 || MO < 0 || VK < 1 || VK > MAX_VARS || body_words < 1 || ppw < 1)
    return (int)cudaErrorInvalidValue;
  const long long warps = (R + ppw - 1) / ppw;
  const i64* local = static_cast<const i64*>(scan);
  const Offsets start{local, local + R, R, (R + SCAN_THREADS - 1) / SCAN_THREADS};
  const PageRec* rec = static_cast<const PageRec*>(pages);
  image_stitch_kernel<<<(unsigned)((warps + WARPS - 1) / WARPS), 32 * WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const i64*>(desc), rec, reinterpret_cast<const u32*>(rec + R), start, ppw,
      static_cast<const u32*>(sections), W, static_cast<const i64*>(states), static_cast<const i64*>(moments), MO, VK,
      static_cast<const u32*>(pfx_words), static_cast<u32*>(body), body_words);
  return (int)cudaGetLastError();
}

extern "C" const char* pcodec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
