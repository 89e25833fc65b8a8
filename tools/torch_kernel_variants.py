"""Variants of the port's E1, E3a, E3b, E4a, E4b and B5 kernels, timed on the card
against the committed ones: each variant is a text edit of a kernel source
(or an earlier tree's source as it is), built by nvcc beside the port's own
libraries and called through the same C entry point. A record of the runs
that chose the designs (PERF.md section 6), not part of the package:
nothing imports it, and an edit that no longer applies to the committed
source raises.

    python3 tools/torch_kernel_variants.py [--parent DIR] [--only e1|e3a|e3b|e4a|e4b|b5]

DIR is an earlier tree of the port (e.g. `git archive` of a parent under
`build/`). E1: its csrc/proto_dma.cu, where that is the earlier fetch
form (a bulk copy of each chain's section into shared memory), is timed
beside the committed kernel. E3a: its csrc/micro_gather.cu's route take,
where that is the earlier walk through the read-only path. E3b and E4a:
its routes taa and row as they are (in an earlier tree, a block's rows
staged by plain loads behind a block barrier; a thread an element). E4b: where its
round loop is the earlier design (a block a tile, the four window words
reloaded every round), its variants run. Every variant that computes
the function is held bit for bit against its plain version (E1, E3a,
E4b) or against the committed kernel's outputs on every page (B5, whose
committed kernel is held to its plain version on its first 64 pages);
those that drop work to expose its cost (named "no ...") are only timed.
E4a's variants are also held against torch.gather.
Card-alone medians (`hold=True`), each variant timed twice in turns, E1's
and B5's kernels also split by the profiler's trace; the card's name and
power limit beside every line. Needs a card and raises without one.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pcodec_tpu_torch.experiments import common
from pcodec_tpu_torch.experiments import micro_gather as mg
from pcodec_tpu_torch.experiments import proto_dma as pd
from pcodec_tpu_torch.experiments import proto_round_loop as prl
from pcodec_tpu_torch.ops import device_train as dt
from pcodec_tpu_torch.ops import kernels

VARIANT_DIR = os.path.join(kernels.BUILD_DIR, "variants")
B5_PAGES, B5_PAGE_N, B5_WNL = 32768, 1024, 15

_SMEM_TABLE = ("  __shared__ int4 s_node4[SUBLANES * TS / 4];\n"
               "  for (int i = threadIdx.x; i < SUBLANES * TS / 4; i += THREADS) s_node4[i] = node[i];\n"
               "  __syncthreads();\n", "")
# the committed round loop's edits
_E4B_NEW = {
    "committed": [],
    "one tile a block": [("constexpr int TILES_PER_BLOCK = 2;", "constexpr int TILES_PER_BLOCK = 1;"),
                         ("__launch_bounds__(THREADS, 4)", "__launch_bounds__(THREADS, 8)")],
    "four tiles a block": [("constexpr int TILES_PER_BLOCK = 2;", "constexpr int TILES_PER_BLOCK = 4;"),
                           ("__launch_bounds__(THREADS, 4)", "__launch_bounds__(THREADS, 2)")],
    "node table through L1": [_SMEM_TABLE, ("nd[j] = ntab[c][st[c][j]];", "nd[j] = __ldg(ntab[c] + st[c][j]);"),
                              ("ntab[c] = reinterpret_cast<const unsigned*>(s_node4) + s * TS;",
                               "ntab[c] = reinterpret_cast<const unsigned*>(node) + s * TS;")],
    "plain emit stores": [("__stcs(emit + (tile * rounds + r) * (SUBLANES * 32) + (o[c] & (SUBLANES * 32 - 1)),\n"
                           "               make_int4(st[c][0], st[c][1], st[c][2], st[c][3]));",
                           "emit[(tile * rounds + r) * (SUBLANES * 32) + (o[c] & (SUBLANES * 32 - 1))] =\n"
                           "            make_int4(st[c][0], st[c][1], st[c][2], st[c][3]);")],
}
# the earlier round loop's edits (a block a tile, W4 reloaded every round)
_E4B_OLD = {
    "earlier design": [],
    "earlier, node table through L1": [
        _SMEM_TABLE, ("const unsigned nd = ntab[x < TS ? x : (x & 127)];", "const unsigned nd = __ldg(ntab + (x < TS ? x : (x & 127)));"),
        ("const unsigned* ntab = reinterpret_cast<const unsigned*>(s_node4) + s * TS;",
         "const unsigned* ntab = reinterpret_cast<const unsigned*>(node) + s * TS;")],
    "earlier, no refill loads": [("for (int k = 0; k < 4; ++k) w[k] = row[(w0n + k) & 127];", "w[0] ^= w0n;")],
    "earlier, 128-thread blocks": [
        ("constexpr int THREADS = TILE_CHAINS;", "constexpr int THREADS = TILE_CHAINS / 2;"),
        ("  const long long tile = blockIdx.x;\n  const int s = threadIdx.x >> 5, g = threadIdx.x & 31;",
         "  const long long tile = blockIdx.x >> 1;\n"
         "  const int s = (threadIdx.x >> 5) + 4 * (blockIdx.x & 1), g = threadIdx.x & 31;"),
        ("round_kernel<<<n_tiles, THREADS,", "round_kernel<<<n_tiles * 2, THREADS,")],
}
_RED = "const u32 k0 = __reduce_max_sync(FULL, half ? 0u : key), k1 = __reduce_max_sync(FULL, half ? key : 0u);"
# the hash reads fused into the chain's block (pages of at most WARP_SORT_N
# numbers), the inserts kept sorted as u16 positions or u32 keys
_FUSED = """// Variant: the hash reads in the chain's own block (pages of at most
// WARP_SORT_N numbers). A half-warp a page as in chain_kernel; first the
// warp sorts each page's two coarsenesses' inserts in registers and keeps
// them sorted in shared memory (as positions, the hash recomputed from the
// staged latents, or as whole keys: FUSED_KEYS); then, every 32 positions,
// the whole warp searches the six proposals of the next 32 positions of
// both pages into a ring in shared memory, and the half-warps step through
// them.
constexpr int RING = 32;
template <typename S>
long long fused_page_bytes(long long m, int bits, int window_n_log) {
  return chain_page_bytes(m, bits, window_n_log) + 2 * align16(m * (long long)sizeof(S)) + HASH_SLOTS * RING * 2;
}

template <typename L, typename S>
__global__ void __launch_bounds__(32)
    fused_kernel(const u64* __restrict__ x, const long long* __restrict__ lens, long long m, int bits,
                 int window_n_log, int state_n, long long pages, long long page_smem, u32* __restrict__ lbs,
                 u64* __restrict__ prim, u64* __restrict__ states) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x, half = lane >> 4, t = lane & 15;
  const long long p = (long long)blockIdx.x * CHAIN_PAGES + half;
  const bool page_ok = p < pages;
  const long long cnt_n = count_slots(m, window_n_log);
  const long long off_srt = align16(m * (long long)sizeof(L)) + align16(2 * cnt_n);
  const long long srt_n = align16(m * (long long)sizeof(S)) / (long long)sizeof(S);
  L* xs = reinterpret_cast<L*>(smem + half * page_smem);
  u16* cs = reinterpret_cast<u16*>(smem + half * page_smem + align16(m * (long long)sizeof(L)));
  const S* srt = reinterpret_cast<const S*>(smem + half * page_smem + off_srt);
  u16* ring = reinterpret_cast<u16*>(smem + half * page_smem + off_srt + 2 * srt_n * (long long)sizeof(S));
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
  const u64 hmask = (2ull << window_n_log) - 1;
  for (int h = 0; h < CHAIN_PAGES; ++h) {  // the warp sorts page h's inserts, coarseness 0 then 8
    const long long lh = __shfl_sync(FULL, (unsigned)len, 16 * h);
    if (lh <= state_n) continue;
    const L* xh = reinterpret_cast<const L*>(smem + h * page_smem);
    S* sh = reinterpret_cast<S*>(smem + h * page_smem + off_srt);
    for (int c = 0; c < 2; ++c) {
      u32 k[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int e = lane * 32 + r;
        k[r] = e >= state_n && e < lh ? (u32)(hash_u64((u64)xh[e] >> (8 * c)) & hmask) << POS_BITS | (u32)e
                                      : 0xffffffffu;
      }
      warp_sort(k, lane);
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int e = lane * 32 + r;
        if (e < m) sh[c * srt_n + e] = sizeof(S) == 4 ? (S)k[r] : (S)(k[r] & POS_MASK);
      }
    }
  }
  __syncwarp();
  const int ilen = (int)len;
  const int iend = max(ilen, (int)__shfl_xor_sync(FULL, (unsigned)len, 16));
  const int n_ins = max(ilen - state_n, 0);
  const long long window_n = 1ll << window_n_log;
  const L mask = bits == 8 * (int)sizeof(L) ? ~L(0) : (L(1) << bits) - 1;
  const L mid = L(1) << (bits - 1);
  auto key_of = [&](int c, int e) -> u32 {
    const S s = srt[c * srt_n + e];
    if (sizeof(S) == 4) return (u32)s;
    return (u32)(hash_u64((u64)xs[s] >> (8 * c)) & hmask) << POS_BITS | (u32)s;
  };
  u32 prop = (u32)min(t + 1, state_n);
  u32 best_lb = 1, rep = 0;
  u32 mine = 0;
  for (int b0 = state_n & ~(RING - 1); b0 < iend; b0 += RING) {
    __syncwarp();  // the last batch's steps have read the ring
#pragma unroll
    for (int u = 0; u < 2; ++u) {  // lane t searches positions b0 + t and b0 + t + 16 of its page
      const int i = b0 + t + 16 * u;
      if (i < state_n || i >= m) continue;
      if (!page_ok) {
#pragma unroll
        for (int q = 0; q < HASH_SLOTS; ++q) ring[q * RING + (i & (RING - 1))] = 1;
        continue;
      }
      const u64 v = (u64)xs[i];
#pragma unroll
      for (int q = 0; q < HASH_SLOTS; ++q) {
        const int c = q < 3 ? 0 : 1;
        const u32 qh = (u32)(hash_u64((v >> (8 * c)) + (u64)(long long)(q % 3 - 1)) & hmask);
        const u32 key = qh << POS_BITS | (u32)i;
        int j = -1;
        u32 kj = 0;
#pragma unroll
        for (int s = WARP_SORT_N / 2; s > 0; s >>= 1) {
          if (j + s < n_ins) {
            const u32 kk = key_of(c, j + s);
            if (kk < key) {
              j += s;
              kj = kk;
            }
          }
        }
        const long long pred = j >= 0 && kj >> POS_BITS == qh ? (long long)(kj & POS_MASK) : 0;
        const long long lb_last = i - pred;
        ring[q * RING + (i & (RING - 1))] = (u16)(lb_last <= window_n ? lb_last : min((long long)(10 + q), (long long)i));
      }
    }
    __syncwarp();
#pragma unroll 8
    for (int e = 0; e < RING; ++e) {
      const int i = b0 + e;
      if (i < state_n || i >= iend) continue;  // the same for the whole warp
      const u32 nb = (u32)min(i, 16);
      prop = t >= 10 ? (u32)ring[(t - 10) * RING + e] : (u32)t == nb - 1 ? nb : prop;
      const u32 same_slot = 6 + (rep & 3), moved_slot = 6 + ((rep + 1) & 3);
      const u32 lb = min(max(prop, 1u), (u32)i);
      const L l = xs[i], other = xs[i - lb];
      const u32 cnt = cs[lb - 1];
      const L d1 = (L)(l - other) & mask, d2 = (L)(other - l) & mask;
      const L dd = d1 < d2 ? d1 : d2;
      const int dbits = sizeof(L) == 8 ? 64 - __clzll((long long)dd) : 32 - __clz((int)dd);
      const u32 good = (u32)((32 - __clz((int)cnt)) + bits - dbits);
      const u32 key = good << (POS_BITS + 4) | (u32)(15 - t) << POS_BITS | lb;
      const u32 k0 = __reduce_max_sync(FULL, half ? 0u : key), k1 = __reduce_max_sync(FULL, half ? key : 0u);
      const u32 kmax = half ? k1 : k0, best = kmax & POS_MASK;
      const bool active = i < ilen, moved = best != best_lb;
      rep += active && moved;
      prop = active && (u32)t == (moved ? moved_slot : same_slot) ? best : prop;
      best_lb = active ? best : best_lb;
      if (active && key == kmax) cs[lb - 1] = (u16)(cnt + 1);
      if ((i & 15) == t) mine = best;
      if ((i & 15) == 15 || i == iend - 1) {
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

template <typename L, typename S>
cudaError_t fused_optin(int bytes) {
  cudaError_t err = cudaFuncSetAttribute(fused_kernel<L, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fused_kernel<L, S>, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename S>
cudaError_t fused_launch(const u64* xp, const long long* lp, int lanes, long long m, int bits, int window_n_log,
                         int state_n, void* lbs, void* prim, void* states, cudaStream_t s) {
  const long long page_smem = fused_page_bytes<S>(m, bits, window_n_log);
  const unsigned grid = (unsigned)((lanes + CHAIN_PAGES - 1) / CHAIN_PAGES);
  const size_t smem = (size_t)(CHAIN_PAGES * page_smem);
  if (bits <= 32)
    fused_kernel<u32, S><<<grid, 32, smem, s>>>(xp, lp, m, bits, window_n_log, state_n, lanes, page_smem,
                                                static_cast<u32*>(lbs), static_cast<u64*>(prim),
                                                static_cast<u64*>(states));
  else
    fused_kernel<u64, S><<<grid, 32, smem, s>>>(xp, lp, m, bits, window_n_log, state_n, lanes, page_smem,
                                                static_cast<u32*>(lbs), static_cast<u64*>(prim),
                                                static_cast<u64*>(states));
  return cudaGetLastError();
}

template <typename S>
int fused_resident(long long m, int bits, int window_n_log) {
  const size_t smem = (size_t)(CHAIN_PAGES * fused_page_bytes<S>(m, bits, window_n_log));
  int blocks = 0;
  cudaError_t err = bits <= 32
                        ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fused_kernel<u32, S>, 32, smem)
                        : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fused_kernel<u64, S>, 32, smem);
  return err != cudaSuccess ? -(int)err : blocks * CHAIN_PAGES;
}

"""


def _fused(sorted_type: str) -> list:
    return [
        ("#include <cstdint>\n", "#include <cstdint>\n#define FUSED_S " + sorted_type + "\n"),
        ("// The device-memory route (pages over SMEM_MAX_N numbers)", _FUSED + "using FS = FUSED_S;\n\n"
         "// The device-memory route (pages over SMEM_MAX_N numbers)"),
        ("    if (err == cudaSuccess) err = chain_optin<u64>(bytes);\n",
         "    if (err == cudaSuccess) err = chain_optin<u64>(bytes);\n"
         "    if (err == cudaSuccess) err = fused_optin<u32, FS>(bytes);\n"
         "    if (err == cudaSuccess) err = fused_optin<u64, FS>(bytes);\n"),
        ("  const size_t smem = (size_t)(CHAIN_PAGES * chain_page_bytes(m, bits, window_n_log));\n",
         "  if (m <= WARP_SORT_N) return fused_resident<FS>(m, bits, window_n_log);\n"
         "  const size_t smem = (size_t)(CHAIN_PAGES * chain_page_bytes(m, bits, window_n_log));\n"),
        ("  if (m <= SMEM_MAX_N) {\n",
         "  if (m <= WARP_SORT_N) {\n"
         "    if (CHAIN_PAGES * fused_page_bytes<FS>(m, bits, window_n_log) > optin) return (int)cudaErrorInvalidValue;\n"
         "    return (int)fused_launch<FS>(xp, lp, lanes, m, bits, window_n_log, state_n, lbs, prim, states, s);\n"
         "  }\n"
         "  if (m <= SMEM_MAX_N) {\n"),
    ]


# the committed chooser's edits
_B5 = {
    "committed": [],
    "hash reads in the chain's block, sorted positions": _fused("u16"),
    "hash reads in the chain's block, sorted keys": _fused("u32"),
    "block sort for every page": [
        ("      if (m <= WARP_SORT_N)\n        hash_reads_warp_kernel", "      if (m < 0)\n        hash_reads_warp_kernel"),
        ("      case 11: hash_queries<11>", "      case 10: hash_queries<10>(seg, searched, row[i], i, hmask, window_n, out, stride); break;\n"
                                          "      case 11: hash_queries<11>")],
    "reduce over a half-warp mask": [
        (_RED, "const u32 k0 = __reduce_max_sync(0xffffu << (16 * half), key), k1 = k0;")],
    "reduce by shuffles": [
        (_RED, "u32 k0 = key; for (int o = 8; o; o >>= 1) k0 = max(k0, __shfl_xor_sync(FULL, k0, o)); const u32 k1 = k0;")],
    "no sort": [("  warp_sort(k, lane);\n  const u32 before", "  const u32 before")],
    "no search": [("        if (seg(c, j + s) < key) j += s;", "        if (key == 0u) j += s;")],
    "no per-step __syncwarp": [("          prow[k] = (u64)((L)((L)(xs[k] - xs[k - mine]) + mid) & mask);\n        }\n      }\n"
                                "      __syncwarp();\n    }\n  }\n}\n\n// The device-memory route",
                                "          prow[k] = (u64)((L)((L)(xs[k] - xs[k - mine]) + mid) & mask);\n        }\n      }\n"
                                "    }\n  }\n}\n\n// The device-memory route")],
}


def _edited(path: str, edits) -> str:
    with open(path) as f:
        src = f.read()
    for old, new in edits:
        if old not in src:
            raise ValueError(f"{path}: the variant's edit does not apply: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build_variants(path: str, variants: dict, prefix: str) -> dict:
    """{name: ctypes library} of each variant of the source at `path`, all
    nvcc processes at once; prints each one's ptxas registers and spills."""
    os.makedirs(VARIANT_DIR, exist_ok=True)
    procs = {}
    for k, (name, edits) in enumerate(variants.items()):
        cu = os.path.join(VARIANT_DIR, f"{prefix}{k}.cu")
        with open(cu, "w") as f:
            f.write(_edited(path, edits))
        so = cu[:-3] + ".so"
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-I", kernels._CSRC, "-o", so, cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} failed to build:\n{log}")
        used, fn = [], "?"
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn = (re.findall(r"\d+([A-Za-z_]+_kernel)", line) or ["?"])[0]
            elif "Used" in line:
                used.append(f"{fn}: {line.split('ptxas info    : ')[-1].strip()}")
        print(f"build: {prefix}{name!r}: {'; '.join(used)}", flush=True)
        libs[name] = ctypes.CDLL(so)
    return libs


def _bind(libs: dict, fn_name: str) -> None:
    for lib in libs.values():
        getattr(lib, fn_name).argtypes = kernels._ARGTYPES[fn_name]
        getattr(lib, fn_name).restype = ctypes.c_int


def _in_turns(names, fn) -> dict:
    """{name: (median of the first turn, of the second)}: fn(name) timed
    in order, then in reverse order."""
    got = {name: [] for name in names}
    for order in (list(names), list(names)[::-1]):
        for name in order:
            got[name].append(fn(name))
    return got


def e4b_variants(path: str, variants: dict, prefix: str, card: str) -> None:
    libs = build_variants(path, variants, prefix)
    _bind(libs, "proto_round_loop")
    dev = torch.device("cuda")
    for with_emit, n_tiles in prl.BENCH:
        sec, node, state = prl.make_inputs(n_tiles, dev)
        want = prl.round_loop_plain(sec, node, state, prl.ROUNDS, True)

        def run(name):
            out = torch.empty_like(state)
            emit = torch.empty((n_tiles, prl.ROUNDS, 8, 128), dtype=torch.int32, device=dev)
            rc = libs[name].proto_round_loop(sec.data_ptr(), node.data_ptr(), state.data_ptr(), out.data_ptr(),
                                             emit.data_ptr() if with_emit else None, n_tiles, prl.ROUNDS, 0,
                                             torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")
            return out, emit

        def timed(name):
            out, emit = run(name)
            if "no " not in name:
                common.check_equal(out, want[0], name)
                if with_emit:
                    common.check_equal(emit, want[1], name)
            return common.time_ms(lambda: run(name), hold=True)[0]

        times = _in_turns(libs, timed)
        print(f"E4b {'emit' if with_emit else 'noemit'} x{n_tiles} tiles, card alone ms (two turns): "
              + "; ".join(f"{k} {a:.4f}/{b:.4f}" for k, (a, b) in times.items()) + f" [{card}]", flush=True)


def b5_inputs(dev, bits: int):
    """A lookback-like input: a 97-value period of `bits`-bit latents with
    one bit of noise, B5_PAGES pages of B5_PAGE_N (seed 16)."""
    rng = np.random.default_rng(16)
    n = B5_PAGES * B5_PAGE_N
    x = np.tile(rng.integers(0, 2**64, 97, dtype=np.uint64), -(-n // 97))[:n] ^ rng.integers(0, 2, n, dtype=np.uint64)
    if bits < 64:
        x &= np.uint64((1 << bits) - 1)
    return (torch.from_numpy(x.view(np.int64).reshape(B5_PAGES, B5_PAGE_N)).to(dev),
            torch.full((B5_PAGES,), B5_PAGE_N, dtype=torch.int64, device=dev))


def kernel_times(fn, calls=5) -> dict:
    """{kernel name: device ms a launch} of fn's kernels: the mean of the
    launches that the profiler's trace of `calls` calls holds."""
    return {name: ms / n for name, (ms, n) in common.traced_kernels(fn, calls).items()}


def b5_variants(card: str) -> None:
    libs = build_variants(os.path.join(kernels._CSRC, "lookback_choose.cu"), _B5, "b5_")
    for lib in libs.values():
        lib.lookback_choose.argtypes = kernels._ARGTYPES["lookback_choose"]
        lib.lookback_choose.restype = ctypes.c_int
        lib.lookback_choose_resident_pages.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.lookback_choose_resident_pages.restype = ctypes.c_int
        lib.pcodec_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pcodec_cuda_error_string.restype = ctypes.c_char_p
    dev = torch.device("cuda")
    keep = kernels._LIBS.get("lookback_choose")
    try:
        for bits in (64, 32):
            x, lens = b5_inputs(dev, bits)
            kernels._LIBS["lookback_choose"] = libs["committed"]
            ref = dt.lookback_choose(x, lens, bits, B5_WNL, 1)
            want = dt.lookback_choose_plain(x[:64], lens[:64], bits, B5_WNL, 1)
            if not all(torch.equal(a[:64], b) for a, b in zip(ref, want)):
                raise AssertionError(f"B5's committed kernel differs from the plain version at {bits} bits")

            def timed(name):
                kernels._LIBS["lookback_choose"] = libs[name]
                got = dt.lookback_choose(x, lens, bits, B5_WNL, 1)
                same = all(torch.equal(a, b) for a, b in zip(got, ref))
                if not same and "no " not in name:
                    raise AssertionError(f"B5 variant {name!r} differs from the committed kernel at {bits} bits")
                return (common.time_ms(lambda: dt.lookback_choose(x, lens, bits, B5_WNL, 1), hold=True)[0],
                        common.time_ms(lambda: dt.lookback_choose(x[:1], lens[:1], bits, B5_WNL, 1), hold=True)[0])

            times = _in_turns(libs, timed)
            for name, runs in times.items():
                kernels._LIBS["lookback_choose"] = libs[name]
                split = kernel_times(lambda: dt.lookback_choose(x, lens, bits, B5_WNL, 1))
                pages = libs[name].lookback_choose_resident_pages(B5_PAGE_N, bits, B5_WNL, 0)
                print(f"B5 {name}: {B5_PAGES} pages of {B5_PAGE_N} {bits}-bit, card alone ms (two turns): whole "
                      f"{runs[0][0]:.4f}/{runs[1][0]:.4f}, one page {runs[0][1]:.4f}/{runs[1][1]:.4f}; kernels "
                      f"(profiler, ms a launch, one launch each a call): {', '.join(f'{k} {v:.4f}' for k, v in sorted(split.items()))}; "
                      f"{pages} pages resident an SM; "
                      + ("timing only" if "no " in name else "every page == the committed kernel") + f" [{card}]",
                      flush=True)
    finally:
        if keep is None:
            kernels._LIBS.pop("lookback_choose", None)
        else:
            kernels._LIBS["lookback_choose"] = keep


# the column-sum pass's route forced either way (the committed kernel picks by size)
_E1 = {
    "committed": [],
    "every block always": [("const bool by_starts = touches < n_blocks;", "const bool by_starts = false;")],
    "touched blocks always": [("const bool by_starts = touches < n_blocks;", "const bool by_starts = true;")],
}


def e1_variants(parent, card: str) -> None:
    """The committed E1 (column sums, then a block a tile), its column-sum
    pass forced to every block of raw or to the blocks the chains touch,
    and, from DIR, the fetch form (each chain's 3,072 words bulk-copied into
    shared memory; its scratch holds a tile's 16 partial sums), at the
    experiment's shapes."""
    libs = build_variants(os.path.join(kernels._CSRC, "proto_dma.cu"), _E1, "e1_")
    if parent:
        libs |= build_variants(os.path.join(parent, "pcodec_tpu_torch", "csrc", "proto_dma.cu"),
                               {"earlier section fetch": []}, "e1_parent_")
    _bind(libs, "proto_dma")
    dev = torch.device("cuda")
    for n_tiles, heavy in pd.SHAPES:
        starts, raw = pd.make_inputs(n_tiles, dev)
        want = pd.dma_checksum_plain(starts, raw, heavy)

        def run(name):
            earlier = name.startswith("earlier")
            shape = (n_tiles, pd.GROUPS, 8, 128) if earlier else (raw.shape[0] // pd.BLOCK_WORDS, 128)
            scratch = torch.empty(shape, dtype=torch.int32, device=dev)
            out = torch.empty((n_tiles, 8, 128), dtype=torch.int32, device=dev)
            rc = libs[name].proto_dma(raw.data_ptr(), raw.shape[0], starts.data_ptr(), scratch.data_ptr(),
                                      out.data_ptr(), n_tiles, heavy, 0, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")
            return out

        def timed(name):
            common.check_equal(run(name), want, name)
            return common.time_ms(lambda: run(name), hold=True)[0]

        times = _in_turns(libs, timed)
        split = {name: kernel_times(lambda: run(name), calls=1) for name in libs}
        print(f"E1 {n_tiles} tiles, heavy {heavy}, card alone ms (two turns): "
              + "; ".join(f"{k} {a:.4f}/{b:.4f} (profiler: "
                          + ", ".join(f"{kn} {v:.4f}" for kn, v in sorted(split[k].items())) + ")"
                          for k, (a, b) in times.items()) + f"; every output == the plain version [{card}]",
              flush=True)


_E3A = {
    "committed": [],
    "8 rows a block": [("constexpr int TAKE_ROWS = 4;", "constexpr int TAKE_ROWS = 8;")],
    "16 rows a block": [("constexpr int TAKE_ROWS = 4;", "constexpr int TAKE_ROWS = 16;")],
}
STEPS_SHAPES = (("whole", None, mg.STEPS), ("16 rows", 16, mg.STEPS), ("one row", 1, mg.STEPS),
              ("whole, 0 steps", None, 0), ("one row, 0 steps", 1, 0))


_E3B = {
    "committed": [],
    "1 warp a block": [("constexpr int TAA_WARPS = 4;", "constexpr int TAA_WARPS = 1;")],
    "8 warps a block": [("constexpr int TAA_WARPS = 4;", "constexpr int TAA_WARPS = 8;")],
    "plain loads a warp": [("for (int i = lane; i < (ts >> 2); i += 32) cp_async16(mine + i, src + i);",
                            "for (int i = lane; i < (ts >> 2); i += 32) mine[i] = src[i];")],
}


def steps_variants(key: str, route: int, variants: dict, parent, card: str) -> None:
    """Route take (E3a, route 0) or taa (E3b, route 1) as `variants` edit
    the committed source, and DIR's as it is: at the experiment's shape, on
    its first 16 rows, on one row alone, and at 0 steps (the launch and the
    copies)."""
    libs = build_variants(os.path.join(kernels._CSRC, "micro_gather.cu"), variants, f"{key}_")
    if parent:
        earlier = "earlier read-only-path walk" if route == 0 else "earlier block barrier"
        libs |= build_variants(os.path.join(parent, "pcodec_tpu_torch", "csrc", "micro_gather.cu"),
                               {earlier: []}, f"{key}_parent_")
    _bind(libs, "micro_gather")
    inp = mg.make_inputs(torch.device("cuda"))
    table, idx0 = inp["table_flat"], inp["idx0"]
    ts = table.numel() // idx0.shape[0]

    def run(name, rows, steps):
        idx = idx0[:rows]
        out = torch.empty_like(idx)
        rc = libs[name].micro_gather(route, table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0], ts, steps,
                                     0, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{name}: CUDA error {rc}")
        return out

    def timed(name):
        got = []
        for _, rows, steps in STEPS_SHAPES:
            want = mg.gather_steps_plain(table[: (rows or idx0.shape[0]) * ts], idx0[:rows], steps)
            common.check_equal(run(name, rows, steps), want, f"{name} ({rows} rows, {steps} steps)")
            got.append(common.time_ms(lambda: run(name, rows, steps), hold=True)[0])
        return got

    times = _in_turns(libs, timed)
    for name, (a, b) in times.items():
        print(f"{key.upper()} {name}, T={idx0.shape[0]} TS={ts}, card alone ms (two turns): "
              + "; ".join(f"{what} {x:.4f}/{y:.4f}" for (what, _, _), x, y in zip(STEPS_SHAPES, a, b))
              + f"; every output == the plain version [{card}]", flush=True)


_E4A = {
    "committed": [],
    "one warp a block": [("constexpr int ROW_WARPS = 4;", "constexpr int ROW_WARPS = 1;")],
    "a thread an element": [("} else if (width <= ROW_LANE_MAX) {", "} else if (width < 0) {")],
}
# (rows, width): check A's shape, a ragged row and many rows of the register
# form
E4A_SHAPES = ((8, 128), (8, 77), (4096, 128))


def e4a_variants(parent, card: str) -> None:
    """Route row as _E4A edits the committed source (the register form, a
    warp a row; ROW_WARPS of them a block), and DIR's as it is, each held
    against its plain version and torch.gather and timed card-alone beside
    torch.gather at E4A_SHAPES."""
    libs = build_variants(os.path.join(kernels._CSRC, "micro_gather.cu"), _E4A, "e4a_")
    if parent:
        libs |= build_variants(os.path.join(parent, "pcodec_tpu_torch", "csrc", "micro_gather.cu"),
                               {"earlier thread an element": []}, "e4a_parent_")
    _bind(libs, "micro_gather")
    dev = torch.device("cuda")
    rng = np.random.default_rng(18)
    inputs = [prl.taa_inputs(dev)] + [
        (torch.from_numpy(rng.integers(-(2**31), 2**31, (r, w), dtype=np.int64).astype(np.int32)).to(dev),
         torch.from_numpy(rng.integers(0, w, (r, w), dtype=np.int32)).to(dev)) for r, w in E4A_SHAPES[1:]]

    def run(name, tbl, idx):
        out = torch.empty_like(idx)
        rc = libs[name].micro_gather(3, tbl.data_ptr(), idx.data_ptr(), out.data_ptr(), tbl.shape[0], tbl.shape[1], 0,
                                     0, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{name}: CUDA error {rc}")
        return out

    def timed(name):
        got = []
        for tbl, idx in inputs:
            out = run(name, tbl, idx)
            common.check_equal(out, mg.row_gather_plain(tbl, idx), f"{name} {tuple(tbl.shape)}")
            common.check_equal(out, torch.gather(tbl, 1, idx.long()), f"{name} {tuple(tbl.shape)} (torch.gather)")
            got.append(common.time_ms(lambda: run(name, tbl, idx), hold=True)[0])
        return got

    times = _in_turns(libs, timed)
    lib = [common.time_ms(lambda: torch.gather(tbl, 1, idx.long()), hold=True)[0] for tbl, idx in inputs]
    for name, (a, b) in times.items():
        print(f"E4A {name}, card alone ms (two turns): "
              + "; ".join(f"{shape} {x:.4f}/{y:.4f}" for shape, x, y in zip(E4A_SHAPES, a, b))
              + f"; every output == the plain version and torch.gather [{card}]", flush=True)
    print("E4A torch.gather (its int64 index made outside the timing), card alone ms: "
          + "; ".join(f"{shape} {x:.4f}" for shape, x in zip(E4A_SHAPES, lib)) + f" [{card}]", flush=True)


def main(parent=None, only=None, device="cuda") -> None:
    common.cuda_device(device)
    card = common.card_line()
    if only in (None, "e1"):
        e1_variants(parent, card)
    if only in (None, "e3a"):
        steps_variants("e3a", 0, _E3A, parent, card)
    if only in (None, "e3b"):
        steps_variants("e3b", 1, _E3B, parent, card)
    if only in (None, "e4a"):
        e4a_variants(parent, card)
    if only in (None, "e4b"):
        e4b_variants(os.path.join(kernels._CSRC, "proto_round_loop.cu"), _E4B_NEW, "e4b_", card)
        if parent:
            e4b_variants(os.path.join(parent, "pcodec_tpu_torch", "csrc", "proto_round_loop.cu"), _E4B_OLD,
                         "e4b_old_", card)
    if only in (None, "b5"):
        b5_variants(card)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier tree of the port, whose kernels are timed beside the committed ones")
    ap.add_argument("--only", choices=("e1", "e3a", "e3b", "e4a", "e4b", "b5"), help="run one kernel's variants")
    args = ap.parse_args()
    main(args.parent, args.only)
