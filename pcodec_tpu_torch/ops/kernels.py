"""Build and bind the port's CUDA kernels (csrc/*.cu).

Each source is compiled by `nvcc` for sm_90a into a shared library with a
plain C interface and loaded through ctypes. Libraries are built at first
use into `build/pcodec_tpu_torch/` beside the package, named by a hash of
the source, the csrc/ headers it includes and the flags, with the `-Xptxas
-v` report kept beside each one. Nothing here is compiled or loaded at import time.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; the launch functions below raise if it is non-zero
and count successful launches in LAUNCHES.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess

import numpy as np
import torch

CHAINS_PER_BLOCK = 128  # must match csrc/chain_decode.cu and csrc/bin_ans_encode.cu
K5_TILE_ROUNDS = 8  # rounds a chain K5 searches, then walks, at a time; must match csrc/bin_ans_encode.cu

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "pcodec_tpu_torch")
SOURCES = ("section_gather", "chain_decode", "bin_ans_encode", "section_pack", "image_stitch",
           "row_sort", "lookback_recon", "dict_join", "histogram_walk", "lookback_choose",
           "conv1_recon", "float_mult_join", "chunk_post", "mode_split", "triple_gcd",
           # the microbenchmarks of pcodec_tpu_torch/experiments/
           "proto_realign", "proto_dma", "micro_gather", "proto_round_loop", "bitonic_cluster")
# micro_gather's four routes (its `route` argument), each counted on its own
GATHER_ROUTES = ("gather_take", "gather_taa", "gather_lane", "gather_row")
LB_SMEM_MAX_N = 16384  # longest page K3 reconstructs in shared memory; must match csrc/lookback_recon.cu
# longest page B7 reconstructs (tiles of LB_SMEM_MAX_N); must match csrc/lookback_recon.cu
LB_MAX_PAGE_N = 1 << 30
LB_MAX_BASES = 68  # tensors one K3 launch reads and writes; must match csrc/lookback_recon.cu
# longest page of B5's two-pass route (hash reads, then the chain over
# latents and counts in shared memory); longer pages keep their maps on the
# chain in device memory; must match csrc/lookback_choose.cu
LB_CHOOSE_SMEM_MAX_N = 8192
# device memory B5 may hold at once: a batch of pages' proposals, or the
# longer pages' maps (a region a block)
LB_CHOOSE_SCRATCH_BYTES = 1 << 30
C1_MAX_BASES = 64  # tensors one B1 call reads and writes (launch outputs of 62 page lengths); must match csrc/conv1_recon.cu
POST_MAX_BASES = 64  # tensors one B3 launch reads and writes; must match csrc/chunk_post.cu
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# sources compiled in parts, all at once: part p of n is built with
# -DBUILD_PART=p -DBUILD_PARTS=n and holds its share of the source's template
# instances (B1's orders, its build's longest by far as one process)
PARTS = {"conv1_recon": 8}

# K4's shared-memory table past which its blocks fill the card and walk
# tiles (the copy paid once a block) instead of a block a tile: chip_smoke.py's
# grid sweep has a block a tile ahead up to 8,192 entries, walking from 16,384
DICT_WALK_ENTRIES = 8192

# K3's threads a block (a page a block; more where a page needs over 16
# positions a thread), from chip_smoke.py's sweep
K3_THREADS = 128

# K6's chains (warps) a block, from chip_smoke.py's sweep; fewer where a
# block's rows do not fit its shared memory
K6_WARPS = 1
K6_MAX_VARS = 3  # latent vars a K6 row interleaves; must match csrc/section_pack.cu

K7_SCAN_PAGES = 256  # pages a block of K7's offsets pass scans; must match csrc/image_stitch.cu

# consecutive pages a warp of K7's placement places, from chip_smoke.py's sweep
K7_PAGES_PER_WARP = 4

# C calls that launched kernels, by name; dict_join's counts its kernels;
# lookback_recon counts K3's launches, lookback_tiles B7's
LAUNCHES = {name: 0 for name in SOURCES + GATHER_ROUTES + ("row_sort_span", "lookback_tiles")
            if name != "micro_gather"}
_LIBS = {}
_DICT_SMEM_ENTRIES = {}
_K6_SMEM_WORDS = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = {
    # words, n_words, word0, out, n_chains, stage_words, device, stream
    "section_gather": [_P, _L, _P, _P, _I, _I, _I, _P],
    # stg, stage_words, word0, curs, n_batches, states0, body_n, table_id,
    # node, lower, ts, moment0, out, n_chains, fuse, device, stream
    "chain_decode": [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _P],
    # latents, page_n, body_n, table_id, states0, nexts, ts, lowers, t1, t2,
    # b_pad, p1, offsets, states, n_chains, device, stream
    "bin_ans_encode": [_P, _I, _P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _I, _I, _P],
    # p1, offsets, page_n, row_chains, V, out, sec_words, ans_len, off_len,
    # total_bits, n_rows, warps, device, stream
    "section_pack": [_P, _P, _I, _P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _P],
    # desc, pages, scan, R, sections, W, states, moments, MO, VK, pfx_words,
    # body, body_words, pages a warp, device, stream
    "image_stitch": [_P, _P, _P, _L, _P, _I, _P, _P, _I, _I, _P, _P, _L, _I, _I, _P],
    # in, out, rows, m, in_bytes, key_bytes, passes, mm, keys, hist, device, stream
    "row_sort": [_P, _P, _I, _L, _I, _I, _I, _P, _P, _P, _I, _P],
    # bases, numels, n_bases, desc, n_chunks, table, n_table, out, n_out, smem, walk, launched,
    # device, stream
    "dict_join": [_P, _P, _I, _P, _I, _P, _L, _P, _L, _I, _I, _P, _I, _P],
    # V, L, R, SL1, SR, s0, n, nb_log, lanes, counts, lowers, uppers, n_bins,
    # device, stream
    "histogram_walk": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _P],
    # x, lens, lanes, m, bits, window_n_log, state_n, lbs, prim, states,
    # scratch, scratch_per_block, blocks, device, stream
    "lookback_choose": [_P, _P, _I, _L, _I, _I, _I, _P, _P, _P, _P, _L, _I, _I, _P],
    # bases, numels, n_bases, desc, desc_dev, n_desc, launched, device, stream
    "conv1_recon": [_P, _P, _I, _P, _P, _I, _P, _I, _P],
    # prim, sec, base bits, out, n, W, device, stream
    "float_mult_join": [_P, _P, ctypes.c_ulonglong, _P, _L, _I, _I, _P],
    # bases, numels, n_bases, desc, desc_dev, n_desc, launched, device, stream
    "chunk_post": [_P, _P, _I, _P, _P, _I, _P, _I, _P],
    # lat, prim, out, n, m, owner, table, secondary, W, bits, device, stream
    "mode_split": [_P, _P, _P, _L, _L, _P, _P, _I, _I, _I, _I, _P],
    # sm, valid, rows, m, out, device, stream
    "triple_gcd": [_P, _P, _L, _L, _P, _I, _P],
    # raw2d, n_rows, starts_blk, out, n_groups, device, stream
    "proto_realign": [_P, _L, _P, _P, _I, _I, _P],
    # raw, n_raw, starts, colsum, out, n_tiles, heavy_rounds, device, stream
    "proto_dma": [_P, _L, _P, _P, _P, _I, _I, _I, _P],
    # route, table, idx, out, rows, width, steps, device, stream
    "micro_gather": [_I, _P, _P, _P, _I, _I, _I, _I, _P],
    # sec, node, state, out, emit, n_tiles, rounds, device, stream
    "proto_round_loop": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    # keys, rows, m, device, stream
    "bitonic_cluster": [_P, _I, _L, _I, _P],
}
# C functions beside a library's own: name -> (library, argtypes)
_MORE_FUNCS = {
    # in, rows, m, in_bytes, mm, device, stream
    "row_sort_span": ("row_sort", [_P, _I, _L, _I, _P, _I, _P]),
    # bases, numels, n_bases, desc, desc_dev, n_rows, threads, launched, device, stream
    "lookback_chunks": ("lookback_recon", [_P, _P, _I, _P, _P, _I, _I, _P, _I, _P]),
    # bases, numels, n_bases, desc, desc_dev, n_rows, sync, sync_n, launched, device, stream
    "lookback_tiles": ("lookback_recon", [_P, _P, _I, _P, _P, _I, _P, _L, _P, _I, _P]),
    # desc, n_chunks, total_bits, ans_len, off_len, VK, B, sections, W, states,
    # moments, MO, pfx_words, head_host, H, R, E, head, scan, pages, device, stream
    "image_offsets": ("image_stitch", [_P, _I, _P, _P, _P, _I, _I, _P, _I, _P, _P, _I, _P, _P, _I, _L, _L, _P, _P,
                                       _P, _I, _P]),
}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else (shutil.which("nvcc") or path)


def _lib_path(name: str) -> str:
    with open(os.path.join(_CSRC, name + ".cu"), "rb") as f:
        src = f.read()
    for header in re.findall(rb'#include "([^"]+)"', src):
        with open(os.path.join(_CSRC, header.decode()), "rb") as f:
            src += f.read()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode() + str(PARTS.get(name, 1)).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{name}-{h}.so")


def build(names=SOURCES) -> dict:
    """Compile the named kernels that are not built yet, all nvcc processes
    at once (a source of PARTS one a part, its objects then linked).
    Returns {name: ptxas report (registers, shared memory, spills)}."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        so = _lib_path(name)
        if not os.path.exists(so):
            tmp, src, n = f"{so}.{os.getpid()}.tmp", os.path.join(_CSRC, name + ".cu"), PARTS.get(name, 1)
            cmds = ([[nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]] if n == 1 else
                    [[nvcc_path(), *(f for f in NVCC_FLAGS if f != "-shared"), "-c", f"-DBUILD_PART={p}",
                      f"-DBUILD_PARTS={n}", "-o", f"{tmp}.{p}.o", src] for p in range(n)])
            procs[name] = ([subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                            for cmd in cmds], tmp, so)
    failed = []
    for name, (ps, tmp, so) in procs.items():
        logs = [proc.communicate()[0] for proc in ps]
        log = "".join(logs)
        if any(proc.returncode for proc in ps):
            failed.append(f"{name}: nvcc exited {[proc.returncode for proc in ps]}\n{log}")
            continue
        if len(ps) > 1:
            objs = [f"{tmp}.{p}.o" for p in range(len(ps))]
            link = subprocess.run([nvcc_path(), "-shared", "-o", tmp, *objs], capture_output=True, text=True)
            for obj in objs:
                os.remove(obj)
            if link.returncode:
                failed.append(f"{name}: nvcc link exited {link.returncode}\n{link.stdout}{link.stderr}")
                continue
        with open(so[:-3] + ".ptxas.txt", "w") as f:
            f.write(log)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    reports = {}
    for name in names:
        rep = _lib_path(name)[:-3] + ".ptxas.txt"
        reports[name] = open(rep).read() if os.path.exists(rep) else ""
    return reports


def _lib(name: str):
    if name not in _LIBS:
        build((name,))
        lib = ctypes.CDLL(_lib_path(name))
        funcs = ([(name, _ARGTYPES[name])] if name in _ARGTYPES else []) + [
            (f, a) for f, (src, a) in _MORE_FUNCS.items() if src == name]
        for fn_name, argtypes in funcs:
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.pcodec_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pcodec_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def _stream(index: int) -> int:
    """The current stream of device `index` as a raw handle."""
    return torch.cuda.current_stream(index).cuda_stream


def _call(name: str, t: torch.Tensor, *args, count: str = None, launched: ctypes.c_int = None) -> None:
    """Call C function `name` (of its own library, or of the one
    _MORE_FUNCS names) on t's device and current stream; raise on its error,
    else count under `count` (default `name`) one launch, or the kernels
    the call wrote into `launched`."""
    lib = _lib(_MORE_FUNCS[name][0] if name in _MORE_FUNCS else name)
    index = t.device.index or 0
    rc = getattr(lib, name)(*args, index, _stream(index))
    if rc:
        msg = lib.pcodec_cuda_error_string(rc).decode()
        raise RuntimeError(f"{count or name} kernel launch failed: CUDA error {rc} ({msg})")
    LAUNCHES[count or name] += 1 if launched is None else launched.value


def launch_section_gather(words, word0, out) -> None:
    _call("section_gather", words, words.data_ptr(), words.shape[0], word0.data_ptr(),
          out.data_ptr(), out.shape[0], out.shape[1])


def launch_chain_decode(stg, word0, curs, states0, body_n, table_id, node, lower,
                        moment0, out, fuse: int) -> None:
    _call("chain_decode", stg, stg.data_ptr(), stg.shape[1], word0.data_ptr(),
          curs.data_ptr(), curs.shape[1] // 2, states0.data_ptr(), body_n.data_ptr(),
          table_id.data_ptr(), node.data_ptr(), lower.data_ptr(), node.shape[1],
          moment0.data_ptr(), out.data_ptr(), out.shape[0], fuse)


def launch_bin_ans_encode(latents, body_n, table_id, states0, nexts, lowers, t1, t2,
                          p1, offsets, states) -> None:
    _call("bin_ans_encode", latents, latents.data_ptr(), latents.shape[1], body_n.data_ptr(),
          table_id.data_ptr(), states0.data_ptr(), nexts.data_ptr(), nexts.shape[1],
          lowers.data_ptr(), t1.data_ptr(), t2.data_ptr(), lowers.shape[1], p1.data_ptr(),
          offsets.data_ptr(), states.data_ptr(), latents.shape[0])


def section_pack_smem_words(device) -> int:
    """Longest row, in words, that K6 stages in shared memory on `device`."""
    index = torch.device(device).index or 0
    if index not in _K6_SMEM_WORDS:
        fn = _lib("section_pack").section_pack_smem_words
        fn.argtypes = [_I]
        fn.restype = _L
        _K6_SMEM_WORDS[index] = fn(index)
    return _K6_SMEM_WORDS[index]


def launch_section_pack(p1, offsets, out, ans_len, off_len, total_bits, row_chains=None) -> None:
    """K6: out's rows are p1's chains, or the (R, V) pages of row_chains."""
    rc, V = (None, 1) if row_chains is None else (row_chains.data_ptr(), row_chains.shape[1])
    _call("section_pack", p1, p1.data_ptr(), offsets.data_ptr(), p1.shape[1], rc, V, out.data_ptr(), out.shape[1],
          ans_len.data_ptr(), off_len.data_ptr(), total_bits.data_ptr(), out.shape[0], K6_WARPS)


def image_scratch_sizes(R: int):
    """K7's scratch for R pages: the scan's int64 words (page offsets within
    their blocks, the blocks' first bytes, the body's byte count at index
    R + ceil(R / K7_SCAN_PAGES), the blocks' sums) and the pages' int32
    words (a 4-word record, then the row's first 4 bytes, a page)."""
    nblk = -(-R // K7_SCAN_PAGES)
    return R + 2 * nblk + 1, 5 * R


def launch_image_offsets(desc, total_bits, ans_len, off_len, sections, states, moments, pfx_words, head_host,
                         E: int, head, scan, pages) -> None:
    """K7's first C call (two kernels): the head's words, the pages' records
    and first bytes, and the scan of the pages' byte lengths. ans_len and
    off_len: K6's (rows, B) or (rows, V, B) lengths. Counted under
    image_stitch."""
    R = pages.shape[0] // 5
    VK = ans_len.shape[1] if ans_len.dim() == 3 else 1
    _call("image_offsets", desc, desc.data_ptr(), desc.shape[0], total_bits.data_ptr(), ans_len.data_ptr(),
          off_len.data_ptr(), VK, ans_len.shape[-1], sections.data_ptr(), sections.shape[1], states.data_ptr(),
          moments.data_ptr(), moments.shape[1], pfx_words.data_ptr(), head_host.data_ptr(), head_host.shape[0], R,
          E, head.data_ptr(), scan.data_ptr(), pages.data_ptr(), count="image_stitch")


def launch_image_stitch(desc, pages, scan, sections, states, moments, pfx_words, body, VK: int = 1) -> None:
    """K7's placement: every body word from the pages' sources. VK: K6's
    var slots a row (1 where K6's rows are the chains)."""
    _call("image_stitch", body, desc.data_ptr(), pages.data_ptr(), scan.data_ptr(), pages.shape[0] // 5,
          sections.data_ptr(), sections.shape[1], states.data_ptr(), moments.data_ptr(), moments.shape[1], VK,
          pfx_words.data_ptr(), body.data_ptr(), body.shape[0], K7_PAGES_PER_WARP)


def launch_row_sort_span(x, mm) -> None:
    """K8's first kernels: mm (2 rows + 1,) int64 gets each row's minimum,
    its maximum and the largest span of x (rows, m)."""
    _call("row_sort_span", x, x.data_ptr(), x.shape[0], x.shape[1], x.element_size(), mm.data_ptr())


def launch_row_sort(x, out, mm, keys, hist, key_bytes: int, passes: int) -> None:
    _call("row_sort", x, x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], x.element_size(), key_bytes, passes,
          mm.data_ptr(), keys.data_ptr(), hist.data_ptr())


def launch_lookback_chunks(bases, desc, desc_dev) -> None:
    """bases: the int64 tensors the rows name; desc (R, DESC_COLS) int64
    numpy rows, desc_dev the same rows on the card. The C side checks every
    row against its bases. Counts its kernel under lookback_recon."""
    desc = np.ascontiguousarray(desc, dtype=np.int64)
    B = len(bases)
    launched = ctypes.c_int(0)
    _call("lookback_chunks", desc_dev, (ctypes.c_uint64 * B)(*[b.data_ptr() for b in bases]),
          (ctypes.c_int64 * B)(*[b.numel() for b in bases]), B, desc.ctypes.data, desc_dev.data_ptr(),
          desc.shape[0], K3_THREADS, ctypes.byref(launched), count="lookback_recon", launched=launched)


def launch_lookback_tiles(bases, desc, desc_dev, sync) -> None:
    """B7 over a lookback table whose rows store latents (pages of any
    length, tiles of LB_SMEM_MAX_N): arguments as launch_lookback_chunks;
    sync, int32 words on the card for its ticket counter and a flag a
    ticket (decode.lookback_tiles sizes it), zeroed by the call. Counts its
    kernel under lookback_tiles."""
    desc = np.ascontiguousarray(desc, dtype=np.int64)
    B = len(bases)
    launched = ctypes.c_int(0)
    _call("lookback_tiles", desc_dev, (ctypes.c_uint64 * B)(*[b.data_ptr() for b in bases]),
          (ctypes.c_int64 * B)(*[b.numel() for b in bases]), B, desc.ctypes.data, desc_dev.data_ptr(),
          desc.shape[0], sync.data_ptr(), sync.numel(), ctypes.byref(launched), launched=launched)


def dict_join_smem_entries(device) -> int:
    """Largest table, in entries, that K4 holds in shared memory on `device`."""
    index = torch.device(device).index or 0
    if index not in _DICT_SMEM_ENTRIES:
        fn = _lib("dict_join").dict_join_smem_entries
        fn.argtypes = [_I]
        fn.restype = _L
        _DICT_SMEM_ENTRIES[index] = fn(index)
    return _DICT_SMEM_ENTRIES[index]


def launch_dict_join(bases, desc, table, out) -> None:
    """bases: the int64 tensors the chunks read; desc (C, 6) int64 numpy
    rows (base, start, n, output offset, table offset, D). The C side
    checks every row against its base, the output and the table."""
    desc = np.ascontiguousarray(desc, dtype=np.int64)
    if desc.ndim != 2 or desc.shape[1] != 6:
        raise ValueError("dict_join takes (C, 6) descriptor rows")
    smem = int(table.shape[0] <= dict_join_smem_entries(out.device))
    walk = int(table.shape[0] > DICT_WALK_ENTRIES)
    B = len(bases)
    launched = ctypes.c_int(0)
    _call("dict_join", out, (ctypes.c_uint64 * B)(*[b.data_ptr() for b in bases]),
          (ctypes.c_int64 * B)(*[b.numel() for b in bases]), B, desc.ctypes.data, desc.shape[0], table.data_ptr(),
          table.shape[0], out.data_ptr(), out.shape[0], smem, walk, ctypes.byref(launched), launched=launched)


def launch_histogram_walk(V, L, R, SL1, SR, s0, n, counts, lowers, uppers, n_bins, nb_log: int) -> None:
    _call("histogram_walk", V, V.data_ptr(), L.data_ptr(), R.data_ptr(), SL1.data_ptr(), SR.data_ptr(),
          s0.data_ptr(), n.data_ptr(), nb_log, V.shape[0], counts.data_ptr(), lowers.data_ptr(),
          uppers.data_ptr(), n_bins.data_ptr())


def lookback_choose_page_bytes(m: int, window_n_log: int) -> int:
    """B5's scratch bytes of one page of length m: its six rows of hash
    proposals (m <= LB_CHOOSE_SMEM_MAX_N), or its maps and counts."""
    fn = _lib("lookback_choose").lookback_choose_page_bytes
    fn.argtypes = [_L, _I]
    fn.restype = _L
    return fn(m, window_n_log)


def lookback_choose_resident_pages(m: int, bits: int, window_n_log: int, device) -> int:
    """Pages of m `bits`-bit numbers B5's chain holds on an SM at once."""
    lib = _lib("lookback_choose")
    fn = lib.lookback_choose_resident_pages
    fn.argtypes = [_L, _I, _I, _I]
    fn.restype = _I
    n = fn(m, bits, window_n_log, torch.device(device).index or 0)
    if n < 0:
        raise RuntimeError(f"lookback_choose_resident_pages: CUDA error {-n} "
                           f"({lib.pcodec_cuda_error_string(-n).decode()})")
    return n


def launch_lookback_choose(x, lens, lbs, prim, states, bits: int, window_n_log: int, state_n: int,
                           scratch, blocks: int) -> None:
    """B5 over x's (lanes, m) page rows with `blocks` equal regions of
    `scratch` (a batch of pages' hash proposals, or a longer-page block's
    maps)."""
    _call("lookback_choose", x, x.data_ptr(), lens.data_ptr(), x.shape[0], x.shape[1], bits, window_n_log, state_n,
          lbs.data_ptr(), prim.data_ptr(), states.data_ptr(), scratch.data_ptr(), scratch.numel() // blocks, blocks)


def launch_conv1_recon(bases, desc, desc_dev) -> None:
    """B1 over a conv1 table: bases, the int64 tensors the rows name; desc
    (R, decode.C1_DESC_COLS) int64 numpy rows, desc_dev the same rows on the
    card. The C side checks every row against its bases. Counts its
    kernels (one for each order the rows hold)."""
    desc = np.ascontiguousarray(desc, dtype=np.int64)
    B = len(bases)
    launched = ctypes.c_int(0)
    _call("conv1_recon", desc_dev, (ctypes.c_uint64 * B)(*[b.data_ptr() for b in bases]),
          (ctypes.c_int64 * B)(*[b.numel() for b in bases]), B, desc.ctypes.data, desc_dev.data_ptr(),
          desc.shape[0], ctypes.byref(launched), launched=launched)


def launch_float_mult_join(prim, sec, base_bits: int, out, W: int) -> None:
    """B2 on one chunk: prim, sec and out (n,) int64; base_bits the base
    float's memory bits."""
    _call("float_mult_join", out, prim.data_ptr(), sec.data_ptr(), base_bits & ((1 << 64) - 1), out.data_ptr(),
          out.shape[0], W)


def launch_chunk_post(bases, desc, desc_dev) -> None:
    """B3 over a post table: bases, the int64 tensors the rows name; desc
    (R, decode.POST_DESC_COLS) int64 numpy rows, desc_dev the same rows on
    the card. The C side checks every row against its bases. Counts its
    kernel (none where the rows hold no number)."""
    desc = np.ascontiguousarray(desc, dtype=np.int64)
    B = len(bases)
    launched = ctypes.c_int(0)
    _call("chunk_post", desc_dev, (ctypes.c_uint64 * B)(*[b.data_ptr() for b in bases]),
          (ctypes.c_int64 * B)(*[b.numel() for b in bases]), B, desc.ctypes.data, desc_dev.data_ptr(),
          desc.shape[0], ctypes.byref(launched), launched=launched)


def launch_triple_gcd(sm, valid, out) -> None:
    """B8 over sm's (rows, m) samples and their valid mask: out (rows, m //
    3) int64 gets each triple's GCD of differences, or 0."""
    _call("triple_gcd", sm, sm.data_ptr(), valid.data_ptr(), sm.shape[0], sm.shape[1], out.data_ptr())


def launch_mode_split(lat, prim, out, m: int, owner, table, secondary: bool, W: int, bits: int) -> None:
    """B6 over lat's latents in units of m: owner (units,) int64 chunk of
    each unit, table (chunks, 4) int64 rows (div, flip, invb, base); prim
    (FloatMult's secondary) the units' primaries or None."""
    _call("mode_split", lat, lat.data_ptr(), None if prim is None else prim.data_ptr(), out.data_ptr(), lat.numel(),
          m, owner.data_ptr(), table.data_ptr(), int(secondary), W, bits)


def launch_proto_realign(raw2d, starts_blk, out) -> None:
    _call("proto_realign", raw2d, raw2d.data_ptr(), raw2d.shape[0], starts_blk.data_ptr(), out.data_ptr(),
          out.shape[0])


def launch_proto_dma(raw, starts, colsum, out, heavy_rounds: int) -> None:
    _call("proto_dma", raw, raw.data_ptr(), raw.shape[0], starts.data_ptr(), colsum.data_ptr(), out.data_ptr(),
          starts.shape[0], heavy_rounds)


def micro_gather_take_rows(ts: int, device) -> int:
    """Rows a block of route take stages in shared memory at table width
    ts on `device`, or 0 where a row does not fit (the walk through the
    read-only path)."""
    lib = _lib("micro_gather")
    fn = lib.micro_gather_take_rows
    fn.argtypes = [_I, _I]
    fn.restype = _I
    n = fn(ts, torch.device(device).index or 0)
    if n < 0:
        raise RuntimeError(f"micro_gather_take_rows: CUDA error {-n} ({lib.pcodec_cuda_error_string(-n).decode()})")
    return n


def launch_micro_gather(route: str, table, idx, out, rows: int, width: int, steps: int) -> None:
    _call("micro_gather", table, GATHER_ROUTES.index(route), table.data_ptr(), idx.data_ptr(), out.data_ptr(),
          rows, width, steps, count=route)


def launch_proto_round_loop(sec, node, state, out, emit, rounds: int) -> None:
    _call("proto_round_loop", sec, sec.data_ptr(), node.data_ptr(), state.data_ptr(), out.data_ptr(),
          None if emit is None else emit.data_ptr(), sec.shape[0], rounds)


def launch_bitonic_cluster(keys) -> None:
    _call("bitonic_cluster", keys, keys.data_ptr(), keys.shape[0], keys.shape[1])
