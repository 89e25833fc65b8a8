"""Build and bind the port's CUDA kernels (csrc/*.cu).

Each source is compiled by `nvcc` for sm_90a into a shared library with a
plain C interface and loaded through ctypes. Libraries are built at first
use into `build/pcodec_tpu_torch/` beside the package, named by a hash of
the source and flags, with the `-Xptxas -v` report kept beside each one.
Nothing here is compiled or loaded at import time.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; the launch functions below raise if it is non-zero
and count successful launches in LAUNCHES.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

CHAINS_PER_BLOCK = 128  # must match csrc/chain_decode.cu and csrc/bin_ans_encode.cu

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "pcodec_tpu_torch")
SOURCES = ("section_gather", "chain_decode", "bin_ans_encode", "section_pack", "image_stitch",
           "row_sort", "lookback_recon", "dict_join", "histogram_walk",
           # the microbenchmarks of pcodec_tpu_torch/experiments/
           "proto_realign", "proto_dma", "micro_gather", "proto_round_loop", "bitonic_cluster")
# micro_gather's four routes (its `route` argument), each counted on its own
GATHER_ROUTES = ("gather_take", "gather_taa", "gather_lane", "gather_row")
LB_SMEM_MAX_N = 16384  # longest page K3 reconstructs in shared memory; must match csrc/lookback_recon.cu
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES = {name: 0 for name in SOURCES + GATHER_ROUTES if name != "micro_gather"}
_LIBS = {}
_DICT_SMEM_ENTRIES = {}

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
    # p1, offsets, page_n, curs, out, sec_words, n_chains, device, stream
    "section_pack": [_P, _P, _I, _P, _P, _I, _I, _I, _P],
    # rowsA, WA, F0A, lenA, RA, rowsC, WC, F0C, lenC, RC, body, body_words,
    # device, stream
    "image_stitch": [_P, _I, _P, _P, _I, _P, _I, _P, _P, _I, _P, _L, _I, _P],
    # keys, rows, m_pad, key_bytes, device, stream
    "row_sort": [_P, _I, _L, _I, _I, _P],
    # lat, lb, mom, out, P, N, state_n, window_n, mid, rounds, add_scratch,
    # ptr_scratch, device, stream
    "lookback_recon": [_P, _P, _P, _P, _I, _L, _I, _L, _L, _I, _P, _P, _I, _P],
    # primary, table, out, n, D, smem, device, stream
    "dict_join": [_P, _P, _P, _L, _L, _I, _I, _P],
    # V, L, R, SL1, SR, s0, n, nb_log, lanes, counts, lowers, uppers, n_bins,
    # device, stream
    "histogram_walk": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _P],
    # raw2d, n_rows, starts_blk, out, n_groups, device, stream
    "proto_realign": [_P, _L, _P, _P, _I, _I, _P],
    # raw, n_raw, starts, part, out, n_tiles, heavy_rounds, device, stream
    "proto_dma": [_P, _L, _P, _P, _P, _I, _I, _I, _P],
    # route, table, idx, out, rows, width, steps, device, stream
    "micro_gather": [_I, _P, _P, _P, _I, _I, _I, _I, _P],
    # sec, node, state, out, emit, n_tiles, rounds, device, stream
    "proto_round_loop": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    # keys, rows, m, device, stream
    "bitonic_cluster": [_P, _I, _L, _I, _P],
}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else (shutil.which("nvcc") or path)


def _lib_path(name: str) -> str:
    with open(os.path.join(_CSRC, name + ".cu"), "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{name}-{h}.so")


def build(names=SOURCES) -> dict:
    """Compile the named kernels that are not built yet, all nvcc processes
    at once. Returns {name: ptxas report (registers, shared memory, spills)}."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        so = _lib_path(name)
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, name + ".cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True), tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
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
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        lib.pcodec_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pcodec_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def _call(name: str, t: torch.Tensor, *args, count: str = None) -> None:
    lib = _lib(name)
    stream = torch.cuda.current_stream(t.device).cuda_stream
    rc = getattr(lib, name)(*args, t.device.index or 0, stream)
    if rc:
        msg = lib.pcodec_cuda_error_string(rc).decode()
        raise RuntimeError(f"{count or name} kernel launch failed: CUDA error {rc} ({msg})")
    LAUNCHES[count or name] += 1


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


def launch_section_pack(p1, offsets, curs, out) -> None:
    _call("section_pack", p1, p1.data_ptr(), offsets.data_ptr(), p1.shape[1], curs.data_ptr(),
          out.data_ptr(), out.shape[1], out.shape[0])


def launch_image_stitch(rowsA, F0A, lenA, rowsC, F0C, lenC, body) -> None:
    _call("image_stitch", body, rowsA.data_ptr(), rowsA.shape[1], F0A.data_ptr(), lenA.data_ptr(),
          rowsA.shape[0], rowsC.data_ptr(), rowsC.shape[1], F0C.data_ptr(), lenC.data_ptr(),
          rowsC.shape[0], body.data_ptr(), body.shape[0])


def launch_row_sort(keys) -> None:
    _call("row_sort", keys, keys.data_ptr(), keys.shape[0], keys.shape[1], keys.element_size())


def launch_lookback_recon(lat, lb, mom, out, window_n: int, state_n: int, mid: int, rounds: int,
                          scratch=None) -> None:
    """scratch: (add (P, N) int64, ptr (2, P, N) int32) for pages longer
    than LB_SMEM_MAX_N, else None."""
    add_s, ptr_s = (scratch[0].data_ptr(), scratch[1].data_ptr()) if scratch else (None, None)
    _call("lookback_recon", lat, lat.data_ptr(), lb.data_ptr(), mom.data_ptr(), out.data_ptr(),
          lat.shape[0], lat.shape[1], state_n, window_n, mid, rounds, add_s, ptr_s)


def dict_join_smem_entries(device) -> int:
    """Largest table, in entries, that K4 holds in shared memory on `device`."""
    index = torch.device(device).index or 0
    if index not in _DICT_SMEM_ENTRIES:
        fn = _lib("dict_join").dict_join_smem_entries
        fn.argtypes = [_I]
        fn.restype = _L
        _DICT_SMEM_ENTRIES[index] = fn(index)
    return _DICT_SMEM_ENTRIES[index]


def launch_dict_join(primary, table, out) -> None:
    smem = int(table.shape[0] <= dict_join_smem_entries(primary.device))
    _call("dict_join", primary, primary.data_ptr(), table.data_ptr(), out.data_ptr(), primary.shape[0],
          table.shape[0], smem)


def launch_histogram_walk(V, L, R, SL1, SR, s0, n, counts, lowers, uppers, n_bins, nb_log: int) -> None:
    _call("histogram_walk", V, V.data_ptr(), L.data_ptr(), R.data_ptr(), SL1.data_ptr(), SR.data_ptr(),
          s0.data_ptr(), n.data_ptr(), nb_log, V.shape[0], counts.data_ptr(), lowers.data_ptr(),
          uppers.data_ptr(), n_bins.data_ptr())


def launch_proto_realign(raw2d, starts_blk, out) -> None:
    _call("proto_realign", raw2d, raw2d.data_ptr(), raw2d.shape[0], starts_blk.data_ptr(), out.data_ptr(),
          out.shape[0])


def launch_proto_dma(raw, starts, part, out, heavy_rounds: int) -> None:
    _call("proto_dma", raw, raw.data_ptr(), raw.shape[0], starts.data_ptr(), part.data_ptr(), out.data_ptr(),
          starts.shape[0], heavy_rounds)


def launch_micro_gather(route: str, table, idx, out, rows: int, width: int, steps: int) -> None:
    _call("micro_gather", table, GATHER_ROUTES.index(route), table.data_ptr(), idx.data_ptr(), out.data_ptr(),
          rows, width, steps, count=route)


def launch_proto_round_loop(sec, node, state, out, emit, rounds: int) -> None:
    _call("proto_round_loop", sec, sec.data_ptr(), node.data_ptr(), state.data_ptr(), out.data_ptr(),
          None if emit is None else emit.data_ptr(), sec.shape[0], rounds)


def launch_bitonic_cluster(keys) -> None:
    _call("bitonic_cluster", keys, keys.data_ptr(), keys.shape[0], keys.shape[1])
