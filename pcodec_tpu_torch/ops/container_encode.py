"""PCT container encode on an NVIDIA GPU: the PyTorch/CUDA counterpart of
the JAX package's `pcodec_tpu/ops/pallas_encode.py`.

The host trains each chunk (mode, delta, bins: the copied
`codec.compress.chunk_compressor`, whose latents the card sorts with K8,
ops/row_sort.py); the card dissects and bit-packs every page. Each page of a
chunk's primary latent var is one independent encode *chain*:

    plan_encode          host, numpy: train every chunk (its latents sorted
                         by K8 on the card), build its tANS encoder table
                         (build_enc_tables)
    build_encode_launch  host, numpy: one row of latents per chain, one
                         table per chunk, one launch for all chunks
    bin_ans_encode       K5, CUDA (csrc/bin_ans_encode.cu): bin search,
                         reverse 4-stream tANS walk and offsets per chain
    section_cursors      plain torch: per-batch section lengths and the bit
                         cursors of each [ANS bits][offset bits] section
    section_pack         K6, CUDA (csrc/section_pack.cu): bit-packs each
                         chain's ANS values and offsets at the cursors

ops/assemble.py stitches the sections into the file image on the card and
holds the entry points.

Only single-latent-var chunks (Classic or Dict mode) with NOOP or
consecutive delta encode here; others raise NotImplementedError. A trivial
var writes no body bits and needs no chain.

u64 values travel as int64 tensors holding the same bits (see
container_decode.py). Each kernel wrapper takes its plain PyTorch version
only for CPU tensors; for CUDA tensors it launches the kernel or raises.
"""

from dataclasses import dataclass, field, replace
from functools import partial
from typing import List, Optional

import numpy as np
import torch

from pcodec_tpu_torch.codec import container as ctn
from pcodec_tpu_torch.codec.chunk_config import ChunkConfig, PagingSpec
from pcodec_tpu_torch.codec.compress import ChunkCompressor, chunk_compressor
from pcodec_tpu_torch.dtypes import NumberType, number_type_from_np
from pcodec_tpu_torch.format import ans
from pcodec_tpu_torch.format.metadata import DeltaEncoding
from pcodec_tpu_torch.ops import kernels
from pcodec_tpu_torch.ops.container_decode import BATCH, CHAINS_PER_BLOCK, _resolve_device
from pcodec_tpu_torch.ops.decode import _MIN64, _check_cuda
from pcodec_tpu_torch.ops.row_sort import sort_latents

M32 = 0xFFFFFFFF
_MULTI = (
    "not ported yet; see ROADMAP.md queue item 4b "
    "(multi-latent-var and lookback encode and file image)"
)


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor of u32 values -> int32 tensor with the same bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


# ---------------------------------------------------------------------------
# host planner
# ---------------------------------------------------------------------------


def build_enc_tables(var_meta):
    """(nexts, lowers, t1, t2, ts): t1 = min_renorm | ob<<4 | cutoff<<11;
    t2 = wbase - weight so st' = nexts[t2[sym] + (st >> renorm)]."""
    bins = var_meta.bins
    n_bins = len(bins)
    spec = ans.Spec.from_weights(var_meta.ans_size_log, bins.weights.tolist())
    enc = ans.Encoder(spec)
    ts = max(spec.table_size, 1)
    weights = np.asarray(enc.weights, dtype=np.int64)
    wbase = np.cumsum(weights) - weights
    nexts = np.zeros(ts, dtype=np.int64)
    for s in range(n_bins):
        ns = np.asarray(enc.next_states[s], dtype=np.int64)
        nexts[wbase[s] : wbase[s] + weights[s]] = ns
    minren = np.asarray(enc.min_renorm_bits, dtype=np.int64)
    cutoff = np.asarray(enc.renorm_bit_cutoff, dtype=np.int64)
    ob = bins.offset_bits.astype(np.int64)
    t1 = minren | (ob << 4) | (cutoff << 11)
    t2 = wbase - weights
    lowers = bins.lowers.astype(np.uint64)
    return nexts, lowers, t1, t2, ts


@dataclass
class ChunkJob:
    cc: ChunkCompressor
    order: int  # consecutive delta order; 0 for NOOP
    tables: Optional[tuple]  # build_enc_tables output; None for a trivial var
    sec_words: int  # worst-case section words of one page; 0 when trivial

    @property
    def trivial(self) -> bool:
        return self.tables is None


@dataclass
class EncodePlan:
    nt: NumberType
    n: int
    page_n: int
    chunk_ns: List[int]
    jobs: List[ChunkJob]


def _check_encodable(ci: int, meta) -> None:
    pv = meta.per_latent_var
    if pv.secondary is not None or pv.delta is not None:
        raise NotImplementedError(
            f"chunk {ci}: {meta.mode.kind} mode with {meta.delta_encoding.kind} delta has "
            f"several latent vars; {_MULTI}"
        )
    if meta.delta_encoding.kind not in (DeltaEncoding.NOOP, DeltaEncoding.CONSECUTIVE):
        raise NotImplementedError(f"chunk {ci}: {meta.delta_encoding.kind} delta is {_MULTI}")


def plan_encode(nums: np.ndarray, config: Optional[ChunkConfig] = None, page_n: int = 1024,
                chunk_n: int = 1 << 20, device="cuda") -> EncodePlan:
    """Training of every chunk and its encoder table (the JAX
    `_plan_encode`): on the host, except the sort of each chunk's latents,
    which K8 does on `device` (the GPU unless the caller asks for the CPU).
    Every page length that is a multiple of 256 encodes on the card, with
    any table size."""
    if page_n < BATCH or page_n % BATCH:
        raise ValueError(f"page_n must be a positive multiple of {BATCH}")
    sort = partial(sort_latents, device=_resolve_device(device))
    config = config or ChunkConfig()
    nt = number_type_from_np(nums.dtype)
    chunk_ns = ctn._n_per_chunk(len(nums), chunk_n)
    jobs = []
    start = 0
    for ci, cn in enumerate(chunk_ns):
        chunk_config = replace(config, paging_spec=PagingSpec.exact_pages(ctn._exact_split(cn, page_n)))
        cc = chunk_compressor(nt, nums[start : start + cn], chunk_config, sort=sort)
        start += cn
        meta = cc.meta
        _check_encodable(ci, meta)
        de = meta.delta_encoding
        order = de.order if de.kind == DeltaEncoding.CONSECUTIVE else 0
        lvc = cc.lvcs.primary
        if lvc.is_trivial:
            jobs.append(ChunkJob(cc, order, None, 0))
            continue
        vm = meta.per_latent_var.primary
        worst = int(np.max(vm.bins.worst_case_bits_per_latent(lvc.ans_size_log)))
        sec_words = -(-(page_n * (worst + 1) + 64) // 32)
        jobs.append(ChunkJob(cc, order, build_enc_tables(vm), sec_words))
    return EncodePlan(nt=nt, n=len(nums), page_n=page_n, chunk_ns=chunk_ns, jobs=jobs)


@dataclass
class EncodeLaunch:
    """One launch of K5 + K6 for every non-trivial chunk: one row per chain
    (page), each table's chains padded to CHAINS_PER_BLOCK with inert chains
    (body_n 0), so every K5 block reads a single table. Bins are padded to a
    power of two with copies of the last bin, which the search may pick but
    which encode exactly as that bin."""

    page_n: int
    latents: np.ndarray  # (n_chains, page_n) uint64, zero past body_n
    body_n: np.ndarray  # (n_chains,) int64 latents coded in the chain
    table_id: np.ndarray  # (n_chains,) int64
    states0: np.ndarray  # (n_chains,) int64 encoder start state (= real table size)
    nexts: np.ndarray  # (n_tables, ts) int32 next state per (wbase + x) slot
    lowers: np.ndarray  # (n_tables, b_pad) uint64 sorted bin lowers
    t1: np.ndarray  # (n_tables, b_pad) int32 min_renorm | ob << 4 | cutoff << 11
    t2: np.ndarray  # (n_tables, b_pad) int32 wbase - weight
    sec_words: int  # section row words (multiple of 4), a bound for every chain
    chain_start: List[int] = field(default_factory=list)  # per chunk; -1 when trivial

    @property
    def n_chains(self) -> int:
        return len(self.body_n)


def _page_rows(cc: ChunkCompressor, order: int, page_n: int):
    """(rows (n_pages, page_n) uint64, body_n (n_pages,)) of one chunk: page
    p codes latents [p*page_n + min(order, len), (p+1)*page_n) of the
    delta-encoded chunk (its stored range), shifted to the row's start."""
    lat = cc.lvcs.primary.latents.astype(np.uint64)
    cn = len(lat)
    full, rem = divmod(cn, page_n)
    n_pages = full + (1 if rem else 0)
    rows = np.zeros((n_pages, page_n), dtype=np.uint64)
    body_n = np.zeros(n_pages, dtype=np.int64)
    s0 = min(order, page_n)
    if full:
        rows[:full, : page_n - s0] = lat[: full * page_n].reshape(full, page_n)[:, s0:]
        body_n[:full] = page_n - s0
    if rem:
        s0 = min(order, rem)
        rows[full, : rem - s0] = lat[full * page_n + s0 :]
        body_n[full] = rem - s0
    return rows, body_n


def build_encode_launch(plan: EncodePlan) -> EncodeLaunch:
    """Chain-major launch arrays of every non-trivial chunk (the JAX
    `_build_launch_args` without the TPU layout)."""
    page_n = plan.page_n
    items = [(ci, job) for ci, job in enumerate(plan.jobs) if not job.trivial]
    ts = max((job.tables[4] for _, job in items), default=1)
    b_max = max((len(job.tables[1]) for _, job in items), default=1)
    b_pad = 1 << (b_max - 1).bit_length()
    n_tables = len(items)
    n_pages = [-(-cn // page_n) for cn in plan.chunk_ns]
    n_rows = [-(-n_pages[ci] // CHAINS_PER_BLOCK) * CHAINS_PER_BLOCK for ci, _ in items]
    n_chains = sum(n_rows)
    L = EncodeLaunch(
        page_n=page_n,
        latents=np.zeros((n_chains, page_n), dtype=np.uint64),
        body_n=np.zeros(n_chains, dtype=np.int64),
        table_id=np.zeros(n_chains, dtype=np.int64),
        states0=np.zeros(n_chains, dtype=np.int64),
        nexts=np.zeros((n_tables, ts), dtype=np.int32),
        lowers=np.zeros((n_tables, b_pad), dtype=np.uint64),
        t1=np.zeros((n_tables, b_pad), dtype=np.int32),
        t2=np.zeros((n_tables, b_pad), dtype=np.int32),
        sec_words=-(-max((job.sec_words for _, job in items), default=4) // 4) * 4,
        chain_start=[-1] * len(plan.jobs),
    )
    pos = 0
    for tid, ((ci, job), rows) in enumerate(zip(items, n_rows)):
        nexts, lowers, t1, t2, tsj = job.tables
        b = len(lowers)
        L.nexts[tid, :tsj] = nexts
        L.lowers[tid] = lowers[-1]
        L.lowers[tid, :b] = lowers
        L.t1[tid] = t1[-1]
        L.t1[tid, :b] = t1
        L.t2[tid] = t2[-1]
        L.t2[tid, :b] = t2
        lat, body_n = _page_rows(job.cc, job.order, page_n)
        sl = slice(pos, pos + len(body_n))
        L.latents[sl] = lat
        L.body_n[sl] = body_n
        L.table_id[pos : pos + rows] = tid
        L.states0[pos : pos + rows] = tsj
        L.chain_start[ci] = pos
        pos += rows
    return L


def _from_round_layout(x: np.ndarray) -> np.ndarray:
    """(n_tiles, R, 8, 128) -> (n_tiles * 256, 4R): inverse of the JAX
    `_to_round_layout`, chain t*256 + g*8 + s at [t, r, s, 4g + j]."""
    T, R = x.shape[:2]
    return np.asarray(x).reshape(T, R, 8, 32, 4).transpose(0, 3, 2, 1, 4).reshape(T * 256, 4 * R)


def _undense(x: np.ndarray) -> np.ndarray:
    """(n_tiles, 8, 128) quad-replicated -> (n_tiles * 256,) (inverse of the
    JAX `_dense_quad_dev`)."""
    T = x.shape[0]
    return np.asarray(x).astype(np.int64).reshape(T, 8, 32, 4)[..., 0].transpose(0, 2, 1).reshape(-1)


def enc_launch_from_jax(schema, dev_args) -> EncodeLaunch:
    """The port's launch of one JAX encode launch, for the tests. `schema`
    has the `EncSchema` fields page_n, ts, b_pad and sec_words; `dev_args`
    is the `_build_launch_args` tuple (latlo, lathi, tables, bodyn,
    states0, tbl_ids) as numpy arrays. Undoes the round and dense-quad
    layouts and splits the five table planes. `chain_start` is left empty:
    the JAX jobs carry it."""
    latlo, lathi, tables, bodyn, states0, tbl_ids = (np.asarray(a) for a in dev_args)
    lo = _from_round_layout(latlo).astype(np.uint32).astype(np.uint64)
    hi = _from_round_layout(lathi).astype(np.uint32).astype(np.uint64)
    planes = tables[:, :, 0, :].astype(np.int64)
    b_pad = schema.b_pad
    lowers = (planes[:, 1, :b_pad] & M32).astype(np.uint64) | ((planes[:, 2, :b_pad] & M32).astype(np.uint64) << np.uint64(32))
    return EncodeLaunch(
        page_n=schema.page_n,
        latents=lo | (hi << np.uint64(32)),
        body_n=_undense(bodyn),
        table_id=np.repeat(tbl_ids.astype(np.int64), 256),
        states0=_undense(states0),
        nexts=planes[:, 0, : schema.ts].astype(np.int32),
        lowers=lowers,
        t1=planes[:, 3, :b_pad].astype(np.int32),
        t2=planes[:, 4, :b_pad].astype(np.int32),
        sec_words=schema.sec_words,
    )


def upload_launch(L: EncodeLaunch, device) -> dict:
    """Copy a launch's arrays to `device` (u64 as int64 bits)."""

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return {
        "latents": t(L.latents.view(np.int64)),
        "body_n": t(L.body_n),
        "table_id": t(L.table_id),
        "states0": t(L.states0),
        "nexts": t(L.nexts),
        "lowers": t(L.lowers.view(np.int64)),
        "t1": t(L.t1),
        "t2": t(L.t2),
    }


# ---------------------------------------------------------------------------
# K5: bin search + reverse tANS + offsets
# ---------------------------------------------------------------------------


def bin_ans_encode_plain(latents, body_n, table_id, states0, nexts, lowers, t1, t2):
    """Plain version of K5. latents (n, page_n) int64 u64 bits, body_n /
    table_id / states0 (n,) int64, nexts (n_tables, ts) int32, lowers
    (n_tables, b_pad) int64 u64 bits, t1 / t2 (n_tables, b_pad) int32.
    Returns p1 (n, page_n) int32 = val | renorm << 15 | ob << 19, offsets
    (n, page_n) int64 u64 bits and the final states (n, 4) int64; symbols
    at k >= body_n give zeros and leave the state as it is."""
    dev = latents.device
    i64 = torch.int64
    n, page_n = latents.shape
    ts, b_pad = nexts.shape[1], lowers.shape[1]
    valid = torch.arange(page_n, device=dev)[None, :] < body_n[:, None]

    # the last bin with lower <= latent (unsigned), else bin 0
    lat_x = latents ^ _MIN64
    low_x = (lowers ^ _MIN64).reshape(-1)
    base = (table_id * b_pad)[:, None]
    sym = torch.zeros_like(latents)
    step = b_pad >> 1
    while step:
        cand = sym + step
        sym = torch.where(low_x[base + cand] <= lat_x, cand, sym)
        step >>= 1
    gi = base + sym
    t1s = t1.reshape(-1).to(i64)[gi]
    t2s = t2.reshape(-1).to(i64)[gi]
    offsets = torch.where(valid, latents - lowers.reshape(-1)[gi], 0)
    del lat_x, sym, gi
    minren, ob, cutoff = t1s & 15, (t1s >> 4) & 127, t1s >> 11

    nexts_f = nexts.reshape(-1).to(i64)
    nbase = (table_id * ts)[:, None]
    st = states0[:, None].expand(n, 4).clone()
    p1 = torch.empty((n, page_n), dtype=torch.int32, device=dev)
    for r in range(page_n // 4 - 1, -1, -1):
        sl = slice(4 * r, 4 * r + 4)
        v = valid[:, sl]
        ren = minren[:, sl] + (st >= cutoff[:, sl]).to(i64)
        val = st & ((1 << ren) - 1)
        idx = (t2s[:, sl] + (st >> ren)).clamp(0, ts - 1)
        st = torch.where(v, nexts_f[nbase + idx], st)
        p1[:, sl] = torch.where(v, val | (ren << 15) | (ob[:, sl] << 19), 0).to(torch.int32)
    return p1, offsets, st


def bin_ans_encode(latents, body_n, table_id, states0, nexts, lowers, t1, t2):
    """K5: dissect every chain of a launch; arguments as
    bin_ans_encode_plain. Each block of CHAINS_PER_BLOCK chains must share
    one table (build_encode_launch pads each table's chains so)."""
    if latents.device.type == "cpu":
        return bin_ans_encode_plain(latents, body_n, table_id, states0, nexts, lowers, t1, t2)
    n, page_n = latents.shape
    b_pad = lowers.shape[1]
    if n % CHAINS_PER_BLOCK or page_n % BATCH or b_pad & (b_pad - 1):
        raise ValueError("bin_ans_encode needs whole blocks of chains, whole batches and a "
                         "power-of-two bin count")
    if (
        any(t.shape != (n,) for t in (body_n, table_id, states0))
        or nexts.dim() != 2
        or lowers.shape[0] != nexts.shape[0]
        or t1.shape != lowers.shape
        or t2.shape != lowers.shape
    ):
        raise ValueError("bin_ans_encode: argument shapes do not match the chains and tables")
    _check_cuda((latents, torch.int64), (body_n, torch.int64), (table_id, torch.int64),
                (states0, torch.int64), (nexts, torch.int32), (lowers, torch.int64),
                (t1, torch.int32), (t2, torch.int32))
    blocks = table_id.view(-1, CHAINS_PER_BLOCK)
    if not bool((blocks == blocks[:, :1]).all()):  # the kernel reads one table per block
        raise ValueError(f"bin_ans_encode: each block of {CHAINS_PER_BLOCK} chains must share one table")
    dev = latents.device
    p1 = torch.empty((n, page_n), dtype=torch.int32, device=dev)
    offsets = torch.empty((n, page_n), dtype=torch.int64, device=dev)
    states = torch.empty((n, 4), dtype=torch.int64, device=dev)
    kernels.launch_bin_ans_encode(latents, body_n, table_id, states0, nexts, lowers, t1, t2,
                                  p1, offsets, states)
    return p1, offsets, states


# ---------------------------------------------------------------------------
# glue: plain torch (XLA in the JAX package)
# ---------------------------------------------------------------------------


def section_cursors(p1: torch.Tensor):
    """Per (chain, batch) ANS and offset bit lengths, the bit cursors of
    each batch's sections in the page body ([ANS bits][offset bits], batch
    after batch) and each chain's total bits. Returns (ans_len, off_len
    (n, B), curs (n, 2B) with ANS cursors at even columns, total_bits
    (n,)), all int64."""
    n, page_n = p1.shape
    p = p1.view(n, page_n // BATCH, BATCH)
    ans_len = ((p >> 15) & 15).sum(2, dtype=torch.int64)
    off_len = ((p >> 19) & 127).sum(2, dtype=torch.int64)
    total = ans_len + off_len
    start = torch.cumsum(total, 1) - total
    curs = torch.stack([start, start + ans_len], 2).reshape(n, -1)
    return ans_len, off_len, curs, start[:, -1] + total[:, -1]


# ---------------------------------------------------------------------------
# K6: section bit-packing
# ---------------------------------------------------------------------------


def section_pack_plain(p1, offsets, curs, sec_words: int) -> torch.Tensor:
    """Plain version of K6. p1 (n, page_n) int32 and offsets (n, page_n)
    int64 from K5, curs (n, 2B) int64 from section_cursors. Returns (n,
    sec_words) int32: batch b's ANS values (renorm bits each) LSB-first from
    curs[:, 2b], then its offsets (ob bits each) from curs[:, 2b + 1]. Every
    value lands in at most three words and payload bits never overlap, so
    an index_add_ on int64 words is an OR."""
    dev = p1.device
    n, page_n = p1.shape
    B = page_n // BATCH
    p = p1.to(torch.int64).view(n, B, BATCH)
    ren, ob = (p >> 15) & 15, (p >> 19) & 127
    a_pos = curs[:, 0::2, None] + torch.cumsum(ren, 2) - ren
    o_pos = curs[:, 1::2, None] + torch.cumsum(ob, 2) - ob
    del ren, ob
    W = sec_words + 3  # deposits past the last payload word add zeros
    words = torch.zeros(n * W, dtype=torch.int64, device=dev)
    row = (torch.arange(n, device=dev) * W)[:, None, None]

    def deposit(v, pos):  # v < 2^32
        x = v << (pos & 31)
        w = row + (pos >> 5)
        words.index_add_(0, w.reshape(-1), (x & M32).reshape(-1))
        words.index_add_(0, (w + 1).reshape(-1), (x >> 32).reshape(-1))

    deposit(p & 0x7FFF, a_pos)
    off = offsets.view(n, B, BATCH)
    deposit(off & M32, o_pos)
    deposit((off >> 32) & M32, o_pos + 32)  # zero unless ob > 32
    return _to_i32(words.view(n, W)[:, :sec_words])


def section_pack(p1, offsets, curs, sec_words: int) -> torch.Tensor:
    """K6: the page body of every chain; arguments as section_pack_plain."""
    if p1.device.type == "cpu":
        return section_pack_plain(p1, offsets, curs, sec_words)
    n, page_n = p1.shape
    if page_n % BATCH or sec_words < 4 or sec_words % 4:
        raise ValueError("section_pack needs whole batches and sec_words a multiple of 4")
    if offsets.shape != p1.shape or curs.shape != (n, 2 * (page_n // BATCH)):
        raise ValueError("section_pack: argument shapes do not match the chains")
    _check_cuda((p1, torch.int32), (offsets, torch.int64), (curs, torch.int64))
    out = torch.zeros((n, sec_words), dtype=torch.int32, device=p1.device)
    kernels.launch_section_pack(p1, offsets, curs, out)
    return out


def encode_launch(L: EncodeLaunch, a: dict):
    """K5 -> glue -> K6 for one launch. Returns (sections (n, sec_words)
    int32, final states (n, 4), ans_len, off_len, total_bits)."""
    if not L.n_chains:  # every chunk trivial: nothing to launch
        z = a["latents"].new_zeros
        B = L.page_n // BATCH
        return z((0, L.sec_words), dtype=torch.int32), z((0, 4)), z((0, B)), z((0, B)), z(0)
    p1, offsets, states = bin_ans_encode(a["latents"], a["body_n"], a["table_id"], a["states0"],
                                         a["nexts"], a["lowers"], a["t1"], a["t2"])
    ans_len, off_len, curs, total_bits = section_cursors(p1)
    sections = section_pack(p1, offsets, curs, L.sec_words)
    return sections, states, ans_len, off_len, total_bits
