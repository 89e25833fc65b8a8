"""PCT container encode on an NVIDIA GPU: the PyTorch/CUDA counterpart of
the JAX package's `pcodec_tpu/ops/pallas_encode.py`.

Each chunk is trained (mode, delta, bins) on the card by
ops/device_train.py where it covers the configuration, else on the host by
plan_encode here (the copied `codec.compress.chunk_compressor`, whose
latents the card sorts with K8, ops/row_sort.py); the card dissects and
bit-packs every page. Each page of a chunk's primary latent var is one
independent encode *chain*:

    plan_encode          host, numpy: train every chunk (its latents sorted
                         by K8 on the card), build its tANS encoder table
                         (build_enc_tables)
    build_encode_launch  one row of latents per chain, a chain a (page,
                         latent var) (from the host's chunks, or sliced out
                         of device training's rows on the card), one table
                         per (chunk, var), one launch for all chunks
    bin_ans_encode       K5, CUDA (csrc/bin_ans_encode.cu): bin search,
                         reverse 4-stream tANS walk and offsets per chain
    section_pack         K6, CUDA (csrc/section_pack.cu): a warp a row
                         computes each batch's section lengths and cursors
                         and bit-packs its ANS values and offsets at them
                         (section_cursors is that first step in plain torch);
                         a row is a chain, or a page whose vars' chains it
                         interleaves batch by batch at joint cursors

ops/assemble.py stitches the sections into the file image on the card and
holds the entry points.

Every mode (Classic, Dict, IntMult, FloatMult, FloatQuant) and every delta
encodes here: a chunk's latent vars (the lookbacks of a lookback delta,
the primary, the secondary) each get their chains and table. A trivial var
writes no body bits and needs no chain.

u64 values travel as int64 tensors holding the same bits (see
container_decode.py). Each kernel wrapper takes its plain PyTorch version
only for CPU tensors; for CUDA tensors it launches the kernel or raises.
"""

from dataclasses import dataclass, field, replace
from functools import partial
from typing import List, Optional, Union

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
class VarJob:
    """One latent var of a chunk: its encoder table and the page meta's
    fields for it."""

    key: str  # "delta", "primary" or "secondary"
    tables: Optional[tuple]  # build_enc_tables output; None for a trivial var
    sec_words: int  # worst-case section words of one page; 0 when trivial
    n_state: int  # delta-state latents in each page meta
    state_bits: int  # bits of each of them
    sl: int  # ANS size log: the bits of each of the 4 final state indices

    @property
    def trivial(self) -> bool:
        return self.tables is None


@dataclass
class ChunkJob:
    cc: ChunkCompressor
    order: int  # consecutive delta order of the primary; 0 for another delta
    vars: List[VarJob]  # the chunk's latent vars in file order

    @property
    def primary(self) -> VarJob:
        return next(v for v in self.vars if v.key == "primary")

    @property
    def tables(self) -> Optional[tuple]:
        return self.primary.tables

    @property
    def trivial(self) -> bool:
        """No var has a chain."""
        return all(v.trivial for v in self.vars)

    @property
    def sec_words(self) -> int:
        """Worst-case section words of one page, every var's together."""
        return sum(v.sec_words for v in self.vars)

    @property
    def multi(self) -> bool:
        return len(self.vars) > 1


@dataclass
class DeviceRows:
    """The page rows that device training (ops/device_train.py) leaves on
    the card: page p of chunk ci is row ci * rows_per_chunk + p. Each row
    holds its page's primary latents after the chunk's delta (the first
    `order` columns are junk, the stored latents follow up to the page
    length); a chunk that fell back to the baseline compressor holds its
    raw latents. A chunk whose mode splits has its secondary latents (NOOP
    delta, every position stored) in the same layout in sec_rows, from row
    sec_row0[ci] on; a chunk whose delta is lookback has its primary's
    toggled deltas after a state_n front in rows, its state in moments and
    its u32 lookbacks from column 0 in lb_rows, from row lb_row0[ci] on."""

    rows: torch.Tensor  # (n_chunks * rows_per_chunk, page_n) int64, u64 bits
    # (n_chunks * rows_per_chunk, max order or state_n) int64: each page's
    # delta state (a consecutive delta's moments, a lookback's front latents)
    moments: torch.Tensor
    rows_per_chunk: int
    sec_rows: Optional[torch.Tensor] = None  # (split chunks * rows_per_chunk, page_n) int64, u64 bits
    sec_row0: dict = field(default_factory=dict)  # split chunk -> its first row of sec_rows
    lb_rows: Optional[torch.Tensor] = None  # (lookback chunks * rows_per_chunk, page_n - state_n) int32
    lb_row0: dict = field(default_factory=dict)  # lookback chunk -> its first row of lb_rows


@dataclass
class EncodePlan:
    nt: NumberType
    n: int
    page_n: int
    chunk_ns: List[int]
    jobs: List[ChunkJob]
    trained_on: str = "host"  # "device": ops/device_train.py; "host": plan_encode
    dev: Optional[DeviceRows] = None  # device training's page rows
    # numbers copied from the card to the host: a tensor's chunks that fell
    # back to the baseline compressor, or all of them when it trained on the host
    host_copied: int = 0


def chunk_job(cc: ChunkCompressor, page_n: int) -> ChunkJob:
    """The launch job of one trained chunk: per latent var its encoder
    table, the worst-case section words of one page and its page meta's
    fields."""
    meta = cc.meta
    de = meta.delta_encoding
    vars_ = []
    for key, lvc in cc.lvcs.enumerated():
        vm = meta.per_latent_var.get(key)
        n_state = de.for_latent_var(key).n_latents_per_state()
        state_bits = vm.latent_type.bits
        if n_state and isinstance(cc.page_infos, list) and cc.page_infos:
            # the meta writes each state at its dtype's width (device training's
            # lazy infos hold the latent type's)
            state_bits = 8 * cc.page_infos[0].per_latent_var.get(key).delta_state.dtype.itemsize
        tables, sec_words = None, 0
        if not lvc.is_trivial:
            worst = int(np.max(vm.bins.worst_case_bits_per_latent(lvc.ans_size_log)))
            tables, sec_words = build_enc_tables(vm), -(-(page_n * (worst + 1) + 64) // 32)
        vars_.append(VarJob(key, tables, sec_words, n_state, state_bits, int(vm.ans_size_log)))
    order = de.order if de.kind == DeltaEncoding.CONSECUTIVE else 0
    return ChunkJob(cc, order, vars_)


def plan_encode(nums: np.ndarray, config: Optional[ChunkConfig] = None, page_n: int = 1024,
                chunk_n: int = 1 << 20, device="cuda") -> EncodePlan:
    """Training of every chunk and its encoder table on the host (the JAX
    `_plan_encode`), except the sort of each chunk's latents, which K8 does
    on `device` (the GPU unless the caller asks for the CPU). Every page
    length that is a multiple of 256 encodes on the card, with any table
    size. ops/device_train.plan_encode_device trains on the card instead."""
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
        jobs.append(chunk_job(cc, page_n))
    return EncodePlan(nt=nt, n=len(nums), page_n=page_n, chunk_ns=chunk_ns, jobs=jobs)


@dataclass
class EncodeLaunch:
    """One launch of K5 + K6 for every coded (chunk, var): one row per chain
    (a page of one var), each table's chains padded to CHAINS_PER_BLOCK with
    inert chains (body_n 0), so every K5 block reads a single table. Bins
    are padded to a power of two with copies of the last bin, which the
    search may pick but which encode exactly as that bin.

    K6 packs a row per chain when every chunk has one latent var
    (row_chains None); else a row per page of the file, the chains of its
    vars interleaved batch by batch (row_chains)."""

    page_n: int
    # (n_chains, page_n), zero past body_n: a uint64 array built on the host,
    # or an int64 tensor of the same bits on the card after device training
    latents: Union[np.ndarray, torch.Tensor]
    body_n: np.ndarray  # (n_chains,) int64 latents coded in the chain
    table_id: np.ndarray  # (n_chains,) int64
    states0: np.ndarray  # (n_chains,) int64 encoder start state (= real table size)
    nexts: np.ndarray  # (n_tables, ts) int32 next state per (wbase + x) slot
    lowers: np.ndarray  # (n_tables, b_pad) uint64 sorted bin lowers
    t1: np.ndarray  # (n_tables, b_pad) int32 min_renorm | ob << 4 | cutoff << 11
    t2: np.ndarray  # (n_tables, b_pad) int32 wbase - weight
    sec_words: int  # K6's row words (multiple of 4), a bound for every row
    var_starts: List[dict] = field(default_factory=list)  # per chunk: each var's first chain; -1 when trivial
    # (R, V) int64: K6's row of each page of the file, the chain of its v-th
    # var in file order (-1: trivial or none); None: K6 packs a row a chain
    row_chains: Optional[np.ndarray] = None

    @property
    def n_chains(self) -> int:
        return len(self.body_n)

    @property
    def chain_start(self) -> List[int]:
        """Per chunk: the primary's first chain; -1 when trivial."""
        return [vs.get("primary", -1) for vs in self.var_starts]

    @property
    def n_rows(self) -> int:
        """K6's rows."""
        return self.n_chains if self.row_chains is None else len(self.row_chains)


def _page_bodies(cn: int, order: int, page_n: int):
    """(skip, body_n) per page of a chunk of cn numbers: page p codes its
    latents from min(order, page length) on (its stored range; order is
    the var's delta-state latents a page)."""
    lens = np.asarray(ctn._exact_split(cn, page_n), np.int64)
    skip = np.minimum(order, lens)
    return skip, lens - skip


def _var_rows(cc: ChunkCompressor, key: str, page_n: int):
    """(rows (n_pages, page_n) uint64, body_n (n_pages,)): each page's
    stored latents of one var of a host-trained chunk (its page info's
    [start, end) of the var's latents), from the row's start, zeros after."""
    lat = cc.lvcs.get(key).latents
    starts = np.asarray([info.per_latent_var.get(key).start for info in cc.page_infos], np.int64)
    body_n = np.asarray([info.per_latent_var.get(key).end for info in cc.page_infos], np.int64) - starts
    padded = np.zeros(len(lat) + page_n, dtype=np.uint64)
    padded[: len(lat)] = lat
    col = np.arange(page_n)[None, :]
    rows = padded[starts[:, None] + col]
    rows[col >= body_n[:, None]] = 0
    return rows, body_n


def _rows_on_card(dev: DeviceRows, src_row: np.ndarray, skip: np.ndarray, body_n: np.ndarray,
                  src: np.ndarray) -> torch.Tensor:
    """(n_chains, page_n) int64 on the rows' device: chain c takes row
    src_row[c] of the device rows src[c] names (0 the primary rows, 1 the
    secondary rows, 2 the lookback rows) from column skip[c] on, body_n[c]
    latents, zeros after (the JAX `_build_launch_args(dev_rows=...)`)."""
    page_n = dev.rows.shape[1]
    out = dev.rows.new_empty((len(src_row), page_n))
    col = torch.arange(page_n, device=dev.rows.device)[None, :]
    for k, rows in enumerate((dev.rows, dev.sec_rows, dev.lb_rows)):
        sel = np.flatnonzero(src == k)
        if not len(sel):
            continue
        sr, sk, bn = (torch.from_numpy(a[sel]).to(rows.device) for a in (src_row, skip, body_n))
        lat = rows[sr].gather(1, (col + sk[:, None]).clamp(max=rows.shape[1] - 1))
        out[torch.from_numpy(sel).to(rows.device)] = torch.where(col < bn[:, None], lat, 0).to(out.dtype)
    return out


def build_encode_launch(plan: EncodePlan) -> EncodeLaunch:
    """Chain-major launch arrays of every coded (chunk, var) (the JAX
    `_build_launch_args` without the TPU layout). The latents come from the
    host's trained chunks, or, after device training, from the page rows on
    the card, each var's from its own rows (no host latents, no upload)."""
    page_n = plan.page_n
    items = [(ci, vj) for ci, job in enumerate(plan.jobs) for vj in job.vars if not vj.trivial]
    ts = max((vj.tables[4] for _, vj in items), default=1)
    b_max = max((len(vj.tables[1]) for _, vj in items), default=1)
    b_pad = 1 << (b_max - 1).bit_length()
    n_tables = len(items)
    n_pages = [-(-cn // page_n) for cn in plan.chunk_ns]
    n_rows = [-(-n_pages[ci] // CHAINS_PER_BLOCK) * CHAINS_PER_BLOCK for ci, _ in items]
    n_chains = sum(n_rows)
    multi = any(job.multi for job in plan.jobs)
    row_words = max((job.sec_words for job in plan.jobs) if multi else (vj.sec_words for _, vj in items),
                    default=4)
    L = EncodeLaunch(
        page_n=page_n,
        latents=np.zeros((n_chains, page_n), dtype=np.uint64) if plan.dev is None else None,
        body_n=np.zeros(n_chains, dtype=np.int64),
        table_id=np.zeros(n_chains, dtype=np.int64),
        states0=np.zeros(n_chains, dtype=np.int64),
        nexts=np.zeros((n_tables, ts), dtype=np.int32),
        lowers=np.zeros((n_tables, b_pad), dtype=np.uint64),
        t1=np.zeros((n_tables, b_pad), dtype=np.int32),
        t2=np.zeros((n_tables, b_pad), dtype=np.int32),
        sec_words=-(-max(row_words, 4) // 4) * 4,
        var_starts=[{vj.key: -1 for vj in job.vars} for job in plan.jobs],
    )
    src_row = np.zeros(n_chains, dtype=np.int64)
    skip = np.zeros(n_chains, dtype=np.int64)
    src = np.zeros(n_chains, dtype=np.int64)  # _rows_on_card's rows of each chain
    pos = 0
    for tid, ((ci, vj), rows) in enumerate(zip(items, n_rows)):
        job = plan.jobs[ci]
        nexts, lowers, t1, t2, tsj = vj.tables
        b = len(lowers)
        L.nexts[tid, :tsj] = nexts
        L.lowers[tid] = lowers[-1]
        L.lowers[tid, :b] = lowers
        L.t1[tid] = t1[-1]
        L.t1[tid, :b] = t1
        L.t2[tid] = t2[-1]
        L.t2[tid, :b] = t2
        sl = slice(pos, pos + n_pages[ci])
        if plan.dev is None:
            L.latents[sl], L.body_n[sl] = _var_rows(job.cc, vj.key, page_n)
        elif vj.key == "secondary":  # NOOP: every position stored
            L.body_n[sl] = _page_bodies(plan.chunk_ns[ci], 0, page_n)[1]
            src_row[sl] = plan.dev.sec_row0[ci] + np.arange(n_pages[ci])
            src[sl] = 1
        elif vj.key == "delta":  # the lookbacks, one for each primary latent stored
            L.body_n[sl] = _page_bodies(plan.chunk_ns[ci], job.primary.n_state, page_n)[1]
            src_row[sl] = plan.dev.lb_row0[ci] + np.arange(n_pages[ci])
            src[sl] = 2
        else:  # stored after the page's delta-state front
            sk, L.body_n[sl] = _page_bodies(plan.chunk_ns[ci], vj.n_state, page_n)
            src_row[sl] = ci * plan.dev.rows_per_chunk + np.arange(n_pages[ci])
            skip[sl] = sk
        L.table_id[pos : pos + rows] = tid
        L.states0[pos : pos + rows] = tsj
        L.var_starts[ci][vj.key] = pos
        pos += rows
    if plan.dev is not None:
        L.latents = _rows_on_card(plan.dev, src_row, skip, L.body_n, src)
    if multi:
        V = max(len(job.vars) for job in plan.jobs)
        L.row_chains = np.full((sum(n_pages), V), -1, dtype=np.int64)
        p0 = 0
        for ci, job in enumerate(plan.jobs):
            for v, vj in enumerate(job.vars):
                c0 = L.var_starts[ci][vj.key]
                if c0 >= 0:
                    L.row_chains[p0 : p0 + n_pages[ci], v] = c0 + np.arange(n_pages[ci])
            p0 += n_pages[ci]
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
    layouts and splits the five table planes. `var_starts` is left empty:
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


def upload_launch(L: EncodeLaunch, device, chains: Optional[tuple] = None, rows: Optional[tuple] = None) -> dict:
    """Copy a launch's arrays to `device` (u64 as int64 bits): every chain,
    or the chains [c0, c1) = `chains` (whole blocks of CHAINS_PER_BLOCK, so
    each K5 block keeps its one table) and K6's rows [r0, r1) = `rows` (the
    same range where a row is a chain; else pages whose vars' chains all
    lie in [c0, c1), their row_chains rebased to c0). The tables go whole."""

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    c0, c1 = chains or (0, L.n_chains)
    r0, r1 = rows or ((c0, c1) if L.row_chains is None else (0, L.n_rows))
    if chains and (c0 % CHAINS_PER_BLOCK or c1 % CHAINS_PER_BLOCK or not 0 <= c0 <= c1 <= L.n_chains):
        raise ValueError(f"a shard's chains must be whole blocks of {CHAINS_PER_BLOCK} within the launch")
    lat = L.latents[c0:c1]
    a = {
        "latents": lat.to(device) if isinstance(lat, torch.Tensor) else t(lat.view(np.int64)),
        "body_n": t(L.body_n[c0:c1]),
        "table_id": t(L.table_id[c0:c1]),
        "states0": t(L.states0[c0:c1]),
        "nexts": t(L.nexts),
        "lowers": t(L.lowers.view(np.int64)),
        "t1": t(L.t1),
        "t2": t(L.t2),
    }
    if L.row_chains is not None:
        rc = L.row_chains[r0:r1]
        if ((rc >= 0) & ((rc < c0) | (rc >= c1))).any():
            raise ValueError("a shard's rows must name only its own chains")
        a["row_chains"] = t(np.where(rc >= 0, rc - c0, -1))
    elif (r0, r1) != (c0, c1):
        raise ValueError("where a row is a chain, a shard's rows are its chains")
    return a


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


def bin_ans_encode_tiled_plain(latents, body_n, table_id, states0, nexts, lowers, t1, t2,
                               tile_rounds: int = kernels.K5_TILE_ROUNDS):
    """K5's steps in plain torch, for the CPU tests: tiles of tile_rounds
    rounds from the last to the first, each a search step (every symbol's
    bin and offset at once) and then the walk of each (chain, stream) back
    through the tile's symbols of its stream, the states carried from tile
    to tile. Arguments and result as bin_ans_encode_plain."""
    dev = latents.device
    i64 = torch.int64
    n, page_n = latents.shape
    ts, b_pad = nexts.shape[1], lowers.shape[1]
    tile = 4 * tile_rounds
    valid = torch.arange(page_n, device=dev)[None, :] < body_n[:, None]
    low_x = (lowers ^ _MIN64).reshape(-1)
    base = (table_id * b_pad)[:, None]
    nexts_f = nexts.reshape(-1).to(i64)
    nbase = (table_id * ts)[:, None]
    st = states0[:, None].expand(n, 4).clone()
    p1 = torch.empty((n, page_n), dtype=torch.int32, device=dev)
    offsets = torch.empty((n, page_n), dtype=i64, device=dev)
    for t in range(page_n // tile - 1, -1, -1):
        cols = slice(t * tile, (t + 1) * tile)
        lat = latents[:, cols]
        v = valid[:, cols]
        sym = torch.zeros_like(lat)  # search: the last bin with lower <= latent
        step = b_pad >> 1
        while step:
            sym = torch.where(low_x[base + sym + step] <= lat ^ _MIN64, sym + step, sym)
            step >>= 1
        offsets[:, cols] = torch.where(v, lat - lowers.reshape(-1)[base + sym], 0)
        a = t1.reshape(-1).to(i64)[base + sym]
        b2 = t2.reshape(-1).to(i64)[base + sym]
        for r in range(tile_rounds - 1, -1, -1):  # walk: the 4 streams of every chain
            q = slice(4 * r, 4 * r + 4)
            ren = (a[:, q] & 15) + (st >= a[:, q] >> 11).to(i64)
            val = st & ((1 << ren) - 1)
            nx = nexts_f[nbase + (b2[:, q] + (st >> ren)).clamp(0, ts - 1)]
            p1[:, t * tile + 4 * r : t * tile + 4 * r + 4] = torch.where(
                v[:, q], val | (ren << 15) | (((a[:, q] >> 4) & 127) << 19), 0).to(torch.int32)
            st = torch.where(v[:, q], nx, st)
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
# K6: section cursors and bit-packing
# ---------------------------------------------------------------------------


def section_cursors(p1: torch.Tensor):
    """Per (chain, batch) ANS and offset bit lengths, the bit cursors of
    each batch's sections in the page body ([ANS bits][offset bits], batch
    after batch) and each chain's total bits: K6's first step in plain
    torch (XLA glue in the JAX package). Returns (ans_len, off_len (n, B),
    curs (n, 2B) with ANS cursors at even columns, total_bits (n,)), all
    int64."""
    n, page_n = p1.shape
    p = p1.view(n, page_n // BATCH, BATCH)
    ans_len = ((p >> 15) & 15).sum(2, dtype=torch.int64)
    off_len = ((p >> 19) & 127).sum(2, dtype=torch.int64)
    total = ans_len + off_len
    start = torch.cumsum(total, 1) - total
    curs = torch.stack([start, start + ans_len], 2).reshape(n, -1)
    return ans_len, off_len, curs, start[:, -1] + total[:, -1]


def joint_cursors(ans_len, off_len, row_chains):
    """The sections' places when K6's row is a page of several vars: per
    (row, var, batch) the ANS and offset bit lengths (zeros where the
    row's var has no chain), the joint cursors (batch by batch, var by var
    in file order, each [ANS][offsets], from bit 0 of the row; the JAX
    `_multi_glue`'s exclusive scan) and each row's total bits. ans_len and
    off_len (n_chains, B) per chain, row_chains (R, V) int64. Returns
    (a, o (R, V, B), ans_at, off_at (R, V, B), total_bits (R,))."""
    R, V = row_chains.shape
    B = ans_len.shape[1]
    ok = (row_chains >= 0)[:, :, None]
    c = row_chains.clamp(min=0)
    a = torch.where(ok, ans_len[c], 0)
    o = torch.where(ok, off_len[c], 0)
    tot = (a + o).transpose(1, 2).reshape(R, B * V)  # batch-major, var-minor
    excl = (torch.cumsum(tot, 1) - tot).view(R, B, V).transpose(1, 2)
    return a, o, excl, excl + a, tot.sum(1)


def _deposit_rows(p1, offsets, curs, row, n_rows: int, sec_words: int) -> torch.Tensor:
    """Chain c's batch b deposited into row row[c] (n_rows: dropped): its
    ANS values (renorm bits each) LSB-first from curs[c, 2b], its offsets
    (ob bits each) from curs[c, 2b + 1]. Every value lands in at most three
    words and payload bits never overlap, so an index_add_ on int64 words
    is an OR. Returns (n_rows, sec_words) int32."""
    dev = p1.device
    n, page_n = p1.shape
    B = page_n // BATCH
    p = p1.to(torch.int64).view(n, B, BATCH)
    ren, ob = (p >> 15) & 15, (p >> 19) & 127
    a_pos = curs[:, 0::2, None] + torch.cumsum(ren, 2) - ren
    o_pos = curs[:, 1::2, None] + torch.cumsum(ob, 2) - ob
    del ren, ob
    W = sec_words + 3  # deposits past the last payload word add zeros
    words = torch.zeros((n_rows + 1) * W, dtype=torch.int64, device=dev)
    base = (row * W)[:, None, None]

    def deposit(v, pos):  # v < 2^32
        x = v << (pos & 31)
        w = base + (pos >> 5)
        words.index_add_(0, w.reshape(-1), (x & M32).reshape(-1))
        words.index_add_(0, (w + 1).reshape(-1), (x >> 32).reshape(-1))

    deposit(p & 0x7FFF, a_pos)
    off = offsets.view(n, B, BATCH)
    deposit(off & M32, o_pos)
    deposit((off >> 32) & M32, o_pos + 32)  # zero unless ob > 32
    return _to_i32(words.view(n_rows + 1, W)[:n_rows, :sec_words])


def section_pack_plain(p1, offsets, sec_words: int, row_chains=None):
    """Plain version of K6. p1 (n, page_n) int32 and offsets (n, page_n)
    int64 from K5. Without row_chains a row is a chain: returns (sections
    (n, sec_words) int32, ans_len, off_len (n, B), total_bits (n,)) from
    section_cursors, then batch b's ANS values (renorm bits each)
    LSB-first from its ANS cursor and its offsets (ob bits each) from its
    offset cursor. With row_chains (R, V) a row is a page whose vars'
    chains it interleaves at joint_cursors: returns (sections (R,
    sec_words), ans_len, off_len (R, V, B), total_bits (R,))."""
    ans_len, off_len, curs, total_bits = section_cursors(p1)
    n = p1.shape[0]
    if row_chains is None:
        row = torch.arange(n, device=p1.device)
        return _deposit_rows(p1, offsets, curs, row, n, sec_words), ans_len, off_len, total_bits
    R, V = row_chains.shape
    a, o, ans_at, off_at, total_bits = joint_cursors(ans_len, off_len, row_chains)
    ok = row_chains >= 0
    chains = row_chains[ok]
    row = torch.full((n,), R, dtype=torch.int64, device=p1.device)
    row[chains] = torch.arange(R, device=p1.device)[:, None].expand(R, V)[ok]
    curs = torch.zeros_like(curs)
    curs[chains] = torch.stack([ans_at, off_at], 3)[ok].reshape(len(chains), -1)
    return _deposit_rows(p1, offsets, curs, row, R, sec_words), a, o, total_bits


def section_pack(p1, offsets, sec_words: int, row_chains=None):
    """K6: the page body of every row and its section lengths, the cursors
    computed in the kernel; arguments and results as section_pack_plain.
    Rows of at most kernels.section_pack_smem_words words are staged in
    shared memory, longer ones ORed in device memory."""
    if p1.device.type == "cpu":
        return section_pack_plain(p1, offsets, sec_words, row_chains)
    n, page_n = p1.shape
    if page_n < BATCH or page_n % BATCH or sec_words < 4 or sec_words % 4:
        raise ValueError("section_pack needs whole batches and sec_words a multiple of 4")
    if offsets.shape != p1.shape or (row_chains is not None and (row_chains.dim() != 2 or not
                                                                 1 <= row_chains.shape[1] <= kernels.K6_MAX_VARS)):
        raise ValueError("section_pack: argument shapes do not match the chains")
    _check_cuda((p1, torch.int32), (offsets, torch.int64), *(((row_chains, torch.int64),) if row_chains is not None
                                                             else ()))
    dev = p1.device
    R, V = (n, 1) if row_chains is None else tuple(row_chains.shape)
    B = page_n // BATCH
    out = torch.empty((R, sec_words), dtype=torch.int32, device=dev)
    lens = torch.empty((2, R, V, B), dtype=torch.int64, device=dev)
    total_bits = torch.empty(R, dtype=torch.int64, device=dev)
    kernels.launch_section_pack(p1, offsets, out, lens[0], lens[1], total_bits, row_chains)
    if row_chains is None:
        return out, lens[0, :, 0], lens[1, :, 0], total_bits
    return out, lens[0], lens[1], total_bits


def encode_launch(L: EncodeLaunch, a: dict):
    """K5 -> K6 for the chains and rows uploaded in `a` (upload_launch: a
    launch, or a shard of it). Returns (sections (rows, sec_words) int32,
    final states (chains, 4), ans_len, off_len, total_bits): K6's rows
    (section_pack)."""
    if not a["body_n"].shape[0]:  # no chain: nothing to launch, K6's rows empty
        z = a["latents"].new_zeros
        B = L.page_n // BATCH
        rc = a.get("row_chains")
        R = 0 if rc is None else rc.shape[0]
        lens = (R, B) if rc is None else (R, rc.shape[1], B)
        return z((R, L.sec_words), dtype=torch.int32), z((0, 4)), z(lens), z(lens), z(R)
    p1, offsets, states = bin_ans_encode(a["latents"], a["body_n"], a["table_id"], a["states0"],
                                         a["nexts"], a["lowers"], a["t1"], a["t2"])
    sections, ans_len, off_len, total_bits = section_pack(p1, offsets, L.sec_words, a.get("row_chains"))
    return sections, states, ans_len, off_len, total_bits
