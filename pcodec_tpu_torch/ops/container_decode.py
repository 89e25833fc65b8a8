"""PCT container decode on an NVIDIA GPU: the PyTorch/CUDA counterpart of
the JAX package's `pcodec_tpu/ops/pallas_decode.py`.

Every (page, latent var) of the wrapped Pco stream is an independent decode
*chain*: the container directory (codec/container.py) locates each
256-number batch's [ans bits][offset bits] sections, and the page metadata
holds the 4 interleaved tANS states and the delta moments of the page.

    plan_container   host, numpy: one row per chain, absolute bit cursors,
                     one (node, lower) table per (chunk, var)
    section_gather   K1, CUDA (csrc/section_gather.cu): copies each chain's
                     sections out of the container into a chain-major
                     staging buffer
    chain_decode     K2, CUDA (csrc/chain_decode.cu): one thread per chain,
                     4-stream tANS + offsets + lower; in its fused form it also
                     applies the order-1 delta and the Classic join
    post             per chunk: the `delta` var first, then `primary` and
                     `secondary`; delta reconstruction (consecutive and conv1
                     in plain torch, lookback through K3), ragged trim, then
                     the mode join (Dict through K4, the others in plain
                     torch; ops/decode.py holds all of these)

Every mode (Classic, Dict, IntMult, FloatQuant, FloatMult) and every delta
(NOOP, consecutive, lookback, conv1) of every number type decodes here;
nothing goes to the host.

u64 values travel as int64 tensors holding the same bits: add, multiply and
cumsum wrap mod 2^64 exactly, a logical right shift is `(x >> k) & mask`.

Each kernel wrapper takes its plain PyTorch version only for CPU tensors;
for CUDA tensors it launches the kernel or raises.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from pcodec_tpu_torch import constants as c
from pcodec_tpu_torch.codec.container import parse_container
from pcodec_tpu_torch.dtypes import NumberType
from pcodec_tpu_torch.errors import CorruptionError
from pcodec_tpu_torch.format import ans
from pcodec_tpu_torch.format.bitio import BitReader
from pcodec_tpu_torch.format.metadata import DeltaEncoding, Mode
from pcodec_tpu_torch.ops import decode as dec
from pcodec_tpu_torch.ops import kernels
from pcodec_tpu_torch.ops.decode import _MIN64, _check_cuda, _i64, _u64_to_tensor

BATCH = c.FULL_BATCH_N  # 256
ROUNDS_PER_BATCH = BATCH // c.ANS_INTERLEAVING  # 64
CHAINS_PER_BLOCK = kernels.CHAINS_PER_BLOCK  # chains sharing one table in K2
SLACK_WORDS = 2  # zero words after each staged chain (3-word offset reads)

_DELTA_KINDS = (DeltaEncoding.NOOP, DeltaEncoding.CONSECUTIVE, DeltaEncoding.LOOKBACK, DeltaEncoding.CONV1)


# ---------------------------------------------------------------------------
# host planner
# ---------------------------------------------------------------------------


@dataclass
class VarPlan:
    key: str
    trivial: bool
    const_lower: int  # u64, the latent of every number when trivial
    moments: np.ndarray  # (n_pages, state_n) u64 stored delta state
    bits: int  # the var's latent bits (32 for a Dict primary, else the number's)
    launch_key: Optional[tuple] = None
    chain_start: int = 0  # first chain of this var within its launch


@dataclass
class ChunkPlan:
    n_pages: int
    page_ns: np.ndarray
    page_n: int  # launch page length: max page_n rounded up to BATCH
    delta: DeltaEncoding
    mode_kind: str
    mode_scalar: int  # IntMult/FloatMult base latent, FloatQuant k; else 0
    var_plans: Dict[str, VarPlan]
    dict_table: Optional[np.ndarray] = None  # (D,) int64 memory bits of each Dict entry


@dataclass
class ChainPlan:
    """One launch of K1 + K2: chains sharing page_n and fuse, one row each.
    Each table's chains are padded to CHAINS_PER_BLOCK with inert chains
    (body_n 0), so every K2 block reads a single table."""

    page_n: int
    fuse: int  # 0: latents; 1/2: memory bits of i64/u64 (order-1 delta fused)
    chain_bit0: np.ndarray  # (n_chains,) int64 absolute bit of the first section
    curs: np.ndarray  # (n_chains, 2B) int64 absolute [ans, offset] bits per batch
    states0: np.ndarray  # (n_chains, 4) int64 initial tANS state indices
    body_n: np.ndarray  # (n_chains,) int64 latents coded in the chain
    table_id: np.ndarray  # (n_chains,) int64
    moment0: np.ndarray  # (n_chains,) uint64 first delta moment (fused only, else 0)
    node: np.ndarray  # (n_tables, ts) uint32 bits | ob << 4 | next_state_base << 11
    lower: np.ndarray  # (n_tables, ts) uint64 bin lower of each state
    stage_words: int = SLACK_WORDS  # staging stride W in u32 words (multiple of 4)

    @property
    def n_chains(self) -> int:
        return len(self.chain_bit0)

    @property
    def word0(self) -> np.ndarray:
        """First container word each chain stages (chain_bit0 rounded down
        to 4 bytes)."""
        return self.chain_bit0 >> 5


@dataclass
class ContainerPlan:
    nt: NumberType
    chunks: List[ChunkPlan]
    launches: Dict[tuple, ChainPlan]
    words: np.ndarray  # container bytes as u32 words, zero padded


def _build_var_tables(var_meta):
    """node (u32) and lower (u64) per tANS state; the formula of the JAX
    planner's `_build_var_tables`."""
    bins = var_meta.bins
    n_bins = len(bins)
    if n_bins == 1:
        node = np.array([int(bins.offset_bits[0]) << 4], dtype=np.int64)
        lowers = bins.lowers.astype(np.uint64)
    else:
        spec = ans.Spec.from_weights(var_meta.ans_size_log, bins.weights.tolist())
        dec = ans.Decoder(spec, bins.offset_bits.tolist())
        node = (
            dec.bits_to_read.astype(np.int64)
            | (dec.offset_bits.astype(np.int64) << 4)
            | (dec.next_state_idx_base.astype(np.int64) << 11)
        )
        sym = np.minimum(spec.state_symbols, n_bins - 1)
        lowers = np.where(
            spec.state_symbols < n_bins, bins.lowers[sym].astype(np.uint64), np.uint64(0)
        )
    return node.astype(np.uint32), lowers.astype(np.uint64)


def _check_supported(ci: int, meta) -> None:
    if meta.mode.kind not in Mode._WIRE:
        raise NotImplementedError(f"chunk {ci}: unknown mode {meta.mode.kind!r}")
    if meta.delta_encoding.kind not in _DELTA_KINDS:
        raise NotImplementedError(f"chunk {ci}: unknown delta encoding {meta.delta_encoding.kind!r}")


def _fuse_kind(key: str, meta, nt: NumberType) -> int:
    de = meta.delta_encoding
    if (
        key == "primary"
        and meta.mode.kind == Mode.CLASSIC
        and de.kind == DeltaEncoding.CONSECUTIVE
        and de.order == 1
        and nt.latent.bits == 64
        and nt.kind in ("signed", "unsigned")
    ):
        return 1 if nt.kind == "signed" else 2
    return 0


def plan_container(data: bytes) -> ContainerPlan:
    """Chain-major decode plan of a PCT container: every mode and delta
    encoding, any page length, all on the card."""
    idx = parse_container(data)
    reader = BitReader(np.frombuffer(idx.data, dtype=np.uint8))
    pages_by_chunk: List[list] = [[] for _ in idx.chunk_metas]
    for p in idx.pages:
        pages_by_chunk[p.chunk_idx].append(p)

    groups: Dict[tuple, list] = {}
    chunks: List[ChunkPlan] = []
    for ci, meta in enumerate(idx.chunk_metas):
        _check_supported(ci, meta)
        pages = pages_by_chunk[ci]
        n_pages = len(pages)
        page_ns = np.array([p.page_n for p in pages], dtype=np.int64)
        page_n = -(-int(page_ns.max(initial=1)) // BATCH) * BATCH
        page_starts = np.array([p.byte_start for p in pages], dtype=np.int64)
        body_bit0 = (page_starts + meta.exact_page_meta_size()) * 8
        keys = [k for k, _ in meta.per_latent_var.enumerated()]

        # page meta: state_n moments, then 4 tANS initial state indices per var
        pm_bit = page_starts * 8
        var_states: Dict[str, np.ndarray] = {}
        var_init: Dict[str, np.ndarray] = {}
        for key, vm in meta.per_latent_var.enumerated():
            state_n = meta.delta_encoding.for_latent_var(key).n_latents_per_state()
            lt_bits = vm.latent_type.bits
            st = np.zeros((n_pages, 0), dtype=np.uint64)
            if state_n > 0 and n_pages:
                pos = pm_bit[:, None] + np.arange(state_n)[None, :] * lt_bits
                st = reader.gather_batch(
                    pos.reshape(-1), np.full(pos.size, lt_bits), lt_bits
                ).reshape(n_pages, state_n)
            var_states[key] = st
            pm_bit = pm_bit + state_n * lt_bits
            iv = np.zeros((n_pages, 4), dtype=np.uint64)
            if vm.ans_size_log > 0 and n_pages:
                ipos = pm_bit[:, None] + np.arange(4)[None, :] * vm.ans_size_log
                iv = reader.gather_batch(
                    ipos.reshape(-1), np.full(ipos.size, vm.ans_size_log), vm.ans_size_log
                ).reshape(n_pages, 4)
            var_init[key] = iv.astype(np.int64)
            pm_bit = pm_bit + 4 * vm.ans_size_log

        # absolute section cursors per (page, batch), file order var-major
        # within each batch
        max_b = page_n // BATCH
        lens = {
            k: [np.zeros((n_pages, max_b), dtype=np.int64) for _ in range(2)] for k in keys
        }
        for pi, p in enumerate(pages):
            for key in keys:
                a, o = p.sections[key]
                lens[key][0][pi, : len(a)] = a
                lens[key][1][pi, : len(o)] = o
        curs = {k: np.zeros((n_pages, 2 * max_b), dtype=np.int64) for k in keys}
        cur = body_bit0.copy()
        for b in range(max_b):
            for key in keys:
                curs[key][:, 2 * b] = cur
                curs[key][:, 2 * b + 1] = cur + lens[key][0][:, b]
                cur = cur + lens[key][0][:, b] + lens[key][1][:, b]

        var_plans: Dict[str, VarPlan] = {}
        for key, vm in meta.per_latent_var.enumerated():
            state_n = meta.delta_encoding.for_latent_var(key).n_latents_per_state()
            bins = vm.bins
            vp = VarPlan(
                key=key,
                trivial=bins.are_trivial() or len(bins) == 0,
                const_lower=int(bins.lowers[0]) if len(bins) else 0,
                moments=var_states[key],
                bits=vm.latent_type.bits,
            )
            var_plans[key] = vp
            if vp.trivial or n_pages == 0:
                continue
            fuse = _fuse_kind(key, meta, idx.nt)
            vp.launch_key = (page_n, fuse)
            node, lowers = _build_var_tables(vm)
            end_bit = curs[key][:, -1] + lens[key][1][:, -1]
            groups.setdefault(vp.launch_key, []).append({
                "var": vp,
                "node": node,
                "lower": lowers,
                "chain_bit0": curs[key][:, 0],
                "end_bit": end_bit,
                "curs": curs[key],
                "states0": var_init[key],
                "body_n": np.maximum(page_ns - state_n, 0),
                "moment0": (
                    var_states[key][:, 0].astype(np.uint64)
                    if fuse else np.zeros(n_pages, dtype=np.uint64)
                ),
            })
        mode = meta.mode
        table = None
        if mode.kind == Mode.DICT:
            if len(mode.payload) == 0 and n_pages:
                raise CorruptionError(f"chunk {ci}: dict mode with an empty dictionary")
            table = dec.dict_table(idx.nt, mode.payload)
        chunks.append(ChunkPlan(
            n_pages=n_pages, page_ns=page_ns, page_n=page_n, delta=meta.delta_encoding,
            mode_kind=mode.kind,
            mode_scalar=int(mode.payload) if mode.kind in (Mode.INT_MULT, Mode.FLOAT_MULT, Mode.FLOAT_QUANT) else 0,
            var_plans=var_plans, dict_table=table,
        ))

    launches = {lkey: _build_launch(lkey, items) for lkey, items in groups.items()}
    n_words = -(-len(data) // 4)
    for cp in launches.values():  # K1 may read a full staging row past any chain start
        n_words = max(n_words, int(cp.word0.max(initial=0)) + cp.stage_words)
    n_words = -(-n_words // 4) * 4 + 4
    raw = np.zeros(4 * n_words, dtype=np.uint8)
    raw[: len(data)] = np.frombuffer(data, dtype=np.uint8)
    return ContainerPlan(nt=idx.nt, chunks=chunks, launches=launches, words=raw.view(np.uint32))


def _build_launch(lkey: tuple, items: list) -> ChainPlan:
    page_n, fuse = lkey
    ts = max(len(it["node"]) for it in items)
    n_tables = len(items)
    node = np.zeros((n_tables, ts), dtype=np.uint32)
    lower = np.zeros((n_tables, ts), dtype=np.uint64)
    n_rows = [-(-len(it["body_n"]) // CHAINS_PER_BLOCK) * CHAINS_PER_BLOCK for it in items]
    n_chains = sum(n_rows)
    B2 = 2 * (page_n // BATCH)
    cp = ChainPlan(
        page_n=page_n,
        fuse=fuse,
        chain_bit0=np.zeros(n_chains, dtype=np.int64),
        curs=np.zeros((n_chains, B2), dtype=np.int64),
        states0=np.zeros((n_chains, 4), dtype=np.int64),
        body_n=np.zeros(n_chains, dtype=np.int64),
        table_id=np.zeros(n_chains, dtype=np.int64),
        moment0=np.zeros(n_chains, dtype=np.uint64),
        node=node,
        lower=lower,
    )
    extent = 0
    pos = 0
    for tid, (it, rows) in enumerate(zip(items, n_rows)):
        n = len(it["body_n"])
        node[tid, : len(it["node"])] = it["node"]
        lower[tid, : len(it["lower"])] = it["lower"]
        it["var"].chain_start = pos
        sl = slice(pos, pos + n)
        cp.chain_bit0[sl] = it["chain_bit0"]
        cp.curs[sl] = it["curs"]
        cp.states0[sl] = it["states0"]
        cp.body_n[sl] = it["body_n"]
        cp.moment0[sl] = it["moment0"]
        cp.table_id[pos : pos + rows] = tid
        words = -(-it["end_bit"] // 32) - (it["chain_bit0"] >> 5)
        extent = max(extent, int(words.max(initial=0)))
        pos += rows
    cp.stage_words = -(-(extent + SLACK_WORDS) // 4) * 4
    return cp


def chain_plan_from_jax(arrays, bias=None) -> ChainPlan:
    """The port's chain-major plan of one JAX `Launch`.

    `arrays` has the Launch fields `schema` (for `fuse`), `tables`
    (n_tables, 3, 8, ts) int32, `tbl_ids` (n_tiles,), `starts_blk`
    (n_chains,), `curs` (n_tiles, 2B, 8, 128), `states0` and `bodyn`
    (n_tiles, 8, 128) and `moments` (n_tiles, 4, 8, 128) or None, as
    attributes or mapping keys. `bias` is the u64 the
    JAX planner subtracted from each table's lowers (its `lat32` form), one
    per table, default 0. Undoes the (8, 128) dense-quad layout and rebases
    the block-relative cursors to absolute bits. `stage_words` is left at
    its minimum: the JAX plan does not record where sections end."""
    get = (lambda k: arrays[k]) if isinstance(arrays, dict) else (lambda k: getattr(arrays, k))
    tables = np.asarray(get("tables")).astype(np.int64)
    starts_blk = np.asarray(get("starts_blk")).astype(np.int64)
    n_tiles = len(np.asarray(get("tbl_ids")))
    tpc = len(starts_blk) // n_tiles  # chains per JAX tile (256)

    def undense(x):  # (tiles, 8, 128) quad-replicated -> (tiles * 256,)
        return np.asarray(x).astype(np.int64).reshape(n_tiles, 8, 32, 4)[..., 0].transpose(0, 2, 1).reshape(-1)

    curs_d = np.asarray(get("curs"))
    B2 = curs_d.shape[1]
    curs = np.stack([undense(curs_d[:, col]) for col in range(B2)], axis=1)
    curs = curs + (starts_blk << 15)[:, None]
    st = np.asarray(get("states0")).astype(np.int64).reshape(n_tiles, 8, 32, 4)
    states0 = st.transpose(0, 2, 1, 3).reshape(-1, 4)
    moments = get("moments")
    if moments is not None:
        m = np.asarray(moments)
        lo = undense(m[:, 0]).astype(np.uint64) & np.uint64(0xFFFFFFFF)
        hi = undense(m[:, 1]).astype(np.uint64) & np.uint64(0xFFFFFFFF)
        moment0 = lo | (hi << np.uint64(32))
    else:
        moment0 = np.zeros(len(starts_blk), dtype=np.uint64)
    node = (tables[:, 0, 0] & 0xFFFFFFFF).astype(np.uint32)
    lower = ((tables[:, 1, 0] & 0xFFFFFFFF) | ((tables[:, 2, 0] & 0xFFFFFFFF) << 32)).astype(np.uint64)
    if bias is not None:
        lower = lower + np.asarray(bias, dtype=np.uint64)[:, None]
    return ChainPlan(
        page_n=B2 // 2 * BATCH,
        fuse=int(get("schema").fuse),
        chain_bit0=curs[:, 0].copy(),
        curs=curs,
        states0=states0,
        body_n=undense(get("bodyn")),
        table_id=np.repeat(np.asarray(get("tbl_ids")).astype(np.int64), tpc),
        moment0=moment0,
        node=node,
        lower=lower,
    )


# ---------------------------------------------------------------------------
# K1: section gather
# ---------------------------------------------------------------------------


def section_gather_plain(words: torch.Tensor, word0: torch.Tensor, stage_words: int) -> torch.Tensor:
    """Plain version of K1. words (n_words,) int32 container words, word0
    (n_chains,) int64 -> (n_chains, stage_words) int32: row c holds words
    [word0[c], word0[c] + stage_words - SLACK_WORDS) of the container
    (0 past its end) followed by SLACK_WORDS zero words."""
    n_words = words.shape[0]
    w = torch.arange(stage_words, device=words.device, dtype=torch.int64)
    idx = word0[:, None] + w[None, :]
    ok = (w < stage_words - SLACK_WORDS)[None, :] & (idx >= 0) & (idx < n_words)
    return torch.where(ok, words[idx.clamp(0, max(n_words - 1, 0))], torch.zeros((), dtype=words.dtype, device=words.device))


def section_gather(words: torch.Tensor, word0: torch.Tensor, stage_words: int) -> torch.Tensor:
    """K1: chain-major staging buffer of each chain's compressed sections."""
    if words.device.type == "cpu":
        return section_gather_plain(words, word0, stage_words)
    if words.dim() != 1 or word0.dim() != 1 or stage_words < 4 or stage_words % 4 or words.shape[0] % 4:
        raise ValueError("section_gather needs flat words and word0, and stage_words and "
                         "len(words) divisible by 4")
    _check_cuda((words, torch.int32), (word0, torch.int64))
    out = torch.empty((word0.shape[0], stage_words), dtype=torch.int32, device=words.device)
    kernels.launch_section_gather(words, word0, out)
    return out


# ---------------------------------------------------------------------------
# K2: chain decode
# ---------------------------------------------------------------------------


def chain_decode_plain(stg, word0, curs, states0, body_n, table_id, node, lower,
                       moment0, page_n: int, fuse: int) -> torch.Tensor:
    """Plain version of K2, vectorised over chains x 4 streams; the round
    order of the JAX kernel (`_decode_kernel_impl`). stg (n, W) int32,
    word0/body_n/table_id (n,) int64, curs (n, 2B) int64 absolute bits,
    states0 (n, 4) int64, node (n_tables, ts) int32, lower (n_tables, ts)
    int64, moment0 (n,) int64. Returns (n, page_n) int64: u64 latents
    (fuse 0), or memory bits of i64 (fuse 1) / u64 (fuse 2) numbers."""
    dev = stg.device
    n, W = stg.shape
    ts = node.shape[1]
    i64 = torch.int64
    words = stg.to(i64) & 0xFFFFFFFF
    node_f = node.reshape(-1).to(i64) & 0xFFFFFFFF
    lower_f = lower.reshape(-1)
    tbase = table_id[:, None] * ts
    rel = curs - (word0 << 5)[:, None]
    bodyn = body_n[:, None]
    states = states0.clone()
    acc = moment0.clone()[:, None]
    out = torch.empty((n, page_n), dtype=i64, device=dev)
    j4 = torch.arange(4, device=dev, dtype=i64)[None, :]

    def word(w):
        return torch.gather(words, 1, w.clamp(0, W - 1))

    def funnel(w, s):  # 32 bits at bit s of the word pair (w, w + 1)
        return ((word(w) | (word(w + 1) << 32)) >> s) & 0xFFFFFFFF

    def excl(x):
        return torch.cumsum(x, 1) - x

    for b in range(page_n // BATCH):
        anscur = rel[:, 2 * b : 2 * b + 1]
        offcur = rel[:, 2 * b + 1 : 2 * b + 2]
        for r in range(ROUNDS_PER_BATCH):
            k0 = BATCH * b + 4 * r
            valid = (k0 + j4) < bodyn
            sidx = tbase + states.clamp(0, ts - 1)
            nd = node_f[sidx]
            bits = torch.where(valid, nd & 15, 0)
            ob = torch.where(valid, (nd >> 4) & 127, 0)
            low = lower_f[sidx]

            pos = anscur + excl(bits)
            aval = funnel(pos >> 5, pos & 31) & ((1 << bits) - 1)
            states = torch.where(valid, (nd >> 11) + aval, states)
            anscur = anscur + bits.sum(1, keepdim=True)

            pos = offcur + excl(ob)
            w, s = pos >> 5, pos & 31
            off = funnel(w, s) | (funnel(w + 1, s) << 32)
            off = off & torch.where(ob >= 64, -1, (1 << ob.clamp(max=63)) - 1)
            offcur = offcur + ob.sum(1, keepdim=True)

            lat = low + off
            if fuse:
                d = torch.where(valid, lat + _MIN64, 0)
                incl = torch.cumsum(d, 1)
                o = acc + incl - d
                out[:, k0 : k0 + 4] = o ^ _MIN64 if fuse == 1 else o
                acc = acc + incl[:, 3:4]
            else:
                out[:, k0 : k0 + 4] = lat
    return out


def chain_decode(stg, word0, curs, states0, body_n, table_id, node, lower, moment0,
                 page_n: int, fuse: int) -> torch.Tensor:
    """K2: decode every chain of a launch; arguments as chain_decode_plain."""
    if stg.device.type == "cpu":
        return chain_decode_plain(stg, word0, curs, states0, body_n, table_id, node,
                                  lower, moment0, page_n, fuse)
    n = stg.shape[0]
    if n % CHAINS_PER_BLOCK or page_n % BATCH or fuse not in (0, 1, 2):
        raise ValueError("chain_decode needs whole blocks of chains, whole batches and fuse in 0..2")
    if (
        curs.shape != (n, 2 * (page_n // BATCH))
        or states0.shape != (n, 4)
        or any(t.shape != (n,) for t in (word0, body_n, table_id, moment0))
        or node.dim() != 2
        or lower.shape != node.shape
    ):
        raise ValueError("chain_decode: argument shapes do not match the chains and tables")
    _check_cuda((stg, torch.int32), (word0, torch.int64), (curs, torch.int64),
                (states0, torch.int64), (body_n, torch.int64), (table_id, torch.int64),
                (node, torch.int32), (lower, torch.int64), (moment0, torch.int64))
    out = torch.empty((n, page_n), dtype=torch.int64, device=stg.device)
    kernels.launch_chain_decode(stg, word0, curs, states0, body_n, table_id, node,
                                lower, moment0, out, fuse)
    return out


# ---------------------------------------------------------------------------
# post: delta reconstruction, trim, mode join (XLA and K3/K4 in the JAX package)
# ---------------------------------------------------------------------------


def trim_pages(x, cp: ChunkPlan):
    """Flat numbers of a chunk from its (n_pages, page_n) rows: only the last
    page may be ragged, so the numbers are a prefix of the flat rows."""
    if cp.n_pages == 0:
        return x.reshape(-1)[:0]
    n_valid = (cp.n_pages - 1) * x.shape[1] + int(cp.page_ns[-1])
    return x.reshape(-1)[:n_valid]


def result_checksum_u64(res) -> int:
    """Sum of the decoded memory bits mod 2^64."""
    return int(res.sum()) & ((1 << 64) - 1)


def reconstruct_var(cp: ChunkPlan, vp: VarPlan, lat, delta_latents, moments):
    """Undo the var's delta encoding on its (n_pages, page_n) latents (the
    JAX `_reconstruct_var`); `moments` is the var's stored state on the
    device and `delta_latents` the chunk's reconstructed `delta` var."""
    de = cp.delta.for_latent_var(vp.key)
    if de.kind == DeltaEncoding.NOOP:
        return lat
    if de.kind == DeltaEncoding.CONSECUTIVE:
        return dec.consecutive_decode_batched(lat, moments, de.order, vp.bits)
    if de.kind == DeltaEncoding.LOOKBACK:
        return dec.lookback_recon(lat, delta_latents, moments, de.window_n, de.state_n, vp.bits)
    return dec.conv1_decode_pages(lat, moments, de.weights, de.quantization, de.bias, de.order, vp.bits)


def post_chunks(plan: ContainerPlan, outs: Dict[tuple, torch.Tensor], dev: "DeviceArrays") -> List[torch.Tensor]:
    """Per chunk: flat memory bits (int64) of its numbers (the JAX
    `_post_chunks`). A fused launch's rows are final memory bits already."""
    results = []
    for cp, arrays in zip(plan.chunks, dev.chunks):
        var_latents = {}
        for key in ("delta", "primary", "secondary"):
            vp = cp.var_plans.get(key)
            if vp is None:
                continue
            if vp.trivial:
                lat = torch.full((cp.n_pages, cp.page_n), _i64(vp.const_lower), dtype=torch.int64,
                                 device=dev.words.device)
            else:
                lat = outs[vp.launch_key][vp.chain_start : vp.chain_start + cp.n_pages]
                if plan.launches[vp.launch_key].fuse:
                    var_latents[key] = lat
                    continue
            var_latents[key] = reconstruct_var(cp, vp, lat, var_latents.get("delta"), arrays["moments_" + key])
        primary = trim_pages(var_latents["primary"], cp)
        lkey = cp.var_plans["primary"].launch_key
        if lkey is not None and plan.launches[lkey].fuse:
            results.append(primary)
        elif cp.mode_kind == Mode.DICT:
            results.append(dec.dict_join(primary, arrays["dict"]))
        else:
            secondary = var_latents.get("secondary")
            secondary = trim_pages(secondary, cp) if secondary is not None else None
            results.append(dec.join_mem(plan.nt, cp.mode_kind, cp.mode_scalar, primary, secondary))
    return results


def _concat(pieces: List[torch.Tensor], device) -> torch.Tensor:
    """Concatenate chunk results; a view when they already lie end to end in
    one launch output, as they do for fused full-page chunks."""
    if not pieces:
        return torch.zeros(0, dtype=torch.int64, device=device)
    total = sum(p.numel() for p in pieces)
    adjacent = all(
        p.untyped_storage().data_ptr() == pieces[0].untyped_storage().data_ptr()
        and q.data_ptr() == p.data_ptr() + 8 * p.numel()
        for p, q in zip(pieces, pieces[1:])
    )
    if adjacent:
        return torch.as_strided(pieces[0], (total,), (1,))
    return torch.cat(pieces)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to decode with the "
            "kernels' plain PyTorch versions"
        )
    return device


@dataclass
class DeviceArrays:
    words: torch.Tensor
    launches: Dict[tuple, Dict[str, torch.Tensor]] = field(default_factory=dict)
    # per chunk: "moments_<var>" (n_pages, state_n) and, for Dict, "dict"
    chunks: List[Dict[str, torch.Tensor]] = field(default_factory=list)


def upload_plan(plan: ContainerPlan, device="cuda") -> DeviceArrays:
    """Copy the container words and each launch's plan arrays to `device`."""
    device = _resolve_device(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    dev = DeviceArrays(words=t(plan.words.view(np.int32)))
    for lkey, cp in plan.launches.items():
        dev.launches[lkey] = {
            "word0": t(cp.word0),
            "curs": t(cp.curs),
            "states0": t(cp.states0),
            "body_n": t(cp.body_n),
            "table_id": t(cp.table_id),
            "node": t(cp.node.view(np.int32)),
            "lower": t(cp.lower.view(np.int64)),
            "moment0": t(cp.moment0.view(np.int64)),
        }
    for ch in plan.chunks:
        arrays = {"moments_" + key: _u64_to_tensor(vp.moments, device) for key, vp in ch.var_plans.items()}
        if ch.dict_table is not None:
            arrays["dict"] = t(ch.dict_table)
        dev.chunks.append(arrays)
    return dev


def run_launch(cp: ChainPlan, words: torch.Tensor, a: Dict[str, torch.Tensor]) -> torch.Tensor:
    """K1 then K2 for one launch."""
    stg = section_gather(words, a["word0"], cp.stage_words)
    return chain_decode(stg, a["word0"], a["curs"], a["states0"], a["body_n"], a["table_id"],
                        a["node"], a["lower"], a["moment0"], cp.page_n, cp.fuse)


def decode_plan(plan: ContainerPlan, dev: DeviceArrays) -> torch.Tensor:
    """Device part of the decode: (n,) int64 memory bits of every number."""
    outs = {lkey: run_launch(cp, dev.words, dev.launches[lkey])
            for lkey, cp in plan.launches.items()}
    return _concat(post_chunks(plan, outs, dev), dev.words.device)


def decode_container_tensor(data: bytes, device="cuda", plan: Optional[ContainerPlan] = None) -> torch.Tensor:
    """Decode a PCT container; returns the numbers' memory bits as an (n,)
    int64 tensor on `device`."""
    device = _resolve_device(device)
    plan = plan or plan_container(data)
    return decode_plan(plan, upload_plan(plan, device))


def to_numbers(bits: torch.Tensor, nt: NumberType) -> np.ndarray:
    """Memory bits (int64 tensor) -> numpy array of the number type."""
    u64 = bits.cpu().numpy().view(np.uint64)
    return u64.astype(nt.latent.np_dtype).view(nt.np_dtype)


def decode_container_device(data: bytes, device="cuda") -> np.ndarray:
    """Decode a PCT container on `device` (the GPU unless the caller asks for
    the CPU); returns the numbers as a numpy array of the container's type."""
    device = _resolve_device(device)
    plan = plan_container(data)
    return to_numbers(decode_container_tensor(data, device, plan), plan.nt)
