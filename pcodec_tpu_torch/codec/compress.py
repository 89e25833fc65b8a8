"""Compression pipeline: mode choice → delta choice → bin training → dissection.

Host reference path mirroring ref: pco/src/wrapped/chunk_compressor.rs and
chunk_latent_compressor.rs. Vectorized numpy everywhere except the inherently
serial reverse ANS chain (python here, C++/device elsewhere).
"""

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from pcodec_tpu_torch import constants as c
from pcodec_tpu_torch import modes as modes_mod
from pcodec_tpu_torch.binning import sampling
from pcodec_tpu_torch.binning.bin_optimization import BinCompressionInfo, optimize_bins
from pcodec_tpu_torch.binning.histogram import histogram
from pcodec_tpu_torch.codec import guarantee
from pcodec_tpu_torch.codec.chunk_config import ChunkConfig, DeltaSpec, ModeSpec, PagingSpec
from pcodec_tpu_torch.delta import consecutive_encode, consecutive_encode_pages
from pcodec_tpu_torch.delta.encode import (
    choose_lookbacks,
    conv1_choose_config,
    conv1_encode,
    lookback_encode,
    new_lookback,
)
from pcodec_tpu_torch.dtypes import LatentType, NumberType, U32
from pcodec_tpu_torch.errors import InvalidArgumentError
from pcodec_tpu_torch.format import ans
from pcodec_tpu_torch.format.bitio import BitWriter
from pcodec_tpu_torch.format.metadata import (
    Bins,
    ChunkLatentVarMeta,
    ChunkMeta,
    DeltaEncoding,
    Mode,
    PageLatentVarMeta,
    PageMeta,
    PerLatentVar,
)
from pcodec_tpu_torch.modes import dict_mode, float_mult, float_quant, int_mult
from pcodec_tpu_torch.utils import calc_max_bytes, concat

PAGE_SIZE_OVERESTIMATION = 1.2
N_PER_EXTRA_DELTA_GROUP = 10000
DELTA_GROUP_SIZE = 200
LOOKBACK_REQUIRED_BYTE_SAVINGS_PER_N = 0.25

try:
    from pcodec_tpu_torch.native import kernels as _native
except Exception:  # pragma: no cover
    _native = None


# ---------------------------------------------------------------------------
# bin training
# ---------------------------------------------------------------------------


@dataclass
class TrainedBins:
    infos: list  # BinCompressionInfo with quantized weights
    ans_size_log: int
    counts: list  # pre-quantization counts


def choose_unoptimized_bins_log(compression_level: int, n: int) -> int:
    """ref: chunk_compressor.rs:397-406."""
    log_n = int(np.floor(np.log2(n))) if n > 0 else 0
    fast = max(log_n - 4, 0)
    if compression_level <= fast:
        return compression_level
    return fast + (compression_level - fast) // 2


def train_infos(latents: np.ndarray, unoptimized_bins_log: int, latent_type: LatentType,
                ans_cap: Optional[int] = None, sort=None) -> TrainedBins:
    """histogram → optimal merge DP → ANS weight quantization.

    ref: chunk_compressor.rs:54-101. ans_cap (TPU profile, see
    ChunkConfig.ans_size_log_cap) bounds the estimate; quantize_weights
    still raises size_log to fit the bin count when needed. sort: see
    histogram().
    """
    if len(latents) == 0:
        return TrainedBins([], 0, [])
    n_latents = len(latents)
    # train_infos always receives a freshly concatenated buffer it owns
    unopt = histogram(latents, unoptimized_bins_log, sort_in_place=True, sort=sort)
    n_log_ceil = 0 if n_latents <= 1 else (n_latents - 1).bit_length()
    estimated_ans_size_log = min(unoptimized_bins_log + 2, c.MAX_COMPRESSION_LEVEL, n_log_ceil)
    if ans_cap is not None:
        estimated_ans_size_log = min(estimated_ans_size_log, ans_cap)

    infos = optimize_bins(unopt, estimated_ans_size_log, latent_type)
    counts = [i.weight for i in infos]
    ans_size_log, weights = ans.quantize_weights(counts, n_latents, estimated_ans_size_log)
    for info, w in zip(infos, weights):
        info.weight = w
    return TrainedBins(infos, ans_size_log, counts)


def bins_from_infos(infos, latent_type: LatentType) -> Bins:
    return Bins(
        latent_type,
        np.array([i.weight for i in infos], dtype=np.uint32),
        np.array([i.lower for i in infos], dtype=np.uint64).astype(latent_type.np_dtype),
        np.array([i.offset_bits for i in infos], dtype=np.uint32),
    )


# ---------------------------------------------------------------------------
# per-latent-var compressor
# ---------------------------------------------------------------------------


class LatentVarCompressor:
    """Trained state for one latent var (ref: chunk_latent_compressor.rs)."""

    def __init__(self, trained: TrainedBins, bins: Bins, latents: np.ndarray):
        self.latent_type = bins.latent_type
        self.bins = bins
        self.ans_size_log = trained.ans_size_log
        self.needs_ans = len(bins) != 1
        self.is_trivial = bins.are_trivial()
        self.max_offset_bits = bins.max_offset_bits()
        self.avg_bits_per_latent = bins.avg_bits_per_latent(trained.ans_size_log) if len(bins) else 0.0
        self.latents = latents

        spec = ans.Spec.from_weights(trained.ans_size_log, bins.weights.tolist())
        self.encoder = ans.Encoder(spec)
        # sorted by lower already (histogram ascending); search arrays:
        self.sorted_lowers = bins.lowers
        self.sorted_offset_bits = bins.offset_bits.astype(np.int64)

    def dissect_page(self, start: int, end: int):
        """Returns dict(ans_vals, ans_bits, offsets, offset_bits, final_states).

        Bin search and offsets are vectorized over the whole page; the
        LIFO 4-stream ANS chain runs in reverse (ref:
        chunk_latent_compressor.rs:96-132, 246-270).
        """
        default_state = self.encoder.default_state()
        final_states = [default_state] * c.ANS_INTERLEAVING
        if self.is_trivial:
            return {
                "ans_vals": np.zeros(0, dtype=np.uint64),
                "ans_bits": np.zeros(0, dtype=np.int64),
                "offsets": np.zeros(0, dtype=np.uint64),
                "offset_bits": np.zeros(0, dtype=np.int64),
                "final_states": final_states,
                "n": 0,
            }
        lat = self.latents[start:end]
        n = len(lat)
        idxs = np.searchsorted(self.sorted_lowers, lat, side="right") - 1
        np.clip(idxs, 0, len(self.bins) - 1, out=idxs)
        offsets = (lat - self.sorted_lowers[idxs]).astype(np.uint64)
        offset_bits = self.sorted_offset_bits[idxs]

        ans_vals = np.zeros(n, dtype=np.uint64)
        ans_bits = np.zeros(n, dtype=np.int64)
        if self.needs_ans and self.encoder.size_log > 0:
            if _native is not None:
                final_states = _native.ans_encode_reverse(
                    idxs, ans_vals, ans_bits, self.encoder
                )
            else:
                final_states = self._ans_encode_reverse(idxs, ans_vals, ans_bits)
        return {
            "ans_vals": ans_vals,
            "ans_bits": ans_bits,
            "offsets": offsets,
            "offset_bits": offset_bits,
            "final_states": final_states,
            "n": n,
        }

    def _ans_encode_reverse(self, symbols: np.ndarray, ans_vals, ans_bits):
        enc = self.encoder
        min_renorm = enc.min_renorm_bits
        cutoff = enc.renorm_bit_cutoff
        nexts = enc.next_states
        weights = enc.weights
        states = [enc.default_state()] * c.ANS_INTERLEAVING
        vals_out = [0] * len(symbols)
        bits_out = [0] * len(symbols)
        syms = symbols.tolist()
        for i in range(len(syms) - 1, -1, -1):
            j = i & 3
            s = syms[i]
            st = states[j]
            renorm = min_renorm[s] + (1 if st >= cutoff[s] else 0)
            vals_out[i] = st & ((1 << renorm) - 1)
            bits_out[i] = renorm
            states[j] = nexts[s][(st >> renorm) - weights[s]]
        ans_vals[:] = np.array(vals_out, dtype=np.uint64)
        ans_bits[:] = np.array(bits_out, dtype=np.int64)
        return states


# ---------------------------------------------------------------------------
# page info / delta application
# ---------------------------------------------------------------------------


@dataclass
class PageInfoVar:
    delta_state: np.ndarray
    start: int
    end: int


@dataclass
class PageInfo:
    page_n: int
    per_latent_var: PerLatentVar  # of PageInfoVar


def delta_encode_and_build_page_infos(
    delta_encoding: DeltaEncoding,
    n_per_page: List[int],
    primary: np.ndarray,
    secondary: Optional[np.ndarray],
):
    """ref: chunk_compressor.rs:144-219. Returns (latents per var, page infos)."""
    latents = PerLatentVar(None, primary.copy(), None if secondary is None else secondary.copy())

    # fast path: consecutive delta over uniform pages vectorizes across the
    # page axis (the per-page python loop dominates host training otherwise)
    if (
        delta_encoding.kind == DeltaEncoding.CONSECUTIVE
        and len(n_per_page) > 1
        and delta_encoding.order < min(n_per_page)
    ):
        order = delta_encoding.order
        uniform = n_per_page[0]
        n_uniform = 0
        while n_uniform < len(n_per_page) and n_per_page[n_uniform] == uniform:
            n_uniform += 1
        page_infos = []
        for key in ("primary", "secondary"):
            var_latents = latents.get(key)
            if var_latents is None:
                continue
            enc = delta_encoding.for_latent_var(key)
            if enc.kind != DeltaEncoding.CONSECUTIVE:
                # secondary without the delta flag stays NOOP
                continue
            body = var_latents[: n_uniform * uniform].reshape(n_uniform, uniform)
            deltas, moments = consecutive_encode_pages(order, body)
            var_latents[: n_uniform * uniform] = deltas.reshape(-1)
            if key == "primary":
                prim_moments = moments
            else:
                sec_moments = moments
        for pi in range(n_uniform):
            start, end = pi * uniform, (pi + 1) * uniform
            per_var = PerLatentVar()
            for key in ("primary", "secondary"):
                if latents.get(key) is None:
                    continue
                enc = delta_encoding.for_latent_var(key)
                if enc.kind == DeltaEncoding.CONSECUTIVE:
                    state = (prim_moments if key == "primary" else sec_moments)[pi]
                    stored_start = min(start + enc.n_latents_per_state(), end)
                else:
                    state = np.zeros(0, dtype=latents.get(key).dtype)
                    stored_start = start
                per_var.set(key, PageInfoVar(state, stored_start, end))
            page_infos.append(PageInfo(uniform, per_var))
        # remaining (ragged) pages via the scalar path
        tail_infos = _delta_encode_pages_scalar(
            delta_encoding, n_per_page[n_uniform:], latents, n_uniform * uniform
        )
        page_infos.extend(tail_infos)
        return latents, page_infos

    page_infos = _delta_encode_pages_scalar(delta_encoding, n_per_page, latents, 0)
    return latents, page_infos


def _delta_encode_pages_scalar(delta_encoding, n_per_page, latents, start):
    page_infos = []
    delta_latents_parts = []
    for page_n in n_per_page:
        end = start + page_n

        page_delta_latents = None
        if delta_encoding.kind == DeltaEncoding.LOOKBACK:
            page_delta_latents = choose_lookbacks(delta_encoding, latents.primary[start:end])

        per_var = PerLatentVar()
        for key in ("primary", "secondary"):
            var_latents = latents.get(key)
            if var_latents is None:
                continue
            enc = delta_encoding.for_latent_var(key)
            if enc.kind == DeltaEncoding.NOOP:
                state = np.zeros(0, dtype=var_latents.dtype)
            elif enc.kind == DeltaEncoding.CONSECUTIVE:
                var_latents[start:end], state = consecutive_encode(
                    enc.order, var_latents[start:end]
                )
            elif enc.kind == DeltaEncoding.LOOKBACK:
                var_latents[start:end], state = lookback_encode(
                    enc, page_delta_latents, var_latents[start:end]
                )
            else:  # conv1
                var_latents[start:end], state = conv1_encode(enc, var_latents[start:end])
            stored_start = min(start + enc.n_latents_per_state(), end)
            per_var.set(key, PageInfoVar(state, stored_start, end))

        if page_delta_latents is not None:
            pos = sum(len(p) for p in delta_latents_parts)
            per_var.delta = PageInfoVar(
                np.zeros(0, dtype=np.uint32), pos, pos + len(page_delta_latents)
            )
            delta_latents_parts.append(page_delta_latents)

        page_infos.append(PageInfo(page_n, per_var))
        start = end

    if delta_encoding.kind == DeltaEncoding.LOOKBACK:
        latents.delta = (
            concat(delta_latents_parts)
            if delta_latents_parts
            else np.zeros(0, dtype=np.uint32)
        )
    return page_infos


# ---------------------------------------------------------------------------
# chunk compressor
# ---------------------------------------------------------------------------


class ChunkCompressor:
    def __init__(self, meta: ChunkMeta, lvcs: PerLatentVar, page_infos: List[PageInfo]):
        self.meta = meta
        self.lvcs = lvcs
        self.page_infos = page_infos

    def n_per_page(self) -> List[int]:
        per = getattr(self.page_infos, "per_page", None)  # lazy device infos
        return list(per) if per is not None else [p.page_n for p in self.page_infos]

    def meta_size_hint(self) -> int:
        return self.meta.max_size()

    def page_size_hint(self, page_idx: int) -> int:
        return self._page_size_hint_inner(page_idx, PAGE_SIZE_OVERESTIMATION)

    def _page_size_hint_inner(self, page_idx: int, overestimation: float) -> int:
        page_info = self.page_infos[page_idx]
        body_bits = 0
        for key, lvc in self.lvcs.enumerated():
            piv = page_info.per_latent_var.get(key)
            n_stored = piv.end - piv.start
            body_bits += int(np.ceil(n_stored * lvc.avg_bits_per_latent * overestimation))
        return self.meta.exact_page_meta_size() + (body_bits + 7) // 8

    def write_meta(self, writer: BitWriter) -> None:
        self.meta.write_to(writer)

    def write_page(self, page_idx: int, writer: BitWriter, sections_out=None) -> None:
        """Writes one page. If `sections_out` is a list, appends one
        (ans_bits_per_batch, off_bits_per_batch) int array pair per latent
        var (file order) — the device-decode directory payload
        (see codec/container.py)."""
        if page_idx >= len(self.page_infos):
            raise InvalidArgumentError(
                f"page idx exceeds num pages ({page_idx} >= {len(self.page_infos)})"
            )
        page_info = self.page_infos[page_idx]

        dissected = {}
        ans_size_logs = PerLatentVar()
        page_var_metas = PerLatentVar()
        for key, lvc in self.lvcs.enumerated():
            piv = page_info.per_latent_var.get(key)
            d = lvc.dissect_page(piv.start, piv.end)
            dissected[key] = d
            ans_size_logs.set(key, lvc.encoder.size_log)
            default_state = lvc.encoder.default_state()
            page_var_metas.set(
                key,
                PageLatentVarMeta(
                    piv.delta_state,
                    tuple(s - default_state for s in d["final_states"]),
                ),
            )

        PageMeta(page_var_metas).write_to(ans_size_logs, writer)

        page_n = page_info.page_n
        n_batches = -(-page_n // c.FULL_BATCH_N)
        if sections_out is not None:
            section_arrays = {
                key: (
                    np.zeros(n_batches, dtype=np.int64),
                    np.zeros(n_batches, dtype=np.int64),
                )
                for key, _ in self.lvcs.enumerated()
            }
        batch_start = 0
        batch_idx = 0
        while batch_start < page_n:
            batch_end = min(batch_start + c.FULL_BATCH_N, page_n)
            for key, lvc in self.lvcs.enumerated():
                d = dissected[key]
                if batch_start >= d["n"]:
                    continue
                sl = slice(batch_start, batch_start + c.FULL_BATCH_N)
                if lvc.needs_ans:
                    ans_bits = d["ans_bits"][sl]
                    writer.write_batch(d["ans_vals"][sl], ans_bits)
                    if sections_out is not None:
                        section_arrays[key][0][batch_idx] = int(ans_bits.sum())
                if lvc.max_offset_bits > 0:
                    off_bits = d["offset_bits"][sl]
                    writer.write_batch(d["offsets"][sl], off_bits)
                    if sections_out is not None:
                        section_arrays[key][1][batch_idx] = int(off_bits.sum())
            batch_start = batch_end
            batch_idx += 1
        writer.finish_byte()
        if sections_out is not None:
            for key, _ in self.lvcs.enumerated():
                sections_out.append(section_arrays[key])

    def should_fallback(
        self, latent_type: LatentType, n: int, bin_counts: PerLatentVar
    ) -> bool:
        """ref: chunk_compressor.rs:536-575."""
        meta = self.meta
        if meta.delta_encoding.kind == DeltaEncoding.NOOP and meta.mode.kind == Mode.CLASSIC:
            return False
        n_pages = len(self.page_infos)
        worst_case_body_bits = 7 * n_pages
        for key, var_meta in meta.per_latent_var.enumerated():
            counts = bin_counts.get(key)
            wc = var_meta.bins.worst_case_bits_per_latent(var_meta.ans_size_log)
            for bits, count in zip(wc.tolist(), counts):
                worst_case_body_bits += count * bits
        worst_case_size = (
            meta.max_size()
            + n_pages * meta.exact_page_meta_size()
            + (worst_case_body_bits + 7) // 8
        )
        return worst_case_size > guarantee.wrapped_chunk_size(latent_type, n)


def new_candidate(
    primary: np.ndarray,
    secondary: Optional[np.ndarray],
    n_per_page: List[int],
    mode: Mode,
    delta_encoding: DeltaEncoding,
    unoptimized_bins_log: int,
    number_latent_type: LatentType,
    ans_cap: Optional[int] = None,
    sort=None,
):
    """ref: chunk_compressor.rs:221-289. ans_cap applies at this final
    training only (sample-cost estimation passes None, so mode/delta
    decisions are cap-independent); so does sort (see histogram())."""
    latents, page_infos = delta_encode_and_build_page_infos(
        delta_encoding, n_per_page, primary, secondary
    )

    var_metas = PerLatentVar()
    lvcs = PerLatentVar()
    bin_counts = PerLatentVar()
    for key in ("delta", "primary", "secondary"):
        var_latents = latents.get(key)
        if var_latents is None:
            continue
        ubl = unoptimized_bins_log
        if key == "secondary":
            ubl = min(ubl, c.LIMITED_UNOPTIMIZED_BINS_LOG)
        lt = U32 if key == "delta" else (
            mode.primary_latent_type(number_latent_type) if key == "primary"
            else mode.secondary_latent_type(number_latent_type)
        )
        # collect contiguous latents across pages (junk-front excluded)
        parts = [
            var_latents[p.per_latent_var.get(key).start : p.per_latent_var.get(key).end]
            for p in page_infos
        ]
        contiguous = concat(parts) if parts else var_latents[:0]
        trained = train_infos(contiguous, ubl, lt, ans_cap, sort)
        bins = bins_from_infos(trained.infos, lt)
        lvcs.set(key, LatentVarCompressor(trained, bins, var_latents))
        var_metas.set(key, ChunkLatentVarMeta(trained.ans_size_log, bins))
        bin_counts.set(key, trained.counts)

    meta = ChunkMeta(mode, delta_encoding, var_metas, number_latent_type)
    return ChunkCompressor(meta, lvcs, page_infos), bin_counts


# ---------------------------------------------------------------------------
# delta encoding choice
# ---------------------------------------------------------------------------


def delta_sample_slices(n: int, group_size: int, n_extra_groups: int):
    """(start, stop) pairs of the delta-sample groups, clamped to n."""
    nominal = (n_extra_groups + 1) * group_size
    padding = 0 if n_extra_groups == 0 else max(n - nominal, 0) // n_extra_groups
    slices = [(0, min(group_size, n))]
    i = group_size
    for _ in range(n_extra_groups):
        i += padding
        slices.append((min(i, n), min(i + group_size, n)))
        i += group_size
    return slices


def choose_delta_sample(primary: np.ndarray, group_size: int, n_extra_groups: int) -> np.ndarray:
    """ref: chunk_compressor.rs:291-319."""
    parts = [
        primary[a:b] for a, b in delta_sample_slices(len(primary), group_size, n_extra_groups)
    ]
    return concat(parts)


def _compressed_sample_size(sample: np.ndarray, ubl: int, delta_encoding: DeltaEncoding, lt: LatentType) -> float:
    cc, _ = new_candidate(
        sample.copy(), None, [len(sample)], Mode(Mode.CLASSIC), delta_encoding, ubl, lt
    )
    return float(cc.meta_size_hint() + cc._page_size_hint_inner(0, 1.0))


def train_from_histogram(unopt, n_latents, unoptimized_bins_log, latent_type,
                         ans_cap: Optional[int] = None):
    """train_infos with the histogram precomputed (device-train feeds
    device-walked bins; decision math identical to train_infos)."""
    if n_latents == 0:
        return TrainedBins([], 0, [])
    n_log_ceil = 0 if n_latents <= 1 else (n_latents - 1).bit_length()
    estimated = min(unoptimized_bins_log + 2, c.MAX_COMPRESSION_LEVEL, n_log_ceil)
    if ans_cap is not None:
        estimated = min(estimated, ans_cap)
    infos = optimize_bins(unopt, estimated, latent_type)
    counts = [i.weight for i in infos]
    ans_size_log, weights = ans.quantize_weights(counts, n_latents, estimated)
    for info, w in zip(infos, weights):
        info.weight = w
    return TrainedBins(infos, ans_size_log, counts)


def sample_cost_from_unopt(delta_encoding: DeltaEncoding, per_var: dict,
                           ubl: int, number_lt: LatentType) -> float:
    """_compressed_sample_size computed from precomputed unoptimized
    histograms instead of the sample itself. per_var maps latent-var key ->
    ((counts, lowers, uppers) u64 arrays OR list[HistogramBin], n_stored);
    classic mode, single page. Fully array-based: identical math to the
    TrainedBins path without per-bin Python objects (this runs per delta
    candidate per chunk in the encode hot path)."""
    from pcodec_tpu_torch.binning.bin_optimization import (
        _bits_to_encode_offset_vec,
        _choose_optimized_partitioning,
    )
    from pcodec_tpu_torch.format.metadata import MAX_DELTA_ENCODING_BIT_SIZE

    meta_bits = c.BITS_TO_ENCODE_MODE_VARIANT + MAX_DELTA_ENCODING_BIT_SIZE
    page_meta_bits = 0
    body_bits = 0
    for key in ("delta", "primary"):
        if key not in per_var:
            continue
        unopt, n_stored = per_var[key]
        var_lt = U32 if key == "delta" else number_lt
        if isinstance(unopt, tuple):
            counts, lowers, uppers = (np.asarray(a, dtype=np.uint64) for a in unopt)
        else:
            counts = np.array([b.count for b in unopt], dtype=np.uint64)
            lowers = np.array([b.lower for b in unopt], dtype=np.uint64)
            uppers = np.array([b.upper for b in unopt], dtype=np.uint64)
        if n_stored == 0 or len(counts) == 0:
            n_bins, asl, avg = 0, 0, 0.0
        else:
            n_log_ceil = 0 if n_stored <= 1 else (n_stored - 1).bit_length()
            estimated = min(ubl + 2, c.MAX_COMPRESSION_LEVEL, n_log_ceil)
            part = _choose_optimized_partitioning(counts, lowers, uppers, estimated, var_lt)
            js = np.fromiter((p[0] for p in part), dtype=np.int64, count=len(part))
            is_ = np.fromiter((p[1] for p in part), dtype=np.int64, count=len(part))
            c_counts = np.concatenate([[0], np.cumsum(counts)]).astype(np.uint64)
            w = (c_counts[is_ + 1] - c_counts[js]).astype(np.int64)
            ob = _bits_to_encode_offset_vec(uppers[is_] - lowers[js])
            asl, weights = ans.quantize_weights(w.tolist(), n_stored, estimated)
            warr = np.asarray(weights, dtype=np.float64)
            # Bins.avg_bits_per_latent, same numpy ops/order
            ans_bits = asl - np.log2(warr)
            avg = float(np.sum(
                (ans_bits + ob.astype(np.uint32)) * warr / float(1 << asl)
            ))
            n_bins = len(part)
        meta_bits += (
            c.BITS_TO_ENCODE_ANS_SIZE_LOG
            + c.BITS_TO_ENCODE_N_BINS
            + n_bins * (asl + var_lt.bits + var_lt.offset_bits_bits)
        )
        de_v = delta_encoding.for_latent_var(key)
        page_meta_bits += asl * c.ANS_INTERLEAVING + var_lt.bits * de_v.n_latents_per_state()
        body_bits += int(np.ceil(n_stored * avg * 1.0))
    return float(
        (meta_bits + 7) // 8 + (page_meta_bits + 7) // 8 + (body_bits + 7) // 8
    )


def choose_auto_delta_from_cand_bins(cand_bins, sample_n: int, n: int, ubl: int,
                                     lt: LatentType) -> DeltaEncoding:
    """The auto delta decision (chunk_compressor.rs:341-395) from device-
    reduced candidate histograms. cand_bins[k] = (bins, n_stored): index 0 =
    noop, 1..MAX_CONSECUTIVE_DELTA_ORDER = consecutive orders, then lookback
    primary deltas and lookback values."""
    best = DeltaEncoding.noop()
    best_cost = sample_cost_from_unopt(best, {"primary": cand_bins[0]}, ubl, lt)

    lookback_penalty = LOOKBACK_REQUIRED_BYTE_SAVINGS_PER_N * sample_n
    if best_cost > lookback_penalty:
        lb_enc = new_lookback(sample_n)
        mo = c.MAX_CONSECUTIVE_DELTA_ORDER
        lb_cost = sample_cost_from_unopt(
            lb_enc, {"delta": cand_bins[mo + 2], "primary": cand_bins[mo + 1]},
            ubl, lt,
        ) + lookback_penalty
        if lb_cost < best_cost:
            best = new_lookback(n)
            best_cost = lb_cost

    for order in range(1, c.MAX_CONSECUTIVE_DELTA_ORDER + 1):
        enc = DeltaEncoding.consecutive(order)
        cost = sample_cost_from_unopt(enc, {"primary": cand_bins[order]}, ubl, lt)
        if cost < best_cost:
            best = enc
            best_cost = cost
        else:
            break  # it's almost always convex
    return best


def lookback_cost_from_sample(sample: np.ndarray, ubl: int,
                              enc: DeltaEncoding, lt: LatentType) -> float:
    """_compressed_sample_size(sample, ubl, lookback enc, lt) without the
    candidate-object construction: native chooser + encode, array-based
    histograms, and the array cost path (identical float math). This runs
    per chunk in the encode hot path, mostly inside GIL-releasing native
    calls, so a thread pool scales it."""
    from pcodec_tpu_torch.delta.encode import choose_lookbacks, lookback_encode

    n = len(sample)
    lookbacks = choose_lookbacks(enc, sample)
    deltas, _state = lookback_encode(enc, lookbacks, sample.copy())
    n_stored = max(n - enc.state_n, 0)
    try:
        from pcodec_tpu_torch.native.kernels import histogram_sorted
    except Exception:
        histogram_sorted = None
    if histogram_sorted is not None:
        hp = histogram_sorted(np.sort(deltas[enc.state_n :].astype(np.uint64)), ubl)
        hd = histogram_sorted(np.sort(lookbacks.astype(np.uint64)), ubl)
        per_var = {
            "delta": ((hd[0], hd[1], hd[2]), len(lookbacks)),
            "primary": ((hp[0], hp[1], hp[2]), n_stored),
        }
    else:  # pure-python fallback keeps identical results
        from pcodec_tpu_torch.binning.histogram import histogram

        per_var = {
            "delta": (histogram(lookbacks.astype(np.uint64), ubl), len(lookbacks)),
            "primary": (histogram(deltas[enc.state_n :].astype(np.uint64), ubl), n_stored),
        }
    return sample_cost_from_unopt(enc, per_var, ubl, lt)


def extend_orders_chain(costs, cand_bins, ubl: int, lt: LatentType):
    """Extend the no-lookback auto-delta chain with more candidate bins.
    costs holds the evaluated chain so far ([] to start); cand_bins[k] is the
    (bins, n_stored) for order len(costs) + k. Returns (costs, broke): broke
    is True once the chain hit a non-improving order (the reference's break
    point, chunk_compressor.rs:374-391) or ran out of orders."""
    for bins in cand_bins:
        order = len(costs)
        enc = DeltaEncoding.noop() if order == 0 else DeltaEncoding.consecutive(order)
        cost = sample_cost_from_unopt(enc, {"primary": bins}, ubl, lt)
        costs.append(cost)
        if order > 0 and cost >= min(costs[:-1]):
            return costs, True
        if order == c.MAX_CONSECUTIVE_DELTA_ORDER:
            return costs, True
    return costs, len(costs) > c.MAX_CONSECUTIVE_DELTA_ORDER


def orders_chain_from_cand_bins(cand_bins, ubl: int, lt: LatentType):
    """The full no-lookback chain from device bins: [noop_cost, order1_cost,
    ...] up to and including the first non-improving order. The true decision
    with the lookback candidate inserted breaks no later, so these costs are
    sufficient for finalize_delta_choice."""
    costs, _ = extend_orders_chain([], cand_bins, ubl, lt)
    return costs


def finalize_delta_choice(chain_costs, lb_cost_with_penalty, n: int) -> DeltaEncoding:
    """The reference decision sequence (chunk_compressor.rs:341-395) given
    precomputed candidate costs: noop -> (lookback, already penalty-added,
    or None when untriggered/unevaluated) -> consecutive orders."""
    best = DeltaEncoding.noop()
    best_cost = chain_costs[0]
    if lb_cost_with_penalty is not None and lb_cost_with_penalty < best_cost:
        best = new_lookback(n)
        best_cost = lb_cost_with_penalty
    for order in range(1, len(chain_costs)):
        cost = chain_costs[order]
        if cost < best_cost:
            best = DeltaEncoding.consecutive(order)
            best_cost = cost
        else:
            break
    return best


def choose_auto_delta_encoding(primary: np.ndarray, ubl: int, lt: LatentType) -> DeltaEncoding:
    """ref: chunk_compressor.rs:341-395."""
    n = len(primary)
    sample = choose_delta_sample(primary, DELTA_GROUP_SIZE, 1 + n // N_PER_EXTRA_DELTA_GROUP)
    return choose_auto_delta_encoding_from_sample(sample, n, ubl, lt)


def choose_auto_delta_encoding_from_sample(
    sample: np.ndarray, n: int, ubl: int, lt: LatentType
) -> DeltaEncoding:
    """Auto delta choice given the already-assembled delta sample (a pure
    function of the sample and n; device-train fetches only the sample)."""
    sample_n = len(sample)

    best = DeltaEncoding.noop()
    best_cost = _compressed_sample_size(sample, ubl, best, lt)

    lookback_penalty = LOOKBACK_REQUIRED_BYTE_SAVINGS_PER_N * sample_n
    if best_cost > lookback_penalty:
        lb_enc = new_lookback(sample_n)
        lb_cost = _compressed_sample_size(sample, ubl, lb_enc, lt) + lookback_penalty
        if lb_cost < best_cost:
            best = new_lookback(n)
            best_cost = lb_cost

    for order in range(1, c.MAX_CONSECUTIVE_DELTA_ORDER + 1):
        enc = DeltaEncoding.consecutive(order)
        cost = _compressed_sample_size(sample, ubl, enc, lt)
        if cost < best_cost:
            best = enc
            best_cost = cost
        else:
            break  # it's almost always convex
    return best


def choose_delta_encoding(primary: np.ndarray, config: ChunkConfig, ubl: int, lt: LatentType) -> DeltaEncoding:
    ds = config.delta_spec
    if ds.kind == DeltaSpec.AUTO:
        return choose_auto_delta_encoding(primary, ubl, lt)
    if ds.kind == DeltaSpec.NO_OP:
        return DeltaEncoding.noop()
    if ds.kind == DeltaSpec.TRY_CONSECUTIVE:
        if ds.order == 0:
            return DeltaEncoding.noop()
        return DeltaEncoding.consecutive(ds.order)
    if ds.kind == DeltaSpec.TRY_LOOKBACK:
        return new_lookback(len(primary))
    if ds.kind == DeltaSpec.TRY_CONV1:
        if ds.order == 0:
            return DeltaEncoding.noop()
        enc = conv1_choose_config(ds.order, primary)
        return enc if enc is not None else DeltaEncoding.noop()
    raise InvalidArgumentError(f"unknown delta spec {ds.kind}")


# ---------------------------------------------------------------------------
# mode choice
# ---------------------------------------------------------------------------


def _is_normal(nt: NumberType, x: np.ndarray) -> np.ndarray:
    bits = np.ascontiguousarray(x, dtype=nt.np_dtype).view(nt.latent.np_dtype)
    exp_mask = ((1 << (nt.latent.bits - nt.precision_bits - 1)) - 1) << nt.precision_bits
    exp = bits & nt.latent.np_dtype.type(exp_mask)
    return (exp != 0) & (exp != nt.latent.np_dtype.type(exp_mask))


def _max_for_sampling(nt: NumberType):
    if nt.name == "f16":
        return np.uint16(30719).view(np.float16)
    return np.finfo(nt.np_dtype).max * nt.np_dtype.type(0.5)


def choose_mode_and_split(nt: NumberType, nums: np.ndarray, config: ChunkConfig):
    """Returns (mode, primary, secondary); ref: data_types/float.rs:83-134,
    unsigned.rs:742-768."""
    ms = config.mode_spec
    L = nt.latent.np_dtype

    if nt.kind == "float":
        if ms.kind == ModeSpec.AUTO:
            best = (0.0, Mode(Mode.CLASSIC), None)  # (bits_saved, mode, splitter)
            ab = np.abs(nums)
            keep = _is_normal(nt, nums) & (ab <= _max_for_sampling(nt))
            sample = sampling.choose_sample(ab.astype(nt.np_dtype), keep)
            if sample is not None:
                fm = float_mult.compute_bid(nt, sample)
                if fm is not None and fm[2] >= best[0]:
                    base, inv_base, est = fm
                    best = (est, Mode(Mode.FLOAT_MULT, int(nt.to_latent_ordered(np.array([base]))[0])),
                            lambda: float_mult.split_latents(nt, nums, base, inv_base))
                fq = float_quant.compute_bid(nt, sample)
                if fq is not None and fq[1] >= best[0]:
                    k, est = fq
                    best = (est, Mode(Mode.FLOAT_QUANT, k),
                            lambda: float_quant.split_latents(nt, nums, k))
            if best[2] is None:
                return Mode(Mode.CLASSIC), nt.to_latent_ordered(nums), None
            p, s = best[2]()
            return best[1], p, s
        if ms.kind == ModeSpec.CLASSIC:
            return Mode(Mode.CLASSIC), nt.to_latent_ordered(nums), None
        if ms.kind == ModeSpec.TRY_FLOAT_MULT:
            base = nt.np_dtype.type(ms.value)
            inv_base = nt.np_dtype.type(1.0) / base
            p, s = float_mult.split_latents(nt, nums, base, inv_base)
            return Mode(Mode.FLOAT_MULT, int(nt.to_latent_ordered(np.array([base]))[0])), p, s
        if ms.kind == ModeSpec.TRY_FLOAT_QUANT:
            k = int(ms.value)
            p, s = float_quant.split_latents(nt, nums, k)
            return Mode(Mode.FLOAT_QUANT, k), p, s
        if ms.kind == ModeSpec.TRY_INT_MULT:
            raise InvalidArgumentError("unable to use int mult mode on floats")
        if ms.kind == ModeSpec.TRY_DICT:
            d, idxs = dict_mode.configure_and_split_latents(nt, nums)
            return Mode(Mode.DICT, d), idxs, None

    else:
        if ms.kind == ModeSpec.AUTO:
            base = int_mult.choose_base(nt, nums)
            if base is not None:
                p, s = int_mult.split_latents(nt, nums, base)
                return Mode(Mode.INT_MULT, base), p, s
            return Mode(Mode.CLASSIC), nt.to_latent_ordered(nums), None
        if ms.kind == ModeSpec.CLASSIC:
            return Mode(Mode.CLASSIC), nt.to_latent_ordered(nums), None
        if ms.kind == ModeSpec.TRY_INT_MULT:
            base = int(ms.value)
            p, s = int_mult.split_latents(nt, nums, base)
            return Mode(Mode.INT_MULT, base), p, s
        if ms.kind in (ModeSpec.TRY_FLOAT_MULT, ModeSpec.TRY_FLOAT_QUANT):
            raise InvalidArgumentError("unable to use float mode for ints")
        if ms.kind == ModeSpec.TRY_DICT:
            d, idxs = dict_mode.configure_and_split_latents(nt, nums)
            return Mode(Mode.DICT, d), idxs, None
    raise InvalidArgumentError(f"unknown mode spec {ms.kind}")


# ---------------------------------------------------------------------------
# top-level chunk compression
# ---------------------------------------------------------------------------


def fallback_chunk_compressor(nt: NumberType, nums: np.ndarray, n_per_page) -> ChunkCompressor:
    """1-bin classic with full-width offsets (ref: chunk_compressor.rs:431-473)."""
    latents = nt.to_latent_ordered(nums)
    lt = nt.latent
    n = len(latents)
    meta = guarantee.baseline_chunk_meta(lt)
    trained = TrainedBins(
        [BinCompressionInfo(1, 0, lt.max, 0, lt.bits)], 0, [n]
    )
    lvc = LatentVarCompressor(trained, meta.per_latent_var.primary.bins, latents)
    page_infos = []
    start = 0
    for page_n in n_per_page:
        page_infos.append(
            PageInfo(
                page_n,
                PerLatentVar(
                    None, PageInfoVar(np.zeros(0, dtype=lt.np_dtype), start, start + page_n), None
                ),
            )
        )
        start += page_n
    return ChunkCompressor(meta, PerLatentVar(None, lvc, None), page_infos)


def chunk_compressor(nt: NumberType, nums: np.ndarray, config: ChunkConfig, sort=None) -> ChunkCompressor:
    """The bulk of compression (ref: chunk_compressor.rs:477-534). sort
    orders the latents of the final training (see histogram())."""
    config.validate(nt.latent)
    n = len(nums)
    if n == 0:
        raise InvalidArgumentError("cannot compress empty chunk")
    if n > c.MAX_ENTRIES:
        raise InvalidArgumentError(f"count may not exceed {c.MAX_ENTRIES} per chunk (was {n})")

    mode, primary, secondary = choose_mode_and_split(nt, nums, config)
    if not modes_mod.mode_is_valid(nt, mode):
        raise InvalidArgumentError(f"the chosen mode {mode.kind} is invalid for {nt.name}")

    ubl = choose_unoptimized_bins_log(config.compression_level, n)
    from pcodec_tpu_torch.dtypes import LATENT_TYPES

    primary_lt = LATENT_TYPES[primary.dtype.itemsize * 8]
    delta_encoding = choose_delta_encoding(primary, config, ubl, primary_lt)

    n_per_page = config.paging_spec.n_per_page(n)
    candidate, bin_counts = new_candidate(
        primary, secondary, n_per_page, mode, delta_encoding, ubl, nt.latent,
        ans_cap=config.ans_size_log_cap, sort=sort,
    )
    if candidate.should_fallback(nt.latent, n, bin_counts):
        return fallback_chunk_compressor(nt, nums, n_per_page)
    return candidate
