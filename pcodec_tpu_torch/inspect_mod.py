"""File inspection: parse a .pco file and report structure + size breakdown.

The observability surface of the codec (ref: pco_cli/src/inspect/handler.rs
and pco/src/describers.rs): per-chunk mode, delta encoding, per-latent-var
ANS/bin statistics, and byte-level size accounting.
"""

import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from pcodec_tpu_torch.codec.decompress import PageDecompressor
from pcodec_tpu_torch.codec.standalone import FileDecompressor
from pcodec_tpu_torch.format.bitio import BitReader
from pcodec_tpu_torch.format.metadata import ChunkMeta, DeltaEncoding, Mode


@dataclass
class LatentDescriber:
    """Interprets one latent var: description, units, and a value formatter
    (ref: pco/src/describers.rs DescribeLatent)."""

    description: str
    units: str
    center: int = 0  # latent-domain center subtracted before display
    is_signed: bool = False
    as_float_nt: object = None  # format latent via nt.from_latent_ordered
    shift_k: int = 0  # FloatQuant primary: latent << k then float-format

    def format(self, latent: int, lt) -> str:
        if self.as_float_nt is not None:
            nt = self.as_float_nt
            v = latent << self.shift_k if self.shift_k else latent
            x = nt.from_latent_ordered(np.array([v], dtype=lt.np_dtype))[0]
            return f"{x}"
        if self.is_signed:
            # centered signed interpretation (ref: describers.rs IntDescriber)
            val = int(latent) - int(self.center)
            return f"{val}{self.units}"
        val = int(latent) - int(self.center)
        return f"{val}{self.units}"


def _centered_delta(desc: str, units: str, lt) -> LatentDescriber:
    return LatentDescriber(desc, units, center=int(lt.mid), is_signed=True)


def get_latent_describers(meta: ChunkMeta, nt) -> dict:
    """Per-latent-var describers matching Number::get_latent_describers
    (ref: describers.rs:62-228). Keys: delta/primary/secondary."""
    mode = meta.mode
    de = meta.delta_encoding
    lt = nt.latent
    delta_noop = de.kind == DeltaEncoding.NOOP
    sec_delta = (
        de.kind in (DeltaEncoding.CONSECUTIVE, DeltaEncoding.LOOKBACK)
        and de.secondary_uses_delta
    )
    out = {}
    if de.kind == DeltaEncoding.LOOKBACK:
        out["delta"] = LatentDescriber("lookback", "", 0, False)

    if mode.kind == Mode.CLASSIC:
        if delta_noop:
            out["primary"] = LatentDescriber("primary", "", as_float_nt=nt if nt.kind == "float" else None,
                                             center=int(lt.mid) if nt.kind == "signed" else 0,
                                             is_signed=nt.kind == "signed")
        else:
            units = " ULPs" if nt.kind == "float" else ""
            out["primary"] = _centered_delta("delta", units, lt)
    elif mode.kind == Mode.INT_MULT:
        base = int(mode.payload)
        dtype_center = int(lt.mid) if nt.kind == "signed" else 0
        if delta_noop:
            out["primary"] = LatentDescriber(
                f"multiplier [x{base}]", "x", dtype_center // base, nt.kind == "signed"
            )
        else:
            out["primary"] = _centered_delta(f"multiplier delta [x{base}]", "x", lt)
        if sec_delta:
            out["secondary"] = _centered_delta("adjustment delta", "", lt)
        else:
            out["secondary"] = LatentDescriber("adjustment", "", dtype_center % base, False)
    elif mode.kind == Mode.DICT:
        if delta_noop:
            out["primary"] = LatentDescriber("index", "", 0, False)
        else:
            out["primary"] = _centered_delta("index delta", "", lt)
    elif mode.kind == Mode.FLOAT_MULT:
        base = nt.from_latent_ordered(np.array([mode.payload], dtype=lt.np_dtype))[0]
        if delta_noop:
            out["primary"] = LatentDescriber(
                f"multiplier [x{base}]", "x", int(lt.mid), True
            )
        else:
            out["primary"] = LatentDescriber(
                f"multiplier delta [x{base}]", "x", int(lt.mid), True
            )
        if sec_delta:
            out["secondary"] = _centered_delta("adjustment delta", "", lt)
        else:
            out["secondary"] = LatentDescriber("adjustment", " ULPs", int(lt.mid), True)
    elif mode.kind == Mode.FLOAT_QUANT:
        k = int(mode.payload)
        if delta_noop:
            out["primary"] = LatentDescriber(
                f"quantized value [<<{k}]", "", as_float_nt=nt, shift_k=k
            )
        else:
            out["primary"] = _centered_delta(f"quantums delta [<<{k}]", "q", lt)
        if sec_delta:
            out["secondary"] = _centered_delta("magnitude adjustment delta", "", lt)
        else:
            out["secondary"] = LatentDescriber("magnitude adjustment", " ULPs", 0, False)
    return out


def describe_latent_var(meta: ChunkMeta, key: str, nt) -> str:
    """Human-readable interpretation of a latent var (ref: describers.rs)."""
    d = get_latent_describers(meta, nt).get(key)
    return d.description if d is not None else key


@dataclass
class LatentVarReport:
    key: str
    description: str
    ans_size_log: int
    n_bins: int
    avg_bits_per_latent: float
    # per-bin dump (weight, formatted lower, offset_bits) — reference
    # inspect's bin listing (ref: pco_cli/src/inspect/handler.rs:24-110)
    bins: List[tuple] = field(default_factory=list)


@dataclass
class ChunkReport:
    idx: int
    dtype: str
    n: int
    mode: str
    delta_encoding: str
    meta_bytes: int
    page_bytes: int
    latent_vars: List[LatentVarReport] = field(default_factory=list)


@dataclass
class FileReport:
    n_chunks: int = 0
    total_n: int = 0
    total_bytes: int = 0
    header_bytes: int = 0
    meta_bytes: int = 0
    page_bytes: int = 0
    footer_bytes: int = 1
    uncompressed_bytes: int = 0
    chunks: List[ChunkReport] = field(default_factory=list)

    @property
    def ratio(self) -> float:
        return self.uncompressed_bytes / self.total_bytes if self.total_bytes else 0.0


def describe_delta(de: DeltaEncoding) -> str:
    if de.kind == DeltaEncoding.NOOP:
        return "none"
    if de.kind == DeltaEncoding.CONSECUTIVE:
        return f"consecutive order {de.order}" + (
            " (secondary too)" if de.secondary_uses_delta else ""
        )
    if de.kind == DeltaEncoding.LOOKBACK:
        return f"lookback window 2^{de.window_n_log}, state 2^{de.state_n_log}"
    return f"conv1 order {len(de.weights)} quantization {de.quantization}"


def _fill_latent_vars(cr, meta, nt):
    describers = get_latent_describers(meta, nt)
    for key, vm in meta.per_latent_var.enumerated():
        d = describers.get(key)
        lt = vm.latent_type
        bins = []
        for bi in range(len(vm.bins)):
            lower = int(vm.bins.lowers[bi])
            bins.append((
                int(vm.bins.weights[bi]),
                d.format(lower, lt) if d is not None else str(lower),
                int(vm.bins.offset_bits[bi]),
            ))
        cr.latent_vars.append(
            LatentVarReport(
                key=key,
                description=describe_latent_var(meta, key, nt),
                ans_size_log=vm.ans_size_log,
                n_bins=len(vm.bins),
                avg_bits_per_latent=vm.bins.avg_bits_per_latent(vm.ans_size_log)
                if len(vm.bins)
                else 0.0,
                bins=bins,
            )
        )


def inspect_container(data: bytes) -> FileReport:
    """Inspect a PCT container: directory accounting + per-chunk reports
    built from the embedded wrapped stream."""
    from pcodec_tpu_torch.codec.container import HEADER_BYTES, parse_container

    cidx = parse_container(data)
    report = FileReport(total_bytes=len(data), header_bytes=HEADER_BYTES)
    # span from the container header to the first chunk meta covers the
    # directory plus the embedded wrapped header
    dir_bytes = (
        int(cidx.chunk_meta_starts[0]) - HEADER_BYTES
        if len(cidx.chunk_metas)
        else len(data) - HEADER_BYTES
    )
    report.footer_bytes = 0
    pages_by_chunk = {}
    for p in cidx.pages:
        pages_by_chunk.setdefault(p.chunk_idx, []).append(p)
    for ci, meta in enumerate(cidx.chunk_metas):
        n = int(cidx.chunk_ns[ci])
        pages = pages_by_chunk.get(ci, [])
        meta_nbytes = (
            (pages[0].byte_start - int(cidx.chunk_meta_starts[ci]))
            if pages else 0
        )
        page_nbytes = sum(p.byte_len for p in pages)
        cr = ChunkReport(
            idx=ci,
            dtype=cidx.nt.name,
            n=n,
            mode=meta.mode.kind,
            delta_encoding=describe_delta(meta.delta_encoding),
            meta_bytes=meta_nbytes,
            page_bytes=page_nbytes,
        )
        _fill_latent_vars(cr, meta, cidx.nt)
        report.chunks.append(cr)
        report.meta_bytes += meta_nbytes
        report.page_bytes += page_nbytes
        report.total_n += n
        report.uncompressed_bytes += n * cidx.nt.np_dtype.itemsize
    report.n_chunks = len(cidx.chunk_metas)
    # count the directory as header overhead
    report.header_bytes += dir_bytes
    return report


def inspect_file(data: bytes) -> FileReport:
    if data[:4] == b"PCT1":
        return inspect_container(data)
    reader = BitReader(data)
    fd = FileDecompressor.new(reader)
    report = FileReport(total_bytes=len(data), header_bytes=reader.bit_idx // 8)
    idx = 0
    while True:
        chunk_start = reader.bit_idx // 8
        pre = fd.chunk_preamble(reader)
        if pre is None:
            break
        nt, n = pre
        meta_start = reader.bit_idx // 8
        meta = ChunkMeta.read_from(reader, fd.format_version, nt.latent)
        meta_end = reader.bit_idx // 8
        pd = PageDecompressor(reader, meta, nt, n)
        scratch = np.zeros(n, dtype=nt.np_dtype)
        pd.read_page_fast(scratch)
        page_end = reader.bit_idx // 8

        cr = ChunkReport(
            idx=idx,
            dtype=nt.name,
            n=n,
            mode=meta.mode.kind,
            delta_encoding=describe_delta(meta.delta_encoding),
            meta_bytes=meta_end - chunk_start,
            page_bytes=page_end - meta_end,
        )
        _fill_latent_vars(cr, meta, nt)
        report.chunks.append(cr)
        report.meta_bytes += cr.meta_bytes
        report.page_bytes += cr.page_bytes
        report.total_n += n
        report.uncompressed_bytes += n * nt.np_dtype.itemsize
        idx += 1
    report.n_chunks = idx
    return report


def format_report(report: FileReport, verbose: bool = False) -> str:
    lines = []
    lines.append(
        f"{report.n_chunks} chunks, {report.total_n} numbers, "
        f"{report.total_bytes} bytes (ratio {report.ratio:.3f}, "
        f"{8 * report.total_bytes / max(report.total_n, 1):.3f} bits/num)"
    )
    lines.append(
        f"size breakdown: header {report.header_bytes} B, chunk metas "
        f"{report.meta_bytes} B, pages {report.page_bytes} B, footer "
        f"{report.footer_bytes} B"
    )
    for cr in report.chunks if verbose else report.chunks[:5]:
        lines.append(
            f"chunk {cr.idx}: {cr.dtype} n={cr.n} mode={cr.mode} "
            f"delta=[{cr.delta_encoding}] meta={cr.meta_bytes}B page={cr.page_bytes}B"
        )
        for lv in cr.latent_vars:
            lines.append(
                f"  {lv.key} ({lv.description}): {lv.n_bins} bins, "
                f"ans_size_log={lv.ans_size_log}, "
                f"~{lv.avg_bits_per_latent:.2f} bits/latent"
            )
            if verbose:
                shown = lv.bins if len(lv.bins) <= 32 else lv.bins[:32]
                for w, lower_s, ob in shown:
                    lines.append(f"    weight={w} lower={lower_s} offset_bits={ob}")
                if len(lv.bins) > 32:
                    lines.append(f"    ... and {len(lv.bins) - 32} more bins")
    if not verbose and report.n_chunks > 5:
        lines.append(f"... and {report.n_chunks - 5} more chunks (use -v)")
    return "\n".join(lines)
