"""Standalone .pco container format: header, chunks, footer.

Wire layout per docs/format.md "Standalone Format"
(ref: pco/src/standalone/compressor.rs:85-204, decompressor.rs:83-250).
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np

from pcodec_tpu_torch import constants as c
from pcodec_tpu_torch.dtypes import NUMBER_TYPES_BY_BYTE, NumberType, number_type_from_np
from pcodec_tpu_torch.errors import CorruptionError, InsufficientDataError
from pcodec_tpu_torch.format.bitio import BitReader, BitWriter
from pcodec_tpu_torch.format.metadata import ChunkMeta, FormatVersion
from pcodec_tpu_torch.codec.decompress import PageDecompressor
from pcodec_tpu_torch.utils import concat


def _read_varint(reader: BitReader) -> int:
    power = 1 + reader.read_uint(c.BITS_TO_ENCODE_VARINT_POWER)
    res = reader.read_uint(power)
    reader.drain_empty_byte("standalone size hint")
    return res


def write_varint(n: int, writer: BitWriter) -> None:
    power = 1 if n == 0 else n.bit_length()
    writer.write_uint(power - 1, c.BITS_TO_ENCODE_VARINT_POWER)
    writer.write_uint(n & ((1 << power) - 1), power)


@dataclass
class FileDecompressor:
    standalone_version: int
    uniform_type: Optional[NumberType]
    n_hint: int
    format_version: FormatVersion

    @classmethod
    def new(cls, reader: BitReader) -> "FileDecompressor":
        header = reader.read_aligned_bytes(len(c.MAGIC_HEADER))
        if header != c.MAGIC_HEADER:
            raise CorruptionError(
                f"magic header does not match {c.MAGIC_HEADER!r}; found {header!r}"
            )
        standalone_version = reader.read_uint(c.BITS_TO_ENCODE_STANDALONE_VERSION)
        uniform_type = None
        n_hint = 0
        if standalone_version < 2:
            # pre-v2 the byte after the magic was the wrapped version; rewind
            reader.bit_idx -= c.BITS_TO_ENCODE_STANDALONE_VERSION
        else:
            if standalone_version > c.CURRENT_STANDALONE_VERSION:
                raise CorruptionError(
                    f"file's standalone version ({standalone_version}) exceeds "
                    f"max supported ({c.CURRENT_STANDALONE_VERSION})"
                )
            if standalone_version >= 3:
                byte = reader.read_aligned_bytes(1)[0]
                if byte != c.MAGIC_TERMINATION_BYTE:
                    uniform_type = NUMBER_TYPES_BY_BYTE.get(byte)
                    if uniform_type is None:
                        raise CorruptionError(f"unknown number type byte: {byte}")
            n_hint = _read_varint(reader)
        format_version = FormatVersion.read_from(reader)
        return cls(standalone_version, uniform_type, n_hint, format_version)

    def chunk_preamble(self, reader: BitReader):
        """Returns (number_type, chunk_n) or None at the terminator."""
        byte = reader.read_aligned_bytes(1)[0]
        if byte == c.MAGIC_TERMINATION_BYTE:
            return None
        nt = NUMBER_TYPES_BY_BYTE.get(byte)
        if nt is None:
            raise CorruptionError(f"unknown number type byte: {byte}")
        if self.uniform_type is not None and nt is not self.uniform_type:
            raise CorruptionError(
                f"chunk number type {nt.name} does not match file's uniform type "
                f"{self.uniform_type.name}"
            )
        n = reader.read_uint(c.BITS_TO_ENCODE_N_ENTRIES) + 1
        reader.check_in_bounds()
        return nt, n


def write_header(
    writer: BitWriter,
    n_hint: int = 0,
    uniform_type: Optional[NumberType] = None,
    format_version: Optional[FormatVersion] = None,
) -> None:
    """ref: standalone/compressor.rs:85-105."""
    writer.write_aligned_bytes(c.MAGIC_HEADER)
    writer.write_uint(c.CURRENT_STANDALONE_VERSION, c.BITS_TO_ENCODE_STANDALONE_VERSION)
    writer.write_aligned_bytes(bytes([uniform_type.type_byte if uniform_type else 0]))
    write_varint(n_hint, writer)
    writer.finish_byte()
    (format_version or FormatVersion()).write_to(writer)


def write_footer(writer: BitWriter) -> None:
    writer.write_aligned_bytes(bytes([c.MAGIC_TERMINATION_BYTE]))


def simple_compress(nums: np.ndarray, config=None, uniform_type: bool = False) -> bytes:
    """Compress a numpy array into a standalone .pco file.

    Each page of the paging spec becomes one chunk with a single page
    (ref: standalone/simple.rs:58-107).
    """
    from pcodec_tpu_torch.codec.chunk_config import ChunkConfig, PagingSpec
    from pcodec_tpu_torch.codec.compress import chunk_compressor

    if config is None:
        config = ChunkConfig()
    nt = number_type_from_np(nums.dtype)
    writer = BitWriter(max(len(nums) // 2, 1 << 12))
    write_header(
        writer, n_hint=len(nums), uniform_type=nt if uniform_type else None
    )
    n_per_page = config.paging_spec.n_per_page(len(nums))
    start = 0
    for page_n in n_per_page:
        end = start + page_n
        from dataclasses import replace

        chunk_cfg = replace(config, paging_spec=PagingSpec.exact_pages([page_n]))
        cc = chunk_compressor(nt, nums[start:end], chunk_cfg)
        writer.write_aligned_bytes(bytes([nt.type_byte]))
        writer.write_uint(page_n - 1, c.BITS_TO_ENCODE_N_ENTRIES)
        cc.write_meta(writer)
        cc.write_page(0, writer)
        start = end
    write_footer(writer)
    return writer.to_bytes()


@dataclass
class Progress:
    """Decompression progress (ref: pco/src/progress.rs:3-12)."""

    n_processed: int = 0
    finished: bool = False


def simple_decompress_into(data: bytes, dst: np.ndarray) -> Progress:
    """Decompress into a preallocated array; returns Progress.

    Like the reference (ref: standalone/simple.rs:100-146), does not error if
    dst is shorter or longer than the file's contents.
    """
    reader = BitReader(data)
    fd = FileDecompressor.new(reader)
    progress = Progress()
    pos = 0
    while True:
        pre = fd.chunk_preamble(reader)
        if pre is None:
            progress.finished = True
            break
        nt, n = pre
        meta = ChunkMeta.read_from(reader, fd.format_version, nt.latent)
        pd = PageDecompressor(reader, meta, nt, n)
        chunk = np.zeros(n, dtype=nt.np_dtype)
        pd.read_page_fast(chunk)
        take = min(n, len(dst) - pos)
        dst[pos : pos + take] = chunk[:take]
        pos += take
        progress.n_processed = pos
        if pos >= len(dst):
            progress.finished = pos >= len(dst) and n == take and _at_end(fd, reader)
            break
    return progress


def _at_end(fd: FileDecompressor, reader: BitReader) -> bool:
    save = reader.bit_idx
    try:
        return fd.chunk_preamble(reader) is None
    except Exception:
        return False
    finally:
        reader.bit_idx = save


def simple_decompress(data: bytes, expected_dtype=None):
    """Decompress an entire standalone file into a numpy array.

    Returns (array, NumberType). If the file is empty of chunks, dtype falls
    back to the uniform type or expected_dtype (f64 otherwise).
    """
    reader = BitReader(data)
    fd = FileDecompressor.new(reader)
    out_chunks = []
    nt_seen = fd.uniform_type
    while True:
        pre = fd.chunk_preamble(reader)
        if pre is None:
            break
        nt, n = pre
        nt_seen = nt
        meta = ChunkMeta.read_from(reader, fd.format_version, nt.latent)
        pd = PageDecompressor(reader, meta, nt, n)
        dst = np.zeros(n, dtype=nt.np_dtype)
        pd.read_page_fast(dst)
        out_chunks.append(dst)
    if nt_seen is None:
        nt_seen = number_type_from_np(expected_dtype) if expected_dtype is not None else None
    if not out_chunks:
        dtype = nt_seen.np_dtype if nt_seen is not None else np.float64
        return np.zeros(0, dtype=dtype), nt_seen
    if expected_dtype is not None and out_chunks[0].dtype != np.dtype(expected_dtype):
        raise CorruptionError(
            f"file contains {out_chunks[0].dtype} but {expected_dtype} was requested"
        )
    return concat(out_chunks), nt_seen
