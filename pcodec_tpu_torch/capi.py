"""Python side of the port's C ABI (native/cpcodec.cpp).

Pointer-based entry points called from the embedded interpreter; the C shim
owns the buffers (caller-allocates, like the reference's pco_c surface,
ref: pco_c/src/lib.rs:128-195). The counterpart of the JAX package's
`pcodec_tpu/capi.py`, with the same C signatures (native/cpcodec.h):

- guarantee_file_size and simple_compress_ptr run on the host: a standalone
  file has no device encoder.
- simple_decompress_ptr and peek_and_decompress decode on the card through
  K1-K4 (plan_standalone, then the container decode's kernels) unless the
  caller passes device="cpu" (the kernels' plain versions). Without a CUDA
  device the default raises, and the C shim returns
  PCO_DECOMPRESSION_ERROR; nothing falls back to the host decoder. Their
  results are the host's: the numbers, the count written when the
  destination is shorter or longer than the file, (0, b"") for a file of
  no chunk, and the same error code for a truncated or corrupt file.
"""

import ctypes

import numpy as np

from pcodec_tpu_torch.codec.chunk_config import ChunkConfig, PagingSpec
from pcodec_tpu_torch.codec.guarantee import standalone_file_size
from pcodec_tpu_torch.codec.standalone import FileDecompressor, simple_compress
from pcodec_tpu_torch.dtypes import NUMBER_TYPES_BY_BYTE
from pcodec_tpu_torch.errors import CorruptionError, InsufficientDataError, InvalidArgumentError
from pcodec_tpu_torch.format.bitio import BitReader
from pcodec_tpu_torch.utils import concat

PCO_INVALID_ARGUMENT = 1
PCO_COMPRESSION_ERROR = 2
PCO_DECOMPRESSION_ERROR = 3
PCO_INSUFFICIENT_DATA = 4
# the host's simple_decompress_ptr's except clauses, in order
_ERROR_CODES = ((InsufficientDataError, PCO_INSUFFICIENT_DATA), (CorruptionError, PCO_DECOMPRESSION_ERROR),
                (InvalidArgumentError, PCO_INVALID_ARGUMENT))


def guarantee_file_size(number_type_byte: int, n: int) -> int:
    nt = NUMBER_TYPES_BY_BYTE[number_type_byte]
    return standalone_file_size(nt.latent, n, PagingSpec())


def _array_from_ptr(ptr: int, n: int, np_dtype) -> np.ndarray:
    buf = (ctypes.c_char * (n * np.dtype(np_dtype).itemsize)).from_address(ptr)
    return np.frombuffer(buf, dtype=np_dtype, count=n)


def simple_compress_ptr(src_ptr: int, n: int, number_type_byte: int,
                        compression_level: int) -> bytes:
    nt = NUMBER_TYPES_BY_BYTE[number_type_byte]
    nums = _array_from_ptr(src_ptr, n, nt.np_dtype)
    cfg = ChunkConfig(compression_level=compression_level, enable_8_bit=True)
    return simple_compress(nums, cfg)


def _decode(src: bytes, device, max_n=None):
    """The numbers of each run of chunks of one number type, decoded on
    `device` by the port's standalone decode as the run's type, the last
    chunk's type (None for a file of no chunk) and the error that ended
    the walk (None when it read to the end or to max_n numbers); the runs
    hold the chunks before an error."""
    from pcodec_tpu_torch.ops.container_decode import decode_plan, to_numbers, upload_plan
    from pcodec_tpu_torch.ops.standalone_decode import plan_standalone_runs

    plans, error = plan_standalone_runs(src, max_n=max_n)
    runs = [to_numbers(decode_plan(plan, upload_plan(plan, device)), plan.nt) for plan in plans]
    return runs, plans[-1].nt if plans else None, error


def peek_and_decompress(src: bytes, device="cuda"):
    """Decompress a whole standalone file without a priori type/count
    knowledge (the Java binding's simple_decompress surface), on `device`.

    Returns (number_type_byte, raw_bytes), or (0, b"") when the file holds
    no chunks and names no uniform type (type unknowable — mirrors the
    reference's Optional.empty, ref: pco_java/src/main/rust/src/lib.rs:98-116).
    As the host's simple_decompress, the type is the last chunk's and the
    numbers are in the first chunk's dtype."""
    from pcodec_tpu_torch.ops.container_decode import _resolve_device

    device = _resolve_device(device)
    runs, nt, error = _decode(src, device)
    if error is not None:
        raise error
    if nt is None:  # no chunk: the header's uniform type, if it names one
        nt = FileDecompressor.new(BitReader(np.frombuffer(src, dtype=np.uint8))).uniform_type
        return (0, b"") if nt is None else (nt.type_byte, b"")
    return nt.type_byte, concat(runs).tobytes()


def simple_decompress_ptr(src: bytes, number_type_byte: int, dst_ptr: int,
                          dst_capacity_elems: int, device="cuda") -> int:
    """Decode on `device` into the caller's buffer; returns elements
    written, or -error_code. As the host's simple_decompress_into, the
    decode stops at the chunk that fills the destination, so chunks past it
    are not read, and a chunk it cannot read leaves the chunks before it
    written."""
    from pcodec_tpu_torch.ops.container_decode import _resolve_device

    device = _resolve_device(device)
    nt = NUMBER_TYPES_BY_BYTE[number_type_byte]
    dst_buf = (ctypes.c_char * (dst_capacity_elems * nt.np_dtype.itemsize)).from_address(dst_ptr)
    dst = np.frombuffer(dst_buf, dtype=nt.np_dtype, count=dst_capacity_elems)
    runs, _, error = _decode(src, device, max_n=dst_capacity_elems)
    pos = 0
    for nums in runs:  # cast to the destination's type, as the host's copy does
        take = min(len(nums), dst_capacity_elems - pos)
        dst[pos : pos + take] = nums[:take]
        pos += take
    if error is None:
        return pos
    for cls, code in _ERROR_CODES:
        if isinstance(error, cls):
            return -code
    raise error
