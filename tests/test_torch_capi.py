"""The port's C ABI (`pcodec_tpu_torch/capi.py`, `native/cpcodec.cpp`)
against the JAX package's (`pcodec_tpu/capi.py`): on the same buffers the
same bytes, numbers, counts and error codes. The port decodes on the card
by default; here it runs with device="cpu" (the kernels' plain versions),
and without a card its default raises. The shim and the Java binding's
JNI source are compiled, not run (their run needs a card:
tests/test_torch_capi_kernels.py)."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import pcodec_tpu.capi as ref

import pcodec_tpu_torch.capi as port
from pcodec_tpu_torch.codec.chunk_config import ChunkConfig, PagingSpec
from pcodec_tpu_torch.codec.standalone import FileDecompressor, simple_compress
from pcodec_tpu_torch.format.bitio import BitReader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 6000
I64, F32, U16, F64 = 4, 5, 7, 6
NP_OF = {I64: np.int64, F32: np.float32, U16: np.uint16, F64: np.float64}


def _numbers(tb: int, n: int = N) -> np.ndarray:
    rng = np.random.default_rng(tb)
    if tb == F32:
        return (rng.integers(0, 777, n) * 0.25).astype(np.float32)
    if tb == U16:
        return rng.integers(0, 60000, n).astype(np.uint16)
    return np.cumsum(rng.integers(-3, 97, n)).astype(np.int64)


def _file(tb: int = I64, page: int = 2500) -> bytes:
    """A file of several chunks (simple_compress's pages of `page` numbers)."""
    cfg = ChunkConfig(compression_level=8, enable_8_bit=True, paging_spec=PagingSpec.equal_pages_up_to(page))
    return simple_compress(_numbers(tb), cfg)


def _mixed_types() -> bytes:
    """The i64 file with its second chunk's type byte made f64's: a file of
    two number types, which the host decodes chunk by chunk."""
    data = _file()
    reader = BitReader(np.frombuffer(data, dtype=np.uint8))
    fd = FileDecompressor.new(reader)
    from pcodec_tpu_torch.codec.decompress import PageDecompressor
    from pcodec_tpu_torch.format.metadata import ChunkMeta

    nt, n = fd.chunk_preamble(reader)
    meta = ChunkMeta.read_from(reader, fd.format_version, nt.latent)
    PageDecompressor(reader, meta, nt, n).read_page_fast(np.zeros(n, nt.np_dtype))
    at = reader.bit_idx // 8
    assert data[at] == I64
    return data[:at] + bytes([F64]) + data[at + 1:]


@pytest.mark.parametrize("tb", [I64, F32, U16, F64, 1, 3, 10])
def test_guarantee_file_size_equals_the_jax_package(tb):
    for n in (0, 1, 1000, 262144, 10**6 + 3):
        assert port.guarantee_file_size(tb, n) == ref.guarantee_file_size(tb, n)


@pytest.mark.parametrize("tb,level", [(I64, 8), (I64, 0), (F32, 8), (U16, 4)])
def test_simple_compress_ptr_bytes_equal_the_jax_package(tb, level):
    nums = _numbers(tb)
    got = port.simple_compress_ptr(nums.ctypes.data, len(nums), tb, level)
    assert got == ref.simple_compress_ptr(nums.ctypes.data, len(nums), tb, level)


def _decompress_cases():
    data = _file()
    return {
        "full": (data, I64, N),
        "short_inside_a_chunk": (data, I64, 3000),
        "short_at_a_chunk_end": (data, I64, 2500),
        "zero_capacity": (data, I64, 0),
        "long": (data, I64, N + 777),
        "truncated_half": (data[: len(data) // 2], I64, N),
        "truncated_past_the_filled_chunks": (data[: len(data) // 2], I64, 2500),
        "truncated_footer": (data[:-1], I64, N),
        "truncated_footer_long": (data[:-1], I64, N + 1),
        "truncated_header": (data[:5], I64, N),
        "corrupt_type_byte": (data[:15] + bytes([99]) + data[16:], I64, N),
        "f32_file": (_file(F32), F32, N),
        "wrong_type_byte_f32_dst": (data, F32, N),
        "wrong_type_byte_u16_dst": (data, U16, N),
        "two_number_types": (_mixed_types(), I64, N),
        "no_chunks": (simple_compress(np.zeros(0, np.int64)), I64, 10),
    }


DECOMPRESS = _decompress_cases()


@pytest.mark.parametrize("case", sorted(DECOMPRESS))
def test_simple_decompress_ptr_equals_the_jax_package(case):
    """Exact: the return (count or -code) and every byte of the
    destination, against the host's on the same buffers."""
    data, tb, cap = DECOMPRESS[case]
    outs = []
    for fn in (lambda *a: port.simple_decompress_ptr(*a, device="cpu"), ref.simple_decompress_ptr):
        dst = np.full(cap, 7, NP_OF[tb])
        outs.append((fn(data, tb, dst.ctypes.data, cap), dst.tobytes()))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("case", ["full", "f32_file", "two_number_types", "no_chunks", "uniform_no_chunks",
                                  "truncated_half"])
def test_peek_and_decompress_equals_the_jax_package(case):
    """Exact: (type byte, bytes), or the same error class."""
    if case == "uniform_no_chunks":
        data = simple_compress(np.zeros(0, np.float32), uniform_type=True)
    else:
        data = DECOMPRESS[case][0]
    outs = []
    for fn in (lambda d: port.peek_and_decompress(d, device="cpu"), ref.peek_and_decompress):
        try:
            outs.append(fn(data))
        except Exception as e:  # the class's name: the two packages' errors are distinct classes
            outs.append(type(e).__name__)
    assert outs[0] == outs[1]
    if case == "no_chunks":
        assert outs[0] == (0, b"")


def test_without_a_card_the_default_device_raises():
    """The decode entry points run on the card by default and do not fall
    back to the host: without CUDA they raise (the C shim then returns
    PCO_DECOMPRESSION_ERROR)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device runs")
    data = _file()
    dst = np.zeros(N, np.int64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.simple_decompress_ptr(data, I64, dst.ctypes.data, N)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.peek_and_decompress(data)
    assert not dst.any()


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
def test_shim_builds_and_runs_through_ctypes(tmp_path):
    """The port's cpcodec.cpp compiles (-shared) and, loaded into this
    process, compresses to the JAX package's bytes through the C ABI; its
    decode runs on the card, so without one it returns
    PCO_DECOMPRESSION_ERROR (3)."""
    from pcodec_tpu_torch.native import capi_build

    lib = capi_build.load_shim(capi_build.build_shim(str(tmp_path), embed=False))
    nums = _numbers(I64)
    cap = lib.pco_standalone_guarantee_file_size(I64, N)
    assert cap == ref.guarantee_file_size(I64, N)
    dst = np.zeros(cap, np.uint8)
    written = ctypes.c_size_t(0)
    assert lib.pco_standalone_simple_compress_into(nums.ctypes.data, N, I64, 8, dst.ctypes.data, cap,
                                                   ctypes.byref(written)) == 0
    assert dst[: written.value].tobytes() == ref.simple_compress_ptr(nums.ctypes.data, N, I64, 8)
    if torch.cuda.is_available():
        return
    out = np.zeros(N, np.int64)
    n_out = ctypes.c_size_t(0)
    rc = lib.pco_standalone_simple_decompress_into(dst.ctypes.data, written.value, I64, out.ctypes.data, N,
                                                   ctypes.byref(n_out))
    assert rc == 3 and n_out.value == 0 and not out.any()


def test_jni_shim_compiles():
    """The port's JNI shim stays well-formed C++ against the port's
    cpcodec.h (no JDK: checked against the vendored jni_stub/jni.h)."""
    r = subprocess.run(["make", "syntax-check"], cwd=os.path.join(REPO, "pcodec_tpu_torch", "java"),
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
