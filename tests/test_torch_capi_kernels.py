"""The port's C ABI on the card: the shim (native/cpcodec.cpp) and its C
test program built and run, and a C ABI decode launching K1 and K2. No JAX:
runs on the GPU machine with `--noconftest -m gpu`; here it skips."""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from pcodec_tpu_torch import capi
from pcodec_tpu_torch.codec.chunk_config import ChunkConfig, PagingSpec
from pcodec_tpu_torch.codec.standalone import simple_compress, simple_decompress
from pcodec_tpu_torch.ops import kernels

I64 = 4


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the C ABI decodes on the card")
    if shutil.which("g++") is None or shutil.which("gcc") is None:
        pytest.skip("no C toolchain")


def _file():
    nums = np.cumsum(np.random.default_rng(5).integers(-3, 97, 9000)).astype(np.int64)
    cfg = ChunkConfig(compression_level=8, enable_8_bit=True, paging_spec=PagingSpec.equal_pages_up_to(4000))
    return nums, simple_compress(nums, cfg)


@pytest.mark.gpu
def test_c_test_program_passes_on_the_card(tmp_path):
    """The C program (test_cpcodec.c: i64 and f32 round trips, the
    allocating decode, a truncated file) passes with the port's shim."""
    _need_card()
    from pcodec_tpu_torch.native import capi_build

    shim = capi_build.build_shim(str(tmp_path), embed=True)
    exe = capi_build.build_test_program(str(tmp_path), str(tmp_path))
    assert shim.startswith(str(tmp_path))
    r = capi_build.run_test_program(exe)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "ALL C ABI TESTS PASSED" in r.stdout


@pytest.mark.gpu
def test_c_abi_decode_launches_k1_and_k2(tmp_path):
    """Exact: a decode through the C ABI (the shim loaded into this
    process) and through capi's functions returns the numbers, and each
    launches K1 section_gather and K2 chain_decode."""
    _need_card()
    from pcodec_tpu_torch.native import capi_build

    nums, data = _file()
    lib = capi_build.load_shim(capi_build.build_shim(str(tmp_path), embed=False))
    src = np.frombuffer(data, np.uint8)
    out = np.zeros(len(nums), np.int64)
    n_out = ctypes.c_size_t(0)
    before = dict(kernels.LAUNCHES)
    rc = lib.pco_standalone_simple_decompress_into(src.ctypes.data, len(data), I64, out.ctypes.data, len(nums),
                                                   ctypes.byref(n_out))
    assert rc == 0 and n_out.value == len(nums) and np.array_equal(out, nums)
    for k in ("section_gather", "chain_decode"):
        assert kernels.LAUNCHES[k] > before[k], k

    before = dict(kernels.LAUNCHES)
    dst = np.zeros(5000, np.int64)
    assert capi.simple_decompress_ptr(data, I64, dst.ctypes.data, 5000) == 5000
    assert np.array_equal(dst, nums[:5000])
    tb, raw = capi.peek_and_decompress(data)
    assert tb == I64 and raw == simple_decompress(data)[0].tobytes()
    assert capi.peek_and_decompress(data, device="cpu") == (tb, raw)
    for k in ("section_gather", "chain_decode"):
        assert kernels.LAUNCHES[k] >= before[k] + 2, k
