"""f16 numbers whose FloatMult base has no finite reciprocal.

`standard_normal(20000) * 1e-4` as f16 leads FloatMult's sample GCD to a
base so small that 1 / base overflows f16. Rust's float comparisons make
both of `_snap_to_int_reciprocal`'s snap tests false on inf or NaN, so the
base stays as it is and the bids reject it. The JAX package raises an
OverflowError on this input (its `_snap_to_int_reciprocal` rounds the
infinite reciprocal to an integer), so it cannot be the oracle here: the
port's own host codec is, and the device encode on the CPU must equal its
container bytes.
"""

import numpy as np
import pytest
import torch

import pcodec_tpu_torch as pt
from pcodec_tpu_torch.dtypes import NUMBER_TYPES_BY_NAME
from pcodec_tpu_torch.modes import float_mult

torch.set_num_threads(1)  # the test workers share the cores: more intra-op threads spin on theirs


def _nums(seed):
    return (np.random.default_rng(seed).standard_normal(20000) * 1e-4).astype(np.float16)


@pytest.mark.parametrize("seed", [1, 9, 13])
def test_tiny_f16_round_trips_through_the_host_codec(seed):
    nums = _nums(seed)
    out = pt.simple_decompress(pt.simple_compress(nums, pt.ChunkConfig()))
    out = out[0] if isinstance(out, tuple) else out
    assert out.dtype == np.float16 and np.array_equal(out.view(np.uint16), nums.view(np.uint16))


@pytest.mark.parametrize("seed", [1, 9, 13])
def test_tiny_f16_device_encode_equals_the_host_container(seed):
    nums = _nums(seed)
    want = pt.container_compress(nums, pt.ChunkConfig())
    assert pt.encode_container_device(nums, pt.ChunkConfig(), device="cpu") == want
    assert np.array_equal(pt.container_decompress(want).view(np.uint16), nums.view(np.uint16))


def test_snap_keeps_a_base_without_a_finite_reciprocal():
    nt = NUMBER_TYPES_BY_NAME["f16"]
    base = np.float16(1e-7)
    with np.errstate(over="ignore"):
        got_base, inv = float_mult._snap_to_int_reciprocal(nt, base)
    assert got_base == base and np.isinf(inv)
