"""The port's PCT decode (pcodec_tpu_torch.ops.container_decode) against the
JAX package.

On the CPU every kernel wrapper runs its plain PyTorch version (the CUDA
kernels are held against them in test_torch_kernels.py). Every comparison
here is exact: decoded numbers bit for bit, post-processing bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pcodec_tpu.ops.decode as xops
import pcodec_tpu.ops.pallas_decode as pd
from pcodec_tpu.codec.container import container_decompress as ref_decompress
from pcodec_tpu.dtypes import NUMBER_TYPES_BY_NAME as REF_TYPES

import pcodec_tpu_torch as pt
from pcodec_tpu_torch.dtypes import NUMBER_TYPES
from pcodec_tpu_torch.dtypes import NUMBER_TYPES_BY_NAME as TYPES
from pcodec_tpu_torch.ops import container_decode as cd
from pcodec_tpu_torch.ops import decode as dec

torch.set_num_threads(1)  # the test workers share the cores: more intra-op threads spin on theirs

RNG = np.random.default_rng(2024)
CLASSIC = pt.ModeSpec("classic")


def _cfg(order, mode=CLASSIC, **kw):
    kind = "try_consecutive" if order else "no_op"
    return pt.ChunkConfig(mode_spec=mode, delta_spec=pt.DeltaSpec(kind, order), **kw)


def _walk(dtype, n):
    """A walk with small steps, wrapped into the type's range."""
    steps = np.cumsum(RNG.integers(-3, 40, n))
    if dtype.kind == "f":
        return (steps * 0.37 - 200).astype(dtype)
    info = np.iinfo(dtype)
    span = min(int(info.max) - int(info.min) + 1, 1 << 62)
    return (steps % span + max(int(info.min), -(1 << 61))).astype(dtype)


def _check(nums, config, page_n, chunk_n=1 << 20):
    data = pt.container_compress(nums, config, page_n=page_n, chunk_n=chunk_n)
    out = pt.decode_container_device(data, device="cpu")
    ref = ref_decompress(data)
    assert out.dtype == nums.dtype == ref.dtype
    assert np.array_equal(out.view(np.uint8), ref.view(np.uint8))
    assert np.array_equal(out.view(np.uint8), nums.view(np.uint8))
    return data


@pytest.mark.parametrize("name", [t.name for t in NUMBER_TYPES])
def test_decode_every_number_type_classic(name):
    """Exact, Classic mode, order-1 consecutive delta, ragged last page."""
    dtype = np.dtype(REF_TYPES[name].np_dtype)
    _check(_walk(dtype, 1300), _cfg(1, enable_8_bit=True), page_n=256)


@pytest.mark.parametrize("order", range(8))
def test_decode_consecutive_orders(order):
    """Exact for consecutive orders 0-7 (0 is NOOP), i32 and i64 in turn."""
    dtype = np.int64 if order % 2 else np.int32
    nums = np.cumsum(np.cumsum(RNG.integers(-5, 9, 1500))).astype(dtype)
    _check(nums, _cfg(order), page_n=256)


@pytest.mark.parametrize("page_n", [256, 1024])
@pytest.mark.parametrize("dtype", [np.int64, np.uint64])
def test_decode_fused_order1(page_n, dtype):
    """Exact; i64/u64 at order 1 take the fused K2 form (fuse 1 / 2)."""
    incs = RNG.integers(0, 120, 5000) + (RNG.random(5000) < 0.002) * RNG.integers(0, 10**6, 5000)
    nums = np.cumsum(incs).astype(dtype)
    data = _check(nums, _cfg(1), page_n=page_n, chunk_n=3000)
    fuses = {cp.fuse for cp in cd.plan_container(data).launches.values()}
    assert fuses == {1 if dtype == np.int64 else 2}


@pytest.mark.parametrize("case", ["constant", "high_entropy_i64", "wide_offsets_i64", "f32_o0",
                                  "u16_p1024", "i64_p2048"])
def test_decode_edge_cases(case):
    """Exact: a constant column (trivial var, no launch), 64 offset bits in
    one bin, 39-63 offset bits across several bins, a float join, a 16-bit
    type and a page longer than 1024."""
    if case == "constant":
        data = _check(np.full(2000, -77, np.int64), _cfg(1), page_n=256)
        assert not cd.plan_container(data).launches
    elif case == "high_entropy_i64":
        nums = RNG.integers(-(2**63), 2**63 - 1, 1200, dtype=np.int64)
        _check(nums, _cfg(0), page_n=256)
    elif case == "wide_offsets_i64":
        nums = (np.where(RNG.random(3000) < 0.3, -(2**62), 2**61)
                + RNG.integers(0, 2**45, 3000) * RNG.integers(1, 3, 3000)).astype(np.int64)
        _check(nums, _cfg(0), page_n=1024)
    elif case == "f32_o0":
        _check(RNG.standard_normal(1500).astype(np.float32), _cfg(0), page_n=256)
    elif case == "u16_p1024":
        _check(RNG.integers(0, 60000, 2500).astype(np.uint16), _cfg(0), page_n=1024)
    else:
        _check(np.cumsum(RNG.integers(0, 1000, 4500)).astype(np.int64), _cfg(2), page_n=2048)


@pytest.mark.parametrize("mode,delta", [
    ("try_int_mult", ("no_op", 0)),
    ("try_dict", ("no_op", 0)),
    ("classic", ("try_lookback", 0)),
])
def test_chunks_outside_the_slice_raise(mode, delta):
    """IntMult, Dict and lookback chunks, refused by the first slice, now
    decode exactly; a mode or delta kind the format does not know still
    raises."""
    if mode == "try_int_mult":
        nums = (RNG.integers(0, 1000, 3000) * 1_000_000).astype(np.int64)
        spec = pt.ModeSpec(mode, 1_000_000)
    elif mode == "try_dict":
        nums = np.array([3, 99, 1234567, -5], np.int64)[RNG.integers(0, 4, 3000)]
        spec = pt.ModeSpec(mode)
    else:
        nums = np.tile(RNG.integers(0, 10**6, 300), 10).astype(np.int64)
        spec = pt.ModeSpec(mode)
    cfg = pt.ChunkConfig(mode_spec=spec, delta_spec=pt.DeltaSpec(*delta))
    data = pt.container_compress(nums, cfg, page_n=256)
    out = pt.decode_container_device(data, device="cpu")
    assert np.array_equal(out, nums) and np.array_equal(out, ref_decompress(data))
    meta = cd.parse_container(data).chunk_metas[0]
    meta.mode.kind = "unknown"
    with pytest.raises(NotImplementedError, match="unknown mode"):
        cd._check_supported(0, meta)


def test_default_device_needs_a_card():
    data = pt.container_compress(np.arange(300, dtype=np.int64), page_n=256)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device decodes")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.decode_container_device(data)


def test_matches_jax_pallas_path_in_interpret_mode():
    """Exact: JAX's Pallas kernels (interpret mode on the CPU) and the port
    decode the same 2048 i64 numbers at page_n 256 to the same bits, and
    the checksums agree."""
    nums = np.cumsum(RNG.integers(0, 50, 2048)).astype(np.int64)
    data = pt.container_compress(nums, _cfg(1, mode=pt.ModeSpec()), page_n=256)
    ref, fn, args = pd.decode_container_device(data)
    out = pt.decode_container_device(data, device="cpu")
    assert np.array_equal(out.view(np.uint8), ref.view(np.uint8))
    res = cd.decode_container_tensor(data, device="cpu")
    ref_sum = sum(int(pd.result_checksum_u64(r)) for r in fn(args)) % (1 << 64)
    assert cd.result_checksum_u64(res) == ref_sum


# ---------------------------------------------------------------------------
# plain post-processing against the JAX XLA functions
# ---------------------------------------------------------------------------


def _u64(shape):
    return RNG.integers(0, 2**64, shape, dtype=np.uint64)


@pytest.mark.parametrize("order,bits", [(1, 64), (2, 32), (3, 16), (7, 64), (4, 8)])
def test_consecutive_decode_matches_jax(order, bits):
    lat = _u64((5, 300)) & np.uint64((1 << bits) - 1 if bits < 64 else 2**64 - 1)
    mom = _u64((5, order))
    ref = np.asarray(pd._consecutive_decode_batched(jnp.asarray(lat), jnp.asarray(mom), order, bits))
    out = dec.consecutive_decode_batched(cd._u64_to_tensor(lat), cd._u64_to_tensor(mom), order, bits)
    assert np.array_equal(out.numpy().view(np.uint64), ref)


@pytest.mark.parametrize("name", [t.name for t in NUMBER_TYPES])
def test_classic_join_matches_jax(name):
    from pcodec_tpu.format.metadata import Mode

    lat = _u64(1000)
    ref = np.asarray(pd._join_mem(REF_TYPES[name], Mode.CLASSIC, jnp.uint64(0), None,
                                  jnp.asarray(lat), None))
    ordered = np.asarray(xops._from_latent_ordered_u(REF_TYPES[name], jnp.asarray(lat)))
    out = dec.from_latent_ordered(TYPES[name], cd._u64_to_tensor(lat)).numpy().view(np.uint64)
    assert np.array_equal(out, ref) and np.array_equal(out, ordered)


def test_checksum_matches_jax():
    x = _u64(4097)
    assert cd.result_checksum_u64(cd._u64_to_tensor(x)) == int(pd.result_checksum_u64(jnp.asarray(x)))
