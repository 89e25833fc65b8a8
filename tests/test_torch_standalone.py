"""The port's standalone `.pco` decode (pcodec_tpu_torch.ops.standalone_decode)
against the JAX package.

The inputs are those of tests/test_standalone_pallas.py::TestStandaloneDevice
at their sizes (that class needs a TPU). Each file is the JAX package's
`simple_compress`; the port's `decode_standalone_device` and
`decode_standalone_with_device` on the CPU (the kernels' plain versions)
must return exactly the numbers of the JAX package's host
`simple_decompress`, and the port's planner must give each chain the JAX
`plan_standalone`'s cursors, entry states, body length and moments. Every
comparison is exact.
"""

import numpy as np
import pytest
import torch

import pcodec_tpu.ops.pallas_decode as pd
from pcodec_tpu import ChunkConfig, DeltaSpec, ModeSpec
from pcodec_tpu.codec.chunk_config import PagingSpec
from pcodec_tpu.codec.standalone import simple_compress, simple_decompress

import pcodec_tpu_torch as pt
from pcodec_tpu_torch.codec import compress as port_compress
from pcodec_tpu_torch.codec import standalone as port_standalone
from pcodec_tpu_torch.codec.chunk_config import ChunkConfig as PortChunkConfig
from pcodec_tpu_torch.codec.chunk_config import DeltaSpec as PortDeltaSpec
from pcodec_tpu_torch.format.metadata import DeltaEncoding
from pcodec_tpu_torch.ops import container_decode as cd
from pcodec_tpu_torch.ops import standalone_decode as sd

torch.set_num_threads(1)  # the test workers share the cores: more intra-op threads spin on theirs

RNG = np.random.default_rng(99)


def _taxi(n):
    return np.cumsum(RNG.integers(0, 120, n)).astype(np.int64)


def _cases():
    t = np.arange(6000, dtype=np.float64)
    base = np.cumsum(np.cumsum(RNG.integers(0, 10, 6000))).astype(np.int64)
    pat = np.tile(RNG.integers(0, 10**6, 512).astype(np.int64), 30)
    lookback = ChunkConfig(delta_spec=DeltaSpec(DeltaSpec.TRY_LOOKBACK))
    return {
        # name: (numbers, JAX config), TestStandaloneDevice's test of each
        "multi_chunk_ragged": (_taxi(9473), ChunkConfig(paging_spec=PagingSpec.equal_pages_up_to(4096))),
        "u32_noop": (RNG.integers(0, 5000, 6000).astype(np.uint32), None),
        "high_entropy_i64": (RNG.integers(0, 2**63, 6000).astype(np.int64), None),
        "f32_classic": ((RNG.standard_normal(6000) * 100).astype(np.float32), None),
        "f64_float_mult": ((RNG.integers(0, 1000, 6000) * 0.1).astype(np.float64), None),
        "f16_quant": (np.round(RNG.standard_normal(6000) * 16).astype(np.float16) / 16, None),
        "int_mult": ((RNG.integers(0, 10**6, 6000) * 1_000_000_000).astype(np.int64), None),
        "dict_mode": (np.array([3, 99, 1234567, -5], dtype=np.int64)[RNG.integers(0, 4, 6000)],
                      ChunkConfig(mode_spec=ModeSpec(ModeSpec.TRY_DICT))),
        "delta_order_2": (base, ChunkConfig(delta_spec=DeltaSpec(DeltaSpec.TRY_CONSECUTIVE, 2))),
        "delta_order_7": (base, ChunkConfig(delta_spec=DeltaSpec(DeltaSpec.TRY_CONSECUTIVE, 7))),
        "conv1": ((1000 * np.sin(t * 0.01) + RNG.standard_normal(6000)).astype(np.int32),
                  ChunkConfig(delta_spec=DeltaSpec(DeltaSpec.TRY_CONV1, 4))),
        "lookback": (np.tile(RNG.integers(0, 1000, 64).astype(np.int64), 100), lookback),
        "lookback_ragged_multichunk": (pat[: len(pat) - 100], lookback),
        "constant": (np.full(6000, 42, dtype=np.int64), None),
        "tiny_7": (_taxi(7), None),
        "tiny_1025": (_taxi(1025), None),
    }


CASES = _cases()
BLOBS = {name: simple_compress(nums, cfg) for name, (nums, cfg) in CASES.items()}


def _same(out, ref):
    assert out.dtype == ref.dtype
    assert np.array_equal(out.view(np.uint8), ref.view(np.uint8)), (
        f"{np.count_nonzero(out.view(np.uint8) != ref.view(np.uint8))} bytes differ")


@pytest.mark.parametrize("name", sorted(CASES))
def test_standalone_decode_equals_the_host_decode(name):
    """Both entry points on the CPU, exact against the JAX package's
    simple_decompress (and the source numbers)."""
    blob = BLOBS[name]
    ref, _ = simple_decompress(blob)
    _same(ref, CASES[name][0])
    _same(pt.decode_standalone_device(blob, device="cpu"), ref)
    out, seconds = pt.decode_standalone_with_device(blob, time_it=True, device="cpu")
    _same(out, ref)
    assert seconds > 0


def _jax_arrays(launch):
    return {k: getattr(launch, k) for k in ("schema", "tables", "tbl_ids", "starts_blk",
                                            "curs", "states0", "bodyn", "moments")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_standalone_plan_equals_jax_plan(name):
    """Per chain: absolute cursors, entry states, body length, fused moment;
    per var: the moments (consecutive streams at each chain's start, conv1
    numbers, a lookback's stored state). The JAX planner pads each table's
    chains to 256 and the port's to 128, so rows are compared per (chunk,
    var)."""
    blob = BLOBS[name]
    ours = sd.plan_standalone(blob)
    ref = pd.plan_standalone(blob)
    assert len(ours.chunks) == len(ref.chunks)
    converted, compared = {}, 0
    for cp, rcp in zip(ours.chunks, ref.chunks):
        assert rcp.fallback is None, "the JAX planner sent this chunk to the host"
        assert np.array_equal(cp.page_ns, rcp.page_ns)
        assert cp.flat_lookback == (cp.delta.kind == DeltaEncoding.LOOKBACK)
        for key, rvp in rcp.var_plans.items():
            vp = cp.var_plans[key]
            assert vp.trivial == rvp.trivial and vp.const_lower == rvp.const_lower
            assert np.array_equal(vp.moments.astype(np.uint64), np.asarray(rvp.moments).astype(np.uint64)), key
            if rvp.trivial:
                assert vp.launch_key is None
                continue
            if rvp.launch_key not in converted:
                items = sorted((v for c2 in ref.chunks for v in c2.var_plans.values()
                                if v.launch_key == rvp.launch_key), key=lambda v: v.chain_start)
                converted[rvp.launch_key] = cd.chain_plan_from_jax(_jax_arrays(ref.launches[rvp.launch_key]),
                                                                   bias=[v.bias for v in items])
            theirs, mine = converted[rvp.launch_key], ours.launches[vp.launch_key]
            assert mine.page_n == theirs.page_n == sd.CHAIN_N and mine.fuse == theirs.fuse
            a = slice(vp.chain_start, vp.chain_start + cp.n_pages)
            b = slice(rvp.chain_start, rvp.chain_start + cp.n_pages)
            for f in ("chain_bit0", "curs", "states0", "body_n", "moment0"):
                assert np.array_equal(getattr(mine, f)[a], getattr(theirs, f)[b]), f
            compared += 1
    assert compared > 0 or name == "constant"


def test_standalone_lookback_state_n_64_stays_on_the_chains(monkeypatch):
    """A lookback chunk whose stored state has 64 latents (the JAX planner
    sends state_n > 32 to the host) and over 16,384 numbers (K3's
    device-memory route on the card): no chunk leaves the chains, and both
    entry points return the host decode's numbers."""
    monkeypatch.setattr(port_compress, "new_lookback",
                        lambda n: DeltaEncoding.lookback(max(6, (n - 1).bit_length()), 6))
    pattern = RNG.integers(0, 10**6, 173)
    nums = (np.tile(pattern, 120)[:20_000] + RNG.integers(0, 2, 20_000)).astype(np.int64)
    blob = port_standalone.simple_compress(nums, PortChunkConfig(delta_spec=PortDeltaSpec("try_lookback", 0)))
    ref, _ = simple_decompress(blob)
    _same(ref, nums)
    plan = sd.plan_standalone(blob)
    ch = plan.chunks[0]
    assert ch.delta.kind == DeltaEncoding.LOOKBACK and ch.delta.state_n == 64 and ch.flat_lookback
    assert all(vp.launch_key is not None for vp in ch.var_plans.values())
    assert ch.recon_pages == (1, ch.n_pages * sd.CHAIN_N) and not plan.lookback_chunks  # past shared memory
    _same(pt.decode_standalone_device(blob, device="cpu"), ref)
    _same(pt.decode_standalone_with_device(blob, device="cpu")[0], ref)


@pytest.mark.parametrize("name", ["lookback", "lookback_ragged_multichunk"])
def test_standalone_lookback_chunks_stay_on_the_chains(name):
    """Every var of a lookback chunk is decoded by K1 + K2 chains, and its
    lookback var reconstructed by K3's one launch over the whole chunk."""
    plan = sd.plan_standalone(BLOBS[name])
    for ci, ch in enumerate(plan.chunks):
        assert ch.delta.kind == DeltaEncoding.LOOKBACK
        assert all(vp.trivial or vp.launch_key is not None for vp in ch.var_plans.values())
        assert ci in plan.lookback_chunks
        assert ch.var_plans["primary"].moments.shape == (1, ch.delta.state_n)
    assert len(plan.lookback_desc) == len(plan.chunks)
    assert (plan.lookback_desc[:, cd.dec.LB_COLS.index("n_pages")] == 1).all()


def test_standalone_decode_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.decode_standalone_device(BLOBS["tiny_7"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.decode_standalone_with_device(BLOBS["tiny_7"])
