"""The port's standalone `.pco` decode on the card (K1-K4 from the
standalone planner) against its CPU route, bit for bit. No JAX: the files
are the port's own `simple_compress`; runs on the GPU machine with
`--noconftest -m gpu`. The CPU cases check the planner's chains."""

import numpy as np
import pytest
import torch

import pcodec_tpu_torch as pt
from pcodec_tpu_torch.codec.chunk_config import PagingSpec
from pcodec_tpu_torch.codec.standalone import simple_compress, simple_decompress
from pcodec_tpu_torch.ops import container_decode as cd
from pcodec_tpu_torch.ops import kernels
from pcodec_tpu_torch.ops import standalone_decode as sd

torch.set_num_threads(1)  # the test workers share the cores: more intra-op threads spin on theirs

RNG = np.random.default_rng(41)


def _case(name):
    """(numbers, config) of one standalone input: every mode and delta kind,
    fused chains, ragged chunks, a lookback chunk past K3's shared memory."""
    walk = np.cumsum(RNG.integers(0, 120, 9000)).astype(np.int64)
    t = np.arange(9000, dtype=np.float64)
    return {
        "i64_consecutive_fused_multichunk": (walk, pt.ChunkConfig(paging_spec=PagingSpec.equal_pages_up_to(4000))),
        "u64_consecutive_fused": (walk.astype(np.uint64), None),
        "i32_order3": ((np.cumsum(np.cumsum(walk % 7)) % 2_000_000).astype(np.int32),
                       pt.ChunkConfig(delta_spec=pt.DeltaSpec("try_consecutive", 3))),
        "f64_float_mult": ((RNG.integers(0, 1000, 9000) * 0.1).astype(np.float64), None),
        "f16_float_quant": (np.round(RNG.standard_normal(9000) * 16).astype(np.float16) / 16, None),
        "i64_int_mult": ((RNG.integers(0, 10**6, 9000) * 1_000_000_000).astype(np.int64), None),
        "i64_dict": (np.array([3, 99, 1234567, -5], np.int64)[RNG.integers(0, 4, 9000)],
                     pt.ChunkConfig(mode_spec=pt.ModeSpec("try_dict"))),
        "i32_conv1": ((1000 * np.sin(t * 0.01) + RNG.standard_normal(9000)).astype(np.int32),
                      pt.ChunkConfig(delta_spec=pt.DeltaSpec("try_conv1", 4))),
        "i64_lookback": (np.tile(RNG.integers(0, 1000, 64), 140).astype(np.int64),
                         pt.ChunkConfig(delta_spec=pt.DeltaSpec("try_lookback", 0))),
        "i64_lookback_long": (np.tile(RNG.integers(0, 10**6, 512), 40).astype(np.int64) + RNG.integers(0, 2, 20480),
                              pt.ChunkConfig(delta_spec=pt.DeltaSpec("try_lookback", 0))),
    }[name]


CASES = ["i64_consecutive_fused_multichunk", "u64_consecutive_fused", "i32_order3", "f64_float_mult",
         "f16_float_quant", "i64_int_mult", "i64_dict", "i32_conv1", "i64_lookback", "i64_lookback_long"]


@pytest.mark.parametrize("name", ["i64_consecutive_fused_multichunk", "i32_conv1", "i64_lookback_long"])
def test_standalone_chains_lie_inside_their_staging_rows(name):
    """Every chain's sections lie inside its K1 staging row, each table's
    chains fill whole K2 blocks, and the CPU route returns the numbers."""
    nums, cfg = _case(name)
    blob = simple_compress(nums, cfg)
    plan = sd.plan_standalone(blob)
    for cp in plan.launches.values():
        assert cp.page_n == sd.CHAIN_N and cp.n_chains % cd.CHAINS_PER_BLOCK == 0
        real = cp.body_n > 0
        assert ((cp.curs[real, -1] >> 5) - cp.word0[real] < cp.stage_words - cd.SLACK_WORDS).all()
    out = pt.decode_standalone_device(blob, device="cpu")
    assert np.array_equal(out.view(np.uint8), nums.view(np.uint8))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CASES)
def test_standalone_decode_on_card_equals_cpu_route(name):
    """Exact: both entry points on the card return the CPU route's numbers
    and the host decode's, K1 and K2 launched (K3 for a lookback chunk,
    its device-memory route past 16,384 numbers; K4 for a Dict chunk)."""
    _need_card()
    nums, cfg = _case(name)
    blob = simple_compress(nums, cfg)
    want = pt.decode_standalone_device(blob, device="cpu")
    before = dict(kernels.LAUNCHES)
    got = pt.decode_standalone_device(blob)
    torch.cuda.synchronize()
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))
    assert np.array_equal(got.view(np.uint8), simple_decompress(blob)[0].view(np.uint8))
    for k in ("section_gather", "chain_decode") + (("lookback_recon",) if "lookback" in name else ()) + (
            ("dict_join",) if "dict" in name else ()):
        assert kernels.LAUNCHES[k] > before[k], k
    out, seconds = pt.decode_standalone_with_device(blob, time_it=True)
    assert np.array_equal(out.view(np.uint8), want.view(np.uint8)) and seconds > 0
