"""The port's chain-major planner against the JAX package's planner.

`plan_container` of the port and `pallas_decode.plan_container` must compute
the same plan: per chain the absolute section cursors, the initial tANS
states, the body length and the fused moment, and per (chunk, var) the same
node and lower tables. `chain_plan_from_jax` carries the JAX (8, 128)
layout over; the comparison is exact. The JAX planner pads each table's
chains to 256 and the port's to 128, so rows are compared per (chunk, var).
"""

import numpy as np
import pytest
import torch

import pcodec_tpu.ops.pallas_decode as pd
from pcodec_tpu.codec.chunk_config import ChunkConfig as RefChunkConfig
from pcodec_tpu.codec.chunk_config import DeltaSpec as RefDeltaSpec
from pcodec_tpu.codec.container import container_compress as ref_compress

from pcodec_tpu_torch.ops import container_decode as cd

torch.set_num_threads(1)  # the test workers share the cores: more intra-op threads spin on theirs

RNG = np.random.default_rng(11)


def _taxi(n):
    incs = RNG.integers(0, 120, n) + (RNG.random(n) < 0.01) * RNG.integers(0, 10**6, n)
    return np.cumsum(incs).astype(np.int64)


CASES = {
    # name: (nums, delta order, page_n, chunk_n)
    "i64_o1_p256": (_taxi(4096), 1, 256, 1 << 20),
    "i64_o1_p1024_multichunk": (_taxi(6000), 1, 1024, 2048),
    "u64_o1_p256_ragged": (_taxi(2000).astype(np.uint64), 1, 256, 1 << 20),
    "i32_o2_p1024_ragged_multichunk": ((_taxi(5000) % 70000).astype(np.int32), 2, 1024, 3000),
    "u16_o0_p256": (RNG.integers(0, 9000, 3000).astype(np.uint16), 0, 256, 1 << 20),
    "i64_hi_entropy_p256": (RNG.integers(-2**62, 2**62, 1500, dtype=np.int64), 0, 256, 1 << 20),
}


def _jax_arrays(launch):
    return {k: getattr(launch, k) for k in ("schema", "tables", "tbl_ids", "starts_blk",
                                            "curs", "states0", "bodyn", "moments")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_equals_jax_plan(name):
    nums, order, page_n, chunk_n = CASES[name]
    kind = "try_consecutive" if order else "no_op"
    data = ref_compress(nums, RefChunkConfig(delta_spec=RefDeltaSpec(kind, order)),
                        page_n=page_n, chunk_n=chunk_n)
    ours = cd.plan_container(data)
    ref = pd.plan_container(data)
    assert len(ours.chunks) == len(ref.chunks)
    converted = {}
    compared = 0
    for ci, (cp, rcp) in enumerate(zip(ours.chunks, ref.chunks)):
        assert rcp.fallback is None, "the JAX planner sent this chunk to the host"
        assert np.array_equal(cp.page_ns, rcp.page_ns)
        for key, rvp in rcp.var_plans.items():
            vp = cp.var_plans[key]
            assert vp.trivial == rvp.trivial and vp.const_lower == rvp.const_lower
            assert np.array_equal(vp.moments, rvp.moments)
            if rvp.trivial:
                assert vp.launch_key is None
                continue
            launch = ref.launches[rvp.launch_key]
            if rvp.launch_key not in converted:
                # one bias per JAX table, in table order of that launch
                items = [v for c2 in ref.chunks for v in c2.var_plans.values()
                         if v.launch_key == rvp.launch_key]
                items.sort(key=lambda v: v.chain_start)
                bias = [v.bias for v in items]
                converted[rvp.launch_key] = cd.chain_plan_from_jax(_jax_arrays(launch), bias=bias)
            theirs = converted[rvp.launch_key]
            mine = ours.launches[vp.launch_key]
            assert mine.page_n == theirs.page_n == launch.schema.page_n
            assert mine.fuse == theirs.fuse
            a = slice(vp.chain_start, vp.chain_start + cp.n_pages)
            b = slice(rvp.chain_start, rvp.chain_start + cp.n_pages)
            for f in ("chain_bit0", "curs", "states0", "body_n", "moment0"):
                assert np.array_equal(getattr(mine, f)[a], getattr(theirs, f)[b]), f
            tm, tt = mine.table_id[a], theirs.table_id[b]
            assert (tm == tm[0]).all() and (tt == tt[0]).all()
            real = 1 << chunk_ts_log(cp, rcp, key, data)
            assert np.array_equal(mine.node[tm[0], :real], theirs.node[tt[0], :real])
            assert np.array_equal(mine.lower[tm[0], :real], theirs.lower[tt[0], :real])
            compared += 1
    assert compared > 0


def chunk_ts_log(cp, rcp, key, data):
    """log2 of the var's real table length (0 for a single bin)."""
    vm = rcp.meta.per_latent_var.get(key)
    return 0 if len(vm.bins) == 1 else vm.ans_size_log


def test_plan_pads_each_table_to_whole_blocks():
    nums = _taxi(5000)
    data = ref_compress(nums, RefChunkConfig(delta_spec=RefDeltaSpec("try_consecutive", 1)),
                        page_n=256, chunk_n=2000)
    plan = cd.plan_container(data)
    (cp,) = plan.launches.values()
    assert cp.n_chains % cd.CHAINS_PER_BLOCK == 0
    blocks = cp.table_id.reshape(-1, cd.CHAINS_PER_BLOCK)
    assert (blocks == blocks[:, :1]).all()
    assert cp.stage_words % 4 == 0
    # every chain's sections lie inside its staging row, ahead of the slack
    end = cp.curs[:, -1]
    assert ((end >> 5) - cp.word0 < cp.stage_words - cd.SLACK_WORDS).all()
