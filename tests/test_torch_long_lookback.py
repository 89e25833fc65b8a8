"""B7's plain version and the decode of lookback pages longer than K3's
shared memory (over kernels.LB_SMEM_MAX_N numbers) against the JAX package.

On the CPU B7 (decode.lookback_tiles) runs its plain version,
lookback_recon_chunks_plain, the same as K3's: a long row of it is held
against the JAX `xops._lookback_decode`, and a standalone lookback file
and PCT containers with such pages decode to the JAX package's host
numbers with their long pages in B7's one table. The CUDA kernel is held
against the plain version in test_torch_breadth_kernels.py. Every
comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pcodec_tpu.ops.decode as xops
from pcodec_tpu.codec.container import container_decompress as ref_decompress
from pcodec_tpu.codec.standalone import simple_decompress

import pcodec_tpu_torch as pt
from pcodec_tpu_torch.codec import standalone as port_standalone
from pcodec_tpu_torch.codec.chunk_config import ChunkConfig as PortChunkConfig
from pcodec_tpu_torch.codec.chunk_config import DeltaSpec as PortDeltaSpec
from pcodec_tpu_torch.ops import container_decode as cd
from pcodec_tpu_torch.ops import decode as dec
from pcodec_tpu_torch.ops import kernels
from pcodec_tpu_torch.ops import standalone_decode as sd

torch.set_num_threads(1)  # the test workers share the cores: more intra-op threads spin on theirs

COL = {name: i for i, name in enumerate(dec.LB_COLS)}


def _t(a):
    return dec._u64_to_tensor(np.asarray(a, dtype=np.uint64))


@pytest.mark.parametrize("N,state_n,window_n", [(20_000, 0, 1), (20_000, 3, 2**15), (40_000, 3, 1),
                                                (33_000, 0, 2**15)])
def test_long_row_plain_matches_jax(N, state_n, window_n):
    """One long row of lookback_recon_chunks_plain (B7's plain version)
    equals jax's xops._lookback_decode of the same page: lookbacks of 0 and
    past the window, wrapping u64 sums, a ragged row (n_valid short of the
    page)."""
    rng = np.random.default_rng(N + state_n + window_n)
    latents = rng.integers(0, 2**64, N, dtype=np.uint64)
    lbs = rng.integers(1, window_n + 1, N, dtype=np.uint64)
    lbs[::17] = 0
    lbs[3::29] = window_n + 1000
    states = rng.integers(0, 2**64, 32, dtype=np.uint64)
    ref = np.asarray(xops._lookback_decode(jnp.asarray(latents), jnp.asarray(lbs), jnp.asarray(states),
                                           jnp.int64(window_n), state_n, 64))
    n_valid = N - 123
    out = torch.full((N,), -77, dtype=torch.int64)
    row = [0, 0, 1, 0, 2, 0, 3, 0, 1, N, n_valid, state_n, window_n, 64, dec.JOIN_LATENTS, 0]
    dec.lookback_tiles([_t(latents), _t(lbs), _t(states[:state_n]), out], np.array([row], np.int64))
    got = out.numpy().view(np.uint64)
    assert np.array_equal(got[:n_valid], ref[:n_valid])
    assert (out[n_valid:] == -77).all()


def test_standalone_long_lookback_decodes_through_one_table():
    """A standalone TRY_LOOKBACK file of 50,000 numbers (one flat chunk of
    49 chains) decodes on the CPU to the JAX package's host numbers; its
    lookback vars are rows of B7's table, none of K3's, and the plan keeps
    no per-chunk lookback list."""
    rng = np.random.default_rng(21)
    nums = (np.tile(rng.integers(0, 10**6, 173), 290)[:50_000] + rng.integers(0, 2, 50_000)).astype(np.int64)
    cfg = PortChunkConfig(delta_spec=PortDeltaSpec("try_lookback", 0))
    blob = port_standalone.simple_compress(nums, cfg)
    ref, _ = simple_decompress(blob)
    assert np.array_equal(ref, nums)
    plan = sd.plan_standalone(blob)
    assert plan.chunks[0].delta.kind == "lookback" and plan.chunks[0].recon_pages[1] > kernels.LB_SMEM_MAX_N
    assert len(plan.lookback_desc) == 0 and len(plan.lookback_long_desc) == 1
    assert not hasattr(plan, "post_lookback")
    assert plan.lookback_long_desc[0, COL["join"]] == dec.JOIN_LATENTS
    assert np.array_equal(pt.decode_standalone_device(blob, device="cpu"), ref)


@pytest.mark.parametrize("mode", [("classic", 0.0), ("try_int_mult", 1000.0)])
def test_long_page_container_decodes_through_one_table(mode):
    """PCT containers of pages of 20,480 numbers (three chunks, a ragged
    last page) decode on the CPU to the JAX package's container_decompress;
    every lookback var is a B7 row of latents, which B3 joins."""
    rng = np.random.default_rng(22)
    n = 3 * 45_000
    nums = (np.tile(rng.integers(0, 10**6, 512), n // 512 + 1)[:n] + rng.integers(0, 2, n)).astype(np.int64)
    if mode[0] == "try_int_mult":
        nums *= 1000
    cfg = pt.ChunkConfig(mode_spec=pt.ModeSpec(*mode), delta_spec=pt.DeltaSpec("try_lookback", 0))
    data = pt.container_compress(nums, cfg, page_n=20_480, chunk_n=45_000)
    plan = cd.plan_container(data)
    long = plan.lookback_long_desc
    assert {ch.mode_kind for ch in plan.chunks} == {mode[0].replace("try_", "")}
    assert len(plan.lookback_desc) == 0 and len(long) >= len(plan.chunks)
    assert (long[:, COL["page_n"]] > kernels.LB_SMEM_MAX_N).all() and (long[:, COL["join"]] == dec.JOIN_LATENTS).all()
    assert len(plan.post_desc) == len(plan.chunks)
    out = pt.decode_container_device(data, device="cpu")
    assert np.array_equal(out, ref_decompress(data)) and np.array_equal(out, nums)
