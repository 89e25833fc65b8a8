"""On the card: the sharded decode and encode (parallel/sharding.py) over
three shards of one card against the single-device paths, and the file
image of numbers already on the card (a CUDA tensor, with and without its
host copy) against the numpy route.

Every test is marked `gpu` and skips when there is no card. This file
imports no JAX, so on a GPU machine without JAX it runs as
`python -m pytest tests/test_torch_sharding_kernels.py --noconftest -m gpu`.
"""

import numpy as np
import pytest
import torch

import pcodec_tpu_torch as pt
from pcodec_tpu_torch.ops import assemble as asm
from pcodec_tpu_torch.ops import container_decode as cd
from pcodec_tpu_torch.parallel import sharding as sh

torch.set_num_threads(1)  # the test workers share the cores: more intra-op threads spin on theirs

SHARDS = ["cuda:0"] * 3


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _inputs():
    rng = np.random.default_rng(51)
    n = 3 * 8192 + 1000
    return {
        "classic_delta1": (np.cumsum(rng.integers(0, 3000, n)).astype(np.int64),
                           pt.ChunkConfig(delta_spec=pt.DeltaSpec(pt.DeltaSpec.TRY_CONSECUTIVE, 1))),
        "intmult_auto": ((np.cumsum(rng.integers(1, 30, n)) * 1000 + rng.integers(0, 4, n)).astype(np.int64),
                         pt.ChunkConfig()),
        "f64_auto": ((rng.integers(-5000, 5000, n) * 0.01).astype(np.float64), pt.ChunkConfig()),
        "dict": (np.array([3, 99, 1234567, -5], np.int64)[rng.integers(0, 4, n)],
                 pt.ChunkConfig(mode_spec=pt.ModeSpec(pt.ModeSpec.TRY_DICT))),
        "lookback": (np.tile(rng.integers(0, 10**6, 512), n // 512 + 1)[:n] + rng.integers(0, 2, n),
                     pt.ChunkConfig(delta_spec=pt.DeltaSpec(pt.DeltaSpec.TRY_LOOKBACK))),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(_inputs()))
def test_sharded_paths_on_one_card_equal_single_device(case):
    """Over three shards of one card the decode equals decode_container_tensor
    bit for bit and the encode equals encode_container_device's bytes."""
    _need_card()
    nums, cfg = _inputs()[case]
    data = pt.container_compress(nums, cfg, page_n=256, chunk_n=8192)
    want = cd.decode_container_tensor(data, "cuda")
    assert torch.equal(sh.sharded_container_decode_tensor(data, SHARDS), want)
    enc, stats = sh.sharded_container_encode(nums, cfg, SHARDS, page_n=256, chunk_n=8192)
    assert enc == pt.encode_container_device(nums, cfg, 256, 8192, device="cuda") == data
    assert len(stats["shards"]) == 3


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(_inputs()))
def test_image_from_a_cuda_tensor_equals_the_numpy_route(case):
    """plan_image from a CUDA tensor, with and without its host copy, gives
    the numpy route's image; without the copy no number reaches the host."""
    _need_card()
    nums, cfg = _inputs()[case]
    want = pt.encode_container_device(nums, cfg, 256, 8192, device="cuda")
    x = torch.from_numpy(nums).cuda()
    for mirror in (None, nums):
        plan = asm.plan_image(x, cfg, 256, 8192, "cuda", nums_host=mirror)
        assert plan.trained_on == "device" and plan.enc.host_copied == 0
        assert asm.file_image_to_bytes(*asm.run_image(plan, asm.upload_image(plan, "cuda"))) == want
