"""K1 (section_gather) and K2 (chain_decode) of the port, on their own.

The plain versions run here on the CPU; the tests marked `gpu` hold the
CUDA kernels against the plain versions bit for bit and skip when there is
no card. This file imports no JAX, so on a GPU machine without JAX it runs
as `python -m pytest tests/test_torch_kernels.py --noconftest -m gpu`.
"""

import numpy as np
import pytest
import torch

import pcodec_tpu_torch as pt
from pcodec_tpu_torch.ops import container_decode as cd
from pcodec_tpu_torch.ops import decode as dec
from pcodec_tpu_torch.ops import kernels

RNG = np.random.default_rng(99)


def _container(dtype, order, page_n, n=20000, chunk_n=7000):
    if np.dtype(dtype).kind == "f":
        nums = np.cumsum(RNG.standard_normal(n)).astype(dtype)
    else:
        nums = np.cumsum(RNG.integers(0, 300, n)).astype(dtype)
    kind = "try_consecutive" if order else "no_op"
    cfg = pt.ChunkConfig(mode_spec=pt.ModeSpec("classic"), delta_spec=pt.DeltaSpec(kind, order))
    return nums, pt.container_compress(nums, cfg, page_n=page_n, chunk_n=chunk_n)


def _launch_args(plan, dev, lkey):
    cp, a = plan.launches[lkey], dev.launches[lkey]
    stg = cd.section_gather(dev.words, a["word0"], cp.stage_words)
    return stg, (stg, a["word0"], a["curs"], a["states0"], a["body_n"], a["table_id"],
                 a["node"], a["lower"], a["moment0"], cp.page_n)


def test_section_gather_plain_matches_numpy_slices():
    """Exact: each row is the container slice at word0, then zero slack."""
    words = RNG.integers(-(2**31), 2**31, 400, dtype=np.int64).astype(np.int32)
    word0 = np.array([0, 3, 17, 390, 399], dtype=np.int64)
    W = 12
    out = cd.section_gather(torch.from_numpy(words), torch.from_numpy(word0), W).numpy()
    for row, w0 in zip(out, word0):
        want = np.zeros(W, np.int32)
        src = words[w0 : w0 + W - cd.SLACK_WORDS]
        want[: len(src)] = src
        assert np.array_equal(row, want)


@pytest.mark.parametrize("dtype", [np.int64, np.uint64])
def test_fused_chain_decode_equals_latents_then_post(dtype):
    """Exact: K2's fused form (order-1 delta + Classic join in the kernel)
    gives the bits that its latent form followed by the plain post gives."""
    nums, data = _container(dtype, 1, 256, n=3000, chunk_n=3000)
    plan = cd.plan_container(data)
    dev = cd.upload_plan(plan, "cpu")
    (lkey,) = plan.launches
    _, args = _launch_args(plan, dev, lkey)
    fuse = plan.launches[lkey].fuse
    assert fuse == (1 if dtype == np.int64 else 2)
    fused = cd.chain_decode(*args, fuse)
    lat = cd.chain_decode(*args, 0)
    (cp,) = plan.chunks
    moments = cd._u64_to_tensor(cp.var_plans["primary"].moments)
    rows = slice(0, cp.n_pages)
    post = dec.from_latent_ordered(plan.nt, dec.consecutive_decode_batched(lat[rows], moments, 1, 64))
    assert torch.equal(cd.trim_pages(fused[rows], cp), cd.trim_pages(post, cp))


def test_wrappers_take_plain_versions_on_cpu():
    _, data = _container(np.int64, 1, 1024, n=3000)
    plan = cd.plan_container(data)
    dev = cd.upload_plan(plan, "cpu")
    before = dict(kernels.LAUNCHES)
    (lkey,) = plan.launches
    stg, args = _launch_args(plan, dev, lkey)
    assert torch.equal(stg, cd.section_gather_plain(dev.words, dev.launches[lkey]["word0"],
                                                    plan.launches[lkey].stage_words))
    assert torch.equal(cd.chain_decode(*args, 1), cd.chain_decode_plain(*args, 1))
    assert kernels.LAUNCHES == before  # plain versions launch nothing


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["i64_o1_p1024", "u64_o1_p256", "i32_o2_p256", "f64_o0_p2048"])
def test_kernels_match_plain_versions_on_card(case):
    """Exact: K1 and K2 on the card equal their plain versions, and the
    decode through them equals the source numbers."""
    _need_card()
    dtype, order, page_n = {
        "i64_o1_p1024": (np.int64, 1, 1024), "u64_o1_p256": (np.uint64, 1, 256),
        "i32_o2_p256": (np.int32, 2, 256), "f64_o0_p2048": (np.float64, 0, 2048),
    }[case]
    nums, data = _container(dtype, order, page_n)
    plan = cd.plan_container(data)
    dev = cd.upload_plan(plan, "cuda")
    before = dict(kernels.LAUNCHES)
    for lkey, cp in plan.launches.items():
        stg, args = _launch_args(plan, dev, lkey)
        assert torch.equal(stg, cd.section_gather_plain(dev.words, args[1], cp.stage_words))
        assert torch.equal(cd.chain_decode(*args, cp.fuse), cd.chain_decode_plain(*args, cp.fuse))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["section_gather"] > before["section_gather"]
    assert kernels.LAUNCHES["chain_decode"] > before["chain_decode"]
    got = cd.to_numbers(cd.decode_plan(plan, dev), plan.nt)
    assert np.array_equal(got.view(np.uint8), nums.view(np.uint8))


@pytest.mark.gpu
def test_kernel_wrappers_refuse_wrong_arguments_on_card():
    _need_card()
    words = torch.zeros(64, dtype=torch.int64, device="cuda")
    word0 = torch.zeros(8, dtype=torch.int64, device="cuda")
    with pytest.raises(ValueError):
        cd.section_gather(words, word0, 8)  # words must be int32
