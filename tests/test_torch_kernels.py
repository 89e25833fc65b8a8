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


def _random_chains(ts, fuse, device):
    """A synthetic K2 launch: random staging words and two random tables of
    ts states (ANS widths 0-15, offset widths 0, 1, 33, 63 and 64, and 65
    and 127 at states 0 and 1: wider than the 64 bits an offset keeps),
    start states in and past the table, ragged body lengths (0, 1, 3, 255,
    257, not multiples of 4 or of 256: the chains past them inert), and
    cursors anywhere in the row: chain 0's sections start at its last bit
    and chain 1's at its last word, so their reads run past the row's end;
    chains 8 and 9 have every directory cursor past +-2^30 bits."""
    rng = np.random.default_rng(ts + 7 * fuse)
    n, page_n, W = 256, 512, 48
    B = page_n // 256
    stg = rng.integers(-(2**31), 2**31, (n, W)).astype(np.int32)
    word0 = rng.integers(0, 5000, n)
    rel = rng.integers(0, W * 32, (n, 2 * B))
    rel[0], rel[1] = W * 32 - 1, (W - 1) * 32
    rel[8] = [2**31 + 13, -(2**31) - 5, 2**40 + 7, -(2**35) + 3]
    rel[9] = [-(2**30) - 1, 2**30 + 33, -(2**44) - 30, 2**33 + 31]
    obs = np.array([0, 1, 33, 63, 64])[rng.integers(0, 5, (2, ts))]
    obs[:, :2] = [65, 127]
    node = rng.integers(0, 16, (2, ts)) | (obs << 4) | (rng.integers(0, ts, (2, ts)) << 11)
    body_n = rng.integers(0, page_n + 1, n)
    body_n[:10] = [page_n, page_n - 1, 0, 1, 3, 255, 257, 4 * 77 + 2, page_n, page_n]
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return (t(stg), t(word0), t(rel + (word0 << 5)[:, None]), t(rng.integers(0, ts + 3, (n, 4))), t(body_n),
            t(np.repeat(np.arange(2), 128)), t(node.astype(np.uint32).view(np.int32)),
            t(rng.integers(-(2**63), 2**63 - 1, (2, ts))), t(rng.integers(-(2**63), 2**63 - 1, n)), page_n, fuse)


RANDOM_CHAINS = [(ts, fuse) for ts in (16, 1024, 1 << 14) for fuse in (0, 1, 2)]


@pytest.mark.parametrize("fuse", [0, 1, 2])
def test_far_cursors_decode_as_at_their_clamped_bits(fuse):
    """Exact: chain_decode_plain decodes chains whose directory cursors lie
    past +-2^30 bits as it decodes them with each such cursor moved to
    +-2^30 keeping its low 5 bits, which is how K2 keeps its bit positions
    in 32 bits: a batch read from there reads only the row's last or first
    word, at the same shift."""
    args = list(_random_chains(16, fuse, "cpu"))
    base = (args[1] << 5)[:, None]
    rel, far = args[2] - base, 1 << 30
    moved = torch.where(rel > far, far + (rel & 31), torch.where(rel < -far, -far + (rel & 31), rel))
    assert int((moved != rel).sum()) == 8
    want = cd.chain_decode_plain(*args)
    args[2] = moved + base
    assert torch.equal(cd.chain_decode_plain(*args), want)


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


@pytest.mark.gpu
@pytest.mark.parametrize("ts,fuse", RANDOM_CHAINS)
def test_chain_decode_matches_plain_on_random_chains_on_card(ts, fuse):
    """Exact: K2 on the card (one counted launch) equals its plain version
    on synthetic chains: FUSE 0, 1 and 2, offsets of 0 to 64 bits and
    wider widths (65, 127) that reload the offset reader, ragged and inert
    chains, sections that end at the row's last word, directory cursors
    past +-2^30 bits, and tables up to 2^14 states, the largest K2 holds in
    shared memory."""
    _need_card()
    args = _random_chains(ts, fuse, "cuda")
    before = kernels.LAUNCHES["chain_decode"]
    got = cd.chain_decode(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["chain_decode"] == before + 1
    assert torch.equal(got, cd.chain_decode_plain(*args))
