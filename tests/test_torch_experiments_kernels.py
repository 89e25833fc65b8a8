"""The microbenchmark kernels of pcodec_tpu_torch/experiments on the card,
held bit for bit against their plain versions at small shapes.

Every test here is marked `gpu` and skips from inside the test when there is
no card. This file imports no JAX, so on a GPU machine without JAX it runs as
`python -m pytest tests/test_torch_experiments_kernels.py --noconftest -m gpu`.
"""

import numpy as np
import pytest
import torch

from pcodec_tpu_torch.experiments import micro_gather, pallas_bitonic, proto_dma, proto_realign
from pcodec_tpu_torch.experiments import proto_round_loop
from pcodec_tpu_torch.ops import kernels
from pcodec_tpu_torch.ops.row_sort import row_sort_u32, row_sort_u32_plain

RNG = np.random.default_rng(51)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _cuda(a):
    return torch.from_numpy(np.ascontiguousarray(a)).cuda()


def _launched(name, fn):
    before = kernels.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    return out


def _i32(shape, lo=-(2**31), hi=2**31):
    return RNG.integers(lo, hi, shape, dtype=np.int64).astype(np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("n_groups,n_rows", [(1, 24), (2, 1024), (37, 4096)])
def test_realign_kernel_matches_plain_version(n_groups, n_rows):
    """Exact: E5 on the card, block indices up to the last full fetch."""
    _need_card()
    raw2d = _cuda(_i32((n_rows, 128)))
    st = RNG.integers(0, n_rows // 8 - 2, n_groups * 8).astype(np.int32)
    st[0] = n_rows // 8 - 3
    st = _cuda(st)
    got = _launched("proto_realign", lambda: proto_realign.realign(st, raw2d))
    assert torch.equal(got, proto_realign.realign_plain(st, raw2d))


@pytest.mark.gpu
@pytest.mark.parametrize("n_tiles,heavy", [(1, 0), (3, 5), (9, 64), (40, 0)])
def test_dma_kernel_matches_plain_version(n_tiles, heavy):
    """Exact: E1 on the card, more tiles than blocks a chain group so the
    double buffer turns over, starts in the last fetchable block."""
    _need_card()
    raw = _cuda(_i32(1 << 16))
    starts = RNG.integers(0, (1 << 16) - 3072, (n_tiles, 128)).astype(np.int32)
    starts[0, :3] = [(1 << 16) - 3072, 0, 1023]
    starts = _cuda(starts)
    got = _launched("proto_dma", lambda: proto_dma.dma_checksum(starts, raw, heavy))
    assert torch.equal(got, proto_dma.dma_checksum_plain(starts, raw, heavy))


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["gather_take", "gather_taa"])
@pytest.mark.parametrize("rows,ts", [(1, 4), (13, 64), (64, 1024), (3, 1 << 14)])
def test_gather_steps_kernels_match_plain_version(route, rows, ts):
    """Exact: routes take and taa on the card, ragged row counts and tables
    from 16 bytes to 64 KB a row (fewer rows a block in shared memory)."""
    _need_card()
    table = _cuda(_i32((rows, ts)))
    idx0 = _cuda(RNG.integers(0, ts, (rows, 4)).astype(np.int32))
    fn = micro_gather.gather_take if route == "gather_take" else micro_gather.gather_taa
    tab = table.flatten() if route == "gather_take" else table
    got = _launched(route, lambda: fn(tab, idx0, 37))
    assert torch.equal(got, micro_gather.gather_steps_plain(table, idx0, 37))


@pytest.mark.gpu
@pytest.mark.parametrize("steps", [0, 1, 300, 6144])
@pytest.mark.parametrize("rows", [1, 8, 19, 64])
def test_lane_kernel_matches_plain_version(rows, steps):
    """Exact: route lane's pointer doubling on the card against the step
    loop, wrapping int32 sums, no step and one, the experiment's 6,144, and
    up to 64 rows (a block a row)."""
    _need_card()
    tbl, idx = _cuda(_i32((rows, 128))), _cuda(_i32((rows, 128)))
    got = _launched("gather_lane", lambda: micro_gather.lane_steps(tbl, idx, steps))
    assert torch.equal(got, micro_gather.lane_steps_plain(tbl, idx, steps))


@pytest.mark.gpu
@pytest.mark.parametrize("rows,width", [(8, 128), (5, 77)])
def test_row_gather_kernel_matches_plain_version(rows, width):
    """Exact: route row on the card, against its plain version and
    torch.gather."""
    _need_card()
    tbl, idx = _cuda(_i32((rows, width))), _cuda(RNG.integers(0, width, (rows, width)).astype(np.int32))
    got = _launched("gather_row", lambda: micro_gather.row_gather(tbl, idx))
    assert torch.equal(got, micro_gather.row_gather_plain(tbl, idx))
    assert torch.equal(got, torch.gather(tbl, 1, idx.long()))


@pytest.mark.gpu
@pytest.mark.parametrize("with_emit", [False, True])
@pytest.mark.parametrize("n_tiles,rounds", [(1, 0), (2, 7), (5, 64)])
def test_round_loop_kernel_matches_plain_version(n_tiles, rounds, with_emit):
    """Exact: E4b on the card, node entries of the full int32 range and
    initial states outside the table."""
    _need_card()
    sec = _cuda(_i32((n_tiles, 256, 128)))
    node = _cuda(_i32((8, 1024)))
    state = RNG.integers(0, 1024, (n_tiles, 8, 128)).astype(np.int32)
    state[0, :, :5] = [-7, 1024, 5000, -(2**31), 2**31 - 1]
    state = _cuda(state)
    got = _launched("proto_round_loop", lambda: proto_round_loop.round_loop(sec, node, state, rounds, with_emit))
    want = proto_round_loop.round_loop_plain(sec, node, state, rounds, with_emit)
    for a, b in zip(got, want) if with_emit else ((got, want),):
        assert torch.equal(a, b)


def _sort_keys(rows, m):
    """u32 keys as int32 on the card: a run of ties, both ends of the range."""
    x = RNG.integers(0, 1 << 32, (rows, m), dtype=np.uint64).astype(np.uint32)
    x[:, : m // 3] = x[:, :1]
    x[:, -2:] = [0, 0xFFFFFFFF]
    return _cuda(x.view(np.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("rows,m", [(3, 2), (5, 16), (8, 256), (16, 1024), (2, 1 << 15), (5, 1 << 16),
                                    (140, 1 << 16), (2, 1 << 17), (2, 1 << 18), (2, 1 << 19), (1, 1 << 21),
                                    (1, 1 << 22)])
def test_cluster_sort_matches_plain_version(rows, m):
    """Exact: E2 on the card, a thread a row under 32 keys, clusters of 1, 2,
    4 and 8 blocks, 140 rows of 2^16 (more than one wave of 66 rows, two
    blocks an SM's row, in the layout before), rows past a tile of 2^17
    (2^18 to 2^22 keys: device-memory passes of 1 to 5 bits), keys with
    ties and both ends of the u32 range, against the plain network and K8's
    plain version."""
    _need_card()
    x = _sort_keys(rows, m)
    got = _launched("bitonic_cluster", lambda: pallas_bitonic.sort_rows_u32(x))
    assert torch.equal(got, pallas_bitonic.sort_rows_u32_plain(x))
    assert torch.equal(got, row_sort_u32_plain(x))


@pytest.mark.gpu
@pytest.mark.parametrize("rows,m", [(3, 2), (5, 1 << 16)])
def test_k8_u32_route_matches_plain_version(rows, m):
    """Exact: K8 on u32 keys (E2's yardstick and its route past a cluster)
    on the card, ties and both ends of the u32 range, into a new tensor."""
    _need_card()
    x = RNG.integers(0, 1 << 32, (rows, m), dtype=np.uint64).astype(np.uint32)
    x[:, : m // 3] = x[:, :1]
    x[:, -2:] = [0, 0xFFFFFFFF]
    x = _cuda(x.view(np.int32))
    keep = x.clone()
    got = _launched("row_sort", lambda: row_sort_u32(x))
    assert torch.equal(got, row_sort_u32_plain(x))
    assert torch.equal(x, keep)


@pytest.mark.gpu
def test_cluster_sort_sorts_rows_longer_than_a_cluster_holds():
    """E2's wrapper sorts rows of 2^19 and 2^21 keys (numpy's sort), one C
    call each, and still raises for a row that is not a power of two,
    launching nothing."""
    _need_card()
    for m in (1 << 19, 1 << 21):
        x = _sort_keys(1, m)
        got = _launched("bitonic_cluster", lambda: pallas_bitonic.sort_rows_u32(x))
        assert np.array_equal(got.cpu().numpy().view(np.uint32), np.sort(x.cpu().numpy().view(np.uint32), axis=1))
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="power-of-two"):
        pallas_bitonic.sort_rows_u32(torch.zeros((1, 3 << 17), dtype=torch.int32, device="cuda"))
    assert kernels.LAUNCHES == before
