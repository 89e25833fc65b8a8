"""The microbenchmark kernels of pcodec_tpu_torch/experiments on the card,
held bit for bit against their plain versions at small shapes.

Every test here is marked `gpu` and skips from inside the test when there is
no card. This file imports no JAX, so on a GPU machine without JAX it runs as
`python -m pytest tests/test_torch_experiments_kernels.py --noconftest -m gpu`.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pcodec_tpu_torch.experiments import micro_gather, pallas_bitonic, proto_dma, proto_realign
from pcodec_tpu_torch.experiments import proto_round_loop
from pcodec_tpu_torch.ops import kernels
from pcodec_tpu_torch.ops.row_sort import row_sort_u32, row_sort_u32_plain

torch.set_num_threads(1)  # the test workers share the cores: more intra-op threads spin on theirs

RNG = np.random.default_rng(51)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
@pytest.mark.parametrize("n_tiles,heavy,n_raw", [(1, 0, 1 << 16), (3, 5, 1 << 16), (9, 64, 1 << 16),
                                                 (40, 0, 1 << 16), (1200, 512, (1 << 16) + 100),
                                                 (3, 512, (1 << 20) + 100), (4, 7, (1 << 20) + 100)])
def test_dma_kernel_matches_plain_version(n_tiles, heavy, n_raw):
    """Exact: E1 on the card, starts at 0, 1,023 and anywhere in the last
    fetchable block, full-range words so the sums wrap; a raw with a
    trailing part-block, 512 rounds and more tiles than the tile pass holds
    in one wave (8 blocks of 256 threads an SM); the column sums of only
    the touched blocks (3 tiles' 768 touches of 1,024 blocks) and of every
    block from 4 tiles on."""
    _need_card()
    raw = _cuda(_i32(n_raw))
    last = (n_raw - 3072) // 1024 * 1024
    starts = RNG.integers(0, last + 1024, (n_tiles, 128)).astype(np.int32)
    starts[0, :4] = [last, 0, 1023, last + 1023]
    starts = _cuda(starts)
    got = _launched("proto_dma", lambda: proto_dma.dma_checksum(starts, raw, heavy))
    assert torch.equal(got, proto_dma.dma_checksum_plain(starts, raw, heavy))


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["gather_take", "gather_taa"])
@pytest.mark.parametrize("rows,ts,steps", [(1, 4, 37), (13, 64, 37), (64, 1024, 37), (3, 1 << 14, 37),
                                           (37, 1024, 37), (37, 1024, 0), (5, 1 << 16, 37)])
def test_gather_steps_kernels_match_plain_version(route, rows, ts, steps):
    """Exact: routes take and taa on the card, ragged row counts (37 rows
    fill no last block of route take's 4), no step, and tables from 16
    bytes to 64 KB a row (fewer rows a block in shared memory). Rows of
    2^16 entries (256 KB) fit no block: route take walks them through the
    read-only path, and route taa refuses them, launching nothing."""
    _need_card()
    table = _cuda(_i32((rows, ts)))
    idx0 = _cuda(RNG.integers(0, ts, (rows, 4)).astype(np.int32))
    fn = micro_gather.gather_take if route == "gather_take" else micro_gather.gather_taa
    tab = table.flatten() if route == "gather_take" else table
    if route == "gather_taa" and ts == 1 << 16:
        before = dict(kernels.LAUNCHES)
        with pytest.raises(RuntimeError, match="gather_taa kernel launch failed"):
            fn(tab, idx0, steps)
        assert kernels.LAUNCHES == before
        return
    got = _launched(route, lambda: fn(tab, idx0, steps))
    assert torch.equal(got, micro_gather.gather_steps_plain(table, idx0, steps))
    if route == "gather_take":  # TAKE_ROWS rows a block, 3 of 64 KB in an H100's 227 KB, none of 256 KB
        want_rows = {1 << 14: 3, 1 << 16: 0}.get(ts, micro_gather.TAKE_ROWS)
        assert micro_gather.take_route(ts, table.device)[0] == want_rows


# a call whose first index lies outside its table, on a fresh process's card
_OUTSIDE = {
    "proto_dma": "from pcodec_tpu_torch.experiments import proto_dma as m\n"
                 "raw = torch.zeros(1 << 16, dtype=torch.int32, device='cuda')\n"
                 "m.dma_checksum(torch.full((2, 128), (1 << 16) - 2048, dtype=torch.int32, device='cuda'), raw, 0)",
    "proto_dma, touched blocks": "from pcodec_tpu_torch.experiments import proto_dma as m\n"
                                 "raw = torch.zeros(1 << 20, dtype=torch.int32, device='cuda')\n"
                                 "m.dma_checksum(torch.full((1, 128), -1024, dtype=torch.int32, device='cuda'), raw, 0)",
    "gather_take": "from pcodec_tpu_torch.experiments import micro_gather as m\n"
                   "table = torch.zeros(4 * 1024, dtype=torch.int32, device='cuda')\n"
                   "m.gather_take(table, torch.full((4, 4), 1024, dtype=torch.int32, device='cuda'), 5)",
    "gather_taa": "from pcodec_tpu_torch.experiments import micro_gather as m\n"
                  "table = torch.zeros((6, 1024), dtype=torch.int32, device='cuda')\n"
                  "idx = torch.zeros((6, 4), dtype=torch.int32, device='cuda')\n"
                  "idx[5, 2] = 1024\n"
                  "m.gather_taa(table, idx, 5)",
}
# route row in registers (77) and a thread an element (1,000 and 3,000),
# one index of its last row past the row's end
for _width in (77, 1000, 3000):
    _OUTSIDE[f"gather_row, width {_width}"] = (
        "from pcodec_tpu_torch.experiments import micro_gather as m\n"
        f"tbl = torch.zeros((5, {_width}), dtype=torch.int32, device='cuda')\n"
        f"idx = torch.zeros((5, {_width}), dtype=torch.int32, device='cuda')\n"
        f"idx[4, {_width} - 1] = {_width}\n"
        "m.row_gather(tbl, idx)")


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", sorted(_OUTSIDE))
def test_kernel_traps_on_an_index_outside_its_table(kernel):
    """E1 (a section past raw's end, or before its start where the column
    sums read only the touched blocks), routes take and taa (a first index
    of TS, route taa's in a block's last warp) and route row (an index of
    the width, in each of its three forms) trap on the card: the process's next synchronize fails with a CUDA
    error and nothing after it runs. In a subprocess, since a trap spoils
    its process's CUDA context."""
    _need_card()
    code = f"import torch\n{_OUTSIDE[kernel]}\ntorch.cuda.synchronize()\nprint('no trap')"
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "no trap" not in r.stdout
    assert "CUDA error" in r.stderr


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
@pytest.mark.parametrize("rows,width", [(8, 128), (5, 77), (3, 1), (7, 32), (4097, 128), (5, 129), (4, 2048),
                                        (3, 3000)])
def test_row_gather_kernel_matches_plain_version(rows, width):
    """Exact: route row on the card, against its plain version and
    torch.gather, in each of its forms: a warp a row in registers (widths 1
    to 128, rows that fill no last block of ROW_WARPS) and a thread an
    element (129 to 3,000)."""
    _need_card()
    tbl, idx = _cuda(_i32((rows, width))), _cuda(RNG.integers(0, width, (rows, width)).astype(np.int32))
    got = _launched("gather_row", lambda: micro_gather.row_gather(tbl, idx))
    assert torch.equal(got, micro_gather.row_gather_plain(tbl, idx))
    assert torch.equal(got, torch.gather(tbl, 1, idx.long()))


@pytest.mark.gpu
@pytest.mark.parametrize("with_emit", [False, True])
@pytest.mark.parametrize("n_tiles,rounds", [(1, 0), (2, 7), (5, 64), (3, 100)])
def test_round_loop_kernel_matches_plain_version(n_tiles, rounds, with_emit):
    """Exact: E4b on the card, node entries of the full int32 range and
    initial states outside the table; tile counts that leave the last
    block's second tile empty; at 100 rounds every node's bits are 15, so
    the cursors pass word 127 and the windows wrap to the row's start."""
    _need_card()
    sec = _cuda(_i32((n_tiles, 256, 128)))
    node = _i32((8, 1024))
    node = _cuda(node | 15 if rounds == 100 else node)
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
