"""K3 (lookback_recon) and K4 (dict_join) of the port, on their own.

The plain versions run here on the CPU, held against independent numpy
references and the port's host decoder; the tests marked `gpu` hold the
CUDA kernels against the plain versions bit for bit, on both routes of
each, and skip when there is no card. Every comparison is exact. This file
imports no JAX, so on a GPU machine without JAX it runs as
`python -m pytest tests/test_torch_breadth_kernels.py --noconftest -m gpu`.
"""

import numpy as np
import pytest
import torch

import pcodec_tpu_torch as pt
from pcodec_tpu_torch.delta import conv1_decode_in_place
from pcodec_tpu_torch.dtypes import NUMBER_TYPES_BY_NAME as TYPES
from pcodec_tpu_torch.format.metadata import DeltaEncoding
from pcodec_tpu_torch.ops import container_decode as cd
from pcodec_tpu_torch.ops import decode as dec
from pcodec_tpu_torch.ops import kernels

RNG = np.random.default_rng(404)
M64 = (1 << 64) - 1


def _pages(P, N, state_n, window_n):
    """u64 latents, lookbacks (some 0 and some past the window) and state,
    as int64 tensors."""
    lat = RNG.integers(0, 2**64, (P, N), dtype=np.uint64)
    lb = RNG.integers(1, window_n + 1, (P, N))
    lb[:, ::13] = 0
    lb[:, 5::31] = window_n + 77
    mom = RNG.integers(0, 2**64, (P, state_n), dtype=np.uint64)
    return (torch.from_numpy(lat.view(np.int64)), torch.from_numpy(lb), torch.from_numpy(mom.view(np.int64)))


def _serial_lookback(lat, lb, mom, window_n, state_n, bits):
    """The recurrence one position at a time, in python ints."""
    P, N = lat.shape
    out = np.zeros((P, N), dtype=np.uint64)
    for p in range(P):
        vals = []
        for i in range(N):
            if i < state_n:
                vals.append(int(mom[p, i]) & M64)
                continue
            k = i - state_n
            step = min(max(int(lb[p, k]), 1), window_n)
            prev = vals[i - step] if i - step >= 0 else 0
            vals.append((int(lat[p, k]) + (1 << (bits - 1)) + prev) & M64)
        out[p] = np.array(vals, dtype=np.uint64)
    return out


@pytest.mark.parametrize("P,N,state_n,window_n,bits", [(3, 256, 1, 256, 64), (2, 300, 40, 64, 32),
                                                        (1, 40, 64, 128, 16)])
def test_lookback_plain_matches_serial_recurrence(P, N, state_n, window_n, bits):
    """Exact, including state_n past 32 and past the page length."""
    lat, lb, mom = _pages(P, N, state_n, window_n)
    out = dec.lookback_decode_pages_plain(lat, lb, mom, window_n, state_n, bits)
    want = _serial_lookback(lat.numpy().view(np.uint64), lb.numpy(), mom.numpy().view(np.uint64),
                            window_n, state_n, bits)
    assert np.array_equal(out.numpy().view(np.uint64), want)


def test_dict_join_plain_clamps_like_the_format():
    """Exact: the low 32 bits of the index, clamped to the last entry."""
    table = torch.arange(10, dtype=torch.int64) * 1000 - 3
    prim = torch.tensor([0, 9, 10, 2**40 + 3, -1, 2**32 - 1], dtype=torch.int64)
    assert dec.dict_join_plain(prim, table).tolist() == [-3, 8997, 8997, 2997, 8997, 8997]


@pytest.mark.parametrize("order", [1, 4, 6])
def test_conv1_plain_matches_host_decoder(order):
    """Exact against the host's serial conv1 decode of one page."""
    nt = TYPES["i32"]
    n = 500
    lat = RNG.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    state = RNG.integers(0, 2**32, order, dtype=np.uint64).astype(np.uint32)
    weights = RNG.integers(-(1 << 12), 1 << 12, order).tolist()
    de = DeltaEncoding.conv1(12, int(RNG.integers(-(1 << 20), 1 << 20)), weights)
    host = lat.copy()  # the page's first `order` numbers are its state, then the decoded latents
    conv1_decode_in_place(de, state.copy(), host)
    out = dec.conv1_decode_pages(torch.from_numpy(lat.astype(np.int64))[None],
                                 torch.from_numpy(state.astype(np.int64))[None], weights, de.quantization,
                                 de.bias, order, nt.latent.bits)
    assert np.array_equal(out.numpy()[0], host.astype(np.int64))


def test_wrappers_take_plain_versions_on_cpu():
    lat, lb, mom = _pages(2, 256, 1, 256)
    table = torch.arange(5, dtype=torch.int64)
    before = dict(kernels.LAUNCHES)
    assert torch.equal(dec.lookback_recon(lat, lb, mom, 256, 1, 64),
                       dec.lookback_decode_pages_plain(lat, lb, mom, 256, 1, 64))
    assert torch.equal(dec.dict_join(lb[0], table), dec.dict_join_plain(lb[0], table))
    assert kernels.LAUNCHES == before  # plain versions launch nothing


@pytest.mark.parametrize("field", ["mode", "delta"])
def test_unknown_kinds_raise(field):
    """Only a mode or delta kind that the format does not know raises."""
    nums = (np.arange(600) * 7).astype(np.int64)
    cfg = pt.ChunkConfig(mode_spec=pt.ModeSpec("try_int_mult", 7.0), delta_spec=pt.DeltaSpec("try_lookback"))
    meta = cd.parse_container(pt.container_compress(nums, cfg, page_n=256)).chunk_metas[0]
    cd._check_supported(0, meta)
    if field == "mode":
        meta.mode.kind = "wavelet"
    else:
        meta.delta_encoding.kind = "wavelet"
    with pytest.raises(NotImplementedError, match=f"unknown {field}"):
        cd._check_supported(0, meta)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("P,N,state_n,window_n,bits", [
    (5, 256, 32, 2048, 64), (3, 1024, 1, 1024, 64), (2, 3000, 40, 5000, 16),  # shared memory
    (2, 16384, 2, 16384, 64), (3, 20000, 8, 30000, 32),  # the largest shared page; global memory
])
def test_lookback_recon_matches_plain_on_card(P, N, state_n, window_n, bits):
    _need_card()
    args = [t.cuda() for t in _pages(P, N, state_n, window_n)]
    before = kernels.LAUNCHES["lookback_recon"]
    got = dec.lookback_recon(*args, window_n, state_n, bits)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["lookback_recon"] == before + 1
    assert (N > kernels.LB_SMEM_MAX_N) == (N == 20000)
    assert torch.equal(got, dec.lookback_decode_pages_plain(*args, window_n, state_n, bits))


@pytest.mark.gpu
@pytest.mark.parametrize("D", [1, 4, 3000, "smem_max", "smem_max+1", 100_000])
def test_dict_join_matches_plain_on_card(D):
    _need_card()
    limit = kernels.dict_join_smem_entries("cuda")
    D = {"smem_max": limit, "smem_max+1": limit + 1}.get(D, D)
    table = torch.from_numpy(RNG.integers(0, 2**64, D, dtype=np.uint64).view(np.int64)).cuda()
    prim = torch.from_numpy(RNG.integers(0, D + 20, 300_000)).cuda()
    prim[::97] |= 5 << 32
    got = dec.dict_join(prim, table)
    torch.cuda.synchronize()
    assert torch.equal(got, dec.dict_join_plain(prim, table))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["lookback", "dict_100k", "float_mult_f32"])
def test_breadth_decode_on_card(case):
    """Exact: containers that run K3, K4 (table in global memory) and the
    softfloat FloatMult join decode on the card to their source."""
    _need_card()
    if case == "lookback":
        nums = np.tile(RNG.integers(0, 10**6, 300), 20).astype(np.int64)
        cfg = pt.ChunkConfig(delta_spec=pt.DeltaSpec("try_lookback"))
    elif case == "dict_100k":
        vals = RNG.integers(-(10**12), 10**12, 100_000)
        nums = vals[np.concatenate([RNG.permutation(100_000), RNG.integers(0, 100_000, 300_000)])]
        cfg = pt.ChunkConfig(mode_spec=pt.ModeSpec("try_dict"))
    else:
        nums = (RNG.integers(-5000, 5000, 6000) * np.float32(0.01)).astype(np.float32)
        nums[::101] = np.nan
        cfg = pt.ChunkConfig(mode_spec=pt.ModeSpec("try_float_mult", 0.01))
    data = pt.container_compress(nums, cfg, page_n=1024)
    before = dict(kernels.LAUNCHES)
    got = pt.decode_container_device(data, device="cuda")
    assert np.array_equal(got.view(np.uint8), nums.view(np.uint8))
    name = {"lookback": "lookback_recon", "dict_100k": "dict_join"}.get(case)
    if name:
        assert kernels.LAUNCHES[name] > before[name]
