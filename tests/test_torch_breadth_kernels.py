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
from pcodec_tpu_torch.codec import compress as port_compress
from pcodec_tpu_torch.delta import conv1_decode_in_place
from pcodec_tpu_torch.dtypes import NUMBER_TYPES_BY_NAME as TYPES
from pcodec_tpu_torch.format.metadata import DeltaEncoding
from pcodec_tpu_torch.ops import container_decode as cd
from pcodec_tpu_torch.ops import decode as dec
from pcodec_tpu_torch.ops import kernels

torch.set_num_threads(1)  # the test workers share the cores: more intra-op threads spin on theirs

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


def dict_container(case):
    """Numbers and config of a three-chunk TRY_DICT container (chunk_n
    3,000): every chunk Dict ("dict", and "consecutive" under an order-1
    delta), or a Classic chunk of high-entropy numbers between two Dict
    chunks ("mixed")."""
    rng = np.random.default_rng(77)
    four = np.array([3, 99, 1234567, -5], np.int64)[rng.integers(0, 4, 3000)]
    forty = rng.integers(-(10**12), 10**12, 40)[rng.integers(0, 40, 2500)]
    middle = rng.integers(-(2**62), 2**62, 3000) if case == "mixed" else four[::-1]
    delta = ("try_consecutive", 1) if case == "consecutive" else ("no_op", 0)
    cfg = pt.ChunkConfig(mode_spec=pt.ModeSpec("try_dict"), delta_spec=pt.DeltaSpec(*delta))
    return np.concatenate([four, middle, forty]).astype(np.int64), cfg


def _dict_join_calls(data, device, name="dict_join_chunks"):
    """Decode on `device`, recording the arguments of every container-level
    K4 call (or of the wrapper `name` of ops/decode.py); returns (plan,
    decoded bits, calls)."""
    plan = cd.plan_container(data)
    calls = []
    saved = getattr(dec, name)

    def record(*args):
        calls.append(args)
        return saved(*args)

    setattr(dec, name, record)
    try:
        got = cd.decode_container_tensor(data, device, plan)
    finally:
        setattr(dec, name, saved)
    return plan, got, calls


@pytest.mark.parametrize("case", ["dict", "consecutive", "mixed"])
def test_dict_join_chunks_plain_is_the_per_chunk_join(case):
    """Exact: the container-level plain K4 equals each Dict chunk's
    dict_join_plain on its trimmed latents and its own table, concatenated;
    one call per decode, the decode equal to the source."""
    nums, cfg = dict_container(case)
    data = pt.container_compress(nums, cfg, page_n=256, chunk_n=3000)
    plan, got, calls = _dict_join_calls(data, "cpu")
    assert np.array_equal(got.numpy(), nums)
    assert [plan.chunks[ci].mode_kind for ci in range(3)] == ["dict", "classic" if case == "mixed" else "dict", "dict"]
    ((bases, desc, table, out),) = calls
    joined = dec.dict_join_chunks_plain(bases, desc, table, torch.zeros_like(out))
    per_chunk = [dec.dict_join_plain(bases[b].reshape(-1)[start : start + plan.chunks[ci].n],
                                     torch.from_numpy(plan.chunks[ci].dict_table))
                 for ci, (b, start) in zip(plan.dict_chunks, desc[:, :2].tolist())]
    assert torch.equal(torch.cat([joined[plan.offsets[ci] : plan.offsets[ci + 1]] for ci in plan.dict_chunks]),
                       torch.cat(per_chunk))


LB_CASES = ["i64_p1024", "i32_p256", "u16_p256", "f32_p1024", "i64_state_n_4", "int_mult", "dict"]


def lookback_container(case, monkeypatch):
    """Numbers and bytes of a TRY_LOOKBACK container of 7,000 numbers in
    chunks of 3,000 (three chunks, the last page of each ragged): Classic
    i64, i32, u16 and f32 (state_n 1, as the encoder makes it), i64 with a
    stored state of 4 latents (state_n_log 2, the encoder's new_lookback
    monkeypatched), and IntMult and Dict chunks under lookback."""
    rng = np.random.default_rng(LB_CASES.index(case) + 90)
    n = 7000
    pattern = rng.integers(0, 50_000, 61)
    reps = np.tile(pattern, n // 61 + 1)[:n] + rng.integers(0, 2, n)
    mode = ("classic", 0.0)
    if case == "i64_state_n_4":
        monkeypatch.setattr(port_compress, "new_lookback",
                            lambda k: DeltaEncoding.lookback(max(6, (k - 1).bit_length()), 2))
    if case == "int_mult":
        nums, mode = (reps * 1000 + rng.integers(0, 3, n)).astype(np.int64), ("try_int_mult", 1000.0)
    elif case == "dict":
        nums = np.array([3, 99, 1234567, -5, 77], np.int64)[np.tile(rng.integers(0, 5, 61), n // 61 + 1)[:n]]
        mode = ("try_dict", 0.0)
    else:
        dtype = {"i64": np.int64, "i32": np.int32, "u16": np.uint16, "f32": np.float32}[case.split("_")[0]]
        nums = (reps * 0.5).astype(dtype) if dtype == np.float32 else reps.astype(dtype)
    cfg = pt.ChunkConfig(mode_spec=pt.ModeSpec(*mode), delta_spec=pt.DeltaSpec("try_lookback"))
    page_n = 256 if "p256" in case or case in ("int_mult", "dict") else 1024
    return nums, pt.container_compress(nums, cfg, page_n=page_n, chunk_n=3000)


@pytest.mark.parametrize("case", LB_CASES)
def test_lookback_recon_chunks_plain_is_the_per_chunk_join(case, monkeypatch):
    """Exact: the container-level plain K3 (one call a decode) equals, for
    each lookback chunk, lookback_decode_pages_plain on its launch rows,
    then trim_pages and, for a Classic chunk, the Classic join into the
    output at the chunk's offset (other chunks' latents in the scratch);
    the decode equals the host container_decompress and the source."""
    nums, data = lookback_container(case, monkeypatch)
    plan, got, calls = _dict_join_calls(data, "cpu", "lookback_recon_chunks")
    ((bases, desc, _),) = calls
    assert np.array_equal(cd.to_numbers(got, plan.nt).view(np.uint8), nums.view(np.uint8))
    assert np.array_equal(pt.container_decompress(data).view(np.uint8), nums.view(np.uint8))
    named = dict(zip(plan.lookback_bases, bases))
    assert len(plan.chunks) == 3 and plan.lookback_chunks == {0, 1, 2} and len(desc) == 3

    def rows_of(vp, cp):
        if vp.trivial:
            return torch.full((cp.n_pages, cp.page_n), dec._i64(vp.const_lower), dtype=torch.int64)
        return named[("launch", vp.launch_key)][vp.chain_start : vp.chain_start + cp.n_pages]

    for ci in sorted(plan.lookback_chunks):
        cp = plan.chunks[ci]
        assert cp.page_ns[-1] < cp.page_n  # a ragged last page
        vp, de = cp.var_plans["primary"], cp.delta
        assert de.state_n == (4 if case == "i64_state_n_4" else 1)
        rec = dec.lookback_decode_pages_plain(rows_of(vp, cp), rows_of(cp.var_plans["delta"], cp),
                                              torch.from_numpy(vp.moments.view(np.int64)), de.window_n,
                                              de.state_n, vp.bits)
        lat = cd.trim_pages(rec, cp)
        if cp.mode_kind == "classic":
            assert torch.equal(got[plan.offsets[ci] : plan.offsets[ci + 1]],
                               dec.join_mem(plan.nt, "classic", 0, lat, None))
        else:
            at = plan.lookback_scratch[(ci, "primary")]
            assert torch.equal(named[("scratch",)][at : at + cp.n], lat)
    assert max(plan.chunks[ci].n_pages for ci in plan.lookback_chunks) > 1
    assert {plan.chunks[ci].mode_kind for ci in plan.lookback_chunks} == {
        {"int_mult": "int_mult", "dict": "dict"}.get(case, "classic")}


def _random_lookback_table(seed):
    """A random K3 table over five tensors (latents, lookbacks with some 0
    and past the window, stored states, an output and a scratch, both
    filled with -77): Classic rows (unsigned, signed and float joins) and
    latent rows, ragged last pages, rows starting at odd numbers (no 16-byte
    loads), trivial latents and lookbacks, state_n 0 to 40 (past the page),
    latent bits 8 to 64, page lengths 1 to 16,384. Returns (bases, desc)."""
    rng = np.random.default_rng(seed)
    specs = [  # P, N, n, state_n, window_n, bits, join, lat trivial, lb trivial
        (3, 1024, 3000, 1, 1024, 64, 2, False, False), (2, 256, 300, 4, 64, 32, 0, False, False),
        (4, 1000, 3999, 40, 5000, 16, 3, False, False), (1, 256, 77, 0, 256, 8, 1, False, True),
        (2, 512, 1024, 2, 512, 64, 0, True, False), (1, 30, 30, 64, 30, 32, 2, False, False),
        (5, 256, 1201, 1, 10, 64, 3, True, True), (1, 1, 1, 1, 1, 64, 1, False, False),
        (2, 16384, 20000, 8, 30000, 64, 2, False, False),
    ]
    n_lat = sum(p * n for p, n, *_ in specs) + 2 * len(specs)
    lat = torch.from_numpy(rng.integers(0, 2**64, n_lat, dtype=np.uint64).view(np.int64))
    lbs = rng.integers(1, 1025, n_lat)
    lbs[::13] = 0
    lbs[5::31] = 10**6
    mom = torch.from_numpy(rng.integers(0, 2**64, sum(p * s for p, _, _, s, *_ in specs), dtype=np.uint64)
                           .view(np.int64))
    out = torch.full((sum(s[2] for s in specs if s[6]),), -77, dtype=torch.int64)
    scratch = torch.full((sum(s[2] for s in specs if not s[6]),), -77, dtype=torch.int64)
    rows, at, mo, oo, so, page0 = [], 0, 0, 0, 0, 0
    for i, (P, N, nv, sn, wn, bits, join, lat_t, lb_t) in enumerate(specs):
        at += i % 2  # every other row starts at an odd number
        src_lat = (-1, int(rng.integers(-(2**63), 2**63))) if lat_t else (0, at)
        src_lb = (-1, int(rng.integers(0, 2 * wn))) if lb_t else (1, at)
        dst = (3, oo) if join else (4, so)
        rows.append([*src_lat, *src_lb, 2, mo, *dst, P, N, nv, sn, wn, bits, join, page0])
        at, mo, page0 = at + P * N, mo + P * sn, page0 + P
        oo, so = (oo + nv, so) if join else (oo, so + nv)
    return [lat, torch.from_numpy(lbs), mom, out, scratch], np.array(rows, np.int64)


def test_lookback_recon_chunks_plain_matches_per_row_pages():
    """Exact: on a random table, the plain K3 writes each row's first n
    numbers of lookback_decode_pages_plain over its pages, joined, at its
    output offset, and nothing else of the output or the scratch."""
    bases, desc = _random_lookback_table(7)
    before = dict(kernels.LAUNCHES)
    got = [b.clone() for b in bases]
    dec.lookback_recon_chunks(got, desc)
    assert kernels.LAUNCHES == before  # the plain version on the CPU
    written = [torch.zeros(b.shape, dtype=torch.bool) for b in bases]
    for r in desc.tolist():
        (lb_, ls, bb, bs_, mb, ms, ob, os_, P, N, nv, sn, wn, bits, join, _) = r
        lat = torch.full((P * N,), ls) if lb_ < 0 else torch.cat([bases[0][ls : ls + nv], torch.zeros(P * N - nv,
                                                                   dtype=torch.int64)])
        lb = torch.full((P * N,), bs_) if bb < 0 else torch.cat([bases[1][bs_ : bs_ + nv],
                                                                 torch.zeros(P * N - nv, dtype=torch.int64)])
        rec = dec.lookback_decode_pages_plain(lat.view(P, N), lb.view(P, N), bases[2][ms : ms + P * sn].view(P, sn),
                                              wn, sn, bits).reshape(-1)[:nv]
        assert torch.equal(got[ob][os_ : os_ + nv], dec.ordered_join(join, bits, rec))
        written[ob][os_ : os_ + nv] = True
    for i in (3, 4):
        assert bool(written[i].all()) and torch.equal(got[i][~written[i]], bases[i][~written[i]])


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
    # a one-row table in shared memory, or the device-memory route's prologue and rounds
    kernels_n = 1 if N <= kernels.LB_SMEM_MAX_N else 1 + dec.lookback_rounds(N)
    assert kernels.LAUNCHES["lookback_recon"] == before + kernels_n
    assert (N > kernels.LB_SMEM_MAX_N) == (N == 20000)
    assert torch.equal(got, dec.lookback_decode_pages_plain(*args, window_n, state_n, bits))


@pytest.mark.gpu
@pytest.mark.parametrize("seed,threads", [(7, 256), (8, 128), (9, 1024)])
def test_lookback_recon_chunks_matches_plain_on_card(seed, threads, monkeypatch):
    """Exact: one counted K3 launch on a random table (Classic and latent
    rows, ragged pages, odd starts, trivial vars, state_n past the page,
    pages of 1 to 16,384 numbers) equals the plain version in both
    outputs, at blocks of 128, 256 and 1,024 threads."""
    _need_card()
    monkeypatch.setattr(kernels, "K3_THREADS", threads)
    bases, desc = _random_lookback_table(seed)
    bases = [b.cuda() for b in bases]
    want = bases[:3] + [b.clone() for b in bases[3:]]
    got = bases[:3] + [b.clone() for b in bases[3:]]
    before = kernels.LAUNCHES["lookback_recon"]
    dec.lookback_recon_chunks(got, desc, torch.from_numpy(desc).cuda())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["lookback_recon"] == before + 1
    dec.lookback_recon_chunks_plain(want, desc)
    for i in (3, 4):
        assert torch.equal(got[i], want[i])
        assert not bool((got[i] == -77).any())


@pytest.mark.gpu
def test_lookback_recon_chunks_refuses_wrong_arguments_on_card():
    """A row past its base, a page longer than shared memory holds, rows
    that do not follow each other, a base that is not int64, more bases
    than a launch carries and rows on the card that are not the table's
    are refused, and nothing is launched."""
    _need_card()
    bases, desc = _random_lookback_table(7)
    bases = [b.cuda() for b in bases]
    before = kernels.LAUNCHES["lookback_recon"]
    bad_rows = []
    for col, value in ((2, 7), (9, kernels.LB_SMEM_MAX_N + 256), (15, 1)):  # lb base, page_n, page0 of row 0
        bad = desc.copy()
        bad[0, col] = value
        bad_rows.append(bad)
    past = desc.copy()
    past[1, 10] = past[1, 8] * past[1, 9] + 1  # more numbers than its pages hold
    bad_rows.append(past)
    for bad in bad_rows:
        with pytest.raises(RuntimeError, match="lookback_recon kernel launch failed"):
            dec.lookback_recon_chunks(bases, bad)
    with pytest.raises(ValueError):
        dec.lookback_recon_chunks(bases[:3] + [bases[3].to(torch.int32)] + bases[4:], desc)
    with pytest.raises(ValueError):
        dec.lookback_recon_chunks(bases + [bases[0]] * kernels.LB_MAX_BASES, desc)
    with pytest.raises(ValueError):
        dec.lookback_recon_chunks(bases, desc, torch.from_numpy(desc[:-1]).cuda())
    assert kernels.LAUNCHES["lookback_recon"] == before


@pytest.mark.gpu
@pytest.mark.parametrize("case", LB_CASES)
def test_lookback_container_decode_one_launch_on_card(case, monkeypatch):
    """Exact: a multi-chunk lookback container (Classic of four number
    types, state_n 4, IntMult, Dict) decodes on the card to its source with
    exactly one K3 launch, which equals its plain version on the call's
    inputs."""
    _need_card()
    nums, data = lookback_container(case, monkeypatch)
    before = kernels.LAUNCHES["lookback_recon"]
    plan, got, calls = _dict_join_calls(data, "cuda", "lookback_recon_chunks")
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["lookback_recon"] == before + 1
    assert np.array_equal(cd.to_numbers(got, plan.nt).view(np.uint8), nums.view(np.uint8))
    ((bases, desc, desc_dev),) = calls
    outs = [i for i, key in enumerate(plan.lookback_bases) if key in (("out",), ("scratch",))]
    kern = [b.clone() if i in outs else b for i, b in enumerate(bases)]
    plain = [b.clone() if i in outs else b for i, b in enumerate(bases)]
    dec.lookback_recon_chunks(kern, desc, desc_dev)
    dec.lookback_recon_chunks_plain(plain, desc)
    for i in outs:
        assert torch.equal(kern[i], plain[i])


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
@pytest.mark.parametrize("route", ["shared_walk", "shared_tile", "global"])
def test_dict_join_chunks_matches_plain_on_card(route, monkeypatch):
    """Exact: one K4 launch joins chunks from a 2-D source, the same
    tensor read at an offset and in part, a view, a one-number chunk and an
    empty one into a buffer with gaps (the other chunks of a mixed
    container, which it leaves as they were), the concatenated table in
    shared memory (blocks walking tiles, or a block a tile) or in global
    memory."""
    _need_card()
    monkeypatch.setattr(kernels, "DICT_WALK_ENTRIES", 1 << 62 if route == "shared_tile" else 0)
    limit = kernels.dict_join_smem_entries("cuda")
    D = [4, limit, 1, 7, 5] if route == "global" else [4, 3000, 1, 7, 5]
    table = torch.from_numpy(RNG.integers(0, 2**64, sum(D), dtype=np.uint64).view(np.int64)).cuda()
    assert (table.shape[0] <= limit) == (route != "global")
    big = torch.from_numpy(RNG.integers(0, 4000, 9000)).cuda()
    big[::97] |= 5 << 32
    bases = [big[:3072].view(3, 1024), big, big[8100:]]
    base, start = [0, 1, 2, 0, 1], [0, 3072, 0, 5, 0]
    n = [3000, 4999, 900, 1, 0]
    off = [0, 3100, 8200, 9100, 9101]
    toff = np.cumsum(D) - D
    desc = np.stack([base, start, n, off, toff, D], 1)
    out = torch.full((9200,), -77, dtype=torch.int64, device="cuda")
    before = kernels.LAUNCHES["dict_join"]
    got = dec.dict_join_chunks(bases, desc, table, out.clone())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["dict_join"] == before + 1
    assert torch.equal(got, dec.dict_join_chunks_plain(bases, desc, table, out.clone()))
    bad = desc.copy()
    bad[2, 2] = 901  # one number past its base
    with pytest.raises(RuntimeError, match="dict_join kernel launch failed"):
        dec.dict_join_chunks(bases, bad, table, out.clone())
    assert int((got == -77).sum()) == 9200 - sum(n)


@pytest.mark.gpu
def test_dict_join_counts_each_kernel_on_card():
    """Exact: past the 96 chunks one launch carries, K4's call launches a
    kernel for each 96 and counts each of them."""
    _need_card()
    C = 200
    table = torch.from_numpy(RNG.integers(0, 2**64, 3 * C, dtype=np.uint64).view(np.int64)).cuda()
    src = torch.from_numpy(RNG.integers(0, 5, 10 * C)).cuda()
    desc = np.array([[0, 10 * c, 10, 10 * c, 3 * c, 3] for c in range(C)])
    before = kernels.LAUNCHES["dict_join"]
    got = dec.dict_join_chunks([src], desc, table, torch.empty_like(src))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["dict_join"] == before + 3
    assert torch.equal(got, dec.dict_join_chunks_plain([src], desc, table, torch.empty_like(src)))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["dict", "consecutive", "mixed"])
def test_dict_container_decode_one_launch_on_card(case):
    """Exact: a multi-chunk Dict container (all Dict, under a delta, or
    mixed with a Classic chunk) decodes on the card to its source with one
    K4 launch, which equals its plain version on the call's inputs."""
    _need_card()
    nums, cfg = dict_container(case)
    data = pt.container_compress(nums, cfg, page_n=256, chunk_n=3000)
    before = kernels.LAUNCHES["dict_join"]
    plan, got, calls = _dict_join_calls(data, "cuda")
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["dict_join"] == before + 1
    assert np.array_equal(got.cpu().numpy(), nums)
    ((bases, desc, table, out),) = calls
    assert torch.equal(got, dec.dict_join_chunks_plain(bases, desc, table, out.clone()))
    assert len(plan.dict_chunks) == (2 if case == "mixed" else 3)


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
    if case == "dict_100k":  # one launch a container
        assert kernels.LAUNCHES[name] == before[name] + 1
