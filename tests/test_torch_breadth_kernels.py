"""K3 (lookback_recon), B7 (lookback_tiles, its pages past shared memory),
K4 (dict_join), B1 (conv1_recon), B2 (float_mult_join) and B3 (chunk_post,
the decode post) of the port, on their own.

The plain versions run here on the CPU, held against independent numpy
references and the port's host decoder; the tests marked `gpu` hold the
CUDA kernels against the plain versions bit for bit, on both routes of
each, and skip when there is no card. Every comparison is exact. This file
imports no JAX, so on a GPU machine without JAX it runs as
`python -m pytest tests/test_torch_breadth_kernels.py --noconftest -m gpu`.
"""

from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import pcodec_tpu_torch as pt
from pcodec_tpu_torch import constants as C
from pcodec_tpu_torch.codec import compress as port_compress
from pcodec_tpu_torch.delta import conv1_decode_in_place
from pcodec_tpu_torch.dtypes import LATENT_TYPES
from pcodec_tpu_torch.dtypes import NUMBER_TYPES_BY_NAME as TYPES
from pcodec_tpu_torch.errors import CorruptionError
from pcodec_tpu_torch.format.metadata import ChunkMeta, DeltaEncoding
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


def random_long_table(seed):
    """A random B7 table over four tensors (latents, lookbacks with some 0
    and past the window, stored states, and a scratch filled with -77), every
    row storing latents: pages of 16,385 to 300,000 numbers, window_n 1,
    2^15 and 2^17 (a pointer skipping tiles), state_n 0 to 32, ragged last
    pages (one shorter than a tile, one that holds no number), rows starting
    at odd numbers, trivial latents and lookbacks, latent bits 8 to 64.
    Returns (bases, desc)."""
    rng = np.random.default_rng(seed)
    specs = [  # P, N, n, state_n, window_n, bits, lat trivial, lb trivial
        (1, 16_385, 16_385, 0, 1, 64, False, False), (2, 300_000, 450_000, 32, 2**17, 64, False, False),
        (3, 40_000, 100_001, 3, 2**15, 32, False, False), (1, 70_000, 70_000, 1, 2**17, 16, True, False),
        (2, 20_000, 39_000, 5, 1, 8, False, True), (1, 50_000, 12_000, 0, 2**15, 64, False, False),
        (3, 16_400, 32_800, 32, 2**17, 64, False, False), (2, 30_000, 60_000, 2, 3, 64, True, True),
    ]
    order = rng.permutation(len(specs))
    specs = [specs[i] for i in order]
    n_lat = sum(p * n for p, n, *_ in specs) + len(specs)
    lat = torch.from_numpy(rng.integers(0, 2**64, n_lat, dtype=np.uint64).view(np.int64))
    lbs = np.zeros(n_lat, np.int64)
    mom = torch.from_numpy(rng.integers(0, 2**64, sum(p * s for p, _, _, s, *_ in specs), dtype=np.uint64)
                           .view(np.int64))
    scratch = torch.full((sum(s[2] for s in specs),), -77, dtype=torch.int64)
    rows, at, mo, so, page0 = [], 0, 0, 0, 0
    for i, (P, N, nv, sn, wn, bits, lat_t, lb_t) in enumerate(specs):
        at += i % 2  # every other row starts at an odd number
        seg = rng.integers(1, wn + 1, P * N)
        seg[::13] = 0
        seg[5::31] = wn + 77
        lbs[at : at + P * N] = seg
        src_lat = (-1, int(rng.integers(-(2**63), 2**63))) if lat_t else (0, at)
        src_lb = (-1, int(rng.integers(0, 2 * wn))) if lb_t else (1, at)
        rows.append([*src_lat, *src_lb, 2, mo, 3, so, P, N, nv, sn, wn, bits, dec.JOIN_LATENTS, page0])
        at, mo, so, page0 = at + P * N, mo + P * sn, so + nv, page0 + P
    return [lat, torch.from_numpy(lbs), mom, scratch], np.array(rows, np.int64)


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


def _serial_conv1(lat, mom, weights, q, bias, bits):
    """One row of the conv1 recurrence a position at a time, in python ints
    wrapped to 64 bits; the window starts from the state unmasked."""
    mask, mid, k = (1 << bits) - 1, 1 << (bits - 1), len(weights)
    v = [int(x) & M64 for x in mom[:k]]
    out = [x & mask for x in v][: len(lat)]
    for i in range(len(lat) - k):
        s = (bias + sum(w * x for w, x in zip(weights, v[-k:]))) & M64
        s = s - (1 << 64) if s >> 63 else s
        v.append((int(lat[i]) + mid + (s >> q if s > 0 else 0)) & mask)
        out.append(v[-1])
    return np.array(out, dtype=np.uint64)


def _random_conv1_table(seed, orders=(1, 6, 32), bits=(32, 16, 8, 64)):
    """Bases (latents 2-D and flat, the stored states, an output filled
    with -77) and a B1 table over them: entries of each order and width,
    rows of 1, `order`, 1,024 and ragged numbers, trivial entries (constant
    latents), several rows an entry, gaps between the outputs."""
    rng = np.random.default_rng(seed)
    lat = torch.from_numpy(rng.integers(0, 2**64, (8, 1500), dtype=np.uint64).view(np.int64))
    rows, row0, mom_at, out_at = [], 0, 0, 0
    for i, (k, b) in enumerate((k, b) for k in orders for b in bits):
        for R, N, nv, trivial in ((1, 1, 1, False), (2, k, 2 * k - 1, False), (3, 1024, 3 * 1024, False),
                                  (4, 700, 3 * 700 + 1, i % 2 == 0), (1, 4000, 3500, False)):
            w = rng.integers(-(1 << 20), 1 << 20, k).tolist()
            lat_src = (-1, int(rng.integers(0, 2**63))) if trivial else (i % 2, int(rng.integers(0, 11_990 - nv)))
            rows.append(dec.conv1_row(w, int(rng.integers(0, 40)), int(rng.integers(-(1 << 40), 1 << 40)), b, R, N,
                                      nv, row0, lat=lat_src, mom=(2, mom_at), out=(3, out_at)))
            row0, mom_at, out_at = row0 + R, mom_at + R * k, out_at + nv + 3
    mom = torch.from_numpy(rng.integers(0, 2**64, mom_at, dtype=np.uint64).view(np.int64))
    out = torch.full((out_at,), -77, dtype=torch.int64)
    return [lat, lat.reshape(-1)[7:], mom, out], np.array(rows, np.int64)


def conv1_admitted(weights, quantization, bias, bits) -> bool:
    """Whether the port's ChunkMeta validation admits this conv1 encoding
    on latents of `bits` bits."""
    meta = SimpleNamespace(delta_encoding=DeltaEncoding.conv1(quantization, bias, weights),
                           per_latent_var=SimpleNamespace(primary=SimpleNamespace(latent_type=LATENT_TYPES[bits])))
    try:
        ChunkMeta.validate(meta)
    except CorruptionError:
        return False
    return True


def conv1_edge_params(rng, order, bits, q_cap, sign):
    """Weights, q and bias of a conv1 row at the edge of what ChunkMeta's
    validation admits for `bits`-bit latents: random weights (all of
    `sign`, or mixed for 0) whose 2^bits * sum|w| takes a random share of
    the bound, then the largest |bias| (of the weights' sign, or either)
    the validation admits beside them; q its cap (conv_bits - 1) or 0."""
    conv_bits = dec.C1_CONV_BITS[bits]
    wsum = int(rng.integers(order, max(order, (1 << (conv_bits - 1 - bits)) - 1) + 1))
    parts = rng.multinomial(wsum - order, np.ones(order) / order) + 1
    signs = rng.choice([-1, 1], order) if sign == 0 else np.full(order, sign)
    w = [int(p) * int(s) for p, s in zip(parts, signs)]
    q = min(C.MAX_CONV1_DELTA_QUANTIZATION, conv_bits - 1) if q_cap else 0
    bias_sign = sign or int(rng.choice([-1, 1]))
    lo, hi = 0, 1 << (conv_bits - 1)  # admitted at |bias| lo, not at hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if conv1_admitted(w, q, bias_sign * mid, bits) else (lo, mid)
    return w, q, bias_sign * lo


@pytest.mark.parametrize("seed", [1, 2])
def test_conv1_recon_chunks_plain_is_each_entry_alone(seed):
    """Exact: the table form of B1's plain version equals each entry's rows
    through conv1_decode_pages_plain, its first n_valid numbers in the
    output, the gaps left as they were; each row's first numbers equal the
    serial recurrence."""
    bases, desc = _random_conv1_table(seed, orders=(1, 3), bits=(32, 64))
    c = {name: i for i, name in enumerate(dec.C1_COLS)}
    got = bases[:3] + [bases[3].clone()]
    dec.conv1_recon_chunks(got, desc)  # the CPU route: the plain version
    written = torch.zeros(len(got[3]), dtype=torch.bool)
    for r in desc.tolist():
        lat, mom = dec.conv1_row_pages(bases, r)
        k, nv, at = r[c["order"]], r[c["n_valid"]], r[c["out_start"]]
        w = r[c["w0"] : c["w0"] + k]
        want = dec.conv1_decode_pages_plain(lat, mom, w, r[c["quant"]], r[c["bias"]], k, r[c["bits"]])
        assert torch.equal(got[3][at : at + nv], want.reshape(-1)[:nv])
        first = _serial_conv1(lat[0].numpy().view(np.uint64)[:200], mom[0].numpy(), w, r[c["quant"]],
                              r[c["bias"]], r[c["bits"]])
        assert np.array_equal(want[0, :200].numpy().view(np.uint64), first)
        written[at : at + nv] = True
    assert bool((got[3][~written] == -77).all())


# B3's random tables: (mode, number type, numbers, page length, primary,
# secondary), each var (order, source: "launch" rows, a "flat" scratch or
# "trivial"); every mode at 16, 32 and 64 bits, orders 0-7, ragged last
# pages, trivial vars, a Dict chunk's latents under a delta (dict) and a
# fused chunk's rows copied (copy)
POST_SPECS = [
    ("classic", "u16", 700, 256, (0, "launch"), None), ("classic", "i32", 1500, 512, (3, "flat"), None),
    ("classic", "f64", 3000, 1024, (7, "launch"), None), ("classic", "i64", 300, 256, (2, "trivial"), None),
    ("int_mult", "u16", 1000, 256, (1, "launch"), (1, "flat")),
    ("int_mult", "i64", 2049, 1024, (5, "flat"), (0, "trivial")),
    ("int_mult", "u32", 64, 256, (0, "trivial"), (4, "launch")),
    ("float_quant", "f16", 777, 256, (6, "launch"), (0, "flat")),
    ("float_quant", "f32", 5000, 1024, (0, "flat"), (0, "flat")),
    ("float_quant", "f64", 1025, 256, (1, "launch"), (1, "launch")),
    ("float_mult", "f16", 900, 256, (3, "flat"), (0, "launch")),
    ("float_mult", "f32", 4000, 1024, (0, "launch"), (0, "flat")),
    ("float_mult", "f64", 2500, 512, (2, "launch"), (2, "flat")),
    ("dict", "i64", 1300, 256, (1, "launch"), None), ("copy", "u64", 1800, 1024, (0, "launch"), None),
]
POST_FLOAT_BASES = (0.01, np.inf, np.nan, -0.0, "subnormal")


def random_post_table(seed, big_page=False):
    """A B3 table over six tensors (launch rows, a flat scratch, the stored
    moments, an output and a Dict scratch filled with -77, and a long
    page's latents), the rows of POST_SPECS at random starts (odd ones
    among them) with full-range u64 latents (NaN, inf, +-0 and subnormal
    FloatMult multipliers among them) and a FloatMult base of
    POST_FLOAT_BASES by seed; with big_page a Classic i64 row of one page
    of 2^18 numbers and a ragged second page, order 2. Returns (bases,
    desc)."""
    rng = np.random.default_rng(seed)
    specs = POST_SPECS + ([("classic", "i64", (1 << 18) + 300, 1 << 18, (2, "big"), None)] if big_page else [])
    used = {"launch": 0, "flat": 0, "big": 0, "moments": 0, "out": 0, "dict": 0}
    rows = []
    item0 = 0

    def take(kind, n):
        at = used[kind] + int(rng.integers(0, 3))
        used[kind] = at + n
        return at

    for mode, name, n, N, p, sv in specs:
        nt = TYPES[name]
        bits = 32 if mode == "dict" else nt.latent.bits
        pages = -(-n // N)

        def var(v):
            order, src = v
            mom = take("moments", pages * order) if order else 0
            if src == "trivial":
                return [-1, int(rng.integers(-(2**63), 2**63)), order, mom, bits]
            return [{"launch": 0, "flat": 1, "big": 5}[src], take(src, n), order, mom, bits]

        prim = var(p)
        sec = var(sv) if sv else [-1, 0, 0, 0, bits]
        scalar = {"int_mult": int(rng.integers(2, 1 << min(bits, 40))), "float_quant": int(rng.integers(1, 9))}.get(mode, 0)
        if mode == "float_mult":
            base = POST_FLOAT_BASES[seed % len(POST_FLOAT_BASES)]
            f = np.array([1], nt.latent.np_dtype).view(nt.np_dtype) if base == "subnormal" else np.array([base], nt.np_dtype)
            scalar = int(nt.to_latent_ordered(f)[0])
        out = (4, take("dict", n)) if mode == "dict" else (3, take("out", n))
        join = dec.JOIN_LATENTS if mode in ("dict", "copy") else dec.JOIN_OF_KIND[nt.kind]
        row = dec.post_row(prim, sec, 2, out, n, N, item0, mode if mode in dec.POST_MODES else "classic", join,
                           nt.latent.bits, scalar)
        rows.append(row)
        item0 += -(-n // row[dec.POST_COLS.index("seg_n")])

    def lat(n):
        return torch.from_numpy(rng.integers(0, 2**64, max(n, 1), dtype=np.uint64).view(np.int64))

    bases = [lat(used["launch"]), lat(used["flat"]),
             lat(used["moments"]), torch.full((used["out"] + 5,), -77, dtype=torch.int64),
             torch.full((used["dict"] + 5,), -77, dtype=torch.int64), lat(used["big"])]
    bases[0] = torch.cat([bases[0], bases[0].new_zeros(-len(bases[0]) % 1024)]).view(-1, 1024)  # rows of 1,024
    return bases, np.array(rows, np.int64)


@pytest.mark.parametrize("seed", [0, 1])
def test_post_rows_plain_is_each_row_alone(seed):
    """Exact: on a random table, the plain B3 writes each row's numbers as
    that row alone does, and nothing else of its outputs."""
    bases, desc = random_post_table(seed)
    got = [b.clone() for b in bases]
    dec.post_rows_plain(got, desc)
    touched = [torch.zeros(len(bases[i]), dtype=torch.bool) for i in (3, 4)]
    for r in desc:
        alone = [b.clone() for b in bases]
        dec.post_rows_plain(alone, r[None, :])
        o, at, n = r[dec.POST_COLS.index("out_base")], r[dec.POST_COLS.index("out_start")], r[dec.POST_COLS.index("n_valid")]
        assert torch.equal(got[o][at : at + n], alone[o][at : at + n])
        touched[o - 3][at : at + n] = True
    for i in (3, 4):
        assert bool((got[i][~touched[i - 3]] == -77).all())


def test_wrappers_take_plain_versions_on_cpu():
    lat, lb, mom = _pages(2, 256, 1, 256)
    table = torch.arange(5, dtype=torch.int64)
    before = dict(kernels.LAUNCHES)
    assert torch.equal(dec.lookback_recon(lat, lb, mom, 256, 1, 64),
                       dec.lookback_decode_pages_plain(lat, lb, mom, 256, 1, 64))
    assert torch.equal(dec.dict_join(lb[0], table), dec.dict_join_plain(lb[0], table))
    assert torch.equal(dec.conv1_decode_pages(lat, mom[:, :1], [3], 2, 5, 1, 32),
                       dec.conv1_decode_pages_plain(lat, mom[:, :1], [3], 2, 5, 1, 32))
    nt = pt.dtypes.NUMBER_TYPES_BY_NAME["f32"]
    assert torch.equal(dec.float_mult_join(nt, 7 << 28, lat[0], lb[0]),
                       dec.float_mult_join_plain(nt, 7 << 28, lat[0], lb[0]))
    bases, desc = random_post_table(2)
    got, want = [b.clone() for b in bases], [b.clone() for b in bases]
    dec.post_rows(got, desc)
    dec.post_rows_plain(want, desc)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
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
    (2, 16384, 2, 16384, 64), (3, 20000, 8, 30000, 32),  # the largest shared page; B7's tiles
])
def test_lookback_recon_matches_plain_on_card(P, N, state_n, window_n, bits):
    _need_card()
    args = [t.cuda() for t in _pages(P, N, state_n, window_n)]
    before = dict(kernels.LAUNCHES)
    got = dec.lookback_recon(*args, window_n, state_n, bits)
    torch.cuda.synchronize()
    # a one-row table of K3 in shared memory, or of B7's tiles: one launch
    name = "lookback_recon" if N <= kernels.LB_SMEM_MAX_N else "lookback_tiles"
    assert kernels.LAUNCHES[name] == before[name] + 1
    assert sum(kernels.LAUNCHES.values()) == sum(before.values()) + 1
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
@pytest.mark.parametrize("orders,bits", [((1, 2, 3, 4, 5, 6, 7, 8), (32, 8)), ((9, 12, 15, 16, 17, 20), (16, 64)),
                                         ((24, 31, 32), (32, 64, 8, 16))])
def test_conv1_recon_chunks_matches_plain_on_card(orders, bits):
    """Exact: one B1 call on a table of every listed order and latent
    width (rows of 1, `order`, 1,024 and ragged numbers, trivial entries,
    full 64-bit states) equals the plain version, one kernel an order."""
    _need_card()
    bases, desc = _random_conv1_table(len(orders), orders, bits)
    bases = [b.cuda() for b in bases]
    got = bases[:3] + [bases[3].clone()]
    want = bases[:3] + [bases[3].clone()]
    before = kernels.LAUNCHES["conv1_recon"]
    dec.conv1_recon_chunks(got, desc, torch.from_numpy(desc).cuda())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["conv1_recon"] == before + len(orders)
    dec.conv1_recon_chunks_plain(want, desc)
    assert torch.equal(got[3], want[3])


@pytest.mark.gpu
@pytest.mark.parametrize("order", [1, 6, 32])
def test_conv1_decode_pages_long_row_on_card(order):
    """Exact: a row of 300,000 numbers (a standalone chunk's route) and
    three rows beside it: the first 16,384 numbers of each against the
    plain version (the recurrence is causal), the whole long row against
    the serial recurrence."""
    _need_card()
    rng = np.random.default_rng(order)
    N = 300_000
    lat = torch.from_numpy(rng.integers(0, 2**32, (4, N), dtype=np.uint64).view(np.int64)).cuda()
    mom = torch.from_numpy(rng.integers(0, 2**64, (4, order), dtype=np.uint64).view(np.int64)).cuda()
    w = rng.integers(-(1 << 12), 1 << 12, order).tolist()
    q, bias = 14, int(rng.integers(-(1 << 30), 1 << 30))
    before = kernels.LAUNCHES["conv1_recon"]
    got = dec.conv1_decode_pages(lat, mom, w, q, bias, order, 32)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["conv1_recon"] == before + 1
    L = 16_384
    assert torch.equal(got[:, :L], dec.conv1_decode_pages_plain(lat[:, :L], mom, w, q, bias, order, 32))
    want = _serial_conv1(lat[0].cpu().numpy().view(np.uint64), mom[0].cpu().numpy(), w, q, bias, 32)
    assert np.array_equal(got[0].cpu().numpy().view(np.uint64), want)


@pytest.mark.gpu
def test_conv1_recon_chunks_refuses_wrong_arguments_on_card():
    """An order past 32, a quantization of 64, latents past their base,
    rows that do not follow each other, a base that is not int64, more
    bases than a call carries and rows on the card that are not the
    table's are refused, and nothing is launched."""
    _need_card()
    bases, desc = _random_conv1_table(5, (2, 3), (32,))
    bases = [b.cuda() for b in bases]
    c = {name: i for i, name in enumerate(dec.C1_COLS)}
    before = kernels.LAUNCHES["conv1_recon"]
    for col, value in (("order", 33), ("quant", 64), ("lat_start", 12_000), ("row0", 0)):
        bad = desc.copy()
        bad[1, c[col]] = value
        with pytest.raises(RuntimeError, match="conv1_recon kernel launch failed"):
            dec.conv1_recon_chunks(bases, bad)
    with pytest.raises(ValueError):
        dec.conv1_recon_chunks(bases[:3] + [bases[3].to(torch.int32)], desc)
    with pytest.raises(ValueError):
        dec.conv1_recon_chunks(bases + [bases[0]] * kernels.C1_MAX_BASES, desc)
    with pytest.raises(ValueError):
        dec.conv1_recon_chunks(bases, desc, torch.from_numpy(desc[:-1]).cuda())
    assert kernels.LAUNCHES["conv1_recon"] == before


def _conv1_edge_table(seed, orders, bits, rows_per_entry, row_n, wide_too=False):
    """Bases (flat latents and states, full 64-bit; an output filled with
    -77) and a B1 table of narrow entries at the domain's edge
    (conv1_edge_params: q 0 with positive weights and bias, q at its cap
    with negative ones, and mixed signs) for each order and width, each
    `rows_per_entry` rows of `row_n` numbers, the last row 3 short; with
    `wide_too`, beside each a wide entry of 64-bit latents and one whose
    weights pass the bound."""
    rng = np.random.default_rng(seed)
    params = []
    for k in orders:
        for b in bits:
            params += [(b, *conv1_edge_params(rng, k, b, q_cap, sign)) for q_cap, sign in ((False, 1), (True, -1),
                                                                                        (True, 0))]
            if wide_too:
                w = rng.integers(-(1 << 20), 1 << 20, k).tolist()
                params += [(64, w, 9, 12345), (b, [abs(x) + (1 << (dec.C1_CONV_BITS[b] - 1 - b)) for x in w], 3, -5)]
    R, nv = rows_per_entry, rows_per_entry * row_n - 3
    lat = torch.from_numpy(rng.integers(0, 2**64, len(params) * nv, dtype=np.uint64).view(np.int64))
    mom = torch.from_numpy(rng.integers(0, 2**64, R * sum(len(w) for _, w, _, _ in params),
                                        dtype=np.uint64).view(np.int64))
    rows, mom_at = [], 0
    for i, (b, w, q, bias) in enumerate(params):
        rows.append(dec.conv1_row(w, q, bias, b, R, row_n, nv, i * R, lat=(0, i * nv), mom=(1, mom_at),
                                  out=(2, i * (nv + 2))))
        mom_at += R * len(w)
    return [lat, mom, torch.full((len(params) * (nv + 2),), -77, dtype=torch.int64)], np.array(rows, np.int64)


def _conv1_on_card_equals_plain(bases, desc, orders):
    """B1 on the card equals the plain version on the CPU, one launch an order."""
    got = [b.cuda() for b in bases]
    before = kernels.LAUNCHES["conv1_recon"]
    dec.conv1_recon_chunks(got, desc, torch.from_numpy(desc).cuda())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["conv1_recon"] == before + len(orders)
    want = bases[:2] + [bases[2].clone()]
    dec.conv1_recon_chunks_plain(want, desc)
    assert torch.equal(got[2].cpu(), want[2])


def _warp_route(rows: int) -> bool:
    """Whether conv1_recon takes a warp a row for a call of `rows` rows."""
    return rows <= 4 * torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 16, 32])
@pytest.mark.parametrize("route", ["warp", "thread"])
def test_conv1_narrow_tables_match_plain_on_card(bits, route):
    """Exact: a B1 call on narrow entries at the domain's edge, orders 1-32
    (q 0 and its cap, sums driven positive and negative, latents with
    garbage above the W bits, full 64-bit states) equals the plain version,
    on the warp route (one row an entry) and the thread route (eight)."""
    _need_card()
    orders = list(range(1, 33))
    R, N = (1, 300) if route == "warp" else (8, 200)
    bases, desc = _conv1_edge_table(bits, orders, (bits,), R, N)
    assert desc[:, dec.C1_COLS.index("narrow")].all()
    assert _warp_route(int(desc[:, dec.C1_COLS.index("n_rows")].sum())) == (route == "warp")
    _conv1_on_card_equals_plain(bases, desc, orders)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["warp", "thread"])
def test_conv1_narrow_and_wide_rows_in_one_call_on_card(route):
    """Exact: one B1 call whose table holds narrow entries of every width
    beside wide ones (64-bit latents, weights past the bound) equals the
    plain version, on each route."""
    _need_card()
    orders = (1, 6, 32)
    R, N = (1, 300) if route == "warp" else (40, 100)
    bases, desc = _conv1_edge_table(7, orders, (8, 16, 32), R, N, wide_too=True)
    narrow = desc[:, dec.C1_COLS.index("narrow")]
    assert narrow.any() and not narrow.all()
    assert _warp_route(int(desc[:, dec.C1_COLS.index("n_rows")].sum())) == (route == "warp")
    _conv1_on_card_equals_plain(bases, desc, orders)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 16, 32])
def test_conv1_narrow_long_row_on_card(bits):
    """Exact: a narrow row of 300,000 numbers at the domain's edge (order
    6, q at its cap, mixed signs) on the warp route against the serial
    recurrence."""
    _need_card()
    rng = np.random.default_rng(300 + bits)
    w, q, bias = conv1_edge_params(rng, 6, bits, True, 0)
    N = 300_000
    lat = torch.from_numpy(rng.integers(0, 2**64, (1, N), dtype=np.uint64).view(np.int64))
    mom = torch.from_numpy(rng.integers(0, 2**64, (1, 6), dtype=np.uint64).view(np.int64))
    assert dec.conv1_narrow(w, q, bias, bits)
    got = dec.conv1_decode_pages(lat.cuda(), mom.cuda(), w, q, bias, 6, bits)
    want = _serial_conv1(lat[0].numpy().view(np.uint64), mom[0].numpy(), w, q, bias, bits)
    assert np.array_equal(got[0].cpu().numpy().view(np.uint64), want)


@pytest.mark.gpu
def test_conv1_narrow_row_outside_the_domain_is_refused_on_card():
    """A row marked narrow whose 64-bit latents, weights one unit past the
    bound or q past its cap leave the narrow domain, or a narrow column
    other than 0 and 1, is refused, and nothing is launched."""
    _need_card()
    bases, desc = _conv1_edge_table(11, (2, 5), (16,), 1, 64)
    bases = [b.cuda() for b in bases]
    c = {name: i for i, name in enumerate(dec.C1_COLS)}
    w = desc[0, c["w0"] : c["w0"] + 2].tolist()
    past = (1 << 31) - (sum(abs(x) for x in w) << 16)  # |bias| + 2^16 * sum|w| == 2^31
    before = kernels.LAUNCHES["conv1_recon"]
    for col, value in (("bits", 64), ("bias", past), ("bias", -past), ("quant", 32), ("narrow", 2)):
        bad = desc.copy()
        bad[0, c[col]] = value
        bad[0, c["narrow"]] = value if col == "narrow" else 1
        with pytest.raises(RuntimeError, match="conv1_recon kernel launch failed"):
            dec.conv1_recon_chunks(bases, bad)
    ok = desc.copy()
    ok[0, c["bias"]] = past - 1
    assert dec.conv1_narrow(w, int(ok[0, c["quant"]]), past - 1, 16)
    assert kernels.LAUNCHES["conv1_recon"] == before
    dec.conv1_recon_chunks(bases[:2] + [bases[2].clone()], ok)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["conv1_recon"] == before + 2


def _float_mult_inputs(nt, rng, n=50_000):
    """FloatMult primaries over the full range (NaN, inf and subnormal
    multipliers among them, and small ones whose products with tiny bases
    are subnormal), secondaries, and bases (normal, tiny, subnormal, zero,
    negative zero, inf, NaN) as latents of the type."""
    bits = nt.latent.bits
    prim = rng.integers(0, 2**64, n, dtype=np.uint64)
    sec = rng.integers(0, 2**64, n, dtype=np.uint64)
    prim[: n // 5] = np.uint64(1 << (bits - 1)) + rng.integers(-3000, 3000, n // 5).astype(np.uint64)
    udt = nt.latent.np_dtype
    special = np.array([0.01, 1e-30, 3.0, -7.5, np.inf, -np.inf, np.nan, 0.0, -0.0], nt.np_dtype)
    special = np.concatenate([special, np.array([1, 7, 3 << (nt.mantissa_digits - 3)], udt).view(nt.np_dtype)])
    bases = [int(b) for b in nt.to_latent_ordered(special)]
    return (torch.from_numpy(prim.view(np.int64)), torch.from_numpy(sec.view(np.int64)), bases)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["f16", "f32", "f64"])
def test_float_mult_join_matches_plain_on_card(name):
    """Exact: B2 against its plain version at every special base, into a
    fresh tensor and into a slice of a larger output (its neighbours left
    as they were), one launch a call."""
    _need_card()
    nt = TYPES[name]
    prim, sec, bases = _float_mult_inputs(nt, np.random.default_rng(11))
    p, a = prim.cuda(), sec.cuda()
    for base in bases:
        want = dec.float_mult_join_plain(nt, base, prim, sec)
        before = kernels.LAUNCHES["float_mult_join"]
        got = dec.float_mult_join(nt, base, p, a)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["float_mult_join"] == before + 1
        assert torch.equal(got.cpu(), want), f"base latent {base:#x}"
        out = torch.full((len(prim) + 10,), -77, dtype=torch.int64, device="cuda")
        dec.float_mult_join(nt, base, p[1:], a[1:], out[3 : 3 + len(prim) - 1])
        assert torch.equal(out[3 : 3 + len(prim) - 1].cpu(), dec.float_mult_join_plain(nt, base, prim[1:], sec[1:]))
        assert bool((out[:3] == -77).all()) and bool((out[3 + len(prim) - 1 :] == -77).all())


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["conv1_standalone", "conv1_pct", "float_mult_standalone"])
def test_conv1_and_float_mult_decode_on_card(case):
    """Exact: a multi-chunk standalone conv1 file (each chunk one B1 row),
    a conv1 PCT container (a row a page) and a FloatMult standalone file
    decode on the card to their source, B1 in one call, every FloatMult
    chunk joined by B3's one launch (B2 not launched)."""
    _need_card()
    t = np.arange(70_000, dtype=np.float64)
    if case.startswith("conv1"):
        nums = ((1 << 20) * np.sin(0.01 * t) + RNG.integers(-64, 64, len(t))).astype(np.int32)
        cfg = pt.ChunkConfig(delta_spec=pt.DeltaSpec("try_conv1", 6))
    else:
        nums = (RNG.integers(-5000, 5000, len(t)) * np.float32(0.01)).astype(np.float32)
        nums[::101] = np.nan
        cfg = pt.ChunkConfig(mode_spec=pt.ModeSpec("try_float_mult", 0.01))
    if case == "conv1_pct":
        data = pt.container_compress(nums, cfg, page_n=1024, chunk_n=30_000)
    else:
        data = pt.simple_compress(nums, replace(cfg, paging_spec=pt.PagingSpec.equal_pages_up_to(30_000)))
    before = dict(kernels.LAUNCHES)
    got = (pt.decode_container_device(data, device="cuda") if case == "conv1_pct"
           else pt.decode_standalone_device(data, device="cuda"))
    assert np.array_equal(got.view(np.uint8), nums.view(np.uint8))
    name = "chunk_post" if case == "float_mult_standalone" else "conv1_recon"
    assert kernels.LAUNCHES[name] == before[name] + 1
    assert kernels.LAUNCHES["float_mult_join"] == before["float_mult_join"]  # B3 joins FloatMult itself


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


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_post_rows_matches_plain_on_card(seed):
    """Exact: B3 against its plain version on random tables (every mode at
    16, 32 and 64 bits, orders 0-7, trivial vars, ragged last pages, Dict
    latents under a delta, each FloatMult base of POST_FLOAT_BASES over the
    seeds; seed 0 also a page of 2^18), one launch a call, nothing else of
    the outputs written."""
    _need_card()
    bases, desc = random_post_table(seed, big_page=seed == 0)
    want = [b.clone() for b in bases]
    dec.post_rows_plain(want, desc)
    got = [b.cuda() for b in bases]
    before = kernels.LAUNCHES["chunk_post"]
    dec.post_rows(got, desc)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["chunk_post"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
def test_post_rows_refuses_wrong_arguments_on_card():
    """A row past its base, an order past 7 and desc_dev of other rows are
    refused before any launch."""
    _need_card()
    bases, desc = random_post_table(5)
    bases = [b.cuda() for b in bases]
    before = kernels.LAUNCHES["chunk_post"]
    for col, value in (("n_valid", 10**9), ("prim_order", 8)):
        bad = desc.copy()
        bad[0, dec.POST_COLS.index(col)] = value
        with pytest.raises(RuntimeError, match="chunk_post kernel launch failed"):
            dec.post_rows(bases, bad)
    with pytest.raises(ValueError):
        dec.post_rows(bases, desc, torch.from_numpy(desc[:-1]).cuda())
    assert kernels.LAUNCHES["chunk_post"] == before


def _post_decode_input(case):
    """(numbers, bytes, decode) of a multi-chunk input whose post B3 takes
    whole: Classic f64 standalone chunks under an order-2 delta, FloatMult
    f32 and IntMult i64 standalone chunks, and a PCT container of f64 chunks
    of several modes."""
    rng = np.random.default_rng(31)
    n = 90_000
    if case == "classic_f64":
        nums, cfg = np.cumsum(rng.standard_normal(n)), pt.ChunkConfig(delta_spec=pt.DeltaSpec("try_consecutive", 2))
    elif case == "float_mult_f32":
        nums = (rng.integers(-5000, 5000, n) * np.float32(0.01)).astype(np.float32)
        nums[::101] = np.nan
        cfg = pt.ChunkConfig(mode_spec=pt.ModeSpec("try_float_mult", 0.01))
    elif case == "int_mult_i64":
        nums = np.cumsum(rng.integers(0, 50, n)) * 1000 + rng.integers(0, 3, n)
        cfg = pt.ChunkConfig(mode_spec=pt.ModeSpec("try_int_mult", 1000.0))
    else:
        nums = np.concatenate([rng.integers(-5000, 5000, 30_000) * 0.01, rng.standard_normal(30_000),
                               np.full(30_000, 3.25)])
        data = pt.container_compress(nums, pt.ChunkConfig(), page_n=1024, chunk_n=30_000)
        return nums, data, pt.decode_container_device
    data = pt.simple_compress(nums, replace(cfg, paging_spec=pt.PagingSpec.equal_pages_up_to(30_000)))
    return nums, data, pt.decode_standalone_device


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["classic_f64", "float_mult_f32", "int_mult_i64", "mixed_pct"])
def test_decode_post_is_one_chunk_post_launch_on_card(case):
    """Exact: a multi-chunk decode whose post is B3's alone makes exactly
    one chunk_post launch, no B2 launch, and equals its source."""
    _need_card()
    nums, data, decode = _post_decode_input(case)
    before = dict(kernels.LAUNCHES)
    got = decode(data, device="cuda")
    torch.cuda.synchronize()
    assert np.array_equal(got.view(np.uint8), nums.view(np.uint8))
    assert kernels.LAUNCHES["chunk_post"] == before["chunk_post"] + 1
    assert kernels.LAUNCHES["float_mult_join"] == before["float_mult_join"]


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_lookback_tiles_matches_plain_on_card(seed):
    """Exact: one counted B7 launch on a random long table (pages of 16,385
    to 300,000 numbers, window_n 1 to 2^17, state_n 0 to 32, ragged and
    empty last pages, trivial vars, bits 8 to 64) equals the plain version
    and writes every row's numbers and nothing else; no K3 launch."""
    _need_card()
    bases, desc = random_long_table(seed)
    want = bases[:3] + [bases[3].clone()]
    dec.lookback_recon_chunks_plain(want, desc)
    got = [b.cuda() for b in bases]
    before = dict(kernels.LAUNCHES)
    dec.lookback_tiles(got, desc, torch.from_numpy(desc).cuda())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["lookback_tiles"] == before["lookback_tiles"] + 1
    assert kernels.LAUNCHES["lookback_recon"] == before["lookback_recon"]
    assert torch.equal(got[3].cpu(), want[3])
    assert not bool((want[3] == -77).any())


@pytest.mark.gpu
def test_lookback_tiles_refuses_wrong_arguments_on_card():
    """A row that joins (B7 stores latents only), a row past its base, rows
    that do not follow each other and rows on the card that are not the
    table's are refused, and nothing is launched."""
    _need_card()
    bases, desc = random_long_table(1)
    bases = [b.cuda() for b in bases]
    before = kernels.LAUNCHES["lookback_tiles"]
    c = {name: i for i, name in enumerate(dec.LB_COLS)}
    for col, value in ((c["join"], dec.JOIN_SIGNED), (c["out_start"], int(bases[3].numel())), (c["page0"], 1)):
        bad = desc.copy()
        bad[0, col] = value
        with pytest.raises(RuntimeError, match="lookback_tiles kernel launch failed"):
            dec.lookback_tiles(bases, bad)
    with pytest.raises(ValueError):
        dec.lookback_tiles(bases, desc, torch.from_numpy(desc[:-1]).cuda())
    assert kernels.LAUNCHES["lookback_tiles"] == before


def long_lookback_blobs():
    """(name, numbers, bytes, decode entry) of lookback inputs whose pages
    are past K3's shared memory: PCT containers of 20,480-number pages in
    45,000-number chunks (Classic i64 and u16, IntMult) and a standalone
    file of 50,000 numbers (one flat chunk)."""
    rng = np.random.default_rng(31)
    n = 3 * 45_000
    reps = np.tile(rng.integers(0, 50_000, 512), n // 512 + 1)[:n] + rng.integers(0, 2, n)
    lb = pt.DeltaSpec("try_lookback", 0)
    out = []
    for name, nums, mode in (("i64", reps.astype(np.int64), ("classic", 0.0)),
                             ("u16", reps.astype(np.uint16), ("classic", 0.0)),
                             ("int_mult", reps.astype(np.int64) * 1000, ("try_int_mult", 1000.0))):
        cfg = pt.ChunkConfig(mode_spec=pt.ModeSpec(*mode), delta_spec=lb)
        out.append((name, nums, pt.container_compress(nums, cfg, page_n=20_480, chunk_n=45_000),
                    pt.decode_container_device))
    nums = reps[:50_000].astype(np.int64)
    out.append(("standalone", nums, pt.simple_compress(nums, pt.ChunkConfig(delta_spec=lb)),
                pt.decode_standalone_device))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(4))
def test_long_lookback_decode_one_launch_on_card(case):
    """Exact: lookback containers and a standalone file whose pages are past
    K3's shared memory decode on the card to their source with exactly one
    B7 launch and no K3 launch."""
    _need_card()
    name, nums, data, decode = long_lookback_blobs()[case]
    before = dict(kernels.LAUNCHES)
    got = decode(data)
    assert kernels.LAUNCHES["lookback_tiles"] == before["lookback_tiles"] + 1, name
    assert kernels.LAUNCHES["lookback_recon"] == before["lookback_recon"], name
    assert np.array_equal(got.view(np.uint8), nums.view(np.uint8)), name
