"""K5 (bin_ans_encode), K6 (section_pack), K7 (image_assemble, in
csrc/image_stitch.cu) and K8 (row_sort) of the port, on their own.

The plain versions run here on the CPU; the tests marked `gpu` hold the
CUDA kernels against the plain versions bit for bit and skip when there is
no card. This file imports no JAX, so on a GPU machine without JAX it runs
as `python -m pytest tests/test_torch_encode_kernels.py --noconftest -m gpu`.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import pcodec_tpu_torch as pt
from pcodec_tpu_torch.dtypes import U64
from pcodec_tpu_torch.format.bitio import BitWriter
from pcodec_tpu_torch.format.metadata import Bins, ChunkLatentVarMeta
from pcodec_tpu_torch.ops import assemble as asm
from pcodec_tpu_torch.ops import container_encode as ce
from pcodec_tpu_torch.ops import kernels
from pcodec_tpu_torch.ops import row_sort as rs

torch.set_num_threads(1)  # the test workers share the cores: more intra-op threads spin on theirs

RNG = np.random.default_rng(31)


def _cfg(order, mode="classic"):
    kind = "try_consecutive" if order else "no_op"
    return pt.ChunkConfig(mode_spec=pt.ModeSpec(mode), delta_spec=pt.DeltaSpec(kind, order))


def _case(name):
    walk = np.cumsum(RNG.integers(0, 120, 6000) + (RNG.random(6000) < 0.01) * 10**6)
    return {
        "i64_o1_p1024": (walk.astype(np.int64), _cfg(1), 1024, 2500),
        "u64_o1_p256": (walk.astype(np.uint64), _cfg(1), 256, 1 << 20),
        "i32_o2_p512": ((walk % 2_000_000).astype(np.int32), _cfg(2), 512, 1 << 20),
        "i64_hi_entropy_p2048": (RNG.integers(-(2**63), 2**63 - 1, 5000, dtype=np.int64),
                                 _cfg(0), 2048, 1 << 20),
        "constant_then_walk": (np.concatenate([np.full(1500, 9, np.int64), walk[:1500]]),
                               _cfg(1), 256, 1500),
    }[name]


def _launch(nums, cfg, page_n, chunk_n, device):
    plan = asm.plan_image(nums, cfg, page_n, chunk_n, device)
    return plan, asm.upload_image(plan, device)


def _k5_args(a):
    return (a["latents"], a["body_n"], a["table_id"], a["states0"], a["nexts"], a["lowers"],
            a["t1"], a["t2"])


def test_wrappers_take_plain_versions_on_cpu():
    """Exact: on CPU tensors each wrapper returns its plain version's result
    and launches nothing."""
    nums, cfg, page_n, chunk_n = _case("i64_o1_p1024")
    plan, a = _launch(nums, cfg, page_n, chunk_n, "cpu")
    before = dict(kernels.LAUNCHES)
    outs = ce.bin_ans_encode(*_k5_args(a))
    for x, y in zip(outs, ce.bin_ans_encode_plain(*_k5_args(a))):
        assert torch.equal(x, y)
    p1, offsets, states = outs
    W = plan.launch.sec_words
    k6 = ce.section_pack(p1, offsets, W)
    for x, y in zip(k6, ce.section_pack_plain(p1, offsets, W)):
        assert torch.equal(x, y)
    sections, ans_len, off_len, total_bits = k6
    got = asm.image_assemble(plan, a, sections, states, ans_len, off_len, total_bits)
    want = asm.image_assemble_plain(plan, a, sections, states, ans_len, off_len, total_bits)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]) and got[2] == want[2]
    assert kernels.LAUNCHES == before


def _bit_writer_rows(val, ren, off, ob):
    """Each chain's page body as BitWriter writes it: per batch of 256, the
    ANS values (ren bits each), then the offsets (ob bits each)."""
    rows = []
    for c in range(val.shape[0]):
        w = BitWriter()
        for b in range(val.shape[1] // 256):
            sl = slice(256 * b, 256 * (b + 1))
            w.write_batch(val[c, sl].astype(np.uint64), ren[c, sl])
            w.write_batch(off[c, sl], ob[c, sl])
        rows.append(np.frombuffer(w.to_bytes(), np.uint8))
    return rows


def test_section_pack_plain_matches_bit_writer():
    """Exact: random ANS values (0-15 bits) and offsets (0-64 bits) packed
    at the cursors equal BitWriter's stream of the same batches."""
    n, page_n = 3, 512
    ren = RNG.integers(0, 16, (n, page_n))
    ob = RNG.integers(0, 65, (n, page_n))
    val = RNG.integers(0, 1 << 15, (n, page_n)) & ((1 << ren) - 1)
    off = RNG.integers(0, 2**64, (n, page_n), dtype=np.uint64)
    off = np.where(ob >= 64, off, off & ((np.uint64(1) << ob.astype(np.uint64)) - np.uint64(1)))
    p1 = torch.from_numpy((val | (ren << 15) | (ob << 19)).astype(np.int32))
    offsets = torch.from_numpy(off.view(np.int64))
    total_bits = int((ren + ob).sum(1).max())
    W = -(-total_bits // 128) * 4 + 4
    got, _, _, total = ce.section_pack_plain(p1, offsets, W)
    got = got.numpy().view(np.uint8)
    for c, want in enumerate(_bit_writer_rows(val, ren, off, ob)):
        assert int(total[c]) == int(ren[c].sum() + ob[c].sum())
        assert np.array_equal(got[c, : len(want)], want) and not got[c, len(want):].any()


K6_CASES = ["ob_0", "ob_1_32", "ob_33", "ob_64", "mixed"]


def _random_k6_launch(case, n=6, page_n=768):
    """K5-like outputs of n chains: random ANS values (0-15 bits) and
    offsets of the case's widths (none, 1-32, 33, 64 bits, or a mix of
    0-64), ragged body lengths (0, 1, 255, 257, the page, the page less 3:
    K5 leaves p1 and the offset 0 past them), and sec_words at the encoder's
    worst-case bound (chunk_job's, rounded up to 4 words as for a launch).
    Returns (p1, offsets, sec_words, (val, ren, off, ob))."""
    rng = np.random.default_rng(K6_CASES.index(case) + 60)
    ren = rng.integers(0, 16, (n, page_n))
    ob = {"ob_0": np.zeros((n, page_n), np.int64), "ob_1_32": rng.integers(1, 33, (n, page_n)),
          "ob_33": np.full((n, page_n), 33), "ob_64": np.full((n, page_n), 64),
          "mixed": rng.choice([0, 1, 17, 32, 33, 50, 63, 64], (n, page_n))}[case]
    live = np.arange(page_n)[None, :] < np.array([0, 1, 255, 257, page_n, page_n - 3])[:n, None]
    ren, ob = np.where(live, ren, 0), np.where(live, ob, 0)
    val = rng.integers(0, 1 << 15, (n, page_n)) & ((1 << ren) - 1)
    off = rng.integers(0, 2**64, (n, page_n), dtype=np.uint64)
    off = np.where(ob >= 64, off, off & ((np.uint64(1) << ob.astype(np.uint64)) - np.uint64(1)))
    worst = 15 + int(ob.max())
    sec_words = -(-(-(-(page_n * (worst + 1) + 64) // 32)) // 4) * 4
    p1 = torch.from_numpy((val | (ren << 15) | (ob << 19)).astype(np.int32))
    return p1, torch.from_numpy(off.view(np.int64)), sec_words, (val, ren, off, ob)


@pytest.mark.parametrize("case", K6_CASES)
def test_section_pack_plain_returns_cursors_lengths_and_deposits(case):
    """Exact: the plain K6 returns section_cursors' lengths and total bits,
    and sections equal to BitWriter's stream of the same batches (zero past
    it), on random launches with offsets of 0, 1-32, 33 and 64 bits, ragged
    body lengths and sec_words at its worst-case bound."""
    p1, offsets, W, (val, ren, off, ob) = _random_k6_launch(case)
    sections, ans_len, off_len, total_bits = ce.section_pack_plain(p1, offsets, W)
    c_ans, c_off, _, c_total = ce.section_cursors(p1)
    assert torch.equal(ans_len, c_ans) and torch.equal(off_len, c_off) and torch.equal(total_bits, c_total)
    assert sections.shape == (p1.shape[0], W)
    got = sections.numpy().view(np.uint8)
    for c, want in enumerate(_bit_writer_rows(val, ren, off, ob)):
        assert int(total_bits[c]) == int(ren[c].sum() + ob[c].sum())
        assert np.array_equal(got[c, : len(want)], want) and not got[c, len(want):].any()


def test_image_stitch_plain_places_rows():
    """Exact: rows ORed in at F0, words past lenW ignored."""
    rows = RNG.integers(0, 2**32, (4, 6)).astype(np.uint32)
    F0 = np.array([0, 5, 5, 11], np.int64)
    lenW = np.array([5, 1, 6, 3], np.int64)
    rows[1, 0] &= 0x0000FFFF  # rows 1 and 2 share word 5: disjoint bits
    rows[2, 0] &= 0xFFFF0000
    body = np.zeros(14, np.uint32)
    for r in range(4):
        body[F0[r] : F0[r] + lenW[r]] |= rows[r, : lenW[r]]
    t = torch.from_numpy
    empty = torch.zeros((0, 2), dtype=torch.int32)
    none = torch.zeros(0, dtype=torch.int64)
    got = asm.image_stitch_plain(t(rows.view(np.int32)), t(F0), t(lenW), empty, none, none, 14)
    assert np.array_equal(got.numpy().view(np.uint32), body)


def _sort_rows(span, rows, m):
    """(rows, m) uint64 keys with ties, whose spans fit 32 bits or need 64."""
    x = RNG.integers(0, 2**32 if span == "u32" else 2**64, (rows, m), dtype=np.uint64)
    x[:, : m // 3] = x[:, :1]
    return x + np.uint64(5 << 40) if span == "u32" else x


def _span_rows(kind, rows, m):
    """(rows, m) uint64 keys whose largest row span is set by `kind`: all
    equal, exactly 2^32 - 1 or 2^32 (the boundary of the two key widths),
    the full 64 bits, or keys at the largest u64; ties in every row."""
    if kind == "all_equal":
        return np.full((rows, m), 0xDEADBEEF12345678, np.uint64)
    if kind == "largest_u64":
        x = np.full((rows, m), 2**64 - 1, np.uint64)
        x[:, ::7] = RNG.integers(2**63, 2**64 - 1, x[:, ::7].shape, dtype=np.uint64)
        return x
    top = {"span_2^32-1": 2**32 - 1, "span_2^32": 2**32, "full_64": 2**64 - 1}[kind]
    base = np.uint64(0 if kind == "full_64" else 3 << 50)
    x = RNG.integers(0, top, (rows, m), dtype=np.uint64, endpoint=True)
    x[:, : m // 3] = x[:, :1]
    x[0, 0], x[0, -1] = 0, top  # the span is reached in row 0
    return x + base


RADIX_CASES = [(kind, 3, m) for kind in ("full_64", "span_2^32-1") for m in (1, 3, 1000, 42_200)] + [
    (kind, 2, 5000) for kind in ("all_equal", "span_2^32", "largest_u64")]


@pytest.mark.parametrize("kind,rows,m", RADIX_CASES)
def test_row_sort_radix_plain_is_numpy_sort(kind, rows, m):
    """Exact: K8's steps in plain torch (span, key width, passes, per-digit
    stable scatter) equal row_sort_plain and numpy's sort, on rows of 1 to
    42,200 keys, on both sides of the u32/u64 boundary, full 64-bit spans
    and the largest u64."""
    x = _span_rows(kind, rows, m)
    t = torch.from_numpy(x.view(np.int64))
    got = rs.row_sort_radix_plain(t)
    assert np.array_equal(got.numpy().view(np.uint64), np.sort(x, 1))
    assert torch.equal(got, rs.row_sort_plain(t))
    want = {"all_equal": (4, 0), "span_2^32-1": (4, 4), "span_2^32": (8, 5), "full_64": (8, 8)}.get(kind)
    if want and m > 1:  # a row of one key spans nothing
        assert rs.radix_plan(int((x.max(1) - x.min(1)).max())) == want


@pytest.mark.parametrize("span", ["u32", "u64"])
def test_row_sort_on_cpu_is_numpy_sort(span):
    """Exact: on the CPU, K8's wrapper and sort_latents return numpy's sort
    and launch nothing."""
    x = _sort_rows(span, 3, 1000)
    before = dict(kernels.LAUNCHES)
    got = rs.row_sort(torch.from_numpy(x.view(np.int64))).numpy().view(np.uint64)
    assert np.array_equal(got, np.sort(x, 1))
    assert np.array_equal(rs.sort_latents(x[1], "cpu"), np.sort(x[1]))
    assert kernels.LAUNCHES == before


def _big_table_launch(device):
    """A launch whose table (2^14 states, 2^14 bins) exceeds a block's shared
    memory, so K5 reads it from global memory."""
    n_bins = 1 << 14
    lowers = np.sort(RNG.choice(2**40, n_bins, replace=False)).astype(np.uint64) << np.uint64(20)
    bins = Bins(U64, np.ones(n_bins, np.uint32), lowers, np.full(n_bins, 20, np.uint32))
    nexts, lo, t1, t2, ts = ce.build_enc_tables(ChunkLatentVarMeta(14, bins))
    n, page_n = 256, 512
    lat = lowers[RNG.integers(0, n_bins, (n, page_n))] + RNG.integers(0, 2**20, (n, page_n), dtype=np.uint64)
    L = ce.EncodeLaunch(
        page_n=page_n, latents=lat, body_n=RNG.integers(0, page_n + 1, n).astype(np.int64),
        table_id=np.zeros(n, np.int64), states0=np.full(n, ts, np.int64),
        nexts=nexts[None].astype(np.int32), lowers=lo[None], t1=t1[None].astype(np.int32),
        t2=t2[None].astype(np.int32), sec_words=page_n * 36 // 32 + 8,
    )
    return L, ce.upload_launch(L, device)


def _random_k5_launch(case, device):
    """A launch of random latents around bins of the case's offset widths
    (0, 33 and 64 bits among them), bins padded to a power of two with
    copies of the last, ragged body lengths (0, 1, 3, 255, 257, not
    multiples of 4 or of 256) and two tables, a group of 128 chains each.
    The largest table (2^14 states, 2^14 bins) takes K5's global-memory
    route, the others its shared-memory one."""
    n_bins, ans_log = {"ob_0_33_64": (3, 2), "bins_256": (256, 10), "bins_4096": (4096, 12),
                       "bins_16384_global": (1 << 14, 14)}[case]
    rng = np.random.default_rng(n_bins)
    n, page_n = 256, 512
    tables = []
    for t in range(2):
        obs = np.resize(np.array([0, 33, 64, 5, 20], np.uint32), n_bins)
        lowers = np.sort(rng.choice(2**62, n_bins, replace=False)).astype(np.uint64) << np.uint64(1)
        lowers[0] = 0
        weights = np.ones(n_bins, np.uint32)
        weights[0] += (1 << ans_log) - n_bins
        nexts, lo, t1, t2, ts = ce.build_enc_tables(ChunkLatentVarMeta(ans_log, Bins(U64, weights, lowers, obs)))
        b_pad = 1 << (n_bins - 1).bit_length()
        pad = lambda x: np.concatenate([x, np.repeat(x[-1:], b_pad - n_bins)])
        tables.append((nexts.astype(np.int32), pad(lo), pad(t1).astype(np.int32), pad(t2).astype(np.int32), lowers))
    lat = np.empty((n, page_n), np.uint64)
    for c in range(n):
        lowers = tables[c // 128][4]
        lat[c] = lowers[rng.integers(0, n_bins, page_n)] + rng.integers(0, 2**33, page_n, dtype=np.uint64)
    body_n = rng.integers(0, page_n + 1, n)
    body_n[:8] = [0, 1, 3, 255, 257, 4 * 77 + 2, page_n, page_n - 1]
    L = ce.EncodeLaunch(
        page_n=page_n, latents=lat, body_n=body_n.astype(np.int64), table_id=np.repeat(np.arange(2), 128),
        states0=rng.integers(ts, 2 * ts, n).astype(np.int64), nexts=np.stack([t[0] for t in tables]),
        lowers=np.stack([t[1] for t in tables]), t1=np.stack([t[2] for t in tables]),
        t2=np.stack([t[3] for t in tables]), sec_words=page_n * 80 // 32 + 8,
    )
    return ce.upload_launch(L, device)


K5_CASES = ["ob_0_33_64", "bins_256", "bins_4096", "bins_16384_global"]


@pytest.mark.parametrize("case", K5_CASES)
def test_bin_ans_encode_tiled_plain_matches_plain(case):
    """Exact: K5's steps in plain torch (tiles of 8 rounds from the last,
    each a search step and a walk of every stream) equal the plain version
    on random launches: offsets of 0, 33 and 64 bits, ragged body lengths,
    two tables, up to the largest table."""
    a = _random_k5_launch(case, "cpu")
    want = ce.bin_ans_encode_plain(*_k5_args(a))
    for got, w in zip(ce.bin_ans_encode_tiled_plain(*_k5_args(a)), want):
        assert torch.equal(got, w)
    assert int(((want[0] >> 19) & 127).max()) == 64 and bool((want[0] == 0).any())


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["i64_o1_p1024", "u64_o1_p256", "i32_o2_p512",
                                  "i64_hi_entropy_p2048", "constant_then_walk"])
def test_kernels_match_plain_versions_on_card(case):
    """Exact: K5, K6 and K7 on the card equal their plain versions, and the
    file image equals the port's container_compress bytes."""
    _need_card()
    nums, cfg, page_n, chunk_n = _case(case)
    plan, a = _launch(nums, cfg, page_n, chunk_n, "cuda")
    before = dict(kernels.LAUNCHES)
    outs = ce.bin_ans_encode(*_k5_args(a))
    for x, y in zip(outs, ce.bin_ans_encode_plain(*_k5_args(a))):
        assert torch.equal(x, y)
    p1, offsets, states = outs
    W = plan.launch.sec_words
    k6 = ce.section_pack(p1, offsets, W)
    for x, y in zip(k6, ce.section_pack_plain(p1, offsets, W)):
        assert torch.equal(x, y)
    sections, ans_len, off_len, total_bits = k6
    got = asm.image_assemble(plan, a, sections, states, ans_len, off_len, total_bits)
    want = asm.image_assemble_plain(plan, a, sections, states, ans_len, off_len, total_bits)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]) and got[2] == want[2]
    torch.cuda.synchronize()
    for name in ("bin_ans_encode", "section_pack", "image_stitch"):
        assert kernels.LAUNCHES[name] > before[name]
    img = asm.file_image_to_bytes(*asm.run_image(plan, a))
    assert img == pt.container_compress(nums, cfg, page_n=page_n, chunk_n=chunk_n)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [3, 256, 5000, 70000])
@pytest.mark.parametrize("span", ["u32", "u64"])
def test_row_sort_matches_plain_version_on_card(span, m):
    """Exact: K8 on the card equals its plain version, from one tile to rows
    of many tiles, on keys of either width."""
    _need_card()
    x = torch.from_numpy(_sort_rows(span, 3, m).view(np.int64)).cuda()
    before = kernels.LAUNCHES["row_sort"]
    got = rs.row_sort(x)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["row_sort"] == before + 1
    assert torch.equal(got, rs.row_sort_plain(x))


@pytest.mark.gpu
@pytest.mark.parametrize("kind,rows,m", RADIX_CASES + [("span_2^32-1", 96, 42_200), ("full_64", 2, (1 << 20) + 3),
                                                       ("span_2^32", 5, 4097), ("all_equal", 1, 2)])
def test_radix_row_sort_matches_plain_on_card(kind, rows, m):
    """Exact: the radix K8 on the card, one counted span call and one
    counted sort call, equals
    row_sort_plain and its own steps in plain torch: both key widths, the
    boundary spans, rows of any length (not powers of two, one key, the
    stage-1 sample rows of 42,200, past 2^20) and equal keys (no pass)."""
    _need_card()
    x = torch.from_numpy(_span_rows(kind, rows, m).view(np.int64)).cuda()
    keep = x.clone()
    before = dict(kernels.LAUNCHES)
    got = rs.row_sort(x)
    torch.cuda.synchronize()
    for name in ("row_sort", "row_sort_span"):  # the span's kernels, then the passes'
        assert kernels.LAUNCHES[name] == before[name] + (m > 1)
    assert torch.equal(got, rs.row_sort_plain(x))
    assert torch.equal(got.cpu(), rs.row_sort_radix_plain(x.cpu()))
    assert torch.equal(x, keep)


@pytest.mark.gpu
def test_bin_ans_encode_table_in_global_memory_on_card():
    """Exact: the largest legal table takes K5's global-memory path and
    still equals the plain version."""
    _need_card()
    _, a = _big_table_launch("cuda")
    for x, y in zip(ce.bin_ans_encode(*_k5_args(a)), ce.bin_ans_encode_plain(*_k5_args(a))):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_encode_wrappers_refuse_wrong_arguments_on_card():
    _need_card()
    p1 = torch.zeros((4, 256), dtype=torch.int64, device="cuda")
    with pytest.raises(ValueError):
        ce.section_pack(p1, p1, 8)  # p1 must be int32
    p1 = p1.to(torch.int32)
    offsets = torch.zeros((4, 256), dtype=torch.int64, device="cuda")
    for bad in (6, 0):  # sec_words not a multiple of 4, or none
        with pytest.raises(ValueError):
            ce.section_pack(p1, offsets, bad)
    with pytest.raises(ValueError):
        ce.section_pack(p1[:, :200].contiguous(), offsets[:, :200].contiguous(), 8)  # a ragged batch
    with pytest.raises(ValueError):
        ce.section_pack(p1, offsets[:3], 8)
    _, a = _big_table_launch("cuda")
    a["table_id"][5] = 1  # a block of chains that does not share one table
    with pytest.raises(ValueError, match="share one table"):
        ce.bin_ans_encode(*_k5_args(a))


@pytest.mark.gpu
@pytest.mark.parametrize("case", K5_CASES)
def test_bin_ans_encode_matches_plain_on_random_launch_on_card(case):
    """Exact: K5 on the card (one counted launch) equals its plain version
    and its steps in plain torch on random launches: offsets of 0, 33 and
    64 bits, ragged body lengths and empty chains, two tables, tables in
    shared memory up to 2^12 states and the largest one in global memory."""
    _need_card()
    a = _random_k5_launch(case, "cuda")
    before = kernels.LAUNCHES["bin_ans_encode"]
    got = ce.bin_ans_encode(*_k5_args(a))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bin_ans_encode"] == before + 1
    for x, y in zip(got, ce.bin_ans_encode_plain(*_k5_args(a))):
        assert torch.equal(x, y)
    for x, y in zip(got, ce.bin_ans_encode_tiled_plain(*_k5_args(a))):
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("case", K6_CASES + ["smem_limit", "past_smem_limit"])
def test_section_pack_matches_plain_on_random_launch_on_card(case):
    """Exact: K6 on the card (one counted launch) equals its plain version
    in every output (sections, ans_len, off_len, total_bits) on random
    launches: offsets of 0, 1-32, 33 and 64 bits, ragged body lengths,
    sec_words at the worst-case bound; rows of exactly the longest the
    shared-memory route stages (a block of one warp), and 4 words longer
    (device memory)."""
    _need_card()
    p1, offsets, W, _ = _random_k6_launch("mixed" if "smem" in case else case)
    if "smem" in case:
        W = kernels.section_pack_smem_words("cuda") // 4 * 4 + (4 if case == "past_smem_limit" else 0)
    p1, offsets = p1.cuda(), offsets.cuda()
    before = kernels.LAUNCHES["section_pack"]
    got = ce.section_pack(p1, offsets, W)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["section_pack"] == before + 1
    for x, y in zip(got, ce.section_pack_plain(p1, offsets, W)):
        assert torch.equal(x, y)
    assert got[0].shape == (p1.shape[0], W)


K7_CASES = ["random_outputs", "trivial_chunk", "mixed_meta_groups", "wide_rows", "zero_length_pages",
            "tiny_pages"]


def _k7_inputs(case, device):
    """A plan, its uploaded arrays and the launch's outputs for K7:
    "random_outputs" replaces a real launch's outputs and moments with
    random ones of the same layout (total bits from 0 to the row, section
    bits zero past them, u16 lengths, any states and moments);
    "trivial_chunk" has a trivial chunk (no chain) beside coded ones;
    "mixed_meta_groups" chunks of three (order, ANS size log) meta layouts
    with ragged chunks; "wide_rows" pages of 2^16 numbers, rows of over
    130,000 words; "zero_length_pages" trivial chunks without a delta, whose
    pages take no byte; "tiny_pages" chunks whose last pages take 1 to 3
    bytes, so a body word holds several pages."""
    rng = np.random.default_rng(K7_CASES.index(case) + 70)
    walk = np.cumsum(rng.integers(0, 120, 6000) + (rng.random(6000) < 0.01) * 10**6)
    nums, cfg, page_n, chunk_n = {
        "random_outputs": (walk.astype(np.int64), _cfg(2), 512, 2100),
        "trivial_chunk": _case("constant_then_walk"),
        "mixed_meta_groups": (np.concatenate([np.full(700, 3, np.int64), walk[:700], np.full(300, 9, np.int64),
                                              walk[:900] % 200]), pt.ChunkConfig(), 256, 700),
        "wide_rows": (rng.integers(-(2**63), 2**63 - 1, 3 << 16, dtype=np.int64), _cfg(0), 1 << 16, 1 << 20),
        "zero_length_pages": (np.concatenate([np.full(1000, 7, np.int64), walk[:1000], np.full(777, 3, np.int64),
                                              walk[:1001]]), _cfg(0), 256, 1000),
        "tiny_pages": (rng.integers(0, 3, 1300).astype(np.uint16),
                       pt.ChunkConfig(compression_level=0, mode_spec=pt.ModeSpec("classic"),
                                      delta_spec=pt.DeltaSpec("no_op", 0)), 256, 259),
    }[case]
    plan, a = _launch(nums, cfg, page_n, chunk_n, device)
    sections, states, ans_len, off_len, total_bits = ce.encode_launch(plan.launch, a)
    ref = None
    if case == "random_outputs":
        n, W = sections.shape
        tb = rng.integers(0, 32 * W + 1, n)
        tb[:3] = [0, 1, 32 * W]
        words = rng.integers(0, 2**32, (n, W), dtype=np.uint64)
        bit = np.arange(W)[None, :] * 32
        keep = np.clip(tb[:, None] - bit, 0, 32).astype(np.uint64)
        words &= (np.uint64(1) << keep) - np.uint64(1)
        t = lambda x: torch.from_numpy(x).to(device)
        sections = t(words.astype(np.uint32).view(np.int32))
        total_bits = t(tb.astype(np.int64))
        states = t(rng.integers(-(2**40), 2**40, (n, 4)))
        ans_len, off_len = (t(rng.integers(0, 2**16, tuple(ans_len.shape))) for _ in range(2))
        a = dict(a, moments=t(rng.integers(-(2**63), 2**63 - 1, tuple(a["moments"].shape), dtype=np.int64)))
    else:
        ref = pt.container_compress(nums, cfg, page_n=page_n, chunk_n=chunk_n)
    return plan, a, (sections, states, ans_len, off_len, total_bits), ref


@pytest.mark.parametrize("case", ["trivial_chunk", "mixed_meta_groups", "zero_length_pages", "tiny_pages"])
def test_k7_cases_reach_their_layouts(case):
    """The K7 cases' plans hold what their names say: a trivial chunk (no
    chain), chunks of three meta layouts, pages of no byte, pages of 1 to 3
    bytes (each page's bytes read from the plain version's head)."""
    plan, a, outs, _ = _k7_inputs(case, "cpu")
    lay = plan.layout
    head = asm.image_assemble_plain(plan, a, *outs)[0].numpy()
    H = len(plan.head_host) // 4
    page_bytes = head[H : H + lay.total_pages]
    if case == "trivial_chunk":
        assert -1 in plan.launch.chain_start and plan.launch.n_chains
    elif case == "mixed_meta_groups":
        assert len(set(zip(lay.orders, lay.sls, lay.bits))) == 3 and len(set(lay.n_pages)) > 1
    elif case == "zero_length_pages":
        assert (page_bytes == 0).sum() > 1 and (page_bytes > 0).any()
    else:
        assert ((page_bytes > 0) & (page_bytes < 4)).sum() > 1


@pytest.mark.gpu
@pytest.mark.parametrize("case", K7_CASES)
def test_image_assemble_matches_plain_on_card(case):
    """Exact: K7 on the card (two counted C calls, each warp placing runs of
    1, 3, 4 or 16 pages) writes the plain version's head words, body words
    and byte count: on random outputs of
    a real layout, a trivial chunk, three meta layouts, rows of over
    130,000 words, pages of no byte and of 1 to 3 bytes; from the real
    outputs the image is the port's container_compress bytes."""
    _need_card()
    plan, a, outs, ref = _k7_inputs(case, "cuda")
    before = kernels.LAUNCHES["image_stitch"]
    got = asm.image_assemble(plan, a, *outs)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["image_stitch"] == before + 2
    want = asm.image_assemble_plain(plan, a, *outs)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]) and got[2] == want[2]
    keep = kernels.K7_PAGES_PER_WARP
    try:
        for ppw in (1, 3, 16):  # runs of pages a warp that end mid-chunk and past the last page
            kernels.K7_PAGES_PER_WARP = ppw
            assert torch.equal(asm.image_assemble(plan, a, *outs)[1], want[1])
    finally:
        kernels.K7_PAGES_PER_WARP = keep
    if case == "wide_rows":
        assert plan.launch.sec_words > 130_000
    if ref is not None:
        assert asm.file_image_to_bytes(got[0], got[1], plan.head_bytes, got[2]) == ref


_TRAP = """
import numpy as np, torch
import pcodec_tpu_torch as pt
from pcodec_tpu_torch.ops import assemble as asm, container_encode as ce, kernels
nums = np.cumsum(np.random.default_rng(3).integers(0, 120, 5000)).astype(np.int64)
cfg = pt.ChunkConfig(delta_spec=pt.DeltaSpec("try_consecutive", 1))
plan = asm.plan_image(nums, cfg, 256, 2048, "cuda")
a = asm.upload_image(plan, "cuda")
sections, states, ans_len, off_len, total_bits = ce.encode_launch(plan.launch, a)
head, body, body_bytes = asm.image_assemble(plan, a, sections, states, ans_len, off_len, total_bits)
scan_words, page_words = kernels.image_scratch_sizes(plan.layout.total_pages)
scan = torch.empty(scan_words, dtype=torch.int64, device="cuda")
pages = torch.empty(page_words, dtype=torch.int32, device="cuda")
kernels.launch_image_offsets(a["image_desc"], total_bits, ans_len, off_len, sections, states, a["moments"],
                             a["image_pfx"], a["head_host"], head.shape[0] - a["head_host"].shape[0]
                             - plan.layout.total_pages, head, scan, pages)
short = torch.empty(body.shape[0] - 1, dtype=torch.int32, device="cuda")
kernels.launch_image_stitch(a["image_desc"], pages, scan, sections, states, a["moments"], a["image_pfx"], short)
torch.cuda.synchronize()
print("placed without an error")
"""


@pytest.mark.gpu
def test_image_stitch_traps_a_word_outside_the_body_on_card():
    """K7's placement into a body one word too short stops with a device
    error rather than drop the word (in a process of its own: the error
    ends that process's CUDA context)."""
    _need_card()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", _TRAP], cwd=root, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "placed without an error" not in r.stdout, r.stdout + r.stderr
    assert "CUDA error" in r.stderr or "launch failure" in r.stderr or "illegal instruction" in r.stderr, r.stderr


def _multi_case(name):
    """A multi-var or lookback input (numbers, config, page_n, chunk_n):
    IntMult's two vars with a second chunk of one var, FloatMult f32, a
    lookback delta's lookbacks and primary, an IntMult chunk whose secondary
    is trivial (no chain), and K6's joint row over the shared-memory limit
    (pages of 2^16 numbers of two wide vars)."""
    rng = np.random.default_rng(["intmult_mixed", "floatmult_f32", "lookback", "trivial_secondary",
                                 "wide_joint_rows"].index(name) + 90)
    if name == "intmult_mixed":
        a = np.cumsum(rng.integers(0, 120, 8192)).astype(np.int64)
        b = (rng.integers(0, 1 << 20, 8192) * 1_000_003 + rng.integers(0, 3, 8192)).astype(np.int64)
        return np.concatenate([a, b]), pt.ChunkConfig(), 256, 8192
    if name == "floatmult_f32":
        x = (rng.integers(-5000, 5000, 6000) * np.float32(0.01)).astype(np.float32)
        x.view(np.uint32)[::9] += 1
        return x, pt.ChunkConfig(), 512, 4000
    if name == "lookback":
        x = np.tile(rng.integers(0, 10**6, 300), 20).astype(np.int64) + rng.integers(0, 2, 6000)
        return x, pt.ChunkConfig(delta_spec=pt.DeltaSpec("try_lookback", 0)), 256, 2500
    if name == "trivial_secondary":
        return (rng.integers(0, 1 << 20, 6000) * 777).astype(np.int64), pt.ChunkConfig(), 1024, 1 << 20
    x = rng.integers(0, 2**40, 3 << 16, dtype=np.int64) * 1000 + rng.integers(0, 4, 3 << 16)
    return x, pt.ChunkConfig(mode_spec=pt.ModeSpec("try_int_mult", 1000)), 1 << 16, 1 << 20


MULTI_CASES = ["intmult_mixed", "floatmult_f32", "lookback", "trivial_secondary", "wide_joint_rows"]


@pytest.mark.parametrize("name", MULTI_CASES[:4])
def test_multivar_cases_reach_their_layouts(name):
    """The multi-var cases hold what their names say, and their plain image
    is the port's container_compress bytes."""
    nums, cfg, page_n, chunk_n = _multi_case(name)
    plan, a = _launch(nums, cfg, page_n, chunk_n, "cpu")
    jobs, L = plan.enc.jobs, plan.launch
    assert L.row_chains is not None and L.n_rows == plan.layout.total_pages
    if name == "intmult_mixed":
        assert [len(job.vars) for job in jobs] == [1, 2]
    elif name == "lookback":
        assert all([vj.key for vj in job.vars] == ["delta", "primary"] for job in jobs)
    elif name == "trivial_secondary":
        assert (L.row_chains[:, 1] == -1).all() and jobs[0].vars[1].trivial
    img = asm.file_image_to_bytes(*asm.run_image(plan, a))
    assert img == pt.container_compress(nums, cfg, page_n=page_n, chunk_n=chunk_n)


@pytest.mark.gpu
@pytest.mark.parametrize("name", MULTI_CASES)
def test_multivar_kernels_match_plain_on_card(name):
    """Exact: on pages of several vars K6 (one counted launch, the joint
    cursors inside) and K7 (two counted C calls, multi-var descriptor rows)
    equal their plain versions, K6 also with its row map replaced by every
    page's chains in another order, and the image is the port's
    container_compress bytes; "wide_joint_rows" packs rows past the
    shared-memory limit."""
    _need_card()
    nums, cfg, page_n, chunk_n = _multi_case(name)
    plan, a = _launch(nums, cfg, page_n, chunk_n, "cuda")
    L = plan.launch
    p1, offsets, states = ce.bin_ans_encode(*_k5_args(a))
    before = dict(kernels.LAUNCHES)
    k6 = ce.section_pack(p1, offsets, L.sec_words, a["row_chains"])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["section_pack"] == before["section_pack"] + 1
    for x, y in zip(k6, ce.section_pack_plain(p1, offsets, L.sec_words, a["row_chains"])):
        assert torch.equal(x, y)
    flipped = a["row_chains"].flip(1).contiguous()
    for x, y in zip(ce.section_pack(p1, offsets, L.sec_words, flipped),
                    ce.section_pack_plain(p1, offsets, L.sec_words, flipped)):
        assert torch.equal(x, y)
    if name == "wide_joint_rows":
        assert L.sec_words > kernels.section_pack_smem_words("cuda")
    got = asm.image_assemble(plan, a, k6[0], states, *k6[1:])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["image_stitch"] == before["image_stitch"] + 2
    want = asm.image_assemble_plain(plan, a, k6[0], states, *k6[1:])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]) and got[2] == want[2]
    img = asm.file_image_to_bytes(*asm.run_image(plan, a))
    assert img == pt.container_compress(nums, cfg, page_n=page_n, chunk_n=chunk_n)


@pytest.mark.gpu
def test_single_var_rows_unchanged_on_card():
    """The V = 1 case: K6 without a row map packs a row a chain, its lengths
    (rows, B), exactly as with the one-column map of every chain, and K7
    reads those rows."""
    _need_card()
    nums, cfg, page_n, chunk_n = _case("i64_o1_p1024")
    plan, a = _launch(nums, cfg, page_n, chunk_n, "cuda")
    assert plan.launch.row_chains is None and "row_chains" not in a
    p1, offsets, _ = ce.bin_ans_encode(*_k5_args(a))
    W = plan.launch.sec_words
    plain = ce.section_pack(p1, offsets, W)
    one = torch.arange(p1.shape[0], device="cuda")[:, None].contiguous()
    mapped = ce.section_pack(p1, offsets, W, one)
    assert plain[1].shape == (p1.shape[0], page_n // 256) and mapped[1].shape == (p1.shape[0], 1, page_n // 256)
    assert torch.equal(plain[0], mapped[0]) and torch.equal(plain[3], mapped[3])
    assert torch.equal(plain[1], mapped[1][:, 0]) and torch.equal(plain[2], mapped[2][:, 0])


def _wide_meta_case():
    """Order-32 conv1 on u32 numbers: a page meta of 32 states of 32 bits
    and 4 indices, over 32 words."""
    t = np.arange(20_000)
    nums = (1e6 * np.sin(t * 0.01) + 2e6 + np.random.default_rng(77).integers(-64, 64, 20_000)).astype(np.uint32)
    return nums, pt.ChunkConfig(delta_spec=pt.DeltaSpec("try_conv1", 32)), 256, 8192


def test_wide_page_meta_case_reaches_its_layout():
    """The order-32 conv1 image's metas take over 32 words (K7's second meta
    word a lane), and its plain image is the port's container_compress
    bytes."""
    nums, cfg, page_n, chunk_n = _wide_meta_case()
    plan, a = _launch(nums, cfg, page_n, chunk_n, "cpu")
    assert max(plan.layout.meta_bits) > 32 * 32
    assert all(job.cc.meta.delta_encoding.kind == "conv1" for job in plan.enc.jobs)
    img = asm.file_image_to_bytes(*asm.run_image(plan, a))
    assert img == pt.container_compress(nums, cfg, page_n=page_n, chunk_n=chunk_n)


@pytest.mark.gpu
def test_wide_page_meta_matches_plain_on_card():
    """Exact: K7 places page metas of over 32 words (order-32 conv1 on u32)
    as its plain version does, and the image is container_compress's."""
    _need_card()
    nums, cfg, page_n, chunk_n = _wide_meta_case()
    plan, a = _launch(nums, cfg, page_n, chunk_n, "cuda")
    outs = ce.encode_launch(plan.launch, a)
    got = asm.image_assemble(plan, a, *outs)
    want = asm.image_assemble_plain(plan, a, *outs)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]) and got[2] == want[2]
    assert asm.file_image_to_bytes(*got[:2], plan.head_bytes, got[2]) == pt.container_compress(
        nums, cfg, page_n=page_n, chunk_n=chunk_n)
