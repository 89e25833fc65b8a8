"""The port's lookback device training against the JAX package and its host
codec.

The chooser's plain version (B5's reference, which the CPU runs) is held
against JAX's `_choose_lookbacks_device` and the native chooser, the
lookback phase against JAX's `_phase_lookback`, each device-trained chunk
meta against pcodec_tpu's host `chunk_compressor` and each file image
against its `container_compress` bytes. B5 itself is held against the
plain version in test_torch_train_kernels.py. Inputs come from numpy with a
seed; every comparison is exact.
"""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pcodec_tpu.codec.compress as ref_cmp
import pcodec_tpu.ops.device_train as jdt
from pcodec_tpu.codec.chunk_config import ChunkConfig as RefChunkConfig
from pcodec_tpu.codec.chunk_config import DeltaSpec as RefDeltaSpec
from pcodec_tpu.codec.chunk_config import ModeSpec as RefModeSpec
from pcodec_tpu.codec.chunk_config import PagingSpec as RefPagingSpec
from pcodec_tpu.codec.container import _exact_split
from pcodec_tpu.codec.container import container_compress as ref_compress
from pcodec_tpu.dtypes import number_type_from_np as ref_number_type
from pcodec_tpu.format.bitio import BitWriter as RefBitWriter
from pcodec_tpu.native.kernels import choose_lookbacks_native

import pcodec_tpu_torch as pt
from pcodec_tpu_torch import constants as c
from pcodec_tpu_torch.format.bitio import BitWriter
from pcodec_tpu_torch.ops import assemble as asm
from pcodec_tpu_torch.ops import device_train as dt

PAGE_N = 256


def _wlog(n: int) -> int:
    return min(max((n - 1).bit_length(), c.LOOKBACK_MIN_WINDOW_N_LOG), c.LOOKBACK_MAX_WINDOW_N_LOG)


def _chooser_lanes(name):
    """(lanes of latents, bits, window_n_log): tests/test_device_train_phases.py's
    five chooser cases (the three 64-bit ones as lanes of one batch), and a
    batch of ragged lanes."""
    rng = np.random.default_rng(5)
    five = [np.tile(rng.integers(0, 1000, 64), 40).astype(np.uint64), rng.integers(0, 2**62, 2600).astype(np.uint64),
            np.cumsum(rng.integers(0, 100, 2600)).astype(np.uint64), rng.integers(0, 2**16, 777).astype(np.uint16),
            rng.integers(0, 255, 1300).astype(np.uint8)]
    if name == "u64_three_cases":
        return five[:3], 64, _wlog(2600)
    if name == "u16":
        return five[3:4], 16, _wlog(777)
    if name == "u8":
        return five[4:5], 8, _wlog(1300)
    if name.startswith("w4_u"):  # window_n_log 4 (a 5-bit hash: collisions, predecessor misses), a ragged page
        bits = int(name[4:])
        rng = np.random.default_rng(8 + bits)
        pat = rng.integers(0, 1 << bits, 11, dtype=np.uint64)
        lanes = [np.tile(pat, 19)[:200] ^ rng.integers(0, 4, 200).astype(np.uint64),
                 rng.integers(0, 1 << bits, 200, dtype=np.uint64), np.tile(pat[:3], 26)[:77]]
        return [lane.astype(f"uint{bits}") for lane in lanes], bits, 4
    rng = np.random.default_rng(6)  # ragged lanes: repeats, full-range u64, the top values, a lane of one
    pat = rng.integers(0, 2**64, 40, dtype=np.uint64)
    return [np.tile(pat, 12)[:480] + rng.integers(0, 2, 480).astype(np.uint64),
            rng.integers(0, 2**64, 300, dtype=np.uint64),
            np.tile(np.array([0, 2**64 - 1, 2**63, 5], np.uint64), 90),
            np.tile(pat[:5], 40), np.array([7], np.uint64)], 64, 9


SPLIT_CASES = ["w4_u8", "w4_u16", "w4_u32", "w4_u64"]


def _chooser_batch(name):
    """(x (lanes, m) u64 rows, lens, bits, window_n_log) of a chooser case."""
    lanes, bits, wnl = _chooser_lanes(name)
    x = np.zeros((len(lanes), max(len(x) for x in lanes)), np.uint64)
    for k, lane in enumerate(lanes):
        x[k, : len(lane)] = lane
    return x, np.array([len(lane) for lane in lanes], np.int64), bits, wnl


@pytest.mark.parametrize("name", SPLIT_CASES)
def test_choose_lookbacks_split_plain_matches_jax_and_plain(name):
    """Exact, lane by lane: B5's two-pass structure in torch (the hash reads
    of every position, then the chain of counts and repeats) equals JAX's
    `_choose_lookbacks_device` and choose_lookbacks_plain, and its hash pass
    equals JAX's precomputed reads (slots 10-15) on every position."""
    x, lens, bits, wnl = _chooser_batch(name)
    xt, lt = torch.from_numpy(x.view(np.int64)), torch.from_numpy(lens)
    got = dt.choose_lookbacks_split_plain(xt, lt, bits, wnl, 1)
    want = np.asarray(jdt._choose_lookbacks_device(jnp.asarray(x), jnp.asarray(lens.astype(np.int32)), bits, wnl, 1))
    assert np.array_equal(got.numpy(), want.astype(np.int32))
    assert torch.equal(got, dt.choose_lookbacks_plain(xt, lt, bits, wnl, 1))
    props = dt.lookback_hash_props_plain(xt, lt, wnl, 1)
    assert props.shape == (len(lens), dt.LOOKBACK_HASH_SLOTS, x.shape[1])
    assert int(props.max()) <= 1 << wnl and int(props[:, :, 1:].min()) >= 1


@pytest.mark.parametrize("name", ["u64_three_cases", "u16", "u8", "ragged_lanes"] + SPLIT_CASES)
def test_choose_lookbacks_plain_matches_jax_and_native(name):
    """Exact: every lane's lookbacks from choose_lookbacks_plain equal JAX's
    `_choose_lookbacks_device` on the same batch and the native chooser on
    the lane alone, zeros past each lane's length, at state_n 1."""
    lanes, bits, wnl = _chooser_lanes(name)
    m = max(len(x) for x in lanes)
    x = np.zeros((len(lanes), m), np.uint64)
    for k, lane in enumerate(lanes):
        x[k, : len(lane)] = lane
    lens = np.array([len(lane) for lane in lanes], np.int64)
    got = dt.choose_lookbacks_plain(torch.from_numpy(x.view(np.int64)), torch.from_numpy(lens), bits, wnl, 1).numpy()
    want = np.asarray(jdt._choose_lookbacks_device(jnp.asarray(x), jnp.asarray(lens.astype(np.int32)), bits, wnl, 1))
    assert got.shape == (len(lanes), m - 1) and np.array_equal(got, want.astype(np.int32))
    for k, lane in enumerate(lanes):
        native = choose_lookbacks_native(wnl, 1, lane)
        assert np.array_equal(got[k, : len(native)].astype(np.uint32), native), k
        assert not got[k, len(native) :].any()


def test_phase_lookback_matches_jax():
    """Exact: on 2 chunks x 4 page rows x 256 (a ragged last page), the
    lookback phase's primary rows, lookback rows, states and both vars'
    walked bins equal JAX `_phase_lookback`'s."""
    rng = np.random.default_rng(7)
    rpc, m = 4, PAGE_N
    lat = np.tile(rng.integers(0, 10**6, 100), 21)[: 2 * rpc * m].astype(np.uint64)
    lat += rng.integers(0, 3, len(lat)).astype(np.uint64)
    rowlen = np.array([m, m, m, m, m, m, m, 130], np.int64)
    lat.reshape(2 * rpc, m)[7, 130:] = 0
    nreal = [int(rowlen[:4].sum()) - 4, int(rowlen[4:].sum()) - 4]
    wnl, ubl = 10, 6
    prim, lbs, states, bins_p, bins_d = dt.phase_lookback(
        torch.from_numpy(lat.view(np.int64).reshape(2 * rpc, m)), rowlen, [wnl, wnl], nreal, [ubl, ubl], 1, 64)
    jp, jl, js, dp, np_, dd, nd = (np.asarray(a) for a in jdt._phase_lookback(
        jnp.asarray(lat.reshape(2 * rpc, m)), jnp.asarray(rowlen.astype(np.int32)), jnp.asarray(np.array(nreal)),
        jnp.asarray(np.array(nreal)), n_chunks=2, rows_per_chunk=rpc, page_n=m, lat_bits=64, wnl=wnl, state_n=1,
        nb_log=ubl))
    assert np.array_equal(prim.numpy().view(np.uint64), jp)
    assert np.array_equal(lbs.numpy().astype(np.uint64), jl[:, : m - 1]) and not jl[:, m - 1 :].any()
    assert np.array_equal(states.numpy().view(np.uint64), js)
    for bins, dense, nbn in ((bins_p, dp, np_), (bins_d, dd, nd)):
        starts = np.concatenate([[0], np.cumsum(nbn)])
        for k, (co, lo, up) in enumerate(bins):
            d = dense[starts[k] : starts[k + 1]]
            assert np.array_equal(lo, d[:, 0]) and np.array_equal(up, d[:, 1]) and np.array_equal(co, d[:, 2])


def _repeats(rng, n, dtype, width=300, vals=10**6):
    return (np.tile(rng.integers(0, vals, width), -(-n // width))[:n] + rng.integers(0, 2, n)).astype(dtype)


def _cfgs(mode=("classic", 0.0), delta=("try_lookback", 0)):
    return (pt.ChunkConfig(mode_spec=pt.ModeSpec(*mode), delta_spec=pt.DeltaSpec(*delta)),
            RefChunkConfig(mode_spec=RefModeSpec(*mode), delta_spec=RefDeltaSpec(*delta)))


# (numbers from a seeded generator, chunk_n, mode spec, delta spec, the
# (mode, delta) kinds the chunks must take)
META_CASES = {
    "try_lookback_i64": (lambda rng: _repeats(rng, 9000, np.int64), 4096, ("classic", 0.0), ("try_lookback", 0),
                         {("classic", "lookback")}),
    "try_lookback_u16": (lambda rng: _repeats(rng, 6000, np.uint16, 50, 60000), 4096, ("classic", 0.0),
                         ("try_lookback", 0), {("classic", "lookback")}),
    "try_lookback_f32": (lambda rng: np.tile(rng.standard_normal(300).astype(np.float32), 20), 4096,
                         ("classic", 0.0), ("try_lookback", 0), {("classic", "lookback")}),
    "auto_lookback_winner": (lambda rng: _repeats(rng, 40_000, np.int64, 700), 32768, ("auto", 0.0), ("auto", 0),
                             {("classic", "lookback"), ("classic", "noop")}),
    "int_mult_lookback": (lambda rng: _repeats(rng, 6000, np.int64) * 1000 + rng.integers(0, 7, 6000), 4096,
                          ("try_int_mult", 1000.0), ("try_lookback", 0), {("int_mult", "lookback")}),
    "dict_lookback": (lambda rng: rng.integers(-(10**12), 10**12, 50)[np.tile(rng.integers(0, 50, 120), 50)], 4096,
                      ("try_dict", 0.0), ("try_lookback", 0), {("dict", "lookback")}),
}


@pytest.mark.parametrize("name", list(META_CASES))
def test_lookback_metas_match_host(name):
    """Exact: every chunk meta plan_encode_device trains with a lookback
    delta (the lookbacks' and the primary's bins and ANS sizes, the window)
    writes pcodec_tpu's host chunk_compressor bytes: TRY_LOOKBACK on i64,
    u16 and f32, an auto-delta lookback winner beside a chunk that does not
    pick it, IntMult with lookback (three vars: the lookbacks, the split's
    primaries, the secondary) and Dict with lookback (the u32 indices)."""
    gen, chunk_n, mode, delta, kinds = META_CASES[name]
    nums = gen(np.random.default_rng(16))
    cfg, ref_cfg = _cfgs(mode, delta)
    plan = dt.plan_encode_device(nums, cfg, PAGE_N, chunk_n, "cpu")
    assert plan.trained_on == "device"
    assert {(job.cc.meta.mode.kind, job.cc.meta.delta_encoding.kind) for job in plan.jobs} == kinds
    nt = ref_number_type(nums.dtype)
    for ci, job in enumerate(plan.jobs):
        chunk = nums[ci * chunk_n : (ci + 1) * chunk_n]
        w, rw = BitWriter(), RefBitWriter()
        job.cc.write_meta(w)
        ref_cmp.chunk_compressor(nt, chunk, replace(ref_cfg, paging_spec=RefPagingSpec.exact_pages(
            _exact_split(len(chunk), PAGE_N)))).write_meta(rw)
        assert w.to_bytes() == rw.to_bytes(), ci


IMAGE_CASES = {
    # three chunks, the last of another window, each with a ragged last page
    "try_lookback_windows": (lambda rng: _repeats(rng, 10_000, np.int64), 4096, ("classic", 0.0),
                             ("try_lookback", 0)),
    "auto_mixed": (lambda rng: np.concatenate([_repeats(rng, 32768, np.int64),
                                               np.cumsum(rng.integers(0, 100, 9000)).astype(np.int64)]), 32768,
                   ("auto", 0.0), ("auto", 0)),
    "int_mult_lookback": (lambda rng: _repeats(rng, 6000, np.int64) * 1000 + rng.integers(0, 7, 6000), 4096,
                          ("try_int_mult", 1000.0), ("try_lookback", 0)),
    "dict_lookback": (lambda rng: rng.integers(-(10**12), 10**12, 50)[np.tile(rng.integers(0, 50, 120), 50)], 4096,
                      ("try_dict", 0.0), ("try_lookback", 0)),
}


@pytest.mark.parametrize("name", list(IMAGE_CASES))
def test_lookback_image_matches_container_compress(name):
    """Exact: the file image trained on the card equals pcodec_tpu's
    container_compress bytes, the lookbacks' chains from the device's
    lookback rows and the primary's from its rows after each page's state:
    TRY_LOOKBACK over chunks of two windows, a plan mixing a lookback and a
    consecutive chunk, IntMult and Dict with lookback."""
    gen, chunk_n, mode, delta = IMAGE_CASES[name]
    nums = gen(np.random.default_rng(17))
    cfg, ref_cfg = _cfgs(mode, delta)
    plan = asm.plan_image(nums, cfg, PAGE_N, chunk_n, "cpu")
    assert plan.trained_on == "device"
    encs = [job.cc.meta.delta_encoding for job in plan.enc.jobs]
    assert encs[0].kind == "lookback"
    if name == "try_lookback_windows":
        assert len({e.window_n_log for e in encs}) == 2
    if name == "auto_mixed":
        assert encs[1].kind != "lookback"
    got = asm.file_image_to_bytes(*asm.run_image(plan, asm.upload_image(plan, "cpu")))
    assert got == ref_compress(nums, ref_cfg, page_n=PAGE_N, chunk_n=chunk_n)
