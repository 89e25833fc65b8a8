"""The port's encode of numbers already on the card (a tensor, with or
without the caller's host copy) against the JAX package.

The screening that runs on the card when there is no host copy is held
against JAX's own device functions: `gcd_u64`, `triple_gcd_plain` (B8's
plain version), `phase_int_gcd`, `phase_int_est` and `phase_float_keep`
against `_gcd_u64`, `_phase_int_gcd`, `_phase_int_est` and
`_phase_float_keep`, and
`int_bases_collect` against the host `int_mult.choose_base_from_sample`.
Each file image planned from a CPU tensor equals pcodec_tpu's
`container_compress` bytes and the port's numpy route. Inputs come from
numpy with a seed; every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pcodec_tpu.ops.device_train as jdt
from pcodec_tpu.codec.chunk_config import ChunkConfig as RefChunkConfig
from pcodec_tpu.codec.chunk_config import DeltaSpec as RefDeltaSpec
from pcodec_tpu.codec.chunk_config import ModeSpec as RefModeSpec
from pcodec_tpu.codec.container import container_compress as ref_compress
from pcodec_tpu.modes import int_mult as ref_int_mult

from pcodec_tpu_torch import ChunkConfig, DeltaSpec, ModeSpec
from pcodec_tpu_torch.dtypes import number_type_from_np
from pcodec_tpu_torch.ops import assemble as asm
from pcodec_tpu_torch.ops import device_train as dt
from tests.test_torch_train_kernels import gcd_triples

torch.set_num_threads(1)  # the test workers share the cores: more intra-op threads spin on theirs

PAGE_N, CHUNK_N = 256, 2048


def _t(u64: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(u64, np.uint64).view(np.int64))


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def test_gcd_u64_matches_jax():
    """gcd_u64 equals JAX's _gcd_u64 (and numpy's gcd) on random u64
    pairs, on 0, 1, 2^63, 2^64 - 1 and powers of two, and on pairs of
    multiples of a common factor."""
    rng = np.random.default_rng(1)
    special = np.array([0, 1, 2, 3, 2**63, 2**64 - 1, 2**62, 2**32, 6, 2**63 + 2], np.uint64)
    pows = np.left_shift(np.uint64(1), np.arange(64, dtype=np.uint64))
    f = rng.integers(1, 2**20, 2000).astype(np.uint64)
    a = np.concatenate([rng.integers(0, 2**64, 2000, dtype=np.uint64), np.repeat(special, len(special)),
                        pows, f * rng.integers(0, 2**40, 2000).astype(np.uint64)])
    b = np.concatenate([rng.integers(0, 2**64, 2000, dtype=np.uint64), np.tile(special, len(special)),
                        pows[::-1], f * rng.integers(0, 2**40, 2000).astype(np.uint64)])
    got = _u64(dt.gcd_u64(_t(a), _t(b)))
    assert np.array_equal(got, np.asarray(jdt._gcd_u64(jnp.asarray(a), jnp.asarray(b))))
    assert np.array_equal(got, np.gcd(a, b))


def test_triple_gcd_plain_matches_jax():
    """triple_gcd_plain (B8's plain version) equals JAX's _gcd_u64 of each
    triple's differences, the triple sorted unsigned in numpy, where the
    triple is valid and the GCD is above 1: zeros, equal triples, powers of
    two, values from 2^63, multiples of a base and random triples."""
    sm, valid = gcd_triples(np.random.default_rng(4), 5000)
    n, m = sm.shape
    t = np.sort(_u64(sm)[:, : m // 3 * 3].reshape(n, m // 3, 3), axis=2)
    g = np.asarray(jdt._gcd_u64(jnp.asarray(t[..., 1] - t[..., 0]), jnp.asarray(t[..., 2] - t[..., 0])))
    ok = valid.numpy()[:, : m // 3 * 3].reshape(n, m // 3, 3).all(2) & (g > 1)
    got = _u64(dt.triple_gcd_plain(sm, valid))
    assert np.array_equal(got, np.where(ok, g, np.uint64(0)))
    assert (got != 0).sum() > 1000 and (got[ok] >= 2**63).any()


def _screen_samples(rng):
    """Chunks' samples back to back: timestamps with a base, a chunk of
    over 256 distinct GCDs, random u64 (top bits set), a short chunk, an
    empty one and one of a single triple."""
    parts = [
        (np.cumsum(rng.integers(1, 40, 900)) * 1000 + rng.integers(0, 3, 900)).astype(np.uint64),
        np.repeat(rng.integers(2, 10**6, 400), 3).astype(np.uint64) * rng.integers(0, 1000, 1200).astype(np.uint64),
        rng.integers(0, 2**64, 700, dtype=np.uint64),
        rng.integers(0, 50, 40).astype(np.uint64) * np.uint64(7) + np.uint64(2**63),
        np.zeros(0, np.uint64),
        np.array([10, 30, 50], np.uint64),
    ]
    lens = np.array([len(p) for p in parts], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    return np.concatenate(parts), starts, lens


def test_phase_int_gcd_and_est_match_jax():
    """phase_int_gcd's distinct GCDs, counts and n_unique equal JAX's
    _phase_int_gcd (a chunk with more than 256 distinct GCDs among them);
    phase_int_est's keep counts equal JAX's _phase_int_est."""
    rng = np.random.default_rng(2)
    mode_s, starts, lens = _screen_samples(rng)
    vals, cnts, nuniq = dt.phase_int_gcd(_t(mode_s), starts, lens)
    jv, jc, jn = jdt._phase_int_gcd(jnp.asarray(mode_s), jnp.asarray(starts), jnp.asarray(lens),
                                    n_chunks=len(lens), m_max=int(lens.max()), k=dt.GCD_K)
    assert np.array_equal(_u64(vals), np.asarray(jv))
    assert np.array_equal(cnts.numpy(), np.asarray(jc))
    assert np.array_equal(nuniq.numpy(), np.asarray(jn))
    assert int(nuniq[1]) > dt.GCD_K
    bases = np.array([1000, 7, 2**63 + 5, 2, 3, 10], np.uint64)
    cutoffs = np.array([3, 1, 2, 1, 1, 1], np.int32)
    got = dt.phase_int_est(_t(mode_s), starts, lens, bases, cutoffs)
    want = jdt._phase_int_est(jnp.asarray(mode_s), jnp.asarray(starts), jnp.asarray(lens), jnp.asarray(bases),
                              jnp.asarray(cutoffs), n_chunks=len(lens), m_max=int(lens.max()))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_int_bases_collect_matches_host_choose_base():
    """int_bases_collect's base of each chunk equals the JAX package's host
    int_mult.choose_base_from_sample of that chunk's sample (a base found,
    none found, and the chunk of many distinct GCDs that decides on its
    own sample)."""
    rng = np.random.default_rng(3)
    mode_s, starts, lens = _screen_samples(rng)
    got = dt.int_bases_collect(_t(mode_s), starts, lens, number_type_from_np(np.uint64).latent)
    want = [ref_int_mult.choose_base_from_sample(mode_s[a : a + m]) if m else None for a, m in zip(starts, lens)]
    assert got == [None if w is None else int(w) for w in want]
    assert got[0] == 1000


@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.float64])
def test_phase_float_keep_matches_jax(dtype):
    """phase_float_keep's flags equal JAX's _phase_float_keep on normal
    floats, subnormals, +-0, +-inf, NaN (payloads too) and values on
    either side of the sampling cap."""
    rng = np.random.default_rng(4)
    fi = np.finfo(dtype)
    width = np.dtype(dtype).itemsize * 8
    udt = {16: np.uint16, 32: np.uint32, 64: np.uint64}[width]
    cap = np.uint16(30719).view(np.float16) if dtype == np.float16 else fi.max * dtype(0.5)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, fi.tiny, fi.tiny / 4, -fi.tiny / 8, fi.max, -fi.max,
                        cap, -cap, np.nextafter(cap, dtype(np.inf)), np.nextafter(cap, dtype(0))], dtype)
    payload = np.array([(np.iinfo(udt).max >> 1) - 3, np.iinfo(udt).max - 1], udt).view(dtype)
    x = np.concatenate([(rng.standard_normal(3000) * 100).astype(dtype), special, payload])
    draws = rng.integers(0, len(x), 5000)
    prec = {16: 10, 32: 23, 64: 52}[width]
    mid, exp_mask = 1 << (width - 1), ((1 << (width - prec - 1)) - 1) << prec
    max_bits = int(np.asarray(cap, dtype).view(udt))
    got = dt.phase_float_keep(dt.bits_of(torch.from_numpy(x)), torch.from_numpy(draws), mid, exp_mask, max_bits)
    want = jdt._phase_float_keep(jnp.asarray(x.view(udt)), jnp.asarray(draws), mid=mid, exp_mask=exp_mask,
                                 max_bits=max_bits)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < len(draws)


def _cases():
    rng = np.random.default_rng(5)
    n = 2 * CHUNK_N + 700
    timestamps = (1_600_000_000_000 + np.cumsum(rng.integers(1, 40, n)) * 1000 + rng.integers(0, 3, n))
    return {
        "intmult_i64": (timestamps.astype(np.int64), {}),
        "floatmult_f64_auto": ((rng.integers(-5000, 5000, n) * 0.01).astype(np.float64), {}),
        "floatquant_f16": ((rng.integers(-900, 900, n) / 64).astype(np.float16),
                           {"mode": (ModeSpec.TRY_FLOAT_QUANT, 4)}),
        "dict_i64": (np.array([3, 99, 1234567, -5], np.int64)[rng.integers(0, 4, n)], {"mode": (ModeSpec.TRY_DICT,)}),
        "lookback_i64": (np.tile(rng.integers(0, 10**6, 512), n // 512 + 1)[:n] + rng.integers(0, 2, n),
                         {"delta": (DeltaSpec.TRY_LOOKBACK,)}),
        "classic_u32": (rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32) >> rng.integers(0, 20, n)
                        .astype(np.uint32), {}),
        "classic_i16": (np.cumsum(rng.integers(-30, 31, n)).astype(np.int16), {}),
        "fallback_i64": (rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64), {"delta": (DeltaSpec.TRY_CONSECUTIVE, 1)}),
    }


def _configs(spec):
    mode, delta = spec.get("mode"), spec.get("delta")
    ours = ChunkConfig(mode_spec=ModeSpec(*mode) if mode else ModeSpec(),
                       delta_spec=DeltaSpec(*delta) if delta else DeltaSpec())
    ref = RefChunkConfig(mode_spec=RefModeSpec(*mode) if mode else RefModeSpec(),
                         delta_spec=RefDeltaSpec(*delta) if delta else RefDeltaSpec())
    return ours, ref


CASES = _cases()


@pytest.mark.parametrize("case", list(CASES))
def test_plan_image_from_a_tensor(case):
    """plan_image from a CPU tensor, with and without its host copy,
    trains on the device and gives the image of pcodec_tpu's
    container_compress bytes and of the port's numpy route; without a
    copy only fallback chunks reach the host (counted)."""
    nums, spec = CASES[case]
    cfg, ref_cfg = _configs(spec)
    want = ref_compress(nums, ref_cfg, page_n=PAGE_N, chunk_n=CHUNK_N)
    plan = asm.plan_image(nums, cfg, PAGE_N, CHUNK_N, "cpu")
    assert asm.file_image_to_bytes(*asm.run_image(plan, asm.upload_image(plan, "cpu"))) == want
    fell_back = 0
    if case == "fallback_i64":  # the chunks the baseline compressor took: no delta, where the config asks for one
        fell_back = sum(cn for cn, j in zip(plan.enc.chunk_ns, plan.enc.jobs)
                        if j.cc.meta.delta_encoding.kind == "noop")
        assert fell_back > 0
    for mirror in (None, nums):
        tplan = asm.plan_image(torch.from_numpy(nums), cfg, PAGE_N, CHUNK_N, "cpu", nums_host=mirror)
        assert tplan.trained_on == "device"
        assert asm.file_image_to_bytes(*asm.run_image(tplan, asm.upload_image(tplan, "cpu"))) == want
        assert [j.cc.meta.mode.kind for j in tplan.enc.jobs] == [j.cc.meta.mode.kind for j in plan.enc.jobs]
        assert tplan.enc.host_copied == (fell_back if mirror is None else 0)
    if case == "intmult_i64":
        assert "int_mult" in {j.cc.meta.mode.kind for j in plan.enc.jobs}
    if case == "floatmult_f64_auto":
        assert "float_mult" in {j.cc.meta.mode.kind for j in plan.enc.jobs}


def test_plan_image_tensor_routes_that_leave_the_card():
    """A TRY_CONV1 tensor trains on the host (copied whole, counted); a
    host copy of the wrong dtype or length, a bfloat16 tensor and a 2-D
    one are refused, on the host-training route and the card's."""
    rng = np.random.default_rng(6)
    nums = ((1 << 16) * np.sin(0.01 * np.arange(5000)) + rng.integers(-16, 16, 5000)).astype(np.int32)
    cfg = ChunkConfig(delta_spec=DeltaSpec(DeltaSpec.TRY_CONV1, 4))
    ref_cfg = RefChunkConfig(delta_spec=RefDeltaSpec(RefDeltaSpec.TRY_CONV1, 4))
    plan = asm.plan_image(torch.from_numpy(nums), cfg, PAGE_N, CHUNK_N, "cpu")
    assert plan.trained_on == "host" and plan.enc.host_copied == len(nums)
    assert asm.file_image_to_bytes(*asm.run_image(plan, asm.upload_image(plan, "cpu"))) == ref_compress(
        nums, ref_cfg, page_n=PAGE_N, chunk_n=CHUNK_N)
    for c in (cfg, ChunkConfig()):
        for bad in (nums.astype(np.int64), nums[:-1]):
            with pytest.raises(ValueError):
                asm.plan_image(torch.from_numpy(nums), c, PAGE_N, CHUNK_N, "cpu", nums_host=bad)
    with pytest.raises(ValueError):
        asm.plan_image(torch.zeros(100, dtype=torch.bfloat16), ChunkConfig(), PAGE_N, CHUNK_N, "cpu")
    with pytest.raises(ValueError):
        asm.plan_image(torch.zeros((10, 10), dtype=torch.int64), ChunkConfig(), PAGE_N, CHUNK_N, "cpu")
