"""The port's device training of every mode (IntMult, Dict, FloatQuant,
FloatMult) against the JAX package and its host codec.

The unsigned division and the FloatMult split are held against numpy's
uint64 arithmetic, the host `split_latents` and JAX's
`float_mult_split_device`; the Dict split against JAX's `_phase_dict` and
the host `dict_mode`; each device-trained chunk meta against pcodec_tpu's
host `chunk_compressor` and each file image against its
`container_compress` bytes. On the CPU K8 and K9 run their plain versions
(the kernels are held against them in test_torch_train_kernels.py). Inputs
come from numpy with a seed; every comparison is exact.
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
from pcodec_tpu.modes import dict_mode as ref_dict_mode
from pcodec_tpu.modes import float_mult as ref_float_mult
from pcodec_tpu.ops import softfloat as ref_sf

import pcodec_tpu_torch as pt
from pcodec_tpu_torch.dtypes import number_type_from_np
from pcodec_tpu_torch.format.bitio import BitWriter
from pcodec_tpu_torch.ops import assemble as asm
from pcodec_tpu_torch.ops import device_train as dt
from pcodec_tpu_torch.ops import softfloat as sf

torch.set_num_threads(1)  # the test workers share the cores: more intra-op threads spin on theirs

N = 40_000
PAGE_N, CHUNK_N = 256, 16_384


def test_udivmod_matches_numpy_uint64():
    """Exact: udivmod's quotient and remainder equal numpy's uint64 // and
    % for values over the whole u64 range (the top bit set included) and
    divisors from 1 to 2^64 - 1, 2^63 and above among them."""
    rng = np.random.default_rng(11)
    x = np.concatenate([rng.integers(0, 2**64, 6000, dtype=np.uint64),
                        np.array([0, 1, 2**63 - 1, 2**63, 2**64 - 1], np.uint64)])
    d = np.concatenate([rng.integers(1, 2**64, 3000, dtype=np.uint64), rng.integers(1, 2**16, 2000).astype(np.uint64),
                        rng.integers(2**63, 2**64, 1000, dtype=np.uint64),
                        np.array([1, 2, 2**63, 2**63 + 1, 2**64 - 1], np.uint64)])
    q, r = dt.udivmod(torch.from_numpy(x.view(np.int64)), torch.from_numpy(d.view(np.int64)))
    assert np.array_equal(q.numpy().view(np.uint64), x // d)
    assert np.array_equal(r.numpy().view(np.uint64), x % d)


@pytest.mark.parametrize("dtype,base", [(np.float16, 0.25), (np.float32, 0.01), (np.float64, 0.01)])
def test_float_mult_split_matches_host_and_jax(dtype, base):
    """Exact: the softfloat FloatMult split (primary and adjustment) equals
    the host `split_latents` (numpy's multiply) on adversarial bits (random
    patterns: NaNs with payloads, infinities, subnormals, signed zeros;
    multiples of the base; their neighbours one ulp away), and JAX's
    `float_mult_split_device` wherever JAX agrees with the host."""
    rng = np.random.default_rng(12)
    nt = ref_number_type(np.dtype(dtype))
    L = nt.latent.np_dtype
    W, P = nt.latent.bits, nt.mantissa_digits
    nums = rng.integers(0, 2**W, 12_000, dtype=np.uint64).astype(L).view(dtype)
    nums[:4000] = (rng.integers(-5000, 5000, 4000) * dtype(base)).astype(dtype)
    nums.view(L)[4000:6000] = nums.view(L)[:2000] + L.type(1)
    nums.view(L)[6000:6010] = np.array([0, 1 << (W - 1), 1, (1 << (W - 1)) + 1] + [0] * 6, L)
    b = dtype(base)
    ib = dtype(1.0) / b
    with np.errstate(all="ignore"):
        hp, ha = ref_float_mult.split_latents(nt, nums, b, ib)
    lat = nt.to_latent_ordered(nums).astype(np.uint64)
    bits = [int(np.asarray(v, dtype).view(L)) for v in (ib, b)]
    p, a = sf.float_mult_split(torch.from_numpy(lat.view(np.int64)), *(torch.tensor(sf._i64(v)) for v in bits),
                               W, W - P, P)
    p, a = (t.numpy().view(np.uint64) for t in (p, a))
    assert np.array_equal(p, hp.astype(np.uint64)) and np.array_equal(a, ha.astype(np.uint64))
    jp, ja = ref_sf.float_mult_split_device(jnp.asarray(lat), jnp.uint64(bits[0]), jnp.uint64(bits[1]), W=W,
                                            E=W - P, P=P)
    for got, want, host in ((p, np.asarray(jp), hp), (a, np.asarray(ja), ha)):
        agree = want == host.astype(np.uint64)
        assert np.array_equal(got[agree], want[agree])


@pytest.mark.parametrize("dtype", [np.int64, np.float32])
def test_phase_dict_matches_jax_and_host(dtype):
    """Exact: per chunk, phase_dict's dictionary equals the host
    `configure_and_split_latents`' (descending count, ties in ascending
    unsigned value) and JAX `_phase_dict`'s, and each number's index
    equals both; values of both signs, so the unsigned order differs from
    int64's."""
    rng = np.random.default_rng(13)
    vals = rng.integers(-(10**12), 10**12, 300).astype(dtype)
    nums = vals[rng.integers(0, 300, 9000) % rng.integers(1, 300, 9000)]
    nt = number_type_from_np(nums.dtype)
    chunk_ns = [4096, 4096, 808]
    idx, dicts = dt.phase_dict(dt.latents_on_card(nums, nt, "cpu"), chunk_ns)
    idx = idx.numpy()
    rnt = ref_number_type(nums.dtype)
    starts = np.array([0, 4096, 8192])
    j_idx, j_uniq, j_small = jdt._phase_dict(jnp.asarray(nums), jnp.asarray(starts), kind=rnt.kind,
                                             mid=int(rnt.latent.mid), n_chunks=3, dcap=9000)
    j_idx, j_uniq, U = np.asarray(j_idx), np.asarray(j_uniq), np.asarray(j_small)[:3].astype(np.int64)
    assert np.array_equal(idx, j_idx.astype(np.int64))
    for ci, (st, cn) in enumerate(zip(starts, chunk_ns)):
        d_host, i_host = ref_dict_mode.configure_and_split_latents(rnt, nums[st : st + cn])
        got = dicts[ci].numpy().view(np.uint64)
        assert np.array_equal(got, d_host.astype(np.uint64))
        assert np.array_equal(got, j_uniq[U[:ci].sum() : U[: ci + 1].sum()])
        assert np.array_equal(idx[st : st + cn], i_host.astype(np.int64))


def test_device_train_supported_covers_every_mode_but_lookback():
    """Decided from the type and configuration alone: every mode spec
    trains on the card under NOOP, consecutive, lookback or auto delta
    (TRY_LOOKBACK, which trained on the host before lookback training came
    to the card, included); a float mode on integers, IntMult on floats, a
    FloatQuant k outside 1 .. bits - 1 and a FloatMult base whose inverse
    is not normal do not."""
    f32, i64 = number_type_from_np(np.dtype(np.float32)), number_type_from_np(np.dtype(np.int64))

    def ok(nt, mode=("auto", 0.0), delta=("auto", 0)):
        cfg = pt.ChunkConfig(mode_spec=pt.ModeSpec(*mode), delta_spec=pt.DeltaSpec(*delta))
        return dt.device_train_supported(nt, cfg, PAGE_N, CHUNK_N)

    for nt in (f32, i64):
        for mode in ("auto", "classic", "try_dict"):
            assert all(ok(nt, (mode, 0.0), d) for d in (("auto", 0), ("no_op", 0), ("try_consecutive", 2)))
        assert ok(nt, delta=("try_lookback", 0))
    assert ok(i64, ("try_int_mult", 7.0)) and not ok(f32, ("try_int_mult", 7.0)) and not ok(i64, ("try_int_mult", 1.0))
    assert ok(f32, ("try_float_quant", 5.0)) and not ok(f32, ("try_float_quant", 32.0))
    assert not ok(i64, ("try_float_quant", 5.0))
    assert ok(f32, ("try_float_mult", 0.01)) and not ok(f32, ("try_float_mult", 1e-39))
    assert not ok(i64, ("try_float_mult", 0.01))


def _timestamps(rng, n=N):
    return np.cumsum(rng.integers(1, 2000, n)).astype(np.int64) * 1_000_000_000 + rng.integers(0, 3, n)


def _cfgs(mode=("auto", 0.0), delta=("auto", 0)):
    return (pt.ChunkConfig(mode_spec=pt.ModeSpec(*mode), delta_spec=pt.DeltaSpec(*delta)),
            RefChunkConfig(mode_spec=RefModeSpec(*mode), delta_spec=RefDeltaSpec(*delta)))


# (numbers from a seeded generator, mode spec, delta spec, the modes the chunks must take)
META_CASES = {
    "int_mult_auto": (_timestamps, ("auto", 0.0), ("auto", 0), {"int_mult"}),
    "try_int_mult": (lambda rng: (rng.integers(0, 1000, N) * 1_000_000 + rng.integers(0, 5, N)).astype(np.int64),
                     ("try_int_mult", 1e6), ("no_op", 0), {"int_mult"}),
    "try_dict": (lambda rng: np.array([3, 99, 1234567, -5], np.int64)[rng.integers(0, 4, N)], ("try_dict", 0.0),
                 ("auto", 0), {"dict"}),
    "try_dict_consecutive": (lambda rng: rng.integers(-(10**6), 10**6, 300)[np.cumsum(rng.integers(0, 3, N)) % 300]
                             .astype(np.int32), ("try_dict", 0.0), ("try_consecutive", 1), {"dict"}),
    "f16_auto": (lambda rng: (np.round(rng.standard_normal(N) * 16) / 16).astype(np.float16), ("auto", 0.0),
                 ("auto", 0), {"classic"}),
    "f32_auto_float_quant": (lambda rng: (rng.standard_normal(N).astype(np.float32).view(np.uint32)
                                          & np.uint32(0xFFFFF000)).view(np.float32), ("auto", 0.0), ("auto", 0),
                             {"float_quant"}),
    "f64_auto_mixed": (lambda rng: np.concatenate([rng.integers(-5000, 5000, CHUNK_N) * 0.01,
                                                   np.cumsum(rng.standard_normal(CHUNK_N)),
                                                   (rng.standard_normal(N - 2 * CHUNK_N).astype(np.float32).view(
                                                       np.uint32) & np.uint32(0xFFFFFF00)).view(np.float32)
                                                   .astype(np.float64)]),
                       ("auto", 0.0), ("auto", 0), {"float_mult", "classic", "float_quant"}),
    "try_float_quant": (lambda rng: (np.round(rng.standard_normal(N) * 64) / 64).astype(np.float32),
                        ("try_float_quant", 6.0), ("try_consecutive", 1), {"float_quant"}),
    "try_float_mult": (lambda rng: (rng.integers(-5000, 5000, N) * np.float32(0.01)).astype(np.float32),
                       ("try_float_mult", 0.01), ("auto", 0), {"float_mult"}),
}


def _ref_meta(nums, ref_cfg):
    nt = ref_number_type(nums.dtype)
    cfg = replace(ref_cfg, paging_spec=RefPagingSpec.exact_pages(_exact_split(len(nums), PAGE_N)))
    w = RefBitWriter()
    ref_cmp.chunk_compressor(nt, nums, cfg).write_meta(w)
    return w.to_bytes()


@pytest.mark.parametrize("name", list(META_CASES))
def test_device_trained_metas_of_every_mode_match_host(name):
    """Exact: every chunk meta that plan_encode_device trains (mode and its
    parameter, delta, both latent vars' bins and ANS sizes) writes
    pcodec_tpu's host chunk_compressor bytes, for IntMult under auto mode
    and pinned, TRY_DICT with and without a consecutive delta, f16/f32/f64
    under auto mode (Classic, FloatQuant and FloatMult winners, mixed
    across chunks) and pinned FloatQuant and FloatMult."""
    gen, mode, delta, kinds = META_CASES[name]
    nums = gen(np.random.default_rng(14))
    cfg, ref_cfg = _cfgs(mode, delta)
    plan = dt.plan_encode_device(nums, cfg, PAGE_N, CHUNK_N, "cpu")
    assert plan.trained_on == "device"
    assert {job.cc.meta.mode.kind for job in plan.jobs} == kinds
    for ci, job in enumerate(plan.jobs):
        w = BitWriter()
        job.cc.write_meta(w)
        assert w.to_bytes() == _ref_meta(nums[ci * CHUNK_N : (ci + 1) * CHUNK_N], ref_cfg), ci


IMAGE_CASES = {
    "mixed_classic_int_mult": (lambda rng: np.concatenate([_timestamps(rng, CHUNK_N),
                                                           np.cumsum(rng.integers(0, 100, N - CHUNK_N))
                                                           .astype(np.int64)]), ("auto", 0.0), ("auto", 0)),
    "trivial_secondary": (lambda rng: (rng.integers(0, 1000, N) * 7919).astype(np.uint32), ("try_int_mult", 7919.0),
                          ("try_consecutive", 2)),
    "float_mult": (lambda rng: (rng.integers(-5000, 5000, N) * 0.01), ("auto", 0.0), ("no_op", 0)),
    "dict": (lambda rng: rng.integers(-(10**12), 10**12, 700)[rng.integers(0, 700, N)], ("try_dict", 0.0),
             ("auto", 0)),
}


@pytest.mark.parametrize("name", list(IMAGE_CASES))
def test_device_trained_image_of_every_mode_matches_container_compress(name):
    """Exact: the file image trained on the card equals pcodec_tpu's
    container_compress bytes: mixed Classic and IntMult chunks, an exact
    multiple (a trivial secondary, which writes its directory entries but
    no chain), FloatMult f64 and Dict. Both vars' chains come from their
    own device rows."""
    gen, mode, delta = IMAGE_CASES[name]
    nums = gen(np.random.default_rng(15))
    cfg, ref_cfg = _cfgs(mode, delta)
    plan = asm.plan_image(nums, cfg, PAGE_N, CHUNK_N, "cpu")
    assert plan.trained_on == "device"
    jobs = plan.enc.jobs
    if name == "trivial_secondary":
        assert all(job.vars[1].trivial and not job.vars[0].trivial for job in jobs)
    if name == "mixed_classic_int_mult":
        assert [len(job.vars) for job in jobs] == [2, 1, 1]
    got = asm.file_image_to_bytes(*asm.run_image(plan, asm.upload_image(plan, "cpu")))
    assert got == ref_compress(nums, ref_cfg, page_n=PAGE_N, chunk_n=CHUNK_N)
