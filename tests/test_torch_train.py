"""The port's device training (pcodec_tpu_torch.ops.device_train) against
the JAX package.

On the CPU K8 and K9 run their plain versions (the CUDA kernels are held
against them in test_torch_train_kernels.py). JAX's phases run as plain XLA
on the CPU (its walk is the lax.scan, no interpret mode). Inputs come from
numpy with a seed; every comparison is exact.
"""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pcodec_tpu.codec.compress as ref_cmp
import pcodec_tpu.ops.device_train as jdt
from pcodec_tpu.binning.histogram import histogram as ref_histogram
from pcodec_tpu.codec.chunk_config import ChunkConfig as RefChunkConfig
from pcodec_tpu.codec.chunk_config import DeltaSpec as RefDeltaSpec
from pcodec_tpu.codec.chunk_config import ModeSpec as RefModeSpec
from pcodec_tpu.codec.chunk_config import PagingSpec as RefPagingSpec
from pcodec_tpu.codec.container import _exact_split
from pcodec_tpu.codec.container import container_compress as ref_compress
from pcodec_tpu.dtypes import number_type_from_np as ref_number_type
from pcodec_tpu.format.bitio import BitWriter as RefBitWriter

import pcodec_tpu_torch as pt
from pcodec_tpu_torch.codec import compress as cmp
from pcodec_tpu_torch.dtypes import number_type_from_np
from pcodec_tpu_torch.format.bitio import BitWriter
from pcodec_tpu_torch.ops import assemble as asm
from pcodec_tpu_torch.ops import device_train as dt

torch.set_num_threads(1)  # the test workers share the cores: more intra-op threads spin on theirs

RNG = np.random.default_rng(2031)


def _configs(kind):
    """(port config, JAX config) of one of the slice's configurations."""
    delta = {"auto": ("auto", 0), "consecutive1": ("try_consecutive", 1), "noop": ("no_op", 0)}[kind]
    return (pt.ChunkConfig(delta_spec=pt.DeltaSpec(*delta)),
            RefChunkConfig(delta_spec=RefDeltaSpec(*delta)))


def _walk_cases():
    """tests/test_device_train_phases.py's walk cases."""
    rng = np.random.default_rng(5)
    return [
        rng.integers(0, 10, 5000).astype(np.uint64),
        np.zeros(3000, dtype=np.uint64),
        rng.integers(0, 2**63, 5000).astype(np.uint64),
        np.repeat(rng.integers(0, 50, 100), 50).astype(np.uint64),
        np.full(1000, 0xFFFFFFFFFFFFFFFF, dtype=np.uint64),
        rng.integers(0, 3, 777).astype(np.uint64),
        np.arange(4096, dtype=np.uint64),
        rng.integers(0, 2, 10).astype(np.uint64),
    ]


@pytest.mark.parametrize("nb_log", [2, 5, 8])
def test_walk_plain_matches_jax_scan_and_host_histogram(nb_log):
    """Exact: walk_bins_plain over the port's extracts equals JAX's jitted
    `_walk_bins_device` over the same extracts and pcodec_tpu's histogram()."""
    cases = _walk_cases()
    m = max(len(x) for x in cases)
    vals = np.zeros((len(cases), m), np.uint64)
    live = np.zeros((len(cases), m), bool)
    for i, x in enumerate(cases):
        vals[i, : len(x)] = RNG.permutation(x)
        live[i, : len(x)] = True
    n = torch.tensor([len(x) for x in cases], dtype=torch.int64)
    ext = dt.sorted_extracts(torch.from_numpy(vals.view(np.int64)), torch.from_numpy(live), n,
                             torch.full_like(n, nb_log))
    tabs = [t[:, : 1 << nb_log] for t in ext[:5]]
    got = dt.walk_bins_plain(*tabs, ext[5], n, nb_log)
    u64 = [np.uint64, np.int64, np.int64, np.uint64, np.uint64, np.uint64]
    jargs = [jnp.asarray(t.numpy().view(d)) for t, d in zip(tabs + [ext[5]], u64)]
    want = jdt.jax.jit(jdt._walk_bins_device, static_argnames=("nb_log",))(*jargs, jnp.asarray(n.numpy()),
                                                                        nb_log=nb_log)
    co, lo, up = (np.asarray(a).astype(np.uint64) for a in want[:3])
    assert np.array_equal(got[3].numpy(), np.asarray(want[3]))
    for a, b in zip(got[:3], (co, lo, up)):
        assert np.array_equal(a.numpy().view(np.uint64), b)
    for i, x in enumerate(cases):
        k = int(got[3][i])
        host = [(b.count, b.lower, b.upper) for b in ref_histogram(x.copy(), nb_log)]
        assert [(int(co[i, j]), int(lo[i, j]), int(up[i, j])) for j in range(k)] == host


@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_phase_delta_sort_matches_jax(dtype):
    """Exact, on 2 chunks x 4 rows x 256 with a ragged last page and orders
    1 and 3: the delta'd rows, the moments, V/L/R/SL1/SR and s0 of the
    port's phase B equal JAX's `_phase_delta_sort`."""
    nums = np.cumsum(RNG.integers(-40, 90, 1900)).astype(dtype)
    nt = number_type_from_np(nums.dtype)
    page_n, rpc = 256, 4
    chunk_ns = [1024, 876]
    rowlen = np.array([256] * 4 + [256, 256, 256, 108])
    orders, bits = [1, 3], nt.latent.bits
    nreal = [sum(max(p - o, 0) for p in _exact_split(cn, page_n)) for cn, o in zip(chunk_ns, orders)]
    ubls = [cmp.choose_unoptimized_bins_log(8, cn) for cn in chunk_ns]
    lat2d, _ = dt.phase_latents(nums, nt, 2 * rpc, page_n, None, "cpu")
    rows, moments, ext = dt.phase_delta_sort(lat2d, orders, rowlen, nreal, ubls, bits)

    NB = 1 << max(ubls)
    eidx = np.zeros((2, NB), np.int64)
    for ci, (nr, ubl) in enumerate(zip(nreal, ubls)):
        j = np.arange(1 << ubl)
        eidx[ci, : 1 << ubl] = np.minimum((((j + 1) * nr + (1 << ubl) - 1) >> ubl) - 1, nr - 1)
    want = jdt._phase_delta_sort(
        jnp.asarray(lat2d.numpy().view(np.uint64)), jnp.asarray(np.repeat(orders, rpc).astype(np.int32)),
        jnp.asarray(rowlen.astype(np.int32)), jnp.asarray(np.array(nreal, np.int32)), jnp.asarray(eidx),
        max_order=3, n_chunks=2, rows_per_chunk=rpc, page_n=page_n, lat_bits=bits)
    got = [rows, moments, *ext]
    for name, a, b in zip(("rows", "moments", "V", "L", "R", "SL1", "SR", "s0"), got, want):
        assert np.array_equal(a.numpy().astype(np.int64), np.asarray(b).astype(np.int64)), name


@pytest.mark.parametrize("stage", [1, 2])
def test_candidate_bins_match_jax(stage):
    """Exact: the port's auto-delta candidate bins (stage 1: orders 0-2;
    stage 2: orders 3-7) equal JAX's `_phase_delta_candidates` with
    cands="orders", read back by `_fetch_packed_bins`."""
    samples = [np.cumsum(RNG.integers(0, 120, 2600)), RNG.integers(0, 2**40, 1700),
               np.cumsum(np.cumsum(RNG.integers(0, 5, 2200)))]
    delta_s = np.concatenate(samples).astype(np.uint64)
    lens = np.array([len(s) for s in samples])
    starts = np.cumsum(np.concatenate([[0], lens[:-1]]))
    lo, hi = (0, 2) if stage == 1 else (3, 7)
    got = dt.delta_candidates(torch.from_numpy(delta_s.view(np.int64)), starts, lens, lo, hi, 6, 64)
    dense, nbn = jdt._phase_delta_candidates(
        jnp.asarray(delta_s), jnp.asarray(starts.astype(np.int32)), jnp.asarray(lens.astype(np.int32)),
        n_chunks=3, m_max=int(lens.max()), max_order=hi, nb_log=6, lat_bits=64, window_n_log=4,
        cands="orders", min_order=lo)
    want = jdt._fetch_packed_bins(dense, nbn)
    n_cand = hi - lo + 1
    for ci, cands in enumerate(got):
        assert len(cands) == n_cand
        for k, (bins, n_stored) in enumerate(cands):
            assert n_stored == max(lens[ci] - (lo + k), 0)
            for a, b in zip(bins, want[ci * n_cand + k]):
                assert np.array_equal(a, np.asarray(b).astype(np.uint64))


# tests/test_pallas_encode.py's TestDeviceTrain inputs
TRAIN_CASES = {
    "i64_delta1": lambda rng: np.cumsum(rng.integers(0, 120, 200_000)).astype(np.int64),
    "u32_noop": lambda rng: rng.integers(0, 5000, 200_000).astype(np.uint32),
    "i32_wrap": lambda rng: np.cumsum(rng.integers(-3, 9, 200_000)).astype(np.int32),
    "i16": lambda rng: rng.integers(-300, 300, 200_000).astype(np.int16),
    "u64_second_order": lambda rng: np.cumsum(np.cumsum(rng.integers(0, 5, 200_000))).astype(np.uint64),
}


def _fallback_case(rng):
    """High-entropy chunks under order-3 delta fall back to the baseline
    compressor, and so does a last chunk of one number (no stored latent)."""
    return np.concatenate([rng.integers(-(2**63), 2**63 - 1, 131072, dtype=np.int64),
                           np.cumsum(rng.integers(0, 50, 131073)).astype(np.int64)])


def _ref_meta(nums, ref_cfg, page_n):
    nt = ref_number_type(nums.dtype)
    cfg = replace(ref_cfg, paging_spec=RefPagingSpec.exact_pages(_exact_split(len(nums), page_n)))
    w = RefBitWriter()
    ref_cmp.chunk_compressor(nt, nums, cfg).write_meta(w)
    return w.to_bytes()


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_device_trained_metas_match_host_chunk_compressor(name):
    """Exact: for each chunk, the device-trained chunk meta (mode, delta,
    bins, ANS size) writes pcodec_tpu's host chunk_compressor bytes, under
    ChunkConfig(), consecutive order 1 and NOOP (page_n 256, chunk_n
    131,072)."""
    nums = TRAIN_CASES[name](np.random.default_rng(7))
    page_n, chunk_n = 256, 131072
    for kind in ("auto", "consecutive1", "noop"):
        cfg, ref_cfg = _configs(kind)
        plan = dt.plan_encode_device(nums, cfg, page_n, chunk_n, "cpu")
        assert plan.trained_on == "device" and plan.chunk_ns == [131072, 68928]
        for ci, job in enumerate(plan.jobs):
            w = BitWriter()
            job.cc.write_meta(w)
            chunk = nums[ci * chunk_n : (ci + 1) * chunk_n]
            assert w.to_bytes() == _ref_meta(chunk, ref_cfg, page_n), (kind, ci)


@pytest.mark.parametrize("name,kind", [("i64_delta1", "auto"), ("i32_wrap", "consecutive1"),
                                       ("fallback", "consecutive3")])
def test_device_trained_image_matches_container_compress(name, kind):
    """Exact: the file image trained on the device equals pcodec_tpu's
    container_compress bytes, chunks that fall back to the baseline
    compressor (their raw latents left on the card) included."""
    rng = np.random.default_rng(8)
    nums = _fallback_case(rng) if name == "fallback" else TRAIN_CASES[name](rng)
    if kind == "consecutive3":
        cfg = pt.ChunkConfig(delta_spec=pt.DeltaSpec("try_consecutive", 3))
        ref_cfg = RefChunkConfig(delta_spec=RefDeltaSpec("try_consecutive", 3))
    else:
        cfg, ref_cfg = _configs(kind)
    plan = asm.plan_image(nums, cfg, 256, 131072, "cpu")
    assert plan.trained_on == "device"
    fell_back = [j.cc.meta.delta_encoding.kind == "noop" for j in plan.enc.jobs]
    assert fell_back == ([True, False, True] if name == "fallback" else [False] * len(fell_back))
    got = asm.file_image_to_bytes(*asm.run_image(plan, asm.upload_image(plan, "cpu")))
    assert got == ref_compress(nums, ref_cfg, page_n=256, chunk_n=131072)


@pytest.mark.parametrize("name", ["try_dict", "float_auto"])
def test_configurations_outside_the_slice_train_on_the_host(name):
    """TRY_DICT and float numbers under auto mode, which trained on the host
    planner until the card took every mode's training, now train on the
    card, decided from the type and configuration alone; the image still
    equals pcodec_tpu's container_compress."""
    if name == "try_dict":
        nums = np.array([3, 99, 1234567, -5], np.int64)[RNG.integers(0, 4, 3000)]
        cfg, ref_cfg = pt.ChunkConfig(mode_spec=pt.ModeSpec("try_dict")), RefChunkConfig(
            mode_spec=RefModeSpec("try_dict"))
    else:
        nums = RNG.standard_normal(3000)
        cfg, ref_cfg = pt.ChunkConfig(), RefChunkConfig()
    assert dt.device_train_supported(number_type_from_np(nums.dtype), cfg, 256, 1 << 20)
    plan = asm.plan_image(nums, cfg, 256, 1 << 20, "cpu")
    assert plan.trained_on == "device"
    got = asm.file_image_to_bytes(*asm.run_image(plan, asm.upload_image(plan, "cpu")))
    assert got == ref_compress(nums, ref_cfg, page_n=256)


@pytest.mark.parametrize("name", ["int_mult_timestamps", "lookback_winner"])
def test_decisions_outside_the_single_var_image_raise(name):
    """An IntMult base (tests/test_pallas_encode.py's timestamps) and an
    auto-delta lookback winner, which raised NotImplementedError before the
    multi-var image and then trained on the host, now train on the card.
    The plan says so, and the image is the JAX package's
    container_compress bytes."""
    from pcodec_tpu_torch.ops import assemble as asm

    rng = np.random.default_rng(23)
    if name == "int_mult_timestamps":
        nums = np.cumsum(rng.integers(1, 2000, 40_000)).astype(np.int64) * 1_000_000_000 + rng.integers(0, 3, 40_000)
    else:
        nums = np.tile(rng.integers(0, 10**6, 700), 60)[:40_000].astype(np.int64) + rng.integers(0, 2, 40_000)
    plan = asm.plan_image(nums, pt.ChunkConfig(), 256, 32768, "cpu")
    assert plan.trained_on == "device"
    kinds = {(job.cc.meta.mode.kind, job.cc.meta.delta_encoding.kind) for job in plan.enc.jobs}
    assert ("int_mult" if name == "int_mult_timestamps" else "lookback") in {k for kind in kinds for k in kind}
    got = asm.file_image_to_bytes(*asm.run_image(plan, asm.upload_image(plan, "cpu")))
    assert got == ref_compress(nums, page_n=256, chunk_n=32768)
