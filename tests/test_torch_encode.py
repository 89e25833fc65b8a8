"""The port's PCT encode (pcodec_tpu_torch.ops.container_encode and
ops.assemble) against the JAX package.

On the CPU every kernel wrapper runs its plain PyTorch version (the CUDA
kernels are held against them in test_torch_encode_kernels.py). Every
comparison here is exact: container bytes byte for byte, launch arrays,
dissections, page bodies and stitched words bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pcodec_tpu.ops.assemble as ja
import pcodec_tpu.ops.pallas_encode as pe
from pcodec_tpu.codec.chunk_config import ChunkConfig as RefChunkConfig
from pcodec_tpu.codec.chunk_config import DeltaSpec as RefDeltaSpec
from pcodec_tpu.codec.chunk_config import ModeSpec as RefModeSpec
from pcodec_tpu.codec.container import container_compress as ref_compress

import pcodec_tpu_torch as pt
from pcodec_tpu_torch.format.bitio import BitWriter
from pcodec_tpu_torch.ops import assemble as asm
from pcodec_tpu_torch.ops import container_encode as ce
from pcodec_tpu_torch.ops import row_sort as rs

RNG = np.random.default_rng(2026)


def _walk(n, jump=0.01):
    return np.cumsum(RNG.integers(0, 120, n) + (RNG.random(n) < jump) * RNG.integers(0, 10**6, n))


def _configs(order, mode="classic", level=8):
    """(port config, JAX config) of one mode, delta order and level."""
    kind = "try_consecutive" if order else "no_op"
    return (
        pt.ChunkConfig(compression_level=level, mode_spec=pt.ModeSpec(mode),
                       delta_spec=pt.DeltaSpec(kind, order)),
        RefChunkConfig(compression_level=level, mode_spec=RefModeSpec(mode),
                       delta_spec=RefDeltaSpec(kind, order)),
    )


def _wide(n):
    """Two far-apart clusters: bins with 39 to 63 offset bits."""
    return (np.where(RNG.random(n) < 0.3, -(2**62), 2**61)
            + RNG.integers(0, 2**45, n) * RNG.integers(1, 3, n)).astype(np.int64)


# name: (numbers, delta order, mode, compression level, page_n, chunk_n)
CASES = {
    "i64_o1_ragged_multichunk": (_walk(5000).astype(np.int64), 1, "classic", 8, 1024, 2100),
    "u32_o0_p512": (RNG.integers(0, 70000, 3000).astype(np.uint32), 0, "classic", 8, 512, 1 << 20),
    "i64_o3_p256": (np.cumsum(np.cumsum(_walk(2500, 0))).astype(np.int64), 3, "classic", 8, 256, 1 << 20),
    "f32_classic": (RNG.standard_normal(3000).astype(np.float32), 0, "classic", 8, 1024, 1 << 20),
    "i64_64bit_offsets": (_wide(3000), 0, "classic", 8, 1024, 1 << 20),
    "i64_one_bin_64bit_offsets": (RNG.integers(-(2**63), 2**63 - 1, 2000, dtype=np.int64), 0,
                                  "classic", 0, 256, 1 << 20),
    "constant": (np.full(3000, -77, np.int64), 1, "classic", 8, 256, 1 << 20),
    "constant_chunk_then_walk": (np.concatenate([np.full(1500, 5, np.int64), _walk(1500)]), 1,
                                 "classic", 8, 256, 1500),
    "one_bin_with_offsets": (RNG.integers(0, 5000, 3000).astype(np.int64), 0, "classic", 0, 512, 1 << 20),
    "dict": (np.array([3, 99, 1234567, -5], np.int64)[RNG.integers(0, 4, 3000)], 0, "try_dict", 8,
             256, 1 << 20),
    "f64_o1": ((np.cumsum(RNG.integers(-3, 40, 2500)) * 0.37).astype(np.float64), 1, "classic", 8,
               256, 1 << 20),
    "i16_o2_p512": ((_walk(2500, 0) % 30000).astype(np.int16), 2, "classic", 8, 512, 1 << 20),
    "u64_o1_p2048": (_walk(5000).astype(np.uint64), 1, "classic", 8, 2048, 1 << 20),
    "tiny_7": (np.arange(7, dtype=np.int64), 1, "classic", 8, 1024, 1 << 20),
    "tiny_1025": (_walk(1025).astype(np.int64), 1, "classic", 8, 1024, 1 << 20),
}


@pytest.mark.parametrize("entry", ["host_assembly", "file_image"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_encoders_write_the_reference_bytes(name, entry):
    """Exact: both device entry points (plain versions on the CPU), the
    container bytes and the file image, write the bytes of pcodec_tpu's
    container_compress."""
    nums, order, mode, level, page_n, chunk_n = CASES[name]
    cfg, ref_cfg = _configs(order, mode, level)
    ref = ref_compress(nums, ref_cfg, page_n=page_n, chunk_n=chunk_n)
    if entry == "host_assembly":
        got = pt.encode_container_device(nums, cfg, page_n=page_n, chunk_n=chunk_n, device="cpu")
    else:
        got = asm.file_image_to_bytes(*pt.encode_container_image_device(
            nums, cfg, page_n=page_n, chunk_n=chunk_n, device="cpu"))
    assert got == ref


def test_matrix_reaches_its_edge_cases():
    """The matrix above holds a trivial chunk, a one-bin chunk with offset
    bits, offsets over 32 and of 64 bits, and a Dict chunk."""
    seen = set()
    for name, (nums, order, mode, level, page_n, chunk_n) in CASES.items():
        plan = ce.plan_encode(nums, _configs(order, mode, level)[0], page_n, chunk_n, "cpu")
        for job in plan.jobs:
            bins = job.cc.meta.per_latent_var.primary.bins
            seen.add(("trivial", job.trivial))
            seen.add(("one_bin_offsets", len(bins) == 1 and int(bins.offset_bits[0]) > 0))
            seen.add(("ob>32", bins.max_offset_bits() > 32))
            seen.add(("ob=64", bins.max_offset_bits() == 64))
            seen.add(("dict", job.cc.meta.mode.kind == "dict"))
    assert all((k, True) in seen for k in ("trivial", "one_bin_offsets", "ob>32", "ob=64", "dict"))


@pytest.mark.parametrize("name", ["i64_o1_ragged_multichunk", "i64_o3_p256", "dict",
                                  "i64_64bit_offsets", "u32_o0_p512"])
def test_build_enc_tables_matches_jax(name):
    nums, order, mode, level, page_n, chunk_n = CASES[name]
    cfg, ref_cfg = _configs(order, mode, level)
    ours = ce.plan_encode(nums, cfg, page_n, chunk_n, "cpu")
    ref = pe._plan_encode(nums, ref_cfg, page_n, chunk_n)[2]
    for job, rcc in zip(ours.jobs, ref):
        got = ce.build_enc_tables(job.cc.meta.per_latent_var.primary)
        want = pe.build_enc_tables(rcc.meta.per_latent_var.primary)
        assert got[4] == want[4]
        for g, w in zip(got[:4], want[:4]):
            assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("name", ["i64_o1_ragged_multichunk", "i64_o3_p256", "tiny_1025",
                                  "constant_chunk_then_walk", "dict"])
def test_launch_matches_jax_launch(name):
    """Exact, per chunk: latent rows, body lengths, start states and the
    chunk's table (real part and last-bin padding) of build_encode_launch
    equal the JAX `_build_launch_args` launch carried over by
    enc_launch_from_jax."""
    nums, order, mode, level, page_n, chunk_n = CASES[name]
    cfg, ref_cfg = _configs(order, mode, level)
    plan = ce.plan_encode(nums, cfg, page_n, chunk_n, "cpu")
    L = ce.build_encode_launch(plan)
    groups = pe._plan_encode(nums, ref_cfg, page_n, chunk_n)[4]
    compared = set()
    for schema, jobs, dev_args in pe._build_launch_args(groups):
        J = ce.enc_launch_from_jax(schema, [np.asarray(x) for x in dev_args])
        for job in jobs:
            ci, npg = job["ci"], job["n_pages"]
            a = slice(L.chain_start[ci], L.chain_start[ci] + npg)
            b = slice(job["chain_start"], job["chain_start"] + npg)
            for f in ("latents", "body_n", "states0"):
                assert np.array_equal(getattr(L, f)[a], getattr(J, f)[b]), f
            tm, tj = L.table_id[a][0], J.table_id[b][0]
            nb, ts = len(job["tables"][1]), job["tables"][4]
            assert np.array_equal(L.nexts[tm, :ts], J.nexts[tj, :ts])
            for f in ("lowers", "t1", "t2"):
                mine, theirs = getattr(L, f)[tm], getattr(J, f)[tj]
                assert np.array_equal(mine[:nb], theirs[:nb]), f
                assert (mine[nb:] == mine[nb - 1]).all() and (theirs[nb:] == theirs[nb - 1]).all()
            compared.add(ci)
    assert compared == {ci for ci, job in enumerate(plan.jobs) if not job.trivial} != set()


@pytest.mark.parametrize("name", ["i64_o1_ragged_multichunk", "i64_64bit_offsets", "one_bin_with_offsets"])
def test_tiled_plain_k5_matches_plain_on_jax_launch(name):
    """Exact: on the JAX package's own launches (`_build_launch_args`,
    carried over by enc_launch_from_jax), K5's steps in plain torch (tiles
    of 8 rounds, and of 1 and 64) equal the plain version."""
    nums, order, mode, level, page_n, chunk_n = CASES[name]
    groups = pe._plan_encode(nums, _configs(order, mode, level)[1], page_n, chunk_n)[4]
    for schema, _, dev_args in pe._build_launch_args(groups):
        a = ce.upload_launch(ce.enc_launch_from_jax(schema, [np.asarray(x) for x in dev_args]), "cpu")
        args = (a["latents"], a["body_n"], a["table_id"], a["states0"], a["nexts"], a["lowers"], a["t1"], a["t2"])
        want = ce.bin_ans_encode_plain(*args)
        for rounds in (8, 1, 64):
            for got, w in zip(ce.bin_ans_encode_tiled_plain(*args, tile_rounds=rounds), want):
                assert torch.equal(got, w)


def _launch_outputs(nums, cfg, page_n, chunk_n):
    plan = ce.plan_encode(nums, cfg, page_n, chunk_n, "cpu")
    L = ce.build_encode_launch(plan)
    a = ce.upload_launch(L, "cpu")
    p1, offsets, states = ce.bin_ans_encode(a["latents"], a["body_n"], a["table_id"], a["states0"],
                                            a["nexts"], a["lowers"], a["t1"], a["t2"])
    sections, ans_len, off_len, total_bits = ce.section_pack(p1, offsets, L.sec_words)
    return plan, L, [x.numpy() for x in (p1, offsets, states, ans_len, off_len, total_bits, sections)]


@pytest.mark.parametrize("name", ["i64_o1_ragged_multichunk", "i64_64bit_offsets",
                                  "one_bin_with_offsets", "f32_classic"])
def test_plain_encode_matches_host_dissection_and_page_bodies(name):
    """Exact, on every page: the plain K5 equals the host's dissect_page
    (ANS values and bits, offsets and their bits, final states), and the
    plain K5 -> glue -> plain K6 equals the body write_page writes after the
    page meta, with its sections_out lengths."""
    nums, order, mode, level, page_n, chunk_n = CASES[name]
    plan, L, (p1, offsets, states, ans_len, off_len, total_bits, sections) = _launch_outputs(
        nums, _configs(order, mode, level)[0], page_n, chunk_n)
    val, ren, ob = p1 & 0x7FFF, (p1 >> 15) & 15, (p1 >> 19) & 127
    pages = 0
    for ci, job in enumerate(plan.jobs):
        cc, lvc = job.cc, job.cc.lvcs.primary
        for pi, info in enumerate(cc.page_infos):
            c = L.chain_start[ci] + pi
            piv = info.per_latent_var.primary
            d = lvc.dissect_page(piv.start, piv.end)
            n = d["n"]
            assert np.array_equal(val[c, :n], d["ans_vals"]) and np.array_equal(ren[c, :n], d["ans_bits"])
            assert np.array_equal(offsets[c, :n].view(np.uint64), d["offsets"])
            assert np.array_equal(ob[c, :n], d["offset_bits"])
            assert not p1[c, n:].any() and not offsets[c, n:].any()
            assert list(states[c]) == list(d["final_states"])

            w = BitWriter()
            secs = []
            cc.write_page(pi, w, sections_out=secs)
            body = np.frombuffer(w.to_bytes(), np.uint8)[cc.meta.exact_page_meta_size():]
            row = sections[c].view(np.uint8)
            assert (int(total_bits[c]) + 7) // 8 == len(body)
            assert np.array_equal(row[: len(body)], body) and not row[len(body):].any()
            nb = -(-info.page_n // 256)
            assert np.array_equal(ans_len[c, :nb], secs[0][0]) and np.array_equal(off_len[c, :nb], secs[0][1])
            pages += 1
    assert pages > 1


@pytest.mark.parametrize("name", ["i64_o1_ragged_multichunk", "constant_chunk_then_walk", "i64_o3_p256", "tiny_7"])
def test_prep_rows_through_plain_stitch_match_jax_stitch_xla(name):
    """Exact: the port's row streams A and C, placed by the plain K7 step,
    equal JAX's gather-based `_stitch_xla` placing the same rows; the fused
    K7's plain version gives those body words and prep's head words, and
    head and body are pcodec_tpu's container_compress bytes (a ragged last
    chunk, a trivial chunk beside a coded one in two meta groups, order 3,
    one page of 7 numbers)."""
    nums, order, mode, level, page_n, chunk_n = CASES[name]
    cfg, ref_cfg = _configs(order, mode, level)
    plan = asm.plan_image(nums, cfg, page_n, chunk_n, "cpu")
    a = asm.upload_image(plan, "cpu")
    out = ce.encode_launch(plan.launch, a)
    prep = asm.prepare_image(plan, {**a, **asm.upload_prep(plan, "cpu")}, *out)
    nw = -(-int(prep["sizes"][0]) // 4)
    rows = [prep[k] for k in ("rowsA", "F0A", "lenA", "rowsC", "F0C", "lenC")]
    got = asm.image_stitch_plain(*rows, nw).numpy().view(np.uint32)
    F0A = rows[1].numpy()
    assert np.max(np.unique(F0A, return_counts=True)[1]) < 8  # within the XLA stitch's K
    j = [jnp.asarray(x.numpy().view(np.uint32) if x.dtype == torch.int32 else x.numpy().astype(np.int32))
         for x in rows]
    want = np.asarray(ja._stitch_xla(*j, W_pad=nw, K=8))
    assert np.array_equal(got, want)
    head, body, body_bytes = asm.image_assemble_plain(plan, a, *out)
    assert np.array_equal(body.numpy().view(np.uint32), want)
    assert torch.equal(head, prep["head_words"])
    image = asm.file_image_to_bytes(head, body, plan.head_bytes, body_bytes)
    assert image == ref_compress(nums, ref_cfg, page_n=page_n, chunk_n=chunk_n)
    if name == "constant_chunk_then_walk":
        assert len(set(zip(plan.layout.orders, plan.layout.sls, plan.layout.bits))) == 2 and 0 in plan.layout.ts


def test_row_sort_matches_jax_pallas_sort_in_interpret_mode():
    """Exact: the port's K8 (its plain version on the CPU) orders u32 rows
    as JAX's Pallas bitonic sort (`sort_rows_u32`, interpret mode) does,
    with keys equal to the pad value and a run of ties."""
    from pcodec_tpu.ops import pallas_sort

    x = RNG.integers(0, 2**32, (2, 300), dtype=np.uint64)
    x[0, :5] = 0xFFFFFFFF
    x[1, :40] = 7
    want = np.asarray(pallas_sort.sort_rows_u32(x.astype(np.uint32))).astype(np.uint64)
    got = rs.row_sort(torch.from_numpy(x.view(np.int64))).numpy().view(np.uint64)
    assert np.array_equal(got, want)


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device encodes")
    nums = np.arange(300, dtype=np.int64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.encode_container_device(nums)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.encode_container_image_device(nums)


@pytest.mark.parametrize("entry", ["host_assembly", "file_image"])
@pytest.mark.parametrize("mode,delta", [("try_int_mult", ("no_op", 0)), ("classic", ("try_lookback", 0))])
def test_chunks_outside_the_slice_raise(mode, delta, entry):
    """Chunks of several latent vars (IntMult's secondary, a lookback
    delta's lookbacks), which raised NotImplementedError before the
    multi-var image, now encode through both entry points to the JAX
    package's container_compress bytes, pinned IntMult and TRY_LOOKBACK
    both trained on the card."""
    if mode == "try_int_mult":
        nums = (RNG.integers(0, 1000, 3000) * 1_000_000).astype(np.int64)
        spec, ref_spec = pt.ModeSpec(mode, 1_000_000), RefModeSpec(mode, 1_000_000)
    else:
        nums = np.tile(RNG.integers(0, 10**6, 300), 10).astype(np.int64)
        spec, ref_spec = pt.ModeSpec(mode), RefModeSpec(mode)
    cfg = pt.ChunkConfig(mode_spec=spec, delta_spec=pt.DeltaSpec(*delta))
    ref = ref_compress(nums, RefChunkConfig(mode_spec=ref_spec, delta_spec=RefDeltaSpec(*delta)), page_n=256)
    if entry == "host_assembly":
        got = pt.encode_container_device(nums, cfg, page_n=256, device="cpu")
    else:
        got = asm.file_image_to_bytes(*pt.encode_container_image_device(nums, cfg, page_n=256, device="cpu"))
    assert got == ref
    plan = asm.plan_image(nums, cfg, 256, 1 << 20, "cpu")
    assert plan.trained_on == "device" and plan.launch.row_chains is not None
    assert len(plan.enc.jobs[0].vars) == 2
