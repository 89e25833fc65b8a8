"""The port's multi-latent-var and lookback file image (ops/assemble.py's
multi-var rows, K6's joint cursors, K7's multi-var descriptor rows) against
the JAX package.

The eight inputs are those of tests/test_image_multivar.py (:37-108), cut
from 200,000 numbers (131,072 a chunk for the mixed case) to 20,000 (8,192)
so that a case stays under a second here, at page_n 256 and chunk_n 8,192
(so every case has at least two chunks). On the CPU every kernel wrapper
runs its plain version; the image must be the JAX package's
container_compress bytes. K6's plain joint-cursor rows are also held to the
host's own interleave of the per-var sections (`interleave_sections`, the
JAX multi-var host assembly), and the directory's (page, var, batch) order
to the JAX `_entry_sel_np`. Every comparison is exact.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import pcodec_tpu.ops.assemble as ja
from pcodec_tpu.codec.chunk_config import ChunkConfig as RefChunkConfig
from pcodec_tpu.codec.chunk_config import DeltaSpec as RefDeltaSpec
from pcodec_tpu.codec.chunk_config import ModeSpec as RefModeSpec
from pcodec_tpu.codec.container import container_compress as ref_compress

import pcodec_tpu_torch as pt
from pcodec_tpu_torch.native.kernels import interleave_sections
from pcodec_tpu_torch.ops import assemble as asm
from pcodec_tpu_torch.ops import container_encode as ce

torch.set_num_threads(1)  # the test workers share the cores: more intra-op threads spin on theirs

N = 20_000  # each case's 200,000 numbers cut to this
PAGE_N, CHUNK_N = 256, 8192


def _case(name):
    """(numbers, (mode, base), (delta, order)) of a tests/test_image_multivar.py case at N."""
    if name == "intmult_two_vars":
        rng = np.random.default_rng(21)
        x = (np.cumsum(rng.integers(1, 30, N)) * 1_000_000_000 + rng.integers(0, 4, N)).astype(np.int64)
        return x, ("try_int_mult", 10**9), ("auto", 0)
    if name == "intmult_auto_winner":
        rng = np.random.default_rng(22)
        return (rng.integers(0, 1 << 20, N) * 777 + rng.integers(0, 3, N)).astype(np.int64), ("auto", 0), ("auto", 0)
    if name == "intmult_trivial_secondary":
        rng = np.random.default_rng(28)
        return (rng.integers(0, 1 << 20, N) * 777).astype(np.int64), ("auto", 0), ("auto", 0)
    if name in ("lookback_two_vars", "lookback_pallas_stitch"):
        rng = np.random.default_rng(23 if name == "lookback_two_vars" else 27)
        n = N // 512 * 512
        x = np.tile(rng.integers(0, 10**6, 512).astype(np.int64), n // 512) + rng.integers(0, 2, n)
        return x, ("auto", 0), ("try_lookback", 0)
    if name == "floatquant_f32":
        rng = np.random.default_rng(24)
        x = (np.round(rng.standard_normal(N) * 64) / 64).astype(np.float32)
        bits = x.view(np.uint32)
        bits[::7] += rng.integers(1, 4, len(bits[::7])).astype(np.uint32)
        return bits.view(np.float32), ("try_float_quant", 6), ("auto", 0)
    if name == "floatmult_f32":
        rng = np.random.default_rng(25)
        x = (rng.integers(-5000, 5000, N) * np.float32(0.01)).astype(np.float32)
        x.view(np.uint32)[::9] += 1
        return x, ("auto", 0), ("auto", 0)
    assert name == "mixed_chunks_classic_and_intmult"
    rng = np.random.default_rng(26)
    half = CHUNK_N  # 131,072 cut to one chunk of each kind
    a = np.cumsum(rng.integers(0, 120, half)).astype(np.int64)
    b = (rng.integers(0, 1 << 20, half) * 1_000_003).astype(np.int64)
    return np.concatenate([a, b]), ("auto", 0), ("auto", 0)


CASES = ["intmult_two_vars", "intmult_auto_winner", "intmult_trivial_secondary", "lookback_two_vars",
         "floatquant_f32", "floatmult_f32", "mixed_chunks_classic_and_intmult", "lookback_pallas_stitch"]


def _configs(mode, delta):
    (mk, base), (dk, order) = mode, delta
    mode_args = (mk, base) if base else (mk,)
    return (pt.ChunkConfig(mode_spec=pt.ModeSpec(*mode_args), delta_spec=pt.DeltaSpec(dk, order)),
            RefChunkConfig(mode_spec=RefModeSpec(*mode_args), delta_spec=RefDeltaSpec(dk, order)))


def _plan(name):
    nums, mode, delta = _case(name)
    cfg, ref_cfg = _configs(mode, delta)
    return nums, asm.plan_image(nums, cfg, PAGE_N, CHUNK_N, "cpu"), ref_compress(nums, ref_cfg, page_n=PAGE_N,
                                                                                  chunk_n=CHUNK_N)


@pytest.mark.parametrize("name", CASES)
def test_multivar_image_equals_reference_bytes(name):
    """The file image (K5, K6's joint rows, K7's plain version) is the JAX
    package's container_compress bytes; the chunks have several latent
    vars (a trivial one where the name says so)."""
    nums, plan, ref = _plan(name)
    assert len(plan.enc.chunk_ns) >= 2 and plan.launch.row_chains is not None
    jobs = plan.enc.jobs
    assert any(job.multi for job in jobs)
    if name == "intmult_trivial_secondary":
        assert any(vj.trivial for job in jobs for vj in job.vars if vj.key == "secondary")
    if name.startswith("lookback"):
        assert all(job.cc.meta.delta_encoding.kind == "lookback" for job in jobs)
    if name == "mixed_chunks_classic_and_intmult":
        assert [job.multi for job in jobs] == [False, True]
    a = asm.upload_image(plan, "cpu")
    got = asm.file_image_to_bytes(*asm.run_image(plan, a))
    assert got == ref
    if name == "lookback_pallas_stitch":  # the rows K7 took in, placed by the plain stitch, give the same body
        out = ce.encode_launch(plan.launch, a)
        prep = asm.prepare_image(plan, {**a, **asm.upload_prep(plan, "cpu")}, *out)
        rows = [prep[k] for k in ("rowsA", "F0A", "lenA", "rowsC", "F0C", "lenC")]
        body = asm.image_stitch_plain(*rows, -(-int(prep["sizes"][0]) // 4))
        assert body.numpy().tobytes()[: int(prep["sizes"][0])] == ref[plan.head_bytes :]


@pytest.mark.parametrize("name", ["intmult_two_vars", "lookback_two_vars"])
def test_joint_rows_equal_host_interleave(name):
    """K6's plain joint-cursor rows: each page's body equals the host's
    interleave of its vars' own section rows (K6 a row a chain), batch by
    batch, var by var, and the lengths are the chains' own."""
    _, plan, _ = _plan(name)
    L = plan.launch
    a = asm.upload_image(plan, "cpu")
    p1, offsets, _ = ce.bin_ans_encode_plain(a["latents"], a["body_n"], a["table_id"], a["states0"], a["nexts"],
                                             a["lowers"], a["t1"], a["t2"])
    joint, ans, off, total = ce.section_pack_plain(p1, offsets, L.sec_words, a["row_chains"])
    own, own_ans, own_off, own_total = ce.section_pack_plain(p1, offsets, L.sec_words)
    B = PAGE_N // 256
    for r in range(0, len(L.row_chains), 7):
        chains = [int(c) for c in L.row_chains[r] if c >= 0]
        seclens = np.stack([np.stack([own_ans[c].numpy(), own_off[c].numpy()]) for c in chains])
        dst = np.zeros(4 * L.sec_words + 16, np.uint8)
        nbits = interleave_sections([own[c].numpy().view(np.uint8) for c in chains], seclens, dst, 0)
        assert nbits == int(total[r]) == sum(int(own_total[c]) for c in chains)
        assert joint[r].numpy().view(np.uint8).tobytes() == dst[: 4 * L.sec_words].tobytes()
        for v, c in enumerate(chains):
            assert torch.equal(ans[r, v], own_ans[c]) and torch.equal(off[r, v], own_off[c])
    assert ans.shape == (len(L.row_chains), L.row_chains.shape[1], B)


def test_directory_order_equals_jax_entry_sel():
    """The directory's (page, var, batch) entries in the JAX `_entry_sel_np`
    order: per chunk, per page, per var, its page's real batches."""
    _, plan, _ = _plan("mixed_chunks_classic_and_intmult")
    lay = plan.layout
    B = lay.page_n // 256
    chunks = []
    pages, vars_, batches = lay.dir_entry_pages()
    cofp, page0 = lay.chunk_of_page(), lay.page0_of_chunk()
    for ci, (vf, npg) in enumerate(zip(lay.var_fields, lay.n_pages)):
        last = lay.page_lens()[page0[ci] + npg - 1]
        chunks.append(SimpleNamespace(vars=vf, npg=npg, last_nb=-(-int(last) // 256)))
    starts = np.concatenate([[0], np.cumsum([len(c.vars) * c.npg * B for c in chunks])])
    mine = starts[cofp[pages]] + (vars_ * np.asarray(lay.n_pages)[cofp[pages]] + pages - page0[cofp[pages]]) * B + batches
    assert np.array_equal(mine, ja._entry_sel_np(chunks, lay.page_n))
    assert len(mine) == len(set(mine.tolist()))
    assert 4 * len(mine) == plan.head_bytes - len(plan.head_host) - 4 * lay.total_pages
