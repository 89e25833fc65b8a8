"""The port's microbenchmarks (pcodec_tpu_torch/experiments) against the
JAX repository's Pallas prototypes in experiments/, run in TPU interpret
mode on the CPU.

Each plain PyTorch version must equal its prototype's kernel exactly on
inputs drawn from numpy seeds. The prototype files are scripts, loaded from
their paths; micro_gather.py runs its whole benchmark when imported, so only
its `pallas_*` definitions are executed, with small sizes in their globals.
"""

import ast
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pcodec_tpu_torch.experiments import common, micro_gather, pallas_bitonic, proto_dma, proto_realign
from pcodec_tpu_torch.experiments import proto_round_loop
from pcodec_tpu_torch.ops import kernels
from pcodec_tpu_torch.ops.row_sort import MIN32, row_sort_plain, row_sort_u32, row_sort_u32_plain

torch.set_num_threads(1)  # the test workers share the cores: more intra-op threads spin on theirs

EXP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "experiments")
MIN64 = -(1 << 63)


@pytest.fixture
def load(monkeypatch):
    """Load a prototype from experiments/, restoring sys.path and the
    environment it changes at import (pallas_bitonic.py, bitonic_jnp.py)."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")

    def _load(name):
        spec = importlib.util.spec_from_file_location(f"_experiment_{name}", os.path.join(EXP, name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    return _load


@pytest.fixture
def interpret(monkeypatch):
    """Every pallas_call in TPU interpret mode, unless the caller says."""
    real = pl.pallas_call

    def call(*args, **kw):
        kw.setdefault("interpret", pltpu.InterpretParams())
        return real(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", call)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.usefixtures("interpret")
def test_realign_plain_matches_pallas(load):
    """Exact: E5's plain version equals proto_realign.py's kernel (2 groups)."""
    mod = load("proto_realign")
    rng = np.random.default_rng(11)
    raw2d = rng.integers(0, 2**31, (1024, 128), dtype=np.int32)
    starts = rng.integers(0, 1024 // 8 - 3, 16, dtype=np.int32)
    with jax.enable_x64(False):
        want = np.asarray(mod.make_run(2)(jnp.asarray(starts), jnp.asarray(raw2d)))
    got = proto_realign.realign(_t(starts), _t(raw2d))
    assert got.shape == (2, 24, 8, 128)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.usefixtures("interpret")
def test_dma_plain_matches_pallas(load):
    """Exact: E1's plain version and its kernel structure in torch
    (dma_checksum_blocks_plain) equal proto_dma.py's kernel (3 tiles, 5
    heavy rounds, starts anywhere in their 1,024-word blocks)."""
    mod = load("proto_dma")
    rng = np.random.default_rng(12)
    raw = rng.integers(-(2**31), 2**31, 1 << 15, dtype=np.int32)
    starts = rng.integers(0, raw.shape[0] - 3072 - 1024, (3, 128), dtype=np.int32)
    with jax.enable_x64(False):
        want = np.asarray(mod.make_run(3, 5)(jnp.asarray(starts), jnp.asarray(raw)))
    got = proto_dma.dma_checksum(_t(starts), _t(raw), 5)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(proto_dma.dma_checksum_blocks_plain(_t(starts), _t(raw), 5), got)


@pytest.mark.parametrize("heavy", [0, 1, 7, 512])
def test_dma_blocks_plain_matches_plain(heavy):
    """Exact: E1's kernel structure in torch (the blocks' column sums, each
    tile's rows of them, the rounds by pointer doubling) equals the plain
    version on a raw of 2^15 + 100 words (a trailing part-block), full-range
    words so the sums wrap, starts at 0, 1,023 and in the last fetchable
    block; both refuse a section past raw's end."""
    rng = np.random.default_rng(heavy + 18)
    n_raw = (1 << 15) + 100
    last = (n_raw - 3072) // 1024 * 1024
    raw = _t(rng.integers(-(2**31), 2**31, n_raw, dtype=np.int64).astype(np.int32))
    starts = rng.integers(0, last + 1024, (3, 128), dtype=np.int32)
    starts[0, :3] = [0, 1023, last + 1023]
    got = proto_dma.dma_checksum_blocks_plain(_t(starts), raw, heavy)
    assert torch.equal(got, proto_dma.dma_checksum_plain(_t(starts), raw, heavy))
    starts[1, 5] = last + 1024
    for fn in (proto_dma.dma_checksum_plain, proto_dma.dma_checksum_blocks_plain):
        with pytest.raises(ValueError, match="outside raw"):
            fn(_t(starts), raw, heavy)


def test_dma_blocks_plain_sums_only_touched_blocks():
    """Exact: where the chains touch fewer blocks than raw holds (one tile on
    a raw of 2^20 + 100 words), E1's kernel structure in torch sums only the
    touched blocks, as the kernel's column-sum pass then does, and still
    equals the plain version at 512 rounds, with starts at 0, 1,023 and in
    the last fetchable block."""
    rng = np.random.default_rng(19)
    n_raw = (1 << 20) + 100
    last = (n_raw - 3072) // 1024 * 1024
    raw = _t(rng.integers(-(2**31), 2**31, n_raw, dtype=np.int64).astype(np.int32))
    starts = rng.integers(0, last + 1024, (1, 128), dtype=np.int32)
    starts[0, :3] = [0, 1023, last + 1023]
    assert proto_dma.colsum_rows(1, n_raw) == ("touched blocks", 256)
    assert proto_dma.colsum_rows(4, n_raw) == ("every block", 1024)
    got = proto_dma.dma_checksum_blocks_plain(_t(starts), raw, 512)
    assert torch.equal(got, proto_dma.dma_checksum_plain(_t(starts), raw, 512))


def _gather_prototypes(T, TS, steps, lsteps, tables):
    """micro_gather.py's pallas_* definitions, executed with small sizes."""
    path = os.path.join(EXP, "micro_gather.py")
    tree = ast.parse(open(path).read(), path)
    defs = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name.startswith("pallas_")]
    assert {d.name for d in defs} >= {"pallas_take", "pallas_taa", "pallas_lane"}
    env = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, T=T, TS=TS, STEPS=steps, LSTEPS=lsteps, **tables)
    exec(compile(ast.Module(body=defs, type_ignores=[]), path, "exec"), env)
    return env


@pytest.mark.usefixtures("interpret")
@pytest.mark.parametrize("route", ["gather_take", "gather_taa", "gather_lane"])
def test_gather_plain_matches_pallas(route):
    """Exact: E3's plain versions equal micro_gather.py's pallas_take,
    pallas_taa and pallas_lane (T=16, TS=64), with table entries of the
    full int32 range so the lane route wraps."""
    T, TS, steps, lsteps = 16, 64, 12, 96
    rng = np.random.default_rng(13)
    table_flat = rng.integers(-(2**31), 2**31, T * TS, dtype=np.int32)
    idx0 = rng.integers(0, TS, (T, 4), dtype=np.int32)
    tbl = rng.integers(-(2**31), 2**31, (8, 128), dtype=np.int32)
    idx_l = rng.integers(-(2**31), 2**31, (8, 128), dtype=np.int32)
    with jax.enable_x64(False):
        env = _gather_prototypes(T, TS, steps, lsteps, dict(
            table_flat=jnp.asarray(table_flat), table2d=jnp.asarray(table_flat.reshape(T, TS)),
            tbl_small=jnp.asarray(tbl)))
        if route == "gather_lane":
            want = np.asarray(env["pallas_lane"](jnp.asarray(idx_l)))
        else:
            want = np.asarray(env["pallas_take" if route == "gather_take" else "pallas_taa"](jnp.asarray(idx0)))
    if route == "gather_take":
        got = micro_gather.gather_take(_t(table_flat), _t(idx0), steps)
    elif route == "gather_taa":
        got = micro_gather.gather_taa(_t(table_flat.reshape(T, TS)), _t(idx0), steps)
    else:
        got = micro_gather.lane_steps(_t(tbl), _t(idx_l), lsteps)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.usefixtures("interpret")
def test_row_gather_plain_matches_pallas(load):
    """Exact: E4a's plain version (route gather_row) equals
    proto_round_loop.py's taa_kernel on check A's inputs."""
    mod = load("proto_round_loop")
    tbl, idx = (t.numpy() for t in proto_round_loop.taa_inputs("cpu"))
    with jax.enable_x64(False):
        want = np.asarray(pl.pallas_call(
            mod.taa_kernel, out_shape=jax.ShapeDtypeStruct((8, 128), jnp.int32),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM))(jnp.asarray(tbl), jnp.asarray(idx)))
    got = micro_gather.row_gather(_t(tbl), _t(idx))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, np.take_along_axis(tbl, idx, axis=1))


def _i32(rng, shape, hi=None):
    lo, hi = (0, hi) if hi else (-(2**31), 2**31)
    return rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("rows,ts,steps", [(1, 4, 37), (13, 64, 37), (37, 1024, 37), (37, 1024, 0), (3, 1 << 14, 5)])
def test_taa_twin_matches_plain(rows, ts, steps):
    """Exact: route taa's kernel in torch (a warp a row, each staging its
    row in 16-byte quads, `gather_taa_warps_plain`) equals
    gather_steps_plain on 1 to 37 rows of 4 to 2^14 entries, no step
    included."""
    rng = np.random.default_rng(20 + rows)
    table, idx0 = _t(_i32(rng, (rows, ts))), _t(_i32(rng, (rows, 4), ts))
    want = micro_gather.gather_steps_plain(table, idx0, steps)
    assert torch.equal(micro_gather.gather_taa_warps_plain(table, idx0, steps), want)


@pytest.mark.usefixtures("interpret")
def test_taa_and_row_twins_match_plain_and_jax():
    """Exact: route taa's kernel in torch (`gather_taa_warps_plain`) equals
    micro_gather.py's pallas_taa (T=16, TS=64). Route row's register form
    (`row_gather_lanes_plain`) equals row_gather_plain and
    jnp.take_along_axis at widths 5, 77 and 128; wider rows take the
    thread-an-element form. Both twins raise on an index outside the
    table, where the kernels trap."""
    rng = np.random.default_rng(20)
    T, TS, steps = 16, 64, 12
    table, idx0 = _i32(rng, (T, TS)), _i32(rng, (T, 4), TS)
    with jax.enable_x64(False):
        env = _gather_prototypes(T, TS, steps, 96, dict(table_flat=jnp.asarray(table.reshape(-1)),
                                                        table2d=jnp.asarray(table), tbl_small=None))
        want = np.asarray(env["pallas_taa"](jnp.asarray(idx0)))
    assert np.array_equal(micro_gather.gather_taa_warps_plain(_t(table), _t(idx0), steps).numpy(), want)
    for width in (5, 77, 128):
        tbl, idx = _i32(rng, (6, width)), _i32(rng, (6, width), width)
        got = micro_gather.row_gather_lanes_plain(_t(tbl), _t(idx))
        assert micro_gather.row_route(width) == "registers"
        assert torch.equal(got, micro_gather.row_gather_plain(_t(tbl), _t(idx)))
        with jax.enable_x64(False):
            assert np.array_equal(got.numpy(), np.asarray(jnp.take_along_axis(jnp.asarray(tbl), jnp.asarray(idx), 1)))
    assert [micro_gather.row_route(w) for w in (129, 2048, 3000)] == ["device memory"] * 3
    with pytest.raises(IndexError):
        micro_gather.row_gather_lanes_plain(_t(_i32(rng, (1, 5))), _t(np.array([[0, 1, 5, 2, 3]], np.int32)))
    with pytest.raises(IndexError):
        micro_gather.gather_taa_warps_plain(_t(_i32(rng, (2, 64))),
                                            _t(np.array([[0, 1, 2, 3], [64, 0, 0, 0]], np.int32)), 1)


@pytest.mark.usefixtures("interpret")
def test_round_loop_plain_matches_pallas(load, monkeypatch):
    """Exact: E4b's plain version equals proto_round_loop.py's round kernel
    (ROUNDS = 4, one tile, with emit), on states partly outside the table
    and node entries of the full int32 range."""
    mod = load("proto_round_loop")
    monkeypatch.setattr(mod, "ROUNDS", 4)
    rng = np.random.default_rng(14)
    sec = rng.integers(-(2**31), 2**31, (1, 256, 128), dtype=np.int32)
    node = rng.integers(-(2**31), 2**31, (8, 1024), dtype=np.int32)
    state = rng.integers(0, 1024, (1, 8, 128), dtype=np.int32)
    state[0, :, :5] = [-7, 1024, 5000, -(2**31), 2**31 - 1]
    sds = jax.ShapeDtypeStruct
    with jax.enable_x64(False):
        out, emit = pl.pallas_call(
            mod.make_round_kernel(True), out_shape=(sds((8, 128), jnp.int32), sds((4, 8, 128), jnp.int32)),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 3,
            out_specs=(pl.BlockSpec(memory_space=pltpu.VMEM),) * 2,
        )(jnp.asarray(sec[0]), jnp.asarray(node), jnp.asarray(state[0]))
    got, got_emit = proto_round_loop.round_loop(_t(sec), _t(node), _t(state), 4, with_emit=True)
    assert np.array_equal(got.numpy()[0], np.asarray(out))
    assert np.array_equal(got_emit.numpy()[0], np.asarray(emit))
    assert torch.equal(proto_round_loop.round_loop(_t(sec), _t(node), _t(state), 4), got)


@pytest.mark.parametrize("rows,m", [(8, 256), (16, 1024)])
def test_bitonic_plain_matches_pallas(load, rows, m):
    """Exact: E2's plain version equals pallas_bitonic.py's sort_rows_u32
    (interpret mode of its own off a TPU) and numpy's sort."""
    mod = load("pallas_bitonic")
    x = np.random.default_rng(rows).integers(0, 1 << 32, (rows, m), dtype=np.uint64).astype(np.uint32)
    with jax.enable_x64(False):
        want = np.asarray(jax.jit(mod.sort_rows_u32)(jnp.asarray(x)))
    got = pallas_bitonic.sort_rows_u32(_t(x.view(np.int32)))
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert np.array_equal(want, np.sort(x, axis=1))


@pytest.mark.parametrize("width", [32, 64])
def test_bitonic_network_matches_bitonic_jnp(load, width):
    """Exact: the port's plain network equals bitonic_jnp.bitonic_sort on
    u32 and u64 rows with ties."""
    mod = load("bitonic_jnp")
    rng = np.random.default_rng(width)
    udt, idt, flip = (np.uint32, np.int32, MIN32) if width == 32 else (np.uint64, np.int64, MIN64)
    x = rng.integers(0, 2**width - 1, (4, 512), dtype=np.uint64, endpoint=True).astype(udt)
    x[:, :100] = x[:, :1]
    with jax.enable_x64(width == 64):
        want = np.asarray(jax.jit(mod.bitonic_sort)(jnp.asarray(x)))
    got = pallas_bitonic.bitonic_sort(_t(x.view(idt)) ^ flip) ^ flip
    assert want.dtype == udt
    assert np.array_equal(got.numpy().view(udt), want)
    assert np.array_equal(want, np.sort(x, axis=1))


def test_wrappers_take_the_plain_versions_on_cpu():
    """Exact: on CPU tensors every wrapper returns its plain version's
    result and launches nothing."""
    rng = np.random.default_rng(15)
    before = dict(kernels.LAUNCHES)
    st, raw2d = _t(rng.integers(0, 61, 16, dtype=np.int32)), _t(rng.integers(0, 99, (512, 128), dtype=np.int32))
    assert torch.equal(proto_realign.realign(st, raw2d), proto_realign.realign_plain(st, raw2d))
    starts, raw = _t(rng.integers(0, 4000, (2, 128), dtype=np.int32)), _t(rng.integers(0, 99, 8192, dtype=np.int32))
    assert torch.equal(proto_dma.dma_checksum(starts, raw, 3), proto_dma.dma_checksum_plain(starts, raw, 3))
    tab, idx = _t(rng.integers(0, 99, (4, 32), dtype=np.int32)), _t(rng.integers(0, 32, (4, 4), dtype=np.int32))
    assert torch.equal(micro_gather.gather_take(tab.flatten(), idx, 5), micro_gather.gather_steps_plain(tab, idx, 5))
    assert torch.equal(micro_gather.gather_taa(tab, idx, 5), micro_gather.gather_steps_plain(tab, idx, 5))
    x = _t(rng.integers(0, 1 << 32, (3, 64), dtype=np.uint64).astype(np.uint32).view(np.int32))
    assert torch.equal(pallas_bitonic.sort_rows_u32(x), row_sort_u32_plain(x))
    assert torch.equal(row_sort_u32(x), row_sort_u32_plain(x))
    assert kernels.LAUNCHES == before


def test_k8_u32_route_orders_as_the_u64_route():
    """Exact: K8's u32 path (int32 keys holding u32 bits) sorts as the u64
    path sorts the same values, ties and both ends of the range included."""
    rng = np.random.default_rng(16)
    x = rng.integers(0, 1 << 32, (4, 300), dtype=np.uint64).astype(np.uint32)
    x[:, :50] = x[:, :1]
    x[:, -2:] = [0, 0xFFFFFFFF]
    got = row_sort_u32_plain(_t(x.view(np.int32)))
    want = row_sort_plain(_t(x.astype(np.int64)))
    assert np.array_equal(got.numpy().view(np.uint32), want.numpy().astype(np.uint32))
    assert np.array_equal(got.numpy().view(np.uint32), np.sort(x, axis=1))


def test_dma_bound_counts_the_distinct_summed_words():
    """E1's bound reads each summed word once: the union of the chains'
    first 2,048 words from their aligned starts, shared blocks counted once."""
    rng = np.random.default_rng(17)
    n_raw = 1 << 16
    starts = rng.integers(0, n_raw - 4096, (3, 128), dtype=np.int32)
    starts[0, :3] = [0, 1023, 1024]  # one aligned block, and one it overlaps
    covered = np.zeros(n_raw, bool)
    for al in (starts.astype(np.int64) & ~1023).ravel():
        covered[al:al + 2048] = True
    assert proto_dma.needed_words(_t(starts), n_raw) == int(covered.sum())


def test_bound_and_check_equal():
    """The shared helpers: a bound is the larger of the byte and operation
    times, named after it; check_equal passes equal tensors only."""
    assert common.bound(3.35e9) == (pytest.approx(1.0), "bytes")
    assert common.bound(3.35e6, 67e9) == (pytest.approx(1.0), "operations")
    a = torch.arange(6)
    assert common.check_equal(a, a.clone()) == 0.0
    with pytest.raises(AssertionError, match="K0 differs from its plain version at 1 of 6"):
        common.check_equal(a, torch.where(a == 2, -1, a), "K0")
    with pytest.raises(AssertionError, match="differs"):
        common.check_equal(a, a[:5])


def test_cluster_sort_refuses_rows_longer_than_a_cluster_holds():
    """E2 no longer refuses rows longer than one cluster holds: sort_plan
    cuts them into tiles of 2^17 keys (8 blocks of 2^14), sorts each on
    chip, then merges each longer run, its stages above the tile through
    device memory (5 bits a pass at most) and those below on chip. Rows of
    2^16 keys are one tile of 4 blocks, rows under 32 a thread each. Rows
    that are not a power of two from 2 to 2^31, and tiles the kernel does
    not hold, still raise a ValueError."""
    pb = pallas_bitonic
    assert pb.sort_plan(1 << 16) == dict(tile_keys=1 << 16, blocks=4, block_keys=1 << 14, launches=[("tile", 5, 16)])
    assert pb.sort_plan(16) == dict(tile_keys=16, blocks=1, block_keys=16, launches=[("rows",)])
    assert [(p["blocks"], p["block_keys"]) for p in map(pb.sort_plan, (32, 1 << 14, 1 << 15, 1 << 17))] == [
        (1, 32), (1, 1 << 14), (2, 1 << 14), (8, 1 << 14)]
    assert pb.sort_plan(1 << 19) == dict(tile_keys=1 << 17, blocks=8, block_keys=1 << 14, launches=[
        ("tile", 5, 17), ("global", 18, 17, 1), ("tile", 18, 18), ("global", 19, 17, 2), ("tile", 19, 19)])
    assert pb.sort_plan(1 << 21)["launches"][-2:] == [("global", 21, 17, 4), ("tile", 21, 21)]
    assert pb.sort_plan(1 << 12, 32)["launches"][-3:] == [("global", 12, 7, 5), ("global", 12, 5, 2), ("tile", 12, 12)]
    assert pb.tile_groups(16, 16) == [(11, 5), (6, 5), (1, 5), (0, 1)]
    assert pb.tile_groups(19, 17) == [(12, 5), (7, 5), (2, 5), (0, 2)]
    for m in (3000, 0, 1 << 32):
        with pytest.raises(ValueError, match="power-of-two"):
            pb.sort_plan(m)
    with pytest.raises(ValueError, match="tile"):
        pb.sort_plan(1 << 10, 1 << 18)
    with pytest.raises(ValueError, match="power-of-two"):
        pb.sort_rows_u32(torch.zeros((1, 3 << 10), dtype=torch.int32))
    x = _t(np.random.default_rng(19).integers(0, 1 << 32, (1, 1 << 19), dtype=np.uint64).astype(np.uint32))
    assert pb.sort_rows_u32(x.view(torch.int32)).shape == (1, 1 << 19)


@pytest.mark.parametrize("rows,m,tile", [(4, 1 << 10, 1 << 6), (3, 1 << 8, 1 << 8)])
def test_bitonic_tiled_plain_matches_network(rows, m, tile):
    """Exact: E2's schedule in torch (tiles sorted on chip, longer runs
    merged through device memory, descending runs held complemented) equals
    the plain network and numpy's sort, on rows with runs of equal keys and
    both ends of the u32 range."""
    rng = np.random.default_rng(m + tile)
    x = rng.integers(0, 1 << 32, (rows, m), dtype=np.uint64).astype(np.uint32)
    x[:, 5: m // 3] = x[:, :1]
    x[:, m // 2: m // 2 + 40] = rng.integers(0, 3, (rows, 40))
    x[:, -2:] = [0xFFFFFFFF, 0]
    xt = _t(x.view(np.int32))
    got = pallas_bitonic.sort_rows_u32_tiled_plain(xt, tile)
    assert torch.equal(got, pallas_bitonic.sort_rows_u32_plain(xt))
    assert np.array_equal(got.numpy().view(np.uint32), np.sort(x, axis=1))


@pytest.mark.parametrize("steps,rows", [(0, 1), (1, 19), (2, 8), (127, 3), (300, 19), (6144, 8)])
def test_lane_doubling_plain_matches_step_loop(steps, rows):
    """Exact: route lane's pointer doubling in torch (ceil(log2(steps + 1))
    rounds) equals the step loop on full-range int32 tables, so the sums
    wrap."""
    rng = np.random.default_rng(steps + rows)
    tbl = _t(rng.integers(-(2**31), 2**31, (rows, 128), dtype=np.int64).astype(np.int32))
    idx = _t(rng.integers(-(2**31), 2**31, (rows, 128), dtype=np.int64).astype(np.int32))
    assert micro_gather.lane_rounds(steps) == int(np.ceil(np.log2(steps + 1)))
    got = micro_gather.lane_steps_doubling_plain(tbl, idx, steps)
    assert torch.equal(got, micro_gather.lane_steps_plain(tbl, idx, steps))


@pytest.mark.parametrize("mod", [proto_realign, proto_dma, micro_gather, proto_round_loop, pallas_bitonic],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_main_needs_a_card(mod, monkeypatch):
    """Each microbenchmark's main() times on the card and raises without
    one, or when asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main()
    with pytest.raises(ValueError, match="CUDA device"):
        mod.main("cpu")
