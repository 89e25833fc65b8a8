"""K9 (histogram_walk) of the port, on its own, and the extracts that feed
it; on the card, B5 (lookback_choose) against its plain version and device
training of every mode and of the lookback delta through K8, K9 and B5.

The plain version runs here on the CPU against the host codec's
histogram(); the tests marked `gpu` hold the CUDA kernel against the plain
version bit for bit and skip when there is no card. This file imports no
JAX, so on a GPU machine without JAX it runs as
`python -m pytest tests/test_torch_train_kernels.py --noconftest -m gpu`.
"""

import numpy as np
import pytest
import torch

import pcodec_tpu_torch as pt
from pcodec_tpu_torch.binning.histogram import histogram
from pcodec_tpu_torch.format.bitio import BitWriter
from pcodec_tpu_torch.ops import assemble as asm
from pcodec_tpu_torch.ops import device_train as dt
from pcodec_tpu_torch.ops import kernels
from pcodec_tpu_torch.ops import row_sort as rs

torch.set_num_threads(1)  # the test workers share the cores: more intra-op threads spin on theirs

RNG = np.random.default_rng(41)
U64_MAX = 0xFFFFFFFFFFFFFFFF


def _lanes():
    """Rows of u64 values: few distinct values, zeros, high entropy, long
    runs, the largest value, tiny rows, a row of 4,096 distinct values."""
    return [
        RNG.integers(0, 10, 5000).astype(np.uint64),
        np.zeros(3000, dtype=np.uint64),
        RNG.integers(0, 2**63, 5000).astype(np.uint64),
        np.repeat(RNG.integers(0, 50, 100), 50).astype(np.uint64),
        np.full(1000, U64_MAX, dtype=np.uint64),
        RNG.integers(0, 3, 777).astype(np.uint64),
        np.arange(4096, dtype=np.uint64),
        RNG.integers(0, 2, 10).astype(np.uint64),
        np.zeros(0, dtype=np.uint64),
        np.array([7], dtype=np.uint64),
        RNG.integers(0, 2**64, 3000, dtype=np.uint64),
    ]


def _tables(lanes, nb_log, device):
    """K9's inputs for the rows: sorted_extracts of the rows padded to one
    width, each at nb_log."""
    m = max(len(x) for x in lanes)
    vals = np.zeros((len(lanes), m), np.uint64)
    live = np.zeros((len(lanes), m), bool)
    for i, x in enumerate(lanes):
        vals[i, : len(x)] = RNG.permutation(x)
        live[i, : len(x)] = True
    n = torch.tensor([len(x) for x in lanes], dtype=torch.int64, device=device)
    t = torch.from_numpy(vals.view(np.int64)).to(device)
    ext = dt.sorted_extracts(t, torch.from_numpy(live).to(device), n, torch.full_like(n, nb_log))
    return ext, n


def _host_bins(x, nb_log):
    return [(b.count, b.lower, b.upper) for b in histogram(x.copy(), nb_log)]


@pytest.mark.parametrize("nb_log", [2, 5, 8, 10, 12])
def test_walk_plain_matches_host_histogram(nb_log):
    """Exact: the plain K9 over the port's extracts gives the host codec's
    histogram() bins, lane by lane, with zeros after each lane's bins."""
    lanes = _lanes()
    (V, L, R, SL1, SR, s0), n = _tables(lanes, nb_log, "cpu")
    counts, lowers, uppers, n_bins = dt.walk_bins(V, L, R, SL1, SR, s0, n, nb_log)
    co, lo, up = (t.numpy().view(np.uint64) for t in (counts, lowers, uppers))
    for i, x in enumerate(lanes):
        k = int(n_bins[i])
        got = [(int(a), int(b), int(c)) for a, b, c in zip(co[i, :k], lo[i, :k], up[i, :k])]
        assert got == _host_bins(x, nb_log), i
        assert not (co[i, k:].any() or lo[i, k:].any() or up[i, k:].any())


def test_walk_wrapper_takes_the_plain_version_on_cpu():
    """Exact: on CPU tensors walk_bins returns walk_bins_plain's result and
    launches nothing."""
    (V, L, R, SL1, SR, s0), n = _tables(_lanes(), 5, "cpu")
    before = dict(kernels.LAUNCHES)
    for a, b in zip(dt.walk_bins(V, L, R, SL1, SR, s0, n, 5), dt.walk_bins_plain(V, L, R, SL1, SR, s0, n, 5)):
        assert torch.equal(a, b)
    assert kernels.LAUNCHES == before


WALK_NS = ["1", "2", "3", "2^20", "2^31-1", "largest"]


@pytest.mark.parametrize("nb_log", [0, 8, 12, 24])
@pytest.mark.parametrize("n_name", WALK_NS)
def test_walk_reciprocal_division_is_floor_division(n_name, nb_log):
    """Exact: K9's bin index by a multiply with floor((2^64 - 1) / n) and one
    correction (walk_bin_idx_plain, the kernel's arithmetic in numpy) equals
    (c << nb_log) // n for c from 0 to n - 1: every c where n is small,
    else both ends and random c between, up to the largest n the kernel
    takes (n << nb_log just below 2^63)."""
    n = {"1": 1, "2": 2, "3": 3, "2^20": 1 << 20, "2^31-1": 2**31 - 1,
         "largest": (1 << (dt.WALK_X_BITS - nb_log)) - 1}[n_name]
    if n <= 1 << 20:
        c = np.arange(n, dtype=np.uint64)
    else:
        rng = np.random.default_rng(nb_log)
        c = np.concatenate([np.arange(5000), n - 1 - np.arange(5000),
                            rng.integers(0, n, 50_000, dtype=np.uint64)]).astype(np.uint64)
    want = np.array([(int(x) << nb_log) // n for x in c], dtype=np.uint64)
    assert np.array_equal(dt.walk_bin_idx_plain(c, n, nb_log), want)


NARROW_CASES = [(n, nb_log) for nb_log in (0, 8, 12, 24)
                for n in (1, 2, 3, 1 << 20, 2**31 - 1, (1 << (dt.WALK_NARROW_BITS - nb_log)) - 1)
                if (n + 1) << nb_log <= 1 << dt.WALK_NARROW_BITS]


@pytest.mark.parametrize("n,nb_log", NARROW_CASES)
def test_walk_reciprocal_division_in_32_bits_is_floor_division(n, nb_log):
    """Exact: the 32-bit route of K9's bin index (lanes with (n + 1) <<
    nb_log at most 2^32), floor((2^32 - 1) / n) and one correction, equals
    (c << nb_log) // n for c from 0 to n - 1 (both ends and random c
    between where n is large), up to the largest n the route takes."""
    if n <= 1 << 20:
        c = np.arange(n, dtype=np.uint64)
    else:
        rng = np.random.default_rng(n)
        c = np.concatenate([np.arange(5000), n - 1 - np.arange(5000),
                            rng.integers(0, n, 50_000, dtype=np.uint64)]).astype(np.uint64)
    want = np.array([(int(x) << nb_log) // n for x in c], dtype=np.uint64)
    assert np.array_equal(dt.walk_bin_idx_plain(c, n, nb_log, bits=32), want)


def _meta(cc) -> bytes:
    w = BitWriter()
    cc.write_meta(w)
    return w.to_bytes()


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("nb_log", list(range(2, 15)))
def test_walk_kernel_matches_plain_version_on_card(nb_log):
    """Exact: K9 on the card equals its plain version, on lanes of n 0, 1
    and 10, all-equal values, all 0xFFFF... values and full 64-bit ranges;
    its tables in shared memory up to nb_log 12, in device memory at 13 and
    14 (40 bytes a bin past the card's opt-in shared memory)."""
    _need_card()
    (V, L, R, SL1, SR, s0), n = _tables(_lanes(), nb_log, "cuda")
    before = kernels.LAUNCHES["histogram_walk"]
    got = dt.walk_bins(V, L, R, SL1, SR, s0, n, nb_log)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["histogram_walk"] == before + 1
    for a, b in zip(got, dt.walk_bins_plain(V, L, R, SL1, SR, s0, n, nb_log)):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [pt.ChunkConfig(), pt.ChunkConfig(delta_spec=pt.DeltaSpec("try_consecutive", 2))])
def test_device_training_on_card_writes_the_container(cfg):
    """Exact: training on the card (K8 and K9) plans the CPU's chunk metas,
    and the image equals the port's container_compress bytes."""
    _need_card()
    nums = np.cumsum(RNG.integers(0, 120, 70_000) + (RNG.random(70_000) < 0.01) * 10**6).astype(np.int64)
    before = dict(kernels.LAUNCHES)
    plan = asm.plan_image(nums, cfg, 256, 32768, "cuda")
    cpu = asm.plan_image(nums, cfg, 256, 32768, "cpu")
    assert plan.trained_on == "device"
    for name in ("row_sort", "histogram_walk"):
        assert kernels.LAUNCHES[name] > before[name]
    assert [_meta(j.cc) for j in plan.enc.jobs] == [_meta(j.cc) for j in cpu.enc.jobs]
    img = asm.file_image_to_bytes(*asm.run_image(plan, asm.upload_image(plan, "cuda")))
    assert img == pt.container_compress(nums, cfg, page_n=256, chunk_n=32768)


def _mode_inputs():
    """(name, numbers, config) of each mode's device training: IntMult under
    auto mode, Dict, FloatMult f32 and FloatQuant f32 pinned, and f64 under
    auto mode with chunks of Classic, FloatMult and FloatQuant."""
    rng = np.random.default_rng(42)
    n = 60_000
    ts = np.cumsum(rng.integers(1, 2000, n)).astype(np.int64) * 10**9 + rng.integers(0, 3, n)
    quant = (rng.standard_normal(20_000).astype(np.float32).view(np.uint32) & np.uint32(0xFFFFFF00)).view(np.float32)
    f64 = np.concatenate([rng.integers(-5000, 5000, 20_000) * 0.01, np.cumsum(rng.standard_normal(20_000)),
                          quant.astype(np.float64)])
    mode = lambda kind, v=0.0: pt.ChunkConfig(mode_spec=pt.ModeSpec(kind, v))  # noqa: E731
    return [
        ("int_mult_auto", ts, pt.ChunkConfig()),
        ("dict", rng.integers(-(10**12), 10**12, 900)[rng.integers(0, 900, n)], mode("try_dict")),
        ("float_mult_f32", (rng.integers(-5000, 5000, n) * np.float32(0.01)).astype(np.float32),
         mode("try_float_mult", 0.01)),
        ("float_quant_f32", (np.round(rng.standard_normal(n) * 64) / 64).astype(np.float32),
         pt.ChunkConfig(mode_spec=pt.ModeSpec("try_float_quant", 6), delta_spec=pt.DeltaSpec("no_op"))),
        ("f64_auto_mixed", f64, pt.ChunkConfig()),
    ]


@pytest.mark.gpu
@pytest.mark.parametrize("case", [c[0] for c in _mode_inputs()])
def test_every_mode_trains_on_card_to_the_container(case):
    """Exact: each mode's training on the card plans the CPU's chunk metas
    (a secondary var's and Dict's too), every K8 and K9 call it makes (the
    secondary rows and the index rows among them) equals the plain
    version, and the image equals the port's container_compress bytes."""
    _need_card()
    _, nums, cfg = next(c for c in _mode_inputs() if c[0] == case)
    calls = {"row_sort": [], "walk_bins": []}
    saved = {k: getattr(dt, k) for k in calls}
    for k in calls:
        setattr(dt, k, lambda *a, k=k: calls[k].append(a) or saved[k](*a))
    try:
        plan = asm.plan_image(nums, cfg, 256, 20_480, "cuda")
    finally:
        for k, fn in saved.items():
            setattr(dt, k, fn)
    cpu = asm.plan_image(nums, cfg, 256, 20_480, "cpu")
    assert plan.trained_on == "device"
    assert [_meta(j.cc) for j in plan.enc.jobs] == [_meta(j.cc) for j in cpu.enc.jobs]
    assert calls["row_sort"] and calls["walk_bins"]
    for (x,) in calls["row_sort"]:
        assert torch.equal(saved["row_sort"](x), rs.row_sort_plain(x))
    for a in calls["walk_bins"]:
        for got, want in zip(saved["walk_bins"](*a), dt.walk_bins_plain(*a)):
            assert torch.equal(got, want)
    img = asm.file_image_to_bytes(*asm.run_image(plan, asm.upload_image(plan, "cuda")))
    assert img == pt.container_compress(nums, cfg, page_n=256, chunk_n=20_480)


def _lookback_rows(page_n: int, bits: int):
    """Page rows of `bits`-bit latents (repeats with noise, then random
    values), the last page ragged."""
    rng = np.random.default_rng(43)
    # odd counts of pages, so the last block of the chain (two pages) is half full
    lanes = 3 if page_n > kernels.LB_CHOOSE_SMEM_MAX_N else 5 if page_n == kernels.LB_CHOOSE_SMEM_MAX_N else 7
    hi = 1 << bits
    pat = rng.integers(0, hi, 97, dtype=np.uint64)
    x = np.tile(pat, -(-lanes * page_n // 97))[: lanes * page_n] ^ rng.integers(0, 2, lanes * page_n, dtype=np.uint64)
    x[len(x) // 2 :] = rng.integers(0, hi, len(x) - len(x) // 2, dtype=np.uint64)
    lens = np.full(lanes, page_n, np.int64)
    lens[-1] = page_n // 3 + 5
    x = x.reshape(lanes, page_n)
    x[-1, lens[-1] :] = 0
    return torch.from_numpy(x.view(np.int64)), torch.from_numpy(lens)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [16, 32, 64])
@pytest.mark.parametrize("page_n", [256, 1024, 8192, 65536])
def test_lookback_choose_kernel_matches_plain_version_on_card(page_n, bits):
    """Exact: B5 on the card (its hash reads, then its chain over latents and
    counts in shared memory, up to kernels.LB_CHOOSE_SMEM_MAX_N numbers a
    page; its maps in device memory at 65,536) equals its plain version (on
    the CPU, for speed): lookbacks, primary rows and states, on full pages
    and a ragged last page, an odd count of pages."""
    _need_card()
    x, lens = _lookback_rows(page_n, bits)
    wnl = min(max((page_n * 8 - 1).bit_length(), 4), 15)
    before = kernels.LAUNCHES["lookback_choose"]
    got = dt.lookback_choose(x.cuda(), lens.cuda(), bits, wnl, 1)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["lookback_choose"] == before + 1
    for a, b in zip(got, dt.lookback_choose_plain(x, lens, bits, wnl, 1)):
        assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["try_lookback", "int_mult_lookback"])
def test_lookback_trains_on_card_to_the_container(case):
    """Exact: lookback training on the card (B5, K8, K9) plans the CPU's
    chunk metas, and the image equals the port's container_compress bytes:
    TRY_LOOKBACK, and IntMult with lookback (three vars)."""
    _need_card()
    rng = np.random.default_rng(44)
    nums = np.tile(rng.integers(0, 10**6, 300), 200).astype(np.int64) + rng.integers(0, 2, 60_000)
    spec = pt.ModeSpec("classic")
    if case == "int_mult_lookback":
        nums, spec = nums * 1000 + rng.integers(0, 7, len(nums)), pt.ModeSpec("try_int_mult", 1000)
    cfg = pt.ChunkConfig(mode_spec=spec, delta_spec=pt.DeltaSpec("try_lookback"))
    before = dict(kernels.LAUNCHES)
    plan = asm.plan_image(nums, cfg, 256, 20_480, "cuda")
    cpu = asm.plan_image(nums, cfg, 256, 20_480, "cpu")
    assert plan.trained_on == "device"
    assert {j.cc.meta.delta_encoding.kind for j in plan.enc.jobs} == {"lookback"}
    for name in ("lookback_choose", "row_sort", "histogram_walk"):
        assert kernels.LAUNCHES[name] > before[name]
    assert [_meta(j.cc) for j in plan.enc.jobs] == [_meta(j.cc) for j in cpu.enc.jobs]
    img = asm.file_image_to_bytes(*asm.run_image(plan, asm.upload_image(plan, "cuda")))
    assert img == pt.container_compress(nums, cfg, page_n=256, chunk_n=20_480)


@pytest.mark.gpu
def test_lookback_choose_kernel_on_pages_of_a_chunk_matches_the_native_chooser():
    """Exact: B5's route for pages past 2^16 numbers (device memory, 64-bit
    slots), on two pages of 2^20 (the second ragged), gives the native
    chooser's lookbacks on each page and the plain store of them. The plain
    chooser's 2^20 steps a page are too slow to run here; it equals the
    native chooser (tests/test_torch_train_lookback.py)."""
    _need_card()
    from pcodec_tpu_torch.native.kernels import choose_lookbacks_native

    rng = np.random.default_rng(45)
    m = 1 << 20
    x = (np.tile(rng.integers(0, 10**6, 512).astype(np.uint64), 2 * m // 512)
         + rng.integers(0, 2, 2 * m).astype(np.uint64)).reshape(2, m)
    lens = np.array([m, m - 1000], np.int64)
    x[1, lens[1] :] = 0
    xt, lt = torch.from_numpy(x.view(np.int64)), torch.from_numpy(lens)
    lbs, prim, states = (t.cpu() for t in dt.lookback_choose(xt.cuda(), lt.cuda(), 64, 15, 1))
    for k in range(2):
        want = choose_lookbacks_native(15, 1, x[k, : lens[k]])
        assert np.array_equal(lbs[k, : lens[k] - 1].numpy().astype(np.uint32), want)
        assert not lbs[k, lens[k] - 1 :].any()
    for a, b in zip((prim, states), dt.lookback_store_plain(xt, lt, lbs, 64, 1)):
        assert torch.equal(a, b)
