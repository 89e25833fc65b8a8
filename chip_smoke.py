#!/usr/bin/env python3
"""Build the port's CUDA kernels and drive its main path on one NVIDIA GPU.

    python3 chip_smoke.py          (from the root of the repository)

Phases, one line each (numbers beside the card's name and power limit):
  1. card         nvidia-smi name and power limit, torch's device name
  2. build        every kernel from csrc/, nvcc processes in parallel, with
                  the -Xptxas -v report (registers, shared memory, spills)
  3. kernels      small containers from the port's own encoder: K1 and K2 on
                  the card equal their plain PyTorch versions bit for bit,
                  and the decode equals the source numbers
  3b. breadth kernels
                  one small container per mode x delta kind (Classic with
                  lookback and with order-6 conv1, Dict with 4, 3,000 and
                  100,000 entries, IntMult, FloatQuant f32, FloatMult f32
                  and f64), each at page_n 256 and 1024 with a ragged last
                  page, plus a lookback container whose pages are too long
                  for shared memory: the decode equals the source, and every
                  K3 and K4 call it makes equals the plain version bit for
                  bit, K3 in shared and in global memory, K4 with its table
                  in shared and in global memory; the FloatMult joins on the
                  card equal the CPU's on NaN, inf and subnormal multipliers
                  and bases for f16, f32 and f64, and where the card's
                  native f16/f32 multiply differs from the CPU's is printed
                  (the reason the join multiplies in the softfloat)
  4. encode kernels
                  K8 on the card equals its plain version on rows of either
                  key width, from one tile to rows past 2^16 keys; small
                  inputs: K5, K6 and K7 on the card equal their plain
                  versions bit for bit, and the file image (trained through
                  K8; for two inputs also encode_container_device's bytes)
                  equals the port's container_compress bytes
  5. main path    64M taxi-like i64 (seed 1234), page_n 1024, 1M-number
                  chunks, order-1 consecutive delta:
                  decode  the container decoded on the card through K1 and
                          K2 by decode_container_tensor, compared with the
                          source; K1 and K2 held against their plain versions
                          at the main path's shapes; timed with CUDA events
                  encode  the same numbers encoded to a file image on the
                          card by encode_container_image_device: training
                          sorts each chunk's latents through K8, then K5, K6
                          and K7; compared byte for byte with the decode
                          phase's container; K5-K8 held against their plain
                          versions at these shapes; the device part and each
                          step timed with CUDA events
  5b. breadth at full size
                  the PCT inputs of bench_matrix.py's make_configs (seed
                  1234, regenerated here): wrapped_lookback_multipage (32M
                  i64, lookback; K1, K2, K3), dict_i64_100k (16M i64,
                  100,000 entries, uniform indices; K1, K2, K4 with the
                  table in global memory) and dict_i64 (32M i64, 4 values;
                  K1, K2, K4 with the table in shared memory), each encoded by the
                  host container_compress, decoded on the card by
                  decode_container_tensor, compared with the source and
                  timed; K3 and K4 held against their plain versions on
                  every call the decode made, and timed
  6. a `kernels` JSON line, then the `ok` JSON line last.

Launch counts are set to 0 just before each main-path run and read just
after it. Any failure exits non-zero before the `ok` line. Without a CUDA
device, or without the package beside this script, it fails at once.
"""

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

N = 64 * 1024 * 1024
SEED = 1234
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12  # H100 SXM non-tensor 32-bit rate
K2_OPS_PER_NUMBER = 40  # integer operations of K2's inner loop per decoded number
K5_OPS_PER_SYMBOL = 16  # K5's tANS step and offset per coded symbol, besides the search
K5_OPS_PER_STEP = 4  # K5's operations per binary-search step
K6_OPS_PER_SYMBOL = 12  # K6's two deposits per coded symbol
_MIN64 = -(1 << 63)
RUNS = 10


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def make_data() -> np.ndarray:
    """Taxi-like timestamps: sorted, jittery increments, rare jumps."""
    rng = np.random.default_rng(SEED)
    incs = rng.integers(0, 120, N)
    jumps = rng.random(N) < 0.001
    incs = incs + jumps * rng.integers(0, 10**6, N)
    return np.cumsum(incs).astype(np.int64)


def time_ms(torch, fn, runs=RUNS, warmup=2):
    """Median, min and max of `runs` CUDA-event timings of fn()."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), min(times), max(times)


def max_abs_err(torch, a, b) -> float:
    if not torch.equal(a, b):
        bad = int((a != b).sum())
        raise AssertionError(f"kernel differs from its plain version at {bad} of {a.numel()} values")
    return 0.0


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def cfg_of(pt, order, mode="classic", level=8):
    kind = "try_consecutive" if order else "no_op"
    return pt.ChunkConfig(compression_level=level, mode_spec=pt.ModeSpec(mode),
                          delta_spec=pt.DeltaSpec(kind, order))


def walk_of(rng, n):
    return np.cumsum(rng.integers(0, 120, n) + (rng.random(n) < 0.002) * 10**6)


def wide_of(rng, n):
    """Two far-apart clusters: several bins whose offsets take 39 to 63 bits."""
    return (np.where(rng.random(n) < 0.3, -(2**62), 2**61)
            + rng.integers(0, 2**45, n) * rng.integers(1, 3, n)).astype(np.int64)


def small_cases(pt):
    """(name, numbers, config, page_n, chunk_n) of the decode kernel-check phase."""
    rng = np.random.default_rng(SEED)
    walk = walk_of(rng, 50_000)
    return [
        ("i64_o1_p1024_fused", walk.astype(np.int64), cfg_of(pt, 1), 1024, 20_000),
        ("u64_o1_p256_fused", walk.astype(np.uint64), cfg_of(pt, 1), 256, 1 << 20),
        ("i32_o2_p256", (walk % 2_000_000).astype(np.int32), cfg_of(pt, 2), 256, 1 << 20),
        ("f32_o0_p1024", rng.standard_normal(30_000).astype(np.float32), cfg_of(pt, 0), 1024, 1 << 20),
        ("u16_o0_p256", rng.integers(0, 60_000, 30_000).astype(np.uint16), cfg_of(pt, 0), 256, 1 << 20),
        ("i64_wide_offsets_p1024", wide_of(rng, 20_000), cfg_of(pt, 0), 1024, 1 << 20),
        ("i64_hi_entropy_p2048", rng.integers(-(2**63), 2**63 - 1, 20_000, dtype=np.int64),
         cfg_of(pt, 0), 2048, 1 << 20),
    ]


def encode_cases(pt):
    """(name, numbers, config, page_n, chunk_n) of the encode kernel-check phase."""
    rng = np.random.default_rng(SEED + 1)
    walk = walk_of(rng, 50_000)
    return [
        ("i64_o1_p1024_ragged_chunks", walk.astype(np.int64), cfg_of(pt, 1), 1024, 20_500),
        ("u64_o1_p256", walk.astype(np.uint64), cfg_of(pt, 1), 256, 1 << 20),
        ("i32_o2_p512", (walk % 2_000_000).astype(np.int32), cfg_of(pt, 2), 512, 1 << 20),
        ("f32_classic_o0", rng.standard_normal(30_000).astype(np.float32), cfg_of(pt, 0), 1024, 1 << 20),
        ("u16_o0", rng.integers(0, 60_000, 30_000).astype(np.uint16), cfg_of(pt, 0), 256, 1 << 20),
        ("i64_wide_offsets", wide_of(rng, 20_000), cfg_of(pt, 0), 1024, 1 << 20),
        ("i64_hi_entropy_p2048", rng.integers(-(2**63), 2**63 - 1, 20_000, dtype=np.int64),
         cfg_of(pt, 0), 2048, 1 << 20),
        ("constant_trivial", np.full(30_000, -77, np.int64), cfg_of(pt, 1), 1024, 1 << 20),
        ("one_bin_with_offsets", rng.integers(0, 5000, 30_000).astype(np.int64), cfg_of(pt, 0, level=0),
         512, 1 << 20),
        ("dict", np.array([3, 99, 1234567, -5], np.int64)[rng.integers(0, 4, 30_000)],
         cfg_of(pt, 0, "try_dict"), 256, 1 << 20),
    ]


def breadth_cases(pt):
    """(name, numbers, config) of the breadth kernel-check phase: one
    container per mode x delta kind, counts that leave a ragged last page."""
    rng = np.random.default_rng(SEED + 3)
    n = 12_345
    t = np.arange(n, dtype=np.float64)
    lookback = np.tile(rng.integers(0, 10**6, 512), n // 512 + 1)[:n] + rng.integers(0, 2, n)
    lpc = (1 << 20) * np.sin(0.01 * t) + (1 << 18) * np.sin(0.003 * t + 1.0) + rng.integers(-64, 64, n)
    v3000 = rng.integers(-(10**12), 10**12, 3000)
    v100k = rng.integers(-(10**12), 10**12, 100_000)
    # every entry used, and enough numbers that the dictionary pays for itself
    every = np.concatenate([rng.permutation(100_000), rng.integers(0, 100_000, 300_001)])

    def cfg(mode=("classic", 0.0), delta=("no_op", 0)):
        return pt.ChunkConfig(mode_spec=pt.ModeSpec(*mode), delta_spec=pt.DeltaSpec(*delta))

    return [
        ("classic_lookback", lookback.astype(np.int64), cfg(delta=("try_lookback", 0))),
        ("classic_conv1_o6", lpc.astype(np.int32), cfg(delta=("try_conv1", 6))),
        ("dict_4", np.array([3, 99, 1234567, -5], np.int64)[rng.integers(0, 4, n)], cfg(("try_dict", 0.0))),
        ("dict_3000", v3000[rng.integers(0, 3000, n)].astype(np.int64), cfg(("try_dict", 0.0))),
        ("dict_100k", v100k[every].astype(np.int64), cfg(("try_dict", 0.0))),
        ("int_mult", (np.cumsum(rng.integers(1, 30, n)) * 10**9 + rng.integers(0, 4, n)).astype(np.int64),
         cfg(("try_int_mult", 10**9))),
        ("float_quant_f32", (np.round(rng.standard_normal(n) * 16) / 16).astype(np.float32),
         cfg(("try_float_quant", 12))),
        ("float_mult_f32", (rng.integers(-5000, 5000, n) * np.float32(0.01)).astype(np.float32),
         cfg(("try_float_mult", 0.01))),
        ("float_mult_f64", rng.integers(-5000, 5000, n) * 0.01, cfg(("try_float_mult", 0.01))),
    ]


@contextlib.contextmanager
def capturing(dec):
    """Record the arguments of every K3 and K4 call that a decode makes,
    so the kernels can be held against their plain versions at exactly
    those inputs."""
    calls = {"lookback_recon": [], "dict_join": []}
    saved = {k: getattr(dec, k) for k in calls}

    def recorder(name):
        def call(*args):
            calls[name].append(args)
            return saved[name](*args)
        return call

    for k in calls:
        setattr(dec, k, recorder(k))
    try:
        yield calls
    finally:
        for k, fn in saved.items():
            setattr(dec, k, fn)


def check_breadth_calls(torch, dec, calls) -> float:
    """K3 and K4 against their plain versions on every recorded call."""
    for args in calls["lookback_recon"]:
        max_abs_err(torch, dec.lookback_recon(*args), dec.lookback_decode_pages_plain(*args))
    for args in calls["dict_join"]:
        max_abs_err(torch, dec.dict_join(*args), dec.dict_join_plain(*args))
    return 0.0


def kernel_route(kernels, name, args, smem_entries) -> str:
    """Which route of K3 or K4 a recorded call took."""
    if name == "lookback_recon":
        return "K3 shared memory" if args[0].shape[1] <= kernels.LB_SMEM_MAX_N else "K3 global memory"
    return "K4 table in shared memory" if args[1].shape[0] <= smem_entries else "K4 table in global memory"


def join_inputs(nt, rng):
    """FloatMult primaries (full range, so NaN and inf multipliers, and
    small ones, whose products with tiny bases are subnormal) and bases
    (normal, tiny, subnormal, zero, inf, NaN) as latents of the type."""
    bits = nt.latent.bits
    mid = 1 << (bits - 1)
    prim = rng.integers(0, 1 << min(bits, 63), 20_000, dtype=np.uint64)
    if bits == 64:
        prim |= rng.integers(0, 2, 20_000, dtype=np.uint64) << np.uint64(63)
    prim[:4000] = np.uint64(mid) + rng.integers(-3000, 3000, 4000).astype(np.uint64)
    sec = rng.integers(0, 1 << min(bits, 63), 20_000, dtype=np.uint64)
    udt = nt.latent.np_dtype
    floats = np.array([0.01, 1e-30, 3.0, np.inf, np.nan, 0.0], nt.np_dtype)
    subnormal = np.array([1, 7], udt).view(nt.np_dtype)
    bases = nt.to_latent_ordered(np.concatenate([floats, subnormal]))
    return prim, sec, [int(b) for b in bases]


def matrix_inputs(pt):
    """The PCT decode inputs of bench_matrix.py's make_configs: its seed-1234
    draws replayed in order (the configs before these are drawn and
    dropped), so the numbers are the benchmark's own."""
    rng = np.random.default_rng(1234)
    n, n2, n4 = 48 << 20, 32 << 20, 16 << 20
    for draw in (lambda: rng.integers(0, 120, n), lambda: rng.random(n), lambda: rng.integers(0, 10**6, n),
                 lambda: rng.standard_normal(n2), lambda: rng.integers(1, 30, n2), lambda: rng.integers(0, 4, n2),
                 lambda: rng.integers(-5000, 5000, n), lambda: rng.standard_normal(n)):
        draw()
    pattern = rng.integers(0, 10**6, 512).astype(np.int64)
    reps = np.tile(pattern, n2 // 512)
    lookback = reps + rng.integers(0, 2, len(reps))
    dict4 = np.array([3, 99, 1234567, -5], dtype=np.int64)[rng.integers(0, 4, n2)]
    big_vals = rng.integers(-(10**12), 10**12, 100_000).astype(np.int64)
    dict100k = big_vals[rng.integers(0, 100_000, n4)]
    lb_cfg = pt.ChunkConfig(delta_spec=pt.DeltaSpec(pt.DeltaSpec.TRY_LOOKBACK))
    dict_cfg = pt.ChunkConfig(mode_spec=pt.ModeSpec(pt.ModeSpec.TRY_DICT))
    return [("wrapped_lookback_multipage", lookback, lb_cfg, "lookback_recon"),
            ("dict_i64_100k", dict100k, dict_cfg, "dict_join"),
            ("dict_i64", dict4, dict_cfg, "dict_join")]


def breadth_kernel_numbers(torch, dec, name, calls):
    """Bytes K3 or K4 must move over the recorded calls of one decode, and
    the PyTorch call that computes the same function, where one does."""
    if name == "lookback_recon":  # latents, lookbacks and output at 8 B, and the state
        return sum(3 * nbytes(a[0]) + nbytes(a[2]) for a in calls), None
    # 8 B of index in and 8 B of bits out per number, and the table once
    idx = [torch.clamp(a[0] & 0xFFFFFFFF, max=a[1].shape[0] - 1) for a in calls]
    for (prim, table), i in zip(calls, idx):
        if not torch.equal(torch.take(table, i), dec.dict_join(prim, table)):
            raise AssertionError("K4's torch.take yardstick computes another function")
    return (sum(2 * nbytes(a[0]) + nbytes(a[1]) for a in calls),
            lambda: [torch.take(a[1], i) for a, i in zip(calls, idx)])


def native_product_mismatch(torch, sf, nt, prim, base, dev):
    """Products of the FloatMult multipliers and a base in the card's native
    f16/f32 multiply (the JAX package's join) against the same multiply on
    the CPU: (differing count, first differing index, CPU bits, card bits).
    Why the port's join multiplies in the integer softfloat instead."""
    W, P = nt.latent.bits, nt.mantissa_digits
    fdt, idt = {16: (torch.float16, torch.int16), 32: (torch.float32, torch.int32)}[W]
    mult = sf.int_float_latent_to_bits(prim, W, W - P, P).to(idt).view(fdt)
    base_f = torch.tensor([base], dtype=torch.int64).to(idt).view(fdt)
    cpu = (mult * base_f).view(idt)
    card = (mult.to(dev) * base_f.to(dev)).view(idt).cpu()
    bad = (cpu != card).nonzero().flatten()
    if not len(bad):
        return 0, None, None, None
    i = int(bad[0])
    return len(bad), i, int(cpu[i]) & ((1 << W) - 1), int(card[i]) & ((1 << W) - 1)


def ptxas_lines(reports):
    """(kernel, variant, 'Used ...' or spill line) of each ptxas report."""
    for k, rep in reports.items():
        entry = "kernel"
        for line in rep.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = m.group(1)
                fuse = re.search(r"ILi(\d)E", name)
                smem = re.search(r"ILb(\d)E", name)
                keys = ", u32 keys" if "IjE" in name else ", u64 keys"
                ept = re.search(r"lb_smem_kernelILi(\d+)E", name)
                entry = (f"shared memory, {ept.group(1)} per thread" if ept else
                         "global route, prologue" if "lb_init_kernel" in name else
                         "global route, one round" if "lb_round_kernel" in name else
                         f"fuse {fuse.group(1)}" if fuse else
                         ("table in shared memory" if smem.group(1) == "1" else "table in global memory")
                         if smem else "tile pass" + keys if "tile_kernel" in name
                         else "global pass" + keys if "global_pass" in name else "kernel")
            elif "Used" in line:
                yield k, entry, line.split(":", 1)[1].strip()
            elif "spill" in line:
                yield k, entry, line.strip()


def k5_args(a):
    return (a["latents"], a["body_n"], a["table_id"], a["states0"], a["nexts"], a["lowers"],
            a["t1"], a["t2"])


def sort_rows(rng, span, rows, m):
    """(rows, m) int64 holding u64 keys with ties, whose spans fit 32 bits
    or need 64."""
    x = rng.integers(0, 2**32 if span == "u32" else 2**64, (rows, m), dtype=np.uint64)
    x[:, : m // 3] = x[:, :1]
    return (x + np.uint64(5 << 40) if span == "u32" else x).view(np.int64)


def stitch_args(prep):
    return (prep["rowsA"], prep["F0A"], prep["lenA"], prep["rowsC"], prep["F0C"], prep["lenC"])


def check_encode_steps(torch, ce, asm, plan, a):
    """K5, K6 and K7 against their plain versions on one uploaded plan.
    Returns their errors and the intermediate tensors."""
    outs = ce.bin_ans_encode(*k5_args(a))
    err = {"bin_ans_encode": max(max_abs_err(torch, x, y)
                                 for x, y in zip(outs, ce.bin_ans_encode_plain(*k5_args(a))))}
    p1, offsets, states = outs
    ans_len, off_len, curs, total_bits = ce.section_cursors(p1)
    W = plan.launch.sec_words
    sections = ce.section_pack(p1, offsets, curs, W)
    err["section_pack"] = max_abs_err(torch, sections, ce.section_pack_plain(p1, offsets, curs, W))
    prep = asm.prepare_image(plan, a, sections, states, ans_len, off_len, total_bits)
    nw = -(-int(prep["sizes"][0]) // 4)
    body = asm.image_stitch(*stitch_args(prep), nw)
    err["image_stitch"] = max_abs_err(torch, body, asm.image_stitch_plain(*stitch_args(prep), nw))
    return dict(err=err, p1=p1, offsets=offsets, states=states, ans_len=ans_len, off_len=off_len, curs=curs,
                total_bits=total_bits, sections=sections, prep=prep, body_words=nw)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import pcodec_tpu_torch as pt
    from pcodec_tpu_torch.dtypes import NUMBER_TYPES_BY_NAME
    from pcodec_tpu_torch.ops import assemble as asm
    from pcodec_tpu_torch.ops import container_decode as cd
    from pcodec_tpu_torch.ops import container_encode as ce
    from pcodec_tpu_torch.ops import decode as dops
    from pcodec_tpu_torch.ops import kernels
    from pcodec_tpu_torch.ops import row_sort as rs
    from pcodec_tpu_torch.ops import softfloat as sf

    dev = torch.device("cuda")
    # 1. card
    card = card_line()
    device_kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch: {device_kind} | count {torch.cuda.device_count()} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.time()
    reports = kernels.build()
    for k, entry, line in ptxas_lines(reports):
        print(f"build: {k} ({entry}): {line}", flush=True)
    print(f"build: {len(reports)} kernels in {time.time() - t0:.1f} s [{card}]", flush=True)

    # 3. decode kernels against plain versions on small containers
    for case, nums, cfg, page_n, chunk_n in small_cases(pt):
        data = pt.container_compress(nums, cfg, page_n=page_n, chunk_n=chunk_n)
        plan = cd.plan_container(data)
        arrays = cd.upload_plan(plan, dev)
        for lkey, cp in plan.launches.items():
            a = arrays.launches[lkey]
            stg = cd.section_gather(arrays.words, a["word0"], cp.stage_words)
            max_abs_err(torch, stg, cd.section_gather_plain(arrays.words, a["word0"], cp.stage_words))
            args = (stg, a["word0"], a["curs"], a["states0"], a["body_n"], a["table_id"],
                    a["node"], a["lower"], a["moment0"], cp.page_n, cp.fuse)
            max_abs_err(torch, cd.chain_decode(*args), cd.chain_decode_plain(*args))
        got = cd.to_numbers(cd.decode_plan(plan, arrays), plan.nt)
        if not np.array_equal(got.view(np.uint8), nums.view(np.uint8)):
            raise AssertionError(f"{case}: decode differs from the source")
        fuses = sorted({cp.fuse for cp in plan.launches.values()})
        print(f"kernels: {case}: K1, K2 == plain, decode == source (fuse {fuses})", flush=True)
    torch.cuda.synchronize()

    # 3b. breadth kernels: every mode x delta kind, K3 and K4 on both routes
    smem_entries = kernels.dict_join_smem_entries(dev)
    breadth = breadth_cases(pt)
    cases = [(case, nums, cfg, page_n) for case, nums, cfg in breadth for page_n in (256, 1024)]
    long_pages = np.tile(breadth[0][1], 4)  # pages of 20,480 numbers: K3 in global memory
    cases.append(("classic_lookback_long_pages", long_pages, breadth[0][2], 20_480))
    seen = set()
    for case, nums, cfg, page_n in cases:
        data = pt.container_compress(nums, cfg, page_n=page_n)
        plan = cd.plan_container(data)
        arrays = cd.upload_plan(plan, dev)
        with capturing(dops) as calls:
            got = cd.to_numbers(cd.decode_plan(plan, arrays), plan.nt)
        if not np.array_equal(got.view(np.uint8), nums.view(np.uint8)):
            raise AssertionError(f"{case} p{page_n}: decode differs from the source")
        check_breadth_calls(torch, dops, calls)
        ch = plan.chunks[0]
        want = {"lookback_recon": ch.delta.kind == "lookback", "dict_join": ch.mode_kind == "dict"}
        for k, expected in want.items():
            if bool(calls[k]) != expected:
                raise AssertionError(f"{case} p{page_n}: {len(calls[k])} {k} calls, expected them: {expected}")
        routes = {kernel_route(kernels, k, a, smem_entries) for k, recorded in calls.items() for a in recorded}
        seen |= routes
        print(f"breadth: {case} p{page_n}: decode == source, {ch.mode_kind}/{ch.delta.kind}, "
              f"{sorted(routes) or 'no K3/K4'} == plain", flush=True)
    if len(seen) != 4:
        raise AssertionError(f"phase 3b did not run both routes of K3 and of K4: {sorted(seen)}")
    rng = np.random.default_rng(SEED + 4)
    for ftype in ("f16", "f32", "f64"):
        nt = NUMBER_TYPES_BY_NAME[ftype]
        prim, sec, bases = join_inputs(nt, rng)
        p_cpu, s_cpu = dops._u64_to_tensor(prim), dops._u64_to_tensor(sec)
        if ftype != "f64":
            base0 = dops.from_latent_ordered_int(nt, bases[0])
            n_bad, i, want_b, got_b = native_product_mismatch(torch, sf, nt, p_cpu, base0, dev)
            first = f", first at index {i}: CPU {want_b:#x}, card {got_b:#x}" if n_bad else ""
            print(f"breadth: native {ftype} multiply (the JAX package's join) of {len(prim)} multipliers by "
                  f"base {base0:#x}: the card differs from the CPU at {n_bad}{first} [{card}]", flush=True)
        for base in bases:
            want_bits = dops.join_mem(nt, "float_mult", base, p_cpu, s_cpu)
            got_bits = dops.join_mem(nt, "float_mult", base, p_cpu.to(dev), s_cpu.to(dev)).cpu()
            if not torch.equal(got_bits, want_bits):
                raise AssertionError(f"FloatMult {ftype} join with base latent {base:#x} differs on the card "
                                     f"at {int((got_bits != want_bits).sum())} numbers")
    print("breadth: FloatMult joins on the card == CPU for f16, f32, f64 on NaN, inf, subnormal "
          "multipliers and bases", flush=True)
    torch.cuda.synchronize()

    # 4. encode kernels against plain versions on small inputs
    rng = np.random.default_rng(SEED + 2)
    for span in ("u32", "u64"):
        for m in (3, 256, 5000, 70_000, 1 << 20):
            x = torch.from_numpy(sort_rows(rng, span, 3, m)).to(dev)
            max_abs_err(torch, rs.row_sort(x), rs.row_sort_plain(x))
    print("encode: K8 row_sort == plain, keys of 32 and 64 bits, rows of 3 to 2^20 keys", flush=True)
    for i, (case, nums, cfg, page_n, chunk_n) in enumerate(encode_cases(pt)):
        ref = pt.container_compress(nums, cfg, page_n=page_n, chunk_n=chunk_n)
        plan = asm.plan_image(nums, cfg, page_n, chunk_n, dev)
        a = asm.upload_image(plan, dev)
        steps = "no chains (trivial var)"
        if plan.launch.n_chains:
            check_encode_steps(torch, ce, asm, plan, a)
            steps = "K5, K6, K7 == plain"
        if asm.file_image_to_bytes(*asm.run_image(plan, a)) != ref:
            raise AssertionError(f"{case}: file image differs from container_compress")
        entry = ""
        if i in (0, 5):
            if pt.encode_container_device(nums, cfg, page_n, chunk_n, device=dev) != ref:
                raise AssertionError(f"{case}: encode_container_device differs from container_compress")
            entry = ", encode_container_device == container_compress"
        L = plan.launch
        bins = sorted({len(job.tables[1]) for job in plan.enc.jobs if not job.trivial})
        print(f"encode: {case}: {steps}, image == container_compress{entry} "
              f"({len(plan.enc.jobs)} chunks, {L.n_chains} chains, bins {bins}, "
              f"sec_words {L.sec_words})", flush=True)
    torch.cuda.synchronize()

    # 5. main path: decode
    t0 = time.time()
    nums = make_data()
    cfg = pt.ChunkConfig(delta_spec=pt.DeltaSpec(pt.DeltaSpec.TRY_CONSECUTIVE, 1))
    data = pt.container_compress(nums, cfg, page_n=1024, chunk_n=1 << 20)
    t_enc = time.time() - t0
    t0 = time.time()
    plan = cd.plan_container(data)
    t_plan = time.time() - t0
    ratio = nums.nbytes / len(data)
    print(f"main: {N} taxi-like i64, {len(data)} bytes, ratio {ratio:.4f}, host encode {t_enc:.1f} s, "
          f"host plan {t_plan:.3f} s, {len(plan.chunks)} chunks, "
          f"{sum(cp.n_chains for cp in plan.launches.values())} chains", flush=True)
    if len(plan.launches) != 1:
        raise AssertionError(f"expected one launch, got {list(plan.launches)}")
    for ci, ch in enumerate(plan.chunks):
        vp = ch.var_plans["primary"]
        if vp.launch_key is None or plan.launches[vp.launch_key].fuse != 1:
            raise AssertionError(f"chunk {ci} did not take the fused K2 path")

    src = torch.from_numpy(nums).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    res = cd.decode_container_tensor(data, dev, plan)  # upload, K1, K2, post
    torch.cuda.synchronize()
    dec_launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if not torch.equal(res, src):
        raise AssertionError(f"main path decode differs at {int((res != src).sum())} of {N} numbers")
    if dec_launches["section_gather"] == 0 or dec_launches["chain_decode"] == 0:
        raise AssertionError(f"a kernel of the decode path was not launched: {dec_launches}")
    del res, src
    print(f"main: decode == source (torch.equal), launches {dec_launches}, "
          f"max_memory_allocated {peak} bytes [{card}]", flush=True)

    arrays = cd.upload_plan(plan, dev)
    (lkey, cp), = plan.launches.items()
    a = arrays.launches[lkey]
    words, W = arrays.words, cp.stage_words
    stg = cd.section_gather(words, a["word0"], W)
    k1_err = max_abs_err(torch, stg, cd.section_gather_plain(words, a["word0"], W))
    args = (stg, a["word0"], a["curs"], a["states0"], a["body_n"], a["table_id"], a["node"],
            a["lower"], a["moment0"], cp.page_n, cp.fuse)
    k2_err = max_abs_err(torch, cd.chain_decode(*args), cd.chain_decode_plain(*args))

    dec = time_ms(torch, lambda: cd.decode_plan(plan, arrays))
    k1 = time_ms(torch, lambda: cd.section_gather(words, a["word0"], W))
    k2 = time_ms(torch, lambda: cd.chain_decode(*args))
    k1_plain = time_ms(torch, lambda: cd.section_gather_plain(words, a["word0"], W), runs=3, warmup=1)
    k2_plain = time_ms(torch, lambda: cd.chain_decode_plain(*args), runs=3, warmup=1)
    # yardstick for K1: one torch.take over a precomputed index (the index is not timed)
    col = torch.arange(W, device=dev)
    idx = a["word0"][:, None] + col[None, :]
    idx = torch.where(col[None, :] < W - cd.SLACK_WORDS, idx.clamp(max=words.numel()), words.numel())
    words_ext = torch.cat([words, words.new_zeros(1)])
    if not torch.equal(torch.take(words_ext, idx), stg):
        raise AssertionError("K1's torch.take yardstick computes another function")
    k1_lib = time_ms(torch, lambda: torch.take(words_ext, idx))

    n_chains = cp.n_chains
    out_bytes = n_chains * cp.page_n * 8
    k1_bytes = n_chains * 8 + n_chains * (W - cd.SLACK_WORDS) * 4 + n_chains * W * 4
    k2_in = stg.numel() * 4 + nbytes(*(a[k] for k in ("word0", "curs", "states0", "body_n",
                                                       "table_id", "node", "lower", "moment0")))
    k2_bytes = k2_in + out_bytes
    k1_bound = k1_bytes / HBM_BYTES_PER_S * 1e3
    k2_ops_ms = int(cp.body_n.sum()) * K2_OPS_PER_NUMBER / SCALAR_OPS_PER_S * 1e3
    k2_bound = max(k2_bytes / HBM_BYTES_PER_S * 1e3, k2_ops_ms)
    dec_bound = (len(data) + N * 8) / HBM_BYTES_PER_S * 1e3
    gbps = N * 8 / (dec[0] * 1e-3) / 1e9
    print(f"main: decode {dec[0]:.3f} ms median (min {dec[1]:.3f}, max {dec[2]:.3f}, {RUNS} runs), "
          f"{gbps:.2f} GB/s of output, byte bound {dec_bound:.4f} ms = {dec_bound / dec[0]:.1%} "
          f"[{card}]", flush=True)
    print(f"main: K1 section_gather {k1[0]:.4f} ms (min {k1[1]:.4f}, max {k1[2]:.4f}), "
          f"plain {k1_plain[0]:.3f} ms, torch.take {k1_lib[0]:.4f} ms, bound {k1_bound:.4f} ms "
          f"[{card}]", flush=True)
    print(f"main: K2 chain_decode {k2[0]:.4f} ms (min {k2[1]:.4f}, max {k2[2]:.4f}), "
          f"plain {k2_plain[0]:.1f} ms, bound {k2_bound:.4f} ms [{card}]", flush=True)
    k2_by = "bytes" if k2_bytes / HBM_BYTES_PER_S * 1e3 >= k2_ops_ms else "operations"
    del arrays, a, words, stg, args, idx, words_ext, col
    torch.cuda.empty_cache()

    # 5. main path: encode to a file image on the card
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    t0 = time.time()
    image = pt.encode_container_image_device(nums, cfg, page_n=1024, chunk_n=1 << 20, device=dev)
    torch.cuda.synchronize()
    t_img = time.time() - t0
    enc_launches = {k: kernels.LAUNCHES[k]
                    for k in ("row_sort", "bin_ans_encode", "section_pack", "image_stitch")}
    peak_enc = torch.cuda.max_memory_allocated()
    if asm.file_image_to_bytes(*image) != data:
        raise AssertionError("main path file image differs from container_compress's bytes")
    if any(v == 0 for v in enc_launches.values()):
        raise AssertionError(f"a kernel of the encode path was not launched: {enc_launches}")
    del image
    print(f"main: file image == container_compress bytes ({len(data)}), launches {enc_launches}, "
          f"encode_container_image_device {t_img:.1f} s (host training included), "
          f"max_memory_allocated {peak_enc} bytes [{card}]", flush=True)

    t0 = time.time()
    iplan = asm.plan_image(nums, cfg, 1024, 1 << 20, dev)
    t_iplan = time.time() - t0
    t0 = time.time()
    ia = asm.upload_image(iplan, dev)
    torch.cuda.synchronize()
    t_up = time.time() - t0
    L = iplan.launch
    st = check_encode_steps(torch, ce, asm, iplan, ia)
    prep, nw = st["prep"], st["body_words"]
    print(f"main: host plan_image {t_iplan:.3f} s, upload {t_up:.3f} s, {L.n_chains} chains, "
          f"b_pad {L.lowers.shape[1]}, ts {L.nexts.shape[1]}, sec_words {L.sec_words}, "
          f"page p is chain p: {iplan.identity}; "
          f"K5, K6, K7 == plain at these shapes", flush=True)

    # K8 at the main path's shape: chunk 0's latents as its training sorts them
    cc0 = iplan.enc.jobs[0].cc
    lat0 = cc0.lvcs.primary.latents
    train0 = np.concatenate([lat0[i.per_latent_var.primary.start : i.per_latent_var.primary.end]
                             for i in cc0.page_infos]).astype(np.uint64)
    x8 = torch.from_numpy(train0.view(np.int64)).to(dev)[None]
    s8 = rs.row_sort(x8)
    k8_err = max_abs_err(torch, s8, rs.row_sort_plain(x8))
    if not np.array_equal(s8[0].cpu().numpy().view(np.uint64), np.sort(train0)):
        raise AssertionError("K8 differs from numpy's sort at the main path's shape")
    x8b = x8 ^ _MIN64  # unsigned order as int64 order, for torch.sort (not timed)
    k8 = time_ms(torch, lambda: rs.row_sort(x8))
    k8_plain = time_ms(torch, lambda: rs.row_sort_plain(x8))
    k8_lib = time_ms(torch, lambda: torch.sort(x8b, dim=1))
    m8 = x8.shape[1]
    span8 = int(train0.max() - train0.min())
    print(f"main: K8 row_sort {k8[0]:.4f} ms (min {k8[1]:.4f}, max {k8[2]:.4f}) for chunk 0's "
          f"{m8} latents (span {span8}, {'u32' if span8 <= 0xFFFFFFFF else 'u64'} keys), "
          f"plain {k8_plain[0]:.4f} ms, torch.sort {k8_lib[0]:.4f} ms [{card}]", flush=True)

    enc = time_ms(torch, lambda: asm.run_image(iplan, ia))
    k5 = time_ms(torch, lambda: ce.bin_ans_encode(*k5_args(ia)))
    glue = time_ms(torch, lambda: ce.section_cursors(st["p1"]))
    k6 = time_ms(torch, lambda: ce.section_pack(st["p1"], st["offsets"], st["curs"], L.sec_words))
    prep_t = time_ms(torch, lambda: asm.prepare_image(iplan, ia, st["sections"], st["states"],
                                                      st["ans_len"], st["off_len"], st["total_bits"]))
    k7 = time_ms(torch, lambda: asm.image_stitch(*stitch_args(prep), nw))
    k5_plain = time_ms(torch, lambda: ce.bin_ans_encode_plain(*k5_args(ia)), runs=3, warmup=1)
    k6_plain = time_ms(torch, lambda: ce.section_pack_plain(st["p1"], st["offsets"], st["curs"],
                                                            L.sec_words), runs=3, warmup=1)
    k7_plain = time_ms(torch, lambda: asm.image_stitch_plain(*stitch_args(prep), nw), runs=3, warmup=1)
    # yardstick for K7: one index_add_ of the row words over a precomputed
    # flat index (the index and the int64 words are not timed)
    flat_idx, flat_val = [], []
    for rows, F0, lenW in ((prep["rowsA"], prep["F0A"], prep["lenA"]),
                           (prep["rowsC"], prep["F0C"], prep["lenC"])):
        w = torch.arange(rows.shape[1], device=dev)
        ok = w[None, :] < lenW[:, None]
        flat_idx.append((F0[:, None] + w[None, :])[ok])
        flat_val.append((rows.to(torch.int64) & 0xFFFFFFFF)[ok])
    flat_idx, flat_val = torch.cat(flat_idx), torch.cat(flat_val)
    body64 = torch.zeros(nw, dtype=torch.int64, device=dev)

    def k7_library():
        body64.zero_()
        body64.index_add_(0, flat_idx, flat_val)

    k7_library()
    if not torch.equal(ce._to_i32(body64), asm.image_stitch(*stitch_args(prep), nw)):
        raise AssertionError("K7's index_add_ yardstick computes another function")
    k7_lib = time_ms(torch, k7_library)

    # bytes the functions need: each coded symbol's latent in, its p1 word
    # and its offset (4 bytes unless some bin has over 32 offset bits) out;
    # K6 writes the payload words only, the rows' zero tails are the
    # wrapper's memset
    syms = int(L.body_n.sum())
    b_pad = L.lowers.shape[1]
    off_b = 8 if int(((ia["t1"] >> 4) & 127).max()) > 32 else 4
    k5_bytes = (syms * (8 + 4 + off_b) + nbytes(*(ia[k] for k in ("body_n", "table_id", "states0", "nexts",
                                                                  "lowers", "t1", "t2")))
                + nbytes(st["states"]))
    k5_ops_ms = syms * (K5_OPS_PER_SYMBOL + K5_OPS_PER_STEP * int(math.log2(b_pad))) / SCALAR_OPS_PER_S * 1e3
    k5_bound = max(k5_bytes / HBM_BYTES_PER_S * 1e3, k5_ops_ms)
    payload_words = int(((st["total_bits"] + 31) >> 5).sum())
    k6_bytes = syms * (4 + off_b) + nbytes(st["curs"]) + payload_words * 4
    k6_ops_ms = syms * K6_OPS_PER_SYMBOL / SCALAR_OPS_PER_S * 1e3
    k6_bound = max(k6_bytes / HBM_BYTES_PER_S * 1e3, k6_ops_ms)
    row_words = int(prep["lenA"].sum()) + int(prep["lenC"].sum())
    k7_bytes = row_words * 4 + nbytes(prep["F0A"], prep["lenA"], prep["F0C"], prep["lenC"]) + nw * 4
    k7_bound = k7_bytes / HBM_BYTES_PER_S * 1e3
    k8_bytes = 2 * m8 * 8  # each u64 latent read once and written once
    k8_ops_ms = m8 * math.log2(m8) / SCALAR_OPS_PER_S * 1e3  # m log2 m compares
    k8_bound = max(k8_bytes / HBM_BYTES_PER_S * 1e3, k8_ops_ms)
    enc_bound = (N * 8 + len(data)) / HBM_BYTES_PER_S * 1e3
    enc_gbps = N * 8 / (enc[0] * 1e-3) / 1e9
    print(f"main: encode device part (K5, glue, K6, prep, K7) {enc[0]:.3f} ms median "
          f"(min {enc[1]:.3f}, max {enc[2]:.3f}, {RUNS} runs), {enc_gbps:.2f} GB/s of input, "
          f"byte bound {enc_bound:.4f} ms = {enc_bound / enc[0]:.1%} [{card}]", flush=True)
    print(f"main: K5 bin_ans_encode {k5[0]:.4f} ms (min {k5[1]:.4f}, max {k5[2]:.4f}), "
          f"plain {k5_plain[0]:.1f} ms, bound {k5_bound:.4f} ms [{card}]", flush=True)
    print(f"main: glue section_cursors {glue[0]:.4f} ms (min {glue[1]:.4f}, max {glue[2]:.4f}) "
          f"[{card}]", flush=True)
    print(f"main: K6 section_pack {k6[0]:.4f} ms (min {k6[1]:.4f}, max {k6[2]:.4f}), "
          f"plain {k6_plain[0]:.1f} ms, bound {k6_bound:.4f} ms [{card}]", flush=True)
    print(f"main: prep prepare_image {prep_t[0]:.4f} ms (min {prep_t[1]:.4f}, max {prep_t[2]:.4f}) "
          f"[{card}]", flush=True)
    print(f"main: K7 image_stitch {k7[0]:.4f} ms (min {k7[1]:.4f}, max {k7[2]:.4f}), "
          f"plain {k7_plain[0]:.3f} ms, index_add_ {k7_lib[0]:.4f} ms, bound {k7_bound:.4f} ms "
          f"[{card}]", flush=True)
    print(f"main: K8 bound {k8_bound:.4f} ms; bytes counted: K5 {k5_bytes}, K6 {k6_bytes} "
          f"({payload_words} payload words, offsets at {off_b} bytes), K8 {k8_bytes} [{card}]", flush=True)

    del ia, prep, flat_idx, flat_val, body64, x8, x8b, s8
    torch.cuda.empty_cache()

    # 5b. breadth at full size
    breadth_rows = {}
    for case, nums5, cfg5, kname in matrix_inputs(pt):
        t0 = time.time()
        data5 = pt.container_compress(nums5, cfg5)
        t_enc5 = time.time() - t0
        t0 = time.time()
        plan5 = cd.plan_container(data5)
        t_plan5 = time.time() - t0
        src = torch.from_numpy(nums5).to(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        with capturing(dops) as calls:
            res = cd.decode_container_tensor(data5, dev, plan5)
            torch.cuda.synchronize()
        launches5 = dict(kernels.LAUNCHES)
        peak5 = torch.cuda.max_memory_allocated()
        if not torch.equal(res, src):
            raise AssertionError(f"{case}: decode differs at {int((res != src).sum())} of {len(nums5)} numbers")
        del res, src
        if launches5[kname] == 0 or (plan5.launches and launches5["chain_decode"] == 0):
            raise AssertionError(f"{case}: a kernel of its decode path was not launched: {launches5}")
        kcalls = calls[kname]
        err5 = check_breadth_calls(torch, dops, calls)
        arrays5 = cd.upload_plan(plan5, dev)
        dec5 = time_ms(torch, lambda: cd.decode_plan(plan5, arrays5))
        k12 = time_ms(torch, lambda: [cd.run_launch(cp, arrays5.words, arrays5.launches[lk])
                                      for lk, cp in plan5.launches.items()])
        kern = getattr(dops, kname)
        plain = dops.lookback_decode_pages_plain if kname == "lookback_recon" else dops.dict_join_plain
        k_t = time_ms(torch, lambda: [kern(*a) for a in kcalls])
        k_plain = time_ms(torch, lambda: [plain(*a) for a in kcalls], runs=3, warmup=1)
        k_bytes, library = breadth_kernel_numbers(torch, dops, kname, kcalls)
        k_lib = time_ms(torch, library) if library else None
        k_bound = k_bytes / HBM_BYTES_PER_S * 1e3
        n5 = len(nums5)
        bound5 = (len(data5) + n5 * 8) / HBM_BYTES_PER_S * 1e3
        routes = sorted({kernel_route(kernels, kname, a, smem_entries) for a in kcalls})
        ch0 = plan5.chunks[0]
        bins = {k: ("trivial" if vp.trivial else "coded") for k, vp in ch0.var_plans.items()}
        print(f"breadth: {case}: {n5} i64, {len(data5)} bytes, ratio {nums5.nbytes / len(data5):.4f}, "
              f"host encode {t_enc5:.1f} s, host plan_container {t_plan5:.3f} s, {len(plan5.chunks)} chunks, "
              f"chunk 0 {ch0.mode_kind}/{ch0.delta.kind} vars {bins}, launches {launches5}, "
              f"max_memory_allocated {peak5} bytes [{card}]", flush=True)
        print(f"breadth: {case}: decode {dec5[0]:.3f} ms median (min {dec5[1]:.3f}, max {dec5[2]:.3f}, "
              f"{RUNS} runs), {n5 * 8 / (dec5[0] * 1e-3) / 1e9:.2f} GB/s of output, byte bound "
              f"{bound5:.4f} ms = {bound5 / dec5[0]:.1%}; K1 + K2 alone {k12[0]:.4f} ms (min {k12[1]:.4f}, "
              f"max {k12[2]:.4f}) [{card}]", flush=True)
        lib_txt = f", torch.take {k_lib[0]:.4f} ms" if k_lib else ""
        print(f"breadth: {case}: {kname} ({', '.join(routes)}) {k_t[0]:.4f} ms for its {len(kcalls)} calls "
              f"(min {k_t[1]:.4f}, max {k_t[2]:.4f}), plain {k_plain[0]:.3f} ms{lib_txt}, bound {k_bound:.4f} ms "
              f"({k_bytes} bytes) [{card}]", flush=True)
        if kname not in breadth_rows:
            breadth_rows[kname] = {"launches": launches5[kname], "max_abs_err": err5, "ms": k_t[0],
                                   "plain_ms": k_plain[0], "bound_ms": k_bound, "bound_by": "bytes",
                                   "library_ms": k_lib[0] if k_lib else None}
        del calls, kcalls, arrays5, plan5, data5, nums5
        torch.cuda.empty_cache()

    def by(bytes_, ops_ms):
        return "bytes" if bytes_ / HBM_BYTES_PER_S * 1e3 >= ops_ms else "operations"

    rows = [
        {"name": "section_gather", "route": "cuda", "source": "pcodec_tpu_torch/csrc/section_gather.cu",
         "replaces": "pcodec_tpu/ops/pallas_decode.py:132", "launches": dec_launches["section_gather"],
         "max_abs_err": k1_err, "ms": k1[0], "plain_ms": k1_plain[0], "bound_ms": k1_bound,
         "bound_by": "bytes", "library_ms": k1_lib[0]},
        {"name": "chain_decode", "route": "cuda", "source": "pcodec_tpu_torch/csrc/chain_decode.cu",
         "replaces": "pcodec_tpu/ops/pallas_decode.py:222", "launches": dec_launches["chain_decode"],
         "max_abs_err": k2_err, "ms": k2[0], "plain_ms": k2_plain[0], "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None},
        {"name": "bin_ans_encode", "route": "cuda", "source": "pcodec_tpu_torch/csrc/bin_ans_encode.cu",
         "replaces": "pcodec_tpu/ops/pallas_encode.py:142", "launches": enc_launches["bin_ans_encode"],
         "max_abs_err": st["err"]["bin_ans_encode"], "ms": k5[0], "plain_ms": k5_plain[0], "bound_ms": k5_bound,
         "bound_by": by(k5_bytes, k5_ops_ms), "library_ms": None},
        {"name": "section_pack", "route": "cuda", "source": "pcodec_tpu_torch/csrc/section_pack.cu",
         "replaces": "pcodec_tpu/ops/pallas_encode.py:268", "launches": enc_launches["section_pack"],
         "max_abs_err": st["err"]["section_pack"], "ms": k6[0], "plain_ms": k6_plain[0], "bound_ms": k6_bound,
         "bound_by": by(k6_bytes, k6_ops_ms), "library_ms": None},
        {"name": "image_stitch", "route": "cuda", "source": "pcodec_tpu_torch/csrc/image_stitch.cu",
         "replaces": "pcodec_tpu/ops/assemble.py:495", "launches": enc_launches["image_stitch"],
         "max_abs_err": st["err"]["image_stitch"], "ms": k7[0], "plain_ms": k7_plain[0], "bound_ms": k7_bound,
         "bound_by": "bytes", "library_ms": k7_lib[0]},
        {"name": "row_sort", "route": "cuda", "source": "pcodec_tpu_torch/csrc/row_sort.cu",
         "replaces": "pcodec_tpu/ops/pallas_sort.py:49", "launches": enc_launches["row_sort"],
         "max_abs_err": k8_err, "ms": k8[0], "plain_ms": k8_plain[0], "bound_ms": k8_bound,
         "bound_by": by(k8_bytes, k8_ops_ms), "library_ms": k8_lib[0]},
        {"name": "lookback_recon", "route": "cuda", "source": "pcodec_tpu_torch/csrc/lookback_recon.cu",
         "replaces": "pcodec_tpu/ops/pallas_decode.py:1242", **breadth_rows["lookback_recon"]},
        {"name": "dict_join", "route": "cuda", "source": "pcodec_tpu_torch/csrc/dict_join.cu",
         "replaces": "pcodec_tpu/ops/pallas_decode.py:1450", **breadth_rows["dict_join"]},
    ]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
