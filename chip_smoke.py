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
                  key width, from one tile to rows past 2^16 keys; K9 equals
                  its plain version and the host histogram() on rows of few
                  values, zeros, runs, the largest u64 and full 64-bit
                  ranges, at nb_log 2, 5, 8 and 12; small inputs: K5, K6 and
                  K7 on the card equal their plain versions bit for bit, the
                  file image (trained on the card through K8 and K9 where
                  device_train_supported covers the configuration, else on
                  the host; for two inputs also encode_container_device's
                  bytes) equals the port's container_compress bytes, and
                  each device-trained chunk meta equals the host
                  chunk_compressor's
  5. main path    64M taxi-like i64 (seed 1234), page_n 1024, 1M-number
                  chunks, order-1 consecutive delta:
                  decode  the container decoded on the card through K1 and
                          K2 by decode_container_tensor, compared with the
                          source; K1 and K2 held against their plain versions
                          at the main path's shapes; timed with CUDA events
                  encode  the same numbers encoded to a file image on the
                          card by encode_container_image_device: training on
                          the card (plan_encode_device: K8 sorts every
                          chunk's delta'd latents, K9 walks their histograms),
                          then K5, K6 and K7; compared byte for byte with the
                          decode phase's container; K5-K9 held against their
                          plain versions at these shapes (K8 and K9 on the
                          calls the encode made); the device part, the
                          training and each step timed with CUDA events
  5c. auto config the same 64M numbers at ChunkConfig() (auto mode, auto
                  delta) with 2M-number chunks, as bench.py encodes them:
                  trained on the card (stage-1 candidate sorts and walks,
                  then each chunk's), the image compared with the port's
                  container_compress bytes, every K8 and K9 call held
                  against its plain version, the chosen deltas printed
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
  6. experiments   the microbenchmarks of pcodec_tpu_torch/experiments, the
                  ports of the Pallas prototypes in experiments/: every
                  kernel first held bit for bit against its plain version
                  at small shapes (E2 also refusing a row of 2^19 keys);
                  then each experiment's own shapes, each kernel compared
                  with its plain version and timed beside it, printed in
                  the experiment's units: E5 proto_realign (256 and 2,048
                  groups, beside K1's main-path time), E1 proto_dma (its
                  five tile and round counts), E3 micro_gather (the XLA
                  variants as plain PyTorch yardsticks, routes take and
                  taa at T 2,048 x TS 1,024 x 192 steps, lane at 6,144
                  steps, each also one row alone), E4a gather_row,
                  E4b proto_round_loop (64, 256 and 1,024 tiles, and 256
                  and 1,024 with emit), E2 bitonic_cluster (its checks,
                  (96, 2^16) beside K8 and torch.sort; at (32, 2^21), which
                  no cluster holds, the refusal, then K8 and torch.sort)
  7. a `kernels` JSON line, then the `ok` JSON line last. A phase-6 row
     holds the numbers of the kernel's last shape: `launches` made at that
     shape, `shape`, `timed_runs` behind `ms`, and `launches_all_shapes`.

Launch counts are set to 0 just before each main-path run, and before
phase 6's runs at the experiments' shapes, and read just after. Any
failure exits non-zero before the `ok` line. Without a CUDA device, or
without the package beside this script, it fails at once.
"""

import contextlib
import json
import math
import re
import sys
import time
from dataclasses import replace

import numpy as np

from pcodec_tpu_torch.experiments.common import RUNS, bound, card_line, check_equal, nbytes, time_ms

N = 64 * 1024 * 1024
SEED = 1234
K2_OPS_PER_NUMBER = 40  # integer operations of K2's inner loop per decoded number
K5_OPS_PER_SYMBOL = 16  # K5's tANS step and offset per coded symbol, besides the search
K5_OPS_PER_STEP = 4  # K5's operations per binary-search step
K6_OPS_PER_SYMBOL = 12  # K6's two deposits per coded symbol
K9_OPS_PER_STEP = 40  # K9's integer operations per walk step (a 64-bit division counted as one)
_MIN64 = -(1 << 63)
# phase 6's rows: kernel -> (source in csrc/, the prototype it replaces)
EXPERIMENT_ROWS = {
    "proto_dma": ("proto_dma", "experiments/proto_dma.py:24"),
    "bitonic_cluster": ("bitonic_cluster", "experiments/pallas_bitonic.py:42"),
    "gather_take": ("micro_gather", "experiments/micro_gather.py:109"),
    "gather_taa": ("micro_gather", "experiments/micro_gather.py:137"),
    "gather_lane": ("micro_gather", "experiments/micro_gather.py:171"),
    "gather_row": ("micro_gather", "experiments/proto_round_loop.py:26"),
    "proto_round_loop": ("proto_round_loop", "experiments/proto_round_loop.py:52"),
    "proto_realign": ("proto_realign", "experiments/proto_realign.py:23"),
}


def make_data() -> np.ndarray:
    """Taxi-like timestamps: sorted, jittery increments, rare jumps."""
    rng = np.random.default_rng(SEED)
    incs = rng.integers(0, 120, N)
    jumps = rng.random(N) < 0.001
    incs = incs + jumps * rng.integers(0, 10**6, N)
    return np.cumsum(incs).astype(np.int64)


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
        ("i64_auto_config", walk.astype(np.int64), pt.ChunkConfig(), 256, 16_384),
        ("i16_auto_config_tail", (walk % 30_000).astype(np.int16)[:33_001], pt.ChunkConfig(), 512, 16_384),
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
def capturing(mod, names=("lookback_recon", "dict_join")):
    """Record the arguments of every call of the named kernel wrappers of
    `mod` (K3 and K4 of a decode, K8 and K9 of device training), so the
    kernels can be held against their plain versions at exactly those
    inputs."""
    calls = {k: [] for k in names}
    saved = {k: getattr(mod, k) for k in calls}

    def recorder(name):
        def call(*args):
            calls[name].append(args)
            return saved[name](*args)
        return call

    for k in calls:
        setattr(mod, k, recorder(k))
    try:
        yield calls
    finally:
        for k, fn in saved.items():
            setattr(mod, k, fn)


def check_breadth_calls(dec, calls) -> float:
    """K3 and K4 against their plain versions on every recorded call."""
    for args in calls["lookback_recon"]:
        check_equal(dec.lookback_recon(*args), dec.lookback_decode_pages_plain(*args))
    for args in calls["dict_join"]:
        check_equal(dec.dict_join(*args), dec.dict_join_plain(*args))
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
            if m and k in {source for source, _ in EXPERIMENT_ROWS.values()}:
                entry = re.search(r"\d([a-z]+(?:_[a-z]+)*_kernel)E", m.group(1)).group(1)
            elif m:
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


def walk_lanes(rng):
    """Rows for K9: few values, zeros, high entropy, runs, the largest u64,
    tiny rows (n 0, 1 and 10), distinct values and full 64-bit ranges."""
    return [rng.integers(0, 10, 5000).astype(np.uint64), np.zeros(3000, np.uint64),
            rng.integers(0, 2**63, 5000).astype(np.uint64), np.repeat(rng.integers(0, 50, 100), 50).astype(np.uint64),
            np.full(1000, 2**64 - 1, np.uint64), rng.integers(0, 3, 777).astype(np.uint64),
            np.arange(4096, dtype=np.uint64), rng.integers(0, 2, 10).astype(np.uint64), np.zeros(0, np.uint64),
            np.array([7], np.uint64), rng.integers(0, 2**64, 3000, dtype=np.uint64)]


def walk_tables(torch, dt, lanes, nb_log, dev):
    """K9's arguments for the rows: the port's sorted extracts at nb_log."""
    m = max(len(x) for x in lanes)
    vals = np.zeros((len(lanes), m), np.uint64)
    live = np.zeros((len(lanes), m), bool)
    for i, x in enumerate(lanes):
        vals[i, : len(x)] = x[::-1]
        live[i, : len(x)] = True
    n = torch.tensor([len(x) for x in lanes], dtype=torch.int64, device=dev)
    ext = dt.sorted_extracts(torch.from_numpy(vals.view(np.int64)).to(dev), torch.from_numpy(live).to(dev), n,
                             torch.full_like(n, nb_log))
    return (*ext, n, nb_log)


def walk_steps(R, n, nb_log: int) -> int:
    """Steps the walks of one K9 call take, from its R table and counts:
    a step either ends the lane or moves it to R of its bin."""
    R, n = R.cpu().numpy(), n.cpu().numpy()
    nb = 1 << nb_log
    steps = 0
    for lane in range(len(n)):
        pos, ln = 0, int(n[lane])
        while pos < ln:
            steps += 1
            j = (pos << nb_log) // ln
            if (((j + 1) * ln + nb - 1) >> nb_log) - pos >= ln - pos:
                break
            pos = int(R[lane, j])
    return steps


def check_train_calls(dt, rs, calls) -> float:
    """K8 and K9 against their plain versions on every recorded call."""
    for (x,) in calls["row_sort"]:
        check_equal(rs.row_sort(x), rs.row_sort_plain(x))
    for args in calls["walk_bins"]:
        for a, b in zip(dt.walk_bins(*args), dt.walk_bins_plain(*args)):
            check_equal(a, b)
    return 0.0


def meta_bytes(cc) -> bytes:
    from pcodec_tpu_torch.format.bitio import BitWriter

    w = BitWriter()
    cc.write_meta(w)
    return w.to_bytes()


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


def check_encode_steps(ce, asm, plan, a):
    """K5, K6 and K7 against their plain versions on one uploaded plan.
    Returns their errors and the intermediate tensors."""
    outs = ce.bin_ans_encode(*k5_args(a))
    err = {"bin_ans_encode": max(check_equal(x, y)
                                 for x, y in zip(outs, ce.bin_ans_encode_plain(*k5_args(a))))}
    p1, offsets, states = outs
    ans_len, off_len, curs, total_bits = ce.section_cursors(p1)
    W = plan.launch.sec_words
    sections = ce.section_pack(p1, offsets, curs, W)
    err["section_pack"] = check_equal(sections, ce.section_pack_plain(p1, offsets, curs, W))
    prep = asm.prepare_image(plan, a, sections, states, ans_len, off_len, total_bits)
    nw = -(-int(prep["sizes"][0]) // 4)
    body = asm.image_stitch(*stitch_args(prep), nw)
    err["image_stitch"] = check_equal(body, asm.image_stitch_plain(*stitch_args(prep), nw))
    return dict(err=err, p1=p1, offsets=offsets, states=states, ans_len=ans_len, off_len=off_len, curs=curs,
                total_bits=total_bits, sections=sections, prep=prep, body_words=nw)


def experiment_checks(torch, dev) -> None:
    """Each microbenchmark kernel against its plain version at small shapes
    (ragged rows, wrapping sums, states outside the table, clusters of 1 to
    8 blocks), and E2's refusal of a row longer than a cluster holds."""
    from pcodec_tpu_torch.experiments import micro_gather as mg
    from pcodec_tpu_torch.experiments import pallas_bitonic as pb
    from pcodec_tpu_torch.experiments import proto_dma as pd
    from pcodec_tpu_torch.experiments import proto_realign as pr
    from pcodec_tpu_torch.experiments import proto_round_loop as prl

    rng = np.random.default_rng(SEED + 5)

    def i32(shape, lo=-(2**31), hi=2**31):
        return torch.from_numpy(rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32)).to(dev)

    raw2d, st = i32((4096, 128)), i32(37 * 8, 0, 4096 // 8 - 2)
    check_equal(pr.realign(st, raw2d), pr.realign_plain(st, raw2d))
    raw, starts = i32(1 << 16), i32((40, 128), 0, (1 << 16) - 3071)
    for heavy in (0, 64):
        check_equal(pd.dma_checksum(starts, raw, heavy), pd.dma_checksum_plain(starts, raw, heavy))
    for rows, ts in ((13, 64), (64, 1024), (3, 1 << 14)):
        table, idx0 = i32((rows, ts)), i32((rows, 4), 0, ts)
        want = mg.gather_steps_plain(table, idx0, 37)
        check_equal(mg.gather_take(table.flatten(), idx0, 37), want)
        check_equal(mg.gather_taa(table, idx0, 37), want)
    tbl, idx = i32((19, 128)), i32((19, 128))
    check_equal(mg.lane_steps(tbl, idx, 300), mg.lane_steps_plain(tbl, idx, 300))
    tbl, idx = i32((5, 77)), i32((5, 77), 0, 77)
    check_equal(mg.row_gather(tbl, idx), mg.row_gather_plain(tbl, idx))
    sec, node, state = i32((3, 256, 128)), i32((8, 1024)), i32((3, 8, 128), 0, 1024)
    state[0, :, :5] = torch.tensor([-7, 1024, 5000, -(2**31), 2**31 - 1], dtype=torch.int32)
    for got, want in zip(prl.round_loop(sec, node, state, 7, True), prl.round_loop_plain(sec, node, state, 7, True)):
        check_equal(got, want)
    for rows, m in ((3, 2), (8, 256), (16, 1024), (5, 1 << 16), (2, 1 << 18)):
        x = i32((rows, m))
        x[:, : m // 3] = x[:, :1]
        check_equal(pb.sort_rows_u32(x), pb.sort_rows_u32_plain(x))
    try:
        pb.sort_rows_u32(torch.zeros((1, 1 << 19), dtype=torch.int32, device=dev))
    except ValueError:
        pass
    else:
        raise AssertionError("E2 took a row of 2^19 keys")


def experiment_runs(dev) -> dict:
    """Each microbenchmark's main(): the experiment's own shapes through its
    kernels, each checked against its plain version, timed and printed in
    the experiment's units. Returns {kernel: its row at its last shape, the
    experiment's largest}."""
    from pcodec_tpu_torch.experiments import micro_gather, pallas_bitonic, proto_dma, proto_realign
    from pcodec_tpu_torch.experiments import proto_round_loop

    mods = (proto_realign, proto_dma, micro_gather, proto_round_loop, pallas_bitonic)
    return {r["name"]: r for mod in mods for r in mod.main(dev)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import pcodec_tpu_torch as pt
    from pcodec_tpu_torch.dtypes import NUMBER_TYPES_BY_NAME
    from pcodec_tpu_torch.ops import assemble as asm
    from pcodec_tpu_torch.ops import container_decode as cd
    from pcodec_tpu_torch.ops import container_encode as ce
    from pcodec_tpu_torch.binning.histogram import histogram
    from pcodec_tpu_torch.codec import compress as cmp
    from pcodec_tpu_torch.codec.chunk_config import PagingSpec
    from pcodec_tpu_torch.codec.container import _exact_split
    from pcodec_tpu_torch.ops import decode as dops
    from pcodec_tpu_torch.ops import device_train as dt
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
            check_equal(stg, cd.section_gather_plain(arrays.words, a["word0"], cp.stage_words))
            args = (stg, a["word0"], a["curs"], a["states0"], a["body_n"], a["table_id"],
                    a["node"], a["lower"], a["moment0"], cp.page_n, cp.fuse)
            check_equal(cd.chain_decode(*args), cd.chain_decode_plain(*args))
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
        check_breadth_calls(dops, calls)
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
            check_equal(rs.row_sort(x), rs.row_sort_plain(x))
    print("encode: K8 row_sort == plain, keys of 32 and 64 bits, rows of 3 to 2^20 keys", flush=True)
    lanes = walk_lanes(rng)
    for nb_log in (2, 5, 8, 12):
        args = walk_tables(torch, dt, lanes, nb_log, dev)
        got = dt.walk_bins(*args)
        for a, b in zip(got, dt.walk_bins_plain(*args)):
            check_equal(a, b)
        co, lo, up = (t.cpu().numpy().view(np.uint64) for t in got[:3])
        for i, x in enumerate(lanes):
            k = int(got[3][i])
            host = [(b.count, b.lower, b.upper) for b in histogram(x.copy(), nb_log)]
            if [(int(a), int(b), int(c)) for a, b, c in zip(co[i, :k], lo[i, :k], up[i, :k])] != host:
                raise AssertionError(f"K9 differs from the host histogram() at nb_log {nb_log}, lane {i}")
    print(f"encode: K9 histogram_walk == plain == host histogram() on {len(lanes)} lanes at nb_log 2, 5, 8, 12",
          flush=True)
    for i, (case, nums, cfg, page_n, chunk_n) in enumerate(encode_cases(pt)):
        ref = pt.container_compress(nums, cfg, page_n=page_n, chunk_n=chunk_n)
        plan = asm.plan_image(nums, cfg, page_n, chunk_n, dev)
        if plan.trained_on == "device":
            start = 0
            for ci, (cn, job) in enumerate(zip(plan.enc.chunk_ns, plan.enc.jobs)):
                chunk_cfg = replace(cfg, paging_spec=PagingSpec.exact_pages(_exact_split(cn, page_n)))
                host_cc = cmp.chunk_compressor(plan.enc.nt, nums[start : start + cn], chunk_cfg)
                if meta_bytes(job.cc) != meta_bytes(host_cc):
                    raise AssertionError(f"{case}: chunk {ci}'s device-trained meta differs from the host's")
                start += cn
        a = asm.upload_image(plan, dev)
        steps = "no chains (trivial var)"
        if plan.launch.n_chains:
            check_encode_steps(ce, asm, plan, a)
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
        metas = ", chunk metas == host chunk_compressor" if plan.trained_on == "device" else ""
        print(f"encode: {case}: trained on the {plan.trained_on}{metas}, {steps}, image == container_compress"
              f"{entry} ({len(plan.enc.jobs)} chunks, {L.n_chains} chains, bins {bins}, "
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
    k1_err = check_equal(stg, cd.section_gather_plain(words, a["word0"], W))
    args = (stg, a["word0"], a["curs"], a["states0"], a["body_n"], a["table_id"], a["node"],
            a["lower"], a["moment0"], cp.page_n, cp.fuse)
    k2_err = check_equal(cd.chain_decode(*args), cd.chain_decode_plain(*args))

    dec = time_ms(lambda: cd.decode_plan(plan, arrays))
    k1 = time_ms(lambda: cd.section_gather(words, a["word0"], W))
    k2 = time_ms(lambda: cd.chain_decode(*args))
    k1_plain = time_ms(lambda: cd.section_gather_plain(words, a["word0"], W), runs=3, warmup=1)
    k2_plain = time_ms(lambda: cd.chain_decode_plain(*args), runs=3, warmup=1)
    # yardstick for K1: one torch.take over a precomputed index (the index is not timed)
    col = torch.arange(W, device=dev)
    idx = a["word0"][:, None] + col[None, :]
    idx = torch.where(col[None, :] < W - cd.SLACK_WORDS, idx.clamp(max=words.numel()), words.numel())
    words_ext = torch.cat([words, words.new_zeros(1)])
    if not torch.equal(torch.take(words_ext, idx), stg):
        raise AssertionError("K1's torch.take yardstick computes another function")
    k1_lib = time_ms(lambda: torch.take(words_ext, idx))

    n_chains = cp.n_chains
    out_bytes = n_chains * cp.page_n * 8
    k1_bytes = n_chains * 8 + n_chains * (W - cd.SLACK_WORDS) * 4 + n_chains * W * 4
    k2_in = stg.numel() * 4 + nbytes(*(a[k] for k in ("word0", "curs", "states0", "body_n",
                                                       "table_id", "node", "lower", "moment0")))
    k2_bytes = k2_in + out_bytes
    k1_bound = bound(k1_bytes)[0]
    k2_bound, k2_by = bound(k2_bytes, int(cp.body_n.sum()) * K2_OPS_PER_NUMBER)
    dec_bound = bound(len(data) + N * 8)[0]
    gbps = N * 8 / (dec[0] * 1e-3) / 1e9
    print(f"main: decode {dec[0]:.3f} ms median (min {dec[1]:.3f}, max {dec[2]:.3f}, {RUNS} runs), "
          f"{gbps:.2f} GB/s of output, byte bound {dec_bound:.4f} ms = {dec_bound / dec[0]:.1%} "
          f"[{card}]", flush=True)
    print(f"main: K1 section_gather {k1[0]:.4f} ms (min {k1[1]:.4f}, max {k1[2]:.4f}), "
          f"plain {k1_plain[0]:.3f} ms, torch.take {k1_lib[0]:.4f} ms, bound {k1_bound:.4f} ms "
          f"[{card}]", flush=True)
    print(f"main: K2 chain_decode {k2[0]:.4f} ms (min {k2[1]:.4f}, max {k2[2]:.4f}), "
          f"plain {k2_plain[0]:.1f} ms, bound {k2_bound:.4f} ms [{card}]", flush=True)
    del arrays, a, words, stg, args, idx, words_ext, col
    torch.cuda.empty_cache()

    # 5. main path: encode to a file image on the card
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    t0 = time.time()
    with capturing(dt, ("row_sort", "walk_bins")) as tcalls:
        image = pt.encode_container_image_device(nums, cfg, page_n=1024, chunk_n=1 << 20, device=dev)
        torch.cuda.synchronize()
    t_img = time.time() - t0
    enc_launches = {k: kernels.LAUNCHES[k] for k in ("row_sort", "histogram_walk", "bin_ans_encode",
                                                     "section_pack", "image_stitch")}
    peak_enc = torch.cuda.max_memory_allocated()
    if asm.file_image_to_bytes(*image) != data:
        raise AssertionError("main path file image differs from container_compress's bytes")
    if any(v == 0 for v in enc_launches.values()):
        raise AssertionError(f"a kernel of the encode path was not launched: {enc_launches}")
    del image
    print(f"main: file image == container_compress bytes ({len(data)}), launches {enc_launches}, "
          f"encode_container_image_device {t_img:.1f} s (training included), "
          f"max_memory_allocated {peak_enc} bytes [{card}]", flush=True)
    train_err = check_train_calls(dt, rs, tcalls)
    (x8,) = tcalls["row_sort"][-1]  # the sort of every chunk's delta'd latents
    k9_args = tcalls["walk_bins"][-1]  # the walk of every chunk's histogram
    del tcalls

    t0 = time.time()
    iplan = asm.plan_image(nums, cfg, 1024, 1 << 20, dev)
    t_iplan = time.time() - t0
    if iplan.trained_on != "device":
        raise AssertionError(f"the main path trained on the {iplan.trained_on}")
    t0 = time.time()
    ia = asm.upload_image(iplan, dev)
    torch.cuda.synchronize()
    t_up = time.time() - t0
    L = iplan.launch
    st = check_encode_steps(ce, asm, iplan, ia)
    prep, nw = st["prep"], st["body_words"]
    print(f"main: plan_image {t_iplan:.3f} s (host clock, training on the card included), upload "
          f"{t_up:.3f} s, {L.n_chains} chains, b_pad {L.lowers.shape[1]}, ts {L.nexts.shape[1]}, "
          f"sec_words {L.sec_words}, page p is chain p: {iplan.identity}; "
          f"K5, K6, K7 == plain at these shapes; K8, K9 == plain on the encode's calls", flush=True)
    train = time_ms(lambda: dt.plan_encode_device(nums, cfg, 1024, 1 << 20, dev), runs=3, warmup=1)
    print(f"main: device training plan_encode_device {train[0]:.1f} ms median (min {train[1]:.1f}, "
          f"max {train[2]:.1f}, 3 runs, CUDA events) [{card}]", flush=True)
    # where the training's time goes: its card phases alone at the main path's inputs
    n_ch = N >> 20
    rowlen = np.full(N // 1024, 1024)
    orders, nreal = [1] * n_ch, [(1 << 20) - 1024] * n_ch
    ubls = [cmp.choose_unoptimized_bins_log(cfg.compression_level, 1 << 20)] * n_ch
    lat_t = time_ms(lambda: dt.phase_latents(nums, iplan.enc.nt, N // 1024, 1024, None, dev), runs=3, warmup=1)
    lat2d, _ = dt.phase_latents(nums, iplan.enc.nt, N // 1024, 1024, None, dev)
    sort_t = time_ms(lambda: dt.phase_delta_sort(lat2d, orders, rowlen, nreal, ubls, 64), runs=3, warmup=1)
    ext = dt.phase_delta_sort(lat2d, orders, rowlen, nreal, ubls, 64)[2]
    walk_t = time_ms(lambda: dt.phase_walk(ext, nreal, ubls), runs=3, warmup=1)
    launch_t = time_ms(lambda: ce.build_encode_launch(iplan.enc), runs=3, warmup=1)
    rest = train[0] - lat_t[0] - sort_t[0] - walk_t[0]
    print(f"main: training parts: phase_latents (upload, bijection) {lat_t[0]:.1f} ms, phase_delta_sort "
          f"(delta, K8, extracts) {sort_t[0]:.1f} ms, phase_walk (K9, read back) {walk_t[0]:.2f} ms, the rest "
          f"(host screening and chunk build) {rest:.1f} ms; build_encode_launch (latents sliced on the card) "
          f"{launch_t[0]:.1f} ms [{card}]", flush=True)
    del lat2d, ext

    # K8 and K9 at the main path's shapes: the calls the encode made
    x8b = x8 ^ _MIN64  # unsigned order as int64 order, for torch.sort (not timed)
    k8 = time_ms(lambda: rs.row_sort(x8))
    k8_plain = time_ms(lambda: rs.row_sort_plain(x8))
    k8_lib = time_ms(lambda: torch.sort(x8b, dim=1))
    rows8, m8 = x8.shape
    print(f"main: K8 row_sort {k8[0]:.4f} ms (min {k8[1]:.4f}, max {k8[2]:.4f}) for {rows8} rows of {m8} "
          f"latents, plain {k8_plain[0]:.4f} ms, torch.sort {k8_lib[0]:.4f} ms [{card}]", flush=True)
    k9 = time_ms(lambda: dt.walk_bins(*k9_args))
    k9_plain = time_ms(lambda: dt.walk_bins_plain(*k9_args), runs=3, warmup=1)
    k9_one = tuple(x[:1].contiguous() if torch.is_tensor(x) else x for x in k9_args)
    k9_lane = time_ms(lambda: dt.walk_bins(*k9_one))
    lanes9, nb9 = k9_args[0].shape
    steps9 = walk_steps(k9_args[2], k9_args[6], k9_args[7])
    print(f"main: K9 histogram_walk {k9[0]:.4f} ms (min {k9[1]:.4f}, max {k9[2]:.4f}) for {lanes9} lanes of "
          f"{nb9} bins ({steps9} steps), one lane alone {k9_lane[0]:.4f} ms, plain {k9_plain[0]:.2f} ms "
          f"[{card}]", flush=True)

    enc = time_ms(lambda: asm.run_image(iplan, ia))
    k5 = time_ms(lambda: ce.bin_ans_encode(*k5_args(ia)))
    glue = time_ms(lambda: ce.section_cursors(st["p1"]))
    k6 = time_ms(lambda: ce.section_pack(st["p1"], st["offsets"], st["curs"], L.sec_words))
    prep_t = time_ms(lambda: asm.prepare_image(iplan, ia, st["sections"], st["states"],
                                                      st["ans_len"], st["off_len"], st["total_bits"]))
    k7 = time_ms(lambda: asm.image_stitch(*stitch_args(prep), nw))
    k5_plain = time_ms(lambda: ce.bin_ans_encode_plain(*k5_args(ia)), runs=3, warmup=1)
    k6_plain = time_ms(lambda: ce.section_pack_plain(st["p1"], st["offsets"], st["curs"],
                                                            L.sec_words), runs=3, warmup=1)
    k7_plain = time_ms(lambda: asm.image_stitch_plain(*stitch_args(prep), nw), runs=3, warmup=1)
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
    k7_lib = time_ms(k7_library)

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
    k5_bound, k5_by = bound(k5_bytes, syms * (K5_OPS_PER_SYMBOL + K5_OPS_PER_STEP * int(math.log2(b_pad))))
    payload_words = int(((st["total_bits"] + 31) >> 5).sum())
    k6_bytes = syms * (4 + off_b) + nbytes(st["curs"]) + payload_words * 4
    k6_bound, k6_by = bound(k6_bytes, syms * K6_OPS_PER_SYMBOL)
    row_words = int(prep["lenA"].sum()) + int(prep["lenC"].sum())
    k7_bytes = row_words * 4 + nbytes(prep["F0A"], prep["lenA"], prep["F0C"], prep["lenC"]) + nw * 4
    k7_bound = bound(k7_bytes)[0]
    k8_bytes = 2 * rows8 * m8 * 8  # each u64 latent read once and written once
    k8_bound, k8_by = bound(k8_bytes, rows8 * m8 * math.log2(m8))  # m log2 m compares a row
    # K9: the five tables and s0, n read once, the three bin tables and
    # n_bins written once; K9_OPS_PER_STEP integer operations a walk step
    k9_bytes = nbytes(*k9_args[:7]) + 3 * lanes9 * nb9 * 8 + lanes9 * 8
    k9_bound, k9_by = bound(k9_bytes, steps9 * K9_OPS_PER_STEP)
    enc_bound = bound(N * 8 + len(data))[0]
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
    print(f"main: K8 bound {k8_bound:.4f} ms, K9 bound {k9_bound:.6f} ms; bytes counted: K5 {k5_bytes}, "
          f"K6 {k6_bytes} ({payload_words} payload words, offsets at {off_b} bytes), K8 {k8_bytes}, "
          f"K9 {k9_bytes} [{card}]", flush=True)

    del ia, prep, flat_idx, flat_val, body64, x8, x8b, k9_args, k9_one
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
        err5 = check_breadth_calls(dops, calls)
        arrays5 = cd.upload_plan(plan5, dev)
        dec5 = time_ms(lambda: cd.decode_plan(plan5, arrays5))
        k12 = time_ms(lambda: [cd.run_launch(cp, arrays5.words, arrays5.launches[lk])
                                      for lk, cp in plan5.launches.items()])
        kern = getattr(dops, kname)
        plain = dops.lookback_decode_pages_plain if kname == "lookback_recon" else dops.dict_join_plain
        k_t = time_ms(lambda: [kern(*a) for a in kcalls])
        k_plain = time_ms(lambda: [plain(*a) for a in kcalls], runs=3, warmup=1)
        k_bytes, library = breadth_kernel_numbers(torch, dops, kname, kcalls)
        k_lib = time_ms(library) if library else None
        k_bound = bound(k_bytes)[0]
        n5 = len(nums5)
        bound5 = bound(len(data5) + n5 * 8)[0]
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

    # 5c. the same numbers at ChunkConfig(), 2M-number chunks
    auto_cfg = pt.ChunkConfig()
    t0 = time.time()
    data_c = pt.container_compress(nums, auto_cfg, page_n=1024, chunk_n=2 << 20)
    t_enc_c = time.time() - t0
    torch.cuda.synchronize()
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    t0 = time.time()
    with capturing(dt, ("row_sort", "walk_bins")) as ccalls:
        image_c = pt.encode_container_image_device(nums, auto_cfg, page_n=1024, chunk_n=2 << 20, device=dev)
        torch.cuda.synchronize()
    t_img_c = time.time() - t0
    launches_c = {k: kernels.LAUNCHES[k] for k in ("row_sort", "histogram_walk", "bin_ans_encode",
                                                   "section_pack", "image_stitch")}
    if asm.file_image_to_bytes(*image_c) != data_c:
        raise AssertionError("the ChunkConfig() file image differs from container_compress's bytes")
    if any(v == 0 for v in launches_c.values()):
        raise AssertionError(f"a kernel of the ChunkConfig() encode was not launched: {launches_c}")
    del image_c
    check_train_calls(dt, rs, ccalls)
    sorts_c = [tuple(x.shape) for (x,) in ccalls["row_sort"]]
    walks_c = [tuple(a[0].shape) for a in ccalls["walk_bins"]]
    k9_c = [time_ms(lambda a=a: dt.walk_bins(*a))[0] for a in ccalls["walk_bins"]]
    del ccalls
    t0 = time.time()
    plan_c = asm.plan_image(nums, auto_cfg, 1024, 2 << 20, dev)
    t_plan_c = time.time() - t0
    if plan_c.trained_on != "device":
        raise AssertionError(f"the ChunkConfig() encode trained on the {plan_c.trained_on}")
    deltas_c = {}
    for job in plan_c.enc.jobs:
        de = job.cc.meta.delta_encoding
        key = f"{job.cc.meta.mode.kind}/{de.kind}" + (f" {de.order}" if de.order else "")
        deltas_c[key] = deltas_c.get(key, 0) + 1
    print(f"auto: {N} taxi-like i64 at ChunkConfig(), 2M-number chunks: {len(data_c)} bytes, host encode "
          f"{t_enc_c:.1f} s; image == container_compress bytes; launches {launches_c}; chunks {deltas_c}; "
          f"encode_container_image_device {t_img_c:.1f} s, plan_image {t_plan_c:.3f} s (host clock, "
          f"training included) [{card}]", flush=True)
    print(f"auto: K8 calls {sorts_c}, K9 calls {walks_c} == plain; K9 "
          f"{', '.join(f'{t:.4f}' for t in k9_c)} ms [{card}]", flush=True)
    del plan_c, data_c
    torch.cuda.empty_cache()

    # 6. experiments: the microbenchmarks of pcodec_tpu_torch/experiments
    t_exp = time.time()
    experiment_checks(torch, dev)
    print(f"experiments: every kernel == plain at small shapes, E2 refuses a row of 2^19 keys [{card}]", flush=True)
    torch.cuda.synchronize()
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    exp = experiment_runs(dev)
    torch.cuda.synchronize()
    exp_launches = {k: kernels.LAUNCHES[k] for k in EXPERIMENT_ROWS}
    if any(v == 0 for v in exp_launches.values()):
        raise AssertionError(f"a kernel of the experiments was not launched: {exp_launches}")
    print(f"experiments: E5 proto_realign at 2048 groups {exp['proto_realign']['ms'][0]:.4f} ms beside K1 "
          f"section_gather at the main path {k1[0]:.4f} ms; launches {exp_launches}; phase {time.time() - t_exp:.1f} s "
          f"[{card}]", flush=True)

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
         "bound_by": k5_by, "library_ms": None},
        {"name": "section_pack", "route": "cuda", "source": "pcodec_tpu_torch/csrc/section_pack.cu",
         "replaces": "pcodec_tpu/ops/pallas_encode.py:268", "launches": enc_launches["section_pack"],
         "max_abs_err": st["err"]["section_pack"], "ms": k6[0], "plain_ms": k6_plain[0], "bound_ms": k6_bound,
         "bound_by": k6_by, "library_ms": None},
        {"name": "image_stitch", "route": "cuda", "source": "pcodec_tpu_torch/csrc/image_stitch.cu",
         "replaces": "pcodec_tpu/ops/assemble.py:495", "launches": enc_launches["image_stitch"],
         "max_abs_err": st["err"]["image_stitch"], "ms": k7[0], "plain_ms": k7_plain[0], "bound_ms": k7_bound,
         "bound_by": "bytes", "library_ms": k7_lib[0]},
        {"name": "row_sort", "route": "cuda", "source": "pcodec_tpu_torch/csrc/row_sort.cu",
         "replaces": "pcodec_tpu/ops/pallas_sort.py:49", "launches": enc_launches["row_sort"],
         "max_abs_err": train_err, "ms": k8[0], "plain_ms": k8_plain[0], "bound_ms": k8_bound,
         "bound_by": k8_by, "library_ms": k8_lib[0]},
        {"name": "histogram_walk", "route": "cuda", "source": "pcodec_tpu_torch/csrc/histogram_walk.cu",
         "replaces": "pcodec_tpu/ops/pallas_walk.py:40", "launches": enc_launches["histogram_walk"],
         "max_abs_err": train_err, "ms": k9[0], "plain_ms": k9_plain[0], "bound_ms": k9_bound,
         "bound_by": k9_by, "library_ms": None},
        {"name": "lookback_recon", "route": "cuda", "source": "pcodec_tpu_torch/csrc/lookback_recon.cu",
         "replaces": "pcodec_tpu/ops/pallas_decode.py:1242", **breadth_rows["lookback_recon"]},
        {"name": "dict_join", "route": "cuda", "source": "pcodec_tpu_torch/csrc/dict_join.cu",
         "replaces": "pcodec_tpu/ops/pallas_decode.py:1450", **breadth_rows["dict_join"]},
    ]
    # phase 6's rows: the numbers of each kernel's last shape; launches at
    # that shape (its check, warm-ups and timed runs), beside the phase's
    # launches over all of the experiment's shapes
    for name, (source, replaces) in EXPERIMENT_ROWS.items():
        r = exp[name]
        rows.append({"name": name, "route": "cuda", "source": f"pcodec_tpu_torch/csrc/{source}.cu",
                     "replaces": replaces, "launches": r["launches"], "max_abs_err": r["max_abs_err"],
                     "ms": r["ms"][0], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r["library_ms"], "shape": r["shape"],
                     "timed_runs": r["timed_runs"], "launches_all_shapes": exp_launches[name]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
