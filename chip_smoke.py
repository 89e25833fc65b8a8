#!/usr/bin/env python3
"""Build the port's CUDA kernels and drive its main path on one NVIDIA GPU.

    python3 chip_smoke.py          (from the root of the repository)
    python3 chip_smoke.py --lookback-decode
                                   only the 32M lookback decode of phase 5b:
                                   a call's and the card's time and the CUDA
                                   kernels and copies torch.profiler counts in
                                   one decode (through the package beside
                                   the script, so a copy of the script in
                                   another tree measures that tree)
    python3 chip_smoke.py --sharded
                                   only phase 11, over 4 shards of the first
                                   card and then over every visible card
                                   (on a machine of several cards)
    python3 chip_smoke.py --train  only the device training of the main
                                   path's 64M numbers and of phase 8's
                                   IntMult 32M and lookback 32M inputs,
                                   timed the same way (a copy in another
                                   tree times that tree)

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
                  bit, K3 in shared memory (one call a decode, every lookback
                  var of the container) and in global memory (a call a
                  chunk), K4 (one call a decode, every Dict chunk of the
                  container) with its table in shared and in global memory;
                  the FloatMult joins on the
                  card equal the CPU's on NaN, inf and subnormal multipliers
                  and bases for f16, f32 and f64, and where the card's
                  native f16/f32 multiply differs from the CPU's is printed
                  (the reason the join multiplies in the softfloat)
  4. encode kernels
                  K8 on the card equals its plain version on rows of either
                  key width, spans of 0, 2^32 - 1 and 2^32 and keys at the
                  largest u64, rows of 1 to 2^20 + 3 keys; K9 equals
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
                          at the main path's shapes; timed with CUDA events,
                          K2 also on the card alone, beside the inputs of
                          its accounting (ts, staging words, coded bits)
                  encode  the same numbers encoded to a file image on the
                          card by encode_container_image_device: training on
                          the card (plan_encode_device: K8 sorts every
                          chunk's delta'd latents, K9 walks their histograms),
                          then K5, K6 and K7 (the image prep inside); compared
                          byte for byte with the decode phase's container,
                          its peak memory printed; K5-K9 held against their
                          plain versions at these shapes (K8 and K9 on the
                          calls the encode made); K5, K6, K7 and K9 also timed
                          on the card alone, beside ts, b_pad and the ANS and
                          offset bits a number, K6 at each block size of its
                          sweep, the plain section_cursors (the glue K6 took
                          in) timed beside it, K7's two passes apart, its
                          placement at each run of pages a warp of its sweep
                          and its kernels' device time, the plain prepare_image (the
                          prep K7 took in) and an index_add_ of its rows (the
                          placement alone) timed once beside it, K9's longest
                          lane alone and its time a step; the device part
                          (with torch.profiler's count of the CUDA kernels one
                          run_image runs), the training and each step timed
                          with CUDA events, K8 three ways: as called, its sort
                          launch alone on prepared keys, and torch.sort, and
                          one call's device time split over its kernels
  5c. auto config the same 64M numbers at ChunkConfig() (auto mode, auto
                  delta) with 2M-number chunks, as bench.py encodes them:
                  trained on the card (stage-1 candidate sorts and walks,
                  then each chunk's), the image compared with the port's
                  container_compress bytes, every K8 and K9 call and K5,
                  K6 and K7 on the encode's launch held against their plain
                  versions, each K8 call timed three ways as in phase 5,
                  the chosen deltas printed
  5b. breadth at full size
                  the PCT inputs of bench_matrix.py's make_configs (seed
                  1234, regenerated here): wrapped_lookback_multipage (32M
                  i64, lookback; K1, K2, K3), dict_i64_100k (16M i64,
                  100,000 entries, uniform indices; K1, K2, K4 with the
                  table in global memory) and dict_i64 (32M i64, 4 values;
                  K1, K2, K4 with the table in shared memory), each encoded by the
                  host container_compress, decoded on the card by
                  decode_container_tensor, compared with the source and
                  timed; K1 and K2 on every launch and K3 and K4 on every
                  call the decode made held against their plain versions,
                  K3 and K4 timed a call and on the card alone; K3 and K4
                  each make one launch a decode (K3's blocks swept over
                  128 to 1,024 threads, its time split into loads, rounds
                  and stores, and torch.profiler's count of the CUDA
                  kernels one lookback decode launches printed); K4 is
                  timed beside one
                  torch.take over the container's concatenated table (its
                  library_ms) and beside a torch.take a chunk. Two more
                  Dict containers (16M i64, seed 1235) put K4 where its
                  tables' sizes matter: 1,500 values (a concatenated table
                  of about 24,000 entries in shared memory) and 10,000
                  (each chunk's table fits shared memory, their sum does
                  not). K4's shared-memory route is timed with each of its
                  grids (blocks walking tiles, a block a tile) on every
                  such decode and on one chunk of 16M indices against
                  tables of 128 entries to the shared-memory limit; K3 and
                  K9 are timed a call with the raw stream handle the
                  binding passes and with torch's Stream-object accessor
  6. experiments   the microbenchmarks of pcodec_tpu_torch/experiments, the
                  ports of the Pallas prototypes in experiments/: every
                  kernel first held bit for bit against its plain version
                  at small shapes (E2 also at (2, 2^19) and (1, 2^21),
                  rows longer than one cluster holds; E1 on a ragged raw
                  at 1,200 tiles and 512 rounds; route take also at 0
                  steps and on rows of 2^16 entries; route lane at 0, 1,
                  300 and 6,144 steps);
                  then each experiment's own shapes, each kernel compared
                  with its plain version and timed beside it, printed in
                  the experiment's units: E5 proto_realign (256 and 2,048
                  groups, beside K1's main-path time), E1 proto_dma (its
                  five tile and round counts, its column-sum and tile
                  kernels' device times a call from the profiler's trace
                  and the bytes each reads), E3 micro_gather (the XLA
                  variants as plain PyTorch yardsticks, routes take and
                  taa at T 2,048 x TS 1,024 x 192 steps, lane at 6,144
                  steps by pointer doubling, each also one row alone;
                  take also its rows a block and the route that ran),
                  E4a gather_row, E4b proto_round_loop (64, 256 and 1,024
                  tiles, and 256 and 1,024 with emit), E2 bitonic_cluster
                  (its checks, then (96, 2^16) and (32, 2^21), each beside
                  K8 and torch.sort)
  7. standalone   small standalone `.pco` files, one a mode x delta kind
                  (Classic with NOOP, fused and order-3 consecutive,
                  lookback and conv1 deltas; Dict, IntMult, FloatMult f64,
                  FloatQuant f16): decode_standalone_device on the card
                  equals its CPU route and the source, K1, K2 and every K3
                  and K4 call equal their plain versions; then
                  bench_matrix.py's seven standalone inputs (its seed-1234
                  draws replayed): taxi_i64_delta1 (48M), f64_auto_multichunk
                  (32M) and conv1_i32_lpc (8M, order 6) at full size, the
                  first 8M numbers of intmult_i64_timestamps, floatmult_f32,
                  floatquant_f16 and taxi_i64_realistic_ratio; each encoded
                  by the port's simple_compress, planned by
                  plan_standalone (host seconds), decoded by
                  decode_standalone_device with the counts set to 0 just
                  before and read just after, compared bit for bit with the
                  source, K1, K2, K3 and K4 held against their plain
                  versions, and timed: the decode, K1 + K2, K3, K4 and the
                  post (conv1's post the loop over positions)
  8. multi-var    small IntMult, FloatMult f32, FloatQuant f32 and lookback
                  inputs (page_n 256, 8,192-number chunks; lookback also with a
                  ragged last page, on u16, u32 and f32 latents, with pinned
                  IntMult (three vars) and with Dict, and at page_n 65,536,
                  past B5's shared-memory route, its time printed): trained on
                  the card, every B5 call equal to its plain version (on CPU
                  copies); B5 on two pages of 2^20 of the lookback numbers
                  (64-bit slots in device memory) equal to the native
                  chooser and the plain store, and timed; K5,
                  K6 with its joint-cursor rows and K7 with its multi-var
                  rows equal their plain versions, the image equals
                  container_compress; then intmult_i64_timestamps (32M) and
                  f64_auto_multichunk (32M, in its standalone file's
                  262,144-number chunks, which mix Classic, FloatMult and
                  FloatQuant) at full size, prefixes of floatmult_f32,
                  floatquant_f16 (4M each), and phase 5b's
                  wrapped_lookback_multipage (32M, TRY_LOOKBACK), dict_i64
                  (32M) and dict_i64_100k (16M) with their container_compress
                  bytes, and the auto route: the lookback numbers' first 4M
                  under ChunkConfig(), whose auto delta picks lookback: each
                  planned by plan_image with the counts set to 0 just before
                  and read just after, trained on the card (K8, K9 and, for
                  the lookback inputs, B5; no input trains on the host),
                  its image (counts set to 0 just before run_image, read
                  just after) equal to the port's container_compress at
                  page_n 1024 and 1M-number chunks byte for byte, the
                  metas of chunk 0 and of the first chunk of each other
                  mode (else the last) equal to the host
                  chunk_compressor's, every
                  K8 and K9 call of its training held against the plain
                  versions and the last sort (the secondary rows; the
                  lookback rows, and the lookback primary's rows before
                  them; Dict's u32 index rows) and its walks timed beside
                  the plain versions and torch.sort; B5's pages of the first
                  two chunks held against the plain version, the call timed
                  (a call, the card alone, the two chunks beside the plain
                  version, one page alone) beside its bound; plan_image's
                  seconds with the device training's part, the peak memory
                  of training and image, the encode device part, K5, K6 (a
                  call and alone) and K7 timed, K6's and K7's bounds from
                  the run's rows; K6 at the main path printed again
  9. entry points `python -m pcodec_tpu_torch compress --format pct` and
                  `decompress` in subprocesses on the card, on the main
                  path's numbers saved as .npy in a temporary directory
                  (the file equals the main path's container, the decode the
                  numbers), and pcodec_tpu_torch.entry.entry()'s decode on
                  the card (its checksum equals numpy's)
  10. resident    the main path's 64M numbers (order-1 delta, 1M-number
                  chunks; then ChunkConfig() at 2M) and phase 8's
                  intmult_i64_timestamps, f64_auto_multichunk, dict_i64 and
                  wrapped_lookback_multipage as CUDA tensors, each planned
                  by plan_image without and with its host copy (nums_host)
                  and by the numpy route: each image equal to the numpy
                  route's bytes, trained on the card; each route's
                  plan_image seconds with its training part, the numbers it
                  copied to the host and the host-to-card and card-to-host
                  bytes of one plan_image (the memcpy events of an exported
                  torch.profiler trace; the main path's tensor route must
                  move under 10% of the numbers either way and copy none);
                  the 64M IntMult screening on the card and its GCD loop
                  timed; the 64M image decoded by decode_container_tensor
                  and compared with the source tensor on the card
  11. sharded     parallel/sharding.py over 4 shards of the card: every
                  per-shard K1, K2, K5 and K6 call held against its plain
                  version on small containers (a row a chain, and IntMult's
                  joint rows); the main path's container decoded sharded
                  (equal to the single-device decode) and its image encoded
                  sharded (equal to the container's bytes), the counts set
                  to 0 just before each and read just after, each shard's
                  uploaded words beside the container's, the sharded and
                  single-device ms and the peak memory;
                  dryrun_multichip(4, devices=[cuda] * 4); where there are
                  two or more cards, the same over the cards (else "1 card:
                  shards share it")
  12. bench/capi  `python -m pcodec_tpu_torch bench` in subprocesses on the
                  card: the main path's 64M numbers saved as .npy with its
                  delta (pct, the median of 3 calls; pco_tpu, one call after
                  pct's, its host compress ~17 s a call), pct's size equal
                  to the main path's container; the synthetic 2^20 numbers
                  with pco_tpu, pct, zlib, lzma, bz2 and qco on the card and
                  with --host, every size equal; each row's ratio and GB/s.
                  The C ABI: Python.h found, the shim (native/cpcodec.cpp)
                  and test_cpcodec.c built and run (ALL C ABI TESTS PASSED),
                  a C ABI decode in this process equal to its numbers with
                  the counts set to 0 just before it and K1 and K2 launched;
                  `make syntax-check` of java/; then the run's wall time
  13. a `kernels` JSON line, then the `ok` JSON line last. A phase-6 row
     holds the numbers of the kernel's last shape: `launches` made at that
     shape, `shape`, `timed_runs` behind `ms`, and `launches_all_shapes`
     (both without the calls that the profiler traced).
     The rows of K2, K3, K5, K6, K7 and K9 add `device_ms` (the card alone)
     and the label `"status": "redesigned"`, K6's and K7's a `multivar`
     object (phase 8's IntMult 32M: numbers, times, bound), K9's also its
     longest lane's steps and time alone, K8's and K9's a `train_modes`
     object (phase 8's shapes of each device-trained input: launches,
     times, K8's bound); B5's row (lookback_choose, phase 8's 32M lookback
     training: launches, a call, `device_ms`) adds its pages, the plain
     version's pages (the first two chunks) and the kernel's time on them,
     one page's time alone and its steps, the device time of its hash-read
     kernels and of its chain kernels a call (`hash_reads_ms`, `chain_ms`,
     from the profiler's trace; null where it holds none) and the pages its
     chain holds on an SM; a phase-6 row adds its `device_ms`, for E4a
     `library_device_ms` (torch.gather on the card alone), for E1 its two
     kernels' device ms (`colsum_ms`, `tile_ms`, from the profiler) and its
     column-sum route (`colsum_route`), for E3 one row's `one_row_ms`, for E3a its `rows_per_block` and
     `take_route`. K1's, K2's, K5's and K6's rows add a `sharded` object
     (phase 11: the launches of the sharded main-path run, the shards, the
     sharded and single-device ms).

Launch counts are set to 0 just before each main-path run, each of phase
7's and 8's full-size runs, phase 11's sharded runs, phase 12's C ABI
decode and phase 6's runs at the experiments' shapes,
and read just after. Any
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

from pcodec_tpu_torch.experiments.common import (RUNS, bound, card_line, check_equal, kernel_split_ms, nbytes,
                                                 time_ms, traced_kernels)

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
def capturing(mod, names=("lookback_recon", "lookback_recon_chunks", "dict_join_chunks")):
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


def check_launches(cd, plan, arrays) -> None:
    """K1 and K2 against their plain versions on every launch of an
    uploaded plan."""
    for lkey, cp in plan.launches.items():
        a = arrays.launches[lkey]
        stg = cd.section_gather(arrays.words, a["word0"], cp.stage_words)
        check_equal(stg, cd.section_gather_plain(arrays.words, a["word0"], cp.stage_words))
        args = (stg, a["word0"], a["curs"], a["states0"], a["body_n"], a["table_id"],
                a["node"], a["lower"], a["moment0"], cp.page_n, cp.fuse)
        check_equal(cd.chain_decode(*args), cd.chain_decode_plain(*args))


def check_breadth_calls(dec, calls) -> float:
    """K3 and K4 against their plain versions on every recorded call (K3's
    container call and K4 into copies of the outputs the decode gave
    them)."""
    for args in calls["lookback_recon"]:
        check_equal(dec.lookback_recon(*args), dec.lookback_decode_pages_plain(*args))
    for bases, desc, desc_dev in calls["lookback_recon_chunks"]:
        written = set(desc[:, dec.LB_COLS.index("out_base")].tolist())
        got = [b.clone() if i in written else b for i, b in enumerate(bases)]
        want = [b.clone() if i in written else b for i, b in enumerate(bases)]
        dec.lookback_recon_chunks(got, desc, desc_dev)
        dec.lookback_recon_chunks_plain(want, desc)
        for i in written:
            check_equal(got[i], want[i])
    for bases, desc, table, out in calls["dict_join_chunks"]:
        check_equal(dec.dict_join_chunks(bases, desc, table, out.clone()),
                    dec.dict_join_chunks_plain(bases, desc, table, out.clone()))
    return 0.0


def kernel_route(kernels, name, args, smem_entries) -> str:
    """Which route of K3 or K4 a recorded call took."""
    if name == "lookback_recon_chunks":
        return "K3 shared memory"
    if name == "lookback_recon":
        return "K3 shared memory" if args[0].shape[1] <= kernels.LB_SMEM_MAX_N else "K3 global memory"
    return "K4 table in shared memory" if args[2].shape[0] <= smem_entries else "K4 table in global memory"


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
    return [("wrapped_lookback_multipage", lookback, lb_cfg, "lookback_recon_chunks"),
            ("dict_i64_100k", dict100k, dict_cfg, "dict_join_chunks"),
            ("dict_i64", dict4, dict_cfg, "dict_join_chunks")]


def standalone_inputs(pt):
    """bench_matrix.py's make_configs standalone inputs and its lookback
    input, its seed-1234 draws replayed in order (the Dict inputs' draws
    made and dropped): {name: (numbers, config)} at the benchmark's full
    sizes."""
    rng = np.random.default_rng(1234)
    n, n2, n3, n4 = 48 << 20, 32 << 20, 8 << 20, 16 << 20
    incs, jumps = rng.integers(0, 120, n), rng.random(n) < 0.001
    out = {"taxi_i64_delta1": np.cumsum(incs + jumps * rng.integers(0, 10**6, n)).astype(np.int64)}
    del incs, jumps
    out["f64_auto_multichunk"] = np.cumsum(rng.standard_normal(n2)) + 0.001 * np.arange(n2, dtype=np.float64)
    out["intmult_i64_timestamps"] = (np.cumsum(rng.integers(1, 30, n2)) * 1_000_000_000
                                     + rng.integers(0, 4, n2)).astype(np.int64)
    out["floatmult_f32"] = (rng.integers(-5000, 5000, n) * np.float32(0.01)).astype(np.float32)
    out["floatquant_f16"] = (np.round(rng.standard_normal(n) * 16) / 16).astype(np.float16)
    pattern = rng.integers(0, 10**6, 512).astype(np.int64)
    out["wrapped_lookback_multipage"] = np.tile(pattern, n2 // 512) + rng.integers(0, 2, n2)
    rng.integers(0, 4, n2)  # dict_i64
    rng.integers(-(10**12), 10**12, 100_000), rng.integers(0, 100_000, n4)  # dict_i64_100k
    t3 = np.arange(n3, dtype=np.float64)
    sig = (1 << 20) * np.sin(0.01 * t3) + (1 << 18) * np.sin(0.003 * t3 + 1.0) + rng.integers(-64, 64, n3)
    out["conv1_i32_lpc"] = sig.astype(np.int32)
    incs_r, jumps_r = rng.integers(0, 600, n2), rng.random(n2) < 0.001
    out["taxi_i64_realistic_ratio"] = np.cumsum(incs_r + jumps_r * rng.integers(0, 10**6, n2)).astype(np.int64)
    cfgs = {"conv1_i32_lpc": pt.ChunkConfig(delta_spec=pt.DeltaSpec(pt.DeltaSpec.TRY_CONV1, 6)),
            "wrapped_lookback_multipage": pt.ChunkConfig(delta_spec=pt.DeltaSpec(pt.DeltaSpec.TRY_LOOKBACK))}
    return {k: (v, cfgs.get(k)) for k, v in out.items()}


# phase 7's inputs, in bench_matrix.py's order
STANDALONE = ("taxi_i64_delta1", "f64_auto_multichunk", "intmult_i64_timestamps", "floatmult_f32", "floatquant_f16",
              "conv1_i32_lpc", "taxi_i64_realistic_ratio")


# phase 7: the standalone inputs decoded at full size; the others cut to
# their first STANDALONE_CUT numbers (host encode time)
STANDALONE_FULL = ("taxi_i64_delta1", "f64_auto_multichunk", "conv1_i32_lpc")
STANDALONE_CUT = 8 << 20
# phase 8: the multi-var image inputs and their numbers (full size but the
# FloatMult and FloatQuant prefixes, cut for the host reference's time; the
# auto route's 4M prefix of the lookback numbers, whose auto delta picks
# lookback, under ChunkConfig())
MULTI_INPUTS = (("intmult_i64_timestamps", 32 << 20), ("f64_auto_multichunk", 32 << 20),
                ("floatmult_f32", 4 << 20), ("floatquant_f16", 4 << 20), ("wrapped_lookback_multipage", 32 << 20),
                ("wrapped_lookback_auto", 4 << 20), ("dict_i64", 32 << 20), ("dict_i64_100k", 16 << 20))
# phase 8's chunk size, 1M numbers but for f64_auto_multichunk, whose
# standalone file's 262,144-number chunks mix Classic, FloatMult and
# FloatQuant (1M-number chunks are all Classic)
MULTI_CHUNK_N = {"f64_auto_multichunk": 1 << 18}
# phase 8's inputs of phase 5b: its numbers and container_compress bytes
# (page_n 1024, 1M-number chunks, as phase 8 encodes)
MULTI_KEPT = ("wrapped_lookback_multipage", "dict_i64", "dict_i64_100k")
# B5's operations a number, counted from csrc/lookback_choose.cu: ~16 in
# each of the 16 proposals' scores, ~15 in each of the 6 hash queries
B5_OPS_PER_NUMBER = 16 * 16 + 6 * 15
# B5's card-alone ms on phase 8's 32,768 pages of 1,024 in its earlier
# design, its hash maps on the chain, as PERF.md's kernel table records it
# (NVIDIA H100 80GB HBM3, 700.00 W): printed beside this run's time, never
# in the kernels line
B5_EARLIER_DEVICE_MS = 15.050


def standalone_small_cases(pt):
    """(name, numbers, config) of small standalone files, one a mode x delta
    kind, held against the CPU route of the decode."""
    rng = np.random.default_rng(SEED + 7)
    walk = np.cumsum(rng.integers(0, 120, 9000)).astype(np.int64)
    t = np.arange(9000, dtype=np.float64)
    cfg = lambda kind, order=0: pt.ChunkConfig(delta_spec=pt.DeltaSpec(kind, order))
    return [
        ("classic_noop_u32", rng.integers(0, 5000, 9000).astype(np.uint32), None),
        ("classic_consecutive_fused_i64", walk, cfg("try_consecutive", 1)),
        ("classic_consecutive_order3_i32", (np.cumsum(np.cumsum(walk % 7)) % 2_000_000).astype(np.int32),
         cfg("try_consecutive", 3)),
        ("classic_lookback_i64", np.tile(rng.integers(0, 10**6, 512), 40).astype(np.int64)
         + rng.integers(0, 2, 20480), cfg("try_lookback")),
        ("classic_conv1_i32", (1000 * np.sin(t * 0.01) + rng.standard_normal(9000)).astype(np.int32),
         cfg("try_conv1", 4)),
        ("dict_i64", np.array([3, 99, 1234567, -5], np.int64)[rng.integers(0, 4, 9000)],
         pt.ChunkConfig(mode_spec=pt.ModeSpec("try_dict"))),
        ("int_mult_i64", (rng.integers(0, 10**6, 9000) * 1_000_000_000).astype(np.int64), None),
        ("float_mult_f64", (rng.integers(0, 1000, 9000) * 0.1).astype(np.float64), None),
        ("float_quant_f16", np.round(rng.standard_normal(9000) * 16).astype(np.float16) / 16, None),
    ]


def multi_small_cases(pt):
    """(name, numbers, config, page_n, chunk_n) of small multi-var and
    lookback inputs, one a kind, at page_n 256 and 8,192-number chunks:
    IntMult's two vars, FloatMult f32, FloatQuant f32 (a non-trivial
    secondary), a lookback delta's lookbacks and primary (i64; a ragged
    last page; u16, u32 and f32 latents; pinned IntMult, three vars; Dict's
    u32 indices), and pages of 65,536 numbers, past B5's shared-memory
    route."""
    rng = np.random.default_rng(SEED + 8)
    fq = (np.round(rng.standard_normal(20_000) * 64) / 64).astype(np.float32)
    fq.view(np.uint32)[::7] += rng.integers(1, 4, len(fq[::7])).astype(np.uint32)
    fm = (rng.integers(-5000, 5000, 20_000) * np.float32(0.01)).astype(np.float32)
    fm.view(np.uint32)[::9] += 1
    lb = np.tile(rng.integers(0, 10**6, 512), 40).astype(np.int64) + rng.integers(0, 2, 20480)
    lb_cfg = pt.ChunkConfig(delta_spec=pt.DeltaSpec("try_lookback", 0))
    noise = rng.integers(0, 2, 20_000)
    return [
        ("int_mult_i64", (np.cumsum(rng.integers(1, 30, 20_000)) * 1_000_000_000
                          + rng.integers(0, 4, 20_000)).astype(np.int64),
         pt.ChunkConfig(mode_spec=pt.ModeSpec("try_int_mult", 10**9)), 256, 8192),
        ("float_mult_f32", fm, None, 256, 8192),
        ("float_quant_f32", fq, pt.ChunkConfig(mode_spec=pt.ModeSpec("try_float_quant", 6)), 256, 8192),
        ("lookback_i64", lb, lb_cfg, 256, 8192),
        ("lookback_i64_ragged_page", lb[:20_000], lb_cfg, 256, 8192),
        ("lookback_u16", (np.tile(rng.integers(0, 60_000, 50), 400) + noise).astype(np.uint16), lb_cfg, 256, 8192),
        ("lookback_u32", np.tile(rng.integers(0, 2**32, 50), 400).astype(np.uint32) ^ noise.astype(np.uint32),
         lb_cfg, 256, 8192),
        ("lookback_f32", np.tile(rng.standard_normal(300).astype(np.float32), 67)[:20_000], lb_cfg, 256, 8192),
        ("int_mult_lookback_i64", lb * 1000 + rng.integers(0, 7, len(lb)),
         pt.ChunkConfig(mode_spec=pt.ModeSpec("try_int_mult", 1000), delta_spec=pt.DeltaSpec("try_lookback", 0)),
         256, 8192),
        ("dict_lookback_i64", rng.integers(-(10**12), 10**12, 50)[np.tile(rng.integers(0, 50, 120), 170)],
         pt.ChunkConfig(mode_spec=pt.ModeSpec("try_dict"), delta_spec=pt.DeltaSpec("try_lookback", 0)), 256, 8192),
        ("lookback_i64_long_pages", np.tile(lb, 7)[:140_000], lb_cfg, 65536, 131072),
    ]


def modes_line(plan) -> str:
    """Each chunk kind of an image plan (mode/delta and its latent vars) and
    its chunks."""
    kinds = {}
    for job in plan.enc.jobs:
        meta = job.cc.meta
        key = f"{meta.mode.kind}/{meta.delta_encoding.kind} {'+'.join(vj.key for vj in job.vars)}"
        kinds[key] = kinds.get(key, 0) + 1
    return ", ".join(f"{k} x{v}" for k, v in kinds.items())


def dict_size_inputs(pt):
    """Two TRY_DICT containers beside bench_matrix.py's, 16M i64 of
    uniform draws from 1,500 and from 10,000 random values (seed 1235), in
    1M-number chunks: every chunk's table holds about all the values."""
    rng = np.random.default_rng(SEED + 1)
    dict_cfg = pt.ChunkConfig(mode_spec=pt.ModeSpec(pt.ModeSpec.TRY_DICT))
    cases = []
    for case, v in (("dict_i64_1500", 1500), ("dict_i64_10k", 10_000)):
        vals = rng.integers(-(10**12), 10**12, v).astype(np.int64)
        cases.append((case, vals[rng.integers(0, v, 16 << 20)], dict_cfg, "dict_join_chunks"))
    return cases


# the K4 route each of dict_size_inputs' containers is there to take
DICT_SIZE_ROUTES = {"dict_i64_1500": "K4 table in shared memory", "dict_i64_10k": "K4 table in global memory"}
K4_SWEEP_N = 16 << 20


def sweep(kernels, knob, values, check, fn, hold=True) -> dict:
    """fn timed under each value of the kernels module's attribute `knob`,
    in turns up the values and down again (on the card alone with hold,
    else a call), check() first under each: {value: [ms, ms]}."""
    keep = getattr(kernels, knob)
    got = {v: [] for v in values}
    try:
        for v in values + values[::-1]:
            setattr(kernels, knob, v)
            if not got[v]:
                check()
            got[v].append(time_ms(fn, hold=hold)[0])
    finally:
        setattr(kernels, knob, keep)
    return got


def turns_line(got) -> str:
    return ", ".join(f"{k} {' '.join(f'{t:.4f}' for t in ts)} ms" for k, ts in got.items())


def k4_grids(kernels, fn, check) -> dict:
    """fn (K4 calls) on the card alone under each grid of K4's
    shared-memory route: "walk", blocks that fill the card each walking
    tiles, and "tile", a block a tile. {grid: [ms, ms]}, as sweep."""
    got = sweep(kernels, "DICT_WALK_ENTRIES", (0, 1 << 62), check, fn)
    return {"walk": got[0], "tile": got[1 << 62]}


def k4_grid_sweep(torch, kernels, dops, dev, smem_entries) -> str:
    """K4 (dict_join, one chunk) on K4_SWEEP_N random indices against
    random tables of 128 entries to the shared-memory limit, each grid
    timed as k4_grids times it."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    parts = []
    for D in sorted({128, 512, 1024, 2048, 4096, 8192, 12288, 16384, smem_entries}):
        table = torch.randint(-(1 << 62), 1 << 62, (D,), device=dev, generator=gen)
        prim = torch.randint(0, D, (K4_SWEEP_N,), device=dev, generator=gen)
        want = dops.dict_join_plain(prim, table)
        got = k4_grids(kernels, lambda: dops.dict_join(prim, table),
                       lambda: check_equal(dops.dict_join(prim, table), want))
        parts.append(f"{D} entries: {turns_line(got)}")
    return "; ".join(parts)


def stream_accessors(torch, kernels, fn) -> dict:
    """fn's median a call with the binding's stream accessor
    (kernels._stream, through a torch Stream object) and with torch's
    private raw-handle accessor: {accessor: [ms, ms]}, as sweep."""
    obj, raw = kernels._stream, torch._C._cuda_getCurrentRawStream
    got = sweep(kernels, "_stream", (obj, raw), lambda: None, fn, hold=False)
    return {"object": got[obj], "raw": got[raw]}


def lookback_bytes(dec, desc) -> int:
    """Bytes K3's function must move for a table: each row's valid numbers'
    latents and lookbacks (none for a trivial var) and output at 8 B, and
    its pages' stored state."""
    c = {k: dec.LB_COLS.index(k) for k in ("lat_base", "lb_base", "n_valid", "n_pages", "state_n")}
    return sum(8 * r[c["n_valid"]] * (1 + (r[c["lat_base"]] >= 0) + (r[c["lb_base"]] >= 0))
               + 8 * r[c["n_pages"]] * r[c["state_n"]] for r in desc.tolist())


def breadth_kernel_numbers(torch, dec, name, calls):
    """Bytes K3 or K4 must move over the recorded calls of one decode, and
    the PyTorch calls that compute the same function, where they exist: for
    K4 one torch.take over the concatenated table with each number's global
    index (the yardstick), and one torch.take a chunk (the calls of a join
    launched chunk by chunk), both over indices prepared untimed."""
    if name == "lookback_recon_chunks":
        return sum(lookback_bytes(dec, a[1]) for a in calls), None, None
    # 8 B of index in and 8 B of bits out per number, and the table once
    ((bases, desc, table, out),) = calls
    rows = desc.tolist()  # base, start, n, output offset, table offset, D
    idx = [torch.clamp(bases[b].reshape(-1)[start : start + n] & 0xFFFFFFFF, max=D - 1)
           for b, start, n, _, _, D in rows]
    tables = [table[toff : toff + D] for *_, toff, D in rows]
    gidx = torch.cat([i + r[4] for i, r in zip(idx, rows)])
    want = torch.cat([out[off : off + n] for _, _, n, off, _, _ in rows])
    if not torch.equal(torch.take(table, gidx), want):
        raise AssertionError("K4's torch.take yardstick computes another function")
    n_dict = int(desc[:, 2].sum())
    return (n_dict * 16 + nbytes(table), lambda: torch.take(table, gidx),
            lambda: [torch.take(t, i) for t, i in zip(tables, idx)])


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
                kern = re.search(r"\d([a-z]+(?:_[a-z]+)*_kernel)(?:ILi(\d+)EE)?E", m.group(1))
                entry = kern.group(1) + (f"<{kern.group(2)}>" if kern.group(2) else "")
            elif m:
                name = m.group(1)
                fuse = re.search(r"ILi(\d)E", name)
                smem = re.search(r"ILb(\d)E", name)
                ept = re.search(r"lb_chunks_kernelILi(\d+)E", name)
                sort = re.search(r"(minmax|span|hist|scan|scatter)_kernel(?:I([yj]+)((?:Lb\dE)*))?", name)
                image = re.search(r"image_(sums|blocks|stitch)_kernel", name)
                entry = ({"sums": "page offsets and head", "blocks": "blocks' scan",
                          "stitch": "placement"}[image.group(1)] if image else
                         f"shared memory, {ept.group(1)} per thread" if ept else
                         ("row in shared memory" if smem.group(1) == "1" else "row in device memory")
                         if smem and "section_pack" in name else
                         "global route, prologue" if "lb_init_kernel" in name else
                         "global route, one round" if "lb_round_kernel" in name else
                         f"fuse {fuse.group(1)}" if fuse else
                         ("table in shared memory" if smem.group(1) == "1" else "table in global memory")
                         if smem else sort_entry(sort) if sort else "kernel")
            elif "Used" in line:
                yield k, entry, line.split(":", 1)[1].strip()
            elif "spill" in line:
                yield k, entry, line.strip()


def sort_entry(m) -> str:
    """A K8 kernel's name and its template's key types (u64/u32 of the
    input, the keys and the output) and flags, from its mangled name."""
    types = "/".join({"y": "u64", "j": "u32"}[c] for c in m.group(2) or "")
    flags = ",".join(re.findall(r"Lb(\d)E", m.group(3) or ""))
    return f"{m.group(1)} pass" + (f" {types}" if types else "") + (f" flags {flags}" if flags else "")


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


def walk_steps(R, n, nb_log: int) -> list:
    """Steps each lane's walk of one K9 call takes, from its R table and
    counts: a step either ends the lane or moves it to R of its bin."""
    R, n = R.cpu().numpy(), n.cpu().numpy()
    nb = 1 << nb_log
    steps = []
    for lane in range(len(n)):
        pos, ln, k = 0, int(n[lane]), 0
        while pos < ln:
            k += 1
            j = (pos << nb_log) // ln
            if (((j + 1) * ln + nb - 1) >> nb_log) - pos >= ln - pos:
                break
            pos = int(R[lane, j])
        steps.append(k)
    return steps


def check_train_calls(dt, rs, calls) -> float:
    """K8 and K9 against their plain versions on every recorded call."""
    for (x,) in calls["row_sort"]:
        check_equal(rs.row_sort(x), rs.row_sort_plain(x))
    for args in calls["walk_bins"]:
        for a, b in zip(dt.walk_bins(*args), dt.walk_bins_plain(*args)):
            check_equal(a, b)
    return 0.0


@contextlib.contextmanager
def timed_call(mod, name):
    """Host seconds of every call of mod.name, the card synchronised after
    each (the device training inside a plan_image)."""
    import torch

    spent = [0.0]
    fn = getattr(mod, name)

    def call(*args, **kwargs):
        t0 = time.time()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        spent[0] += time.time() - t0
        return out

    setattr(mod, name, call)
    try:
        yield spent
    finally:
        setattr(mod, name, fn)


def check_two_metas(pt, cmp, plan, nums, cfg) -> str:
    """The metas of chunk 0 and of the first chunk of each other mode (the
    last chunk where all share one) against the host chunk_compressor's."""
    from pcodec_tpu_torch.codec.chunk_config import PagingSpec
    from pcodec_tpu_torch.codec.container import _exact_split

    jobs, chunk_ns = plan.enc.jobs, plan.enc.chunk_ns
    first = {}
    for ci, j in enumerate(jobs):
        first.setdefault(j.cc.meta.mode.kind, ci)
    picked = sorted(set(first.values()) | ({len(jobs) - 1} if len(first) == 1 else set()))
    starts = np.cumsum([0] + chunk_ns[:-1])
    for ci in picked:
        ccfg = replace(cfg or pt.ChunkConfig(),
                       paging_spec=PagingSpec.exact_pages(_exact_split(chunk_ns[ci], plan.enc.page_n)))
        host = cmp.chunk_compressor(plan.enc.nt, nums[starts[ci] : starts[ci] + chunk_ns[ci]], ccfg)
        if meta_bytes(jobs[ci].cc) != meta_bytes(host):
            raise AssertionError(f"chunk {ci}'s device-trained meta differs from the host chunk_compressor's")
    return f"of chunks {', '.join(f'{ci} ({jobs[ci].cc.meta.mode.kind})' for ci in picked)}"


def _sort_walk_numbers(torch, dt, rs, x, walks) -> dict:
    """K8 on one recorded sort and K9 on its walks, timed beside their
    plain versions and torch.sort."""
    k8 = time_ms(lambda: rs.row_sort(x))
    k8_plain = time_ms(lambda: rs.row_sort_plain(x), runs=3, warmup=1)
    k8_lib = time_ms(lambda: torch.sort(x, dim=1))
    k9 = time_ms(lambda: [dt.walk_bins(*a) for a in walks])
    k9_plain = time_ms(lambda: [dt.walk_bins_plain(*a) for a in walks], runs=3, warmup=1)
    return {"rows": x.shape[0], "cols": x.shape[1], "key_bytes_passes": rs.radix_plan(rs.radix_span(x)[1]),
            "ms": k8[0], "plain_ms": k8_plain[0], "library_ms": k8_lib[0], "bound_ms": bound(2 * nbytes(x))[0],
            "lanes": sum(a[0].shape[0] for a in walks), "nb_logs": sorted({a[-1] for a in walks}), "walk_ms": k9[0],
            "walk_plain_ms": k9_plain[0]}


def train_kernel_numbers(torch, dt, rs, calls, plan, launches) -> dict:
    """K8 and K9 held against their plain versions on every call of one
    device training, then timed at the shapes of its last sort (the split
    chunks' secondary rows; else a lookback plan's lookback rows; a Dict
    plan's rows of u32 indices) and of the walks of those rows (K9's calls
    from the last, as many lanes as the sort had rows); a lookback plan's
    primary rows, the sort before, and their walks under "more"."""
    check_train_calls(dt, rs, calls)
    walks, groups = list(calls["walk_bins"]), []
    for (x,) in reversed(calls["row_sort"][-2:]):
        group, lanes = [], 0
        while walks and lanes < x.shape[0]:
            group.insert(0, walks.pop())
            lanes += group[0][0].shape[0]
        groups.append(group)
    jobs = plan.enc.jobs
    kinds = {j.cc.meta.mode.kind for j in jobs}
    lookback = any(j.cc.meta.delta_encoding.kind == "lookback" for j in jobs)
    split = any(v.key == "secondary" for j in jobs for v in j.vars)  # phase_secondary sorts last
    out = _sort_walk_numbers(torch, dt, rs, calls["row_sort"][-1][0], groups[0])
    out["rows_of"] = ("secondary rows" if split else "lookback rows" if lookback
                      else "index rows" if "dict" in kinds else "primary rows")
    out["launches"] = launches
    if lookback and not split and len(groups) > 1:
        out["more"] = [_sort_walk_numbers(torch, dt, rs, calls["row_sort"][-2][0], groups[1])
                       | {"rows_of": "primary rows (toggled lookback deltas)"}]
    return out


def check_lookback_calls(dt, calls, lanes=None, cpu=False) -> float:
    """B5 against its plain version on every recorded call (its first
    `lanes` page rows; with cpu, the plain version on CPU copies, faster
    for few long pages)."""
    for x, lens, *rest in calls:
        if lanes:
            x, lens = x[:lanes].contiguous(), lens[:lanes].contiguous()
        got = dt.lookback_choose(x, lens, *rest)
        want = dt.lookback_choose_plain(*((x.cpu(), lens.cpu()) if cpu else (x, lens)), *rest)
        for a, b in zip(got, want):
            check_equal(a.to(b.device), b)
    return 0.0


def long_pages_line(torch, dt, nums, dev) -> str:
    """B5 on two pages of 2^20 of `nums` (i64; the second page ragged),
    past 2^16 numbers a page (device memory, 64-bit slots): the lookbacks
    held against the native chooser page by page (the plain chooser's 2^20
    steps a page would take minutes), the stored rows and states against
    the plain store of them; then timed."""
    from pcodec_tpu_torch.dtypes import number_type_from_np
    from pcodec_tpu_torch.native.kernels import choose_lookbacks_native

    m = 1 << 20
    x = dt.latents_on_card(nums[: 2 * m], number_type_from_np(nums.dtype), dev).view(2, m)
    lens = torch.tensor([m, m - 1000], device=dev)
    x[1, m - 1000 :] = 0
    lbs, prim, states = dt.lookback_choose(x, lens, 64, 15, 1)
    host = x.cpu().numpy().view(np.uint64)
    for k, n in enumerate(lens.tolist()):
        if not np.array_equal(lbs[k, : n - 1].cpu().numpy().astype(np.uint32),
                              choose_lookbacks_native(15, 1, host[k, :n])) or lbs[k, n - 1 :].any():
            raise AssertionError(f"B5 on a page of {n} numbers differs from the native chooser")
    for a, b in zip((prim, states), dt.lookback_store_plain(x, lens, lbs, 64, 1)):
        check_equal(a, b)
    ms = time_ms(lambda: dt.lookback_choose(x, lens, 64, 15, 1), runs=3, warmup=1)
    return (f"B5 on 2 pages of 2^20 (device memory, 64-bit slots) == the native chooser and the plain store; "
            f"{ms[0]:.1f} ms (min {ms[1]:.1f}, max {ms[2]:.1f}), {ms[0] * 1e3 / (m - 1):.3f} us a step")


def lookback_kernel_numbers(torch, dt, kernels, calls, lanes: int, launches: int) -> dict:
    """B5 on a device training's lookback calls: the pages of the first two
    chunks (`lanes` page rows) held against the plain version, then the
    last call timed a call and on the card alone, its hash-read kernels'
    and its chain kernels' device time a call (the mean of their launches
    in the profiler's trace of five calls, times the call's batches, by
    `kernel_split_ms`; None where no trace holds it),
    its two chunks beside the plain version, one page alone (a page's
    dependent steps), the pages its chain holds on an SM, and its bound
    from the call's inputs (8 bytes read, 12 written a number, the page
    lengths; B5_OPS_PER_NUMBER operations a number)."""
    err = check_lookback_calls(dt, calls, lanes)
    x, lens, bits, wnl, state_n = calls[-1]
    sub = (x[:lanes].contiguous(), lens[:lanes].contiguous(), bits, wnl, state_n)
    one = (x[:1].contiguous(), lens[:1].contiguous(), bits, wnl, state_n)
    n = int(lens.sum())
    ms = time_ms(lambda: dt.lookback_choose(x, lens, bits, wnl, state_n))
    b_ms, by = bound(x.numel() * 20 + nbytes(lens), n * B5_OPS_PER_NUMBER)
    split = kernel_split_ms(lambda: dt.lookback_choose(x, lens, bits, wnl, state_n), ("hash_reads", "chain_kernel"))
    batches = -(-x.shape[0] // dt.lookback_scratch(x, wnl)[1])  # each a hash-read and a chain launch
    passes = {key: None if split[p] is None else split[p] * batches  # a call's device ms of each pass
              for key, p in (("hash_reads_ms", "hash_reads"), ("chain_ms", "chain_kernel"))}
    return {"launches": launches, "err": err, "pages": x.shape[0], "page_n": x.shape[1], "ms": ms[0],
            "device_ms": time_ms(lambda: dt.lookback_choose(x, lens, bits, wnl, state_n), hold=True)[0],
            **passes,
            "resident_pages": kernels.lookback_choose_resident_pages(x.shape[1], bits, wnl, x.device),
            "bound_ms": b_ms, "bound_by": by, "plain_pages": lanes,
            "two_chunks_ms": time_ms(lambda: dt.lookback_choose(*sub))[0],
            "plain_ms": time_ms(lambda: dt.lookback_choose_plain(*sub), runs=3, warmup=1)[0],
            "one_page_ms": time_ms(lambda: dt.lookback_choose(*one), hold=True)[0],
            "one_page_steps": int(lens[0]) - state_n}


def ms_or(ms) -> str:
    return "not traced" if ms is None else f"{ms:.4f}"


def meta_bytes(cc) -> bytes:
    from pcodec_tpu_torch.format.bitio import BitWriter

    w = BitWriter()
    cc.write_meta(w)
    return w.to_bytes()


def k5_args(a):
    return (a["latents"], a["body_n"], a["table_id"], a["states0"], a["nexts"], a["lowers"],
            a["t1"], a["t2"])


SORT_SPANS = ("u32", "u64", "2^32-1", "2^32", "equal", "largest_u64")


def sort_rows(rng, span, rows, m):
    """(rows, m) int64 holding u64 keys with ties whose largest row span
    fits 32 bits or needs 64 ("u32", "u64"), is exactly 2^32 - 1 or 2^32
    (the boundary of K8's key widths), is 0, or whose keys sit at the
    largest u64."""
    if span == "equal":
        return np.full((rows, m), -12345, np.int64)
    if span == "largest_u64":
        x = np.full((rows, m), 2**64 - 1, np.uint64)
        x[:, ::5] -= rng.integers(0, 2**40, x[:, ::5].shape, dtype=np.uint64)
        return x.view(np.int64)
    top = {"u32": 2**32 - 1, "u64": 2**64 - 1, "2^32-1": 2**32 - 1, "2^32": 2**32}[span]
    x = rng.integers(0, top, (rows, m), dtype=np.uint64, endpoint=True)
    x[:, : m // 3] = x[:, :1]
    if span.startswith("2^32"):
        x[0, 0], x[0, -1] = 0, top
    return (x if span == "u64" else x + np.uint64(5 << 40)).view(np.int64)


def k8_three_ways(torch, kernels, rs, x):
    """K8 on x timed three ways: the wrapper as the path calls it (span
    read back, scratch allocated), the sort launch alone on prepared keys
    (span, scratch and output made untimed) and torch.sort of the keys in
    unsigned order (flipped untimed); each a call's (median, min, max) and
    the card's median alone. Returns them and (key bytes, passes)."""
    mm, span = rs.radix_span(x)
    key_bytes, passes = rs.radix_plan(span)
    out, keys, hist = rs.radix_scratch(x, key_bytes, passes)
    xb = x ^ _MIN64
    ways = [lambda: rs.row_sort(x), lambda: kernels.launch_row_sort(x, out, mm, keys, hist, key_bytes, passes),
            lambda: torch.sort(xb, dim=1)]
    return [(time_ms(f), time_ms(f, hold=True)[0]) for f in ways], (key_bytes, passes)


def kernel_split(torch, fn) -> str:
    """Device time of each kernel one call of fn launches, from the
    profiler's trace of that call (warmed up first), largest first."""
    split = traced_kernels(fn)
    return ", ".join(f"{k} {v[0]:.4f} ms" for k, v in sorted(split.items(), key=lambda kv: -kv[1][0]))


def profiled_kernels(torch, fn, calls=3):
    """What one call of fn runs on the card, from torch.profiler's CUDA
    activity over `calls` calls, after a warm-up step that the profiler
    traces and drops (without it, a profile taken after an earlier one in
    the process missed the first call's kernels): (kernels, copies and
    memsets, their device ms, {name: count} of the kernels), each a call's
    share, and the kernels a call that key_averages() counts (entries with
    device time), as a cross-check."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for step in range(2):
            for _ in range(calls if step else 1):
                fn()
            torch.cuda.synchronize()
            prof.step()
    n_kernels = n_copies = 0
    dev_ms, names = 0.0, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_ms += e.time_range.elapsed_us() / 1e3
        if e.name.startswith(("Memcpy", "Memset")):
            n_copies += 1
            continue
        n_kernels += 1
        name = re.split(r"[<(]", e.name.replace("(anonymous namespace)::", "").replace("void ", ""))[0].strip()
        names[name] = names.get(name, 0) + 1
    averaged = sum(e.count for e in prof.key_averages() if getattr(e, "device_time_total", 0) > 0
                   and not e.key.startswith(("Memcpy", "Memset")))
    return (n_kernels / calls, n_copies / calls, dev_ms / calls, {k: v / calls for k, v in names.items()},
            averaged / calls)


def kernels_line(counted) -> str:
    n_kernels, n_copies, dev_ms, names, averaged = counted
    top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
    return (f"{n_kernels:g} CUDA kernels and {n_copies:g} copies or memsets, {dev_ms:.4f} ms of device time "
            f"(by name: {', '.join(f'{k} x{v:g}' for k, v in top)}; key_averages counts {averaged:g} kernels)")


SWEEP_K6_WARPS = (1, 2, 4, 8, 16)
SWEEP_K3_THREADS = (128, 256, 512, 1024)
SWEEP_K7_PAGES_PER_WARP = (1, 2, 4, 8, 16)


def k6_warps_sweep(kernels, ce, st, W) -> dict:
    """K6 at 1 to 16 chains (warps) a block, each held against the plain
    version first."""
    want = ce.section_pack_plain(st["p1"], st["offsets"], W)

    def check():
        for x, y in zip(ce.section_pack(st["p1"], st["offsets"], W), want):
            check_equal(x, y)

    return sweep(kernels, "K6_WARPS", SWEEP_K6_WARPS, check, lambda: ce.section_pack(st["p1"], st["offsets"], W))


def k3_threads_sweep(kernels, dec, calls) -> dict:
    """K3's recorded container calls at blocks of 128 to 1,024 threads,
    each held against the plain version first."""
    return sweep(kernels, "K3_THREADS", SWEEP_K3_THREADS, lambda: check_breadth_calls(dec, calls),
                 lambda: [dec.lookback_recon_chunks(*a) for a in calls["lookback_recon_chunks"]])


def k3_split(torch, dec, call) -> str:
    """Where K3's time goes on one recorded container call: the card alone
    as the decode makes it, with no lookback loaded (each row's lookbacks a
    constant past its pages: one round) and with nothing loaded (its
    latents a constant too), each into copies of the outputs; and how many
    of the rounds the pages of its first row run with a pointer left."""
    bases, desc, _ = call
    c = {k: dec.LB_COLS.index(k) for k in dec.LB_COLS}
    written = set(desc[:, c["out_base"]].tolist())
    scratch = [b.clone() if i in written else b for i, b in enumerate(bases)]
    no_lb = desc.copy()
    no_lb[:, c["lb_base"]], no_lb[:, c["lb_start"]] = -1, 1 << 40
    no_loads = no_lb.copy()
    no_loads[:, c["lat_base"]], no_loads[:, c["lat_start"]] = -1, 5
    times = {}
    for name, d in (("as decoded", desc), ("no lookbacks loaded, one round", no_lb),
                    ("nothing loaded, one round", no_loads)):
        dd = torch.from_numpy(d).to(bases[0].device)
        times[name] = time_ms(lambda: dec.lookback_recon_chunks(scratch, d, dd), hold=True)[0]
    r = desc[0].tolist()
    P, N, sn, wn = r[c["n_pages"]], r[c["page_n"]], r[c["state_n"]], r[c["window_n"]]
    lb = bases[r[c["lb_base"]]].reshape(-1)[r[c["lb_start"]] :][: P * N].view(P, N)
    pos = torch.arange(sn, N, device=lb.device)[None, :]
    ptr = torch.cat([torch.full((P, sn), -1, dtype=torch.int64, device=lb.device),
                     torch.clamp(pos - torch.clamp(lb[:, : N - sn], 1, wn), min=-1)], 1)
    moving = torch.zeros(P, dtype=torch.int64, device=lb.device)
    for _ in range(dec.lookback_rounds(N)):
        moving += (ptr >= 0).any(1)
        ptr = torch.where(ptr >= 0, torch.gather(ptr, 1, ptr.clamp(min=0)), ptr)
    counts = torch.bincount(moving).tolist()
    return (", ".join(f"{k} {t:.4f} ms" for k, t in times.items())
            + f"; pages of its first row by rounds with a pointer left: "
            + ", ".join(f"{k}: {n}" for k, n in enumerate(counts) if n))


def k8_line(ways, plan) -> str:
    (w, wh), (k, kh), (t, th) = ways
    return (f"key bytes {plan[0]}, {plan[1]} passes: as called {w[0]:.4f} ms (min {w[1]:.4f}, max {w[2]:.4f}; "
            f"card alone {wh:.4f}), sort launch alone {k[0]:.4f} ms (card alone {kh:.4f}), torch.sort {t[0]:.4f} ms "
            f"(card alone {th:.4f}); torch.sort takes {t[0] / w[0]:.2f}x K8's time as called")


def check_encode_steps(ce, asm, plan, a):
    """K5, K6 and K7 against their plain versions on one uploaded plan.
    Returns their errors and the intermediate tensors."""
    outs = ce.bin_ans_encode(*k5_args(a))
    err = {"bin_ans_encode": max(check_equal(x, y)
                                 for x, y in zip(outs, ce.bin_ans_encode_plain(*k5_args(a))))}
    p1, offsets, states = outs
    W, rc = plan.launch.sec_words, a.get("row_chains")
    k6 = ce.section_pack(p1, offsets, W, rc)
    err["section_pack"] = max(check_equal(x, y) for x, y in zip(k6, ce.section_pack_plain(p1, offsets, W, rc)))
    sections, ans_len, off_len, total_bits = k6
    curs = ce.section_cursors(p1)[2]
    head, body, body_bytes = asm.image_assemble(plan, a, sections, states, ans_len, off_len, total_bits)
    want = asm.image_assemble_plain(plan, a, sections, states, ans_len, off_len, total_bits)
    if body_bytes != want[2]:
        raise AssertionError(f"K7 sized the body at {body_bytes} bytes, its plain version at {want[2]}")
    err["image_stitch"] = max(check_equal(head, want[0]), check_equal(body, want[1]))
    return dict(err=err, p1=p1, offsets=offsets, states=states, ans_len=ans_len, off_len=off_len, curs=curs,
                total_bits=total_bits, sections=sections, body_words=body.shape[0])


def cli_round_trip(nums, data) -> str:
    """`python -m pcodec_tpu_torch` compress --format pct then decompress,
    each in a subprocess on the card, on the main path's numbers saved as
    .npy in a temporary directory, with the main path's flags: the file
    must be the main path's container bytes and the decode the numbers."""
    import os
    import subprocess
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        src, pct, back = (os.path.join(tmp, f) for f in ("x.npy", "x.pct", "y.npy"))
        np.save(src, nums)
        secs = []
        for argv in (["compress", src, pct, "--format", "pct", "--page-n", "1024", "--chunk-n", str(1 << 20),
                      "--delta", "consecutive:1"], ["decompress", pct, back]):
            t0 = time.time()
            proc = subprocess.run([sys.executable, "-m", "pcodec_tpu_torch", *argv], cwd=root, capture_output=True,
                                  text=True, timeout=600)
            secs.append(time.time() - t0)
            if proc.returncode:
                raise AssertionError(f"cli {argv[0]} exited {proc.returncode}: {proc.stdout}{proc.stderr}")
        with open(pct, "rb") as f:
            if f.read() != data:
                raise AssertionError("cli compress: the file differs from the main path's container")
        if not np.array_equal(np.load(back), nums):
            raise AssertionError("cli decompress: the numbers differ from the source")
    return (f"cli compress --format pct == the main path's container, decompress == source ({len(nums)} numbers; "
            f"subprocesses {secs[0]:.1f} s, {secs[1]:.1f} s)")

# phase 12: the CLI bench's codecs at 2^20 (the JAX CLI's codec names)
BENCH_CODECS = "pco_tpu,pct,zlib,lzma,bz2,qco"


def bench_rows(root, argv, csv_path):
    """`python -m pcodec_tpu_torch bench` in a subprocess on the card:
    (its CSV rows, the subprocess's seconds)."""
    import csv
    import subprocess

    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "pcodec_tpu_torch", "bench", *argv, "--csv", csv_path], cwd=root,
                          capture_output=True, text=True, timeout=600)
    secs = time.time() - t0
    if proc.returncode:
        raise AssertionError(f"bench {argv} exited {proc.returncode}: {proc.stdout}{proc.stderr}")
    with open(csv_path, newline="") as f:
        return list(csv.DictReader(f)), secs


def bench_row_line(r) -> str:
    """A bench row's ratio and GB/s of input, as the CLI prints them, with
    the row's own numbers."""
    n, size = int(r["uncompressed_size"]), int(r["compressed_size"])
    c, d = float(r["compress_dt"]), float(r["decompress_dt"])
    return (f"{r['codec']} ratio {n / size:.4f}, compress {n / c / 1e9:.4f} GB/s, decompress {n / d / 1e9:.4f} GB/s "
            f"({size} B, {c:.4f} s, {d:.4f} s)")


def bench_phase(nums, data, card) -> None:
    """The port's CLI bench in subprocesses on the card: the main path's
    64M numbers with the main path's delta (pct: the median of 3 calls;
    pco_tpu: one call, its host simple_compress taking ~17 s a call at 64M,
    after pct's one call has warmed the process), then the synthetic 2^20
    numbers with every codec on the card and on the host (--host). Every pct
    size at 64M must be the main path's container (container_compress at
    the same configuration), every 2^20 size the --host row's."""
    import os
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "main.npy")
        np.save(src, nums)
        flags = ["--input", src, "--delta", "consecutive:1"]
        rows_a, s_a = bench_rows(root, [*flags, "--codecs", "pct", "--iters", "3"], os.path.join(tmp, "a.csv"))
        rows_b, s_b = bench_rows(root, [*flags, "--codecs", "pct,pco_tpu", "--iters", "1"],
                                 os.path.join(tmp, "b.csv"))
        for r in rows_a + rows_b:
            if r["codec"] == "pct" and int(r["compressed_size"]) != len(data):
                raise AssertionError(f"bench pct at 64M: {r['compressed_size']} B, the main path's container "
                                     f"{len(data)} B")
        print(f"bench: main path {len(nums)} i64 (--delta consecutive:1), --iters 3: {bench_row_line(rows_a[0])}; "
              f"--iters 1 after pct's call: {bench_row_line(rows_b[1])}; pct == the main path's container size "
              f"(subprocesses {s_a:.1f} s, {s_b:.1f} s) [{card}]", flush=True)
        rows_c, s_c = bench_rows(root, ["--codecs", BENCH_CODECS], os.path.join(tmp, "c.csv"))
        rows_d, s_d = bench_rows(root, ["--codecs", BENCH_CODECS, "--host"], os.path.join(tmp, "d.csv"))
    sizes = [[(r["input"], r["codec"], r["compressed_size"]) for r in rows] for rows in (rows_c, rows_d)]
    if sizes[0] != sizes[1]:
        raise AssertionError(f"bench at 2^20: the card's sizes {sizes[0]} differ from --host's {sizes[1]}")
    for where, rows, secs in (("the card", rows_c, s_c), ("the host (--host)", rows_d, s_d)):
        print(f"bench: {rows[0]['input']} on {where}, --iters 3: "
              f"{'; '.join(bench_row_line(r) for r in rows)} (subprocess {secs:.1f} s) [{card}]", flush=True)
    print(f"bench: every 2^20 size on the card == --host's [{card}]", flush=True)


def capi_phase(torch, kernels, card) -> None:
    """The port's C ABI: Python.h found, the shim (native/cpcodec.cpp) and
    its C test program built with g++/gcc and run on the card (it must
    print ALL C ABI TESTS PASSED), the shim loaded into this process and a
    C ABI decode of the bench's synthetic 2^20 numbers (compressed through
    the C ABI) equal to them, the counts set to 0 just before it and K1
    and K2 launched; then `make syntax-check` of the Java binding's JNI
    source."""
    import ctypes
    import os
    import subprocess
    import tempfile

    from pcodec_tpu_torch.native import capi_build

    t0 = time.time()
    inc = capi_build.python_headers()
    with tempfile.TemporaryDirectory() as tmp:
        capi_build.build_shim(tmp, embed=True)
        exe = capi_build.build_test_program(tmp, tmp)
        lib = capi_build.load_shim(capi_build.build_shim(tmp, embed=False))
        t_build = time.time() - t0
        t0 = time.time()
        proc = capi_build.run_test_program(exe)
        t_run = time.time() - t0
        if proc.returncode or "ALL C ABI TESTS PASSED" not in proc.stdout:
            raise AssertionError(f"test_cpcodec exited {proc.returncode}: {proc.stdout}{proc.stderr}")
        rng = np.random.default_rng(0)
        n = 1 << 20
        x = np.cumsum(rng.integers(0, 120, n) + (rng.random(n) < 0.001) * rng.integers(0, 10**6, n)).astype(np.int64)
        cap = lib.pco_standalone_guarantee_file_size(4, n)
        blob = np.zeros(cap, np.uint8)
        written = ctypes.c_size_t(0)
        rc = lib.pco_standalone_simple_compress_into(x.ctypes.data, n, 4, 8, blob.ctypes.data, cap,
                                                     ctypes.byref(written))
        if rc:
            raise AssertionError(f"C ABI compress returned {rc}")
        out = np.zeros(n, np.int64)
        n_out = ctypes.c_size_t(0)
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        t1 = time.time()
        rc = lib.pco_standalone_simple_decompress_into(blob.ctypes.data, written.value, 4, out.ctypes.data, n,
                                                       ctypes.byref(n_out))
        t_dec = time.time() - t1
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    if rc or n_out.value != n or not np.array_equal(out, x):
        raise AssertionError(f"C ABI decode on the card: rc {rc}, {n_out.value} numbers, equal "
                             f"{np.array_equal(out, x)}")
    if not (launches.get("section_gather") and launches.get("chain_decode")):
        raise AssertionError(f"the C ABI decode launched {launches}, not K1 and K2")
    java = subprocess.run(["make", "syntax-check"], cwd=os.path.join(os.path.dirname(capi_build.NATIVE), "java"),
                          capture_output=True, text=True, timeout=120)
    if java.returncode:
        raise AssertionError(f"make syntax-check of java/ exited {java.returncode}: {java.stdout}{java.stderr}")
    print(f"capi: Python.h in {inc}; shim, its in-process build and test_cpcodec built in {t_build:.1f} s; "
          f"test_cpcodec on the card: ALL C ABI TESTS PASSED ({t_run:.1f} s, its process's start and kernel load "
          f"included); C ABI decode in this process of {n} i64 ({written.value} B) == source, {t_dec:.3f} s, "
          f"launches {launches}; java: make syntax-check passed [{card}]", flush=True)


def experiment_checks(torch, dev) -> None:
    """Each microbenchmark kernel against its plain version at small shapes
    (ragged rows, wrapping sums, states outside the table, clusters of 1 to
    8 blocks), E1 on a ragged raw at 1,200 tiles and 512 rounds and at 3
    and 4 tiles on 2^20 + 100 words (its two column-sum routes), route take
    on rows of 2^16 entries and at 0 steps, route taa at the same shapes
    but 2^16 (which it refuses), route row in each of its two forms (also
    against torch.gather), route lane at 0, 1, 300 and 6,144 steps, and E2
    on rows longer than one cluster holds."""
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
    # a ragged raw, starts at 0, 1,023 and in the last fetchable block, more
    # tiles than the tile pass holds in one wave, 512 rounds
    n_raw = (1 << 16) + 100
    last = (n_raw - 3072) // 1024 * 1024
    raw, starts = i32(n_raw), i32((1200, 128), 0, last + 1024)
    starts[0, :3] = torch.tensor([0, 1023, last + 1023], dtype=torch.int32)
    check_equal(pd.dma_checksum(starts, raw, 512), pd.dma_checksum_plain(starts, raw, 512))
    # 3 tiles on a raw of 2^20 + 100 words: the column sums of only the
    # touched blocks (768 touches of 1,024 blocks), and of every block at 4
    n_raw = (1 << 20) + 100
    last = (n_raw - 3072) // 1024 * 1024
    raw = i32(n_raw)
    for n_tiles in (3, 4):
        starts = i32((n_tiles, 128), 0, last + 1024)
        starts[0, :3] = torch.tensor([0, 1023, last + 1023], dtype=torch.int32)
        check_equal(pd.dma_checksum(starts, raw, 512), pd.dma_checksum_plain(starts, raw, 512))
    # rows that fill no last block of route take's 4, no step, and rows of
    # 2^16 entries (route take's read-only-path walk; route taa refuses them)
    for rows, ts, steps in ((13, 64, 37), (64, 1024, 37), (3, 1 << 14, 37), (37, 1024, 37), (37, 1024, 0),
                            (5, 1 << 16, 37)):
        table, idx0 = i32((rows, ts)), i32((rows, 4), 0, ts)
        want = mg.gather_steps_plain(table, idx0, steps)
        check_equal(mg.gather_take(table.flatten(), idx0, steps), want)
        if ts < 1 << 16:
            check_equal(mg.gather_taa(table, idx0, steps), want)
    tbl, idx = i32((19, 128)), i32((19, 128))
    for steps in (0, 1, 300, 6144):
        check_equal(mg.lane_steps(tbl, idx, steps), mg.lane_steps_plain(tbl, idx, steps))
    # route row in each of its forms: registers (widths 1-128, rows that
    # fill no last block), a thread an element (129-3,000)
    for rows, width in ((5, 77), (3, 1), (7, 32), (4097, 128), (5, 129), (4, 2048), (3, 3000)):
        tbl, idx = i32((rows, width)), i32((rows, width), 0, width)
        got = mg.row_gather(tbl, idx)
        check_equal(got, mg.row_gather_plain(tbl, idx))
        check_equal(got, torch.gather(tbl, 1, idx.long()))
    sec, node, state = i32((3, 256, 128)), i32((8, 1024)), i32((3, 8, 128), 0, 1024)
    state[0, :, :5] = torch.tensor([-7, 1024, 5000, -(2**31), 2**31 - 1], dtype=torch.int32)
    for got, want in zip(prl.round_loop(sec, node, state, 7, True), prl.round_loop_plain(sec, node, state, 7, True)):
        check_equal(got, want)
    for rows, m in ((3, 2), (8, 256), (16, 1024), (5, 1 << 16), (2, 1 << 18), (2, 1 << 19), (1, 1 << 21)):
        x = i32((rows, m))
        x[:, : m // 3] = x[:, :1]
        check_equal(pb.sort_rows_u32(x), pb.sort_rows_u32_plain(x))


def experiment_runs(dev) -> tuple:
    """Each microbenchmark's main(): the experiment's own shapes through its
    kernels, each checked against its plain version, timed and printed in
    the experiment's units. Returns {kernel: its row at its last shape, the
    experiment's largest} and {kernel: the launches of the calls that the
    profiler traced over all of its shapes}."""
    from pcodec_tpu_torch.experiments import micro_gather, pallas_bitonic, proto_dma, proto_realign
    from pcodec_tpu_torch.experiments import proto_round_loop

    mods = (proto_realign, proto_dma, micro_gather, proto_round_loop, pallas_bitonic)
    rows = [r for mod in mods for r in mod.main(dev)]
    traced = {}
    for r in rows:
        traced[r["name"]] = traced.get(r["name"], 0) + r.get("traced_launches", 0)
    return {r["name"]: r for r in rows}, traced


# phase 10's inputs of phase 8, kept there with their config, bytes and chunk size
RESIDENT_KEPT = ("intmult_i64_timestamps", "f64_auto_multichunk", "dict_i64", "wrapped_lookback_multipage")
SHARDS = 4  # phase 11's shards of the main path
TRACE_TRIES = 3  # traces of one call taken before a trace that lost its memcpy events fails phase 10


def memcpy_bytes(torch, fn):
    """(host-to-card bytes, card-to-host bytes, copies) of one call of fn:
    the memcpy events of an exported torch.profiler trace (CUDA activity)
    of that call, the card synchronised at its end, after a warm-up call
    the profiler traces and drops (as profiled_kernels does)."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    up = down = copies = 0
    for e in events:
        if e.get("cat") != "gpu_memcpy":
            continue
        n = int(e.get("args", {}).get("bytes", 0))
        if "HtoD" in e.get("name", ""):
            up += n
        elif "DtoH" in e.get("name", ""):
            down += n
        copies += 1
    return up, down, copies


def moved_line(moved: dict, nbytes_in: int) -> str:
    """The bytes each route's plan_image moved, as memcpy_bytes counts them."""
    return "; ".join(f"{k}: {up} B up ({up / nbytes_in:.2%} of the numbers), {down} B down ({down / nbytes_in:.2%}), "
                     f"{c} copies" for k, (up, down, c) in moved.items())


def resident_run(torch, asm, nums, cfg, ref, chunk_n, dev, measure_bytes=True):
    """Phase 10 on one input: plan_image of the numbers as a CUDA tensor,
    without and with their host copy, each image == ref (the numpy
    route's bytes) and trained on the card; each route's plan_image host
    seconds (the card synchronised) with its training part, the numbers it
    copied to the host, and (measure_bytes) the bytes each route, the
    numpy one too, moves between host and card. Returns (the tensor,
    {route: (plan s, training s, copied)}, {route: memcpy_bytes})."""
    x = torch.from_numpy(nums).to(dev)
    routes = {"numpy": (nums, None), "tensor": (x, None), "tensor+mirror": (x, nums)}
    times = {}
    for route, (arg, mirror) in routes.items():
        torch.cuda.synchronize()
        with timed_call(asm, "plan_encode_device") as t_train:
            t0 = time.time()
            plan = asm.plan_image(arg, cfg, 1024, chunk_n, dev, nums_host=mirror)
            torch.cuda.synchronize()
            t_plan = time.time() - t0
        if plan.trained_on != "device":
            raise AssertionError(f"the {route} route trained on the {plan.trained_on}")
        if route != "numpy" and asm.file_image_to_bytes(*asm.run_image(plan, asm.upload_image(plan, dev))) != ref:
            raise AssertionError(f"the {route} route's image differs from the numpy route's bytes")
        times[route] = (t_plan, t_train[0], plan.enc.host_copied)
        del plan
    moved = {}
    if measure_bytes:
        for route, (arg, mirror) in routes.items():
            moved[route] = memcpy_bytes(torch, lambda: asm.plan_image(arg, cfg, 1024, chunk_n, dev, nums_host=mirror))
        # the numpy route uploads the numbers: a trace without that upload
        # lost its events, so it is taken again, up to TRACE_TRIES in all
        tries = 1
        while moved["numpy"][0] < nums.nbytes and tries < TRACE_TRIES:
            print(f"resident: the trace of the numpy route's plan_image shows {moved['numpy'][0]} B up, not the "
                  f"numbers' {nums.nbytes} B; traced again", flush=True)
            moved["numpy"] = memcpy_bytes(torch, lambda: asm.plan_image(nums, cfg, 1024, chunk_n, dev))
            tries += 1
        if moved["numpy"][0] < nums.nbytes:
            raise AssertionError(f"the trace of the numpy route's plan_image shows {moved['numpy'][0]} B up in "
                                 f"{moved['numpy'][2]} copies, not the numbers' {nums.nbytes} B, in each of "
                                 f"{tries} traces: the bytes are not measured")
    return x, times, moved


def times_line(times: dict) -> str:
    return "; ".join(f"{k}: plan_image {t:.3f} s, training {tr:.3f} s, {c} numbers copied to the host"
                     for k, (t, tr, c) in times.items())


def shard_kernel_checks(torch, pt, asm, cd, ce, sh, mesh) -> str:
    """Every per-shard K1 and K2 call of a small sharded decode, and every
    per-shard K5 and K6 call of small sharded encodes (a row a chain, and
    IntMult's joint rows), held against their plain versions; the decode
    equals the source and each image container_compress's bytes."""
    rng = np.random.default_rng(SEED + 13)
    n = 5 * 8192 + 300
    cases = (("classic_delta1", np.cumsum(rng.integers(0, 3000, n)).astype(np.int64),
              pt.ChunkConfig(delta_spec=pt.DeltaSpec(pt.DeltaSpec.TRY_CONSECUTIVE, 1))),
             ("intmult", (np.cumsum(rng.integers(1, 30, n)) * 1000 + rng.integers(0, 4, n)).astype(np.int64),
              pt.ChunkConfig(mode_spec=pt.ModeSpec(pt.ModeSpec.TRY_INT_MULT, 1000))))
    calls = {"K1": 0, "K2": 0, "K5": 0, "K6": 0}
    for name, nums, cfg in cases:
        data = pt.container_compress(nums, cfg, page_n=256, chunk_n=8192)
        plan = cd.plan_container(data)
        sd = sh.upload_sharded(plan, mesh)
        for s in sd.shards:
            cp, a = plan.launches[s.lkey], s.arrays
            stg = cd.section_gather(s.words, a["word0"], cp.stage_words)
            check_equal(stg, cd.section_gather_plain(s.words, a["word0"], cp.stage_words), f"{name}: a shard's K1")
            args = (stg, a["word0"], a["curs"], a["states0"], a["body_n"], a["table_id"], a["node"], a["lower"],
                    a["moment0"], cp.page_n, cp.fuse)
            check_equal(cd.chain_decode(*args), cd.chain_decode_plain(*args), f"{name}: a shard's K2")
            calls["K1"] += 1
            calls["K2"] += 1
        got = cd.to_numbers(sh.decode_sharded(plan, sd), plan.nt)
        if not np.array_equal(got, nums):
            raise AssertionError(f"{name}: the sharded decode differs from the source")
        iplan = asm.plan_image(nums, cfg, 256, 8192, mesh[0])
        img = sh.upload_sharded_image(iplan, mesh)
        for s in img.shards:
            a = s.arrays
            p1, off, st = ce.bin_ans_encode(*k5_args(a))
            for g, w in zip((p1, off, st), ce.bin_ans_encode_plain(*k5_args(a))):
                check_equal(g, w, f"{name}: a shard's K5")
            rc = a.get("row_chains")
            for g, w in zip(ce.section_pack(p1, off, iplan.launch.sec_words, rc),
                            ce.section_pack_plain(p1, off, iplan.launch.sec_words, rc)):
                check_equal(g, w, f"{name}: a shard's K6")
            calls["K5"] += 1
            calls["K6"] += 1
        if asm.file_image_to_bytes(*sh.run_image_sharded(iplan, img)) != data:
            raise AssertionError(f"{name}: the sharded image differs from container_compress")
    return f"per-shard calls == plain: {calls} on {len(cases)} small containers of 6 chunks"


def sharded_main(torch, kernels, asm, cd, sh, plan, iplan, data, single_bits, mesh):
    """The main path's container decoded and its image encoded sharded over
    mesh, with the counts set to 0 just before each and read just after:
    (decode launches, encode launches, the shards' uploaded words, decode
    ms, encode ms (each median, min, max), peak bytes). The decode must
    equal single_bits and the image the container's bytes."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sd = sh.upload_sharded(plan, mesh)
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    res = sh.decode_sharded(plan, sd)
    torch.cuda.synchronize()
    dec_l = {k: kernels.LAUNCHES[k] for k in ("section_gather", "chain_decode")}
    if not torch.equal(res, single_bits):
        raise AssertionError(f"the sharded decode differs from the single-device decode at "
                             f"{int((res != single_bits).sum())} numbers")
    del res
    img = sh.upload_sharded_image(iplan, mesh)
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    out = sh.run_image_sharded(iplan, img)
    torch.cuda.synchronize()
    enc_l = {k: kernels.LAUNCHES[k] for k in ("bin_ans_encode", "section_pack", "image_stitch")}
    if asm.file_image_to_bytes(*out) != data:
        raise AssertionError("the sharded image differs from the container's bytes")
    del out
    if (set(dec_l.values()) != {len(sd.shards)} or enc_l["bin_ans_encode"] != len(img.shards)
            or enc_l["section_pack"] != len(img.shards) or not enc_l["image_stitch"]):
        raise AssertionError(f"a sharded kernel was not launched once a shard: {dec_l}, {enc_l}")
    spans = [(str(s.device), s.chains, s.span[1] - s.span[0]) for s in sd.shards]
    t_dec = time_ms(lambda: sh.decode_sharded(plan, sd))
    t_enc = time_ms(lambda: sh.run_image_sharded(iplan, img))
    peak = torch.cuda.max_memory_allocated()
    return dec_l, enc_l, spans, t_dec, t_enc, peak, [(str(s.device), s.chains, s.rows) for s in img.shards]


def sharded_phase(torch, pt, kernels, asm, cd, ce, sh, plan, iplan, data, single, dev, card):
    """Phase 11 over SHARDS shards of the first card, then over every
    visible card where there are two or more: the per-shard kernel checks,
    the main path's decode and image sharded (sharded_main) beside the
    single-device times, and dryrun_multichip. Returns the first mesh's
    (decode launches, encode launches, the kernels line's sharded object)."""
    from pcodec_tpu_torch.entry import dryrun_multichip

    arrays1, ia1 = cd.upload_plan(plan, dev), asm.upload_image(iplan, dev)
    one_dec = time_ms(lambda: cd.decode_plan(plan, arrays1))
    one_enc = time_ms(lambda: asm.run_image(iplan, ia1))
    del arrays1, ia1
    n_cards = torch.cuda.device_count()
    # (label, mesh, dryrun's devices: None needs that many visible cards)
    meshes = [(f"{SHARDS} shards of one card", [dev] * SHARDS, [dev] * SHARDS)]
    if n_cards >= 2:
        meshes.append((f"{n_cards} cards", sh.make_mesh(), None))
    first = None
    for label, mesh, dry_devices in meshes:
        mesh = sh.make_mesh(mesh)
        print(f"sharded: {label}: {shard_kernel_checks(torch, pt, asm, cd, ce, sh, mesh)} [{card}]", flush=True)
        d, e, spans, td, te, peak, eshards = sharded_main(torch, kernels, asm, cd, sh, plan, iplan, data, single, mesh)
        print(f"sharded: {label}: main path decode == the single-device decode (torch.equal), image == the "
              f"container's bytes; launches {d}, {e}; each shard's words uploaded (device, chains, words) {spans} of "
              f"the container's {len(plan.words)}; encode shards (device, chains, rows) {eshards}; "
              f"max_memory_allocated {peak} bytes [{card}]", flush=True)
        print(f"sharded: {label}: main path decode {td[0]:.3f} ms (min {td[1]:.3f}, max {td[2]:.3f}) sharded, "
              f"{one_dec[0]:.3f} ms single-device; encode device part {te[0]:.3f} ms (min {te[1]:.3f}, max "
              f"{te[2]:.3f}) sharded, {one_enc[0]:.3f} ms single-device [{card}]", flush=True)
        dry = dryrun_multichip(len(mesh), devices=dry_devices)
        call = f"{len(mesh)}" if dry_devices is None else f"{len(mesh)}, devices=[cuda] * {len(mesh)}"
        print(f"sharded: {label}: dryrun_multichip({call}): encode == container_compress, decode == source for "
              f"{', '.join(dry)} [{card}]", flush=True)
        if first is None:
            first = (d, e, {"shards": len(mesh), "decode_ms": td[0], "single_decode_ms": one_dec[0],
                            "encode_ms": te[0], "single_encode_ms": one_enc[0]})
    if n_cards < 2:
        print("sharded: 1 card: shards share it", flush=True)
    return first


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

    from pcodec_tpu_torch.codec import standalone as sa
    from pcodec_tpu_torch.ops import standalone_decode as sd

    t_wall = time.time()
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
        check_launches(cd, plan, arrays)
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
        check_launches(cd, plan, arrays)
        ch = plan.chunks[0]
        made = {"K3": bool(calls["lookback_recon"] or calls["lookback_recon_chunks"]),
                "K4": bool(calls["dict_join_chunks"])}
        want = {"K3": ch.delta.kind == "lookback", "K4": ch.mode_kind == "dict"}
        if made != want:
            raise AssertionError(f"{case} p{page_n}: K3 and K4 called {made}, expected {want}")
        for k in ("lookback_recon_chunks", "dict_join_chunks"):
            if len(calls[k]) > 1:
                raise AssertionError(f"{case} p{page_n}: {len(calls[k])} {k} calls, not one a decode")
        routes = {kernel_route(kernels, k, a, smem_entries) for k, recorded in calls.items() for a in recorded}
        seen |= routes
        print(f"breadth: {case} p{page_n}: decode == source, {ch.mode_kind}/{ch.delta.kind}, "
              f"K1, K2 and {sorted(routes) or 'no K3/K4'} == plain", flush=True)
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
    plans8 = set()
    for span in SORT_SPANS:
        for m in (1, 3, 256, 5000, 42_200, 70_000, (1 << 20) + 3):
            x = torch.from_numpy(sort_rows(rng, span, 3, m)).to(dev)
            check_equal(rs.row_sort(x), rs.row_sort_plain(x))
            if m > 1:
                plans8.add(rs.radix_plan(rs.radix_span(x)[1]))
    if not {(4, 0), (4, 4), (8, 5), (8, 8)} <= plans8:
        raise AssertionError(f"phase 4 missed a key width or pass count of K8: {sorted(plans8)}")
    print(f"encode: K8 row_sort == plain on spans {', '.join(SORT_SPANS)} (key bytes, passes: {sorted(plans8)}), "
          f"rows of 1 to 2^20 + 3 keys", flush=True)
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
    k2_alone = time_ms(lambda: cd.chain_decode(*args), hold=True)[0]
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
    print(f"main: K2 chain_decode {k2[0]:.4f} ms (min {k2[1]:.4f}, max {k2[2]:.4f}; card alone {k2_alone:.4f}), "
          f"plain {k2_plain[0]:.1f} ms, bound {k2_bound:.4f} ms [{card}]",
          flush=True)
    print(f"main: K2's accounting inputs: ts {a['node'].shape[1]}, stage_words {W}, {n_chains} chains of "
          f"{cp.page_n} numbers, {len(data) * 8 / N:.3f} container bits a number [{card}]", flush=True)
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
    enc_launches = {k: kernels.LAUNCHES[k] for k in ("row_sort", "row_sort_span", "histogram_walk",
                                                     "bin_ans_encode", "section_pack", "image_stitch")}
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
    nw = st["body_words"]
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
    k8_ways, k8_plan = k8_three_ways(torch, kernels, rs, x8)
    k8, k8_lib = k8_ways[0][0], k8_ways[2][0]
    k8_plain = time_ms(lambda: rs.row_sort_plain(x8))
    rows8, m8 = x8.shape
    print(f"main: K8 row_sort for {rows8} rows of {m8} latents: {k8_line(k8_ways, k8_plan)}; plain "
          f"{k8_plain[0]:.4f} ms [{card}]", flush=True)
    print(f"main: K8 row_sort's kernels, one call's device time (torch.profiler): "
          f"{kernel_split(torch, lambda: rs.row_sort(x8))} [{card}]", flush=True)
    k9 = time_ms(lambda: dt.walk_bins(*k9_args))
    k9_alone = time_ms(lambda: dt.walk_bins(*k9_args), hold=True)[0]
    k9_plain = time_ms(lambda: dt.walk_bins_plain(*k9_args), runs=3, warmup=1)
    lanes9, nb9 = k9_args[0].shape
    lane_steps = walk_steps(k9_args[2], k9_args[6], k9_args[7])
    steps9, long9 = sum(lane_steps), int(np.argmax(lane_steps))
    k9_one = tuple(x[long9 : long9 + 1].contiguous() if torch.is_tensor(x) else x for x in k9_args)
    k9_lane = time_ms(lambda: dt.walk_bins(*k9_one), hold=True)[0]
    print(f"main: K9 histogram_walk {k9[0]:.4f} ms (min {k9[1]:.4f}, max {k9[2]:.4f}; card alone {k9_alone:.4f}) "
          f"for {lanes9} lanes of {nb9} bins ({steps9} steps), plain {k9_plain[0]:.2f} ms; its longest lane "
          f"({lane_steps[long9]} steps) alone on the card {k9_lane:.4f} ms, "
          f"{k9_lane / lane_steps[long9] * 1e3:.3f} us a step [{card}]", flush=True)
    k9_acc = stream_accessors(torch, kernels, lambda: dt.walk_bins(*k9_args))
    print(f"main: K9 a call by stream accessor: {turns_line(k9_acc)} [{card}]", flush=True)

    enc = time_ms(lambda: asm.run_image(iplan, ia))
    enc_kernels = profiled_kernels(torch, lambda: asm.run_image(iplan, ia))
    k5 = time_ms(lambda: ce.bin_ans_encode(*k5_args(ia)))
    k5_alone = time_ms(lambda: ce.bin_ans_encode(*k5_args(ia)), hold=True)[0]
    glue = time_ms(lambda: ce.section_cursors(st["p1"]))
    k6 = time_ms(lambda: ce.section_pack(st["p1"], st["offsets"], L.sec_words))
    k6_alone = time_ms(lambda: ce.section_pack(st["p1"], st["offsets"], L.sec_words), hold=True)[0]
    k6_sweep = k6_warps_sweep(kernels, ce, st, L.sec_words)
    k7_in = (st["sections"], st["states"], st["ans_len"], st["off_len"], st["total_bits"])
    k7 = time_ms(lambda: asm.image_assemble(iplan, ia, *k7_in))
    # K7 on the card alone: its two C calls each held (a call waits on the
    # body's byte count in between), into the scratch and outputs of a call
    R7 = iplan.layout.total_pages
    head7 = torch.empty(iplan.head_bytes // 4, dtype=torch.int32, device=dev)
    scan_words7, page_words7 = kernels.image_scratch_sizes(R7)
    scan7 = torch.empty(scan_words7, dtype=torch.int64, device=dev)
    pages7 = torch.empty(page_words7, dtype=torch.int32, device=dev)
    body7 = torch.empty(nw, dtype=torch.int32, device=dev)
    E7 = head7.shape[0] - ia["head_host"].shape[0] - R7
    k7_offsets = time_ms(lambda: kernels.launch_image_offsets(
        ia["image_desc"], st["total_bits"], st["ans_len"], st["off_len"], st["sections"], st["states"],
        ia["moments"], ia["image_pfx"], ia["head_host"], E7, head7, scan7, pages7), hold=True)[0]
    k7_place = time_ms(lambda: kernels.launch_image_stitch(ia["image_desc"], pages7, scan7, st["sections"],
                                                           st["states"], ia["moments"], ia["image_pfx"], body7),
                       hold=True)[0]
    check_equal(body7, asm.image_assemble(iplan, ia, *k7_in)[1])
    k7_alone = k7_offsets + k7_place
    k7_want = asm.image_assemble(iplan, ia, *k7_in)[1]
    k7_sweep = sweep(kernels, "K7_PAGES_PER_WARP", SWEEP_K7_PAGES_PER_WARP,
                     lambda: check_equal(asm.image_assemble(iplan, ia, *k7_in)[1], k7_want),
                     lambda: kernels.launch_image_stitch(ia["image_desc"], pages7, scan7, st["sections"],
                                                         st["states"], ia["moments"], ia["image_pfx"], body7))
    del k7_want
    k7_split = kernel_split(torch, lambda: asm.image_assemble(iplan, ia, *k7_in))
    k5_plain = time_ms(lambda: ce.bin_ans_encode_plain(*k5_args(ia)), runs=3, warmup=1)
    k6_plain = time_ms(lambda: ce.section_pack_plain(st["p1"], st["offsets"], L.sec_words), runs=3, warmup=1)
    k7_plain = time_ms(lambda: asm.image_assemble_plain(iplan, ia, *k7_in), runs=3, warmup=1)
    # the plain steps K7 took in, once: prepare_image's rows (the JAX
    # package's XLA prep), then the placement yardstick, one index_add_ of
    # the row words over a precomputed flat index (index and int64 words
    # not timed), which computes the placement only
    pa = {**ia, **asm.upload_prep(iplan, dev)}
    prep_t = time_ms(lambda: asm.prepare_image(iplan, pa, *k7_in))
    prep = asm.prepare_image(iplan, pa, *k7_in)
    flat_idx, flat_val = [], []
    for rows, F0, lenW in ((prep["rowsA"], prep["F0A"], prep["lenA"]),
                           (prep["rowsC"], prep["F0C"], prep["lenC"])):
        w = torch.arange(rows.shape[1], device=dev)
        ok = w[None, :] < lenW[:, None]
        flat_idx.append((F0[:, None] + w[None, :])[ok])
        flat_val.append((rows.to(torch.int64) & 0xFFFFFFFF)[ok])
    del prep, pa
    flat_idx, flat_val = torch.cat(flat_idx), torch.cat(flat_val)
    body64 = torch.zeros(nw, dtype=torch.int64, device=dev)

    def k7_library():
        body64.zero_()
        body64.index_add_(0, flat_idx, flat_val)

    k7_library()
    if not torch.equal(ce._to_i32(body64), body7):
        raise AssertionError("K7's index_add_ placement yardstick computes another function")
    k7_lib = time_ms(k7_library)
    del flat_idx, flat_val, body64

    # bytes the functions need: each coded symbol's latent in, its p1 word
    # and its offset (4 bytes unless some bin has over 32 offset bits) out;
    # K6 reads them, and writes every row whole (its zero tail included) and
    # the section lengths; its bound before it took the cursors in counted
    # the cursors read and only the payload words written
    syms = int(L.body_n.sum())
    b_pad = L.lowers.shape[1]
    off_b = 8 if int(((ia["t1"] >> 4) & 127).max()) > 32 else 4
    k5_bytes = (syms * (8 + 4 + off_b) + nbytes(*(ia[k] for k in ("body_n", "table_id", "states0", "nexts",
                                                                  "lowers", "t1", "t2")))
                + nbytes(st["states"]))
    k5_bound, k5_by = bound(k5_bytes, syms * (K5_OPS_PER_SYMBOL + K5_OPS_PER_STEP * int(math.log2(b_pad))))
    payload_words = int(((st["total_bits"] + 31) >> 5).sum())
    k6_bytes_old = syms * (4 + off_b) + nbytes(st["curs"]) + payload_words * 4
    k6_bytes = (syms * (4 + off_b) + nbytes(st["sections"], st["ans_len"], st["off_len"], st["total_bits"]))
    k6_bound, k6_by = bound(k6_bytes, syms * K6_OPS_PER_SYMBOL)
    k6_bound_old = bound(k6_bytes_old, syms * K6_OPS_PER_SYMBOL)[0]
    # K7: each page's payload words, the states, lengths, total bits and
    # moments read once (the descriptor rows, prefix and head host words
    # too), each body and head word written once
    k7_bytes = (payload_words * 4 + nbytes(st["states"], st["ans_len"], st["off_len"], st["total_bits"],
                                           ia["moments"], ia["image_desc"], ia["image_pfx"], ia["head_host"])
                + nw * 4 + iplan.head_bytes)
    k7_bound = bound(k7_bytes)[0]
    k8_bytes = 2 * rows8 * m8 * 8  # each u64 latent read once and written once
    k8_bound, k8_by = bound(k8_bytes, rows8 * m8 * math.log2(m8))  # m log2 m compares a row
    # K9: the five tables and s0, n read once, the three bin tables and
    # n_bins written once; K9_OPS_PER_STEP integer operations a walk step
    k9_bytes = nbytes(*k9_args[:7]) + 3 * lanes9 * nb9 * 8 + lanes9 * 8
    k9_bound, k9_by = bound(k9_bytes, steps9 * K9_OPS_PER_STEP)
    enc_bound = bound(N * 8 + len(data))[0]
    enc_gbps = N * 8 / (enc[0] * 1e-3) / 1e9
    print(f"main: encode device part (K5, K6, K7) {enc[0]:.3f} ms median "
          f"(min {enc[1]:.3f}, max {enc[2]:.3f}, {RUNS} runs), {enc_gbps:.2f} GB/s of input, "
          f"byte bound {enc_bound:.4f} ms = {enc_bound / enc[0]:.1%}; one run_image runs "
          f"{kernels_line(enc_kernels)} [{card}]", flush=True)
    print(f"main: K5 bin_ans_encode {k5[0]:.4f} ms (min {k5[1]:.4f}, max {k5[2]:.4f}; card alone {k5_alone:.4f}), "
          f"plain {k5_plain[0]:.1f} ms, bound {k5_bound:.4f} ms [{card}]",
          flush=True)
    print(f"main: K5's accounting inputs: ts {L.nexts.shape[1]}, b_pad {b_pad}, {syms} coded numbers, "
          f"{int(st['ans_len'].sum()) / syms:.3f} ANS bits and {int(st['off_len'].sum()) / syms:.3f} offset bits "
          f"a number [{card}]", flush=True)
    print(f"main: K6 section_pack {k6[0]:.4f} ms (min {k6[1]:.4f}, max {k6[2]:.4f}; card alone {k6_alone:.4f}), "
          f"plain {k6_plain[0]:.1f} ms, bound {k6_bound:.4f} ms (rows whole and lengths written; "
          f"{k6_bound_old:.4f} ms counting payload words and cursors read, as before the cursors moved in); "
          f"the plain section_cursors (the glue K6 took in) {glue[0]:.4f} ms (min {glue[1]:.4f}, "
          f"max {glue[2]:.4f}) [{card}]", flush=True)
    print(f"main: K6 card alone by chains a block, in turns (each == plain): {turns_line(k6_sweep)}; "
          f"{kernels.K6_WARPS} used [{card}]", flush=True)
    print(f"main: K7 image_assemble {k7[0]:.4f} ms (min {k7[1]:.4f}, max {k7[2]:.4f}; card alone {k7_alone:.4f}: "
          f"offsets pass {k7_offsets:.4f}, placement {k7_place:.4f}), plain {k7_plain[0]:.3f} ms, bound "
          f"{k7_bound:.4f} ms ({k7_bytes} bytes: {payload_words} payload words read, {nw} body words and "
          f"{iplan.head_bytes} head bytes written); its kernels' device time (torch.profiler): {k7_split}; "
          f"the plain steps it took in: prepare_image {prep_t[0]:.4f} ms (min {prep_t[1]:.4f}, max "
          f"{prep_t[2]:.4f}), the placement alone as one index_add_ {k7_lib[0]:.4f} ms [{card}]", flush=True)
    print(f"main: K7 placement card alone by pages a warp, in turns (each == plain): {turns_line(k7_sweep)}; "
          f"{kernels.K7_PAGES_PER_WARP} used [{card}]", flush=True)
    print(f"main: K8 bound {k8_bound:.4f} ms, K9 bound {k9_bound:.6f} ms; bytes counted: K5 {k5_bytes}, "
          f"K6 {k6_bytes} ({L.n_chains} rows of {L.sec_words} words, {payload_words} payload words, offsets at "
          f"{off_b} bytes; before: {k6_bytes_old}), K8 {k8_bytes}, "
          f"K9 {k9_bytes} [{card}]", flush=True)

    del ia, head7, scan7, pages7, body7, x8, k9_args, k9_one
    torch.cuda.empty_cache()

    # 5b. breadth at full size
    breadth_rows = {}
    kept = {}  # phase 8's inputs of this phase: their numbers, config and container_compress bytes
    for case, nums5, cfg5, kname in matrix_inputs(pt) + dict_size_inputs(pt):
        t0 = time.time()
        data5 = pt.container_compress(nums5, cfg5)
        t_enc5 = time.time() - t0
        if case in MULTI_KEPT:
            kept[case] = (nums5, cfg5, data5)
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
        lname = {"dict_join_chunks": "dict_join", "lookback_recon_chunks": "lookback_recon"}[kname]
        if launches5[lname] == 0 or (plan5.launches and launches5["chain_decode"] == 0):
            raise AssertionError(f"{case}: a kernel of its decode path was not launched: {launches5}")
        if launches5[lname] != 1 or len(calls[kname]) != 1:
            raise AssertionError(f"{case}: {launches5[lname]} {lname} launches in {len(calls[kname])} calls, "
                                 f"not one a decode")
        kcalls = calls[kname]
        err5 = check_breadth_calls(dops, calls)
        arrays5 = cd.upload_plan(plan5, dev)
        dec5 = time_ms(lambda: cd.decode_plan(plan5, arrays5))
        k12 = time_ms(lambda: [cd.run_launch(cp, arrays5.words, arrays5.launches[lk])
                                      for lk, cp in plan5.launches.items()])
        check_launches(cd, plan5, arrays5)  # after the timings: the plain K2 precedes no measurement
        kern = getattr(dops, kname)
        plain = dops.lookback_recon_chunks_plain if kname == "lookback_recon_chunks" else dops.dict_join_chunks_plain
        k_t = time_ms(lambda: [kern(*a) for a in kcalls])
        k_alone = time_ms(lambda: [kern(*a) for a in kcalls], hold=True)[0]
        k_plain = time_ms(lambda: [plain(*a) for a in kcalls], runs=3, warmup=1)
        k_bytes, library, per_chunk = breadth_kernel_numbers(torch, dops, kname, kcalls)
        k_lib = (time_ms(library), time_ms(library, hold=True)[0]) if library else None
        k_old = time_ms(per_chunk) if per_chunk else None
        k_bound = bound(k_bytes)[0]
        n5 = len(nums5)
        bound5 = bound(len(data5) + n5 * 8)[0]
        routes = sorted({kernel_route(kernels, kname, a, smem_entries) for a in kcalls})
        if case in DICT_SIZE_ROUTES and routes != [DICT_SIZE_ROUTES[case]]:
            raise AssertionError(f"{case}: K4 took {routes}, not {DICT_SIZE_ROUTES[case]}")
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
        lib_txt = ""
        if k_lib:
            lib_txt = (f", one torch.take over the container's index {k_lib[0][0]:.4f} ms (card alone "
                       f"{k_lib[1]:.4f}), a torch.take a chunk {k_old[0]:.4f} ms for {len(kcalls[0][1])} chunks; "
                       f"K4 at {k_t[0] / k_lib[0][0]:.2f}x the one torch.take's time")
        print(f"breadth: {case}: {kname} ({', '.join(routes)}) {k_t[0]:.4f} ms for its {len(kcalls)} calls "
              f"(min {k_t[1]:.4f}, max {k_t[2]:.4f}; card alone {k_alone:.4f}, {k_bound / k_alone:.1%} of the bound), "
              f"{launches5[lname]} launches, plain {k_plain[0]:.3f} ms{lib_txt}, bound {k_bound:.4f} ms "
              f"({k_bytes} bytes) [{card}]", flush=True)
        if routes == ["K4 table in shared memory"]:
            grids = k4_grids(kernels, lambda: [kern(*a) for a in kcalls], lambda: check_breadth_calls(dops, calls))
            print(f"breadth: {case}: K4 card alone by grid (each == plain): {turns_line(grids)} [{card}]", flush=True)
        if kname == "lookback_recon_chunks":
            acc = stream_accessors(torch, kernels, lambda: [kern(*a) for a in kcalls])
            print(f"breadth: {case}: K3 a call ({len(kcalls)} calls) by stream accessor: {turns_line(acc)} "
                  f"[{card}]", flush=True)
            print(f"breadth: {case}: K3 card alone by threads a block, in turns (each == plain): "
                  f"{turns_line(k3_threads_sweep(kernels, dops, calls))}; {kernels.K3_THREADS} used [{card}]",
                  flush=True)
            print(f"breadth: {case}: K3's time split, card alone: {k3_split(torch, dops, kcalls[0])} [{card}]",
                  flush=True)
            dec5_alone = time_ms(lambda: cd.decode_plan(plan5, arrays5), hold=True)[0]
            print(f"breadth: {case}: one decode_plan runs "
                  f"{kernels_line(profiled_kernels(torch, lambda: cd.decode_plan(plan5, arrays5)))}; "
                  f"decode card alone (hold) {dec5_alone:.4f} ms [{card}]", flush=True)
        if lname not in breadth_rows:
            breadth_rows[lname] = {"launches": launches5[lname], "max_abs_err": err5, "ms": k_t[0],
                                   "plain_ms": k_plain[0], "bound_ms": k_bound, "bound_by": "bytes",
                                   "library_ms": k_lib[0][0] if k_lib else None, "device_ms": k_alone}
        del calls, kcalls, arrays5, plan5, data5, nums5
        torch.cuda.empty_cache()

    print(f"breadth: K4 grid sweep, one chunk of {K4_SWEEP_N} random indices, card alone by grid (each == "
          f"plain): {k4_grid_sweep(torch, kernels, dops, dev, smem_entries)} [{card}]", flush=True)

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
    launches_c = {k: kernels.LAUNCHES[k] for k in ("row_sort", "row_sort_span", "histogram_walk",
                                                   "bin_ans_encode", "section_pack", "image_stitch")}
    if asm.file_image_to_bytes(*image_c) != data_c:
        raise AssertionError("the ChunkConfig() file image differs from container_compress's bytes")
    if any(v == 0 for v in launches_c.values()):
        raise AssertionError(f"a kernel of the ChunkConfig() encode was not launched: {launches_c}")
    del image_c
    check_train_calls(dt, rs, ccalls)
    sorts_c = [tuple(x.shape) for (x,) in ccalls["row_sort"]]
    walks_c = [tuple(a[0].shape) for a in ccalls["walk_bins"]]
    k9_c = [time_ms(lambda a=a: dt.walk_bins(*a))[0] for a in ccalls["walk_bins"]]
    k8_c = [(tuple(x.shape), *k8_three_ways(torch, kernels, rs, x)) for (x,) in ccalls["row_sort"]]
    del ccalls
    t0 = time.time()
    plan_c = asm.plan_image(nums, auto_cfg, 1024, 2 << 20, dev)
    t_plan_c = time.time() - t0
    if plan_c.trained_on != "device":
        raise AssertionError(f"the ChunkConfig() encode trained on the {plan_c.trained_on}")
    ca = asm.upload_image(plan_c, dev)
    check_encode_steps(ce, asm, plan_c, ca)
    del ca
    deltas_c = {}
    for job in plan_c.enc.jobs:
        de = job.cc.meta.delta_encoding
        key = f"{job.cc.meta.mode.kind}/{de.kind}" + (f" {de.order}" if de.order else "")
        deltas_c[key] = deltas_c.get(key, 0) + 1
    print(f"auto: {N} taxi-like i64 at ChunkConfig(), 2M-number chunks: {len(data_c)} bytes, host encode "
          f"{t_enc_c:.1f} s; image == container_compress bytes; K5, K6, K7 == plain; launches {launches_c}; "
          f"chunks {deltas_c}; "
          f"encode_container_image_device {t_img_c:.1f} s, plan_image {t_plan_c:.3f} s (host clock, "
          f"training included) [{card}]", flush=True)
    print(f"auto: K8 calls {sorts_c}, K9 calls {walks_c} == plain; K9 "
          f"{', '.join(f'{t:.4f}' for t in k9_c)} ms [{card}]", flush=True)
    for shape, ways, plan8 in k8_c:
        print(f"auto: K8 row_sort {shape}: {k8_line(ways, plan8)} [{card}]", flush=True)
    del plan_c  # data_c: phase 10's reference for this configuration
    torch.cuda.empty_cache()

    # 7. standalone .pco decode: small files of each mode x delta kind, then
    # bench_matrix.py's seven standalone inputs
    t_ph = time.time()
    for case, nums7, cfg7 in standalone_small_cases(pt):
        blob = sa.simple_compress(nums7, cfg7)
        want = pt.decode_standalone_device(blob, device="cpu")
        plan7 = sd.plan_standalone(blob)
        arrays7 = cd.upload_plan(plan7, dev)
        with capturing(dops) as calls:
            got = cd.to_numbers(cd.decode_plan(plan7, arrays7), plan7.nt)
        if not (np.array_equal(got.view(np.uint8), want.view(np.uint8))
                and np.array_equal(got.view(np.uint8), nums7.view(np.uint8))):
            raise AssertionError(f"standalone {case}: the card's decode differs from the CPU route's")
        check_launches(cd, plan7, arrays7)
        check_breadth_calls(dops, calls)
        ch = plan7.chunks[0]
        print(f"standalone: {case}: decode on the card == CPU route == source, {ch.mode_kind}/{ch.delta.kind}, "
              f"K1, K2{', K3' if calls['lookback_recon_chunks'] or calls['lookback_recon'] else ''}"
              f"{', K4' if calls['dict_join_chunks'] else ''} == plain", flush=True)
    inputs = standalone_inputs(pt)
    sa_rows = {}
    for case in STANDALONE:
        nums7, cfg7 = inputs[case]
        if case not in STANDALONE_FULL:
            nums7 = nums7[:STANDALONE_CUT]
        t0 = time.time()
        blob = sa.simple_compress(nums7, cfg7)
        t_enc7 = time.time() - t0
        t0 = time.time()
        plan7 = sd.plan_standalone(blob)
        t_plan7 = time.time() - t0
        torch.cuda.synchronize()
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        with capturing(dops) as calls:
            got = pt.decode_standalone_device(blob, device=dev)
            torch.cuda.synchronize()
        launches7 = {k: v for k, v in kernels.LAUNCHES.items() if v}
        if not np.array_equal(got.view(np.uint8), nums7.view(np.uint8)):
            raise AssertionError(f"standalone {case}: decode_standalone_device differs from the source")
        del got
        kinds = {(ch.mode_kind, ch.delta.kind) for ch in plan7.chunks}
        need = ["section_gather", "chain_decode"] + (["lookback_recon"] if any(d == "lookback" for _, d in kinds)
                                                     else []) + (["dict_join"] if any(m == "dict" for m, _ in kinds)
                                                                 else [])
        if any(not launches7.get(k) for k in need):
            raise AssertionError(f"standalone {case}: a kernel of its decode was not launched: {launches7}")
        arrays7 = cd.upload_plan(plan7, dev)
        check_launches(cd, plan7, arrays7)
        check_breadth_calls(dops, calls)
        dec7 = time_ms(lambda: cd.decode_plan(plan7, arrays7))
        k12 = time_ms(lambda: [cd.run_launch(cp, arrays7.words, arrays7.launches[lk])
                               for lk, cp in plan7.launches.items()])
        outs7 = {lk: cd.run_launch(cp, arrays7.words, arrays7.launches[lk]) for lk, cp in plan7.launches.items()}
        # a post of over 50 ms (conv1's loop, FloatMult's softfloat) is timed in 3 runs
        post7 = time_ms(lambda: cd.post_chunks(plan7, outs7, arrays7),
                        **({"runs": 3, "warmup": 1} if dec7[0] > 50 else {}))
        k3 = [(dops.lookback_recon_chunks, a) for a in calls["lookback_recon_chunks"]] + [
            (dops.lookback_recon, a) for a in calls["lookback_recon"]]
        k4 = [(dops.dict_join_chunks, a) for a in calls["dict_join_chunks"]]
        k3_t = time_ms(lambda: [f(*a) for f, a in k3])[0] if k3 else 0.0
        k4_t = time_ms(lambda: [f(*a) for f, a in k4])[0] if k4 else 0.0
        n7, nb7 = len(nums7), nums7.nbytes
        bound7 = bound(len(blob) + nb7)[0]
        sa_rows[case] = {"n": n7, "bytes": len(blob), "ms": dec7[0], "plan_s": t_plan7, "post_ms": post7[0]}
        print(f"standalone: {case}: {n7} {nums7.dtype}{'' if case in STANDALONE_FULL else ' (the first 8M)'}, "
              f"{len(blob)} bytes, ratio {nb7 / len(blob):.4f}, {len(plan7.chunks)} chunks "
              f"{sorted(kinds)}, host simple_compress {t_enc7:.1f} s, host plan_standalone {t_plan7:.3f} s; "
              f"decode_standalone_device == source, launches {launches7}, K1, K2 and the decode's K3/K4 calls "
              f"== plain [{card}]", flush=True)
        print(f"standalone: {case}: decode {dec7[0]:.3f} ms median (min {dec7[1]:.3f}, max {dec7[2]:.3f}, "
              f"{RUNS} runs), {nb7 / (dec7[0] * 1e-3) / 1e9:.2f} GB/s of output, byte bound {bound7:.4f} ms = "
              f"{bound7 / dec7[0]:.1%}; K1 + K2 {k12[0]:.4f} ms ({len(plan7.launches)} launches), K3 "
              f"{k3_t:.4f} ms ({len(k3)} calls), K4 {k4_t:.4f} ms ({len(k4)} calls), post (post_chunks, K3/K4 "
              f"inside) {post7[0]:.4f} ms (min {post7[1]:.4f}, max {post7[2]:.4f}, {3 if dec7[0] > 50 else RUNS} runs)"
              f"{'; the conv1 post (conv1_decode_pages, a loop over positions)' if case == 'conv1_i32_lpc' else ''}"
              f" [{card}]", flush=True)
        del outs7, arrays7, plan7, blob, calls, nums7
        torch.cuda.empty_cache()
    print(f"standalone: phase {time.time() - t_ph:.1f} s [{card}]", flush=True)

    # 8. multi-var and lookback file image: small inputs of each kind with
    # K6 and K7 held against their plain versions, then bench_matrix.py's
    # multi-var inputs
    t_ph = time.time()
    for case, nums8, cfg8, pn8, cn8 in multi_small_cases(pt):
        ref8 = pt.container_compress(nums8, cfg8, page_n=pn8, chunk_n=cn8)
        with capturing(dt, ("lookback_choose",)) as bcalls:
            plan8 = asm.plan_image(nums8, cfg8, pn8, cn8, dev)
        if plan8.launch.row_chains is None or plan8.trained_on != "device":
            raise AssertionError(f"multi {case}: trained on the {plan8.trained_on}, no chunk of several latent vars "
                                 f"({modes_line(plan8)})")
        lookback = any(j.cc.meta.delta_encoding.kind == "lookback" for j in plan8.enc.jobs)
        if lookback != bool(bcalls["lookback_choose"]):
            raise AssertionError(f"multi {case}: {len(bcalls['lookback_choose'])} B5 calls ({modes_line(plan8)})")
        check_lookback_calls(dt, bcalls["lookback_choose"], cpu=True)
        a8 = asm.upload_image(plan8, dev)
        check_encode_steps(ce, asm, plan8, a8)
        if asm.file_image_to_bytes(*asm.run_image(plan8, a8)) != ref8:
            raise AssertionError(f"multi {case}: file image differs from container_compress")
        routes = sorted({"shared" if a[0].shape[1] <= kernels.LB_CHOOSE_SMEM_MAX_N else "device"
                         for a in bcalls["lookback_choose"]})
        b5 = f"{len(bcalls['lookback_choose'])} B5 calls ({'/'.join(routes)} memory) == plain, " if lookback else ""
        print(f"multi: {case}: page_n {pn8}, {modes_line(plan8)}; trained on the card, {b5}K5, K6 (joint rows), "
              f"K7 (multi-var rows) == plain, image == container_compress", flush=True)
        if "device" in routes:  # B5's device-memory route, timed
            long_ms = time_ms(lambda: [dt.lookback_choose(*a) for a in bcalls["lookback_choose"]], runs=3, warmup=1)
            print(f"multi: {case}: B5's device-memory route, its {len(bcalls['lookback_choose'])} calls "
                  f"({', '.join(str(tuple(a[0].shape)) for a in bcalls['lookback_choose'])} pages x numbers) "
                  f"{long_ms[0]:.2f} ms [{card}]", flush=True)
        del bcalls
    print(f"multi: {long_pages_line(torch, dt, kept['wrapped_lookback_multipage'][0][: 2 << 20], dev)} [{card}]",
          flush=True)
    multi_rows, train_rows, lb_rows = {}, {}, {}
    resident = {}  # phase 10's inputs: numbers, config, container_compress bytes, chunk size
    for case, m in MULTI_INPUTS:
        t0 = time.time()
        chunk8 = MULTI_CHUNK_N.get(case, 1 << 20)
        if case in MULTI_KEPT:
            nums8, cfg8, ref8 = kept[case]
        elif case == "wrapped_lookback_auto":
            nums8, cfg8 = kept.pop("wrapped_lookback_multipage")[0][:m], pt.ChunkConfig()
            ref8 = pt.container_compress(nums8, cfg8, page_n=1024, chunk_n=chunk8)
        else:
            nums8, cfg8 = inputs[case]
            nums8 = nums8[:m]
            ref8 = pt.container_compress(nums8, cfg8, page_n=1024, chunk_n=chunk8)
        t_ref8 = time.time() - t0
        if case in RESIDENT_KEPT:
            resident[case] = (nums8, cfg8, ref8, chunk8)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        t0 = time.time()
        with capturing(dt, ("row_sort", "walk_bins", "lookback_choose")) as tcalls8, \
                timed_call(asm, "plan_encode_device") as t_train8:
            plan8 = asm.plan_image(nums8, cfg8, 1024, chunk8, dev)
            torch.cuda.synchronize()
        t_plan8 = time.time() - t0
        train_launches8 = {k: kernels.LAUNCHES[k] for k in ("row_sort", "row_sort_span", "histogram_walk",
                                                            "lookback_choose")}
        if plan8.trained_on != "device":
            raise AssertionError(f"multi {case}: trained on the {plan8.trained_on}, not the card")
        lookback = any(j.cc.meta.delta_encoding.kind == "lookback" for j in plan8.enc.jobs)
        if case.startswith("wrapped_lookback") and not (lookback and train_launches8["lookback_choose"]):
            raise AssertionError(f"multi {case}: no lookback chunk trained through B5 ({modes_line(plan8)}, "
                                 f"launches {train_launches8})")
        a8 = asm.upload_image(plan8, dev)
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        img8 = asm.run_image(plan8, a8)
        torch.cuda.synchronize()
        launches8 = {k: kernels.LAUNCHES[k] for k in ("bin_ans_encode", "section_pack", "image_stitch")}
        peak8 = torch.cuda.max_memory_allocated()
        if asm.file_image_to_bytes(*img8) != ref8:
            raise AssertionError(f"multi {case}: file image differs from container_compress")
        if any(v == 0 for v in launches8.values()):
            raise AssertionError(f"multi {case}: a kernel of its encode was not launched: {launches8}")
        del img8
        metas8 = check_two_metas(pt, cmp, plan8, nums8, cfg8)
        if lookback:  # B5 on the pages of the first two chunks against plain, then timed
            lb_rows[case] = lookback_kernel_numbers(torch, dt, kernels, tcalls8["lookback_choose"],
                                                    2 * plan8.enc.dev.rows_per_chunk,
                                                    train_launches8["lookback_choose"])
            lr = lb_rows[case]
            print(f"multi: {case}: B5 lookback_choose {lr['launches']} launch(es) on {lr['pages']} pages of "
                  f"{lr['page_n']}: {lr['ms']:.4f} ms a call (card alone {lr['device_ms']:.4f}; PERF.md's record of its "
                  f"earlier design {B5_EARLIER_DEVICE_MS:.3f}; the call's hash-read kernels {ms_or(lr['hash_reads_ms'])}, "
                  f"its chain kernels {ms_or(lr['chain_ms'])} (profiler), {lr['resident_pages']} pages resident an SM; bound "
                  f"{lr['bound_ms']:.4f} by {lr['bound_by']}); the first two chunks' {lr['plain_pages']} pages == "
                  f"plain, {lr['two_chunks_ms']:.4f} ms (plain {lr['plain_ms']:.2f}); one page alone "
                  f"{lr['one_page_ms']:.4f} ms, {lr['one_page_steps']} steps [{card}]", flush=True)
        train_rows[case] = tr = train_kernel_numbers(torch, dt, rs, tcalls8, plan8, train_launches8)
        more = "".join(f"; the {p['rows_of']}: K8 on {p['rows']} rows of {p['cols']} (key bytes, passes "
                       f"{p['key_bytes_passes']}) {p['ms']:.4f} ms (plain {p['plain_ms']:.4f}, torch.sort "
                       f"{p['library_ms']:.4f}), K9 on {p['lanes']} lanes at nb_log {p['nb_logs']} {p['walk_ms']:.4f} ms "
                       f"(plain {p['walk_plain_ms']:.3f})" for p in tr.get("more", []))
        print(f"multi: {case}: plan_image {t_plan8:.3f} s, of it device training (plan_encode_device) "
              f"{t_train8[0]:.3f} s; chunk metas {metas8} == host chunk_compressor; K8, K9 == plain on "
              f"every call; launches {train_launches8}; the {tr['rows_of']}: K8 on {tr['rows']} rows of "
              f"{tr['cols']} (key bytes, passes {tr['key_bytes_passes']}) {tr['ms']:.4f} ms a call (plain "
              f"{tr['plain_ms']:.4f}, torch.sort {tr['library_ms']:.4f}), K9 on {tr['lanes']} lanes at nb_log "
              f"{tr['nb_logs']} {tr['walk_ms']:.4f} ms (plain {tr['walk_plain_ms']:.3f}){more} [{card}]", flush=True)
        del tcalls8
        L8 = plan8.launch
        st8 = check_encode_steps(ce, asm, plan8, a8)
        rc8 = a8.get("row_chains")
        enc8 = time_ms(lambda: asm.run_image(plan8, a8))
        k5_8 = time_ms(lambda: ce.bin_ans_encode(*k5_args(a8)))
        k6_8 = time_ms(lambda: ce.section_pack(st8["p1"], st8["offsets"], L8.sec_words, rc8))
        k6_8a = time_ms(lambda: ce.section_pack(st8["p1"], st8["offsets"], L8.sec_words, rc8), hold=True)[0]
        k7_in = (st8["sections"], st8["states"], st8["ans_len"], st8["off_len"], st8["total_bits"])
        k7_8 = time_ms(lambda: asm.image_assemble(plan8, a8, *k7_in))
        syms8 = int(L8.body_n.sum())
        off_b8 = 8 if int(((a8["t1"] >> 4) & 127).max()) > 32 else 4
        pw8 = int(((st8["total_bits"] + 31) >> 5).sum())
        k6_b8 = bound(syms8 * (4 + off_b8) + nbytes(st8["sections"], st8["ans_len"], st8["off_len"],
                                                    st8["total_bits"]) + (nbytes(rc8) if rc8 is not None else 0),
                      syms8 * K6_OPS_PER_SYMBOL)[0]
        k7_b8 = bound(pw8 * 4 + nbytes(st8["states"], st8["ans_len"], st8["off_len"], st8["total_bits"],
                                       a8["moments"], a8["image_desc"], a8["image_pfx"], a8["head_host"])
                      + st8["body_words"] * 4 + plan8.head_bytes)[0]
        multi_rows[case] = {"n": len(nums8), "launches": launches8, "k6_ms": k6_8[0], "k6_device_ms": k6_8a,
                            "k6_bound_ms": k6_b8, "k7_ms": k7_8[0], "k7_bound_ms": k7_b8, "encode_ms": enc8[0]}
        print(f"multi: {case}: {len(nums8)} {nums8.dtype}, {len(ref8)} bytes, {modes_line(plan8)}; trained on the "
              f"{plan8.trained_on}, host container_compress {t_ref8:.1f} s, plan_image {t_plan8:.3f} s; image == "
              f"container_compress, launches {launches8}; K5, K6, K7 == plain; {L8.n_chains} chains, K6 rows "
              f"{L8.n_rows} x {L8.sec_words} words ({'pages of ' + str(rc8.shape[1]) + ' var slots' if rc8 is not None else 'a row a chain'}); "
              f"max_memory_allocated {peak8} bytes [{card}]", flush=True)
        print(f"multi: {case}: encode device part (run_image) {enc8[0]:.3f} ms (min {enc8[1]:.3f}, max "
              f"{enc8[2]:.3f}), {nums8.nbytes / (enc8[0] * 1e-3) / 1e9:.2f} GB/s of input; K5 {k5_8[0]:.4f} ms, K6 "
              f"{k6_8[0]:.4f} ms (card alone {k6_8a:.4f}, bound {k6_b8:.4f}), K7 {k7_8[0]:.4f} ms (bound "
              f"{k7_b8:.4f}) [{card}]", flush=True)
        del st8, a8, plan8, ref8, nums8
        torch.cuda.empty_cache()
    del inputs, kept
    print(f"multi: K6 at the main path {k6[0]:.4f} ms (card alone {k6_alone:.4f}); phase {time.time() - t_ph:.1f} s "
          f"[{card}]", flush=True)

    # 6. experiments: the microbenchmarks of pcodec_tpu_torch/experiments
    t_exp = time.time()
    experiment_checks(torch, dev)
    print(f"experiments: every kernel == plain at small shapes, E1 at 1,200 tiles of a ragged raw and on both column-"
          f"sum routes, route take on "
          f"rows of 2^16, E2 at (2, 2^19) and (1, 2^21) too [{card}]", flush=True)
    torch.cuda.synchronize()
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    exp, exp_traced = experiment_runs(dev)
    torch.cuda.synchronize()
    # launches of the checks and timed calls; those the profiler traced apart
    exp_launches = {k: kernels.LAUNCHES[k] - exp_traced.get(k, 0) for k in EXPERIMENT_ROWS}
    if any(v == 0 for v in exp_launches.values()):
        raise AssertionError(f"a kernel of the experiments was not launched: {exp_launches}")
    print(f"experiments: E5 proto_realign at 2048 groups {exp['proto_realign']['ms'][0]:.4f} ms beside K1 "
          f"section_gather at the main path {k1[0]:.4f} ms; launches {exp_launches} (the profiler's traces apart: "
          f"{exp_traced}); phase {time.time() - t_exp:.1f} s [{card}]", flush=True)

    # 9. entry points: the CLI in subprocesses on the main path's numbers, and
    # entry()
    t0 = time.time()
    cli_line = cli_round_trip(nums, data)
    from pcodec_tpu_torch.entry import entry, entry_numbers

    fn, args = entry()
    got = int(fn(*args).item()) & ((1 << 64) - 1)
    if got != int(entry_numbers().view(np.uint64).sum()):
        raise AssertionError(f"entry(): checksum {got} differs from numpy's")
    print(f"entry: {cli_line}; entry() on the card: checksum {got} == numpy's; phase {time.time() - t0:.1f} s "
          f"[{card}]", flush=True)
    b5 = lb_rows["wrapped_lookback_multipage"]

    # 10. device-resident encode: the numbers already on the card as a CUDA
    # tensor, planned without and with their host copy, each image against
    # the numpy route's bytes
    t_ph = time.time()
    x_main, times10, moved10 = resident_run(torch, asm, nums, cfg, data, 1 << 20, dev)
    print(f"resident: main path {N} i64 (order-1 delta, 1M-number chunks): both tensor routes' images == the numpy "
          f"route's bytes; {times_line(times10)} [{card}]", flush=True)
    print(f"resident: main path, the host/card bytes of one plan_image (torch.profiler memcpy events): "
          f"{moved_line(moved10, nums.nbytes)} [{card}]", flush=True)
    up10, down10, _ = moved10["tensor"]
    if max(up10, down10) >= nums.nbytes // 10:
        raise AssertionError(f"the tensor route moved {up10} B up and {down10} B down, not under 10% of the numbers")
    if times10["tensor"][2]:
        raise AssertionError(f"the tensor route copied {times10['tensor'][2]} numbers to the host")
    nt_main = iplan.enc.nt
    lat_main = dt.latents_on_card(x_main, nt_main, dev)
    starts_main = np.arange(0, N, 1 << 20)
    screen = time_ms(lambda: dt._screen_int_mult(lat_main, nt_main, [1 << 20] * (N >> 20), starts_main), runs=3,
                     warmup=1)
    idx_main = np.concatenate([dt.sampling.choose_sample_indices(1 << 20) + st for st in starts_main])
    mode_s = lat_main[torch.from_numpy(idx_main).to(dev)]
    m_s = len(idx_main) // (N >> 20)
    gcd_t = time_ms(lambda: dt.phase_int_gcd(mode_s, np.arange(0, len(idx_main), m_s), [m_s] * (N >> 20)), runs=3,
                    warmup=1)
    print(f"resident: main path, IntMult screening on the card (no host copy) {screen[0]:.2f} ms a plan (min "
          f"{screen[1]:.2f}, max {screen[2]:.2f}, 3 runs), of it phase_int_gcd (the triple GCDs' loop, "
          f"{len(idx_main) // 3} triples) {gcd_t[0]:.2f} ms [{card}]", flush=True)
    del lat_main, mode_s
    res10 = cd.decode_container_tensor(data, dev)
    if not torch.equal(res10, x_main):  # one bool read back
        raise AssertionError("the 64M image decoded on the card differs from the source tensor")
    del res10
    _, times10c, _ = resident_run(torch, asm, nums, auto_cfg, data_c, 2 << 20, dev, measure_bytes=False)
    print(f"resident: main path at ChunkConfig(), 2M-number chunks: images == the numpy route's bytes; "
          f"{times_line(times10c)}; the 64M image decoded by decode_container_tensor == the source tensor "
          f"(torch.equal on the card) [{card}]", flush=True)
    del x_main, data_c
    for case, (nums10, cfg10, ref10, chunk10) in resident.items():
        x10, t10, m10 = resident_run(torch, asm, nums10, cfg10 or pt.ChunkConfig(), ref10, chunk10, dev)
        print(f"resident: {case} {len(nums10)} {nums10.dtype}: images == the numpy route's bytes; {times_line(t10)}; "
              f"{moved_line(m10, nums10.nbytes)} [{card}]", flush=True)
        del x10
    del resident
    torch.cuda.empty_cache()
    print(f"resident: phase {time.time() - t_ph:.1f} s [{card}]", flush=True)

    # 11. decode and encode sharded over a list of devices
    from pcodec_tpu_torch.parallel import sharding as sh

    t_ph = time.time()
    single = cd.decode_container_tensor(data, dev, plan)
    dec11, enc11, sharded11 = sharded_phase(torch, pt, kernels, asm, cd, ce, sh, plan, iplan, data, single, dev, card)
    del single
    print(f"sharded: phase {time.time() - t_ph:.1f} s [{card}]", flush=True)

    # 12. the CLI's bench on the card, the C ABI and the Java binding's JNI source
    t_ph = time.time()
    bench_phase(nums, data, card)
    capi_phase(torch, kernels, card)
    print(f"bench/capi: phase {time.time() - t_ph:.1f} s [{card}]", flush=True)

    rows = [
        {"name": "section_gather", "route": "cuda", "source": "pcodec_tpu_torch/csrc/section_gather.cu",
         "replaces": "pcodec_tpu/ops/pallas_decode.py:132", "launches": dec_launches["section_gather"],
         "max_abs_err": k1_err, "ms": k1[0], "plain_ms": k1_plain[0], "bound_ms": k1_bound,
         "bound_by": "bytes", "library_ms": k1_lib[0],
         "sharded": {"launches": dec11["section_gather"], **sharded11}},
        {"name": "chain_decode", "route": "cuda", "source": "pcodec_tpu_torch/csrc/chain_decode.cu",
         "replaces": "pcodec_tpu/ops/pallas_decode.py:222", "launches": dec_launches["chain_decode"],
         "max_abs_err": k2_err, "ms": k2[0], "plain_ms": k2_plain[0], "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None, "device_ms": k2_alone, "status": "redesigned",
         "sharded": {"launches": dec11["chain_decode"], **sharded11}},
        {"name": "bin_ans_encode", "route": "cuda", "source": "pcodec_tpu_torch/csrc/bin_ans_encode.cu",
         "replaces": "pcodec_tpu/ops/pallas_encode.py:142", "launches": enc_launches["bin_ans_encode"],
         "max_abs_err": st["err"]["bin_ans_encode"], "ms": k5[0], "plain_ms": k5_plain[0], "bound_ms": k5_bound,
         "bound_by": k5_by, "library_ms": None, "device_ms": k5_alone, "status": "redesigned",
         "sharded": {"launches": enc11["bin_ans_encode"], **sharded11}},
        {"name": "section_pack", "route": "cuda", "source": "pcodec_tpu_torch/csrc/section_pack.cu",
         "replaces": "pcodec_tpu/ops/pallas_encode.py:268", "launches": enc_launches["section_pack"],
         "max_abs_err": st["err"]["section_pack"], "ms": k6[0], "plain_ms": k6_plain[0], "bound_ms": k6_bound,
         "bound_by": k6_by, "library_ms": None, "device_ms": k6_alone, "status": "redesigned",
         "sharded": {"launches": enc11["section_pack"], **sharded11},
         "multivar": {k: multi_rows["intmult_i64_timestamps"][k] for k in ("n", "k6_ms", "k6_device_ms",
                                                                           "k6_bound_ms")}},
        {"name": "image_stitch", "route": "cuda", "source": "pcodec_tpu_torch/csrc/image_stitch.cu",
         "replaces": "pcodec_tpu/ops/assemble.py:495", "launches": enc_launches["image_stitch"],
         "max_abs_err": st["err"]["image_stitch"], "ms": k7[0], "plain_ms": k7_plain[0], "bound_ms": k7_bound,
         "bound_by": "bytes", "library_ms": None, "device_ms": k7_alone, "status": "redesigned",
         "multivar": {k: multi_rows["intmult_i64_timestamps"][k] for k in ("n", "k7_ms", "k7_bound_ms")}},
        {"name": "row_sort", "route": "cuda", "source": "pcodec_tpu_torch/csrc/row_sort.cu",
         "replaces": "pcodec_tpu/ops/pallas_sort.py:49", "launches": enc_launches["row_sort"],
         "max_abs_err": train_err, "ms": k8[0], "plain_ms": k8_plain[0], "bound_ms": k8_bound,
         "bound_by": k8_by, "library_ms": k8_lib[0], "span_launches": enc_launches["row_sort_span"],
         "train_modes": {case: {k: r[k] for k in ("rows_of", "rows", "cols", "ms", "plain_ms", "library_ms",
                                                  "bound_ms")} | {"launches": r["launches"]["row_sort"]}
                         for case, r in train_rows.items()}},
        {"name": "histogram_walk", "route": "cuda", "source": "pcodec_tpu_torch/csrc/histogram_walk.cu",
         "replaces": "pcodec_tpu/ops/pallas_walk.py:40", "launches": enc_launches["histogram_walk"],
         "max_abs_err": train_err, "ms": k9[0], "plain_ms": k9_plain[0], "bound_ms": k9_bound,
         "bound_by": k9_by, "library_ms": None, "device_ms": k9_alone, "status": "redesigned",
         "longest_lane_steps": lane_steps[long9], "longest_lane_ms": k9_lane,
         "train_modes": {case: {"lanes": r["lanes"], "nb_logs": r["nb_logs"], "ms": r["walk_ms"],
                                "plain_ms": r["walk_plain_ms"], "launches": r["launches"]["histogram_walk"]}
                         for case, r in train_rows.items()}},
        {"name": "lookback_recon", "route": "cuda", "source": "pcodec_tpu_torch/csrc/lookback_recon.cu",
         "replaces": "pcodec_tpu/ops/pallas_decode.py:1242", **breadth_rows["lookback_recon"],
         "status": "redesigned"},
        {"name": "dict_join", "route": "cuda", "source": "pcodec_tpu_torch/csrc/dict_join.cu",
         "replaces": "pcodec_tpu/ops/pallas_decode.py:1450", **breadth_rows["dict_join"]},
        {"name": "lookback_choose", "route": "cuda", "source": "pcodec_tpu_torch/csrc/lookback_choose.cu",
         "replaces": "pcodec_tpu/ops/device_train.py:745", "launches": b5["launches"], "max_abs_err": b5["err"],
         "ms": b5["ms"], "plain_ms": b5["plain_ms"], "bound_ms": b5["bound_ms"], "bound_by": b5["bound_by"],
         "library_ms": None, "device_ms": b5["device_ms"],
         **{k: b5[k] for k in ("pages", "page_n", "plain_pages", "two_chunks_ms", "one_page_ms", "one_page_steps",
                               "hash_reads_ms", "chain_ms", "resident_pages")}},
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
                     "timed_runs": r["timed_runs"], "launches_all_shapes": exp_launches[name],
                     **{k: r[k] for k in ("device_ms", "library_device_ms", "step_loop_bound_ms", "long_rows",
                                          "colsum_ms", "tile_ms", "colsum_route", "one_row_ms", "rows_per_block",
                                          "take_route") if k in r}})
    print(f"wall: {time.time() - t_wall:.1f} s from the start of main [{card}]", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def lookback_decode_only() -> int:
    """The 32M lookback decode of phase 5b alone, through the entry points
    every tree of the port has (container_compress, plan_container,
    upload_plan, decode_plan): compared with the source, then a call's and
    the card's time and what torch.profiler counts in one decode."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import pcodec_tpu_torch as pt
    from pcodec_tpu_torch.ops import container_decode as cd
    from pcodec_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    card = card_line()
    case, nums, cfg, _ = matrix_inputs(pt)[0]
    data = pt.container_compress(nums, cfg)
    plan = cd.plan_container(data)
    arrays = cd.upload_plan(plan, dev)
    src = torch.from_numpy(nums).to(dev)
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    res = cd.decode_plan(plan, arrays)
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    if not torch.equal(res, src):
        raise AssertionError(f"{case}: decode differs at {int((res != src).sum())} of {len(nums)} numbers")
    del res, src
    t = time_ms(lambda: cd.decode_plan(plan, arrays))
    alone = time_ms(lambda: cd.decode_plan(plan, arrays), hold=True)[0]
    counted = profiled_kernels(torch, lambda: cd.decode_plan(plan, arrays))
    print(f"lookback-decode: {case} ({len(nums)} i64, {len(plan.chunks)} chunks) == source, launches {launches}; "
          f"decode {t[0]:.3f} ms median (min {t[1]:.3f}, max {t[2]:.3f}, {RUNS} runs), card alone (hold) "
          f"{alone:.4f} ms; one decode runs {kernels_line(counted)} [{card}]", flush=True)
    return 0


def profiled_functions(fn, top=14) -> str:
    """The package's functions under cProfile in one call of fn, the card
    synchronised at its end: name, calls and cumulative host seconds of the
    top ones."""
    import cProfile
    import pstats

    import torch

    prof = cProfile.Profile()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    rows = [(ct, nc, f"{fname.split('pcodec_tpu_torch/')[-1]}:{line}({name})")
            for (fname, line, name), (_, nc, _, ct, _) in pstats.Stats(prof).stats.items()
            if "pcodec_tpu_torch" in fname or name.startswith("<method") or name.startswith("<built-in")]
    return "; ".join(f"{label} x{nc} {ct:.4f}" for ct, nc, label in sorted(rows, reverse=True)[:top])


def train_only() -> int:
    """The device training of the main path's 64M numbers (phase 5's
    configuration), of phase 8's intmult_i64_timestamps (32M, auto mode)
    and of its wrapped_lookback_multipage (32M, TRY_LOOKBACK) alone, through
    plan_encode_device where the tree's device_train_supported covers the
    configuration, else the host training plan_encode (a tree without
    lookback training on the card): a call's host seconds, the card
    synchronised, median (min, max) of RUNS calls after a warm-up, and
    where it trained."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import pcodec_tpu_torch as pt
    from pcodec_tpu_torch.dtypes import number_type_from_np
    from pcodec_tpu_torch.ops import container_encode as ce
    from pcodec_tpu_torch.ops import device_train as dt

    dev = torch.device("cuda")
    card = card_line()
    inputs = standalone_inputs(pt)
    for case, nums, cfg in (("main", make_data(), cfg_of(pt, 1)),
                            ("intmult_i64_timestamps", inputs.pop("intmult_i64_timestamps")[0], None),
                            ("wrapped_lookback_multipage", *inputs.pop("wrapped_lookback_multipage"))):
        nt = number_type_from_np(nums.dtype)
        train = (dt.plan_encode_device if dt.device_train_supported(nt, cfg or pt.ChunkConfig(), 1024, 1 << 20)
                 else ce.plan_encode)
        plan = train(nums, cfg, 1024, 1 << 20, dev)
        secs = []
        for _ in range(RUNS):
            torch.cuda.synchronize()
            t0 = time.time()
            train(nums, cfg, 1024, 1 << 20, dev)
            torch.cuda.synchronize()
            secs.append(time.time() - t0)
        print(f"train: {case}: {len(nums)} {nums.dtype} trained on the {plan.trained_on} by {dt.__file__}: "
              f"{train.__name__} {sorted(secs)[len(secs) // 2]:.3f} s median (min {min(secs):.3f}, max "
              f"{max(secs):.3f}, {RUNS} runs) [{card}]", flush=True)
        print(f"train: {case}: one call's functions of the package by cumulative host seconds (cProfile): "
              f"{profiled_functions(lambda: train(nums, cfg, 1024, 1 << 20, dev))}", flush=True)
        del plan, nums
    return 0


def sharded_only() -> int:
    """Phase 11 alone (sharded_phase): the main path's numbers encoded on
    the card (encode_container_device, whose bytes phase 5 holds against
    container_compress in every run), that container decoded and its
    image encoded sharded, each against the single-device path."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import pcodec_tpu_torch as pt
    from pcodec_tpu_torch.ops import assemble as asm
    from pcodec_tpu_torch.ops import container_decode as cd
    from pcodec_tpu_torch.ops import container_encode as ce
    from pcodec_tpu_torch.ops import kernels
    from pcodec_tpu_torch.parallel import sharding as sh

    dev = torch.device("cuda")
    card = card_line()
    n_cards = torch.cuda.device_count()
    names = sorted({torch.cuda.get_device_name(i) for i in range(n_cards)})
    print(f"sharded: {n_cards} card(s) {names} [{card}]", flush=True)
    kernels.build()
    nums = make_data()
    cfg = pt.ChunkConfig(delta_spec=pt.DeltaSpec(pt.DeltaSpec.TRY_CONSECUTIVE, 1))
    data = pt.encode_container_device(nums, cfg, 1024, 1 << 20, device=dev)
    plan = cd.plan_container(data)
    iplan = asm.plan_image(nums, cfg, 1024, 1 << 20, dev)
    single = cd.decode_container_tensor(data, dev, plan)
    if not torch.equal(single, torch.from_numpy(nums).to(dev)):
        raise AssertionError("the single-device decode differs from the source")
    sharded_phase(torch, pt, kernels, asm, cd, ce, sh, plan, iplan, data, single, dev, card)
    return 0


if __name__ == "__main__":
    modes = {"--lookback-decode": lookback_decode_only, "--train": train_only, "--sharded": sharded_only}
    sys.exit(modes[sys.argv[1]]() if sys.argv[1:2] and sys.argv[1] in modes else main())
