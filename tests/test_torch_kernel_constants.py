"""The port's Python constants that must equal a kernel source's own.

Each is read out of its `constexpr` in `pcodec_tpu_torch/csrc/*.cu`, so a
change to one side alone fails here on the CPU. No JAX: runs with
`--noconftest`.
"""

import os
import re

import pytest

from pcodec_tpu_torch import constants
from pcodec_tpu_torch.experiments import micro_gather, pallas_bitonic, proto_dma
from pcodec_tpu_torch.ops import assemble, decode, device_train, kernels, row_sort

_CONSTEXPR = re.compile(r"constexpr\s+[\w ]+?\s+(\w+)\s*=\s*([^;]+);")


def _cu_constants(name: str) -> dict:
    """The integer `constexpr`s of csrc/<name>.cu, each evaluated from the
    ones above it (casts and integer suffixes dropped; those that do not
    evaluate, such as sizeof expressions, left out)."""
    with open(os.path.join(kernels._CSRC, name + ".cu")) as f:
        src = f.read()
    vals = {}
    for cname, expr in _CONSTEXPR.findall(src):
        expr = re.sub(r"\((?:long long|unsigned|size_t|int)\)", "", expr)
        expr = re.sub(r"(?<=[0-9])(?:ull|ll|u)\b", "", expr)
        try:
            vals[cname] = int(eval(expr, {"__builtins__": {}}, dict(vals)))
        except (NameError, SyntaxError, TypeError):
            pass
    return vals


@pytest.mark.parametrize("source,name,value", [
    ("chain_decode", "CHAINS_PER_BLOCK", kernels.CHAINS_PER_BLOCK),
    ("bin_ans_encode", "CHAINS_PER_GROUP", kernels.CHAINS_PER_BLOCK),
    ("bin_ans_encode", "TILE_ROUNDS", kernels.K5_TILE_ROUNDS),
    ("lookback_recon", "SMEM_MAX_N", kernels.LB_SMEM_MAX_N),
    ("lookback_recon", "MAX_BASES", kernels.LB_MAX_BASES),
    ("lookback_recon", "DESC_COLS", decode.LB_DESC_COLS),
    ("lookback_recon", "JOIN_LATENTS", decode.JOIN_LATENTS),
    ("lookback_recon", "JOIN_UNSIGNED", decode.JOIN_UNSIGNED),
    ("lookback_recon", "JOIN_SIGNED", decode.JOIN_SIGNED),
    ("lookback_recon", "JOIN_FLOAT", decode.JOIN_FLOAT),
    ("row_sort", "TILE", row_sort.RADIX_TILE),
    ("row_sort", "BITS", row_sort.RADIX_BITS),
    ("image_stitch", "SCAN_THREADS", kernels.K7_SCAN_PAGES),
    ("image_stitch", "MAX_VARS", kernels.K6_MAX_VARS),
    ("section_pack", "MAX_VARS", kernels.K6_MAX_VARS),
    ("histogram_walk", "NB_LOG_MAX", device_train.WALK_NB_LOG_MAX),
    ("histogram_walk", "X_BITS", device_train.WALK_X_BITS),
    ("histogram_walk", "NARROW_BITS", device_train.WALK_NARROW_BITS),
    ("lookback_choose", "SMEM_MAX_N", kernels.LB_CHOOSE_SMEM_MAX_N),
    ("lookback_choose", "WINDOW_N_LOG_MAX", constants.LOOKBACK_MAX_WINDOW_N_LOG),
    ("lookback_choose", "HASH_SLOTS", device_train.LOOKBACK_HASH_SLOTS),
    ("lookback_choose", "POS_BITS", (kernels.LB_CHOOSE_SMEM_MAX_N - 1).bit_length()),
    ("bitonic_cluster", "KEYS", pallas_bitonic.SET_KEYS),
    ("bitonic_cluster", "TILE_LOG", pallas_bitonic.TILE_KEYS.bit_length() - 1),
    ("bitonic_cluster", "BLOCK_LOG", pallas_bitonic.BLOCK_KEYS.bit_length() - 1),
    ("bitonic_cluster", "MAX_CLUSTER", pallas_bitonic.MAX_CLUSTER),
    ("bitonic_cluster", "MAX_LOG", pallas_bitonic.MAX_KEYS.bit_length() - 1),
    ("proto_dma", "N_CHAINS", proto_dma.N_CHAINS),
    ("proto_dma", "FETCH_WORDS", proto_dma.FETCH_WORDS),
    ("proto_dma", "BLOCK_WORDS", proto_dma.BLOCK_WORDS),
    ("micro_gather", "TAKE_ROWS", micro_gather.TAKE_ROWS),
    ("micro_gather", "TAA_WARPS", micro_gather.TAA_WARPS),
    ("micro_gather", "ROW_LANE_MAX", micro_gather.ROW_LANE_MAX),
])
def test_python_constant_equals_kernel_source(source, name, value):
    assert _cu_constants(source)[name] == value


def test_k3_descriptor_columns_follow_the_kernel_enum():
    """K3's descriptor columns (decode.LB_COLS) in the order of
    csrc/lookback_recon.cu's `enum Col`."""
    with open(os.path.join(kernels._CSRC, "lookback_recon.cu")) as f:
        body = re.search(r"enum Col \{([^}]*)\}", f.read()).group(1)
    assert [name.strip().lower() for name in body.split(",") if name.strip()] == list(decode.LB_COLS)


def test_k7_descriptor_columns_follow_the_kernel_enum():
    """K7's descriptor columns (assemble.IMAGE_COLS) in the order of
    csrc/image_stitch.cu's `enum Col`, whose last member counts them."""
    with open(os.path.join(kernels._CSRC, "image_stitch.cu")) as f:
        body = re.search(r"enum Col \{([^}]*)\}", f.read()).group(1)
    assert [name.strip().lower() for name in body.split(",") if name.strip()] == list(assemble.IMAGE_COLS) + ["cols"]
