"""The port's Python constants that must equal a kernel source's own.

Each is read out of its `constexpr` in `pcodec_tpu_torch/csrc/*.cu`, so a
change to one side alone fails here on the CPU. No JAX: runs with
`--noconftest`.
"""

import os
import re

import pytest

from pcodec_tpu_torch.ops import kernels, row_sort

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
    ("row_sort", "TILE", row_sort.RADIX_TILE),
    ("row_sort", "BITS", row_sort.RADIX_BITS),
])
def test_python_constant_equals_kernel_source(source, name, value):
    assert _cu_constants(source)[name] == value
