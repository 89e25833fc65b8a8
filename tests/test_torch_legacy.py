"""The port's copy of the legacy qcompress (`.qco`) codec against the JAX
package's: on the same seeded numbers, `pcodec_tpu_torch.legacy` must write
exactly the bytes of `pcodec_tpu.legacy` and decode exactly its numbers.
qco is host code in both packages (the `bench` CLI's codec `qco`)."""

import numpy as np
import pytest
import torch

import pcodec_tpu.legacy as ref
from pcodec_tpu.errors import PcoError as RefPcoError

import pcodec_tpu_torch.legacy as port
from pcodec_tpu_torch.errors import PcoError

torch.set_num_threads(1)  # the test workers share the cores: more intra-op threads spin on theirs

N = 3000
TYPES = {"i32": np.int32, "i64": np.int64, "u16": np.uint16, "f32": np.float32, "f64": np.float64}


def _numbers(name: str, n: int = N) -> np.ndarray:
    rng = np.random.default_rng(sum(map(ord, name)))
    dt = np.dtype(TYPES[name])
    if dt.kind == "f":
        return np.cumsum(rng.normal(0, 1, n)).astype(dt)
    if dt == np.uint16:
        return (rng.integers(0, 600, n) * 7).astype(dt)
    return (np.cumsum(rng.integers(-5, 9, n)) * 3).astype(dt)


def _cases():
    cases = {}
    for name in TYPES:
        for order in (0, 1, 2):
            for gcds in (True, False):
                cases[f"{name}_order{order}_{'gcd' if gcds else 'nogcd'}"] = (
                    "qco", _numbers(name), {"delta_order": order, "use_gcds": gcds})
    cases["i64_empty"] = ("qco", np.zeros(0, np.int64), {})
    cases["i32_tiny_order2"] = ("qco", np.arange(3, dtype=np.int32), {"delta_order": 2})
    cases["i64_one"] = ("qco", np.array([42], np.int64), {})
    for level in (0, 12):
        cases[f"i64_level{level}"] = ("qco", _numbers("i64"), {"level": level, "delta_order": 1})
    for name in ("i64", "f32"):
        cases[f"auto_{name}"] = ("auto", _numbers(name), {})
        cases[f"wrapped_{name}"] = ("wrapped", _numbers(name), {"delta_order": 1, "sizess": [[1500, 500], [1000]]})
    return cases


CASES = _cases()
CODECS = {"qco": ("qco_compress", "qco_decompress"), "auto": ("auto_compress", "auto_decompress"),
          "wrapped": ("wrapped_compress", "wrapped_decompress")}


def _bits(x: np.ndarray) -> np.ndarray:
    return x.view(np.uint8)


@pytest.mark.parametrize("case", sorted(CASES))
def test_qco_bytes_and_decode_equal_the_jax_package(case):
    """Exact: identical `.qco` bytes, identical decoded bits and dtype name,
    both equal to the source."""
    codec, nums, kw = CASES[case]
    comp, decomp = CODECS[codec]
    blob = getattr(port, comp)(nums, **kw)
    assert blob == getattr(ref, comp)(nums, **kw)
    got, dtype = getattr(port, decomp)(blob)
    want, ref_dtype = getattr(ref, decomp)(blob)
    assert dtype == ref_dtype and got.dtype == want.dtype == nums.dtype
    assert np.array_equal(_bits(got), _bits(want)) and np.array_equal(_bits(got), _bits(nums))


def test_truncated_qco_raises_the_jax_package_class():
    """Each cut of a file raises the same error class in both packages, or
    decodes to the same numbers in both."""
    blob = ref.qco_compress(_numbers("i64", 2000), delta_order=1)
    for cut in list(range(0, 24)) + list(range(24, len(blob), max(1, len(blob) // 40))):
        outcome = []
        for mod, err in ((port, PcoError), (ref, RefPcoError)):
            try:
                outcome.append(_bits(mod.qco_decompress(blob[:cut])[0]).tobytes())
            except err as e:
                outcome.append(type(e).__name__)
        assert outcome[0] == outcome[1], cut
