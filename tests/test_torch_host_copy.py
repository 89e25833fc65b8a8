"""The port's copy of the host layer against the JAX package's.

pcodec_tpu_torch carries its own copy of the framework-free host modules.
Its container encoder must write exactly the bytes of pcodec_tpu's, and its
host decoder must return exactly the same numbers. The port itself imports
neither JAX nor anything of pcodec_tpu.
"""

import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import pcodec_tpu.codec.container as ref_container
from pcodec_tpu.codec.chunk_config import ChunkConfig as RefChunkConfig
from pcodec_tpu.codec.chunk_config import DeltaSpec as RefDeltaSpec
from pcodec_tpu.codec.chunk_config import ModeSpec as RefModeSpec

import pcodec_tpu_torch as pt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(7)
N = 3000


def _cases():
    t = np.arange(N)
    walk = np.cumsum(RNG.integers(0, 120, N)).astype(np.int64)
    return {
        "i64_consecutive1": (walk, ("try_consecutive", 1), "auto", 256),
        "u64_auto": (walk.astype(np.uint64), ("auto", 0), "auto", 1024),
        "i32_consecutive2": ((walk % 50000).astype(np.int32), ("try_consecutive", 2), "auto", 256),
        "f64_auto": ((RNG.integers(-5000, 5000, N) * 0.01).astype(np.float64), ("auto", 0), "auto", 512),
        "f32_classic": (RNG.standard_normal(N).astype(np.float32), ("no_op", 0), "classic", 256),
        "u16_auto": (RNG.integers(0, 60000, N).astype(np.uint16), ("auto", 0), "auto", 256),
        "f16_auto": (np.sin(0.01 * t).astype(np.float16), ("auto", 0), "auto", 256),
        "i64_dict": (np.array([3, 99, 1234567, -5], np.int64)[RNG.integers(0, 4, N)],
                     ("no_op", 0), "try_dict", 256),
        "i64_lookback": (np.tile(RNG.integers(0, 10**6, 300), N // 300 + 1)[:N].astype(np.int64),
                         ("try_lookback", 0), "auto", 256),
    }


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_container_bytes_and_host_decode_match_reference(name):
    """Exact: identical container bytes, identical decoded bits."""
    nums, (dkind, dorder), mkind, page_n = CASES[name]
    ref_cfg = RefChunkConfig(mode_spec=RefModeSpec(mkind), delta_spec=RefDeltaSpec(dkind, dorder))
    cfg = pt.ChunkConfig(mode_spec=pt.ModeSpec(mkind), delta_spec=pt.DeltaSpec(dkind, dorder))
    ref = ref_container.container_compress(nums, ref_cfg, page_n=page_n, chunk_n=2048)
    ours = pt.container_compress(nums, cfg, page_n=page_n, chunk_n=2048)
    assert ours == ref
    ref_out = ref_container.container_decompress(ref)
    out = pt.container_decompress(ours)
    assert out.dtype == ref_out.dtype
    assert np.array_equal(out.view(np.uint8), ref_out.view(np.uint8))
    assert np.array_equal(out.view(np.uint8), nums.view(np.uint8))


@pytest.mark.parametrize("name", ["i64_consecutive1", "f64_auto", "i64_dict", "i64_lookback"])
def test_standalone_bytes_and_host_decode_match_reference(name):
    """The copied codec/standalone.py and standalone.py: identical `.pco`
    bytes, identical decoded bits, through both modules' entry points."""
    import pcodec_tpu.standalone as ref_standalone
    from pcodec_tpu.codec import standalone as ref_codec_standalone

    import pcodec_tpu_torch.standalone as port_standalone
    from pcodec_tpu_torch.codec import standalone as port_codec_standalone

    nums, (dkind, dorder), mkind, _ = CASES[name]
    ref_cfg = RefChunkConfig(mode_spec=RefModeSpec(mkind), delta_spec=RefDeltaSpec(dkind, dorder))
    cfg = pt.ChunkConfig(mode_spec=pt.ModeSpec(mkind), delta_spec=pt.DeltaSpec(dkind, dorder))
    ref = ref_codec_standalone.simple_compress(nums, ref_cfg)
    ours = port_codec_standalone.simple_compress(nums, cfg)
    assert ours == ref == port_standalone.simple_compress(nums, cfg)
    out, nt = port_codec_standalone.simple_decompress(ours)
    assert nt.name == ref_codec_standalone.simple_decompress(ref)[1].name
    assert np.array_equal(out.view(np.uint8), nums.view(np.uint8))
    flat = port_standalone.simple_decompress(ours)
    assert np.array_equal(flat.view(np.uint8), ref_standalone.simple_decompress(ref).view(np.uint8))
    assert port_standalone.header_size() == ref_standalone.header_size()


def _reference_top_level_names():
    """The public names pcodec_tpu/__init__.py binds, read from its source."""
    tree = ast.parse(open(os.path.join(REPO, "pcodec_tpu", "__init__.py")).read())
    names = []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
    return names


@pytest.mark.parametrize("name", _reference_top_level_names())
def test_port_namespace_has_every_reference_top_level_name(name):
    """`from pcodec_tpu_torch import <name>` works for every public name of
    the JAX package's top level, and names the port's own object: a module
    or a function or class of pcodec_tpu_torch, or an equal constant."""
    import pcodec_tpu

    ours, ref = getattr(pt, name), getattr(pcodec_tpu, name)
    if isinstance(ours, type(os)):
        assert ours.__name__ == ref.__name__.replace("pcodec_tpu", "pcodec_tpu_torch", 1)
    elif callable(ours):
        assert ours.__module__.split(".")[0] == "pcodec_tpu_torch" and ours.__qualname__ == ref.__qualname__
    else:
        assert ours == ref


def _forbidden(mod: str) -> bool:
    return mod.split(".")[0] in ("jax", "jaxlib", "pcodec_tpu")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "pcodec_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_port_sources_import_no_jax_and_no_reference_package():
    files = _port_files()
    assert any(f.endswith("chip_smoke.py") for f in files) and len(files) > 20
    for name in ("cli.py", "inspect_mod.py", "entry.py", "__main__.py", "capi.py", "legacy/qco.py",
                 "legacy/__init__.py", "native/capi_build.py"):
        assert os.path.join(REPO, "pcodec_tpu_torch", name) in files
    bad = []
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(path, a.name) for a in node.names if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and _forbidden(node.module or ""):
                bad.append((path, node.module))
    assert not bad, bad


def test_importing_port_loads_no_jax_and_no_reference_package():
    code = (
        "import sys; before = set(sys.modules)\n"
        "import pcodec_tpu_torch, pcodec_tpu_torch.ops.container_decode\n"
        "from pcodec_tpu_torch import PagingSpec, PcoError, __version__, guarantee, simple_compress\n"
        "import pcodec_tpu_torch.ops.container_encode, pcodec_tpu_torch.ops.assemble\n"
        "import pcodec_tpu_torch.ops.row_sort, pcodec_tpu_torch.ops.decode, pcodec_tpu_torch.ops.softfloat\n"
        "import pcodec_tpu_torch.ops.device_train\n"
        "from pcodec_tpu_torch.experiments import micro_gather, pallas_bitonic, proto_dma, proto_realign\n"
        "from pcodec_tpu_torch.experiments import proto_round_loop\n"
        "from pcodec_tpu_torch.codec import compress, decompress, standalone\n"
        "import pcodec_tpu_torch.standalone, pcodec_tpu_torch.ops.standalone_decode\n"
        "import pcodec_tpu_torch.cli, pcodec_tpu_torch.inspect_mod, pcodec_tpu_torch.entry\n"
        "import pcodec_tpu_torch.capi, pcodec_tpu_torch.legacy, pcodec_tpu_torch.native.capi_build\n"
        "new = sorted(m for m in set(sys.modules) - before "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'pcodec_tpu'))\n"
        "print(new); sys.exit(1 if new else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_native_and_java_sources_name_no_reference_module():
    """The port's C, C++ and Makefile sources (the C ABI shim, its test
    program, the JNI shim) name no module of the JAX package: the shim
    imports pcodec_tpu_torch.capi, and every include and build rule points
    into pcodec_tpu_torch/."""
    files = []
    for root, _, names in os.walk(os.path.join(REPO, "pcodec_tpu_torch")):
        files += [os.path.join(root, n) for n in names
                  if n.endswith((".cpp", ".c", ".h", ".cu")) or n == "Makefile"]
    names = {os.path.relpath(f, os.path.join(REPO, "pcodec_tpu_torch")) for f in files}
    assert {"native/cpcodec.cpp", "native/cpcodec.h", "native/test_cpcodec.c", "java/Makefile",
            "java/jni/pco_jni.cpp"} <= names
    bad = [(f, m) for f in files for m in re.findall(r"\bpcodec_tpu\.\w+|\bjax\w*", open(f).read())]
    assert not bad, bad
    shim = open(os.path.join(REPO, "pcodec_tpu_torch", "native", "cpcodec.cpp")).read()
    assert 'PyImport_ImportModule("pcodec_tpu_torch.capi")' in shim
