"""The port's decode and encode sharded over a list of devices
(pcodec_tpu_torch/parallel/sharding.py) against the JAX package.

On the CPU every shard runs the kernels' plain versions on its own device
entry (["cpu"] * k); the shards are cut, uploaded and gathered as on cards.
The sharded decode equals pcodec_tpu's container_decompress and the source,
the sharded encode pcodec_tpu's container_compress bytes, on the JAX dry
run's seven mode and delta families and on tests/test_sharding.py's inputs
(which hold JAX's own sharded functions to the same host bytes and
numbers; the direct comparison with them, ~140 s of Pallas interpret mode,
is the `slow` test at the end). Inputs come from numpy with a seed; every
comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax

from pcodec_tpu import ChunkConfig as RefChunkConfig
from pcodec_tpu import DeltaSpec as RefDeltaSpec
from pcodec_tpu import PagingSpec as RefPagingSpec
from pcodec_tpu import simple_compress as ref_simple_compress
from pcodec_tpu import simple_decompress as ref_simple_decompress
from pcodec_tpu.codec.container import container_compress as ref_compress
from pcodec_tpu.codec.container import container_decompress as ref_decompress

from pcodec_tpu_torch import ChunkConfig
from pcodec_tpu_torch.entry import DRYRUN_CHUNK_N, DRYRUN_PAGE_N, dryrun_cases, dryrun_multichip
from pcodec_tpu_torch.ops import container_decode as cd
from pcodec_tpu_torch.parallel import sharding as sh

torch.set_num_threads(1)  # the test workers share the cores: more intra-op threads spin on theirs

CPU = "cpu"


def _ref_config(cfg: ChunkConfig) -> RefChunkConfig:
    """The JAX package's config of a port config of the dry run."""
    from pcodec_tpu import ModeSpec as RefModeSpec

    ms, ds = cfg.mode_spec, cfg.delta_spec
    return RefChunkConfig(mode_spec=RefModeSpec(ms.kind, ms.value), delta_spec=RefDeltaSpec(ds.kind, ds.order))


DRY = dryrun_cases(3)


@pytest.mark.parametrize("case", list(DRY))
def test_sharded_decode_matches_host_codec(case):
    """sharded_container_decode over 1, 3 and 8 CPU shards equals
    pcodec_tpu's container_decompress and the source bit for bit, on the
    dry run's families in 1,024-number chunks (one K2 block of a var a
    chunk, so 3 shards each hold one)."""
    nums, cfg = DRY[case]
    data = ref_compress(nums, _ref_config(cfg), page_n=DRYRUN_PAGE_N, chunk_n=DRYRUN_CHUNK_N)
    want = ref_decompress(data)
    for k in (1, 3, 8):
        got = sh.sharded_container_decode(data, [CPU] * k)
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), k
        assert np.array_equal(got.view(np.uint8), nums.view(np.uint8)), k


def test_sharded_decode_of_the_jax_sharding_test_inputs():
    """The 20,000-number container of tests/test_sharding.py (seed 3,
    order-1 delta, default pages) decodes over 8 CPU shards to the
    numbers JAX's sharded_container_decode is held to there; so does its
    all-modes test's IntMult container at page_n 256."""
    rng = np.random.default_rng(3)
    nums = np.cumsum(rng.integers(0, 3000, 20_000)).astype(np.int64)
    data = ref_compress(nums, RefChunkConfig(delta_spec=RefDeltaSpec(RefDeltaSpec.TRY_CONSECUTIVE, 1)))
    assert np.array_equal(sh.sharded_container_decode(data, [CPU] * 8), nums)
    rng = np.random.default_rng(5)
    y = (rng.integers(0, 5000, 8192) * 1000 + rng.integers(0, 3, 8192)).astype(np.int64)
    assert np.array_equal(sh.sharded_container_decode(ref_compress(y, None, page_n=256), [CPU] * 8), y)


def test_sharded_encode_of_the_jax_sharding_test_input():
    """tests/test_sharding.py's encode input (seed 11, page_n 256,
    8,192-number chunks) encodes over 8 CPU shards to pcodec_tpu's
    container_compress bytes, the bytes JAX's sharded_container_encode is
    held to there, with its device_chunks (3); each shard holds whole
    blocks of chains, the shards in order cover the launch."""
    rng = np.random.default_rng(11)
    x = np.cumsum(rng.integers(0, 120, 20000)).astype(np.int64)
    enc, stats = sh.sharded_container_encode(x, None, [CPU] * 8, page_n=256, chunk_n=8192)
    assert enc == ref_compress(x, None, page_n=256, chunk_n=8192)
    assert stats["device_chunks"] == 3 and stats["trained_on"] == "device"
    spans = [s["chains"] for s in stats["shards"]]
    assert len(spans) > 1 and spans[0][0] == 0
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert all(c0 % cd.CHAINS_PER_BLOCK == 0 and c1 % cd.CHAINS_PER_BLOCK == 0 for c0, c1 in spans)


def test_sharded_encode_device_chunks_leave_out_trivial_chunks():
    """device_chunks counts the chunks whose pages the card codes, as JAX's
    chunk plan (pallas_encode._plan_encode, host training, no kernel) does
    for single-var chunks: a constant chunk is trivial and left out, a
    fallback chunk of random bits is coded; the bytes over 3 shards equal
    pcodec_tpu's container_compress."""
    from pcodec_tpu.ops.pallas_encode import _plan_encode

    rng = np.random.default_rng(12)
    x = np.concatenate([np.cumsum(rng.integers(0, 120, 8192)), np.full(8192, 7),
                        rng.integers(-(2**63), 2**63 - 1, 8192, dtype=np.int64),
                        np.cumsum(rng.integers(0, 120, 3000))]).astype(np.int64)
    enc, stats = sh.sharded_container_encode(x, None, [CPU] * 3, page_n=256, chunk_n=8192)
    assert enc == ref_compress(x, None, page_n=256, chunk_n=8192)
    kinds = [k for k, _ in _plan_encode(x, None, 256, 8192)[3]]
    assert kinds == ["device", "host", "device", "device"]
    assert stats["device_chunks"] == kinds.count("device") == 3 and stats["chunks"] == 4


def test_sharded_encode_multivar_cuts_at_chunks():
    """A multi-var launch (IntMult: K6 rows of several vars) is cut only at
    chunk starts: every shard's rows name only its own chains, and the
    bytes over 3 shards equal pcodec_tpu's container_compress."""
    nums, cfg = DRY["intmult_i64"]
    want = ref_compress(nums, _ref_config(cfg), page_n=DRYRUN_PAGE_N, chunk_n=DRYRUN_CHUNK_N)
    enc, stats = sh.sharded_container_encode(nums, cfg, [CPU] * 3, page_n=DRYRUN_PAGE_N, chunk_n=DRYRUN_CHUNK_N)
    assert enc == want
    assert [s["rows"] for s in stats["shards"]] == [(0, 4), (4, 8), (8, 12)]


def test_sharded_decode_standalone_matches_simple_decompress():
    """sharded_decode_standalone over 3 CPU shards equals pcodec_tpu's
    simple_decompress (tests/test_sharding.py's standalone input)."""
    rng = np.random.default_rng(0)
    nums = np.cumsum(rng.integers(0, 50, 16 * 512)).astype(np.int64)
    cfg = RefChunkConfig(delta_spec=RefDeltaSpec(RefDeltaSpec.TRY_CONSECUTIVE, 1),
                         paging_spec=RefPagingSpec.equal_pages_up_to(512))
    data = ref_simple_compress(nums, cfg)
    got = sh.sharded_decode_standalone(data, [CPU] * 3)
    assert np.array_equal(got, ref_simple_decompress(data)[0])
    assert np.array_equal(got, nums)


def test_each_shard_uploads_only_its_chains_words():
    """A shard's uploaded words run from the first word its coded chains
    stage to stage_words past the last one's first, and hold the
    container's words there; the shards of a 3-chunk container together
    upload little more than the container (not a copy a device)."""
    rng = np.random.default_rng(7)
    nums = np.cumsum(rng.integers(0, 3000, 3 * 8192)).astype(np.int64)
    data = ref_compress(nums, RefChunkConfig(delta_spec=RefDeltaSpec(RefDeltaSpec.TRY_CONSECUTIVE, 1)), page_n=256,
                        chunk_n=8192)
    plan = cd.plan_container(data)
    sharded = sh.upload_sharded(plan, [CPU] * 3)
    assert len(sharded.shards) == 3
    total = 0
    for s in sharded.shards:
        cp = plan.launches[s.lkey]
        c0, c1 = s.chains
        coded = cp.body_n[c0:c1] > 0
        lo, hi = s.span
        assert lo == int(cp.word0[c0:c1][coded].min())
        assert hi == int(cp.word0[c0:c1][coded].max()) + cp.stage_words
        w = s.words.numpy().view(np.uint32)
        assert np.array_equal(w[: hi - lo], plan.words[lo:hi]) and not w[hi - lo :].any()
        total += hi - lo
    assert total <= len(data) // 4 + 3 * cp.stage_words
    assert np.array_equal(cd.to_numbers(sh.decode_sharded(plan, sharded), plan.nt), nums)


def test_dryrun_multichip_on_four_cpu_shards():
    """dryrun_multichip(4, devices=["cpu"] * 4) encodes and decodes the
    seven families bit-exactly; without the devices it needs four cards
    (none here)."""
    assert dryrun_multichip(4, devices=[CPU] * 4) == list(dryrun_cases(4))
    with pytest.raises(ValueError):
        dryrun_multichip(4, devices=[CPU] * 3)
    with pytest.raises(RuntimeError):
        dryrun_multichip(4)
    with pytest.raises(RuntimeError):
        sh.make_mesh()


@pytest.mark.slow
def test_sharded_paths_equal_the_jax_sharded_functions():
    """The port's sharded decode and encode against JAX's
    sharded_container_decode and sharded_container_encode themselves on the
    8-device CPU mesh (Pallas in interpret mode, ~140 s): the inputs of
    tests/test_sharding.py."""
    from pcodec_tpu.parallel.sharding import make_mesh, sharded_container_decode, sharded_container_encode

    rng = np.random.default_rng(3)
    nums = np.cumsum(rng.integers(0, 3000, 20_000)).astype(np.int64)
    data = ref_compress(nums, RefChunkConfig(delta_spec=RefDeltaSpec(RefDeltaSpec.TRY_CONSECUTIVE, 1)))
    mesh = make_mesh(jax.devices()[:8])
    assert np.array_equal(sh.sharded_container_decode(data, [CPU] * 8), sharded_container_decode(data, mesh))
    rng = np.random.default_rng(11)
    x = np.cumsum(rng.integers(0, 120, 20000)).astype(np.int64)
    enc, stats = sh.sharded_container_encode(x, None, [CPU] * 8, page_n=256, chunk_n=8192)
    jenc, jstats = sharded_container_encode(x, None, mesh, page_n=256, chunk_n=8192)
    assert enc == jenc and stats["device_chunks"] == jstats["device_chunks"]


def test_port_package_scan_covers_parallel():
    """The import scan of tests/test_torch_host_copy.py walks the whole
    package, parallel/ included."""
    from tests.test_torch_host_copy import _port_files

    assert any(f.endswith("pcodec_tpu_torch/parallel/sharding.py") for f in _port_files())
