"""The port's PCT decode of every mode and delta against the JAX package.

Every comparison here is exact, bit for bit: decoded numbers against the
host decoder and the source, the plain versions of K3 (lookback) and K4
(dict join), conv1, the mode joins and the softfloat multiply against the
JAX package's functions, numpy's multiply where the port widens them.
On the CPU every kernel wrapper runs its plain version; the CUDA kernels
are held against those in test_torch_breadth_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pcodec_tpu.ops.decode as xops
import pcodec_tpu.ops.pallas_decode as pd
from pcodec_tpu import modes as ref_modes
from pcodec_tpu.delta import conv1_decode_in_place as ref_conv1_decode_in_place
from pcodec_tpu.codec.container import container_decompress as ref_decompress
from pcodec_tpu.dtypes import NUMBER_TYPES_BY_NAME as REF_TYPES
from pcodec_tpu.format.metadata import DeltaEncoding as RefDeltaEncoding
from pcodec_tpu.format.metadata import Mode as RefMode
from pcodec_tpu.ops import softfloat as ref_sf

import pcodec_tpu_torch as pt
from pcodec_tpu_torch.codec import compress as port_compress
from pcodec_tpu_torch.dtypes import NUMBER_TYPES_BY_NAME as TYPES
from pcodec_tpu_torch.format.metadata import DeltaEncoding
from pcodec_tpu_torch.ops import container_decode as cd
from pcodec_tpu_torch.ops import decode as dec
from pcodec_tpu_torch.ops import softfloat as sf
from tests.test_torch_breadth_kernels import dict_container

torch.set_num_threads(1)  # the test workers share the cores: more intra-op threads spin on theirs

RNG = np.random.default_rng(303)
WEP = {"f16": (16, 5, 11), "f32": (32, 8, 24), "f64": (64, 11, 53)}
UDT = {"f16": np.uint16, "f32": np.uint32, "f64": np.uint64}


def _t(a):
    return dec._u64_to_tensor(np.asarray(a, dtype=np.uint64))


def _u(t):
    return t.numpy().view(np.uint64)


def _decode_equals_host(nums, mode=("classic", 0.0), delta=("no_op", 0), page_n=256):
    cfg = pt.ChunkConfig(mode_spec=pt.ModeSpec(*mode), delta_spec=pt.DeltaSpec(*delta))
    data = pt.container_compress(nums, cfg, page_n=page_n, chunk_n=2000)
    out = pt.decode_container_device(data, device="cpu")
    ref = ref_decompress(data)
    assert out.dtype == nums.dtype == ref.dtype
    assert np.array_equal(out.view(np.uint8), ref.view(np.uint8))
    assert np.array_equal(out.view(np.uint8), nums.view(np.uint8))
    return cd.plan_container(data), data


def _with_specials(x):
    """Float data with NaN (two payloads), infinities, a subnormal and -0."""
    x = x.copy()
    udt = UDT[{2: "f16", 4: "f32", 8: "f64"}[x.itemsize]]
    nan2 = np.array(np.iinfo(udt).max >> 1, udt).view(x.dtype)  # NaN, full payload
    specials = np.array([np.nan, np.inf, -np.inf, np.finfo(x.dtype).smallest_subnormal, -0.0, nan2], x.dtype)
    x[5 : 5 + 211 * len(specials) : 211] = specials
    return x


def _mode_cases():
    n = 2500
    walk = np.cumsum(RNG.integers(0, 40, n))
    dec_vals = RNG.integers(-5000, 5000, n)
    cases = {
        "dict_i64": (np.array([3, 99, 1234567, -5], np.int64)[RNG.integers(0, 4, n)], ("try_dict", 0.0)),
        "dict_u32": (RNG.integers(0, 2**32, 40, dtype=np.uint64).astype(np.uint32)[RNG.integers(0, 40, n)],
                     ("try_dict", 0.0)),
        "dict_i16": (RNG.integers(-(2**15), 2**15, 30).astype(np.int16)[RNG.integers(0, 30, n)], ("try_dict", 0.0)),
        "dict_f64": (RNG.standard_normal(25)[RNG.integers(0, 25, n)], ("try_dict", 0.0)),
        "int_mult_i64": ((walk * 1_000_003 + RNG.integers(0, 3, n)).astype(np.int64), ("try_int_mult", 1_000_003)),
        "int_mult_u32": ((walk * 1000 + RNG.integers(0, 5, n)).astype(np.uint32), ("try_int_mult", 1000)),
        "int_mult_i16": ((RNG.integers(-300, 300, n) * 100 + RNG.integers(0, 2, n)).astype(np.int16),
                         ("try_int_mult", 100)),
    }
    for name, k in (("f16", 4), ("f32", 12), ("f64", 30)):
        dt = np.dtype(name.replace("f", "float"))
        cases[f"float_quant_{name}"] = (_with_specials((np.round(RNG.standard_normal(n) * 16) / 16).astype(dt)),
                                        ("try_float_quant", k))
        base = 0.25 if name == "f16" else 0.01
        cases[f"float_mult_{name}"] = (_with_specials((dec_vals % 800 * dt.type(base)).astype(dt)),
                                       ("try_float_mult", base))
    return cases


MODE_CASES = _mode_cases()


@pytest.mark.parametrize("name", sorted(MODE_CASES))
def test_decode_every_mode_and_number_type(name):
    """Exact, page_n 256 with a ragged last page, two chunks; the float
    cases carry NaN payloads, infinities, a subnormal and -0."""
    nums, mode = MODE_CASES[name]
    plan, _ = _decode_equals_host(nums, mode=mode)
    assert plan.chunks[0].mode_kind == mode[0].replace("try_", "")


@pytest.mark.parametrize("order", range(1, 7))
def test_decode_conv1_orders(order):
    """Exact for conv1 orders 1-6 on an LPC-friendly i32 signal (i16 for
    odd orders)."""
    t = np.arange(2300.0)
    sig = (1 << 12) * np.sin(0.01 * t) + (1 << 10) * np.sin(0.003 * t + 1.0) + RNG.integers(-8, 8, len(t))
    dtype = np.int16 if order % 2 else np.int32
    plan, _ = _decode_equals_host(sig.astype(dtype), delta=("try_conv1", order))
    de = plan.chunks[0].delta
    assert de.kind == DeltaEncoding.CONV1 and de.order == order


@pytest.mark.parametrize("case", ["i64_p256", "u32_p1024", "f64_p256", "i64_state_n_64", "dict_consecutive"])
def test_decode_lookback_and_delta_var_types(case, monkeypatch):
    """Exact. Lookback as the encoder makes it (state_n 1), a lookback
    chunk whose stored state has 64 latents (the JAX planner sends
    state_n > 32 to the host), and a Dict primary (u32 latents) under
    consecutive delta, whose delta arithmetic is 32-bit whatever the
    number type."""
    pattern = RNG.integers(0, 10**6, 173)
    reps = np.tile(pattern, 20)[:3000] + RNG.integers(0, 2, 3000)
    if case == "dict_consecutive":
        nums = np.repeat(np.array([7, -3, 10**15, 42], np.int64)[RNG.integers(0, 4, 600)], 5)
        plan, _ = _decode_equals_host(nums, mode=("try_dict", 0.0), delta=("try_consecutive", 1))
        assert plan.chunks[0].var_plans["primary"].bits == 32
        return
    if case == "i64_state_n_64":
        monkeypatch.setattr(port_compress, "new_lookback",
                            lambda n: DeltaEncoding.lookback(max(6, (n - 1).bit_length()), 6))
    dtype, page_n = {"i64_p256": (np.int64, 256), "u32_p1024": (np.uint32, 1024),
                     "f64_p256": (np.float64, 256), "i64_state_n_64": (np.int64, 256)}[case]
    nums = reps.astype(dtype) if dtype != np.float64 else reps * 0.5
    plan, _ = _decode_equals_host(nums, delta=("try_lookback", 0), page_n=page_n)
    de = plan.chunks[0].delta
    assert de.kind == DeltaEncoding.LOOKBACK
    assert de.state_n == (64 if case == "i64_state_n_64" else 1)


@pytest.mark.parametrize("case", ["dict", "consecutive", "mixed"])
def test_dict_containers_decode_as_the_reference(case):
    """Exact: multi-chunk TRY_DICT containers (every chunk Dict, under an
    order-1 delta, or with a Classic chunk between Dict chunks), whose Dict
    chunks the port joins in one K4 call into the output, decode as the JAX
    package's container_decompress."""
    nums, cfg = dict_container(case)
    data = pt.container_compress(nums, cfg, page_n=256, chunk_n=3000)
    out = pt.decode_container_device(data, device="cpu")
    assert np.array_equal(out, ref_decompress(data))
    assert np.array_equal(out, nums)


def test_dict_with_delta_i64_keeps_its_32_bit_latents():
    """Exact: the reference fault of a Dict chunk under a delta with i64
    numbers (300 draws of {7, -3, 10^15, 42}, each repeated 5 times, the
    first 42; page_n 256): the port decodes 42 at index 1, as
    container_decompress does."""
    vals = np.array([7, -3, 10**15, 42], np.int64)
    draws = np.random.default_rng(42).integers(0, 4, 300)
    draws[0] = 3
    nums = np.repeat(vals[draws], 5)
    cfg = pt.ChunkConfig(mode_spec=pt.ModeSpec("try_dict"), delta_spec=pt.DeltaSpec("try_consecutive", 1))
    data = pt.container_compress(nums, cfg, page_n=256)
    plan = cd.plan_container(data)
    assert plan.chunks[0].mode_kind == "dict" and plan.chunks[0].delta.kind == "consecutive"
    out = pt.decode_container_device(data, device="cpu")
    assert out[1] == 42
    assert np.array_equal(out, ref_decompress(data))


def test_decode_float_mult_f64_with_a_subnormal_base():
    """Exact: an f64 FloatMult chunk whose base is subnormal (the JAX
    planner sends it to the host) decodes through the widened softfloat."""
    nums = RNG.integers(-5000, 5000, 1200) * 1e-310
    plan, data = _decode_equals_host(nums, mode=("try_float_mult", 1e-310))
    assert plan.chunks[0].mode_kind == "float_mult"
    assert not pd.float_mult_f64_device_ok(pd.parse_container(data).chunk_metas[0], REF_TYPES["f64"])


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["lookback", "dict"])
def test_matches_jax_pallas_path_in_interpret_mode(mode):
    """Exact: JAX's Pallas decode (interpret mode on the CPU) and the port
    decode a tiny lookback and a dict container to the same bits. Slow:
    K1, K2 and K3 in interpret mode take 25-45 s; the tier-1 run holds K3
    and K4 to the JAX package through xops._lookback_decode and
    _dict_join_pairs above."""
    if mode == "lookback":
        nums = np.tile(RNG.integers(0, 10**5, 50), 6).astype(np.int64)[:300]
        cfg = pt.ChunkConfig(delta_spec=pt.DeltaSpec("try_lookback"))
    else:
        nums = np.array([3, 99, 1234567, -5], np.int64)[RNG.integers(0, 4, 300)]
        cfg = pt.ChunkConfig(mode_spec=pt.ModeSpec("try_dict"))
    data = pt.container_compress(nums, cfg, page_n=256)
    ref, _, _ = pd.decode_container_device(data)
    out = pt.decode_container_device(data, device="cpu")
    assert np.array_equal(out.view(np.uint8), ref.view(np.uint8))
    assert np.array_equal(out.view(np.uint8), nums.view(np.uint8))


# ---------------------------------------------------------------------------
# K3's plain version and conv1 against the XLA functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P,N,state_n,window_n,bits", [
    (5, 256, 32, 2048, 64), (1, 768, 2, 300, 16), (2, 512, 0, 1000, 32),
])
def test_lookback_plain_matches_jax(P, N, state_n, window_n, bits):
    """Exact against jax.vmap(xops._lookback_decode) on adversarial inputs:
    lookbacks of 0 and past the window, wrapping u64 sums, state_n 0-32
    (the generator of the JAX package's own Pallas-vs-XLA test)."""
    rng = np.random.default_rng(11)
    latents = rng.integers(0, 1 << 63, (P, N), dtype=np.uint64)
    latents |= rng.integers(0, 2, (P, N), dtype=np.uint64) << np.uint64(63)
    lbs = rng.integers(1, window_n + 1, (P, N), dtype=np.uint64)
    lbs[:, ::17] = 0
    lbs[:, 3::29] = window_n + 1000
    states = rng.integers(0, 1 << 62, (P, 32), dtype=np.uint64)
    ref = jax.vmap(lambda lat, lb, st: xops._lookback_decode(lat, lb, st, jnp.int64(window_n), state_n, bits))(
        jnp.asarray(latents), jnp.asarray(lbs), jnp.asarray(states))
    out = dec.lookback_decode_pages_plain(_t(latents), _t(lbs), _t(states[:, :state_n]), window_n, state_n, bits)
    assert np.array_equal(_u(out), np.asarray(ref))
    assert torch.equal(dec.lookback_recon(_t(latents), _t(lbs), _t(states[:, :state_n]), window_n, state_n,
                                          bits), out)
    # the container-level plain K3 on a one-row table of the same pages
    table = torch.zeros(P * N, dtype=torch.int64)
    row = [0, 0, 1, 0, 2, 0, 3, 0, P, N, P * N, state_n, window_n, bits, dec.JOIN_LATENTS, 0]
    dec.lookback_recon_chunks_plain([_t(latents), _t(lbs), _t(states[:, :state_n]), table], np.array([row]))
    assert np.array_equal(_u(table).reshape(P, N), np.asarray(ref))


@pytest.mark.parametrize("order,bits", [(1, 32), (3, 16), (6, 32), (2, 8)])
def test_conv1_matches_jax(order, bits):
    """Exact against jax.vmap(xops._conv1_decode)."""
    P, N = 3, 300
    lat = RNG.integers(0, 1 << bits, (P, N), dtype=np.uint64)
    states = RNG.integers(0, 1 << bits, (P, 32), dtype=np.uint64)
    weights = RNG.integers(-(1 << 10), 1 << 10, order)
    quant, bias = 9, int(RNG.integers(-(1 << 20), 1 << 20))
    aux = np.zeros(36, np.int64)
    aux[1], aux[2], aux[3 : 3 + order] = quant, bias, weights
    ref = jax.vmap(lambda la, st: xops._conv1_decode(la, st, jnp.asarray(aux), order, bits))(
        jnp.asarray(lat), jnp.asarray(states))
    out = dec.conv1_decode_pages(_t(lat), _t(states[:, :order]), weights.tolist(), quant, bias, order, bits)
    assert np.array_equal(_u(out), np.asarray(ref))


@pytest.mark.parametrize("order", [1, 6, 32])
def test_conv1_plain_flat_row_matches_jax(order):
    """Exact: conv1_decode_pages_plain on one flat row of a few thousand
    numbers (a standalone chunk's route) against the JAX package's host
    conv1_decode_in_place; the same numbers cut into pages, each from its
    own state, against jax.vmap(xops._conv1_decode)."""
    bits, n, P = 32, 3000, 3
    lat = RNG.integers(0, 1 << bits, n, dtype=np.uint64)
    state = RNG.integers(0, 1 << bits, order, dtype=np.uint64)
    weights = RNG.integers(-(1 << 12), 1 << 12, order)
    quant, bias = 11, int(RNG.integers(-(1 << 24), 1 << 24))
    host = lat.astype(np.uint32)
    ref_conv1_decode_in_place(RefDeltaEncoding.conv1(quant, bias, weights.tolist()), state.astype(np.uint32), host)
    out = dec.conv1_decode_pages_plain(_t(lat)[None], _t(state)[None], weights.tolist(), quant, bias, order, bits)
    assert np.array_equal(_u(out)[0], host.astype(np.uint64))
    states = RNG.integers(0, 1 << bits, (P, 32), dtype=np.uint64)
    aux = np.zeros(36, np.int64)
    aux[1], aux[2], aux[3 : 3 + order] = quant, bias, weights
    pages = lat.reshape(P, n // P)
    ref = jax.vmap(lambda la, st: xops._conv1_decode(la, st, jnp.asarray(aux), order, bits))(
        jnp.asarray(pages), jnp.asarray(states))
    out = dec.conv1_decode_pages_plain(_t(pages), _t(states[:, :order]), weights.tolist(), quant, bias, order, bits)
    assert np.array_equal(_u(out), np.asarray(ref))


# ---------------------------------------------------------------------------
# joins against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["f16", "f32", "f64"])
def test_float_mult_join_plain_matches_jax(name):
    """Exact: B2's plain version against pd._join_mem's FloatMult branch
    and the host's join_latents, on bases 0.01, 3.0 and a subnormal, with
    NaN, inf and zero multipliers among the full-range latents. As in
    test_join_mem_matches_jax, f32 is held to JAX only where neither the
    host's product nor the multiplier is subnormal, and f32 and f64 only
    with a normal base (XLA's CPU flushes subnormal f32 products and
    operands; JAX's f64 softfloat takes normal bases only); to the host
    everywhere."""
    nt, rnt = TYPES[name], REF_TYPES[name]
    bits = nt.latent.bits
    L = rnt.latent.np_dtype
    prim, sec = _latents(bits), _latents(bits)
    mid = 1 << (bits - 1)
    prim[:1000] = np.uint64(mid) + RNG.integers(-500, 500, 1000).astype(np.uint64)  # small multipliers
    for base_f, normal in ((0.01, True), (3.0, True), (np.array([3], L).view(rnt.np_dtype)[0], False)):
        scalar = int(rnt.to_latent_ordered(np.array([base_f], rnt.np_dtype))[0])
        out = _u(dec.float_mult_join_plain(nt, scalar, _t(prim), _t(sec)))
        ref = np.asarray(pd._join_mem(rnt, RefMode.FLOAT_MULT, jnp.uint64(scalar), None, jnp.asarray(prim),
                                      jnp.asarray(sec)))
        with np.errstate(all="ignore"):
            host = ref_modes.join_latents(rnt, RefMode(RefMode.FLOAT_MULT, scalar), prim.astype(L), sec.astype(L))
            keep = np.ones(len(prim), bool)
            if name == "f32":
                mult = np.abs(rnt.int_float_from_latent(prim.astype(L)))
                prod = mult * rnt.np_dtype.type(base_f)
                tiny = np.finfo(np.float32).tiny
                keep = ~(((prod > 0) & (prod < tiny)) | ((mult > 0) & (mult < tiny)))
        assert np.array_equal(out, host.view(L).astype(np.uint64))
        if normal or name == "f16":
            assert np.array_equal(out[keep], ref[keep]) and keep.mean() > 0.5
        into = torch.full((len(prim),), -7, dtype=torch.int64)
        assert dec.float_mult_join_plain(nt, scalar, _t(prim), _t(sec), into) is into
        assert np.array_equal(_u(into), out)


def _latents(bits, n=3000):
    x = RNG.integers(0, 2**63, n, dtype=np.uint64) | (RNG.integers(0, 2, n, dtype=np.uint64) << np.uint64(63))
    return x & np.uint64((1 << bits) - 1 if bits < 64 else 2**64 - 1)


@pytest.mark.parametrize("mode,name", [
    ("int_mult", "u32"), ("int_mult", "i64"), ("int_mult", "u16"), ("int_mult", "i8"),
    ("float_quant", "f16"), ("float_quant", "f32"), ("float_quant", "f64"),
    ("float_mult", "f16"), ("float_mult", "f32"), ("float_mult", "f64"),
])
def test_join_mem_matches_jax(mode, name):
    """Exact against pd._join_mem and the host's join_latents. One
    exception: XLA's CPU flushes subnormal f32 products to zero, which
    the host does not, so f32 FloatMult is held to JAX only where the
    host's product is not subnormal (and to the host everywhere)."""
    nt, rnt = TYPES[name], REF_TYPES[name]
    bits = nt.latent.bits
    prim, sec = _latents(bits), _latents(bits)
    scalar = {"int_mult": 1_000_003 % (1 << bits), "float_quant": 4}.get(mode)
    if mode == "float_mult":
        scalar = int(rnt.to_latent_ordered(np.array([0.01], rnt.np_dtype))[0])
    kind = {"int_mult": RefMode.INT_MULT, "float_quant": RefMode.FLOAT_QUANT, "float_mult": RefMode.FLOAT_MULT}[mode]
    out = _u(dec.join_mem(nt, kind, scalar, _t(prim), _t(sec)))
    ref = np.asarray(pd._join_mem(rnt, kind, jnp.uint64(scalar), None, jnp.asarray(prim), jnp.asarray(sec)))
    L = rnt.latent.np_dtype
    with np.errstate(all="ignore"):
        host = ref_modes.join_latents(rnt, RefMode(kind, scalar), prim.astype(L), sec.astype(L))
        keep = np.ones(len(prim), bool)
        if mode == "float_mult" and name == "f32":
            prod = np.abs(rnt.int_float_from_latent(prim.astype(L)) * rnt.np_dtype.type(0.01))
            keep = ~((prod > 0) & (prod < np.finfo(np.float32).tiny))
    assert np.array_equal(out, host.view(L).astype(np.uint64))
    assert np.array_equal(out[keep], ref[keep]) and keep.mean() > 0.9


@pytest.mark.parametrize("D", [100, 9000, 20000])
def test_dict_join_plain_matches_jax(D):
    """Exact against pd._dict_join_pairs (interpret mode), whose big-dict
    kernel takes the 20,000-entry table; indices past the table clamp."""
    nt = TYPES["i64"]
    vals = RNG.integers(0, 2**64, D, dtype=np.uint64)
    prim = RNG.integers(0, D + 50, 2048).astype(np.uint64)
    prim[::31] |= np.uint64(7 << 32)
    pairs = np.asarray(pd._dict_join_pairs(jnp.asarray(prim), jnp.asarray(pd._dict_mem_planes(REF_TYPES["i64"], vals)),
                                           D)).astype(np.uint32).astype(np.uint64)
    ref = pairs[:, 0] | (pairs[:, 1] << np.uint64(32))
    out = dec.dict_join(_t(prim), torch.from_numpy(dec.dict_table(nt, vals)))
    assert np.array_equal(_u(out), ref)


# ---------------------------------------------------------------------------
# softfloat against the JAX package and numpy
# ---------------------------------------------------------------------------


def _adversarial_bits(name, rng, n=2048):
    """The special cases of tests/test_softfloat.py: random patterns, +-0,
    subnormals, +-inf, NaNs, the smallest and largest normals."""
    W, E, P = WEP[name]
    bits = rng.integers(0, 1 << min(W, 63), n, dtype=np.uint64)
    if W == 64:
        bits = bits | (rng.integers(0, 2, n, dtype=np.uint64) << np.uint64(63))
    exp_mask = ((1 << E) - 1) << (P - 1)
    specials = np.array([
        0, 1 << (W - 1), 1, 3, (1 << (P - 1)) - 1, exp_mask, exp_mask | (1 << (W - 1)), exp_mask | 1,
        exp_mask | (1 << (P - 2)), 1 << (P - 1), ((1 << E) - 2) << (P - 1) | ((1 << (P - 1)) - 1),
    ], dtype=np.uint64) & np.uint64((1 << W) - 1 if W < 64 else 2**64 - 1)
    bits[: len(specials)] = specials
    return bits


def _numpy_mul(name, x_bits, y_bits):
    udt, ft = UDT[name], TYPES[name].np_dtype
    with np.errstate(all="ignore"):
        return np.multiply(x_bits.astype(udt).view(ft), y_bits.astype(udt).view(ft)).view(udt).astype(np.uint64)


@pytest.mark.parametrize("name", ["f16", "f32", "f64"])
def test_softfloat_matches_jax(name):
    """Exact: sf_mul_bits on the normal bases of tests/test_softfloat.py,
    int_float_latent_to_bits, the float bijection and the helpers."""
    W, E, P = WEP[name]
    rng = np.random.default_rng(5)
    x = _adversarial_bits(name, rng)
    for yv in (0.01, 0.25, 3.0, 1e3, 1.0 / 3.0):
        y = np.uint64(np.asarray(TYPES[name].np_dtype.type(yv)).view(UDT[name]))
        ref = np.asarray(ref_sf.sf_mul_bits(jnp.asarray(x), jnp.uint64(y), W, E, P))
        out = _u(sf.sf_mul_bits(_t(x), torch.tensor(int(y), dtype=torch.int64), W, E, P))
        assert np.array_equal(out, ref) and np.array_equal(out, _numpy_mul(name, x, np.full_like(x, y)))
    lat = _latents(W, 2048)
    assert np.array_equal(_u(sf.int_float_latent_to_bits(_t(lat), W, E, P)),
                          np.asarray(ref_sf.int_float_latent_to_bits(jnp.asarray(lat), W, E, P)))
    assert np.array_equal(_u(sf.ordered_from_bits(_t(x), W)), np.asarray(ref_sf.ordered_from_bits(jnp.asarray(x), W)))
    assert np.array_equal(_u(sf.bits_from_ordered(_t(x), W)), np.asarray(ref_sf.bits_from_ordered(jnp.asarray(x), W)))
    m = _latents(64, 2048) >> np.uint64(11)  # < 2^53
    ref_hi, ref_lo = ref_sf._mul_dbl(jnp.asarray(m), jnp.asarray(m[::-1].copy()))
    hi, lo = sf._mul_dbl(_t(m), _t(m[::-1].copy()))
    assert np.array_equal(_u(hi), np.asarray(ref_hi)) and np.array_equal(_u(lo), np.asarray(ref_lo))
    assert np.array_equal(_u(sf._msb_pos(_t(lat))), np.asarray(ref_sf._msb_pos(jnp.asarray(lat))))


@pytest.mark.parametrize("name", ["f16", "f32", "f64"])
def test_softfloat_multiply_widened_to_any_base(name):
    """Exact against numpy's multiply for bases the JAX version refuses:
    subnormal, +-0, +-inf and NaN (quiet and signalling, both signs). When
    both operands are NaN, numpy's answer depends on its loop (which operand
    the compiled multiply takes first), so there the port is held to the
    x86 rule it states: x wins, quieted."""
    W, E, P = WEP[name]
    rng = np.random.default_rng(6)
    x = _adversarial_bits(name, rng)
    exp_mask = ((1 << E) - 1) << (P - 1)
    sign = 1 << (W - 1)
    x_nan = ((x & np.uint64(exp_mask)) == np.uint64(exp_mask)) & ((x & np.uint64((1 << (P - 1)) - 1)) != 0)
    for y in (1, 5, (1 << (P - 1)) - 1, sign | 3, 0, sign, exp_mask, sign | exp_mask, exp_mask | 1,
              sign | exp_mask | (1 << (P - 2)) | 9):
        out = _u(sf.sf_mul_bits(_t(x), torch.tensor(dec._i64(y), dtype=torch.int64), W, E, P))
        want = _numpy_mul(name, x, np.full(len(x), y, np.uint64))
        if (y & exp_mask) == exp_mask and y & ((1 << (P - 1)) - 1):  # y is NaN
            want[x_nan] = x[x_nan] | np.uint64(1 << (P - 2))
        assert np.array_equal(out, want), hex(y)
