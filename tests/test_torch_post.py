"""B3 (the decode post, `ops/decode.post_rows`) and B6 (the mode split of
training, `ops/device_train.split_primary` and `split_secondary`) of the
port against the JAX package, on the CPU.

Every comparison is exact, bit for bit. The plain versions run here, held
to the JAX package's XLA functions (`pd._consecutive_decode_batched`,
`pd._join_mem`, `softfloat.float_mult_split_device`, the IntMult and
FloatQuant transform in jnp ops) and to its host modes; the CUDA kernels
are held to the plain versions in test_torch_breadth_kernels.py and
test_torch_train_kernels.py. Sizes are a few pages of 256.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pcodec_tpu.ops.pallas_decode as pd
from pcodec_tpu import modes as ref_modes
from pcodec_tpu.codec.container import container_decompress as ref_decompress
from pcodec_tpu.dtypes import NUMBER_TYPES_BY_NAME as REF_TYPES
from pcodec_tpu.format.metadata import Mode as RefMode
from pcodec_tpu.modes import float_mult as ref_float_mult
from pcodec_tpu.modes import float_quant as ref_float_quant
from pcodec_tpu.modes import int_mult as ref_int_mult
from pcodec_tpu.ops import softfloat as ref_sf

import pcodec_tpu_torch as pt
from pcodec_tpu_torch.dtypes import NUMBER_TYPES_BY_NAME as TYPES
from pcodec_tpu_torch.format.metadata import Mode
from pcodec_tpu_torch.ops import container_decode as cd
from pcodec_tpu_torch.ops import decode as dec
from pcodec_tpu_torch.ops import device_train as dt

torch.set_num_threads(1)  # the test workers share the cores: more intra-op threads spin on theirs

RNG = np.random.default_rng(2020)
U64 = np.uint64
REF_MODE = {Mode.CLASSIC: RefMode.CLASSIC, Mode.INT_MULT: RefMode.INT_MULT, Mode.FLOAT_QUANT: RefMode.FLOAT_QUANT,
            Mode.FLOAT_MULT: RefMode.FLOAT_MULT}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=U64).view(np.int64))


def _u(t):
    return t.numpy().view(U64)


def _latents(bits, shape):
    x = RNG.integers(0, 2**64, shape, dtype=U64)
    return x & U64((1 << bits) - 1) if bits < 64 else x


# (mode, number type, primary order, secondary order, primary trivial):
# every mode at 16, 32 and 64 bits, orders 0-7, trivial vars
POST_CASES = [
    (Mode.CLASSIC, "u16", 0, 0, False), (Mode.CLASSIC, "i32", 1, 0, False), (Mode.CLASSIC, "f64", 7, 0, False),
    (Mode.CLASSIC, "i64", 3, 0, True),
    (Mode.INT_MULT, "u16", 2, 2, False), (Mode.INT_MULT, "i32", 4, 0, True), (Mode.INT_MULT, "i64", 5, 5, False),
    (Mode.FLOAT_QUANT, "f16", 6, 0, False), (Mode.FLOAT_QUANT, "f32", 0, 0, False),
    (Mode.FLOAT_QUANT, "f64", 1, 1, False),
    (Mode.FLOAT_MULT, "f16", 3, 0, False), (Mode.FLOAT_MULT, "f64", 2, 2, False),
]


@pytest.mark.parametrize("mode,name,p_order,s_order,p_trivial", POST_CASES)
def test_post_rows_plain_matches_jax(mode, name, p_order, s_order, p_trivial):
    """Exact: B3's plain version on a one-row table of 3 pages of 256 (the
    last ragged, 600 numbers), the primary read from the middle of a launch
    output (or trivial), the secondary from a flat base, against
    pd._consecutive_decode_batched on each var's pages, the trim and
    pd._join_mem; FloatMult also to the host's join_latents (f32's join
    is held to JAX in test_torch_breadth.py, where XLA's CPU flushes
    subnormal f32 products)."""
    nt, rnt = TYPES[name], REF_TYPES[name]
    bits = nt.latent.bits
    P, N, n = 3, 256, 600
    two = mode != Mode.CLASSIC
    launch = _latents(bits, (5, N))
    prim_rows = np.full((P, N), launch[1, 7], U64) if p_trivial else launch[1:4]
    sec_rows = _latents(bits, (P, N))
    moments = _latents(64, 64)
    scalar = {Mode.INT_MULT: 1_000_003 % (1 << bits), Mode.FLOAT_QUANT: 4}.get(mode, 0)
    if mode == Mode.FLOAT_MULT:
        scalar = int(rnt.to_latent_ordered(np.array([0.01], rnt.np_dtype))[0])
    prim = [-1, dec._i64(int(launch[1, 7])), p_order, 3, bits] if p_trivial else [0, N, p_order, 3, bits]
    sec = [1, 5, s_order, 40, bits]
    out = torch.full((n + 9,), -77, dtype=torch.int64)
    flat = np.concatenate([_latents(bits, 5), sec_rows.reshape(-1)])
    bases = [_t(launch), _t(flat), _t(moments), out]
    row = dec.post_row(prim, sec if two else [-1, 0, 0, 0, bits], 2, (3, 4), n, N, 0, mode,
                       dec.JOIN_OF_KIND[nt.kind], bits, scalar)
    dec.post_rows_plain(bases, np.array([row]))

    def ref_var(rows, order, mom):
        if not order:
            return rows.reshape(-1)[:n]
        m = moments[mom : mom + P * order].reshape(P, order)
        return np.asarray(pd._consecutive_decode_batched(jnp.asarray(rows), jnp.asarray(m), order, bits)).reshape(-1)[:n]

    p, s = ref_var(prim_rows, p_order, 3), ref_var(sec_rows, s_order, 40) if two else None
    ref = np.asarray(pd._join_mem(rnt, REF_MODE[mode], jnp.uint64(scalar), None, jnp.asarray(p),
                                  None if s is None else jnp.asarray(s)))
    got = _u(out)[4 : 4 + n]
    assert (_u(out)[:4] == U64(2**64 - 77)).all() and (_u(out)[4 + n :] == U64(2**64 - 77)).all()
    if mode == Mode.FLOAT_MULT:
        L = rnt.latent.np_dtype
        with np.errstate(all="ignore"):
            host = ref_modes.join_latents(rnt, RefMode(RefMode.FLOAT_MULT, scalar), p.astype(L), s.astype(L))
        assert np.array_equal(got, host.view(L).astype(U64))
    assert np.array_equal(got, ref)


def test_post_rows_plain_dict_latents_keep_their_bits():
    """Exact: a JOIN_LATENTS row (a Dict chunk's 32-bit primary under an
    order-1 delta, into K4's scratch) writes the consecutive decode's u64
    values unmasked, as pd._consecutive_decode_batched gives them."""
    P, N, n = 2, 256, 400
    lat, moments = _latents(32, (P, N)), _latents(64, P)
    out = torch.zeros(n, dtype=torch.int64)
    row = dec.post_row([0, 0, 1, 0, 32], [-1, 0, 0, 0, 32], 1, (2, 0), n, N, 0, Mode.CLASSIC, dec.JOIN_LATENTS, 64, 0)
    dec.post_rows_plain([_t(lat), _t(moments), out], np.array([row]))
    ref = np.asarray(pd._consecutive_decode_batched(jnp.asarray(lat), jnp.asarray(moments[:, None]), 1, 32))
    assert np.array_equal(_u(out), ref.reshape(-1)[:n])


def _mixed_numbers():
    """f64 numbers whose 2,000-number chunks take FloatMult (multiples of
    0.01), FloatQuant (low mantissa bits zero), Classic (full-precision
    draws) and, under the delta, a constant run."""
    mult = RNG.integers(-5000, 5000, 2000) * 0.01
    quant = (RNG.standard_normal(2000) * 1000).view(np.uint64) & ~U64((1 << 30) - 1)
    return np.concatenate([mult, quant.view(np.float64), RNG.standard_normal(2000), np.full(1500, 3.25)])


@pytest.mark.parametrize("delta", [("no_op", 0), ("try_consecutive", 2)])
def test_mixed_mode_container_decode_matches_host(delta):
    """Exact: a multi-chunk f64 container of mixed modes (auto mode), page_n
    256 with ragged last pages, decoded by decode_container_device on the
    CPU (B3's plain version, one table for every chunk) equals the JAX
    package's container_decompress and the source."""
    nums = _mixed_numbers()
    cfg = pt.ChunkConfig(delta_spec=pt.DeltaSpec(*delta))
    data = pt.container_compress(nums, cfg, page_n=256, chunk_n=2000)
    plan = cd.plan_container(data)
    assert {ch.mode_kind for ch in plan.chunks} >= {Mode.FLOAT_MULT, Mode.FLOAT_QUANT, Mode.CLASSIC}
    assert plan.post_view is None and len(plan.post_desc) == len(plan.chunks)
    got = pt.decode_container_device(data, device="cpu")
    assert np.array_equal(got.view(np.uint8), ref_decompress(data).view(np.uint8))
    assert np.array_equal(got.view(np.uint8), nums.view(np.uint8))


# (mode, number type): B6's primary and secondary at 16, 32 and 64 bits
SPLIT_CASES = [(Mode.INT_MULT, "u16"), (Mode.INT_MULT, "i32"), (Mode.INT_MULT, "i64"), (Mode.FLOAT_QUANT, "f16"),
               (Mode.FLOAT_QUANT, "f64"), (Mode.FLOAT_MULT, "f16"), (Mode.FLOAT_MULT, "f64")]


def _split_numbers(mode, nt):
    if mode == Mode.INT_MULT:
        return RNG.integers(0, 2**62, 768).astype(nt.np_dtype) * nt.np_dtype.type(7) + nt.np_dtype.type(3)
    x = (RNG.integers(-5000, 5000, 768) * nt.np_dtype.type(0.25)).astype(nt.np_dtype)
    x[:6] = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, np.finfo(nt.np_dtype).smallest_subnormal], nt.np_dtype)
    return x


@pytest.mark.parametrize("mode,name", SPLIT_CASES)
def test_mode_split_plain_matches_jax(mode, name):
    """Exact: B6's plain split of three units of 256 latents (a split chunk
    between an unsplit one and another split one) against the JAX
    package: FloatMult's against softfloat.float_mult_split_device,
    IntMult's and FloatQuant's against the transform of
    _phase_delta_sort and _phase_secondary in jnp ops; each split unit also
    against the host's split_latents. NaN, inf, -0 and a subnormal among
    the floats."""
    nt, rnt = TYPES[name], REF_TYPES[name]
    bits = nt.latent.bits
    nums = _split_numbers(mode, nt)
    lat = nt.to_latent_ordered(nums).astype(U64)
    fp = (bits, bits - nt.mantissa_digits, nt.mantissa_digits) if nt.kind == "float" else None
    if mode == Mode.FLOAT_MULT:
        sp = dt._float_mult_split(nt, 0.25, 4.0)
    elif mode == Mode.INT_MULT:
        sp = dt._int_mult_split(7)
    else:
        sp = dt._float_quant_split(3)
    table = dt.split_table([None, sp], "cpu")
    owner = torch.tensor([1, 0, 1])
    rows = _t(lat.reshape(3, 256))
    prim = dt.split_primary(rows, owner, table, fp)
    sec = dt.split_secondary(rows, prim, owner, table, fp, bits)
    assert torch.equal(prim[1], rows[1]) and not bool(sec[1].any())  # the unsplit unit
    ju = jnp.asarray(lat.reshape(3, 256)[[0, 2]])
    if mode == Mode.FLOAT_MULT:
        p_ref, s_ref = ref_sf.float_mult_split_device(ju, jnp.uint64(sp.invb), jnp.uint64(sp.base), *fp)
    else:
        d = jnp.uint64(sp.div)
        p_ref, s_ref = ju // d, ju % d
        if sp.flip:
            s_ref = jnp.where(ju < jnp.uint64(1 << (bits - 1)), d - jnp.uint64(1) - s_ref, s_ref)
    assert np.array_equal(_u(prim[[0, 2]]), np.asarray(p_ref))
    assert np.array_equal(_u(sec[[0, 2]]), np.asarray(s_ref))
    L = rnt.latent.np_dtype
    with np.errstate(all="ignore"):
        if mode == Mode.FLOAT_MULT:
            hp, hs = ref_float_mult.split_latents(rnt, nums, nt.np_dtype.type(0.25), nt.np_dtype.type(4.0))
        elif mode == Mode.INT_MULT:
            hp, hs = ref_int_mult.split_latents(rnt, nums, 7)
        else:
            hp, hs = ref_float_quant.split_latents(rnt, nums, 3)
    for u in (0, 2):
        sl = slice(256 * u, 256 * (u + 1))
        assert np.array_equal(_u(prim[u]), hp[sl].astype(L).astype(U64))
        assert np.array_equal(_u(sec[u]), hs[sl].astype(L).astype(U64))
