"""B1's narrow domain on the CPU: the conv1 recurrence's plain version
against the JAX package's scan at the edges of what the port's ChunkMeta
validation admits, and the route column `decode.conv1_row` writes
(`decode.conv1_narrow`) against that validation.

Every comparison is exact. The kernel's narrow and wide steps are held
against the plain version on the card in test_torch_breadth_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pcodec_tpu.ops.decode as xops

import pcodec_tpu_torch as pt
from pcodec_tpu_torch.codec import standalone as port_standalone
from pcodec_tpu_torch.ops import container_decode as cd
from pcodec_tpu_torch.ops import decode as dec
from pcodec_tpu_torch.ops import standalone_decode as sd
from tests.test_torch_breadth_kernels import conv1_admitted, conv1_edge_params

torch.set_num_threads(1)  # the test workers share the cores: more intra-op threads spin on theirs

NARROW = dec.C1_COLS.index("narrow")
# (q at its cap, the weights' and bias's sign: 0 mixed)
EDGES = ((False, 1), (True, -1), (False, 0), (True, 0))


def _t(a):
    return dec._u64_to_tensor(np.asarray(a, dtype=np.uint64))


@pytest.mark.parametrize("bits", [8, 16, 32])
def test_conv1_plain_matches_jax_at_domain_edges(bits):
    """Exact against jax.vmap(xops._conv1_decode) for orders 1, 6 and 32,
    each with q 0 and its cap, sums driven positive, negative and both, and
    |bias| + 2^bits * sum|w| the largest ChunkMeta's validation admits
    beside the weights: every such row is narrow. Latents carry garbage
    above the W bits and states are full 64-bit."""
    rng = np.random.default_rng(bits)
    N = 160
    for order in (1, 6, 32):
        params = [conv1_edge_params(rng, order, bits, q_cap, sign) for q_cap, sign in EDGES]
        P = len(params)
        lat = rng.integers(0, 2**64, (P, N), dtype=np.uint64)
        states = rng.integers(0, 2**64, (P, 32), dtype=np.uint64)
        aux = np.zeros((P, 36), np.int64)
        for p, (w, q, bias) in enumerate(params):
            assert conv1_admitted(w, q, bias, bits) and dec.conv1_narrow(w, q, bias, bits)
            aux[p, 1], aux[p, 2], aux[p, 3 : 3 + order] = q, bias, w
        ref = np.asarray(jax.vmap(lambda la, st, a: xops._conv1_decode(la, st, a, order, bits))(
            jnp.asarray(lat), jnp.asarray(states), jnp.asarray(aux)))
        for p, (w, q, bias) in enumerate(params):
            out = dec.conv1_decode_pages_plain(_t(lat[p : p + 1]), _t(states[p : p + 1, :order]), w, q, bias,
                                               order, bits)
            assert np.array_equal(out.numpy().view(np.uint64)[0], ref[p])


def test_conv1_row_is_narrow_wherever_chunk_meta_admits_it():
    """conv1_row's narrow column on random descriptors of every width: each
    one ChunkMeta's validation admits is narrow; at each width a row at the
    exact bound's last unit is narrow and one unit past it is wide, either
    sign, as is a q past its cap; every 64-bit row is wide."""
    rng = np.random.default_rng(22)
    admitted = 0
    for _ in range(400):
        bits = int(rng.choice([8, 16, 32]))
        order = int(rng.integers(1, 33))
        top = dec.C1_CONV_BITS[bits] - 1
        e = int(rng.integers(0, top - bits + 1))  # the weights' scale, up to the bound's
        w = [int(x) for x in rng.integers(-(1 << e), (1 << e) + 1, order)]
        q = int(rng.integers(0, top + 2))
        e = int(rng.integers(0, top + 1))
        bias = int(rng.integers(-(1 << e), 1 << e))
        row = dec.conv1_row(w, q, bias, bits, 1, 8, 8, 0)
        assert row[NARROW] == dec.conv1_narrow(w, q, bias, bits)
        if conv1_admitted(w, q, bias, bits):
            admitted += 1
            assert row[NARROW] == 1, (w, q, bias, bits)
        w64 = rng.integers(-3, 4, order).tolist()
        assert dec.conv1_row(w64, q % 64, bias, 64, 1, 8, 8, 0)[NARROW] == 0
    assert admitted > 150
    for bits, conv_bits in dec.C1_CONV_BITS.items():
        w = [3, -2, 1]
        last = (1 << (conv_bits - 1)) - 1 - (6 << bits)  # |bias| + 2^bits * sum|w| == 2^(conv_bits - 1) - 1
        for sign in (1, -1):
            assert dec.conv1_row(w, conv_bits - 1, sign * last, bits, 1, 8, 8, 0)[NARROW] == 1
            assert dec.conv1_row(w, conv_bits - 1, sign * (last + 1), bits, 1, 8, 8, 0)[NARROW] == 0
        assert dec.conv1_row(w, conv_bits, 0, bits, 1, 8, 8, 0)[NARROW] == 0


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32])
def test_conv1_rows_of_encoded_files_are_narrow(dtype):
    """Every B1 row of a PCT container and of a standalone file that the
    port's host encoder writes with TRY_CONV1 is narrow; the container
    decodes to its source on the CPU route."""
    t = np.arange(3000)
    sig = 50 * np.sin(t * 0.05) + np.random.default_rng(5).standard_normal(3000) * 3
    x = (sig * {np.int8: 1, np.int16: 100, np.int32: 100_000}[dtype]).astype(dtype)
    cfg = pt.ChunkConfig(delta_spec=pt.DeltaSpec(pt.DeltaSpec.TRY_CONV1, 4), enable_8_bit=True)
    data = pt.container_compress(x, cfg, page_n=256, chunk_n=1024)
    pct = cd.plan_container(data).conv1_desc
    flat = sd.plan_standalone(port_standalone.simple_compress(x, cfg)).conv1_desc
    for desc in (pct, flat):
        assert len(desc) and desc[:, NARROW].all()
    assert np.array_equal(pt.decode_container_device(data, device="cpu"), x)
