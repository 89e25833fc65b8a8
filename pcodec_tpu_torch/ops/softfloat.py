"""IEEE-754 binary multiply in integer ops, the PyTorch counterpart of the
JAX package's `pcodec_tpu/ops/softfloat.py`: the multiply the FloatMult
decode join needs, and the FloatMult split of the encoder's training
(`float_mult_split`).

Every value is an int64 tensor holding a W-bit pattern in its low bits (u64
semantics: unsigned compares go through `_ult`, right shifts through
`_srl`). W/E/P (width, exponent bits, mantissa digits including the
implicit one) are python ints per float type. `sf_mul_bits` reproduces
numpy's (x86) multiply bit for bit: round to nearest even, subnormal inputs
and outputs, signed zeros, overflow to inf, and x86 NaN propagation (a NaN
x wins, quieted; otherwise a NaN y, quieted; inf * 0 is the negative
default NaN).
"""

import torch

_MIN64 = -(1 << 63)


def _i64(v: int) -> int:
    """u64 python int -> the int64 value with the same bits."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


def _ult(a, b):
    """Unsigned a < b of u64 bit patterns."""
    return (a ^ _MIN64) < (b ^ _MIN64)


def _srl(x, k: int):
    """Logical right shift by a python int 0 <= k < 64."""
    return (x >> k) & ((1 << (64 - k)) - 1) if k else x


def _srl_t(x, k):
    """Logical right shift by a tensor of shifts in [0, 63]."""
    mask = torch.where(k == 0, -1, (1 << (64 - k).clamp(max=63)) - 1)
    return (x >> k) & mask


def _msb_pos(x):
    """floor(log2(x)) for x > 0 as u64 (0 for x == 0), integer only."""
    pos = torch.zeros_like(x)
    for k in (32, 16, 8, 4, 2, 1):
        big = _srl(x, k) != 0
        x = torch.where(big, _srl(x, k), x)
        pos = pos + torch.where(big, k, 0)
    return pos


def _mul_dbl(a, b):
    """Full product of a, b (each < 2^53) -> (hi, lo) u64. The 32-bit
    halves stay below 2^32; every partial sum is masked back to u64 bits."""
    m32 = 0xFFFFFFFF
    ah, al = _srl(a, 32), a & m32
    bh, bl = _srl(b, 32), b & m32
    ll = al * bl  # < 2^64, wraps into int64 as the same bits
    mid = al * bh + ah * bl + _srl(ll, 32)  # < 2^63 for 53-bit inputs
    lo = (ll & m32) | (mid << 32)
    hi = ah * bh + _srl(mid, 32)
    return hi, lo


def ordered_from_bits(bits, W: int):
    """Float memory bits -> order-preserving latent (the float bijection)."""
    mask = _i64((1 << W) - 1)
    sign = _i64(1 << (W - 1))
    return torch.where((bits & sign) != 0, (~bits) & mask, bits ^ sign)


def bits_from_ordered(lat, W: int):
    """Inverse float bijection: ordered latent -> memory bits."""
    mask = _i64((1 << W) - 1)
    sign = _i64(1 << (W - 1))
    return torch.where((lat & sign) == 0, (~lat) & mask, lat ^ sign)


def _normalize(m, e_raw, sub, P: int, bias: int):
    """Mantissa scaled to [2^(P-1), 2^P) and unbiased exponent, so the value
    is mant * 2^(exp - (P-1)); subnormals shift up to the implicit bit."""
    q = _msb_pos(torch.clamp(m, min=1))
    mant = torch.where(sub, m << ((P - 1) - q), m | (1 << (P - 1)))
    exp = torch.where(sub, q - (P - 1) + (1 - bias), e_raw - bias)
    return mant, exp


def sf_mul_bits(x, y, W: int, E: int, P: int):
    """IEEE round-to-nearest-even product bits of two W-bit floats.

    Unlike the JAX package's version, y need not be normal: a subnormal y is
    normalised as x is, and zero, inf and NaN y follow the x86 rules."""
    bias = (1 << (E - 1)) - 1
    sign_bit = _i64(1 << (W - 1))
    mant_mask = (1 << (P - 1)) - 1
    exp_raw_mask = (1 << E) - 1
    quiet = 1 << (P - 2)
    inf_field = ((1 << E) - 1) << (P - 1)
    x, y = torch.broadcast_tensors(x, y)

    def fields(v):
        e = _srl(v, P - 1) & exp_raw_mask
        m = v & mant_mask
        return (v & sign_bit, e, m, (e == exp_raw_mask) & (m != 0), (e == exp_raw_mask) & (m == 0),
                (e == 0) & (m == 0), (e == 0) & (m != 0))

    sx, ex, mx, nan_x, inf_x, zero_x, sub_x = fields(x)
    sy, ey, my, nan_y, inf_y, zero_y, sub_y = fields(y)
    mA, eA = _normalize(mx, ex, sub_x, P, bias)
    mB, eB = _normalize(my, ey, sub_y, P, bias)

    hi, lo = _mul_dbl(mA, mB)
    # align the 2P-bit product so its top set bit lands at 63 (big) or 62
    if 2 * P > 64:
        drop = 2 * P - 64
        sticky0 = (lo & ((1 << drop) - 1)) != 0
        v = (hi << (64 - drop)) | _srl(lo, drop)
    else:
        sticky0 = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
        v = lo << (64 - 2 * P)
    big = v < 0  # bit 63 set

    erb = eA + eB + big.to(torch.int64) + bias  # biased result exponent
    # alignment shift to a P-bit mantissa incl. implicit; more for subnormals
    s_unc = torch.where(big, 64 - P, 63 - P) + torch.clamp(1 - erb, min=0)
    s = torch.clamp(s_unc, 1, 63)

    mant = _srl_t(v, s)
    rbit = _srl_t(v, s - 1) & 1
    sticky = sticky0 | ((v & ((1 << (s - 1)) - 1)) != 0)
    # deep underflow: s_unc == 64 keeps only the top bit as the round bit;
    # s_unc > 64 shifts everything into sticky (v != 0 by construction)
    mant = torch.where(s_unc > 63, 0, mant)
    rbit = torch.where(s_unc == 64, _srl(v, 63), torch.where(s_unc > 64, 0, rbit))
    sticky = torch.where(s_unc == 64, sticky0 | ((v & ((1 << 63) - 1)) != 0),
                         sticky | (s_unc > 64))

    ebm1 = torch.clamp(erb - 1, min=0)
    # (ebm1 << (P-1)) + mant-with-implicit encodes normals and subnormals and
    # lets the rounding carry ripple into the exponent
    bits = (ebm1 << (P - 1)) + mant
    round_up = (rbit == 1) & (sticky | ((mant & 1) == 1))
    bits = bits + round_up.to(torch.int64)
    bits = torch.where(_ult(bits, torch.full_like(bits, inf_field)), bits, inf_field)  # overflow -> inf

    sign = sx ^ sy
    out = sign | bits
    out = torch.where(zero_x | zero_y, sign, out)
    out = torch.where(inf_x | inf_y, sign | inf_field, out)
    out = torch.where((inf_x & zero_y) | (zero_x & inf_y), sign_bit | inf_field | quiet, out)
    out = torch.where(nan_y, y | quiet, out)
    return torch.where(nan_x, x | quiet, out)


def int_float_latent_to_bits(lat, W: int, E: int, P: int):
    """Float memory bits of the integer-valued float a latent denotes (the
    inverse of the encoder's int_float_to_latent)."""
    bias = (1 << (E - 1)) - 1
    mid = _i64(1 << (W - 1))
    gpi = 1 << P
    gpi_bits = (P + bias) << (P - 1)

    neg = _ult(lat, torch.full_like(lat, mid))
    a = torch.where(neg, _i64((1 << (W - 1)) - 1) - lat, lat - mid)
    # small path: exact int -> float bits for 0 < a < 2^P
    t = _msb_pos(torch.where(a == 0, 1, a))
    mant = (a << ((P - 1) - t.clamp(max=P - 1))) & ((1 << (P - 1)) - 1)  # t < P where used
    small_bits = ((t + bias) << (P - 1)) | mant
    small_bits = torch.where(a == 0, 0, small_bits)
    bits = torch.where(_ult(a, torch.full_like(a, gpi)), small_bits, gpi_bits + (a - gpi))
    # negation is a sign-bit flip: the big-path bit trick can carry into the
    # sign bit, which -x then clears
    return torch.where(neg, bits ^ mid, bits)


def round_half_away_latent(p, W: int, E: int, P: int):
    """The latent of the W-bit float p rounded half away from zero
    (int_float_to_latent(round_half_away(p)), JAX `round_half_away_latent`),
    in bit operations: exact for every input, inf and NaN (the bit-trick
    path) and signed zeros (zero is always the middle) included."""
    bias = (1 << (E - 1)) - 1
    sign_bit = _i64(1 << (W - 1))
    mant_mask = (1 << (P - 1)) - 1
    exp_raw_mask = (1 << E) - 1
    gpi = 1 << P
    gpi_bits = (P + bias) << (P - 1)  # the bits of float(2^P)

    neg = (p & sign_bit) != 0
    abs_bits = p & ((1 << (W - 1)) - 1)
    ex = _srl(p, P - 1) & exp_raw_mask
    e = ex - bias  # subnormals land at e = -bias (< -1)
    m = (p & mant_mask) | (1 << (P - 1))
    # 0 <= e <= P-2: the integer part plus the bump of the top fraction bit
    k = (P - 1 - e).clamp(1, P - 1)
    small_abs = (m >> k) + ((m >> (k - 1)) & 1)
    abs_int = torch.where(e < -1, 0, torch.where(e == -1, 1, small_abs))
    abs_int = torch.where(ex == 0, 0, abs_int)
    big = e >= P - 1  # an integer already; inf and NaN too
    # trunc quiets a signalling NaN before the bit trick sees it
    is_nan = (ex == exp_raw_mask) & ((p & mant_mask) != 0)
    abs_bits = torch.where(is_nan, abs_bits | (1 << (P - 2)), abs_bits)
    abs_lat = torch.where(big, gpi + (abs_bits - gpi_bits), abs_int)
    # trunc(x) + 0.0 makes a -0.0 result positive
    neg = neg & ((abs_lat != 0) | big)
    out = torch.where(neg, _i64((1 << (W - 1)) - 1) - abs_lat, _i64(1 << (W - 1)) + abs_lat)
    return out & _i64((1 << W) - 1) if W < 64 else out


def float_mult_primary(lat, invb_bits, W: int, E: int, P: int):
    """FloatMult primary latents of ordered latents lat:
    int_float_to_latent(round_half_away(x * inv_base)), the product in the
    softfloat; invb_bits (broadcastable) are inv_base's memory bits."""
    return round_half_away_latent(sf_mul_bits(bits_from_ordered(lat, W), invb_bits, W, E, P), W, E, P)


def float_mult_adjustment(lat, prim, base_bits, W: int, E: int, P: int):
    """FloatMult adjustment latents: x.to_latent() - (mult * base).to_latent()
    + MID (wrapping at W bits), mult the integer-valued float prim denotes."""
    prod = sf_mul_bits(int_float_latent_to_bits(prim, W, E, P), base_bits, W, E, P)
    adj = lat - ordered_from_bits(prod, W) + _i64(1 << (W - 1))
    return adj & _i64((1 << W) - 1) if W < 64 else adj


def float_mult_split(lat, invb_bits, base_bits, W: int, E: int, P: int):
    """The FloatMult split of ordered latents (mode/float_mult.rs
    split_latents; JAX `float_mult_split_device`): (primary, adjustment)
    latents, every multiply in the integer softfloat, never the card's own
    (which drops NaN payloads)."""
    prim = float_mult_primary(lat, invb_bits, W, E, P)
    return prim, float_mult_adjustment(lat, prim, base_bits, W, E, P)
