"""FloatMult mode: x = mult * base + adj ULPs (ref: pco/src/mode/float_mult.rs).

Base detection via (a) trailing-zeros power-of-2 analysis reusing the int
triple-GCD machinery, falling back to (b) an approximate Euclidean pair GCD
with error tracking, then base centering and snapping to 1/int or a decimal.
The Euclidean loop is vectorized across pairs with masks; all arithmetic is
done in the number's own float dtype so IEEE semantics match the reference.
"""

import numpy as np

from pcodec_tpu_torch.binning import sampling
from pcodec_tpu_torch.constants import MULT_REQUIRED_BITS_SAVED_PER_NUM
from pcodec_tpu_torch.dtypes import NumberType, leading_zeros_uint
from pcodec_tpu_torch.modes import int_mult
from pcodec_tpu_torch.utils import round_half_away

REQUIRED_PRECISION_BITS = 6
SNAP_THRESHOLD_ABSOLUTE = 0.02
SNAP_THRESHOLD_DECIMAL_RELATIVE = 0.01
INTERESTING_TRAILING_ZEROS = 5
REQUIRED_TRAILING_ZEROS_FREQUENCY = 0.5
REQUIRED_GCD_PAIR_FREQUENCY = 0.001


def split_latents(nt: NumberType, nums: np.ndarray, base, inv_base):
    nums = np.ascontiguousarray(nums, dtype=nt.np_dtype)
    L = nt.latent.np_dtype
    mult = round_half_away(nums * inv_base)
    primary = nt.int_float_to_latent(mult)
    mid = L.type(nt.latent.mid)
    adj = (nt.to_latent_ordered(nums) - nt.to_latent_ordered(mult * base)) + mid
    return primary, adj


# ---------------------------------------------------------------------------
# base detection
# ---------------------------------------------------------------------------


def _exp2(nt: NumberType, power) -> np.ndarray:
    return np.asarray(nt.exp2(int(power)))


def _choose_config_by_trailing_zeros(nt: NumberType, sample: np.ndarray):
    """ref: float_mult.rs:499-548."""
    precision_bits = nt.precision_bits
    tz = nt.trailing_zeros(sample)
    exponent = nt.exponent(sample)
    k_prime = exponent - np.maximum(precision_bits - tz, 0)
    qualifies = (sample != 0) & (tz >= INTERESTING_TRAILING_ZEROS)
    count = int(qualifies.sum())
    required = max(
        int(np.ceil(len(sample) * REQUIRED_TRAILING_ZEROS_FREQUENCY)), sampling.MIN_SAMPLE
    )
    if count < required:
        return None
    k = int(k_prime[qualifies].min())

    L = nt.latent.np_dtype
    bits = nt.latent.bits
    lshift = bits - precision_bits - 1
    explicit_mantissa = L.type(nt.latent.mid)
    ok = (k_prime >= k) & (exponent < k + bits)
    xs = sample[ok]
    exps = exponent[ok]
    rshift = (bits - 1 - (exps - k)).astype(np.uint64).astype(L)
    lshifted = (xs.view(L) << L.type(lshift)) | explicit_mantissa
    int_sample = lshifted >> rshift
    if len(int_sample) < required:
        return None
    cand = int_mult.choose_candidate_base(int_sample)
    int_base = cand[0] if cand is not None else 1
    base = nt.np_dtype.type(int_base) * nt.exp2(k)
    return nt.np_dtype.type(base)


def _approx_pair_gcds(nt: NumberType, greater: np.ndarray, lesser: np.ndarray):
    """Vectorized approximate Euclid on pairs; returns (gcds, valid_mask).

    ref: float_mult.rs:456-496 — error-tracked remainder loop.
    """
    F = nt.np_dtype
    machine_eps = nt.exp2(-nt.precision_bits)
    insig_factor = nt.exp2(-(max(nt.precision_bits - REQUIRED_PRECISION_BITS, 0)))
    small_rem_factor = nt.exp2(-16)
    imprecise_factor = nt.exp2(REQUIRED_PRECISION_BITS)

    gv = greater.astype(F).copy()
    lv = lesser.astype(F).copy()
    ge = np.zeros_like(gv)
    le = np.zeros_like(lv)
    orig_greater = gv.copy()

    active = ~((lv <= gv * insig_factor) | (lv == gv))
    result = np.zeros_like(gv)
    success = np.zeros(len(gv), dtype=bool)

    for _ in range(200):
        if not active.any():
            break
        prev = gv.copy()
        with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
            ratio = round_half_away(gv / lv)
            ge_new = ge + ratio * le + gv * machine_eps
            gv_new = np.abs(gv - ratio * lv)
        ge = np.where(active, ge_new, ge)
        gv = np.where(active, gv_new, gv)
        with np.errstate(invalid="ignore", over="ignore"):
            done_ok = active & ((gv <= prev * small_rem_factor) | (gv <= ge))
        result = np.where(done_ok, lv, result)
        success |= done_ok
        active &= ~done_ok
        done_fail = active & ((gv <= orig_greater * insig_factor) | (gv <= ge * imprecise_factor))
        active &= ~done_fail
        # swap greater/lesser for remaining
        sw = active
        gv2 = np.where(sw, lv, gv)
        lv2 = np.where(sw, gv, lv)
        ge2 = np.where(sw, le, ge)
        le2 = np.where(sw, ge, le)
        gv, lv, ge, le = gv2, lv2, ge2, le2
    return result, success


def _approx_sample_gcd_euclidean(nt: NumberType, sample: np.ndarray):
    """ref: float_mult.rs:551-583."""
    n_pairs = (len(sample) - 1 + 1) // 2 if len(sample) >= 2 else 0
    idx = np.arange(0, len(sample) - 1, 2)
    a = sample[idx]
    b = sample[idx + 1]
    greater = np.maximum(a, b)
    lesser = np.minimum(a, b)
    gcds, ok = _approx_pair_gcds(nt, greater, lesser)
    gcds = gcds[ok]
    required = 1 + int(np.ceil(len(sample) * REQUIRED_GCD_PAIR_FREQUENCY))
    if len(gcds) < required:
        return None
    gcds = np.sort(gcds)
    rel_tol = nt.np_dtype.type(0.01)
    for percentile in (0.1, 0.3, 0.5):
        candidate = gcds[int(percentile * len(gcds))]
        similar = int(np.sum(np.abs(gcds - candidate) < rel_tol * candidate))
        if similar >= required:
            return candidate
    return None


def _center_sample_base(nt: NumberType, base, sample: np.ndarray):
    """ref: float_mult.rs:593-613 — sequential F-typed accumulation."""
    F = nt.np_dtype
    inv_base = F.type(1.0) / base
    mult = round_half_away(sample * inv_base)
    exps = nt.exponent(mult)
    # reference casts the exponent to Bitlen (u32), so negatives wrap huge
    exps_u32 = exps.astype(np.int64) & 0xFFFFFFFF
    valid = (exps_u32 < nt.precision_bits) & (mult != 0)
    overshoot = (mult * base) - sample
    weight = (nt.precision_bits - exps_u32).astype(np.float64)
    tweak_sum = F.type(0.0)
    tweak_weight = F.type(0.0)
    ratio = np.where(mult != 0, overshoot / np.where(mult == 0, 1, mult), 0)
    w_arr = weight.astype(F)
    for i in np.nonzero(valid)[0]:
        tweak_sum = F.type(tweak_sum + F.type(w_arr[i] * ratio[i]))
        tweak_weight = F.type(tweak_weight + w_arr[i])
    if tweak_weight == 0:
        return base
    return F.type(base - tweak_sum / tweak_weight)


def _snap_to_int_reciprocal(nt: NumberType, base):
    """Returns (base, inv_base); ref: float_mult.rs:615-629."""
    F = nt.np_dtype
    inv_base = F.type(1.0) / base
    if not np.isfinite(inv_base):
        # a base too small for its reciprocal to be finite (f16): both snap
        # tests compare inf or NaN, which is false in Rust
        return base, inv_base
    round_inv_base = round_half_away(np.asarray(inv_base))[()]
    decimal_inv_base = F.type(10.0 ** round(float(np.log10(np.float64(inv_base)))))
    if np.abs(inv_base - round_inv_base) < F.type(SNAP_THRESHOLD_ABSOLUTE):
        return F.type(1.0) / round_inv_base, round_inv_base
    if np.abs(inv_base - decimal_inv_base) / inv_base < F.type(SNAP_THRESHOLD_DECIMAL_RELATIVE):
        return F.type(1.0) / decimal_inv_base, decimal_inv_base
    return base, inv_base


def choose_config(nt: NumberType, sample: np.ndarray):
    base = _choose_config_by_trailing_zeros(nt, sample)
    if base is not None:
        return base, nt.np_dtype.type(1.0) / base
    base = _approx_sample_gcd_euclidean(nt, sample)
    if base is None:
        return None
    base = _center_sample_base(nt, base, sample)
    return _snap_to_int_reciprocal(nt, base)


def bits_saved_per_num_over_classic(nt: NumberType, base, inv_base, sample: np.ndarray):
    """ref: float_mult.rs:631-668."""
    L = nt.latent.np_dtype
    mult = round_half_away(sample * inv_base)
    primary = nt.int_float_to_latent(mult)
    exps_u32 = nt.exponent(mult).astype(np.int64) & 0xFFFFFFFF
    inter_base_bits = np.maximum(nt.precision_bits - exps_u32, 0)
    approx_unsigned = nt.to_latent_ordered(mult * base)
    x_unsigned = nt.to_latent_ordered(sample)
    abs_adj = np.maximum(x_unsigned, approx_unsigned) - np.minimum(x_unsigned, approx_unsigned)
    lz = leading_zeros_uint(abs_adj.astype(np.uint64), 64) - (64 - nt.latent.bits)
    adj_bits = 1 + 2 * (nt.latent.bits - lz)
    bits_saved = inter_base_bits.astype(np.float64) - adj_bits.astype(np.float64)
    est = sampling.est_bits_saved_per_num(primary, bits_saved)
    if est >= MULT_REQUIRED_BITS_SAVED_PER_NUM:
        return est
    return None


def compute_bid(nt: NumberType, sample: np.ndarray):
    """Returns (base_float, bits_saved_per_num) or None."""
    cfg = choose_config(nt, sample)
    if cfg is None:
        return None
    base, inv_base = cfg
    est = bits_saved_per_num_over_classic(nt, base, inv_base, sample)
    if est is None:
        return None
    return base, inv_base, est
