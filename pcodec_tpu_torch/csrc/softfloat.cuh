// The IEEE-754 binary multiply in integer operations, on the card: the
// CUDA counterpart of pcodec_tpu_torch/ops/softfloat.py (itself the port
// of pcodec_tpu/ops/softfloat.py), step for step, so that its bits equal
// that module's for every input, garbage above the W-bit pattern included.
//
// Each value is a u64 holding a W-bit pattern in its low bits. W, E, P
// (width, exponent bits, mantissa digits including the implicit one) are
// template arguments: (16, 5, 11), (32, 8, 24), (64, 11, 53). sf_mul_bits
// reproduces the host's (x86) multiply bit for bit: round to nearest even,
// subnormal inputs and outputs, signed zeros, overflow to inf, and x86 NaN
// propagation (a NaN x wins, quieted; else a NaN y, quieted; inf * 0 is the
// negative default NaN). The card's own f16 and f32 multiplies give other
// NaN payloads, so no float instruction is used: the mantissas' 2P-bit
// product is one 64-bit multiply and its high half (__umul64hi).
#pragma once

#include <cstdint>

namespace softfloat {

using u64 = unsigned long long;

// floor(log2(x)) for x > 0 (0 for x == 0)
__device__ __forceinline__ long long msb_pos(u64 x) { return x ? 63 - __clzll((long long)x) : 0; }

// logical right shift by s in [0, 63]
__device__ __forceinline__ u64 srl(u64 x, long long s) { return x >> s; }

// float memory bits -> order-preserving latent (the float bijection)
template <int W>
__device__ __forceinline__ u64 ordered_from_bits(u64 bits) {
  constexpr u64 mask = W >= 64 ? ~0ull : (1ull << W) - 1;
  constexpr u64 sign = 1ull << (W - 1);
  return (bits & sign) ? (~bits) & mask : bits ^ sign;
}

// order-preserving latent -> float memory bits (the inverse bijection)
template <int W>
__device__ __forceinline__ u64 bits_from_ordered(u64 lat) {
  constexpr u64 mask = W >= 64 ? ~0ull : (1ull << W) - 1;
  constexpr u64 sign = 1ull << (W - 1);
  return (lat & sign) ? lat ^ sign : (~lat) & mask;
}

// mantissa scaled to [2^(P-1), 2^P) and unbiased exponent of a finite
// nonzero field (garbage, as in ops/softfloat.py, for the others)
template <int P, int BIAS>
__device__ __forceinline__ void normalize(u64 m, long long e_raw, bool sub, u64& mant, long long& exp) {
  const long long q = msb_pos(m ? m : 1);
  mant = sub ? m << ((P - 1) - q) : m | (1ull << (P - 1));
  exp = sub ? q - (P - 1) + (1 - BIAS) : e_raw - BIAS;
}

// IEEE round-to-nearest-even product bits of two W-bit floats
template <int W, int E, int P>
__device__ __forceinline__ u64 sf_mul_bits(u64 x, u64 y) {
  constexpr int BIAS = (1 << (E - 1)) - 1;
  constexpr u64 sign_bit = 1ull << (W - 1);
  constexpr u64 mant_mask = (1ull << (P - 1)) - 1;
  constexpr u64 exp_raw_mask = (1ull << E) - 1;
  constexpr u64 quiet = 1ull << (P - 2);
  constexpr u64 inf_field = exp_raw_mask << (P - 1);

  const u64 ex = (x >> (P - 1)) & exp_raw_mask, mx = x & mant_mask;
  const u64 ey = (y >> (P - 1)) & exp_raw_mask, my = y & mant_mask;
  const bool nan_x = ex == exp_raw_mask && mx != 0, inf_x = ex == exp_raw_mask && mx == 0;
  const bool zero_x = ex == 0 && mx == 0, sub_x = ex == 0 && mx != 0;
  const bool nan_y = ey == exp_raw_mask && my != 0, inf_y = ey == exp_raw_mask && my == 0;
  const bool zero_y = ey == 0 && my == 0, sub_y = ey == 0 && my != 0;
  u64 mA, mB;
  long long eA, eB;
  normalize<P, BIAS>(mx, (long long)ex, sub_x, mA, eA);
  normalize<P, BIAS>(my, (long long)ey, sub_y, mB, eB);

  const u64 lo = mA * mB, hi = __umul64hi(mA, mB);
  // align the 2P-bit product so its top set bit lands at 63 (big) or 62
  bool sticky0;
  u64 v;
  if constexpr (2 * P > 64) {
    constexpr int drop = 2 * P - 64;
    sticky0 = (lo & ((1ull << drop) - 1)) != 0;
    v = (hi << (64 - drop)) | (lo >> drop);
  } else {
    sticky0 = false;
    v = lo << (64 - 2 * P);
  }
  const bool big = (v >> 63) != 0;
  const long long erb = eA + eB + (big ? 1 : 0) + BIAS;  // biased result exponent
  // alignment shift to a P-bit mantissa incl. implicit; more for subnormals
  const long long s_unc = (big ? 64 - P : 63 - P) + (1 - erb > 0 ? 1 - erb : 0);
  const long long s = s_unc < 1 ? 1 : (s_unc > 63 ? 63 : s_unc);

  u64 mant = srl(v, s);
  u64 rbit = srl(v, s - 1) & 1;
  bool sticky = sticky0 || (v & ((1ull << (s - 1)) - 1)) != 0;
  // deep underflow: s_unc == 64 keeps only the top bit as the round bit;
  // s_unc > 64 shifts everything into sticky
  if (s_unc > 63) mant = 0;
  if (s_unc == 64) {
    rbit = v >> 63;
    sticky = sticky0 || (v & ((1ull << 63) - 1)) != 0;
  } else if (s_unc > 64) {
    rbit = 0;
    sticky = true;
  }

  const long long ebm1 = erb - 1 > 0 ? erb - 1 : 0;
  // (ebm1 << (P-1)) + mant-with-implicit encodes normals and subnormals and
  // lets the rounding carry ripple into the exponent
  u64 bits = ((u64)ebm1 << (P - 1)) + mant;
  if (rbit == 1 && (sticky || (mant & 1) == 1)) bits += 1;
  if (!(bits < inf_field)) bits = inf_field;  // overflow -> inf

  const u64 sign = (x & sign_bit) ^ (y & sign_bit);
  u64 out = sign | bits;
  if (zero_x || zero_y) out = sign;
  if (inf_x || inf_y) out = sign | inf_field;
  if ((inf_x && zero_y) || (zero_x && inf_y)) out = sign_bit | inf_field | quiet;
  if (nan_y) out = y | quiet;
  if (nan_x) out = x | quiet;
  return out;
}

// float memory bits of the integer-valued float a latent denotes (the
// inverse of the encoder's int_float_to_latent)
template <int W, int E, int P>
__device__ __forceinline__ u64 int_float_latent_to_bits(u64 lat) {
  constexpr long long BIAS = (1 << (E - 1)) - 1;
  constexpr u64 mid = 1ull << (W - 1);
  constexpr u64 gpi = 1ull << P;
  constexpr u64 gpi_bits = (u64)(P + BIAS) << (P - 1);
  const bool neg = lat < mid;
  const u64 a = neg ? (mid - 1) - lat : lat - mid;
  // small path: exact int -> float bits for 0 < a < 2^P
  const long long t = msb_pos(a ? a : 1);
  const u64 mant = (a << ((P - 1) - (t < P - 1 ? t : P - 1))) & ((1ull << (P - 1)) - 1);
  const u64 small_bits = a ? ((u64)(t + BIAS) << (P - 1)) | mant : 0;
  const u64 bits = a < gpi ? small_bits : gpi_bits + (a - gpi);
  // negation is a sign-bit flip: the big-path bit trick can carry into the
  // sign bit, which -x then clears
  return neg ? bits ^ mid : bits;
}

// the latent of the W-bit float p rounded half away from zero
// (int_float_to_latent(round_half_away(p))), in bit operations: exact for
// every input, inf and NaN (the bit-trick path) and signed zeros (zero is
// always the middle) included; ops/softfloat.py::round_half_away_latent
template <int W, int E, int P>
__device__ __forceinline__ u64 round_half_away_latent(u64 p) {
  constexpr long long BIAS = (1 << (E - 1)) - 1;
  constexpr u64 sign_bit = 1ull << (W - 1);
  constexpr u64 mant_mask = (1ull << (P - 1)) - 1;
  constexpr u64 exp_raw_mask = (1ull << E) - 1;
  constexpr u64 gpi = 1ull << P;
  constexpr u64 gpi_bits = (u64)(P + BIAS) << (P - 1);  // the bits of float(2^P)
  constexpr u64 mask = W >= 64 ? ~0ull : (1ull << W) - 1;

  bool neg = (p & sign_bit) != 0;
  u64 abs_bits = p & (sign_bit - 1);
  const u64 ex = (p >> (P - 1)) & exp_raw_mask;
  const long long e = (long long)ex - BIAS;  // subnormals land at e = -BIAS (< -1)
  const u64 m = (p & mant_mask) | (1ull << (P - 1));
  // 0 <= e <= P-2: the integer part plus the bump of the top fraction bit
  const long long k0 = P - 1 - e;
  const long long k = k0 < 1 ? 1 : (k0 > P - 1 ? P - 1 : k0);
  const u64 small_abs = (m >> k) + ((m >> (k - 1)) & 1);
  u64 abs_int = e < -1 ? 0 : (e == -1 ? 1 : small_abs);
  if (ex == 0) abs_int = 0;
  const bool big = e >= P - 1;  // an integer already; inf and NaN too
  // trunc quiets a signalling NaN before the bit trick sees it
  if (ex == exp_raw_mask && (p & mant_mask) != 0) abs_bits |= 1ull << (P - 2);
  const u64 abs_lat = big ? gpi + (abs_bits - gpi_bits) : abs_int;
  // trunc(x) + 0.0 makes a -0.0 result positive
  neg = neg && (abs_lat != 0 || big);
  return (neg ? (sign_bit - 1) - abs_lat : sign_bit + abs_lat) & mask;
}

// The FloatMult join of one number: its primary latent p (the
// multiplier) and secondary latent a (the adjustment), W-bit latents in
// u64, and base, the chunk's base float's memory bits -> the number's
// memory bits:
//   mult = int_float_latent_to_bits(p & mask)    the integer-valued float
//   prod = sf_mul_bits(mult, base)                mult * base, softfloat
//   lat  = (ordered_from_bits(prod) + (a & mask) + mid) & mask
// then lat's memory bits (the float bijection's inverse)
template <int W, int E, int P>
__device__ __forceinline__ u64 float_mult_join_bits(u64 p, u64 a, u64 base) {
  constexpr u64 mask = W >= 64 ? ~0ull : (1ull << W) - 1;
  constexpr u64 mid = 1ull << (W - 1);
  const u64 mult = int_float_latent_to_bits<W, E, P>(p & mask);
  const u64 prod = sf_mul_bits<W, E, P>(mult, base);
  const u64 lat = (ordered_from_bits<W>(prod) + (a & mask) + mid) & mask;
  return bits_from_ordered<W>(lat);
}

}  // namespace softfloat
