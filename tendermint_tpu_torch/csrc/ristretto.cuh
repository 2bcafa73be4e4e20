// Ristretto255 codec for one CUDA thread (RFC 9496 §4.2-4.3), on the
// ten-limb field of fe25519.cuh and the extended points of ge25519.cuh.
//
// The sequence is the JAX package's (tendermint_tpu/ops/ristretto.py:29-103)
// and the port's plain version's (ops/ristretto.py), so every value equals
// the reference's modulo p. Ristretto is not ZIP-215: decoding rejects a
// non-canonical s (the raw bytes must equal their reduced value), an odd
// s, a non-square, a negative t and y = 0, and every sign test reads the
// fully reduced value (fe_parity). The group has prime order: points are
// equal when their encodings are, and the identity encodes as 32 zero
// bytes. The encoding does not change under projective scaling of
// (X : Y : Z : T), so any consistent representative (T Z = X Y) encodes
// the same.
//
// Field operations, counted for the bound in chip_smoke.py: decode 256
// squarings and 18 multiplications, encode 255 squarings and 21
// multiplications (the conditional products counted as taken).
#pragma once
#include "ge25519.cuh"

// invsqrt(-1 - d) (RFC 9496 §4.1), canonical limbs.
__device__ __constant__ int32_t FE_INVSQRT_A_MINUS_D[10] = {
    6111466, 4156064, 39310137, 12243467, 41204824,
    120896, 20826367, 26493656, 6093567, 31568420};

// CT_ABS: the non-negative (even) representative, carried.
__device__ __forceinline__ void fe_abs(fe &h, const fe &f) {
  fe c;
  fe_carry(c, f);
  if (fe_parity(c))
    fe_neg(h, c);
  else
    fe_copy(h, c);
}

// SQRT_RATIO_M1(u, v): r = the non-negative sqrt(u/v) or sqrt(i*u/v);
// returns whether u/v was square. u and v are carried or sums of two.
__device__ __forceinline__ bool sqrt_ratio_m1(fe &r_out, const fe &u, const fe &v) {
  fe v3, v7, t, r, check;
  fe_sq(t, v);
  fe_mul(v3, t, v);
  fe_sq(t, v3);
  fe_mul(v7, t, v);
  fe_mul(t, u, v7);
  fe_pow_p58(t, t);
  fe_mul(r, u, v3);
  fe_mul(r, r, t);
  fe_sq(t, r);
  fe_mul(check, v, t);
  fe_sub(t, check, u);
  const bool correct = fe_iszero(t);
  fe_add(t, check, u);
  const bool flipped = fe_iszero(t);  // check == -u
  fe_mul_c(t, u, FE_SQRTM1);
  fe_add(t, check, t);
  const bool flipped_i = fe_iszero(t);  // check == -u * i
  if (flipped || flipped_i) fe_mul_c(r, r, FE_SQRTM1);
  fe_abs(r_out, r);
  return correct || flipped;
}

// Decode 32 bytes (RFC 9496 §4.3.1). On rejection the point is still the
// deterministic candidate, as in the reference.
__device__ __forceinline__ bool ristretto_decode(ge &p, const uint8_t *enc) {
  uint8_t b[32], c[32];
#pragma unroll
  for (int i = 0; i < 32; i++) b[i] = enc[i];
  fe s, one, ss, u1, u2, u2_sqr, v, t, invsqrt, den_x, den_y;
  fe_from_limbs8(s, b);  // all 256 bits: a set bit 255 makes s non-canonical
  fe_tobytes(c, s);
  bool canonical = true;
#pragma unroll
  for (int i = 0; i < 32; i++) canonical = canonical && c[i] == b[i];
  const bool even = (b[0] & 1) == 0;
  fe_one(one);
  fe_sq(ss, s);
  fe_sub(u1, one, ss);
  fe_add(u2, one, ss);
  fe_sq(u2_sqr, u2);
  fe_mul_c(t, u1, FE_D);
  fe_mul(t, t, u1);
  fe_neg(t, t);
  fe_sub(v, t, u2_sqr);  // -(d u1^2) - u2^2
  fe_mul(t, v, u2_sqr);
  const bool was_square = sqrt_ratio_m1(invsqrt, one, t);
  fe_mul(den_x, invsqrt, u2);
  fe_mul(t, invsqrt, den_x);
  fe_mul(den_y, t, v);
  fe_add(t, s, s);
  fe_mul(t, t, den_x);
  fe_abs(p.X, t);
  fe_mul(p.Y, u1, den_y);
  fe_one(p.Z);
  fe_mul(p.T, p.X, p.Y);
  return canonical && even && was_square && !fe_parity(p.T) && !fe_iszero(p.Y);
}

// Encode a point with a consistent T (RFC 9496 §4.3.2) into canonical
// bytes. Coordinates are carried (outputs of the curve formulas).
__device__ __forceinline__ void ristretto_encode(uint8_t out[32], const ge &p) {
  fe u1, u2, t, t2, one, invsqrt, den1, den2, z_inv, x, y, den_inv;
  fe_add(t, p.Z, p.Y);
  fe_sub(t2, p.Z, p.Y);
  fe_mul(u1, t, t2);
  fe_mul(u2, p.X, p.Y);
  fe_sq(t, u2);
  fe_mul(t, u1, t);
  fe_one(one);
  sqrt_ratio_m1(invsqrt, one, t);
  fe_mul(den1, invsqrt, u1);
  fe_mul(den2, invsqrt, u2);
  fe_mul(t, den1, den2);
  fe_mul(z_inv, t, p.T);
  fe_mul(t, p.T, z_inv);
  if (fe_parity(t)) {  // rotate
    fe_mul_c(x, p.Y, FE_SQRTM1);
    fe_mul_c(y, p.X, FE_SQRTM1);
    fe_mul_c(den_inv, den1, FE_INVSQRT_A_MINUS_D);
  } else {
    fe_copy(x, p.X);
    fe_copy(y, p.Y);
    fe_copy(den_inv, den2);
  }
  fe_mul(t, x, z_inv);
  if (fe_parity(t)) fe_neg(y, y);
  fe_sub(t, p.Z, y);
  fe_mul(t, den_inv, t);
  fe_abs(t, t);
  fe_tobytes(out, t);
}

// Equality of two ristretto255 elements given by Edwards representatives
// in 2E (RFC 9496 section 4.5): X1 Y2 == Y1 X2 or Y1 Y2 == X1 X2, 4
// products, projective and blind to T.
__device__ __forceinline__ bool ristretto_equal(const ge &p, const ge &q) {
  fe l, r, t;
  fe_mul(l, p.X, q.Y);
  fe_mul(r, p.Y, q.X);
  fe_sub(t, l, r);
  const bool xy = fe_iszero(t);
  fe_mul(l, p.Y, q.Y);
  fe_mul(r, p.X, q.X);
  fe_sub(t, l, r);
  return xy || fe_iszero(t);
}
