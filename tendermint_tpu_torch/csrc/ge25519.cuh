// Edwards25519 points for one CUDA thread, in extended coordinates
// (X : Y : Z : T), x = X/Z, y = Y/Z, T = XY/Z.
//
// The formulas and their order are the JAX package's
// (tendermint_tpu/ops/curve.py): the unified add-2008-hwcd-3 addition and
// the dbl-2008-hwcd doubling, so a table built here holds, coordinate by
// coordinate, the same field values as the reference's. Both laws are
// complete on ed25519, so the small-order points ZIP-215 admits need no
// special case.
#pragma once
#include "fe25519.cuh"

struct ge {
  fe X, Y, Z, T;
};

__device__ __forceinline__ void ge_identity(ge &p) {
  fe_zero(p.X);
  fe_one(p.Y);
  fe_one(p.Z);
  fe_zero(p.T);
}

// r = p + q: 8M, plus 1M for T when out_t (otherwise T is left unset).
__device__ __forceinline__ void ge_add(ge &r, const ge &p, const ge &q, bool out_t) {
  fe a, b, c, d, e, f, g, h, t0, t1;
  fe_sub(t0, p.Y, p.X);
  fe_sub(t1, q.Y, q.X);
  fe_mul(a, t0, t1);
  fe_add(t0, p.Y, p.X);
  fe_add(t1, q.Y, q.X);
  fe_mul(b, t0, t1);
  fe_mul(t0, p.T, q.T);
  fe_mul_c(c, t0, FE_D2);
  fe_mul(t0, p.Z, q.Z);
  fe_add(d, t0, t0);
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  if (out_t) fe_mul(r.T, e, h);
}

// r = 2p: 4S + 3M, plus 1M for T when out_t. Never reads p.T.
__device__ __forceinline__ void ge_dbl(ge &r, const ge &p, bool out_t) {
  fe a, b, c, d, e, f, g, h, t0;
  fe_sq(a, p.X);
  fe_sq(b, p.Y);
  fe_sq(t0, p.Z);
  fe_add(t0, t0, t0);
  fe_carry(c, t0);  // keeps f = g - c a sum of three (fe25519.cuh bounds)
  fe_add(t0, p.X, p.Y);
  fe_sq(d, t0);
  fe_sub(e, d, a);
  fe_sub(e, e, b);  // (X+Y)^2 - A - B
  fe_sub(g, b, a);
  fe_sub(f, g, c);
  fe_add(h, a, b);
  fe_neg(h, h);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  if (out_t) fe_mul(r.T, e, h);
}

__device__ __forceinline__ void ge_neg(ge &r, const ge &p) {
  fe_neg(r.X, p.X);
  fe_copy(r.Y, p.Y);
  fe_copy(r.Z, p.Z);
  fe_neg(r.T, p.T);
}

__device__ __forceinline__ bool ge_is_identity(const ge &p) {
  fe t;
  fe_sub(t, p.Y, p.Z);
  return fe_iszero(p.X) && fe_iszero(t);
}

// Projective equality by cross multiplication.
__device__ __forceinline__ bool ge_equal(const ge &p, const ge &q) {
  fe l, r, t;
  fe_mul(l, p.X, q.Z);
  fe_mul(r, q.X, p.Z);
  fe_sub(t, l, r);
  const bool ex = fe_iszero(t);
  fe_mul(l, p.Y, q.Z);
  fe_mul(r, q.Y, p.Z);
  fe_sub(t, l, r);
  return ex && fe_iszero(t);
}

// ZIP-215 decoding of a 32-byte encoding, the reference's sequence
// (tendermint_tpu/ops/curve.py decompress): y is taken mod p without a
// canonicity check, the only rejection is a non-square x^2 candidate, and
// the sign fix reads the parity of the fully reduced x, so x = 0 with the
// sign bit set decodes to x = 0. On rejection the point is still the
// deterministic candidate, as in the reference.
__device__ __forceinline__ bool ge_decompress(ge &p, const uint8_t *enc) {
  uint8_t yb[32];
#pragma unroll
  for (int i = 0; i < 32; i++) yb[i] = enc[i];
  const int sign = yb[31] >> 7;
  yb[31] &= 0x7f;
  fe y, one, yy, u, v, v3, v7, t, x, vxx;
  fe_from_limbs8(y, yb);
  fe_one(one);
  fe_sq(yy, y);
  fe_sub(u, yy, one);
  fe_mul_c(t, yy, FE_D);
  fe_add(v, t, one);
  fe_sq(t, v);
  fe_mul(v3, t, v);
  fe_sq(t, v3);
  fe_mul(v7, t, v);
  fe_mul(t, u, v7);
  fe_pow_p58(t, t);
  fe_mul(x, u, v3);
  fe_mul(x, x, t);
  fe_sq(t, x);
  fe_mul(vxx, v, t);
  fe_sub(t, vxx, u);
  const bool is_root = fe_iszero(t);
  fe_add(t, vxx, u);
  const bool is_neg_root = fe_iszero(t);
  if (!is_root) fe_mul_c(x, x, FE_SQRTM1);
  fe_carry(x, x);
  if (fe_parity(x) != sign) fe_neg(x, x);
  fe_carry(p.X, x);
  fe_carry(p.Y, y);
  fe_one(p.Z);
  fe_mul(p.T, p.X, p.Y);
  return is_root || is_neg_root;
}

// Radix-2^8 limbs of one point, as the port's tables lay them out:
// coordinate c at limbs[c * 32 .. c * 32 + 31].
template <typename T>
__device__ __forceinline__ void ge_from_limbs8(ge &p, const T *limbs) {
  fe_from_limbs8(p.X, limbs);
  fe_from_limbs8(p.Y, limbs + 32);
  fe_from_limbs8(p.Z, limbs + 64);
  fe_from_limbs8(p.T, limbs + 96);
}

// Points in a strided scratch array: limb l of coordinate c of point j at
// base[((j * 4 + c) * 10 + l) * stride], so neighbouring threads (stride
// 1 apart in `base`) touch neighbouring words.
__device__ __forceinline__ void ge_store(int32_t *base, int j, int stride, const ge &p) {
  const fe *c[4] = {&p.X, &p.Y, &p.Z, &p.T};
#pragma unroll
  for (int k = 0; k < 4; k++)
#pragma unroll
    for (int l = 0; l < 10; l++) base[(size_t)((j * 4 + k) * 10 + l) * stride] = c[k]->v[l];
}

__device__ __forceinline__ void ge_load(ge &p, const int32_t *base, int j, int stride) {
  fe *c[4] = {&p.X, &p.Y, &p.Z, &p.T};
#pragma unroll
  for (int k = 0; k < 4; k++)
#pragma unroll
    for (int l = 0; l < 10; l++) c[k]->v[l] = base[(size_t)((j * 4 + k) * 10 + l) * stride];
}

// 4-bit window w (0 = least significant) of a 32-byte little-endian scalar.
__device__ __forceinline__ int nibble(const uint8_t *s, int w) {
  const int b = s[w >> 1];
  return (w & 1) ? (b >> 4) : (b & 15);
}

// Multiples 0..15 of p (with T) into scratch slots 0..15, by repeated
// addition as the reference's _build_var_table.
__device__ __forceinline__ void ge_build_table(int32_t *base, int stride, const ge &p) {
  ge acc;
  ge_identity(acc);
  ge_store(base, 0, stride, acc);
  ge_store(base, 1, stride, p);
  ge_add(acc, p, p, true);
  ge_store(base, 2, stride, acc);
  for (int j = 3; j < 16; j++) {
    ge_add(acc, acc, p, true);
    ge_store(base, j, stride, acc);
  }
}

// [8]q == [8]r, the cofactored acceptance tail of every bitmap kernel
// (reference: _cofactored_accept, tendermint_tpu/ops/verify.py).
__device__ __forceinline__ bool ge_cofactored_equal(ge q, ge r) {
#pragma unroll 1
  for (int i = 0; i < 3; i++) {
    ge_dbl(q, q, false);
    ge_dbl(r, r, false);
  }
  return ge_equal(q, r);
}

// Launch helper: blocks of `threads` covering n work items.
static inline int grid_for(int n, int threads) { return (n + threads - 1) / threads; }
