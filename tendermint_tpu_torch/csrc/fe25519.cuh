// GF(2^255-19) for one CUDA thread: ten signed limbs in radix 2^25.5.
//
// The JAX package keeps field elements as 32 radix-2^8 limbs because a TPU
// has no 64-bit multiply (tendermint_tpu/ops/field.py). Hopper multiplies
// 32x32->64 bits in one instruction (IMAD.WIDE), so here an element is ten
// int32 limbs of 26,25,26,25,... bits (the ref10 layout): a product is 100
// wide multiplies and one carry chain instead of 1024 narrow ones.
//
// Bounds: a carried element has |limb| <= 2^25 (even limbs) / 2^24 (odd
// limbs); limb 1 may exceed that by < 2^17. fe_mul accepts sums of up to
// three carried elements on either side: then 19 * g_j stays below
// 19 * 3 * 2^25 < 2^31 and 2 * f_i (odd i) below 2^27, both int32, every
// product term is below 2^59 and a ten-term column below 2^62, inside
// int64. The curve formulas (ge25519.cuh) carry where a sum would grow
// past three. Everything crossing the kernel boundary is radix-2^8 bytes
// or limbs (the port's layout), converted by fe_from_limbs8 / fe_tobytes.
#pragma once
#include <stdint.h>

struct fe {
  int32_t v[10];
};

__device__ __constant__ int32_t FE_D[10] = {
    56195235, 13857412, 51736253, 6949390, 114729,
    24766616, 60832955, 30306712, 48412415, 21499315};
__device__ __constant__ int32_t FE_D2[10] = {
    45281625, 27714825, 36363642, 13898781, 229458,
    15978800, 54557047, 27058993, 29715967, 9444199};
__device__ __constant__ int32_t FE_SQRTM1[10] = {
    34513072, 25610706, 9377949, 3500415, 12389472,
    33281959, 41962654, 31548777, 326685, 11406482};

// Bit offset of each limb: limb i holds bits [OFF(i), OFF(i+1)).
__device__ __forceinline__ constexpr int fe_off(int i) { return (51 * i + 1) / 2; }
__device__ __forceinline__ constexpr int fe_width(int i) { return (i & 1) ? 25 : 26; }

__device__ __forceinline__ void fe_const(fe &h, const int32_t *c) {
#pragma unroll
  for (int i = 0; i < 10; i++) h.v[i] = c[i];
}

__device__ __forceinline__ void fe_zero(fe &h) {
#pragma unroll
  for (int i = 0; i < 10; i++) h.v[i] = 0;
}

__device__ __forceinline__ void fe_one(fe &h) {
  fe_zero(h);
  h.v[0] = 1;
}

__device__ __forceinline__ void fe_copy(fe &h, const fe &f) {
#pragma unroll
  for (int i = 0; i < 10; i++) h.v[i] = f.v[i];
}

__device__ __forceinline__ void fe_add(fe &h, const fe &f, const fe &g) {
#pragma unroll
  for (int i = 0; i < 10; i++) h.v[i] = f.v[i] + g.v[i];
}

__device__ __forceinline__ void fe_sub(fe &h, const fe &f, const fe &g) {
#pragma unroll
  for (int i = 0; i < 10; i++) h.v[i] = f.v[i] - g.v[i];
}

__device__ __forceinline__ void fe_neg(fe &h, const fe &f) {
#pragma unroll
  for (int i = 0; i < 10; i++) h.v[i] = -f.v[i];
}

// Rounding carry chain over 64-bit columns: every limb ends centered in
// [-2^(w-1), 2^(w-1)), the carry out of limb 9 (weight 2^255) folds into
// limb 0 times 19, and one last step carries limb 0 into limb 1.
__device__ __forceinline__ void fe_carry_wide(fe &h, int64_t t[10]) {
  int64_t c;
#pragma unroll
  for (int i = 0; i < 9; i++) {
    const int w = fe_width(i);
    c = (t[i] + ((int64_t)1 << (w - 1))) >> w;
    t[i + 1] += c;
    t[i] -= c * ((int64_t)1 << w);
  }
  c = (t[9] + ((int64_t)1 << 24)) >> 25;
  t[9] -= c * ((int64_t)1 << 25);
  t[0] += c * 19;
  c = (t[0] + ((int64_t)1 << 25)) >> 26;
  t[0] -= c * ((int64_t)1 << 26);
  t[1] += c;
#pragma unroll
  for (int i = 0; i < 10; i++) h.v[i] = (int32_t)t[i];
}

__device__ __forceinline__ void fe_carry(fe &h, const fe &f) {
  int64_t t[10];
#pragma unroll
  for (int i = 0; i < 10; i++) t[i] = f.v[i];
  fe_carry_wide(h, t);
}

// h = f * g mod p. Limb i times limb j lands in column i + j; a column
// past 9 wraps with 2^255 = 19, and odd-times-odd limbs carry an extra 2
// because their offsets round down twice. Both factors are folded into
// 32-bit operands first (2*f_i for odd i, 19*g_j), so every term is one
// 32x32->64 multiply-add into its column.
__device__ __forceinline__ void fe_mul(fe &h, const fe &f, const fe &g) {
  int32_t f2[10], g19[10];
#pragma unroll
  for (int i = 0; i < 10; i++) {
    f2[i] = (i & 1) ? 2 * f.v[i] : f.v[i];
    g19[i] = 19 * g.v[i];
  }
  int64_t t[10];
#pragma unroll
  for (int k = 0; k < 10; k++) t[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
#pragma unroll
    for (int j = 0; j < 10; j++) {
      const int k = i + j;
      const int32_t a = ((i & 1) && (j & 1)) ? f2[i] : f.v[i];
      const int32_t b = k >= 10 ? g19[j] : g.v[j];
      t[k >= 10 ? k - 10 : k] += (int64_t)a * b;
    }
  }
  fe_carry_wide(h, t);
}

__device__ __forceinline__ void fe_sq(fe &h, const fe &f) { fe_mul(h, f, f); }

__device__ __forceinline__ void fe_mul_c(fe &h, const fe &f, const int32_t *c) {
  fe g;
  fe_const(g, c);
  fe_mul(h, f, g);
}

// From 32 signed radix-2^8 limbs (bytes, or the int16 cache tables whose
// limbs satisfy |limb| < 2^9): value = sum l_i 2^(8i), reduced mod p by
// the carry chain.
template <typename T>
__device__ __forceinline__ void fe_from_limbs8(fe &h, const T *l) {
  int64_t t[10];
#pragma unroll
  for (int k = 0; k < 10; k++) t[k] = 0;
#pragma unroll
  for (int i = 0; i < 32; i++) {
    const int bit = 8 * i;
    int k = 0;
#pragma unroll
    for (int j = 1; j < 10; j++)
      if (fe_off(j) <= bit) k = j;
    t[k] += (int64_t)l[i] * ((int64_t)1 << (bit - fe_off(k)));
  }
  fe_carry_wide(h, t);
}

// Canonical little-endian bytes of a carried element (ref10's fe_tobytes:
// q = floor(h / p) from the top limb down, subtract q*p, carry exactly).
__device__ __forceinline__ void fe_tobytes(uint8_t s[32], const fe &f) {
  fe c;
  fe_carry(c, f);
  int32_t h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = c.v[i];
  int32_t q = (19 * h[9] + (1 << 24)) >> 25;
#pragma unroll
  for (int i = 0; i < 10; i++) q = (h[i] + q) >> fe_width(i);
  h[0] += 19 * q;
#pragma unroll
  for (int i = 0; i < 9; i++) {
    const int w = fe_width(i);
    const int32_t carry = h[i] >> w;
    h[i + 1] += carry;
    h[i] -= carry * (1 << w);
  }
  h[9] &= (1 << 25) - 1;  // drops q * 2^255
  uint64_t acc = 0;
  int nbits = 0, o = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    acc |= (uint64_t)(uint32_t)h[i] << nbits;
    nbits += fe_width(i);
    while (nbits >= 8) {
      s[o++] = (uint8_t)(acc & 0xff);
      acc >>= 8;
      nbits -= 8;
    }
  }
  s[31] = (uint8_t)(acc & 0xff);
}

__device__ __forceinline__ bool fe_iszero(const fe &f) {
  uint8_t s[32];
  fe_tobytes(s, f);
  uint8_t acc = 0;
#pragma unroll
  for (int i = 0; i < 32; i++) acc |= s[i];
  return acc == 0;
}

__device__ __forceinline__ int fe_parity(const fe &f) {
  uint8_t s[32];
  fe_tobytes(s, f);
  return s[0] & 1;
}

__device__ __forceinline__ void fe_sqn(fe &h, const fe &f, int n) {
  fe_sq(h, f);
  for (int i = 1; i < n; i++) fe_sq(h, h);
}

// z^((p-5)/8) = z^(2^252 - 3), the reference's addition chain.
__device__ __forceinline__ void fe_pow_p58(fe &out, const fe &z) {
  fe z2, z9, z11, t, z_5_0, z_10_0, z_20_0, z_50_0, z_100_0;
  fe_sq(z2, z);
  fe_sqn(t, z2, 2);
  fe_mul(z9, t, z);
  fe_mul(z11, z9, z2);
  fe_sq(t, z11);
  fe_mul(z_5_0, t, z9);
  fe_sqn(t, z_5_0, 5);
  fe_mul(z_10_0, t, z_5_0);
  fe_sqn(t, z_10_0, 10);
  fe_mul(z_20_0, t, z_10_0);
  fe_sqn(t, z_20_0, 20);
  fe_mul(t, t, z_20_0);  // 2^40 - 1
  fe_sqn(t, t, 10);
  fe_mul(z_50_0, t, z_10_0);
  fe_sqn(t, z_50_0, 50);
  fe_mul(z_100_0, t, z_50_0);
  fe_sqn(t, z_100_0, 100);
  fe_mul(t, t, z_100_0);  // 2^200 - 1
  fe_sqn(t, t, 50);
  fe_mul(t, t, z_50_0);  // 2^250 - 1
  fe_sqn(t, t, 2);
  fe_mul(out, t, z);
}
