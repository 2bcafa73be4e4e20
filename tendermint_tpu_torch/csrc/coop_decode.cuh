// Point decoding by a quad: the four lanes of a quad (coop.cuh) hold the
// same key, and each field product of the decode is split across them.
//
// A one-lane decode (ge_decompress, ristretto_decode) is one chain of ~275
// dependent products, each 100 wide multiplies on that lane (fe_mul; a
// squaring is fe_mul(f, f)). Here lane q sums only columns q, q + 4 and
// q + 8 of the product (lanes 2 and 3 also sum columns 10 and 11, bounded
// as the others and never read): 30 of the 100 terms, or 18 of the 55
// distinct terms of a square (ref10's fe_sq). The quad then gathers the ten int64
// columns by shuffles (twenty of width 4), and every lane runs
// fe_carry_wide on them. A column is an exact integer whatever the order
// of its terms, so every lane ends with fe_mul's limbs, limb for limb, and
// every bound of fe25519.cuh and ge25519.cuh holds as it does there.
//
// Every lane runs the same instructions: what differs by lane is data,
// chosen by selects. Column k = q + 4m takes f_i times g_(k-i) for
// i = 0..9, the index wrapping with a factor 19 when i > k, and times 2
// when i and k - i are both odd, that is, i odd on an even lane. So lane
// q reads g shifted by q (H[q + r] below, two stages of selects) and f
// doubled at odd i on even lanes. A square's column k = q + 4m takes the
// pairs (i, j) = (ceil(k/2) + t, floor(k/2) - t), t = 0..5 (t = 5 only for
// even k, the second diagonal): x = f shifted by ceil(q/2), y = f shifted
// by floor(q/2) with 19 f_(j+10) for j < 0, and a factor c_t in {0, 1, 2,
// 4} per lane (2 for a pair, 1 for a diagonal, twice that for odd times
// odd). Bounds: 19 lies on y (below 19 * 3 * 2^25 < 2^31, as fe_mul's
// g19) and c_t on x (at most 4 * 3 * 2^24 on odd limbs, 2 * 3 * 2^25 on
// even ones), so no int32 operand overflows; 2 * 19 would, so it is never
// folded into one operand.
//
// The decoders below repeat the one-lane sequences (fe_pow_p58,
// ge_decompress, sqrt_ratio_m1, ristretto_decode) on these products. They
// differ in one point: a conditional product (times sqrt(-1)) runs on
// every lane and a select keeps it, because quads of one warp decode
// different keys and must all reach each shuffle; the one-lane decoders
// keep their branch.
//
// Users: the single-table fills (pk_tables_single.cu with
// coop_ge_decompress, sr_tables_single.cu with coop_ristretto_decode),
// through coop_fill. Every lane of the warp must call these together (the
// shuffles take the whole warp's mask).
#pragma once
#include "coop.cuh"
#include "ristretto.cuh"

// Lane q's ten columns of the quad, gathered: column k lives on lane k & 3
// as its partial sum number k >> 2. Then fe_mul's carry chain.
__device__ __forceinline__ void coop_gather_carry(fe &h, const int64_t t[3]) {
  int64_t col[10];
#pragma unroll
  for (int k = 0; k < 10; k++) {
    const int64_t v = t[k >> 2];
    const int32_t lo = __shfl_sync(QUAD_ALL, (int32_t)(uint32_t)(uint64_t)v, k & 3, 4);
    const int32_t hi = __shfl_sync(QUAD_ALL, (int32_t)(v >> 32), k & 3, 4);
    col[k] = (int64_t)(((uint64_t)(uint32_t)hi << 32) | (uint32_t)lo);
  }
  fe_carry_wide(h, col);
}

// h = f * g mod p by the quad, limb for limb fe_mul's; f and g are the same
// on the quad's four lanes.
__device__ __forceinline__ void coop_fe_mul(fe &h, const fe &f, const fe &g, int q) {
  const bool odd = q & 1, two = q & 2;
  int32_t H[21];  // H[x + 9] = g_x for x in [0, 9], 19 g_(x+10) below, 0 above
#pragma unroll
  for (int x = 0; x < 9; x++) H[x] = 19 * g.v[x + 1];
#pragma unroll
  for (int x = 0; x < 10; x++) H[x + 9] = g.v[x];
  H[19] = H[20] = 0;
  int32_t H1[20];  // H[y + (q & 1)]
#pragma unroll
  for (int y = 0; y < 20; y++) H1[y] = odd ? H[y + 1] : H[y];
  int32_t S[18];  // S[r + 9] = H[q + r], r in [-9, 8]
#pragma unroll
  for (int r = 0; r < 18; r++) S[r] = two ? H1[r + 2] : H1[r];
  int32_t a[10];
#pragma unroll
  for (int i = 0; i < 10; i++) a[i] = ((i & 1) && !odd) ? 2 * f.v[i] : f.v[i];
  int64_t t[3];
#pragma unroll
  for (int m = 0; m < 3; m++) {
    t[m] = 0;
#pragma unroll
    for (int i = 0; i < 10; i++) t[m] += (int64_t)a[i] * S[4 * m - i + 9];
  }
  coop_gather_carry(h, t);
}

// h = f^2 mod p by the quad from the 55 distinct terms, limb for limb
// fe_mul(f, f)'s.
__device__ __forceinline__ void coop_fe_sq(fe &h, const fe &f, int q) {
  const int alpha = (q + 1) >> 1, beta = q >> 1;
  int32_t F[12];
#pragma unroll
  for (int i = 0; i < 10; i++) F[i] = f.v[i];
  F[10] = F[11] = 0;
  int32_t x[10];  // x[u] = f_(u + alpha)
#pragma unroll
  for (int u = 0; u < 10; u++) x[u] = alpha == 0 ? F[u] : alpha == 1 ? F[u + 1] : F[u + 2];
  int32_t Y[11];  // Y[v + 5] = f_v for v in [0, 5], 19 f_(v+10) below
#pragma unroll
  for (int v = 0; v < 5; v++) Y[v] = 19 * F[v + 5];
#pragma unroll
  for (int v = 0; v < 6; v++) Y[v + 5] = F[v];
  int32_t y[10];  // y[w + 5] = Y[w + beta + 5], w in [-5, 4]
#pragma unroll
  for (int w = 0; w < 10; w++) y[w] = beta ? Y[w + 1] : Y[w];
  int32_t c[6];  // the factor of pair t on this lane
#pragma unroll
  for (int s = 0; s < 6; s++) {
    if (q & 1)
      c[s] = s < 5 ? 2 : 0;
    else
      c[s] = ((s == 0 || s == 5) ? 1 : 2) << ((beta + s) & 1);
  }
  int64_t t[3];
#pragma unroll
  for (int m = 0; m < 3; m++) {
    t[m] = 0;
#pragma unroll
    for (int s = 0; s < 6; s++) t[m] += (int64_t)(c[s] * x[2 * m + s]) * y[2 * m - s + 5];
  }
  coop_gather_carry(h, t);
}

// h = f where flag; a select, not a branch.
__device__ __forceinline__ void fe_cmov(fe &h, const fe &f, bool flag) {
#pragma unroll
  for (int i = 0; i < 10; i++) h.v[i] = flag ? f.v[i] : h.v[i];
}

__device__ __forceinline__ void coop_fe_sqn(fe &h, const fe &f, int n, int q) {
  coop_fe_sq(h, f, q);
#pragma unroll 1
  for (int i = 1; i < n; i++) coop_fe_sq(h, h, q);
}

__device__ __forceinline__ void coop_fe_mul_c(fe &h, const fe &f, const int32_t *c, int q) {
  fe g;
  fe_const(g, c);
  coop_fe_mul(h, f, g, q);
}

// fe_pow_p58's addition chain on the quad's products.
__device__ __forceinline__ void coop_fe_pow_p58(fe &out, const fe &z, int q) {
  fe z2, z9, z11, t, z_5_0, z_10_0, z_20_0, z_50_0, z_100_0;
  coop_fe_sq(z2, z, q);
  coop_fe_sqn(t, z2, 2, q);
  coop_fe_mul(z9, t, z, q);
  coop_fe_mul(z11, z9, z2, q);
  coop_fe_sq(t, z11, q);
  coop_fe_mul(z_5_0, t, z9, q);
  coop_fe_sqn(t, z_5_0, 5, q);
  coop_fe_mul(z_10_0, t, z_5_0, q);
  coop_fe_sqn(t, z_10_0, 10, q);
  coop_fe_mul(z_20_0, t, z_10_0, q);
  coop_fe_sqn(t, z_20_0, 20, q);
  coop_fe_mul(t, t, z_20_0, q);  // 2^40 - 1
  coop_fe_sqn(t, t, 10, q);
  coop_fe_mul(z_50_0, t, z_10_0, q);
  coop_fe_sqn(t, z_50_0, 50, q);
  coop_fe_mul(z_100_0, t, z_50_0, q);
  coop_fe_sqn(t, z_100_0, 100, q);
  coop_fe_mul(t, t, z_100_0, q);  // 2^200 - 1
  coop_fe_sqn(t, t, 50, q);
  coop_fe_mul(t, t, z_50_0, q);  // 2^250 - 1
  coop_fe_sqn(t, t, 2, q);
  coop_fe_mul(out, t, z, q);
}

// ge_decompress (ZIP-215) with the quad's products: the same sequence, so
// the same point limb for limb and the same decode bit on every lane.
__device__ __forceinline__ bool coop_ge_decompress(ge &p, const uint8_t *enc) {
  const int q = threadIdx.x & 3;
  uint8_t yb[32];
#pragma unroll
  for (int i = 0; i < 32; i++) yb[i] = enc[i];
  const int sign = yb[31] >> 7;
  yb[31] &= 0x7f;
  fe y, one, yy, u, v, v3, v7, t, x, vxx;
  fe_from_limbs8(y, yb);
  fe_one(one);
  coop_fe_sq(yy, y, q);
  fe_sub(u, yy, one);
  coop_fe_mul_c(t, yy, FE_D, q);
  fe_add(v, t, one);
  coop_fe_sq(t, v, q);
  coop_fe_mul(v3, t, v, q);
  coop_fe_sq(t, v3, q);
  coop_fe_mul(v7, t, v, q);
  coop_fe_mul(t, u, v7, q);
  coop_fe_pow_p58(t, t, q);
  coop_fe_mul(x, u, v3, q);
  coop_fe_mul(x, x, t, q);
  coop_fe_sq(t, x, q);
  coop_fe_mul(vxx, v, t, q);
  fe_sub(t, vxx, u);
  const bool is_root = fe_iszero(t);
  fe_add(t, vxx, u);
  const bool is_neg_root = fe_iszero(t);
  coop_fe_mul_c(t, x, FE_SQRTM1, q);
  fe_cmov(x, t, !is_root);
  fe_carry(x, x);
  if (fe_parity(x) != sign) fe_neg(x, x);
  fe_carry(p.X, x);
  fe_carry(p.Y, y);
  fe_one(p.Z);
  coop_fe_mul(p.T, p.X, p.Y, q);
  return is_root || is_neg_root;
}

// sqrt_ratio_m1 (ristretto.cuh) with the quad's products.
__device__ __forceinline__ bool coop_sqrt_ratio_m1(fe &r_out, const fe &u, const fe &v, int q) {
  fe v3, v7, t, r, check;
  coop_fe_sq(t, v, q);
  coop_fe_mul(v3, t, v, q);
  coop_fe_sq(t, v3, q);
  coop_fe_mul(v7, t, v, q);
  coop_fe_mul(t, u, v7, q);
  coop_fe_pow_p58(t, t, q);
  coop_fe_mul(r, u, v3, q);
  coop_fe_mul(r, r, t, q);
  coop_fe_sq(t, r, q);
  coop_fe_mul(check, v, t, q);
  fe_sub(t, check, u);
  const bool correct = fe_iszero(t);
  fe_add(t, check, u);
  const bool flipped = fe_iszero(t);
  coop_fe_mul_c(t, u, FE_SQRTM1, q);
  fe_add(t, check, t);
  const bool flipped_i = fe_iszero(t);
  coop_fe_mul_c(t, r, FE_SQRTM1, q);
  fe_cmov(r, t, flipped || flipped_i);
  fe_abs(r_out, r);
  return correct || flipped;
}

// ristretto_decode (RFC 9496 §4.3.1) with the quad's products: the same
// sequence, the same point and decode bit on every lane.
__device__ __forceinline__ bool coop_ristretto_decode(ge &p, const uint8_t *enc) {
  const int q = threadIdx.x & 3;
  uint8_t b[32], c[32];
#pragma unroll
  for (int i = 0; i < 32; i++) b[i] = enc[i];
  fe s, one, ss, u1, u2, u2_sqr, v, t, invsqrt, den_x, den_y;
  fe_from_limbs8(s, b);
  fe_tobytes(c, s);
  bool canonical = true;
#pragma unroll
  for (int i = 0; i < 32; i++) canonical = canonical && c[i] == b[i];
  const bool even = (b[0] & 1) == 0;
  fe_one(one);
  coop_fe_sq(ss, s, q);
  fe_sub(u1, one, ss);
  fe_add(u2, one, ss);
  coop_fe_sq(u2_sqr, u2, q);
  coop_fe_mul_c(t, u1, FE_D, q);
  coop_fe_mul(t, t, u1, q);
  fe_neg(t, t);
  fe_sub(v, t, u2_sqr);
  coop_fe_mul(t, v, u2_sqr, q);
  const bool was_square = coop_sqrt_ratio_m1(invsqrt, one, t, q);
  coop_fe_mul(den_x, invsqrt, u2, q);
  coop_fe_mul(t, invsqrt, den_x, q);
  coop_fe_mul(den_y, t, v, q);
  fe_add(t, s, s);
  coop_fe_mul(t, t, den_x, q);
  fe_abs(p.X, t);
  coop_fe_mul(p.Y, u1, den_y, q);
  fe_one(p.Z);
  coop_fe_mul(p.T, p.X, p.Y, q);
  return canonical && even && was_square && !fe_parity(p.T) && !fe_iszero(p.Y);
}
