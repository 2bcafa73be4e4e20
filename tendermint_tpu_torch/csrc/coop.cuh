// Four cooperating lanes a point. A quad is four neighbouring lanes of a
// warp (lanes 4m .. 4m + 3); lane q = lane & 3 of the quad holds coordinate
// q of an extended point (X, Y, Z, T) as one ten-limb field element, so a
// point operation spreads over the quad: dbl-2008-hwcd in two rounds (four
// squarings, then four products) and add-2008-hwcd-3 in three (four
// products, the 2d product, four products), each lane one product a round,
// limbs exchanged by __shfl_sync of width 4. Every quad of a warp may run
// them at once (the default mask is the whole warp, and then every lane of
// the warp must call them together); the RLC tail, where lanes 0-3 alone
// run, passes mask 0xF. The values equal ge_dbl's and ge_add's coordinate
// for coordinate modulo p, T included.
//
// Users: the RLC tail (msm.cuh), the uncached ed25519 bitmap's ladder
// (verify.cu) and the sr25519 split fill (sr_tables.cu).
#pragma once
#include <cuda_runtime.h>

#include "ge25519.cuh"

constexpr unsigned QUAD_ALL = 0xffffffffu;

// One point as a contiguous row of 40 int32 (X, Y, Z, T, ten limbs each),
// moved as ten 16-byte words; the row must be 16-byte aligned.
__device__ __forceinline__ void ge_store_row(int32_t *dst, const ge &p) {
  const fe *c[4] = {&p.X, &p.Y, &p.Z, &p.T};
  int4 *d = reinterpret_cast<int4 *>(dst);
#pragma unroll
  for (int j = 0; j < 10; j++)
    d[j] = make_int4(c[(4 * j) / 10]->v[(4 * j) % 10], c[(4 * j + 1) / 10]->v[(4 * j + 1) % 10],
                     c[(4 * j + 2) / 10]->v[(4 * j + 2) % 10],
                     c[(4 * j + 3) / 10]->v[(4 * j + 3) % 10]);
}

// r = v of lane src of this lane's quad.
__device__ __forceinline__ void fe_shfl(fe &r, const fe &v, int src, unsigned mask = QUAD_ALL) {
#pragma unroll
  for (int l = 0; l < 10; l++) r.v[l] = __shfl_sync(mask, v.v[l], src, 4);
}

// r = the argument numbered q.
__device__ __forceinline__ void fe_pick(fe &r, int q, const fe &a0, const fe &a1, const fe &a2,
                                        const fe &a3) {
#pragma unroll
  for (int l = 0; l < 10; l++)
    r.v[l] = q == 0 ? a0.v[l] : q == 1 ? a1.v[l] : q == 2 ? a2.v[l] : a3.v[l];
}

// Coordinate `coord` of a point stored strided (ge_store's layout); a row
// (ge_store_row's) is stride 1.
__device__ __forceinline__ void fe_load_coord(fe &r, const int32_t *base, int coord, int stride) {
#pragma unroll
  for (int l = 0; l < 10; l++) r.v[l] = base[(coord * 10 + l) * stride];
}

// Coordinate `coord` of the point stored as a row at base.
__device__ __forceinline__ void fe_store_coord(int32_t *base, int coord, const fe &v) {
#pragma unroll
  for (int l = 0; l < 10; l++) base[coord * 10 + l] = v.v[l];
}

// mine = coordinate q of 2P, ge_dbl's formula (T included) in two rounds.
__device__ __forceinline__ void coop_dbl(fe &mine, int q, unsigned mask = QUAD_ALL) {
  fe x, y, u, s, a, b, c, d, e, f, g, h;
  fe_shfl(x, mine, 0, mask);
  fe_shfl(y, mine, 1, mask);
  fe_add(h, x, y);
  fe_pick(u, q, x, y, mine, h);
  fe_sq(s, u);  // X^2, Y^2, Z^2, (X+Y)^2
  fe_add(c, s, s);
  fe_carry(c, c);
  fe_pick(s, q, s, s, c, s);  // lane 2: C = 2 Z^2, carried
  fe_shfl(a, s, 0, mask);
  fe_shfl(b, s, 1, mask);
  fe_shfl(c, s, 2, mask);
  fe_shfl(d, s, 3, mask);
  fe_sub(e, d, a);
  fe_sub(e, e, b);
  fe_sub(g, b, a);
  fe_sub(f, g, c);
  fe_add(h, a, b);
  fe_neg(h, h);
  fe_pick(u, q, e, g, f, e);
  fe_pick(x, q, f, h, g, h);
  fe_mul(mine, u, x);  // X3 = EF, Y3 = GH, Z3 = FG, T3 = EH
}

// mine = coordinate q of P + Q, ge_add's formula in three rounds, given
// Q's X and Y and this lane's w = Q's T on lane 2, Q's Z on the others.
__device__ __forceinline__ void coop_add_xyw(fe &mine, int q, const fe &qx, const fe &qy,
                                             const fe &qw, unsigned mask) {
  fe partner, f1, f2, r, a, b, c, d, e, f, g, h;
  fe_shfl(partner, mine, q ^ 1, mask);  // lanes 0/1 swap X, Y; lanes 2/3 swap Z, T
  fe_sub(a, partner, mine);             // lane 0: Y1 - X1
  fe_add(b, mine, partner);             // lane 1: Y1 + X1
  fe_pick(f1, q, a, b, partner, partner);
  fe_sub(a, qy, qx);
  fe_add(b, qy, qx);
  fe_pick(f2, q, a, b, qw, qw);
  fe_mul(r, f1, f2);  // A, B, T1 T2, Z1 Z2
  if (q == 2) fe_mul_c(r, r, FE_D2);
  fe_add(d, r, r);
  fe_pick(r, q, r, r, r, d);  // C = 2d T1 T2, D = 2 Z1 Z2
  fe_shfl(a, r, 0, mask);
  fe_shfl(b, r, 1, mask);
  fe_shfl(c, r, 2, mask);
  fe_shfl(d, r, 3, mask);
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  fe_pick(f1, q, e, g, f, e);
  fe_pick(f2, q, f, h, g, h);
  fe_mul(mine, f1, f2);  // X3 = EF, Y3 = GH, Z3 = FG, T3 = EH
}

// mine = coordinate q of P + Q, Q a point with T stored at qp (strided, or
// a row at stride 1).
__device__ __forceinline__ void coop_add(fe &mine, const int32_t *qp, int stride, int q,
                                         unsigned mask = QUAD_ALL) {
  fe qx, qy, qw;
  fe_load_coord(qx, qp, 0, stride);
  fe_load_coord(qy, qp, 1, stride);
  fe_load_coord(qw, qp, q == 2 ? 3 : 2, stride);
  coop_add_xyw(mine, q, qx, qy, qw, mask);
}

// mine = coordinate q of P + Q, Q held by the quad as P is (lane q holds
// coordinate q of Q in `theirs`).
__device__ __forceinline__ void coop_add_reg(fe &mine, const fe &theirs, int q,
                                             unsigned mask = QUAD_ALL) {
  fe qx, qy, qw;
  fe_shfl(qx, theirs, 0, mask);
  fe_shfl(qy, theirs, 1, mask);
  fe_shfl(qw, theirs, q == 2 ? 3 : 2, mask);
  coop_add_xyw(mine, q, qx, qy, qw, mask);
}

// One lane's coordinate of a cache entry: canonical radix-2^8 bytes as 32
// int16 limbs at dst (64 bytes, 16-byte aligned), four 16-byte stores.
__device__ __forceinline__ void coop_write_coord(int16_t *dst, const fe &v) {
  uint8_t b[32];
  fe_tobytes(b, v);
  int4 *d = reinterpret_cast<int4 *>(dst);
#pragma unroll
  for (int j = 0; j < 4; j++)
    d[j] = make_int4(b[8 * j] | b[8 * j + 1] << 16, b[8 * j + 2] | b[8 * j + 3] << 16,
                     b[8 * j + 4] | b[8 * j + 5] << 16, b[8 * j + 6] | b[8 * j + 7] << 16);
}

// The cache entry of a decoded, negated key at `splits` chunks of c =
// 256/splits bits, written by its quad: lane q holds coordinate q of the
// key's point in p and writes coordinate q of every entry, so the quad
// writes each 256-byte entry as one contiguous run. The sequence is
// write_power_tables' (ladder.cuh), the reference's build_power_tables:
// per power c >= 1, c doublings (the last one's T is the one read), then
// entries 0, P, P + P and 13 more additions of P; each entry equals the
// one-lane fill's coordinate for coordinate modulo p, so its canonical
// bytes are the same. Only a live quad writes; every quad of the warp
// must call it (the point operations shuffle across the warp).
__device__ __forceinline__ void coop_write_power_tables(int16_t *dst, fe p, int q, int splits,
                                                       bool live) {
  const int chunk_bits = 256 / splits;
  fe acc, id;
  if (q == 1 || q == 2)
    fe_one(id);
  else
    fe_zero(id);
#pragma unroll 1
  for (int c = 0; c < splits; c++) {
    if (c > 0) {
#pragma unroll 1
      for (int d = 0; d < chunk_bits; d++) coop_dbl(p, q);
    }
    int16_t *row = dst + (size_t)c * 16 * 128 + q * 32;
    fe_copy(acc, p);
    coop_add_reg(acc, p, q);
    if (live) {
      coop_write_coord(row, id);
      coop_write_coord(row + 128, p);
      coop_write_coord(row + 2 * 128, acc);
    }
#pragma unroll 1
    for (int j = 3; j < 16; j++) {
      coop_add_reg(acc, p, q);
      if (live) coop_write_coord(row + j * 128, acc);
    }
  }
}
