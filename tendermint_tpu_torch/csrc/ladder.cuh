// The per-row ladders and the cache-table writer shared by the bitmap
// kernels of both signature planes: ed25519 (verify.cu, verify_cached.cu,
// pk_tables.cu and the single-table pk_tables_single.cu,
// verify_cached_single.cu) and sr25519 (verify_sr.cu, verify_sr_cached.cu,
// sr_tables.cu, sr_tables_single.cu, verify_sr_cached_single.cu). The
// planes differ only in how points are decoded and compared (ge25519.cuh,
// ristretto.cuh).
#pragma once
#include "ge25519.cuh"

// [s]B + [k]A' for one row, 4-bit Straus windows from the top (the
// reference's double_scalar_mul_base): B's multiples come from the
// constant table by direct index, A''s from load_a(e, j), which loads
// multiple j of A'. The result carries a valid T only with final_t (the
// ristretto encoder reads it; the cofactored check does not).
template <typename LoadA>
__device__ __forceinline__ void ge_straus_base_with(ge &q, const int32_t *base_table, LoadA load_a,
                                                    const uint8_t *s, const uint8_t *k,
                                                    bool final_t) {
  ge e;
  // Window 63 has no leading doublings.
  ge_from_limbs8(q, base_table + 128 * nibble(s, 63));
  load_a(e, nibble(k, 63));
  ge_add(q, q, e, false);
#pragma unroll 1
  for (int w = 62; w >= 0; w--) {
    ge_dbl(q, q, false);
    ge_dbl(q, q, false);
    ge_dbl(q, q, false);
    ge_dbl(q, q, true);
    ge_from_limbs8(e, base_table + 128 * nibble(s, w));
    ge_add(q, q, e, true);
    load_a(e, nibble(k, w));
    ge_add(q, q, e, final_t && w == 0);
  }
}

// The uncached ladder: A''s 16 multiples in strided int32 scratch
// (ge_build_table).
__device__ __forceinline__ void ge_straus_base(ge &q, const int32_t *base_table, const int32_t *tab,
                                               int stride, const uint8_t *s, const uint8_t *k,
                                               bool final_t) {
  ge_straus_base_with(q, base_table, [&](ge &e, int j) { ge_load(e, tab, j, stride); }, s, k,
                      final_t);
}

// The single-table cache-hit ladder: A''s 16 multiples are one cache entry,
// (16, 4, 32) int16 radix-2^8 limbs, read modulo p (canonical from the
// port's fill, signed from a JAX cache carried across).
__device__ __forceinline__ void ge_straus_base_cached(ge &q, const int32_t *base_table,
                                                      const int16_t *a_tab, const uint8_t *s,
                                                      const uint8_t *k, bool final_t) {
  ge_straus_base_with(q, base_table, [&](ge &e, int j) { ge_from_limbs8(e, a_tab + j * 128); }, s,
                      k, final_t);
}

// [s]B + [k]A' on the split plane (the reference's double_scalar_mul_split)
// with the scalars cut into S chunks of per = 64/S nibbles: per steps of 4
// shared doublings and 2 S additions from the identity; s rides the rows
// of the fixed-base comb at the chunk boundaries, k the cache entry a_tab
// (S x 16 entries of 128 int16 limbs: -A's power tables). A step's last
// addition feeds doublings, which never read T, so it writes T only in the
// last step with final_t. S is a template parameter: the kernels
// instantiate S = 2, 4 and 8 (one ladder with S read at run time crashed
// the device compiler).
template <int S>
__device__ __forceinline__ void ge_straus_split(ge &q, const int16_t *a_tab, const int32_t *fixed_table,
                                                const uint8_t *s, const uint8_t *k, bool final_t) {
  constexpr int per = 64 / S;
  ge e;
  ge_identity(q);
#pragma unroll 1
  for (int w = per - 1; w >= 0; w--) {
    ge_dbl(q, q, false);
    ge_dbl(q, q, false);
    ge_dbl(q, q, false);
    ge_dbl(q, q, true);
#pragma unroll 1
    for (int c = 0; c < S; c++) {
      // fixed-base comb row per*c: j * 16^(per*c) * B
      ge_from_limbs8(e, fixed_table + ((size_t)(per * c) * 16 + nibble(s, per * c + w)) * 128);
      ge_add(q, q, e, true);
      ge_from_limbs8(e, a_tab + ((size_t)c * 16 + nibble(k, per * c + w)) * 128);
      ge_add(q, q, e, c < S - 1 || (final_t && w == 0));
    }
  }
}

// One cache entry's point, each coordinate canonical radix-2^8 (bytes
// 0..255, inside the cache's |limb| < 2^9 contract).
__device__ __forceinline__ void write_entry(int16_t *dst, const ge &p) {
  const fe *c[4] = {&p.X, &p.Y, &p.Z, &p.T};
  uint8_t b[32];
#pragma unroll
  for (int k = 0; k < 4; k++) {
    fe_tobytes(b, *c[k]);
#pragma unroll
    for (int l = 0; l < 32; l++) dst[k * 32 + l] = b[l];
  }
}

// The cache entry of a decoded, negated key p at `splits` chunks of
// c = 256/splits bits: the 16-multiples tables of p, [2^c]p, [2^2c]p, ...,
// (splits, 16, 4, 32) int16 at dst; at splits = 1 the single table
// (16, 4, 32). The reference's sequence (build_power_tables: c - 1
// doublings without T and one with T per power, then repeated addition);
// each entry is written as it is produced, so only the running point
// stays live.
__device__ __forceinline__ void write_power_tables(int16_t *dst, ge p, int splits) {
  const int chunk_bits = 256 / splits;
  ge acc;
#pragma unroll 1
  for (int c = 0; c < splits; c++) {
    if (c > 0) {
#pragma unroll 1
      for (int d = 0; d < chunk_bits - 1; d++) ge_dbl(p, p, false);
      ge_dbl(p, p, true);
    }
    int16_t *row = dst + (size_t)c * 16 * 128;
    ge_identity(acc);
    write_entry(row, acc);
    write_entry(row + 128, p);
    ge_add(acc, p, p, true);
    write_entry(row + 2 * 128, acc);
#pragma unroll 1
    for (int j = 3; j < 16; j++) {
      ge_add(acc, acc, p, true);
      write_entry(row + j * 128, acc);
    }
  }
}

// The cache geometries of the reference (TM_TPU_PK_SPLIT).
__host__ __device__ __forceinline__ bool valid_splits(int splits) {
  return splits == 1 || splits == 2 || splits == 4 || splits == 8;
}
